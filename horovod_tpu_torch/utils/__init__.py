"""Support code of the port."""
