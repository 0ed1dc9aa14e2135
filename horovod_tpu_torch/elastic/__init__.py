"""Elastic support of the port (the signal file drop so far)."""
