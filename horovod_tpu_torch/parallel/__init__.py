"""Parallel attention primitives of the port (single-device so far)."""
