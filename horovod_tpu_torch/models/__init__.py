"""Models of the port: the flagship transformer (forward only so far)."""

from . import transformer

__all__ = ["transformer"]
