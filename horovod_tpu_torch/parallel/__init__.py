"""Parallel layouts of the port: the (pp, dp, ep, sp, tp) mesh, ring
and Ulysses attention, and the pipeline schedules."""

from .mesh import MeshConfig, create_mesh  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
