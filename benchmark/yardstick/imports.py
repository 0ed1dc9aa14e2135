"""The check that the run never loaded JAX or the JAX package.

Names are compared whole, by their top-level part (before the first
dot): the port, ``horovod_tpu_torch``, begins with the JAX package's
name and is not it."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "horovod_tpu")


def top(name):
    return name.split(".", 1)[0]


def loaded(modules=None):
    """The loaded modules (``sys.modules`` by default) whose top-level
    name is forbidden, sorted."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if top(m) in FORBIDDEN)

