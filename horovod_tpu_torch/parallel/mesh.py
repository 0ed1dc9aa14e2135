"""Device topology of the port.

Counterpart of horovod_tpu/parallel/mesh.py, of which the training slice
carries :func:`data_parallel_mesh`: one flat data-parallel axis over
every rank. The 2-D expert and 3-D model meshes come with their slices
(ROADMAP.md, Queue 1 items 6 and 7).
"""

from torch.distributed.device_mesh import DeviceMesh


def data_parallel_mesh(device_type, size, axis_name="hvd"):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over ranks 0..size-1 of
    the default process group (the reference's global communicator)."""
    return DeviceMesh(device_type, list(range(size)),
                      mesh_dim_names=(axis_name,))
