"""Device topology of the port.

Counterpart of horovod_tpu/parallel/mesh.py: :func:`create_mesh` (the
5-axis ``("pp", "dp", "ep", "sp", "tp")`` layout of composable
parallelism, with :class:`MeshConfig`), :func:`data_parallel_mesh` (one
flat data-parallel axis over every rank), :func:`expert_data_mesh` (the
2-D (data, expert) layout of expert-parallel MoE),
:func:`model_expert_data_mesh` (the 3-D (data, expert, model) layout of
tensor parallelism), :func:`hierarchical_mesh` (the 2-D (cross, local)
layout of the two-tier collectives) and :func:`hierarchical_axes`.
``RingAxis.over(mesh.get_group("sp"))`` (or ``"pp"``) is the
:class:`~horovod_tpu_torch.parallel.ring_attention.RingAxis` that ring
attention, Ulysses and the pipeline schedules run over.

A ``DeviceMesh`` creates one process group per row and column of the
layout, on every rank in the same order; so every rank builds every
mesh, with the same arguments.
"""

import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh


@dataclasses.dataclass
class MeshConfig:
    """Requested logical parallelism degrees. -1 on dp means "whatever is
    left" after the explicit axes."""
    dp: int = -1   # data parallel
    tp: int = 1    # tensor/model parallel
    pp: int = 1    # pipeline parallel
    sp: int = 1    # sequence/context parallel (ring or Ulysses axis)
    ep: int = 1    # expert parallel


def create_mesh(device_type, size, config=None, *, dp=None, tp=None,
                pp=None, sp=None, ep=None):
    """The 5-D ``DeviceMesh`` with axes ``("pp", "dp", "ep", "sp", "tp")``
    over ranks 0..size-1, laid out row-major as the JAX package's
    ``create_mesh`` reshapes its device list: tp varies fastest, so each
    run of ``tp`` consecutive ranks is one model group (NVLink within a
    host), then sp, ep, dp, and pp outermost. Axes of size 1 are still
    there, so code can name every axis. ``config`` (a
    :class:`MeshConfig`) gives the degrees, and a keyword overrides its
    field; ``dp=-1`` takes what the others leave. Raises the JAX
    package's errors, word for word, when the degrees do not fit."""
    cfg = config or MeshConfig()
    for name, value in (("dp", dp), ("tp", tp), ("pp", pp), ("sp", sp),
                        ("ep", ep)):
        if value is not None:
            cfg = dataclasses.replace(cfg, **{name: value})
    n = int(size)
    fixed = cfg.tp * cfg.pp * cfg.sp * cfg.ep
    if cfg.dp == -1:
        if n % fixed != 0:
            raise ValueError(
                f"device count {n} not divisible by tp*pp*sp*ep={fixed}")
        cfg = dataclasses.replace(cfg, dp=n // fixed)
    total = cfg.dp * fixed
    if total != n:
        raise ValueError(f"mesh axes {cfg} require {total} devices, "
                         f"have {n}")
    shape = (cfg.pp, cfg.dp, cfg.ep, cfg.sp, cfg.tp)
    ranks = torch.arange(n).reshape(shape).tolist()
    return DeviceMesh(device_type, ranks,
                      mesh_dim_names=("pp", "dp", "ep", "sp", "tp"))


def data_parallel_mesh(device_type, size, axis_name="hvd"):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over ranks 0..size-1 of
    the default process group (the reference's global communicator)."""
    return DeviceMesh(device_type, list(range(size)),
                      mesh_dim_names=(axis_name,))


def expert_data_mesh(device_type, size, expert_parallel=1, data_axis="hvd",
                     expert_axis="ep"):
    """The 2-D (data, expert) ``DeviceMesh`` of expert-parallel MoE: ranks
    0..size-1 laid out as ``(size // expert_parallel, expert_parallel)``
    with axes ``(data_axis, expert_axis)``, so rank r sits at
    ``(r // ep, r % ep)`` and each run of ``ep`` consecutive ranks is
    one expert group (the axis that carries the dispatch and combine
    all-to-all every step); the data axis carries the expert gradients'
    all-reduce. ``mesh.get_group(expert_axis)`` is this rank's expert
    group, ``mesh.get_group(data_axis)`` its data group. Raises the JAX
    package's errors when the degree is not positive, does not divide
    the world, or the axes collide."""
    ep = int(expert_parallel)
    if ep <= 0:
        raise ValueError(f"expert_parallel must be >= 1, got {ep}")
    if size % ep != 0:
        raise ValueError(
            f"expert_parallel={ep} does not divide the world size {size} "
            "(HOROVOD_EXPERT_PARALLEL must divide the device count, "
            "including after an elastic re-init over survivors)")
    if data_axis == expert_axis:
        raise ValueError(
            f"data and expert axes must differ, both are {data_axis!r}")
    ranks = [[r * ep + e for e in range(ep)] for r in range(size // ep)]
    return DeviceMesh(device_type, ranks,
                      mesh_dim_names=(data_axis, expert_axis))


def model_expert_data_mesh(device_type, size, expert_parallel=1,
                           model_parallel=1, data_axis="hvd",
                           expert_axis="ep", model_axis="model"):
    """The 3-D (data, expert, model) ``DeviceMesh`` of composable
    parallelism: ranks 0..size-1 laid out as ``(size // (ep * mp), ep,
    mp)`` with axes ``(data_axis, expert_axis, model_axis)``, so rank r
    sits at ``(r // (ep * mp), (r // mp) % ep, r % mp)``. The model axis
    varies fastest: each run of ``mp`` consecutive ranks is one model
    group, which carries an activation all-reduce in every layer (on a
    host, NVLink); the expert axis carries the MoE all-to-all, the data
    axis one gradient exchange a step. Raises the JAX package's errors
    when a degree is not positive, the degrees do not divide the world,
    or two axis names collide."""
    ep = int(expert_parallel)
    mp = int(model_parallel)
    if ep <= 0:
        raise ValueError(f"expert_parallel must be >= 1, got {ep}")
    if mp <= 0:
        raise ValueError(f"model_parallel must be >= 1, got {mp}")
    if size % (ep * mp) != 0:
        raise ValueError(
            f"expert_parallel={ep} * model_parallel={mp} does not divide "
            f"the world size {size} (HOROVOD_EXPERT_PARALLEL * "
            "HOROVOD_MODEL_PARALLEL must divide the device count, "
            "including after an elastic re-init over survivors)")
    names = (data_axis, expert_axis, model_axis)
    if len(set(names)) != 3:
        raise ValueError(f"mesh axis names must be distinct, got {names}")
    ranks = [[[(d * ep + e) * mp + m for m in range(mp)] for e in range(ep)]
             for d in range(size // (ep * mp))]
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def hierarchical_axes(mesh, ici_axis="local", dcn_axis="cross"):
    """Names of the (intra-host, cross-host) axis pair for hierarchical
    collectives, checked against ``mesh``'s axes: the analog of the
    reference's (local, cross) communicator pair."""
    names = tuple(mesh.mesh_dim_names)
    if ici_axis not in names or dcn_axis not in names:
        raise ValueError(
            f"mesh axes {names} do not contain the hierarchical "
            f"pair ({ici_axis!r}, {dcn_axis!r})")
    return (ici_axis, dcn_axis)


def hierarchical_mesh(device_type, size, local_size, cross_axis="cross",
                      local_axis="local"):
    """The 2-D (cross, local) ``DeviceMesh`` over ranks 0..size-1 that
    hierarchical collectives decompose over: rank r sits at
    ``(r // local_size, r % local_size)``, row-major over (cross, local),
    the reference's rank -> (node, local_rank) mapping. The local tier
    is a host's ranks (NVLink within an H100 node), the cross tier the
    network between hosts. Raises the JAX package's error when
    ``local_size`` does not tile the ranks."""
    if local_size <= 0 or size % local_size != 0:
        raise ValueError(
            f"local_size={local_size} does not evenly divide {size} devices")
    ranks = [[h * local_size + l for l in range(local_size)]
             for h in range(size // local_size)]
    return DeviceMesh(device_type, ranks,
                      mesh_dim_names=(cross_axis, local_axis))
