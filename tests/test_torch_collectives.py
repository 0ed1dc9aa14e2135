"""The port's all-to-all (horovod_tpu_torch/ops/collectives.py) and the
expert mesh (parallel/mesh.py, runtime.expert_mesh) over 4 gloo ranks,
against the JAX package.

One run of 4 processes (tests/torch_ranks.py; ``HOROVOD_EXPERT_PARALLEL=
2``) covers the multi-rank cases: ``alltoall`` for several split and
concat axes against ``lax.all_to_all(..., tiled=True)`` run over 4 of
the conftest's virtual CPU devices, bit for bit (an all-to-all moves
values and adds nothing); its backward, the reverse all-to-all, which
brings the cotangent of ``alltoall(g)`` back to ``g`` exactly;
``alltoall_chunked`` at 1 to 4 chunks (3 falls back to the largest
divisor, 2) equal to the unchunked all-to-all, bit for bit; and the
2 x 2 (data, expert) mesh's layout, rank r at (r // 2, r % 2). The same
run holds ``reducescatter`` to ``lax.psum_scatter(tiled=True)``,
``bucketed_reducescatter_allgather`` to the JAX package's own over 4
devices (f32 within rtol 1e-6, the sum's order; int32 exactly), and
``hierarchical_allreduce`` on a 2 x 2 ``hierarchical_mesh`` to the flat
sum and mean, an odd length included (padded to the ICI size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.ops.collectives import (
    _largest_divisor_leq as jax_largest_divisor)
from horovod_tpu_torch.exceptions import HorovodError
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel.mesh import expert_data_mesh
from torch_ranks import spawn_ranks
import torch_rank_workers

RANKS = 4
PAIRS = ((0, 0), (0, 1), (1, 0), (2, 1), (1, 2))


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    inp = {"x": rng.standard_normal((RANKS, 8, 4, 4), np.float32),
           "g": rng.standard_normal((RANKS, 8, 4, 4), np.float32),
           "rs": rng.standard_normal((RANKS, 8, 3), np.float32),
           "bk_a": rng.standard_normal((RANKS, 5), np.float32),
           "bk_b": rng.standard_normal((RANKS, 3, 4), np.float32),
           "bk_c": rng.integers(-50, 50, (RANKS, 7)).astype(np.int32),
           "h_odd": rng.standard_normal((RANKS, 7), np.float32),
           "h_2d": rng.standard_normal((RANKS, 5, 3), np.float32),
           "h_int": rng.integers(-50, 50, (RANKS, 9)).astype(np.int32)}
    res = spawn_ranks(RANKS, torch_rank_workers.collectives, inp, PAIRS,
                      env={"HOROVOD_EXPERT_PARALLEL": "2"})
    return inp, res


def _jax_alltoall(x, split, concat):
    """``lax.all_to_all(tiled=True)`` of each rank's ``x[r]`` over 4
    virtual devices; the per-rank results stacked."""
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("i",))

    def f(xs):
        y = jax.lax.all_to_all(xs[0], "i", split, concat, tiled=True)
        return y[None]

    return np.asarray(jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=P("i"), out_specs=P("i"),
        check_vma=False))(jnp.asarray(x)))


@pytest.mark.parametrize("split,concat", PAIRS)
def test_alltoall_matches_lax_all_to_all(run, split, concat):
    inp, res = run
    want = _jax_alltoall(inp["x"], split, concat)
    for r in range(RANKS):
        assert np.array_equal(res[r][f"y{split}{concat}"], want[r]), r


@pytest.mark.parametrize("split,concat", PAIRS)
def test_alltoall_backward_is_the_reverse_alltoall(run, split, concat):
    """The cotangent alltoall(g) comes back to each rank as its g."""
    inp, res = run
    for r in range(RANKS):
        assert np.array_equal(res[r][f"grad{split}{concat}"], inp["g"][r])


def test_alltoall_chunked_is_bit_identical_to_unchunked(run):
    _, res = run
    for r in range(RANKS):
        assert [res[r][f"chunks{c}"] for c in (1, 2, 3, 4)] == [1, 2, 2, 4]
        for c in (1, 2, 3, 4):
            assert res[r][f"chunked{c}_equal"], (r, c)
        # one record a call: 5 pairs x 2, 1 whole, 4 chunked; the
        # backward records none, as the JAX package's transpose (lax's
        # own all_to_all) does not
        assert res[r]["alltoall_jit_calls"] == 15


def test_expert_mesh_layout(run):
    _, res = run
    for r in range(RANKS):
        assert res[r]["size"] == RANKS and res[r]["ep_size"] == 2
        assert tuple(res[r]["coordinate"]) == (r // 2, r % 2)
        assert res[r]["ep_group"] == [r // 2 * 2, r // 2 * 2 + 1]
        assert res[r]["data_group"] == [r % 2, r % 2 + 2]


@pytest.mark.parametrize("n,k", [(12, 5), (12, 4), (7, 3), (8, 100),
                                 (5, 0)])
def test_largest_divisor_matches_jax(n, k):
    assert collectives._largest_divisor_leq(n, k) == jax_largest_divisor(
        n, k)


@pytest.mark.parametrize("ep,axes,match", [
    (3, ("hvd", "ep"), "does not divide the world size 4"),
    (0, ("hvd", "ep"), "expert_parallel must be >= 1"),
    (2, ("hvd", "hvd"), "data and expert axes must differ")])
def test_expert_data_mesh_errors_are_the_references(ep, axes, match):
    from horovod_tpu.parallel.mesh import expert_data_mesh as jax_mesh
    with pytest.raises(ValueError) as want:
        jax_mesh(devices=jax.devices()[:4], expert_parallel=ep,
                 data_axis=axes[0], expert_axis=axes[1])
    with pytest.raises(ValueError, match=match) as got:
        expert_data_mesh("cpu", 4, expert_parallel=ep, data_axis=axes[0],
                         expert_axis=axes[1])
    assert str(got.value) == str(want.value)


def test_expert_mesh_without_a_degree_raises_the_references_error():
    hvd.init(device="cpu")
    try:
        assert hvd.expert_parallel_size() == 1
        with pytest.raises(HorovodError, match="no expert mesh: set "
                                               "HOROVOD_EXPERT_PARALLEL"):
            hvd.expert_mesh()
        # one rank: the world all-to-all is the identity
        x = torch.arange(24.0).view(2, 3, 4)
        assert torch.equal(hvd.alltoall(x, split_axis=1, concat_axis=2), x)
    finally:
        hvd.shutdown()


def test_config_reads_the_expert_knobs_with_the_references_clamps(
        monkeypatch):
    from horovod_tpu.config import Config as JaxConfig
    from horovod_tpu_torch.config import Config
    for ep, chunks in (("4", "8"), ("0", "-3"), ("", "x")):
        monkeypatch.setenv("HOROVOD_EXPERT_PARALLEL", ep)
        monkeypatch.setenv("HOROVOD_MOE_CHUNKS", chunks)
        got, want = Config.from_env(), JaxConfig.from_env()
        assert (got.expert_parallel, got.moe_chunks) == (
            want.expert_parallel, want.moe_chunks)


def _jax_per_rank(fn, *arrays):
    """``fn`` of each rank's slice over 4 virtual devices; per-rank
    results stacked."""
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("hvd",))

    def f(*xs):
        out = fn(*[x[0] for x in xs])
        return jax.tree.map(lambda y: y[None], out)

    return jax.tree.map(np.asarray, jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P("hvd"),) * len(arrays),
        out_specs=P("hvd"), check_vma=False))(*map(jnp.asarray, arrays)))


def test_reducescatter_matches_lax_psum_scatter(run):
    inp, res = run
    want = _jax_per_rank(
        lambda x: jax.lax.psum_scatter(x, "hvd", scatter_dimension=0,
                                       tiled=True), inp["rs"])
    for r in range(RANKS):
        np.testing.assert_allclose(res[r]["rs_sum"], want[r], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(res[r]["rs_avg"], want[r] / RANKS,
                                   rtol=1e-6, atol=1e-6)


def test_bucketed_reducescatter_allgather_matches_the_reference(run):
    """Three leaves (f32 5, f32 3 x 4, int32 7) in 32-byte buckets: the
    f32 pair splits in two, the int32 leaf rides alone; each bucket one
    reduce-scatter and one all-gather record, as the JAX package's."""
    from horovod_tpu.ops.collectives import (
        bucketed_reducescatter_allgather as jax_bucketed)
    inp, res = run
    want = _jax_per_rank(
        lambda a, b, c: jax_bucketed([a, b, c], "hvd", True,
                                     bucket_bytes=32),
        inp["bk_a"], inp["bk_b"], inp["bk_c"])
    for r in range(RANKS):
        got = res[r]["bk"]
        for i in range(2):
            np.testing.assert_allclose(got[i], want[i][r], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(
                got[i], [inp["bk_a"], inp["bk_b"]][i].mean(0), rtol=1e-5,
                atol=1e-6)
        assert got[2].dtype == np.int32
        assert np.array_equal(got[2], want[2][r])
        assert res[r]["bk_records"] == (3, 3)


def test_hierarchical_allreduce_matches_the_flat_sum(run):
    inp, res = run
    for r in range(RANKS):
        assert tuple(res[r]["hier_coordinate"]) == (r // 2, r % 2)
        for k in ("h_odd", "h_2d"):
            np.testing.assert_allclose(res[r][f"{k}_sum"], inp[k].sum(0),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(res[r][f"{k}_avg"], inp[k].mean(0),
                                       rtol=1e-5, atol=1e-6)
        assert np.array_equal(res[r]["h_int_sum"], inp["h_int"].sum(0))


@pytest.mark.parametrize("local", [3, 0, -2])
def test_hierarchical_mesh_errors_are_the_references(local):
    from horovod_tpu.parallel.mesh import hierarchical_mesh as jax_mesh
    from horovod_tpu_torch.parallel.mesh import hierarchical_mesh
    with pytest.raises(ValueError) as want:
        jax_mesh(jax.devices()[:4], local)
    with pytest.raises(ValueError) as got:
        hierarchical_mesh("cpu", 4, local)
    assert str(got.value) == str(want.value)


def test_hierarchical_axes_error_is_the_references():
    from horovod_tpu.parallel.mesh import hierarchical_axes as jax_axes
    from horovod_tpu.parallel.mesh import hierarchical_mesh as jax_mesh
    from horovod_tpu_torch.parallel.mesh import hierarchical_axes

    class _Mesh:  # the names are all the check reads
        mesh_dim_names = ("cross", "local")
    jmesh = jax_mesh(jax.devices()[:4], 2)
    assert hierarchical_axes(_Mesh()) == jax_axes(jmesh) == ("local",
                                                             "cross")
    with pytest.raises(ValueError) as want:
        jax_axes(jmesh, "ici", "dcn")
    with pytest.raises(ValueError) as got:
        hierarchical_axes(_Mesh(), "ici", "dcn")
    assert str(got.value) == str(want.value).replace(
        str(jmesh.axis_names), str(_Mesh.mesh_dim_names))
