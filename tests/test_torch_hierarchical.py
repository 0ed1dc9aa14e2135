"""The eager engine's hierarchical allgather (horovod_tpu_torch/ops/
engine.py) against the JAX package's (horovod_tpu/ops/engine.py
``_jit_allgather_rows_hier``), and the knobs beside it.

Spec: tests/test_hierarchical.py (``test_hier_allgather_matches_flat``,
``test_hier_flag_without_topology_warns``). The port runs 4 gloo ranks,
each a process (tests/torch_ranks.py), the local tier 2 ranks
(``HOROVOD_DCN_LOCAL_SIZE``; the JAX package's ``HOROVOD_TPU_LOCAL_SIZE``
is the launcher's variable in the port); the reference runs
``init(num_ranks=4)`` over 4 of the conftest's virtual devices with
``rank=r`` submissions. A gather copies, so every comparison is exact.
"""

import logging

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.config import Config as JConfig
from horovod_tpu_torch.config import Config
from torch_engine_workers import hierarchical_allgather
from torch_ranks import spawn_ranks

N = 4


def _blocks(seed=5):
    """Ragged blocks by rank: f32, int32 and a 3-D f32 block whose first
    dimension is 0 on one rank."""
    rng = np.random.default_rng(seed)
    return [
        [rng.standard_normal((r + 1, 2)).astype(np.float32)
         for r in range(N)],
        [rng.integers(-9, 10, (3 - r % 2,)).astype(np.int32)
         for r in range(N)],
        [rng.standard_normal(((2, 0, 1, 3)[r], 2, 2)).astype(np.float32)
         for r in range(N)],
    ]


def _reference(blocks, monkeypatch):
    """The JAX package's two-stage gather of the same blocks."""
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLGATHER", "1")
    monkeypatch.setenv("HOROVOD_TPU_LOCAL_SIZE", "2")
    jhvd.shutdown()
    jhvd.init(num_ranks=N)
    try:
        assert jhvd.state().engine.hier_local_size == 2
        outs = []
        for i, per_rank in enumerate(blocks):
            hs = [jhvd.allgather_async(per_rank[r], name=f"hag.{i}", rank=r)
                  for r in range(N)]
            res = [jhvd.synchronize(h) for h in hs]
            outs.append([np.asarray(next(iter(v.values()))
                                    if isinstance(v, dict) else v)
                         for v in res])
        return outs
    finally:
        jhvd.shutdown()
        monkeypatch.delenv("HOROVOD_HIERARCHICAL_ALLGATHER")
        monkeypatch.delenv("HOROVOD_TPU_LOCAL_SIZE")
        jhvd.init()


def test_hier_allgather_matches_flat_and_the_reference(monkeypatch):
    """HOROVOD_HIERARCHICAL_ALLGATHER: the engine gathers in two stages
    (the local tier, then across hosts) and every rank gets the flat
    gather's rows, in rank order, bit for bit, as the JAX package's
    two-stage gather does; the allreduce stays flat without its own
    flag."""
    blocks = _blocks()
    got = spawn_ranks(N, hierarchical_allgather, blocks,
                      env={"HOROVOD_HIERARCHICAL_ALLGATHER": "1",
                           "HOROVOD_DCN_LOCAL_SIZE": "2"})
    want = _reference(blocks, monkeypatch)
    for i, per_rank in enumerate(blocks):
        expected = np.concatenate(per_rank)
        for r in range(N):
            np.testing.assert_array_equal(got[r]["out"][i], expected)
            np.testing.assert_array_equal(got[r]["out"][i],
                                          got[r]["flat"][i])
            np.testing.assert_array_equal(got[r]["out"][i], want[i][r])
            assert got[r]["out"][i].dtype == expected.dtype
    for r in range(N):
        assert got[r]["local"] == 2
        assert got[r]["allreduce_flat"]
        np.testing.assert_array_equal(got[r]["sum"], np.full(5, 4.0))
        # an unpadded bucket: no local-tier padding without its flag
        assert got[r]["sizes"] == [5 * 4]


@pytest.mark.parametrize("flag", ["HOROVOD_HIERARCHICAL_ALLREDUCE",
                                  "HOROVOD_HIERARCHICAL_ALLGATHER"])
def test_hier_flag_without_topology_warns(caplog, monkeypatch, flag):
    """Either flag on a flat topology (one rank) warns loudly, as the
    reference does, and the collectives stay flat and correct."""
    hvd.shutdown()
    monkeypatch.setenv(flag, "1")
    monkeypatch.setattr(logging.getLogger("horovod_tpu_torch"),
                        "propagate", True)
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
        hvd.init(device="cpu")
    try:
        eng = hvd.runtime.engine()
        assert eng._hier is None and eng.hier_local_size == 0
        assert any("no two-level structure" in rec.getMessage()
                   for rec in caplog.records)
        out = hvd.allgather(torch.ones(2, 3), name="h.warn.g")
        np.testing.assert_array_equal(out.numpy(), np.ones((2, 3)))
        out = hvd.allreduce(torch.ones(3), average=False, name="h.warn")
        np.testing.assert_array_equal(out.numpy(), np.ones(3))
    finally:
        hvd.shutdown()


def test_fusion_donate_is_read_and_ignored(monkeypatch):
    """Known difference: HOROVOD_FUSION_DONATE is the JAX package's XLA
    buffer donation of the fusion buffer. The port reads it as the
    reference does and changes nothing for it: a torch collective writes
    its buffer in place, so there is nothing to donate, and the fused
    results are the same bits either way."""
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(7).astype(np.float32) for _ in range(3)]
    outs = []
    for value in ("0", "1"):
        monkeypatch.setenv("HOROVOD_FUSION_DONATE", value)
        assert Config.from_env().fusion_donate == \
            JConfig.from_env().fusion_donate == int(value)
        hvd.init(device="cpu")
        try:
            hs = [hvd.allreduce_async(torch.from_numpy(x), average=False,
                                      name=f"donate.{i}")
                  for i, x in enumerate(xs)]
            outs.append([hvd.synchronize(h).numpy().copy() for h in hs])
        finally:
            hvd.shutdown()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
