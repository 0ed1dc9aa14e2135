"""The port's input pipeline (horovod_tpu_torch/data) against the JAX
package's (horovod_tpu/data).

The index math is copied, so it must match array for array over a grid
of (num_samples, size, batch, policy, remainder, steps_done), and
``rebuild_plan`` must re-shard a 4-rank position over 3 survivors as
the reference does. The loader is the port's own (pinned memory and a
side stream on a card; host tensors here): it must yield the batches
the reference's yields, prefetched or not, resume mid-epoch, and
re-shard exactly once across a membership change. Tolerance: exact
(integer indices and the same float values gathered).
"""

import time

import numpy as np
import pytest
import torch

from horovod_tpu import data as jdata
from horovod_tpu.data import sharding as jsh
from horovod_tpu.data import state as jst
from horovod_tpu_torch import data as tdata
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.data import sharding as tsh
from horovod_tpu_torch.data import state as tst

GRID = [(n, size, batch, policy, remainder)
        for n in (0, 1, 7, 20, 37)
        for size in (1, 3, 4)
        for batch in (1, 2, 5)
        for policy in ("contiguous", "strided")
        for remainder in ("pad", "drop")]


@pytest.mark.parametrize("n,seed,epoch,shuffle", [
    (0, 0, 0, True), (10, 0, 0, True), (257, 7, 3, True),
    (33, 2 ** 40, 1, True), (12, 5, 0, False)])
def test_epoch_permutation_matches_the_reference(n, seed, epoch, shuffle):
    np.testing.assert_array_equal(
        tsh.epoch_permutation(n, epoch, seed, shuffle),
        jsh.epoch_permutation(n, epoch, seed, shuffle))


@pytest.mark.parametrize("n,size,batch,policy,remainder", GRID)
def test_sharding_grid_matches_the_reference(n, size, batch, policy,
                                             remainder):
    """steps_for, every rank's shard_indices and remaining_after at every
    steps_done of the epoch, array for array."""
    g = jsh.epoch_permutation(n, 0, 11)
    steps = jsh.steps_for(n, size, batch, remainder)
    assert tsh.steps_for(n, size, batch, remainder) == steps
    for r in range(size):
        np.testing.assert_array_equal(
            tsh.shard_indices(g, r, size, batch, policy, remainder),
            jsh.shard_indices(g, r, size, batch, policy, remainder))
    for done in range(steps + 1):
        np.testing.assert_array_equal(
            tsh.remaining_after(g, done, size, batch, policy, remainder),
            jsh.remaining_after(g, done, size, batch, policy, remainder))


@pytest.mark.parametrize("policy", ["contiguous", "strided"])
@pytest.mark.parametrize("n,batch,steps_done", [(40, 2, 3), (37, 1, 5),
                                                (24, 2, 0), (50, 3, 2)])
def test_rebuild_plan_shrink_matches_the_reference(policy, n, batch,
                                                   steps_done):
    """A 4-rank position after ``steps_done`` steps, rebuilt on each of
    3 survivors: the same plans, steps, re-shard flags and mutated
    segment histories as the reference's, and every sample consumed
    exactly once over the epoch (pad duplicates aside)."""
    sd = {"epoch": 1, "seed": 3, "shuffle": True,
          "segments": [[4, steps_done]]}
    for r in range(3):
        ts, js = tst.IteratorState.from_dict(sd), \
            jst.IteratorState.from_dict(sd)
        tplan, tstep, tres = tst.rebuild_plan(n, ts, r, 3, batch, policy)
        jplan, jstep, jres = jst.rebuild_plan(n, js, r, 3, batch, policy)
        np.testing.assert_array_equal(tplan, jplan)
        assert (tstep, tres) == (jstep, jres)
        assert ts.to_dict() == js.to_dict()
    after = tst.IteratorState.from_dict(sd)
    tst.rebuild_plan(n, after, 0, 3, batch, policy)
    after.segments[-1][1] = tsh.steps_for(
        len(tsh.remaining_after(tsh.epoch_permutation(n, 1, 3), steps_done,
                                4, batch, policy)), 3, batch)
    assert tst.samples_consumed(n, after, batch, policy) == \
        jst.samples_consumed(n, after.to_dict(), batch, policy) == n


def test_iterator_state_codec_matches_the_reference():
    for sd in ({}, {"epoch": 2, "seed": 9, "shuffle": False,
                    "segments": [[4, 2], [3, 1]]}):
        assert tst.IteratorState.from_dict(sd).to_dict() == \
            jst.IteratorState.from_dict(sd).to_dict()


def test_sharding_validation_errors_match():
    for fn, args in ((tsh.shard_indices, (10, 3, 3)),
                     (tsh.steps_for, (10, 0, 2)),
                     (tsh.epoch_permutation, (-1,))):
        with pytest.raises(ValueError):
            fn(*args)
    with pytest.raises(ValueError, match="policy must be one of"):
        tsh.shard_indices(10, 0, 2, policy="blocks")
    with pytest.raises(ValueError, match="remainder must be one of"):
        tsh.steps_for(10, 2, 2, remainder="wrap")


# ------------------------------------------------------------------ loader

def _arrays(n=40):
    x = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 3),
                                                          np.float32)
    return x, np.arange(n)


@pytest.mark.parametrize("depth", [0, 3])
def test_batches_match_the_reference_loader(depth):
    """Two epochs (the per-epoch reshuffle), rank 1 of 2: the port's
    batches, prefetched or inline, are the reference's."""
    x, y = _arrays()
    ours = tdata.DistributedDataset((x, y), 4, seed=5, rank=1, size=2,
                                    prefetch=depth, device="cpu")
    ref = jdata.DistributedDataset((x, y), 4, seed=5, rank=1, size=2,
                                   prefetch=0)
    got, want = [], []
    for _ in range(2):
        got += [(xb.numpy().copy(), yb.numpy().copy()) for xb, yb in ours]
        want += [(np.asarray(xb), np.asarray(yb)) for xb, yb in ref]
    ours.close()
    ref.close()
    assert len(got) == len(want) == 10
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert ours.epoch == ref.epoch == 2


def test_mid_epoch_resume_roundtrip():
    src = {"i": np.arange(30)}
    ds = tdata.DistributedDataset(src, 3, seed=2, rank=0, size=2,
                                  prefetch=2, device="cpu")
    it = iter(ds)
    for _ in range(2):
        next(it)
    sd = ds.state_dict()
    rest = [b["i"].tolist() for b in it]
    ds.close()
    ds2 = tdata.DistributedDataset(src, 3, seed=2, rank=0, size=2,
                                   prefetch=2, device="cpu")
    ds2.load_state_dict(sd)
    assert [b["i"].tolist() for b in ds2] == rest and len(rest) == 3
    ds2.close()


@pytest.mark.parametrize("policy", ["contiguous", "strided"])
def test_membership_change_reshards_exact_once(policy):
    """4 ranks consume 2 steps, one dies, 3 survivors load the committed
    position: every sample exactly once, one re-shard a survivor."""
    n = 20
    before = tmetrics.DATA_RESHARDS.value()
    olds = [tdata.DistributedDataset(np.asarray, 1, num_samples=n, seed=9,
                                     rank=r, size=4, prefetch=0,
                                     policy=policy, device="cpu")
            for r in range(4)]
    seen, sds = [], []
    for ds in olds:
        it = iter(ds)
        seen += [int(next(it)[0]) for _ in range(2)]
        sds.append(ds.state_dict())
    assert all(sd == sds[0] for sd in sds)
    for r in range(3):
        surv = tdata.DistributedDataset(np.asarray, 1, num_samples=n,
                                        seed=9, rank=r, size=3, prefetch=1,
                                        policy=policy, device="cpu")
        surv.load_state_dict(sds[0])
        assert surv.steps_remaining == 4
        seen += [int(b[0]) for b in surv]
        surv.close()
    assert sorted(seen) == list(range(n))
    assert tmetrics.DATA_RESHARDS.value() - before == 3


def test_input_wait_telemetry_and_take_wait():
    def slow(idx):
        time.sleep(0.005)
        return np.asarray(idx)

    before = tmetrics.snapshot()["hvd_data_input_wait_seconds"][
        "values"].get("", {"count": 0})["count"]
    ds = tdata.DistributedDataset(slow, 2, num_samples=8, seed=0, rank=0,
                                  size=1, prefetch=0, device="cpu")
    for _ in ds:
        pass
    assert ds.take_wait() >= 4 * 0.005
    assert ds.take_wait() == 0.0
    assert ds.prefetch_occupancy() is None
    after = tmetrics.snapshot()["hvd_data_input_wait_seconds"]["values"][
        ""]["count"]
    assert after - before == 4


def test_transform_and_callable_source():
    ds = tdata.DistributedDataset(
        lambda idx: np.asarray(idx) * 10, 2, num_samples=6, seed=0,
        shuffle=False, rank=0, size=1, prefetch=2, device="cpu",
        transform=lambda b: b + 1)
    assert [b.tolist() for b in ds] == [[1, 11], [21, 31], [41, 51]]


def test_loader_validation_errors():
    with pytest.raises(ValueError, match="num_samples"):
        tdata.DistributedDataset(np.asarray, 2, device="cpu")
    with pytest.raises(ValueError, match="disagree on length"):
        tdata.DistributedDataset((np.zeros(3), np.zeros(4)), 1,
                                 device="cpu")
    with pytest.raises(ValueError, match="together"):
        tdata.DistributedDataset(np.zeros(4), 1, rank=0, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        tdata.DistributedDataset(np.zeros(4), 0, device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdata.DistributedDataset(np.zeros(4), 1)


def test_process_topology_follows_the_runtime():
    import horovod_tpu_torch as hvd
    assert tdata.process_topology() == (0, 1)
    hvd.init(device="cpu")
    try:
        assert tdata.process_topology() == (hvd.rank(), hvd.size())
        ds = tdata.DistributedDataset(np.zeros(8), 2, device="cpu")
        assert (ds.rank, ds.size, ds.steps_per_epoch) == (0, 1, 4)
        assert ds._autotuner() is None
    finally:
        hvd.shutdown()


def test_attach_to_state_commit_and_restore():
    """Commit pairs the input position with the model state; restore
    rewinds both: the rolled-back batches replay (against the
    reference's permutation)."""
    from horovod_tpu_torch import elastic
    ds = tdata.DistributedDataset(np.asarray, 1, num_samples=12, seed=3,
                                  rank=0, size=1, prefetch=0, device="cpu")
    st = elastic.State(w=torch.zeros(1), step=0)
    tdata.attach_to_state(st, ds)
    it = iter(ds)
    committed = [int(next(it)[0]) for _ in range(3)]
    st.commit()
    rolled_back = [int(next(it)[0]) for _ in range(2)]
    st.restore()
    replay = [int(b[0]) for b in ds]
    assert replay[:2] == rolled_back
    assert committed + replay == [int(i) for i in
                                  jsh.epoch_permutation(12, 0, 3)]
