"""The eager engine on the card (marker ``cuda``; skipped without one).

Run there without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_engine.py``. One rank over NCCL: a gradient still
being written on its producer's stream when it is submitted is read by
the engine's copy only after the producer's event; results stay on the
card, and a profiled exchange copies nothing to the host; a batch of one
in-place tensor at the threshold is reduced in place; the engine refuses
a CUDA graph capture; the autotuner's exposed wire time is the
consumer stream's stall at the hand-over.
"""

import time

import pytest
import torch

import horovod_tpu_torch as hvd

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    hvd.init()
    yield torch.device("cuda", torch.cuda.current_device())
    hvd.shutdown()


def test_a_bucket_waits_for_its_producer_stream(card):
    side = torch.cuda.Stream()
    x = torch.zeros(1 << 22, device=card)
    others = [torch.full((1024,), float(i), device=card) for i in range(3)]
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)  # the producer is still busy
        x.fill_(3.0)
        h = hvd.allreduce_async(x, average=False, name="producer")
    hs = [hvd.allreduce_async(t, average=False, name=f"o{i}")
          for i, t in enumerate(others)]
    out = hvd.synchronize(h)
    assert out.is_cuda and torch.equal(out, torch.full_like(x, 3.0))
    for i, h in enumerate(hs):
        assert torch.equal(hvd.synchronize(h), others[i])


def test_results_stay_on_the_card_with_no_host_copy(card):
    from torch.profiler import ProfilerActivity, profile
    grads = [torch.randn(n, device=card) for n in (1000, 4096, 77)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        hs = [hvd.allreduce_async_(g, name=f"g{i}")
              for i, g in enumerate(grads)]
        outs = [hvd.synchronize(h) for h in hs]
        gathered = hvd.allgather(grads[2].view(77, 1), name="ag")
        bcast = hvd.broadcast(grads[0], 0, name="bc")
        torch.cuda.synchronize()
    assert all(o is g for o, g in zip(outs, grads))
    assert gathered.is_cuda and bcast.is_cuda
    names = [e.name for e in prof.events()]
    assert not [n for n in names if "DtoH" in n or "Device -> P" in n]


def test_an_inplace_bucket_at_the_threshold_is_reduced_in_place(card,
                                                                 monkeypatch):
    hvd.shutdown()
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(1 << 20))
    hvd.init()
    t = torch.arange(1 << 18, device=card, dtype=torch.float32)
    ptr = t.data_ptr()
    assert hvd.allreduce_(t, name="big") is t and t.data_ptr() == ptr
    assert torch.equal(t, torch.arange(1 << 18, device=card,
                                       dtype=torch.float32))


def test_the_engine_refuses_a_graph_capture(card):
    s = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    x = torch.ones(2, device=card)
    with torch.cuda.stream(s):
        with pytest.raises(hvd.HorovodError, match="captured"):
            with torch.cuda.graph(graph, stream=s):
                hvd.allreduce_async(x, name="cap")


def test_the_tuners_exposed_time_is_the_consumer_streams_stall(
        card, monkeypatch):
    """The host's wait on a collective does not block on a card, so the
    engine feeds the tuner how long the consumer's stream stalled at the
    bucket's hand-over: about the engine stream's delay when the bucket
    ends late, little when the consumer computes past the bucket."""
    hvd.shutdown()
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "0")
    hvd.init()
    state = hvd.runtime.live_state()
    engine, tuner = state.engine, state.autotuner
    fed = []
    monkeypatch.setattr(tuner, "record_overlap",
                        lambda hidden, exposed: fed.append(exposed))
    x = torch.ones(1 << 20, device=card)
    # NCCL sets its communicator up at the first collective, and the
    # host waits for the card there
    hvd.synchronize(hvd.allreduce_async(x, name="exposed.warm-up"))

    def exposed(engine_late):
        torch.cuda.synchronize()
        fed.clear()
        if engine_late:
            with torch.cuda.stream(engine._stream):
                torch.cuda._sleep(100_000_000)
        h = hvd.allreduce_async(x, name=f"exposed.{engine_late}")
        if not engine_late:
            torch.cuda._sleep(100_000_000)  # computes past the bucket
        t0 = time.perf_counter()
        hvd.synchronize(h)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        with engine._cv:
            engine._feed_exposure()
        assert len(fed) == 1 and not engine._exposure
        return fed[0], host

    late, early = exposed(True), exposed(False)
    # (exposed s, the host's time in synchronize) of each case
    assert late[0] >= 0.02 and 0.0 <= early[0] < 0.5 * late[0], (late, early)
