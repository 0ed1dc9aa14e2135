"""The port's elastic training (horovod_tpu_torch/elastic, the
coordinator's liveness and departure records, ``init(comm=...)``) and
its callbacks against the JAX package's.

In process: ``State`` commits and restores in place; ``classify_exit``,
``describe_exit``, ``RestartPolicy``, the signal files and
``AutoscalePolicy`` give the reference's decisions for the same inputs
(exact); the learning-rate callbacks walk the reference's rates (exact
floats); the rendezvous agrees, drops a straggler after the settle
window and times out as the reference's; the coordinator declares a
silent worker lost exactly once, in the reference's decision format.

Over gloo (tests/torch_ranks.py, tests/torch_elastic_workers.py): one of
three ranks SIGKILLs itself at a known step and the survivors recover
through ``hvd.elastic.run`` with every sample consumed exactly once; a
SIGTERM departure through the preemption grace recovers without waiting
out the liveness timeout; a lost worker fails every engine handle with
WorkerLostError; the rendezvous over the job's TCPStore. Every wait is
bounded (the elastic timeout is 5 s, the launcher's 90 s).
"""

import json
import os
import threading
import time
import types

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import callbacks as jcallbacks
from horovod_tpu.elastic import policy as jpolicy
from horovod_tpu.elastic import supervisor as jsup
from horovod_tpu_torch import callbacks as tcallbacks
from horovod_tpu_torch.config import Config
from horovod_tpu_torch.coordinator import MultiHostCoordinator
from horovod_tpu_torch.elastic import policy as tpolicy
from horovod_tpu_torch.elastic import supervisor as tsup
from horovod_tpu_torch.elastic.rendezvous import rendezvous
from horovod_tpu_torch.exceptions import CoordinatorError, HorovodError
from horovod_tpu_torch.utils.store_kv import StoreKV

import torch_elastic_workers as workers
from torch_ranks import spawn_ranks

ELASTIC_ENV = {"HOROVOD_ELASTIC": "1", "HOROVOD_ELASTIC_TIMEOUT_SECONDS": "5",
               "HOROVOD_ELASTIC_SETTLE_SECONDS": "2"}


@pytest.fixture(autouse=True)
def _fresh_runtime():
    yield
    hvd.shutdown()


# ----------------------------------------------------------------- State

def test_state_commit_restore_in_place():
    """restore() writes into the same tensors (a captured graph keeps
    reading them), bitwise, optimizer state and scalars included."""
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    st = hvd.elastic.State(model=model, optimizer=opt, step=1,
                           extra=[torch.ones(2), {"k": torch.zeros(1)}])
    st.commit()
    want = ([p.detach().clone() for p in model.parameters()],
            [v.clone() for p in model.parameters()
             for v in opt.state[p].values()])
    ptrs = [p.data_ptr() for p in model.parameters()]
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    st.step = 9
    st.extra[0].add_(1)
    st.restore()
    assert st.step == 1 and torch.equal(st.extra[0], torch.ones(2))
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    for a, b in zip(want[0], model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(want[1], [v for p in model.parameters()
                               for v in opt.state[p].values()]):
        assert torch.equal(a, b)


def test_state_commit_is_a_snapshot_and_buffers_alternate():
    w = torch.zeros(3)
    st = hvd.elastic.State(w=w)
    st.commit()
    first = st.committed["w"]
    w.add_(1)
    st.commit()
    second = st.committed["w"]
    w.add_(1)
    st.commit()
    assert st.committed["w"] is first          # the spare set, reused
    assert second is not first and torch.equal(second, torch.ones(3))
    st.restore()
    assert torch.equal(w, torch.full((3,), 2.0))


def test_state_fields_hooks_and_callbacks():
    st = hvd.elastic.State(a=1, b=torch.ones(1))
    order = []
    st.register_commit_hook(lambda: order.append("pre"))
    st.register_post_commit_hook(lambda: order.append("post"))
    st.register_reset_callback(lambda: order.append("reset"))
    assert st.commit() == 1 and order == ["pre", "post"]
    st.a = 5
    st.restore()
    assert st.a == 1 and order[-1] == "reset"
    assert set(st.fields) == {"a", "b"}
    with pytest.raises(AttributeError):
        st.missing
    with pytest.raises(TypeError):
        hvd.elastic.State(bad=object()).commit()


def test_state_grace_save_and_preference(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC_GRACE_DIR", str(tmp_path))
    assert hvd.elastic.State(w=torch.ones(1)).save_grace() is not None
    one = hvd.elastic.State(w=torch.ones(2))
    one.save_grace(path=str(tmp_path / "grace-0.pt"))
    two = hvd.elastic.State(w=torch.full((2,), 2.0))
    two.commit()
    two.commit()
    two.save_grace(path=str(tmp_path / "grace-1.pt"))
    fresh = hvd.elastic.State(w=torch.zeros(2))
    fresh.restore()
    assert torch.equal(fresh.w, torch.full((2,), 2.0))
    assert fresh.commits == 2
    mem = hvd.elastic.State(w=torch.full((2,), 7.0))
    mem.commit()
    mem.w.zero_()
    mem.restore()                      # an in-memory commit wins
    assert torch.equal(mem.w, torch.full((2,), 7.0))


# ------------------------------------------------- supervisor and policy

@pytest.mark.parametrize("code", [0, 1, 2, 75, 79, 124, 137, -9, -15, -2])
def test_exit_classification_matches_the_reference(code):
    assert tsup.classify_exit(code) == jsup.classify_exit(code)
    assert tsup.describe_exit(code) == jsup.describe_exit(code)
    assert tsup.EX_PREEMPTED == jsup.EX_PREEMPTED


@pytest.mark.parametrize("kw", [{}, {"max_restarts": 5, "base_delay": 0.5,
                                     "factor": 3.0, "max_delay": 4.0},
                                {"max_restarts": 0}])
def test_restart_policy_matches_the_reference(kw):
    t, j = tsup.RestartPolicy(**kw), jsup.RestartPolicy(**kw)
    for _ in range(7):
        assert t.should_retry() == j.should_retry()
        if not j.should_retry():
            break
        assert t.next_delay() == j.next_delay()


def _signals(i):
    return [{"rank": r, "time": 1000.0 + i, "skew": 1.0 + 0.3 * (i % 4),
             "stall": 0.6 if i in (7, 8, 9) else 0.1,
             "occupancy": 0.95 if i >= 11 else 0.5, "step": i,
             "step_seconds": 0.1 * (r + 1)} for r in range(3)] + (
        [{"tag": "serve0", "time": 1000.0 + i, "p99_latency": 0.3,
          "queue_depth": 4}] if i % 5 == 0 else [])


@pytest.mark.parametrize("kw", [
    {}, {"hysteresis": 1, "cooldown_seconds": 2.0},
    {"min_workers": 3, "max_workers": 3},
    {"p99_high": 0.2, "queue_high": 3, "hysteresis": 2}])
def test_autoscale_policy_decisions_match_the_reference(kw):
    t, j = tpolicy.AutoscalePolicy(**kw), jpolicy.AutoscalePolicy(**kw)
    world = 3
    for i in range(16):
        sig = _signals(i)
        assert tpolicy.aggregate_signals(sig) == \
            jpolicy.aggregate_signals(sig)
        a = t.observe(sig, world, now=1000.0 + i,
                      budget_exhausted=i == 13)
        b = j.observe(sig, world, now=1000.0 + i,
                      budget_exhausted=i == 13)
        assert repr(a) == repr(b)
        if a.direction != "hold":
            t.record_resize(now=1000.0 + i)
            j.record_resize(now=1000.0 + i)
            world = a.target


def test_signal_files_read_and_compact_as_the_reference(tmp_path):
    for r in range(3):
        tpolicy.write_signal(str(tmp_path), r, {"rank": r, "time": 100.0 + r,
                                                "skew": 1.0 + r})
    tpolicy.write_signal(str(tmp_path), "old", {"rank": 9, "time": 1.0})
    got = tpolicy.read_signals(str(tmp_path), max_age=30, now=110.0,
                               prune_after=1000)
    want = jpolicy.read_signals(str(tmp_path), max_age=30, now=110.0,
                                prune_after=1000)
    assert got == want and len(got) == 3
    assert tpolicy.compact_signals(str(tmp_path), now=110.0) == 3
    assert jpolicy.read_signals(str(tmp_path), max_age=30, now=110.0) == \
        tpolicy.read_signals(str(tmp_path), max_age=30, now=110.0)


# -------------------------------------------------------------- callbacks

def _lr_run(mod, opt, cb_factory, epochs, steps):
    cb = cb_factory(mod, opt)
    cb.on_train_begin()
    lrs = []
    for e in range(epochs):
        cb.on_epoch_begin(e)
        for b in range(steps):
            cb.on_batch_begin(b)
            lrs.append((opt.lr, getattr(opt, "momentum", None)))
            cb.on_batch_end(b)
        logs = {}
        cb.on_epoch_end(e, logs)
        lrs.append(logs.get("lr"))
    return lrs


@pytest.mark.parametrize("which", ["schedule", "staircase", "warmup"])
def test_lr_callbacks_walk_the_reference_rates(monkeypatch, which):
    monkeypatch.setattr(jcallbacks, "size", lambda: 4)
    monkeypatch.setattr(tcallbacks, "size", lambda: 4)

    def factory(mod, opt):
        if which == "schedule":
            return mod.LearningRateScheduleCallback(
                opt, lambda e: 0.5 ** e, staircase=False,
                steps_per_epoch=3, start_epoch=1)
        if which == "staircase":
            return mod.LearningRateScheduleCallback(opt, 0.1, end_epoch=2)
        return mod.LearningRateWarmupCallback(opt, warmup_epochs=2,
                                              steps_per_epoch=3)

    got = _lr_run(tcallbacks, types.SimpleNamespace(lr=0.8, momentum=0.9),
                  factory, 3, 3)
    want = _lr_run(jcallbacks, types.SimpleNamespace(lr=0.8, momentum=0.9),
                   factory, 3, 3)
    assert got == want


def test_lr_rescale_follows_the_world(monkeypatch):
    sizes = iter([4, 4, 2, 2, 2, 2])
    monkeypatch.setattr(tcallbacks, "size", lambda: next(sizes))
    monkeypatch.setattr(tcallbacks, "is_initialized", lambda: True)
    opt = types.SimpleNamespace(lr=0.8)
    cb = tcallbacks.LearningRateRescaleCallback(opt, ramp_steps=2)
    cb.on_train_begin()
    seen = []
    for b in range(4):
        cb.on_batch_begin(b)
        seen.append(opt.lr)
    assert seen == [0.8, 0.6000000000000001, 0.4, 0.4]
    assert hvd.resize_lr_factor(4, 1, "sqrt") == 0.5


def test_tensor_lr_is_filled_in_place():
    p = torch.nn.Parameter(torch.ones(1))
    lr = torch.tensor(0.8)
    opt = torch.optim.AdamW([p], lr=lr)
    cb = tcallbacks.LearningRateScheduleCallback(opt, 0.5)
    cb.on_train_begin()
    cb.on_epoch_begin(0)
    cb.on_batch_begin(0)
    assert opt.param_groups[0]["lr"] is lr
    assert float(lr) == float(torch.tensor(0.8 * 0.5))   # f32 storage


def test_broadcast_metric_and_elastic_callbacks():
    hvd.init(device="cpu")
    model = torch.nn.Linear(2, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tcallbacks.BroadcastGlobalVariablesCallback(
        0, get_state=lambda: model).on_train_begin()
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())
    logs = {"loss": 2.5, "name": "x"}
    tcallbacks.MetricAverageCallback().on_epoch_end(0, logs)
    assert logs == {"loss": 2.5, "name": "x"}
    st = hvd.elastic.State(w=torch.zeros(1))
    cb = tcallbacks.ElasticStateCallback(st, commit_every=2)
    for b in range(5):
        cb.on_batch_end(b)
    cb.on_epoch_end(0)
    assert st.commits == 3
    guard_cb = tcallbacks.GuardCallback(state=st)
    guard_cb.on_train_begin()
    logs = {}
    guard_cb.on_batch_end(0, logs)
    assert logs == {}                   # no guard installed: no-op


# ------------------------------------------------------------- rendezvous

def _kv():
    return StoreKV(torch.distributed.HashStore())


def test_rendezvous_full_membership_agreement():
    kv, results = _kv(), {}

    def worker(pid):
        results[pid] = rendezvous(1, [0, 1, 2], pid, settle=0.2,
                                  timeout=10.0, client=kv)

    threads = [threading.Thread(target=worker, args=(p,)) for p in (1, 2)]
    for t in threads:
        t.start()
    worker(0)
    for t in threads:
        t.join(timeout=10)
    assert results == {0: [0, 1, 2], 1: [0, 1, 2], 2: [0, 1, 2]}
    assert not kv.store.check(["hvd/elastic/rdzv/1/join/1"])


def test_rendezvous_drops_straggler_and_times_out():
    kv, results = _kv(), {}
    t = threading.Thread(target=lambda: results.__setitem__(
        1, rendezvous(2, [0, 1, 2], 1, settle=0.2, timeout=10.0,
                      client=kv)))
    t.start()
    assert rendezvous(2, [0, 1, 2], 0, min_workers=2, settle=0.2,
                      timeout=10.0, client=kv) == [0, 1]
    t.join(timeout=10)
    assert results[1] == [0, 1]
    with pytest.raises(CoordinatorError, match="timed out"):
        rendezvous(3, [0, 1], 0, min_workers=2, settle=0.05, timeout=0.3,
                   client=kv)
    with pytest.raises(CoordinatorError, match="survivor set"):
        rendezvous(4, [0, 1], 5, client=kv)


# ------------------------------------------ coordinator liveness records

def _coord_pair(**cfg_kw):
    kv = _kv()
    cfg = Config(**cfg_kw)
    return [MultiHostCoordinator(cfg, 2, client=kv, process_index=p,
                                 process_count=2, namespace="hvd/t/coord")
            for p in (0, 1)], kv


def _aborts(kv, n=32):
    out = []
    for i in range(n):
        if kv.store.check([f"hvd/t/coord/dec/{i}"]):
            d = json.loads(kv.store.get(f"hvd/t/coord/dec/{i}").decode())
            if d.get("abort"):
                out.append(d["abort"])
    return out


def test_coordinator_declares_a_silent_worker_lost_once():
    """The reference's record: one worker_lost abort naming the silent
    process, epoch 1; a beating worker is never declared."""
    (c0, c1), kv = _coord_pair(elastic=True, elastic_timeout_seconds=0.3)
    for _ in range(3):
        c1._live_published_t = float("-inf")
        c1.publish_liveness()
        c0.elastic_round()
        time.sleep(0.12)
    assert _aborts(kv) == []
    deadline = time.perf_counter() + 5.0
    while time.perf_counter() < deadline and not _aborts(kv):
        c0.elastic_round()
        time.sleep(0.05)
    for _ in range(5):
        c0.elastic_round()
    assert _aborts(kv) == [{"kind": "worker_lost", "lost_pids": [1],
                            "epoch": 1}]
    fetched = c1.fetch_decisions(timeout_ms=1)
    assert any(d.get("abort", {}).get("lost_pids") == [1] for d in fetched)
    for c in (c0, c1):
        c.close()


def test_coordinator_departure_hosts_updated_and_guard_records():
    (c0, c1), kv = _coord_pair(elastic=True)
    c1.announce_departure()
    assert c0.departed() == [1]
    assert c0.elastic_round()
    c0.announce_hosts_updated()
    c0.append_guard({"step": 3, "ok": False, "action": "skip"})
    assert _aborts(kv) == [
        {"kind": "planned_departure", "lost_pids": [1], "epoch": 1},
        {"kind": "hosts_updated", "lost_pids": [], "epoch": 2}]
    fetched = c1.fetch_decisions(timeout_ms=1)
    assert fetched[-1]["guard"]["action"] == "skip"
    with pytest.raises(ValueError, match="process 0"):
        c1.announce_hosts_updated()
    for c in (c0, c1):
        c.close()


def test_init_comm_validates_as_the_reference():
    for bad, match in ((object(), "no MPI"), ([0, 0], "duplicate"),
                       ([0, 99], "out of range"), ([], "names no rank")):
        with pytest.raises(ValueError, match=match):
            hvd.init(comm=bad, device="cpu")
        assert not hvd.is_initialized()
    hvd.init(comm=[0], device="cpu")
    assert hvd.runtime.members() == [0] and hvd.runtime.world_rank() == 0


@pytest.mark.parametrize("message,lost", [
    ("[gloo/transport/tcp/pair.cc:534] Connection closed by peer "
     "[127.0.0.1]:41234", True),
    ("[gloo/transport/tcp/pair.cc:598] Read error [127.0.0.1]:41234: "
     "Connection reset by peer", True),
    ("[gloo/transport/tcp/unbound_buffer.cc:81] Timed out waiting 5000ms "
     "for recv operation to complete", True),
    ("NCCL error in: ProcessGroupNCCL.cpp:1970, unhandled cuda error", False),
    ("CUDA error: operation not permitted when stream is capturing", False),
    ("Socket Timeout", False),
])
def test_peer_error_translates_only_a_lost_peer(monkeypatch, message, lost):
    """Under HOROVOD_ELASTIC gloo's closed or reset connection and its
    timed-out send or receive are a lost worker; any other backend error
    (NCCL's, a CUDA fault, a store's) is itself, and so is every error
    without elastic training."""
    from horovod_tpu_torch.exceptions import WorkerLostError
    from horovod_tpu_torch.ops.collectives import peer_error
    err = torch.distributed.DistBackendError(message)
    hvd.init(device="cpu")
    assert peer_error(err) is err
    hvd.shutdown()
    for k, v in ELASTIC_ENV.items():
        monkeypatch.setenv(k, v)
    hvd.init(device="cpu")
    got = peer_error(err)
    if lost:
        assert isinstance(got, WorkerLostError) and got.__cause__ is err
    else:
        assert got is err


def _run_raising(monkeypatch, err):
    for k, v in dict(ELASTIC_ENV, HOROVOD_ELASTIC_SETTLE_SECONDS="0.2"
                     ).items():
        monkeypatch.setenv(k, v)
    hvd.init(device="cpu")
    calls = []

    @hvd.elastic.run
    def train(state):
        calls.append(state.step)
        raise err

    with pytest.raises(type(err)) as info:
        train(hvd.elastic.State(step=0))
    assert info.value is err
    return calls


def test_a_non_peer_backend_error_leaves_elastic_run(monkeypatch):
    """An NCCL or CUDA fault is no lost peer: it leaves elastic.run as it
    was raised, after one call, and the session stays up."""
    err = torch.distributed.DistBackendError(
        "NCCL error in: ProcessGroupNCCL.cpp:1970, unhandled cuda error")
    assert _run_raising(monkeypatch, err) == [0]
    assert hvd.is_initialized()


def test_a_recovery_that_loses_no_worker_raises_the_error(monkeypatch):
    """gloo's closed connection is taken for a lost peer; when every
    worker rejoins the rendezvous nobody was lost, and elastic.run raises
    the collective's error instead of calling the function again."""
    err = RuntimeError("[gloo/transport/tcp/pair.cc:534] Connection "
                       "closed by peer [127.0.0.1]:41234")
    assert _run_raising(monkeypatch, err) == [0]
    assert not hvd.is_initialized()


# ---------------------------------------------------------- over gloo

def _consumed(out_dir):
    ids = []
    for f in sorted(os.listdir(out_dir)):
        if f.startswith("consumed-"):
            for line in open(os.path.join(out_dir, f)):
                ids += json.loads(line)["ids"]
    return ids


def test_sigkill_recovery_consumes_every_sample_once(tmp_path):
    """Rank 2 of 3 SIGKILLs itself before its step-2 exchange: ranks 0
    and 1 raise WorkerLostError, re-rendezvous, init(comm=[0, 1]),
    restore the commit and finish the epoch; every sample exactly once."""
    out = spawn_ranks(3, workers.elastic_training, str(tmp_path), 2, 2,
                      "kill", env=ELASTIC_ENV, timeout=90, exits={2: -9})
    assert out[2] is None
    for rec in out[:2]:
        assert rec["recoveries"] == 1 and rec["sizes"] == [3, 2]
        assert rec["step"] == 2 + (workers.NUM_SAMPLES - 12) // 4
    for a, b in zip(out[0]["params"], out[1]["params"]):
        assert torch.equal(a, b)
    assert sorted(_consumed(tmp_path)) == list(range(workers.NUM_SAMPLES))


def test_sigterm_departure_recovers_without_the_liveness_timeout(tmp_path):
    """Rank 2 receives SIGTERM before step 1: it finishes the step,
    commits, writes its grace file, announces its departure and exits
    79; the survivors see a planned departure (HostsUpdatedError), wait
    no settle window or timeout, and finish with every sample once."""
    env = dict(ELASTIC_ENV, HOROVOD_ELASTIC_GRACE_SECONDS="20",
               HOROVOD_ELASTIC_GRACE_DIR=str(tmp_path / "grace"))
    out = spawn_ranks(3, workers.elastic_training, str(tmp_path), 2, 1,
                      "term", env=env, timeout=90,
                      exits={2: tsup.EX_PREEMPTED})
    assert os.path.exists(tmp_path / "grace" / "grace-2.pt")
    for rec in out[:2]:
        assert rec["recoveries"] == 1 and rec["sizes"] == [3, 2]
        # below the settle window (2 s), far below the timeout (5 s)
        assert rec["recovery_s"] < 2.0
    assert sorted(_consumed(tmp_path)) == list(range(workers.NUM_SAMPLES))


def test_a_lost_worker_fails_every_handle():
    out = spawn_ranks(3, workers.lost_worker_handles, 2,
                      env=dict(ELASTIC_ENV,
                               HOROVOD_ELASTIC_TIMEOUT_SECONDS="2"),
                      timeout=90, exits={2: 0})
    for rec in out[:2]:
        assert rec["errors"] == ["WorkerLostError"] * 3
        assert rec["waited"] < 30


def test_rendezvous_over_the_job_store_drops_the_straggler():
    out = spawn_ranks(3, workers.rendezvous_agreement, 1, [0, 1, 2], 2, 0.5,
                      timeout=60)
    assert out[0]["members"] == out[1]["members"] == [0, 1]
    assert "dropped from the membership view" in out[2]["straggler"]
    assert issubclass(CoordinatorError, HorovodError)
