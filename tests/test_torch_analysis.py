"""The port's hvdlint and lock witness (horovod_tpu_torch/analysis/)
against the JAX package's (horovod_tpu/analysis/).

Spec: tests/test_analysis.py. Each of its cases that the two rule sets
share runs through both engines, on the same snippet placed at each
package's counterpart path, and the two must give the same ``(rule,
line)`` findings: HVD001 on the reference's names, HVD002, HVD003,
HVD004, the suppression and baseline machinery and the CLI. The lock
witness's cases run on both witnesses. Then the port's own readings:
``torch.distributed``'s collectives under a rank branch, host clocks
and RNG inside a CUDA graph capture, and a tensor read while an
in-place async collective may still write it. The port's tree must be
lint-clean with no baseline, and the port's witness, installed around
its eager engine, coordinator and metrics registry at one rank and over
two gloo ranks, must see no lock-order cycle.
"""

import os
import textwrap
import threading

import pytest

from horovod_tpu.analysis import core as jcore
from horovod_tpu.analysis import lockwitness as jwitness
from horovod_tpu_torch.analysis import core as tcore
from horovod_tpu_torch.analysis import lockwitness as twitness
from torch_analysis_workers import witnessed_engine
from torch_ranks import spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# engine -> (core module, package directory)
ENGINES = {"jax": (jcore, "horovod_tpu"),
           "torch": (tcore, "horovod_tpu_torch")}
WITNESSES = {"jax": jwitness, "torch": twitness}
# where a snippet lives, below each package's directory
PLACES = {"mod": "fake_mod.py", "config": "config.py", "critical": "wire.py"}


def lint(engine, text, where="mod", select=None):
    core, package = ENGINES[engine]
    rules = core.all_rules()
    if select:
        rules = [r for r in rules if r.rule_id in select]
    path = os.path.join(ROOT, package, PLACES[where])
    return core.lint_file(path, ROOT, rules=rules,
                          text=textwrap.dedent(text))


def keys(findings):
    return [(f.rule, f.line) for f in findings]


# ------------------------------------------------ shared cases, both engines

# (id, rules selected, where, snippet, rule ids the reference finds)
SHARED = [
    ("hvd001_rank_branch", {"HVD001"}, "mod", """
        def step(hvd, x):
            if hvd.rank() == 0:
                hvd.allreduce(x)
    """, ["HVD001"]),
    ("hvd001_rank_attr_ifexp", {"HVD001"}, "mod", """
        def step(state, hvd, x):
            y = hvd.broadcast(x) if state.my_rank == 0 else None
            return y
    """, ["HVD001"]),
    ("hvd001_symmetric", {"HVD001"}, "mod", """
        def step(hvd, x):
            y = hvd.allreduce(x)
            if hvd.rank() == 0:
                print(y)
            return y
    """, []),
    ("hvd001_math_namesakes", {"HVD001"}, "mod", """
        def step(hvd, x):
            if hvd.rank() == 0:
                return lax.broadcast(x, (8,)) + jnp.alltoall
    """, []),
    ("hvd001_def_resets_scope", {"HVD001"}, "mod", """
        def setup(hvd):
            if hvd.rank() == 0:
                def reduce_fn(x):
                    return hvd.allreduce(x)
                return reduce_fn
    """, []),
    ("hvd002_unlocked_and_closure", {"HVD002"}, "mod", """
        class Engine:
            _GUARDED_BY = {"_table": "_lock"}
            _LOCK_ALIASES = {"_cv": "_lock"}

            def __init__(self):
                self._table = {}

            def good(self):
                with self._lock:
                    self._table["a"] = 1

            def good_via_condition_alias(self):
                with self._cv:
                    return len(self._table)

            def bad(self):
                return self._table.get("a")

            def _pop_locked(self):
                return self._table.pop("a")

            def closure_escapes_lock(self):
                with self._lock:
                    def run():
                        return self._table
                    return run
    """, ["HVD002", "HVD002"]),
    ("hvd002_tuple_declaration", {"HVD002"}, "mod", """
        class Pool:
            _GUARDED_BY = ("_rows",)

            def bad(self):
                return self._rows

            def good(self):
                with self._lock:
                    return self._rows
    """, ["HVD002"]),
    ("hvd002_undeclared", {"HVD002"}, "mod", """
        class Free:
            def anything(self):
                return self._table
    """, []),
    ("hvd003_knob_reads", {"HVD003"}, "mod", """
        import os
        a = os.environ.get("HOROVOD_FUSION_THRESHOLD", "0")
        b = os.environ["HOROVOD_CYCLE_TIME"]
        c = os.getenv("PADDING_ALGO")
    """, ["HVD003"] * 3),
    ("hvd003_config_allowed", {"HVD003"}, "config", """
        import os
        a = os.environ.get("HOROVOD_FUSION_THRESHOLD", "0")
    """, []),
    ("hvd003_non_knobs", {"HVD003"}, "mod", """
        import os
        path = os.environ.get("PATH", "")
        home = os.environ["HOME"]
    """, []),
    ("hvd004_unannotated", {"HVD004"}, "critical", """
        def dispatch():
            try:
                send()
            except Exception:
                pass
    """, ["HVD004"]),
    ("hvd004_bare_with_comment", {"HVD004"}, "critical", """
        def dispatch():
            try:
                send()
            except:  # best effort, honest
                pass
    """, ["HVD004"]),
    ("hvd004_base_exception", {"HVD004"}, "critical", """
        def dispatch():
            try:
                send()
            except BaseException:
                pass
    """, ["HVD004"]),
    ("hvd004_annotated_or_reraising", {"HVD004"}, "critical", """
        def dispatch():
            try:
                send()
            except Exception:  # noqa: BLE001 -- beacon write is best-effort
                pass
            try:
                send()
            except Exception:
                cleanup()
                raise
    """, []),
    ("hvd004_narrow", {"HVD004"}, "critical", """
        def dispatch():
            try:
                send()
            except ValueError:
                pass
    """, []),
    ("hvd004_noncritical_path", {"HVD004"}, "mod", """
        def beacon():
            try:
                send()
            except Exception:
                pass
    """, []),
    ("suppress_inline", {"HVD003"}, "mod", """
        import os
        a = os.environ.get("HOROVOD_X_KNOB")  # hvdlint: disable=HVD003 -- protocol var
    """, []),
    ("suppress_next_line", {"HVD003"}, "mod", """
        import os
        # hvdlint: disable-next-line=HVD003
        a = os.environ.get("HOROVOD_X_KNOB")
    """, []),
    ("suppress_file_all", {"HVD003"}, "mod", """
        # hvdlint: disable-file=all
        import os
        a = os.environ.get("HOROVOD_X_KNOB")
    """, []),
    ("suppress_wrong_rule", {"HVD003"}, "mod", """
        import os
        a = os.environ.get("HOROVOD_X_KNOB")  # hvdlint: disable=HVD001
    """, ["HVD003"]),
    ("syntax_error", None, "mod", "def broken(:\n", ["HVD000"]),
]


@pytest.mark.parametrize("case", SHARED, ids=[c[0] for c in SHARED])
def test_shared_case_finds_what_the_reference_finds(case):
    _, select, where, text, want = case
    ref = lint("jax", text, where, select)
    ours = lint("torch", text, where, select)
    assert [f.rule for f in ref] == want
    assert keys(ours) == keys(ref)


@pytest.mark.parametrize("engine", ENGINES)
def test_baseline_round_trip(engine, tmp_path):
    core = ENGINES[engine][0]
    findings = lint(engine, 'import os\na = os.environ.get("HOROVOD_X")\n',
                    select={"HVD003"})
    assert len(findings) == 1
    p = tmp_path / "baseline"
    p.write_text(core.format_baseline(findings), encoding="utf-8")
    assert core.load_baseline(str(p)) == {f.key for f in findings}


@pytest.mark.parametrize("engine", ENGINES)
def test_malformed_baseline_raises(engine, tmp_path):
    p = tmp_path / "baseline"
    p.write_text("HVD003 no-colon-here\n", encoding="utf-8")
    with pytest.raises(ValueError, match="malformed baseline"):
        ENGINES[engine][0].load_baseline(str(p))


@pytest.mark.parametrize("engine", ENGINES)
def test_cli_exit_codes(engine, tmp_path, capsys):
    core = ENGINES[engine][0]
    bad = tmp_path / "mod.py"
    bad.write_text('import os\na = os.environ.get("HOROVOD_X")\n',
                   encoding="utf-8")
    args = [str(bad), "--root", str(tmp_path), "--select", "HVD003",
            "--no-project"]
    assert core.main(args) == 1
    assert "HVD003" in capsys.readouterr().out
    assert core.main(args + ["--write-baseline"]) == 0
    assert (tmp_path / core.BASELINE_DEFAULT).exists()
    assert core.main(args) == 0  # baselined
    assert core.main(["--select", "HVD999", "--root", ROOT]) == 2


def test_the_port_keeps_its_own_baseline_file():
    """--write-baseline can never overwrite the JAX package's file."""
    assert tcore.BASELINE_DEFAULT == ".hvdlint-torch-baseline"
    assert jcore.BASELINE_DEFAULT == ".hvdlint-baseline"
    assert tcore.DEFAULT_PATHS == ("horovod_tpu_torch",)


def test_the_port_has_every_rule_of_the_reference():
    assert [(r.rule_id, r.name) for r in tcore.all_rules()] == \
        [(r.rule_id, r.name) for r in jcore.all_rules()]


# ------------------------------------------------------- the port's readings

@pytest.mark.parametrize("call", [
    "dist.all_reduce(x)", "torch.distributed.barrier()",
    "dist.new_group([0, 1])", "dist.all_gather_into_tensor(out, x)",
    "torch.distributed.broadcast(x, 0)", "dist.all_to_all_single(out, x)"])
def test_torch_distributed_collective_under_a_rank_branch(call):
    text = f"""
        import torch
        import torch.distributed as dist
        def step(x, out):
            if dist.get_rank() == 0:
                {call}
    """
    assert keys(lint("torch", text, select={"HVD001"})) == [("HVD001", 6)]


def test_torch_distributed_is_math_to_the_reference():
    """The difference the port's rule closes: the reference skips every
    ``torch.*`` call as math, ``torch.distributed``'s collectives too."""
    text = """
        import torch
        def step(rank):
            if rank == 0:
                torch.distributed.barrier()
                torch.broadcast_to(x, (8,))
    """
    assert lint("jax", text, select={"HVD001"}) == []
    assert keys(lint("torch", text, select={"HVD001"})) == [("HVD001", 5)]


def test_point_to_point_and_queries_under_a_rank_branch_are_clean():
    text = """
        import torch.distributed as dist
        def step(x, rank):
            if rank == 0:
                dist.send(x, 1)
                n = dist.get_world_size()
            else:
                dist.recv(x, 0)
    """
    assert lint("torch", text, select={"HVD001"}) == []


@pytest.mark.parametrize("call", ["random.random()", "time.time()",
                                  "np.random.rand()", "time.perf_counter()"])
def test_host_nondeterminism_inside_a_graph_capture(call):
    text = f"""
        import random, time
        import numpy as np
        import torch
        def capture(g, step):
            started = time.perf_counter()
            with torch.cuda.graph(g):
                scale = {call}
                step(scale)
            return time.perf_counter() - started
    """
    fs = lint("torch", text, select={"HVD005"})
    assert keys(fs) == [("HVD005", 8)]
    assert "replay" in fs[0].message


def test_host_nondeterminism_in_a_step_program_builder():
    text = """
        import time
        def _build_step_program(model):
            stamp = time.time()
            return model, stamp
        def profile():
            return time.time()
    """
    assert keys(lint("torch", text, select={"HVD005"})) == [("HVD005", 4)]


def test_a_clean_capture_is_clean():
    text = """
        import torch
        def capture(g, step, seed):
            with torch.cuda.graph(g):
                step(seed)
    """
    assert lint("torch", text, select={"HVD005"}) == []


def test_a_tensor_read_before_synchronize_is_flagged():
    text = """
        import horovod_tpu_torch as hvd
        def exchange(t):
            h = hvd.allreduce_async_(t, name="t")
            print(t.sum())
            hvd.synchronize(h)
            return t
    """
    fs = lint("torch", text, select={"HVD005"})
    assert keys(fs) == [("HVD005", 5)]
    assert "allreduce_async_" in fs[0].message


def test_a_tensor_read_after_synchronize_is_clean():
    text = """
        import horovod_tpu_torch as hvd
        def exchange(t, u):
            h = hvd.allreduce_async_(t, name="t")
            g = hvd.broadcast_async_(u, 0, name="u")
            hvd.synchronize(h)
            hvd.synchronize(g)
            return t.sum() + u.sum()
    """
    assert lint("torch", text, select={"HVD005"}) == []


def test_synchronize_revives_only_its_own_tensor():
    text = """
        import horovod_tpu_torch as hvd
        def exchange(t, u):
            h = hvd.allreduce_async_(t, name="t")
            g = hvd.broadcast_async_(u, 0, name="u")
            hvd.synchronize(h)
            x = t + u
            hvd.synchronize(g)
            return x
    """
    assert keys(lint("torch", text, select={"HVD005"})) == [("HVD005", 7)]


def test_a_rebind_or_an_untracked_handle_revives():
    text = """
        import torch
        import horovod_tpu_torch as hvd
        def exchange(t, u, handles):
            hvd.allreduce_async_(t, name="t")
            t = torch.zeros(3)
            handles.append(hvd.allreduce_async_(u, name="u"))
            for h in handles:
                hvd.synchronize(h)
            return t + u
    """
    assert lint("torch", text, select={"HVD005"}) == []


def test_the_ports_config_and_store_are_its_paths():
    env_read = 'import os\na = os.environ.get("HOROVOD_FUSION_THRESHOLD")\n'
    swallow = "def f():\n    try:\n        g()\n    except Exception:\n" \
              "        pass\n"
    for text, select, rel, want in (
            (env_read, "HVD003", "horovod_tpu_torch/config.py", []),
            (env_read, "HVD003", "horovod_tpu/config.py", ["HVD003"]),
            (swallow, "HVD004", "horovod_tpu_torch/utils/store_kv.py",
             ["HVD004"]),
            (swallow, "HVD004", "horovod_tpu_torch/ops/engine.py",
             ["HVD004"])):
        rules = [r for r in tcore.all_rules() if r.rule_id == select]
        fs = tcore.lint_file(os.path.join(ROOT, rel), ROOT, rules=rules,
                             text=text)
        assert [f.rule for f in fs] == want, rel


# ---------------------------------------------------------- the port's tree

def test_the_port_tree_is_lint_clean():
    """Zero findings over horovod_tpu_torch/, the project rules on the
    port's metrics.py and config.py against docs/ included, and no
    baseline."""
    findings = tcore.lint_tree(ROOT)
    assert findings == [], "\n".join(f.render() for f in findings)
    baseline = tcore.load_baseline(
        os.path.join(ROOT, tcore.BASELINE_DEFAULT))
    assert baseline == set(), "the port ships no baseline entries"


def test_the_cli_says_clean(capsys):
    assert tcore.main(["--root", ROOT, "--no-project"]) == 0
    assert "hvdlint: clean" in capsys.readouterr().out


# ------------------------------------------------------ lock witness, both

def _run(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(10)
    assert not t.is_alive()


@pytest.mark.parametrize("engine", WITNESSES)
def test_cross_thread_inversion_is_a_cycle(engine):
    w = WITNESSES[engine].LockOrderWitness()
    a, b = w.make_lock("A"), w.make_lock("B")
    _run(lambda: (a.acquire(), b.acquire(), b.release(), a.release()))
    _run(lambda: (b.acquire(), a.acquire(), a.release(), b.release()))
    rep = w.report()
    assert len(rep["cycles"]) == 1
    text = WITNESSES[engine].format_cycles(rep)
    assert "potential deadlock" in text and "acquisition stack" in text


@pytest.mark.parametrize("engine", WITNESSES)
def test_single_thread_inversion_is_filtered(engine):
    w = WITNESSES[engine].LockOrderWitness()
    a, b = w.make_lock("A"), w.make_lock("B")

    def both_orders():
        a.acquire(); b.acquire(); b.release(); a.release()  # noqa: E702
        b.acquire(); a.acquire(); a.release(); b.release()  # noqa: E702
    _run(both_orders)
    rep = w.report()
    assert len(rep["edges"]) == 2
    assert rep["cycles"] == []


@pytest.mark.parametrize("engine", WITNESSES)
def test_rlock_trylock_and_condition(engine):
    w = WITNESSES[engine].LockOrderWitness()
    r = w.make_rlock("R")
    with r:
        with r:
            pass
    assert w.report()["edges"] == []
    a, b = w.make_lock("A"), w.make_lock("B")
    _run(lambda: (a.acquire(), b.acquire(), b.release(), a.release()))

    def inverted_but_try():
        b.acquire()
        assert a.acquire(blocking=False)
        a.release(); b.release()  # noqa: E702
    _run(inverted_but_try)
    cv = threading.Condition(w.make_rlock("CV"))
    ready = []

    def waiter():
        with cv:
            while not ready:
                cv.wait(timeout=5)
    t = threading.Thread(target=waiter)
    t.start()
    with cv:
        ready.append(1)
        cv.notify()
    t.join(10)
    assert not t.is_alive()
    assert w.report()["cycles"] == []


def test_the_ports_witness_scopes_its_own_package(tmp_path):
    orig = (threading.Lock, threading.RLock, threading.Condition)
    assert twitness.DEFAULT_SCOPE == ("horovod_tpu_torch",)
    w = twitness.LockOrderWitness(scope=("test_torch_analysis",))
    w.install()
    try:
        wrapped = threading.Lock()
        assert type(wrapped).__name__ == "_WitnessedLock"
        with wrapped:
            assert wrapped.locked()
    finally:
        w.uninstall()
    assert (threading.Lock, threading.RLock, threading.Condition) == orig
    a, b = w.make_lock("A"), w.make_lock("B")
    _run(lambda: (a.acquire(), b.acquire(), b.release(), a.release()))
    rep = w.write_report(str(tmp_path / "sub" / "report.json"))
    assert (tmp_path / "sub" / "report.json").exists()
    assert rep["locks"] == 3


def test_a_cycle_reaches_the_ports_flight_recorder():
    from horovod_tpu_torch.config import Config
    from horovod_tpu_torch.diag import recorder
    rec = recorder.install(Config())
    try:
        w = twitness.LockOrderWitness()
        a, b = w.make_lock("A"), w.make_lock("B")
        _run(lambda: (a.acquire(), b.acquire(), b.release(), a.release()))
        _run(lambda: (b.acquire(), a.acquire(), a.release(), b.release()))
        assert len(w.report()["cycles"]) == 1
        events = [e for e in rec.snapshot() if e["ev"] == "lock_cycle"]
        assert len(events) == 1 and events[0]["op"] == "LOCK_WITNESS"
    finally:
        recorder.uninstall()


@pytest.mark.parametrize("ranks", [1, 2])
def test_the_witness_sees_no_cycle_in_the_ports_engine(ranks):
    """The witness installed before the port is imported (so the metrics
    registry's module lock is witnessed too), then ``init()``, two
    application threads submitting in-place all-reduces, allgathers and
    broadcasts in opposite orders, a third reading the registry, the
    engine's completion thread, and at two ranks the coordinator over
    the job's store."""
    outs = spawn_ranks(ranks, witnessed_engine, 6, timeout=180)
    for out in outs:
        assert out["cycles"] == "", out["cycles"]
        assert out["results_ok"]
        assert out["locks"] >= 4, out
        assert out["edges"] >= 1, out
        assert out["engine_witnessed"] and out["registry_witnessed"]
    if ranks > 1:
        assert all(o["coordinator_witnessed"] for o in outs)
