"""hvdlint rule catalog (docs/static-analysis.md), read for the port.

Counterpart of horovod_tpu/analysis/rules.py: the same rule ids and bug
classes, each pointed at ``horovod_tpu_torch/``. Where torch differs:

- HVD001 also knows ``torch.distributed``'s collectives (``dist.*`` and
  ``torch.distributed.*`` are never math namesakes; ``new_group`` is
  collective over the world) and ``get_rank()``;
- HVD003 allows ``horovod_tpu_torch/config.py``;
- HVD004 guards the port's wire-dispatch and completion modules, its
  coordinator's store (``utils/store_kv.py``) among them;
- HVD005 (a) has no ``donate_argnums``: its donation is a tensor handed
  to an in-place async collective (``allreduce_async_``,
  ``broadcast_async_``), which the engine writes on its own stream until
  ``synchronize`` returns; (b) its builders are CUDA graph captures
  (``with torch.cuda.graph(...)``) and ``*step_program*`` functions;
- HVD006 and HVD007 read the port's metrics.py and config.py against
  the docs/ both packages share.

AST rules are pure functions of one parsed file; project rules check
whole-tree parity invariants.
"""

import ast
import os
import re

from .core import AstRule, Finding, ProjectRule, register


def _dotted(node):
    """Dotted name for a Name/Attribute chain ('os.environ.get'), or ''
    when the chain bottoms out in something dynamic (a call, subscript)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _terminal(node):
    """Last segment of a call target ('allreduce' for hvd.allreduce)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _self_attr(node):
    """'field' when ``node`` is ``self.field``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


# --------------------------------------------------------------------- HVD001

#: Collective entry points whose cross-process symmetry is load-bearing:
#: every process must reach the call or negotiation never completes and
#: the job hangs (PAPER.md: the rank-0 negotiation exists precisely
#: because asymmetric collective entry deadlocks MPI_Allreduce).
_COLLECTIVES = {
    "allreduce", "allgather", "broadcast", "alltoall",
    "exchange_gradients", "broadcast_parameters", "broadcast_object",
    "grouped_allreduce", "bucketed_reducescatter_allgather",
    "reducescatter", "reduce_scatter", "allgather_object", "barrier",
    # torch.distributed's, which the port calls directly; new_group is
    # collective over the whole world, whichever ranks it names
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "reduce_scatter_tensor", "all_to_all_single", "broadcast_object_list",
    "all_gather_object", "new_group",
}
#: Math-library prefixes whose same-named ops are NOT collectives
#: (torch.broadcast_to relatives and friends).
_MATH_PREFIXES = ("np", "jnp", "numpy", "lax", "jax", "torch", "tf", "math")
#: ... except torch.distributed, whose every namesake is the collective.
_DIST_PREFIXES = ("torch.distributed.", "dist.")
_RANK_CALLS = {"rank", "local_rank", "cross_rank", "process_index",
               "process_id", "get_rank"}
_RANK_NAMES = _RANK_CALLS | {"my_rank", "rank_id", "worker_rank"}


def _rank_dependent(test):
    """Whether a branch condition reads the process's rank/identity."""
    for node in ast.walk(test):
        if isinstance(node, ast.Call) and _terminal(node.func) in _RANK_CALLS:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _RANK_NAMES:
            return True
        if isinstance(node, ast.Name) and node.id in _RANK_NAMES:
            return True
    return False


@register
class CollectiveSymmetry(AstRule):
    """HVD001: a collective call lexically guarded by a rank-conditional
    branch. Originating bug class: asymmetric collective entry is how
    every 2-process hang in test_*_multihost.py started — negotiation
    waits forever for the rank that never enqueued (the JAX package's
    CHANGES.md: the desync report exists to diagnose exactly this post
    hoc; this rule catches it pre-merge)."""

    rule_id = "HVD001"
    name = "collective-symmetry"
    hint = ("hoist the collective out of the rank-conditional branch — "
            "every rank must enter it (gate the *payload*, not the call); "
            "if the guard provably matches on all ranks, suppress with "
            "'# hvdlint: disable=HVD001 -- <why symmetric>'")

    def check(self, tree, text, path):
        out = []
        self._walk(tree.body, 0, None, path, out)
        return out

    def _walk(self, stmts, depth, cond, path, out):
        for node in stmts:
            self._visit(node, depth, cond, path, out)

    def _visit(self, node, depth, cond, path, out):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # A def under a rank conditional guards the *definition*, not
            # the call sites; conditions reset at scope boundaries.
            self._walk(node.body, 0, None, path, out)
            return
        if isinstance(node, ast.Lambda):
            self._visit(node.body, 0, None, path, out)
            return
        if isinstance(node, (ast.If, ast.While)):
            self._visit(node.test, depth, cond, path, out)
            inner = depth + 1 if _rank_dependent(node.test) else depth
            c = node.test if inner > depth else cond
            self._walk(node.body, inner, c, path, out)
            self._walk(node.orelse, inner, c, path, out)
            return
        if isinstance(node, ast.IfExp):
            self._visit(node.test, depth, cond, path, out)
            inner = depth + 1 if _rank_dependent(node.test) else depth
            c = node.test if inner > depth else cond
            self._visit(node.body, inner, c, path, out)
            self._visit(node.orelse, inner, c, path, out)
            return
        if isinstance(node, ast.Call):
            name = _terminal(node.func)
            dotted = _dotted(node.func)
            root = dotted.split(".", 1)[0] if dotted else ""
            if (depth > 0 and name in _COLLECTIVES
                    and (root not in _MATH_PREFIXES
                         or dotted.startswith(_DIST_PREFIXES))):
                guard = ast.unparse(cond) if cond is not None else "?"
                out.append(self.finding(
                    path, node,
                    f"collective '{name}(...)' is reachable only under the "
                    f"rank-conditional branch 'if {guard}': ranks that skip "
                    "it leave the others wedged in negotiation"))
        for child in ast.iter_child_nodes(node):
            self._visit(child, depth, cond, path, out)


# --------------------------------------------------------------------- HVD002

@register
class LockDiscipline(AstRule):
    """HVD002: a field declared in a class's ``_GUARDED_BY`` mapping is
    touched outside a ``with self.<lock>`` block. Originating bug class:
    the JAX package's CHANGES.md ("synchronize() now waits on a
    Condition sharing the engine RLock and _run_cycle self-locks") —
    engine/coordinator state
    raced between the app thread, completion thread, ticker and watchdog
    until every access was forced under the lock.

    Declaration forms, on the class body::

        _GUARDED_BY = {"_table": "_lock", "_handles": "_lock"}
        _GUARDED_BY = ("_table", "_handles")        # default lock: _lock
        _LOCK_ALIASES = {"_cv": "_lock"}            # Condition shares it

    Exemptions: ``__init__``/``__del__`` (no concurrent access during
    construction/teardown) and methods named ``*_locked`` (documented
    convention: caller holds the lock)."""

    rule_id = "HVD002"
    name = "lock-discipline"
    hint = ("wrap the access in 'with self.<lock>:', rename the method "
            "'*_locked' if its contract is caller-holds-the-lock, or "
            "suppress with a reason if the access is provably "
            "single-threaded")

    def check(self, tree, text, path):
        out = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self._check_class(node, path, out)
        return out

    @staticmethod
    def _declaration(cls):
        guarded, aliases = {}, {}
        for stmt in cls.body:
            target = None
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target = stmt.targets[0]
            elif isinstance(stmt, ast.AnnAssign):
                target = stmt.target
            if not isinstance(target, ast.Name) or stmt.value is None:
                continue
            try:
                value = ast.literal_eval(stmt.value)
            except (ValueError, SyntaxError):
                continue
            if target.id == "_GUARDED_BY":
                if isinstance(value, dict):
                    guarded.update({str(k): str(v)
                                    for k, v in value.items()})
                elif isinstance(value, (tuple, list, set)):
                    guarded.update({str(k): "_lock" for k in value})
            elif target.id == "_LOCK_ALIASES" and isinstance(value, dict):
                aliases.update({str(k): str(v) for k, v in value.items()})
        return guarded, aliases

    def _check_class(self, cls, path, out):
        guarded, aliases = self._declaration(cls)
        if not guarded:
            return
        resolve = lambda n: aliases.get(n, n)  # noqa: E731
        lock_names = set(aliases) | {resolve(v) for v in guarded.values()}
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if (stmt.name in ("__init__", "__del__")
                    or stmt.name.endswith("_locked")):
                continue
            for body_stmt in stmt.body:
                self._scan(body_stmt, frozenset(), guarded, resolve,
                           lock_names, path, out)

    def _scan(self, node, held, guarded, resolve, lock_names, path, out):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = set(held)
            for item in node.items:
                attr = _self_attr(item.context_expr)
                if attr is not None and attr in lock_names:
                    new_held.add(resolve(attr))
                else:
                    self._scan(item.context_expr, held, guarded, resolve,
                               lock_names, path, out)
            for stmt in node.body:
                self._scan(stmt, frozenset(new_held), guarded, resolve,
                           lock_names, path, out)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # A closure may run on another thread (Thread(target=...)):
            # it inherits no lock context.
            body = node.body if isinstance(node.body, list) else [node.body]
            for stmt in body:
                self._scan(stmt, frozenset(), guarded, resolve,
                           lock_names, path, out)
            return
        attr = _self_attr(node)
        if attr is not None and attr in guarded:
            need = resolve(guarded[attr])
            if need not in held:
                out.append(self.finding(
                    path, node,
                    f"'self.{attr}' is declared _GUARDED_BY "
                    f"'self.{guarded[attr]}' but accessed outside a "
                    f"'with self.{need}' block"))
        for child in ast.iter_child_nodes(node):
            self._scan(child, held, guarded, resolve, lock_names, path, out)


# --------------------------------------------------------------------- HVD003

_ENV_READ_CALLS = {"os.environ.get", "environ.get", "os.getenv", "getenv",
                   "os.environ.pop", "environ.pop",
                   "os.environ.setdefault", "environ.setdefault"}
_KNOB_RE = re.compile(r"^(HOROVOD_[A-Z0-9_]+|PADDING_ALGO)$")


@register
class EnvHygiene(AstRule):
    """HVD003: a ``HOROVOD_*`` env var read outside config.py.
    Originating bug class: knobs read at point-of-use bypass the
    init-time Config snapshot — they are invisible to docs parity, are
    re-read at inconsistent times (an env mutation mid-job changes
    behavior on SOME ranks), and drift from the documented defaults
    (the JAX package's CHANGES.md gotchas about knobs routing through
    config.py).
    Launcher↔worker *protocol* variables (HOROVOD_TPU_PROCESS_ID and
    friends, set by run/) are not knobs; suppress those reads with a
    justification."""

    rule_id = "HVD003"
    name = "env-hygiene"
    hint = ("declare the knob as a Config field in "
            "horovod_tpu_torch/config.py "
            "(parsed once in from_env, documented per HVD007) and read "
            "config.<field>; launcher-protocol reads get an inline "
            "'# hvdlint: disable=HVD003 -- <why not a knob>'")

    ALLOWED = ("horovod_tpu_torch/config.py",)

    def check(self, tree, text, path):
        if path in self.ALLOWED:
            return []
        out = []
        for node in ast.walk(tree):
            name = None
            if isinstance(node, ast.Call):
                if _dotted(node.func) in _ENV_READ_CALLS and node.args:
                    arg = node.args[0]
                    if (isinstance(arg, ast.Constant)
                            and isinstance(arg.value, str)
                            and _KNOB_RE.match(arg.value)):
                        name = arg.value
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.ctx, ast.Load)
                  and _dotted(node.value) in ("os.environ", "environ")):
                sl = node.slice
                if (isinstance(sl, ast.Constant) and isinstance(sl.value, str)
                        and _KNOB_RE.match(sl.value)):
                    name = sl.value
            if name is not None:
                out.append(self.finding(
                    path, node,
                    f"'{name}' is read from the environment here instead "
                    "of through config.py — the knob bypasses the "
                    "init-time Config snapshot and the docs parity check"))
        return out


# --------------------------------------------------------------------- HVD004

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler_type):
    if handler_type is None:
        return True
    if isinstance(handler_type, ast.Tuple):
        return any(_is_broad(e) for e in handler_type.elts)
    return _terminal(handler_type) in _BROAD


def _catches_everything(handler_type):
    """Bare ``except:`` / ``except BaseException`` — also eats
    SystemExit/KeyboardInterrupt (and elastic's PreemptedExit), so no
    inline justification makes it acceptable on a critical path."""
    if handler_type is None:
        return True
    if isinstance(handler_type, ast.Tuple):
        return any(_catches_everything(e) for e in handler_type.elts)
    return _terminal(handler_type) == "BaseException"


def _reraises(handler):
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
    return False


@register
class SwallowSafety(AstRule):
    """HVD004: a bare/over-broad ``except`` on a wire-dispatch or
    completion-thread path with no re-raise. Originating bug class: a
    broad handler on those paths eats ``MismatchError`` (a protocol
    desync that MUST abort — retrying it re-wedges the job; the JAX
    package's CHANGES.md: 'MismatchError/protocol errors NEVER retried')
    and
    ``WorkerLostError`` (swallowing it turns a detected dead peer back
    into an undiagnosed hang). Scope is the critical-path module list
    below; best-effort paths elsewhere (beacons, dump files) are
    legitimately broad.

    A deliberate best-effort swallow IS allowed on these paths — beacon
    writes, teardown hygiene, survive-the-completion-thread loops — but
    it must say so: an ``except Exception`` that neither re-raises nor
    carries an inline justification comment on the ``except`` line
    fires. Bare ``except:`` and ``except BaseException`` fire
    regardless of annotation (they also eat SystemExit/
    KeyboardInterrupt/PreemptedExit); only an explicit hvdlint
    suppression excuses those."""

    rule_id = "HVD004"
    name = "swallow-safety"
    hint = ("catch the specific exceptions the path can absorb and "
            "re-raise the rest (MismatchError/WorkerLostError must "
            "propagate); a deliberate best-effort swallow needs an "
            "inline justification comment on the 'except' line "
            "(e.g. '# noqa: BLE001 -- <why safe>')")

    CRITICAL = (
        "horovod_tpu_torch/ops/engine.py",
        "horovod_tpu_torch/coordinator.py",
        "horovod_tpu_torch/wire.py",
        "horovod_tpu_torch/runtime.py",
        "horovod_tpu_torch/negotiation.py",
        "horovod_tpu_torch/elastic/runner.py",
        "horovod_tpu_torch/utils/kvstore.py",
        # the store the port's coordinator runs on
        "horovod_tpu_torch/utils/store_kv.py",
    )

    def check(self, tree, text, path):
        if path not in self.CRITICAL:
            return []
        out = []
        lines = text.splitlines()
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node.type) or _reraises(node):
                continue
            what = ("bare 'except:'" if node.type is None else
                    f"'except {ast.unparse(node.type)}'")
            if _catches_everything(node.type):
                out.append(self.finding(
                    path, node,
                    f"{what} on a wire-dispatch/completion path also "
                    "eats SystemExit/KeyboardInterrupt/PreemptedExit — "
                    "catch Exception (justified) or narrower"))
                continue
            line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
            justification = line.partition("#")[2].strip()
            if not justification:
                out.append(self.finding(
                    path, node,
                    f"{what} without re-raise or an inline justification "
                    "comment on a wire-dispatch/completion path can "
                    "swallow MismatchError/WorkerLostError"))
        return out


# --------------------------------------------------------------------- HVD005

_NONDET_EXACT = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow", "date.today", "datetime.date.today",
    "os.urandom", "uuid.uuid1", "uuid.uuid4", "os.getpid",
}
_NONDET_PREFIX = ("random.", "np.random.", "numpy.random.")


#: The eager engine's in-place async collectives and the position of
#: the tensor each writes in place (horovod_tpu_torch/__init__.py).
_INPLACE_ASYNC = {"allreduce_async_": 0, "broadcast_async_": 0}


def _is_graph_capture(with_node):
    """Whether a ``with`` statement captures a CUDA graph."""
    return any(isinstance(item.context_expr, ast.Call)
               and _dotted(item.context_expr.func) in ("torch.cuda.graph",
                                                       "cuda.graph")
               for item in with_node.items)


@register
class JitHygiene(AstRule):
    """HVD005: (a) a tensor handed to an in-place async collective is
    used again before its handle is synchronized — the engine writes it
    on its own stream (the port's counterpart of a donated buffer, which
    torch does not have: ``HOROVOD_FUSION_DONATE`` is read and ignored),
    so the read sees the input, the result or a mix. Originating bug
    class: the JAX package's CHANGES.md — release-before-consume
    of donated fusion buffers corrupted the wire. (b) wall-clock/RNG
    calls inside a CUDA graph capture or a ``*step_program*`` builder:
    the host call runs once, while the graph is captured, and its value
    is baked into every replay (ROADMAP trap 9: a replay runs no host
    code)."""

    rule_id = "HVD005"
    name = "jit-hygiene"
    hint = ("(in-place async) read the tensor only after "
            "synchronize(handle), or hand the collective a copy; "
            "(captures) take time/rng values as device tensors filled "
            "before the replay, never from host calls inside the capture")

    def check(self, tree, text, path):
        out, seen = [], set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_donation(node, path, out)
                if "step_program" in node.name:
                    self._check_builder(
                        node.body, f"step-program builder '{node.name}'",
                        path, out, seen)
            elif (isinstance(node, (ast.With, ast.AsyncWith))
                  and _is_graph_capture(node)):
                self._check_builder(node.body, "a CUDA graph capture",
                                    path, out, seen)
        return out

    # -- (b) builder nondeterminism

    def _check_builder(self, body, where, path, out, seen):
        for stmt in body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                dotted = _dotted(node.func)
                if (dotted in _NONDET_EXACT
                        or dotted.startswith(_NONDET_PREFIX)):
                    seen.add(id(node))
                    out.append(self.finding(
                        path, node,
                        f"nondeterministic host call '{dotted}(...)' "
                        f"inside {where}: it runs once, at capture time, "
                        "and its value is baked into every replay"))

    # -- (a) in-place async reuse

    def _check_donation(self, func, path, out):
        calls = [n for n in ast.walk(func) if isinstance(n, ast.Call)]
        if not any(_terminal(c.func) in _INPLACE_ASYNC for c in calls):
            return
        # Ordered scan of this scope: an in-place async call marks its
        # Name tensor argument in flight from the call's END; later
        # loads are reads of a tensor the engine is writing; a store
        # resurrects the name, and so does synchronize() of its handle
        # (of any handle, where the argument is not a tracked name).
        # Assignment targets are positioned at the statement's END (the
        # value is evaluated first), so ``t = t.clone()`` after the call
        # resurrects t.
        stmt_end = {}  # id(target Name) -> (end_lineno, end_col)
        handles = {}   # handle name -> tensor name
        for node in ast.walk(func):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            stmt_end[id(n)] = (node.end_lineno,
                                               node.end_col_offset)
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Call)):
                    pos = _INPLACE_ASYNC.get(_terminal(node.value.func))
                    if (pos is not None and pos < len(node.value.args)
                            and isinstance(node.value.args[pos], ast.Name)):
                        handles[node.targets[0].id] = \
                            node.value.args[pos].id
        events = []
        for node in calls:
            if _terminal(node.func) in _INPLACE_ASYNC or \
                    _terminal(node.func) == "synchronize":
                events.append((node.end_lineno, node.end_col_offset, 0,
                               node))
        for node in ast.walk(func):
            if isinstance(node, ast.Name):
                order = 1 if isinstance(node.ctx, ast.Load) else 2
                line, col = stmt_end.get(id(node),
                                         (node.lineno, node.col_offset))
                events.append((line, col, order, node))
        events.sort(key=lambda e: e[:3])
        dead = {}  # tensor name -> the in-place async call
        for _, _, kind, node in events:
            if kind == 0 and _terminal(node.func) == "synchronize":
                arg = node.args[0] if node.args else None
                if isinstance(arg, ast.Name) and arg.id in handles:
                    dead.pop(handles[arg.id], None)
                else:
                    dead.clear()
            elif kind == 0:
                pos = _INPLACE_ASYNC[_terminal(node.func)]
                if pos < len(node.args) and isinstance(node.args[pos],
                                                       ast.Name):
                    dead[node.args[pos].id] = node
            elif kind == 1 and node.id in dead:
                call = dead.pop(node.id)  # report once per call
                out.append(self.finding(
                    path, node,
                    f"'{node.id}' was handed to "
                    f"'{_terminal(call.func)}' on line {call.lineno} and "
                    "is read again here, before synchronize() of its "
                    "handle — the engine may still be writing it on its "
                    "stream"))
            elif kind == 2:
                dead.pop(node.id, None)


# ------------------------------------------------------------ project rules

_FAMILY_RE = re.compile(r'(?:counter|gauge|histogram)\(\s*"(hvd_\w+)"')


def _line_of(text, needle, default=1):
    for i, line in enumerate(text.splitlines(), start=1):
        if needle in line:
            return i
    return default


def _docs_corpus(root):
    docs_dir = os.path.join(root, "docs")
    chunks = []
    if os.path.isdir(docs_dir):
        for dirpath, _, filenames in os.walk(docs_dir):
            for fn in sorted(filenames):
                if fn.endswith(".md"):
                    with open(os.path.join(dirpath, fn),
                              encoding="utf-8") as f:
                        chunks.append(f.read())
    return "\n".join(chunks)


@register
class MetricsDocsParity(ProjectRule):
    """HVD006: every metric family the port registers in its metrics.py
    must have a row in docs/observability.md (the operator-facing
    contract). The port has no docs of its own: its families are the JAX
    package's, under the same names, and share that table."""

    rule_id = "HVD006"
    name = "metrics-docs-parity"
    hint = ("add a row to the matching table in docs/observability.md — "
            "spell the full metric name (abbreviated `_suffix` forms "
            "don't count)")

    METRICS = "horovod_tpu_torch/metrics.py"
    DOCS = "docs/observability.md"

    def check(self, root):
        with open(os.path.join(root, self.METRICS), encoding="utf-8") as f:
            src = f.read()
        families = sorted(set(_FAMILY_RE.findall(src)))
        if not families:
            return [Finding(self.rule_id, self.METRICS, 1, 1,
                            "no metric families found — has the "
                            "registration idiom changed?", self.hint)]
        with open(os.path.join(root, self.DOCS), encoding="utf-8") as f:
            docs = f.read()
        return [Finding(self.rule_id, self.METRICS,
                        _line_of(src, f'"{name}"'), 1,
                        f"metric family '{name}' is registered but has no "
                        f"row in {self.DOCS}", self.hint)
                for name in families if name not in docs]


@register
class KnobDocsParity(ProjectRule):
    """HVD007: every ``HOROVOD_*`` knob the port's config.from_env
    parses must be mentioned somewhere under docs/ (shared with the JAX
    package) — the knob table is how operators discover configuration,
    and HVD003 funnels all knobs through config.py precisely so this
    check sees them."""

    rule_id = "HVD007"
    name = "knob-docs-parity"
    hint = ("document the knob in the relevant docs/*.md (running.md "
            "knob table or the owning feature doc)")

    CONFIG = "horovod_tpu_torch/config.py"
    KNOB = re.compile(r'"((?:HOROVOD|PADDING)_[A-Z0-9_]+)"')

    def check(self, root):
        with open(os.path.join(root, self.CONFIG), encoding="utf-8") as f:
            src = f.read()
        knobs = sorted(set(self.KNOB.findall(src)))
        docs = _docs_corpus(root)
        return [Finding(self.rule_id, self.CONFIG,
                        _line_of(src, f'"{name}"'), 1,
                        f"config knob '{name}' is parsed in from_env but "
                        "documented nowhere under docs/", self.hint)
                for name in knobs if name not in docs]
