"""What each gloo rank runs in the eager engine's tests
(tests/test_torch_engine.py, test_torch_coordinator.py,
test_torch_timeline.py, test_torch_eager_binding.py,
test_torch_runtime_store.py), through tests/torch_ranks.py's
``spawn_ranks``. No JAX here: every rank imports this module. Each
function returns numpy arrays and plain values, which the tests compare
with the JAX package in their own process.

The engine scripts are lists of steps the tests build and hand to both
packages: ``("allreduce", name, {rank: array}, kwargs)``,
``("allgather", name, {rank: array})``, ``("broadcast", name, {rank:
array}, root)``, ``("alltoall", name, {rank: array})``, ``("mixed",
name, {rank: (op, array, kwargs)})`` (ranks submitting different ops),
each submitted by every rank in the step's ``order[rank]`` and then
synchronized in name order. A step's outcome on a rank is its array or
``("error", type name, message)``.
"""

import logging
import os
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd

DTYPES = {"bfloat16": torch.bfloat16}


def _tensor(a):
    """A numpy array (bf16 travels as ``(float32 array, "bfloat16")``) as
    a torch tensor."""
    if isinstance(a, tuple):
        arr, dtype = a
        return torch.from_numpy(np.array(arr)).to(DTYPES[dtype])
    return torch.from_numpy(np.array(a))


def _numpy(t):
    if t.dtype == torch.bfloat16:
        return (t.float().numpy().copy(), "bfloat16")
    return t.numpy().copy()


def _submit(kind, t, name, kw):
    if kind == "allreduce":
        return hvd.allreduce_async(t, name=name, **kw)
    if kind == "allgather":
        return hvd.allgather_async(t, name=name)
    if kind == "broadcast":
        return hvd.broadcast_async(t, kw["root_rank"], name=name)
    if kind == "alltoall":
        from horovod_tpu_torch.negotiation import ALLTOALL
        return hvd.runtime.engine().enqueue(ALLTOALL, t, name)
    raise ValueError(kind)


def run_script(script, rank):
    """Run the steps of ``script`` (module docstring) as ``rank``;
    returns {name: outcome}."""
    from horovod_tpu_torch import Compression
    out = {}
    for step in script:
        kind, order, items = step["kind"], step["order"][rank], step["items"]
        handles = {}
        for name in order:
            item = items[name]
            k, arr, kw = (item[rank] if kind == "mixed"
                          else (kind, item["data"][rank], item.get("kw", {})))
            kw = dict(kw)
            if kw.pop("compression", None) == "fp16":
                kw["compression"] = Compression.fp16
            handles[name] = _submit(k, _tensor(arr), name, kw)
        for name in sorted(handles):
            try:
                out[name] = _numpy(hvd.synchronize(handles[name]))
            except hvd.HorovodError as e:
                out[name] = ("error", type(e).__name__, str(e))
    return out


def engine_session(script, steady_names, steady_rounds):
    """One session: the script; a duplicate name (its error and the
    rollback that leaves the first submission working); ``poll``; the
    steady state (``steady_rounds`` rounds of the same names: response
    cache hits and misses, fast-lane cycles). Returns the outcomes, the
    counters and ``profiler.txt``'s text (rank 0)."""
    hvd.init(device="cpu")
    r = hvd.rank()
    res = {"outcomes": run_script(script, r)}
    h = hvd.allreduce_async(torch.full((3,), float(r)), name="dup",
                            average=False)
    try:
        hvd.allreduce_async(torch.ones(3), name="dup")
        res["duplicate"] = None
    except hvd.DuplicateNameError as e:
        res["duplicate"] = str(e)
    res["dup_result"] = hvd.synchronize(h).numpy().copy()
    h = hvd.allreduce_async(torch.ones(2), name="polled")
    polls = 0
    while not hvd.poll(h):
        polls += 1
        time.sleep(0.001)
    res["poll_result"] = hvd.synchronize(h).numpy().copy()
    eng = hvd.runtime.engine()
    cache = eng.response_cache
    hits0, misses0 = cache.hits, cache.misses
    for i in range(steady_rounds):
        hs = [hvd.allreduce_async(torch.full((4,), float(i + j + r)),
                                  name=n, average=False)
              for j, n in enumerate(steady_names)]
        for h in hs:
            hvd.synchronize(h)
    res["cache"] = (cache.hits - hits0, cache.misses - misses0)
    coord = eng.coordinator
    res["fast_lane_cycles"] = coord.fast_lane_cycles
    res["token_publishes"] = coord.token_publishes
    res["wire_cache"] = (eng.wire_cache.hits, eng.wire_cache.misses)
    path = hvd.runtime.live_state().config.profiler_path
    hvd.shutdown()
    res["profiler"] = open(path).read() if r == 0 else None
    # the direct path's allgather, in a session of its own (its record
    # is not the engine's)
    from horovod_tpu_torch.ops import collectives as C
    hvd.init(device="cpu")
    res["direct_allgather"] = C.allgather(
        torch.full((2 + r, 3), float(r))).numpy().copy()
    hvd.shutdown()
    return res


def stall_session():
    """Rank 1 withholds ``stall.x`` (HOROVOD_STALL_CHECK_TIME_SECONDS 1,
    ..._SHUTDOWN_TIME_SECONDS 2): rank 0 logs the coordinator's warning
    and raises StalledTensorError."""
    hvd.init(device="cpu")
    r = hvd.rank()
    warnings = []

    class _Catch(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    from horovod_tpu_torch.utils.logging import get_logger
    catch = _Catch()
    get_logger().addHandler(catch)
    res = {"warnings": warnings, "error": None}
    try:
        h = hvd.allreduce_async(torch.ones(2), name="stall.both")
        if r == 0:
            hs = hvd.allreduce_async(torch.ones(2), name="stall.x")
        hvd.synchronize(h)
        if r == 0:
            try:
                hvd.synchronize(hs)
            except hvd.StalledTensorError as e:
                res["error"] = str(e)
        import torch.distributed as dist
        dist.barrier()
    finally:
        get_logger().removeHandler(catch)
        hvd.shutdown()
    return res


def timeline_session(path, script):
    """The script under HOROVOD_TIMELINE=path (one trace, rank 0's file)."""
    os.environ["HOROVOD_TIMELINE"] = path
    hvd.init(device="cpu")
    out = run_script(script, hvd.rank())
    hvd.shutdown()
    return out


def store_reinit(sessions, ep_every):
    """``shutdown()`` -> ``init()`` ``sessions`` times over one store, as
    bench.transformer's run_moe_benchmark re-inits (every ``ep_every``-th
    session with the expert mesh of HOROVOD_EXPERT_PARALLEL=2); each
    session an engine all-reduce and a direct gloo one. Returns each
    session's sums and the process's one store."""
    from horovod_tpu_torch import runtime
    sums = []
    for s in range(sessions):
        if ep_every and s % ep_every == ep_every - 1:
            os.environ["HOROVOD_EXPERT_PARALLEL"] = "2"
        else:
            os.environ.pop("HOROVOD_EXPERT_PARALLEL", None)
        hvd.init(device="cpu")
        r = hvd.rank()
        a = hvd.allreduce(torch.full((3,), float(r + s)), average=False,
                          name=f"reinit.{s}")
        b = hvd.grouped_allreduce([torch.full((2,), float(r))],
                                  average=False)[0]
        sums.append((a.numpy().copy(), b.numpy().copy(),
                     hvd.expert_parallel_size()))
        hvd.shutdown()
    return {"sums": sums, "stores": len(runtime._stores)}


def autograd_session(inp):
    """The autograd functions and the in-place forms over the ranks:
    HorovodAllreduce (sum and mean), HorovodAllgather with uneven dim 0,
    HorovodBroadcast, allreduce_/broadcast_, fp16 compression; the
    gradients each rank gets."""
    hvd.init(device="cpu")
    r = hvd.rank()
    res = {}
    for average in (False, True):
        x = torch.from_numpy(inp["x"][r]).requires_grad_()
        y = hvd.allreduce(x, average=average, name=f"ag.ar.{average}")
        (y * torch.from_numpy(inp["w"])).sum().backward()
        res[f"ar_{average}"] = (y.detach().numpy().copy(),
                                x.grad.numpy().copy())
    g = torch.from_numpy(inp["g"][r]).requires_grad_()
    y = hvd.allgather(g, name="ag.gather")
    (y * torch.from_numpy(inp["gw"])).sum().backward()
    res["gather"] = (y.detach().numpy().copy(), g.grad.numpy().copy())
    b = torch.from_numpy(inp["x"][r]).requires_grad_()
    y = hvd.broadcast(b, 1, name="ag.bcast")
    (y * torch.from_numpy(inp["w"])).sum().backward()
    res["bcast"] = (y.detach().numpy().copy(), b.grad.numpy().copy())
    t = torch.from_numpy(inp["x"][r].copy())
    out = hvd.allreduce_(t, name="ag.inplace")
    res["inplace"] = (out is t, t.numpy().copy())
    t = torch.from_numpy(inp["x"][r].copy())
    hvd.broadcast_(t, 0, name="ag.bcast_inplace")
    res["bcast_inplace"] = t.numpy().copy()
    res["fp16"] = hvd.allreduce(
        torch.from_numpy(inp["x"][r]), name="ag.fp16",
        compression=hvd.Compression.fp16).numpy().copy()
    # unnamed ops: every rank names them in its submission order
    res["noname"] = hvd.allreduce(torch.ones(2), average=False).numpy()
    hvd.shutdown()
    return res


def exchange_session(inp):
    """``hvd.exchange_gradients`` over the ranks: this rank's nest of
    gradients summed, averaged and averaged over an fp16 wire, then the
    average again under the same names (the response cache's hits, read
    before and after the repeat)."""
    hvd.init(device="cpu")
    r = hvd.rank()
    grads = {"w": torch.from_numpy(inp["w"][r]),
             "layers": [torch.from_numpy(inp["l0"][r]),
                        (torch.from_numpy(inp["l1"][r]),)]}
    res = {}
    for key, kw in (("sum", {"average": False}), ("avg", {}),
                    ("fp16", {"compression": hvd.Compression.fp16,
                              "name_prefix": "eg.fp16"})):
        out = hvd.exchange_gradients(grads, **kw)
        res[key] = {"w": out["w"].numpy().copy(),
                    "l0": out["layers"][0].numpy().copy(),
                    "l1": out["layers"][1][0].numpy().copy()}
    cache = hvd.runtime.live_state().engine.response_cache
    hits = cache.hits
    hvd.exchange_gradients(grads)
    res["repeat_hits"] = cache.hits - hits
    hvd.shutdown()
    return res


def optimizer_session(inp, steps):
    """DistributedOptimizer(SGD) over the ranks with the bias frozen at
    construction and unfrozen after the first step (the reference's
    test_dynamic_requires_grad): each step's parameters."""
    hvd.init(device="cpu")
    r = hvd.rank()
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(inp["w0"]))
        model.bias.copy_(torch.from_numpy(inp["b0"]))
    model.bias.requires_grad_(False)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    params = []
    for s in range(steps):
        if s == 1:
            model.bias.requires_grad_(True)
        x = torch.from_numpy(inp["opt_x"][s][r])
        loss = (model(x) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        params.append((model.weight.detach().numpy().copy(),
                       model.bias.detach().numpy().copy(),
                       model.bias.grad is not None))
    hvd.shutdown()
    return params


def binding_session(inp, steps):
    """:func:`autograd_session` and :func:`optimizer_session` in one
    spawn: (autograd results, optimizer parameters by step)."""
    return autograd_session(inp), optimizer_session(inp, steps)


def hierarchical_session(inp):
    """HOROVOD_HIERARCHICAL_ALLREDUCE over 4 ranks of local size 2: the
    engine's buckets through the two-level route; the sums and the
    profiler's bucket sizes (padded to the local tier)."""
    hvd.init(device="cpu")
    r = hvd.rank()
    eng = hvd.runtime.engine()
    hs = [hvd.allreduce_async(torch.from_numpy(inp[i][r]), average=avg,
                              name=f"hier.{i}")
          for i, avg in ((0, False), (1, True), (2, False))]
    out = [hvd.synchronize(h).numpy().copy() for h in hs]
    sizes = sorted(hvd.runtime.live_state().stats.histogram("allreduce"))
    local = eng.hier_local_size
    hvd.shutdown()
    return {"out": out, "sizes": sizes, "local": local}


def hierarchical_allgather(inp):
    """HOROVOD_HIERARCHICAL_ALLGATHER over 4 ranks of local size 2: each
    ragged gather through the engine's two-stage route, beside the flat
    gather of ops/collectives.py; which tiers the engine built (the
    allreduce stays flat without its own flag)."""
    from horovod_tpu_torch.ops import collectives
    hvd.init(device="cpu")
    r = hvd.rank()
    eng = hvd.runtime.engine()
    hs = [hvd.allgather_async(torch.from_numpy(blocks[r]), name=f"hag.{i}")
          for i, blocks in enumerate(inp)]
    out = [hvd.synchronize(h).numpy().copy() for h in hs]
    flat = [collectives.allgather(torch.from_numpy(blocks[r])).numpy()
            for blocks in inp]
    summed = hvd.allreduce(torch.ones(5), average=False, name="hag.ar")
    res = {"out": out, "flat": flat, "local": eng.hier_local_size,
           "allreduce_flat": eng._hier_ar is None,
           "sum": summed.numpy().copy(),
           "sizes": sorted(hvd.runtime.live_state().stats.histogram(
               "allreduce"))}
    hvd.shutdown()
    return res


def shutdown_propagation():
    """Rank 1 shuts down without joining ``orphan``; rank 0's pending
    handle must fail fast with ShutDownError (the shutdown bit echoed by
    the coordinator), not wait out the stall deadline."""
    hvd.init(device="cpu")
    r = hvd.rank()
    if r == 1:
        hvd.shutdown()
        return None
    t0 = time.perf_counter()
    h = hvd.allreduce_async(torch.ones(4), name="orphan")
    try:
        hvd.synchronize(h)
        out = None
    except hvd.ShutDownError as e:
        out = str(e)
    waited = time.perf_counter() - t0
    hvd.shutdown()
    return out, waited


# tests/test_torch_matrix.py: the dtype x dims sweeps of
# tests/test_matrix.py, every case run by each rank in one session.
MATRIX_SUM_DTYPES = ["uint8", "int8", "uint16", "int16", "int32", "int64",
                     "float16", "float32", "float64"]
MATRIX_GATHER_DTYPES = MATRIX_SUM_DTYPES + ["bool"]
MATRIX_DIMS = [1, 2, 3]


def matrix_data(case, r, n):
    """Rank ``r``'s input of a matrix case ``(op, dtype, dim)``, as
    tests/test_matrix.py draws it: divergent small integers from
    ``RandomState(100 + r)`` for the sums (an n-rank int8 sum stays in
    range), ``r`` for the average, ``r % 2`` for the gather, and the
    root's ``r + 1`` (True for bool) against zeros for the broadcast
    (root ``dim % n``)."""
    op, dtype, dim = case
    shape = (2,) * dim
    if op == "sum":
        return np.random.RandomState(100 + r).randint(
            0, 16, shape).astype(dtype)
    if op == "avg":
        return np.full((3, 2), float(r), dtype)
    if op == "gather":
        return (np.ones(shape) * (r % 2)).astype(dtype)
    if r != dim % n:
        return np.zeros(shape, dtype)
    return (np.ones(shape) * (1 if dtype == "bool" else r + 1)).astype(dtype)


def matrix_session(cases, fused_dtypes, mixed_dtypes):
    """Every ``(op, dtype, dim)`` case through the engine, then the
    fused-many cases (6 tensors of each dtype in flight, the fused
    buckets they took) and the mixed-dtype group. Returns numpy results
    keyed by case."""
    from horovod_tpu_torch import metrics
    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    out = {}
    for case in cases:
        op, dtype, dim = case
        t = torch.from_numpy(matrix_data(case, r, n))
        name = f"mx.{op}.{dtype}.{dim}"
        if op in ("sum", "avg"):
            res = hvd.allreduce(t, average=op == "avg", name=name)
        elif op == "gather":
            res = hvd.allgather(t, name=name)
        else:
            res = hvd.broadcast(t, dim % n, name=name)
        out[case] = res.numpy().copy()
    for dtype in fused_dtypes:
        before = metrics.ENGINE_BUCKET_FLUSHES.value()
        hs = [hvd.allreduce_async(torch.from_numpy(np.full((4,), i + r,
                                                           dtype)),
                                  average=False, name=f"mx.fused.{dtype}.{i}")
              for i in range(6)]
        vals = [hvd.synchronize(h).numpy().copy() for h in hs]
        out[("fused", dtype)] = (
            vals, metrics.ENGINE_BUCKET_FLUSHES.value() - before)
    hs = [hvd.allreduce_async(torch.from_numpy(np.full((3,), r + i, dtype)),
                              average=False, name=f"mx.mix.{i}")
          for i, dtype in enumerate(mixed_dtypes)]
    out["mixed"] = [hvd.synchronize(h).numpy().copy() for h in hs]
    hvd.shutdown()
    return out


def stress_session(n_threads, per_thread, n_async, n_drain):
    """tests/test_torch_stress.py: ``n_threads`` threads, each
    synchronous-allreducing ``per_thread`` distinct names at once (after
    a barrier), then ``n_async`` threads submitting async and
    ``n_drain`` threads synchronizing the handles another thread made.
    Rank r contributes ``value * (r + 1)``. Returns the results by
    (thread, op) and by submitter, and any error."""
    import concurrent.futures
    import threading

    hvd.init(device="cpu")
    r = hvd.rank()
    results, errors = {}, []
    barrier = threading.Barrier(n_threads)

    def worker(t):
        try:
            barrier.wait(timeout=30)
            for i in range(per_thread):
                value = float(t * 100 + i) * (r + 1)
                out = hvd.allreduce(torch.full((4,), value), average=False,
                                    name=f"stress.{t}.{i}")
                results[(t, i)] = out.numpy().copy()
        except Exception as e:  # reported to the test
            errors.append((t, repr(e)))

    with concurrent.futures.ThreadPoolExecutor(n_threads) as ex:
        list(ex.map(worker, range(n_threads)))

    handles = {}

    def submit(t):
        handles[t] = hvd.allreduce_async(
            torch.full((3,), float(t) * (r + 1)), average=False,
            name=f"xsync.{t}")

    threads = [threading.Thread(target=submit, args=(t,))
               for t in range(n_async)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    drained = {}

    def drain(t):
        drained[t] = hvd.synchronize(handles[t]).numpy().copy()

    with concurrent.futures.ThreadPoolExecutor(n_drain) as ex:
        list(ex.map(drain, range(n_async)))
    hvd.shutdown()
    return {"sync": results, "async": drained, "errors": errors}
