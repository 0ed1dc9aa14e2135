"""Online autotuner for the eager engine's batching knobs.

Reference equivalent: horovod/common/parameter_manager.{h,cc} — a
``ParameterManager`` that jointly tunes the fusion threshold and cycle time by
Bayesian optimization (Gaussian-process surrogate + expected-improvement
acquisition, horovod/common/optim/bayesian_optimization.{h,cc} and
gaussian_process.{h,cc} on Eigen) and flips categorical flags
(hierarchical allreduce/allgather, cache), scoring candidates by observed
bytes/sec (``Update`` parameter_manager.cc:155, ``Tune`` :183), with warmup
discarding and N-sample averaging; rank 0 tunes and broadcasts the winning
parameters (``SyncParams`` :223-262).

Counterpart of horovod_tpu/autotune.py: the same surrogate, acquisition,
categorical layer, largest-message guard, prefetch tuner and CSV log, so
the same observations give the same suggestions and rows
(``np.random.default_rng(0)``). The tunables are the eager engine's
(ops/engine.py): its fusion threshold (which is also the bucket size of
the overlap pipeline), cycle time, padding and in-flight depth. The
Bayesian optimizer is the native one (csrc/gaussian_process.cc, built
with the rest of the control plane by native.py); a failed build raises
at ``init()``, so a tuner never runs on a quietly different optimizer.
:class:`BayesianOptimization` is the numpy form of the same
acquisition, for a caller that constructs it on purpose.

At one rank the engine is in process and the tuned values apply to it
directly. Above one rank, per-process tuning would diverge fusion plans
(and so the buckets each rank sends, which NCCL would hang on), so only
process 0 holds a :class:`ParameterManager`, and ``sync_publish`` routes
each change through the coordinator's decision log; every process
applies it at the same decision index (the reference's ``SyncParams``,
parameter_manager.cc:223-262). The tuning domain is the reference's
(fusion 0..64 MiB, cycle 1..25 ms; parameter_manager.cc:52-76).

The window counts fused collectives, not training steps: every fused
all-reduce the engine completes is one ``record_bytes`` call (the
reference's ``Update``). Set ``HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE`` to a
training step's collectives or more so a window covers a whole step.
"""

import math

import numpy as np

from .config import next_power_of_two
from .utils.logging import get_logger

_logger = get_logger()


class GaussianProcessRegressor:
    """Minimal GP regression with an RBF kernel (reference:
    optim/gaussian_process.{h,cc}; kernel-parameter L-BFGS optimization is
    replaced by a small grid refresh over length scales, which is adequate for
    the 2-D tuning domain)."""

    def __init__(self, alpha=1e-6):
        self.alpha = alpha
        self.length_scale = 1.0
        self._x = None
        self._y = None
        self._k_inv = None

    def _kernel(self, a, b, length_scale=None):
        ls = length_scale or self.length_scale
        d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d / (ls * ls))

    def fit(self, x, y):
        x = np.asarray(x, float)
        y = np.asarray(y, float)
        best = (None, -np.inf)
        for ls in (0.1, 0.3, 1.0, 3.0):
            k = self._kernel(x, x, ls) + self.alpha * np.eye(len(x))
            try:
                l_chol = np.linalg.cholesky(k)
            except np.linalg.LinAlgError:
                continue
            alpha_v = np.linalg.solve(l_chol.T, np.linalg.solve(l_chol, y))
            # log marginal likelihood up to constants
            lml = (-0.5 * y @ alpha_v
                   - np.log(np.diag(l_chol)).sum())
            if lml > best[1]:
                best = (ls, lml)
        if best[0] is not None:
            self.length_scale = best[0]
        k = self._kernel(x, x) + self.alpha * np.eye(len(x))
        self._x, self._y = x, y
        self._k_inv = np.linalg.inv(k)

    def predict(self, x):
        x = np.asarray(x, float)
        if self._x is None:
            return np.zeros(len(x)), np.ones(len(x))
        ks = self._kernel(x, self._x)
        mu = ks @ self._k_inv @ self._y
        kss = np.ones(len(x))
        var = kss - np.einsum("ij,jk,ik->i", ks, self._k_inv, ks)
        return mu, np.sqrt(np.maximum(var, 1e-12))


class BayesianOptimization:
    """Expected-improvement acquisition over a normalized box domain
    (reference: optim/bayesian_optimization.{h,cc}). Reference-only in
    the port: :class:`ParameterManager` always runs the native optimizer,
    and the tests hold this numpy form to the JAX package's."""

    def __init__(self, bounds, xi=0.1):
        self.bounds = np.asarray(bounds, float)  # (d, 2)
        self.xi = xi
        self.gp = GaussianProcessRegressor()
        self._xs = []
        self._ys = []

    def add_sample(self, x, y):
        self._xs.append(np.asarray(x, float))
        self._ys.append(float(y))

    def _normalize(self, x):
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (x - lo) / np.maximum(hi - lo, 1e-12)

    def suggest(self, rng, n_candidates=256):
        d = len(self.bounds)
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        cand = rng.uniform(lo, hi, size=(n_candidates, d))
        if len(self._xs) < 2:
            return cand[0]
        self.gp.fit(self._normalize(np.stack(self._xs)), np.asarray(self._ys))
        mu, sigma = self.gp.predict(self._normalize(cand))
        best = max(self._ys)
        z = (mu - best - self.xi) / np.maximum(sigma, 1e-12)
        ei = (mu - best - self.xi) * _norm_cdf(z) + sigma * _norm_pdf(z)
        return cand[int(np.argmax(ei))]


def _norm_cdf(z):
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


class _NativeBayesianOptimization:
    """ctypes facade over csrc/gaussian_process.cc (same EI acquisition as
    the numpy BayesianOptimization)."""

    def __init__(self, lib, bounds, xi=0.1, seed=0):
        import ctypes
        self._lib = lib
        self._dim = len(bounds)
        lo = (ctypes.c_double * self._dim)(*[b[0] for b in bounds])
        hi = (ctypes.c_double * self._dim)(*[b[1] for b in bounds])
        self._h = lib.hvd_bo_new(self._dim, lo, hi, float(xi), int(seed))
        self._xs = []
        self._ys = []

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.hvd_bo_free(h)

    def add_sample(self, x, y):
        import ctypes
        xs = (ctypes.c_double * self._dim)(*[float(v) for v in np.ravel(x)])
        self._lib.hvd_bo_add_sample(self._h, xs, self._dim, float(y))
        self._xs.append(np.asarray(x, float))
        self._ys.append(float(y))

    def suggest(self, rng=None, n_candidates=256):
        import ctypes
        del rng, n_candidates  # native side owns its RNG/candidate pool
        out = (ctypes.c_double * self._dim)()
        self._lib.hvd_bo_suggest(self._h, out, self._dim)
        return np.array(out[:])


class ParameterManager:
    """Drives the tuning loop from per-step byte/time observations
    (reference: parameter_manager.cc Update/Tune/SetAutoTuning)."""

    # Tuning domain parity (reference: parameter_manager.cc:52-76):
    # fusion threshold 0..64 MiB, cycle time 1..25 ms. The fusion
    # threshold doubles as the overlap pipeline's bucket size — it decides
    # how much gradient traffic each dispatched wire bucket carries.
    BOUNDS = [(0.0, 64.0 * 1024 * 1024), (1.0, 25.0)]
    # Categorical layer (reference chains CategoricalParameters for the
    # hierarchical-allreduce/allgather/cache flags in front of the Bayesian
    # ones, parameter_manager.cc:101-127). The categoricals tuned here are
    # the JAX package's: the fork's power-of-two wire padding experiment
    # (PADDING_ALGO) and the overlap pipeline's in-flight depth (how many
    # fused buckets ride the wire before completion backpressure).
    COMBOS = (0, 1)  # padding_algo values
    DEPTHS = (1, 2, 4)  # pipeline_depth values (pipeline enabled only)
    # Input-prefetch ceiling: each queue slot pins one staged batch on
    # the host (and, with device staging, one in-flight transfer), so
    # growth is bounded the same way the reference bounds its fusion
    # buffer.
    PREFETCH_MAX = 16
    # Largest-message guard (the JAX package's batch-512 sweep regression): a
    # candidate may only become the incumbent if its measured wire
    # goodput at the largest observed message-size bin did not drop more
    # than this fraction below the incumbent's. Protects the big-batch
    # buckets an overall score (dominated by many small messages) can
    # trade away. Engages only at bins >= the floor: below ~1 MiB wire
    # latency is dispatch-dominated and per-bin goodput is noise — a 2%
    # band there would reject candidates on scheduler jitter, not on
    # the large-message regression the guard exists for.
    LARGE_MSG_TOLERANCE = 0.02
    LARGE_MSG_GUARD_MIN_BYTES = 1 << 20

    def __init__(self, config):
        self.config = config
        self.active = True
        # Multi-host: set to engine.publish_autotune on process 0; when set,
        # _apply publishes through the decision log instead of mutating
        # config here (SyncParams analog — see module docstring).
        self.sync_publish = None
        self.warmup_remaining = config.autotune_warmup_samples
        self.steps_per_sample = config.autotune_steps_per_sample
        self.max_samples = config.autotune_bayes_opt_max_samples
        from . import native
        lib = native.get_lib()  # raises when the library cannot be built

        def make_bo():
            return _NativeBayesianOptimization(lib, self.BOUNDS)

        # Depth domain: only explored when the overlap pipeline is on —
        # HOROVOD_PIPELINE_DEPTH=0 is a user's synchronous-mode choice the
        # tuner must never override.
        base_depth = int(getattr(config, "pipeline_depth", 0))
        if base_depth > 0:
            self._depths = tuple(sorted(set(self.DEPTHS) | {base_depth}))
        else:
            self._depths = (base_depth,)
        # one independent surrogate per categorical combo (padding, depth)
        self._bos = {(c, d): make_bo() for c in self.COMBOS
                     for d in self._depths}
        self._rng = np.random.default_rng(0)
        self._bytes = 0
        self._hidden_s = 0.0
        self._exposed_s = 0.0
        self._input_wait_s = 0.0
        self._input_frac = 0.0
        self._input_seen = False
        # Per-window wire telemetry by power-of-two size bin:
        # bin -> [bytes, seconds] (engine._observe_wire feeds it).
        self._wire_bins = {}
        # (size_bin, goodput) of the incumbent best at ITS largest
        # observed message size — the guard's comparison point.
        self._best_large = None
        self._live_prefetch = None
        self._prefetch_idle = 0
        self._t_start = None
        self._steps = 0
        self._samples = 0
        self._best = (-np.inf, config.fusion_threshold, config.cycle_time_ms,
                      config.padding_algo, base_depth)
        self._current = (config.fusion_threshold, config.cycle_time_ms)
        self._combo = config.padding_algo if config.padding_algo in \
            self.COMBOS else 0
        self._depth = base_depth if base_depth in self._depths \
            else self._depths[0]
        self._log_rows = []

    def record_bytes(self, nbytes):
        """Feed per-collective traffic (reference: Update,
        parameter_manager.cc:155)."""
        import time
        if not self.active:
            return
        if self._t_start is None:
            self._t_start = time.perf_counter()
        self._bytes += int(nbytes)
        self._steps += 1
        if self._steps >= self.steps_per_sample:
            self._finish_sample()

    def record_overlap(self, hidden_s, exposed_s):
        """Feed per-bucket overlap telemetry from the engine's completion
        stage: ``hidden_s`` is dispatch-to-first-block wall time (comm that
        rode behind compute), ``exposed_s`` the blocking readback wait.
        On a card the host's wait does not block: ``exposed_s`` is the
        consumer stream's stall at the hand-over (the engine's
        ``_feed_exposure``), and ``hidden_s`` is 0 (the score reads only
        the exposed time).
        Folded into the sample score so depth/bucket-size candidates that
        hide more of the wire time win.

        Window-boundary bleed: a bucket dispatched under candidate k can
        complete after the sample rolled to k+1 and credit its overlap
        there. Bounded by pipeline_depth buckets against
        autotune_steps_per_sample (default 10) per window — the same
        order of boundary noise the reference's byte windows carry — so
        it shifts scores by at most a few percent, not the ranking."""
        if not self.active:
            return
        self._hidden_s += max(float(hidden_s), 0.0)
        self._exposed_s += max(float(exposed_s), 0.0)

    def record_wire(self, nbytes, seconds):
        """Feed one wire-op span (engine._observe_wire / the
        hvd_wire_seconds profiler): message bytes and the measured
        dispatch-to-ready latency, binned by power of two. Drives the
        largest-message guard in :meth:`_finish_sample`."""
        if not self.active:
            return
        b = next_power_of_two(max(int(nbytes), 1))
        acc = self._wire_bins.setdefault(b, [0, 0.0])
        acc[0] += int(nbytes)
        acc[1] += max(float(seconds), 0.0)

    def record_input_wait(self, wait_s):
        """Feed input-pipeline stall telemetry from the data loader
        (data/loader.py): seconds the training loop blocked waiting for
        a batch. Drives the prefetch-depth tuner (:meth:`_tune_prefetch`)
        on the same sample cadence as the comm knobs."""
        if not self.active:
            return
        self._input_seen = True
        self._input_wait_s += max(float(wait_s), 0.0)

    def record_prefetch_depth(self, depth):
        """Loader hook: the prefetch depth the CURRENT epoch actually
        runs at (depth changes land at epoch boundaries). The tuner
        refuses to step again until its last change has taken effect, so
        several sample windows inside one epoch cannot compound
        doublings off measurements all taken at the old depth."""
        self._live_prefetch = int(depth)

    def _tune_prefetch(self, input_frac, input_seen):
        """Tune HOROVOD_DATA_PREFETCH off the window's input-wait share,
        the way pipeline depth is tuned off overlap telemetry — but by
        bounded hill-climb, not the GP: prefetch depth is host-local (it
        never shapes wire programs, so no SyncParams broadcast) and its
        response is monotone-until-saturated, which a double-on-stall /
        decay-when-idle walk finds in a handful of windows. Loaders
        re-read the config at epoch boundaries, so a change lands on the
        next epoch. ``data_prefetch=0`` is a user's explicit synchronous
        choice and is never overridden (the HOROVOD_PIPELINE_DEPTH=0
        contract)."""
        depth = int(getattr(self.config, "data_prefetch", 0))
        if depth <= 0:
            return
        if not input_seen:
            # no loader reported this window: a job without the data
            # subsystem (or between epochs) must not have its configured
            # depth decayed by an all-zero signal
            return
        if self._live_prefetch is not None and self._live_prefetch != depth:
            return  # last change hasn't landed yet — don't compound
        new = depth
        if input_frac > 0.05:
            self._prefetch_idle = 0
            # never REDUCE in response to a stall: a user-configured
            # depth above the cap stays where they put it
            if depth < self.PREFETCH_MAX:
                new = min(depth * 2, self.PREFETCH_MAX)
        elif input_frac < 0.005:
            # decay only after sustained idleness: one quiet window is
            # often just an epoch boundary, and each queue slot holds
            # host memory we'd rather not thrash
            self._prefetch_idle += 1
            if self._prefetch_idle >= 3 and depth > 1:
                new = depth - 1
                self._prefetch_idle = 0
        else:
            self._prefetch_idle = 0
        if new != depth:
            self.config.data_prefetch = new
            _logger.info("autotune: input-wait %.1f%% of window -> "
                         "prefetch depth %d", input_frac * 100.0, new)

    def _finish_sample(self):
        import time
        elapsed = max(time.perf_counter() - self._t_start, 1e-9)
        goodput = self._bytes / elapsed  # bytes/sec, the reference's metric
        # Overlap-adjusted score: scale goodput by how little wall time
        # this window spent BLOCKED on readback (bounded 1..2x). Scoring
        # by exposed time — not by the per-bucket hidden fraction — keeps
        # a deeper pipeline from outscoring a shallow one through pure
        # completer queueing: depth only wins if it actually shrinks the
        # exposed wait for the same bytes.
        hidden_frac = 1.0 - min(self._exposed_s / elapsed, 1.0)
        # Input-wait share of the window: drives the prefetch tuner but
        # stays OUT of the comm score — the GP's knobs (fusion, cycle,
        # depth) cannot move input stalls, and folding them in would
        # only add noise to the surrogate.
        input_frac = min(self._input_wait_s / elapsed, 1.0)
        input_seen = self._input_seen
        self._input_frac = input_frac
        score = goodput * (1.0 + hidden_frac)
        # This window's wire goodput at the largest observed message-size
        # bin (the guard's metric; None when no wire spans were measured).
        large_bin, large_goodput = 0, None
        if self._wire_bins:
            large_bin = max(self._wire_bins)
            b, s = self._wire_bins[large_bin]
            large_goodput = b / max(s, 1e-9)
        self._wire_bins = {}
        self._bytes = 0
        self._hidden_s = 0.0
        self._exposed_s = 0.0
        self._input_wait_s = 0.0
        self._input_seen = False
        self._steps = 0
        self._t_start = None
        if self.warmup_remaining > 0:
            self.warmup_remaining -= 1
            return
        self._tune_prefetch(input_frac, input_seen)
        self._samples += 1
        guard_rejected = False
        if score > self._best[0]:
            # Largest-message guard (batch-512 sweep regression): a
            # candidate whose goodput DROPS vs the incumbent at the
            # largest message size never becomes the incumbent, however
            # its overall score looks — the rejection is recorded in the
            # autotune CSV (guard_rejected=1).
            inc = self._best_large
            if (inc is not None and large_goodput is not None
                    and large_bin >= self.LARGE_MSG_GUARD_MIN_BYTES
                    and large_bin >= inc[0]
                    and large_goodput < inc[1]
                    * (1.0 - self.LARGE_MSG_TOLERANCE)):
                guard_rejected = True
                _logger.info(
                    "autotune: candidate fusion=%d cycle=%.1fms rejected — "
                    "goodput at the largest message bin (%d B) dropped "
                    "%.0f -> %.0f B/s vs the incumbent",
                    int(self._current[0]), self._current[1], large_bin,
                    inc[1], large_goodput)
            else:
                self._best = (score, *self._current, self._combo,
                              self._depth)
                # The guard point always describes the CURRENT incumbent:
                # an incumbent accepted without wire telemetry has no
                # large-message point, and comparing later candidates
                # against a dethroned config's number would reject them
                # against a dead incumbent.
                self._best_large = ((large_bin, large_goodput)
                                    if large_goodput is not None else None)
        # Teach the surrogate AFTER the guard: a rejected candidate fed
        # at its raw (winning) score would steer the acquisition function
        # straight back into the guarded-off region every window. It
        # learns a score discounted below the incumbent's by the same
        # large-message regression that disqualified it; the CSV keeps
        # the raw measurement.
        bo_score = score
        if guard_rejected:
            bo_score = self._best[0] * (large_goodput
                                        / max(self._best_large[1], 1e-9))
        self._bos[(self._combo, self._depth)].add_sample(
            np.asarray(self._current, float), bo_score)
        self._log_rows.append((self._samples, *self._current, self._combo,
                               self._depth,
                               int(getattr(self.config, "data_prefetch", 0)),
                               int(getattr(self.config, "zero_stage", 0)),
                               getattr(self.config, "dcn_compression", "")
                               or "none",
                               int(getattr(self.config, "moe_chunks", 1)),
                               round(hidden_frac, 4), round(input_frac, 4),
                               large_bin,
                               round(large_goodput, 1)
                               if large_goodput is not None else 0,
                               int(guard_rejected),
                               score))
        # the reference streams the log as it tunes (parameter_manager.cc
        # writes each sample); rewrite-per-sample keeps that observability
        self._write_log()
        if self._samples >= self.max_samples:
            # Converged: pin the best parameters (reference: SetAutoTuning
            # false once Bayesian opt exhausts its sample budget).
            _, fusion, cycle, combo, depth = self._best
            self._apply(fusion, cycle, combo, depth)
            self.active = False
            _logger.info("autotune converged: fusion=%d cycle=%.1fms "
                         "padding=%d depth=%d score=%.0f "
                         "(overlap-adjusted B/s)", int(fusion),
                         cycle, combo, depth, self._best[0])
            return
        # round-robin the categorical combos during exploration (the
        # reference cycles categorical settings the same way), each with
        # its own Bayesian suggestion; depth cycles on the slower stride
        # so every (padding, depth) pair gets visited.
        combo = self.COMBOS[self._samples % len(self.COMBOS)]
        depth = self._depths[(self._samples // len(self.COMBOS))
                             % len(self._depths)]
        nxt = self._bos[(combo, depth)].suggest(self._rng)
        self._apply(nxt[0], nxt[1], combo, depth)

    def _apply(self, fusion, cycle, combo=None, depth=None):
        self._current = (float(fusion), float(cycle))
        if combo is not None:
            self._combo = int(combo)
        if depth is not None:
            self._depth = int(depth)
        if self.sync_publish is not None:
            # Multi-host: the parameters take effect when every process —
            # this one included — fetches the decision, keeping fusion
            # plans in lockstep (SyncParams, parameter_manager.cc:223-262).
            self.sync_publish(int(fusion), float(cycle), int(self._combo),
                              int(self._depth))
            return
        self.config.fusion_threshold = int(fusion)
        self.config.cycle_time_ms = float(cycle)
        if combo is not None:
            self.config.padding_algo = int(combo)
        if depth is not None:
            self.config.pipeline_depth = int(depth)

    def _write_log(self):
        """Reference: HOROVOD_AUTOTUNE_LOG CSV (parameter_manager.cc:270-319)."""
        if not self.config.autotune_log:
            return
        with open(self.config.autotune_log, "w") as f:
            # score stays the LAST column — tooling parses it positionally
            # from the end; named for what it now is (goodput scaled by
            # 1+comm_hidden_frac), NOT raw wire bytes/sec
            f.write("sample,fusion_threshold,cycle_time_ms,padding_algo,"
                    "pipeline_depth,data_prefetch,zero_stage,"
                    "dcn_compression,moe_chunks,comm_hidden_frac,"
                    "input_wait_frac,largest_msg_bytes,"
                    "largest_msg_goodput,guard_rejected,"
                    "overlap_adjusted_bytes_per_sec\n")
            for row in self._log_rows:
                f.write(",".join(str(v) for v in row) + "\n")
