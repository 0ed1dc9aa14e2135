"""Smoke run of horovod_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any fault:

1. device: a CUDA card is required; its name and power limit are
   printed as ``nvidia-smi`` reports them;
2. build: every CUDA source of the port is compiled from the checkout
   (one nvcc per source, all at once) into build/horovod_tpu_torch/,
   and beside them the eager engine's native control plane
   (``horovod_tpu_torch/csrc``, g++);
   each kernel's registers, spills and shared memory (nvcc's -Xptxas -v)
   and the count of HGMMA (wgmma) instructions in its SASS (cuobjdump
   -sass, where the toolkit has it; a tensor-core kernel without one
   fails the run) are printed, for both sources;
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the same tensors on the card, with stated tolerances. ``flash_fwd``
   at the serving prefill shape, the SP path's diagonal tile (B 2,
   S 2048, window 4096) and ragged, windowed, non-causal and f32 shapes;
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the training head shape
   (B 1, S 4096), the SP diagonal tile with lse and delta strided as the
   ring's chunks are, and ragged causal, windowed, non-causal MHA and f32
   shapes. Both at a TP rank's heads too (H 8 / H_kv 2: the prefill
   B 8 x 512 and the training B 1 x 4096, whose dO has the batch stride
   1 that autograd gives it there). Every kernel, forward and backward, takes the tensor-core
   route on bf16 at D 64 or 128 and the CUDA-core loop elsewhere (the
   f32 shapes), as ``tensor_core_route`` says, and each shape checks
   that it took the route the rule gives. Each kernel, its plain version
   and one PyTorch library call computing the same function are timed at
   the shape its main path gives it (the plain backward at B 1: at B 4 it
   would materialize 4.3 GB score matrices);
4. parity: the serve engine's prefill logits through the flash kernel
   against the same prompts through ``attention_impl="dense"`` at full
   width, and a small f32 model's prefill + decode against its forward;
   then ``loss_fn``'s loss and every parameter gradient through flash
   against dense, at full width (B 1, S 1024) and on a small f32 model
   (run beside the tp phase, below: parity, not a speed);
5. serve (main path 1): the flagship transformer of bench_transformer.py
   at full width (8 layers, the bench's own depth; d_model 2048, 16 query
   / 4 KV heads, d_ff 8192, vocab 32768, rope, bf16 activations, f32
   parameters, random weights from seed 0) serves 8 greedy requests of
   512 prompt tokens and 64 new tokens through ``serve.Engine``;
6. train (main path 2): the same model, as bench_transformer.py trains
   it (batch 4 x seq 4096, loss_chunk 512, AdamW 3e-4 with weight decay
   1e-4), through ``hvd.init()`` (NCCL, one rank),
   ``broadcast_parameters`` and ``DistributedOptimizer``: one warm-up
   step and 4 timed steps on one batch. The loss must fall, and the
   launches and exchanges must be as many as the steps say;
7. band kernels: ``flash_band_fwd``, ``flash_band_dq`` and
   ``flash_band_dkv`` against their plain versions at the ring's shapes
   (B 2, S 2048, H 16, H_kv 4, D 128, bf16, offsets 2048 and 4096, window
   4096; lse and delta strided as the ring's chunks are) and at small
   ragged f32 shapes with rows that see no key; each
   kernel, its plain version and SDPA with an explicit band mask timed at
   both offsets;
8. sequence-parallel parity: one step's loss and gradients of the
   flagship at max_seq 8192 and Mistral-7B's sliding window 4096 over a
   local ring of 4 against the same model without sequence parallelism
   (``flash_attention`` at the same window) on one batch of 2 x 8192, and
   a small f32 model's ring against dense attention;
9. SP train (main path 3): that model, through ``ShardAxes(sp=
   RingAxis.local(4))``, trained as in 6 at batch 2 x 8192 (2048 tokens
   a shard): 40 launches of each band kernel and 32 of each static kernel
   a step, checked exactly;
10. resnet (main path 4): ResNet-50 as bench.py trains it. Its f32
   forward at batch 2 on the card (TF32 off for cuDNN) against the same
   weights on the CPU; then the bf16 model, channels_last, at batch 256
   x 224^2 through ``hvd.init()``, ``broadcast_parameters`` and
   ``DistributedOptimizer(SGD(0.01))``: the batch-norm running statistics
   after one step against Flax's rule (biased variance, momentum 0.9)
   computed from each layer's input, 5 more steps with a falling loss,
   one all-reduce per bucket a step, img/s and MFU. Its convolutions run
   on cuDNN (the reference has none of its own), so it launches none of
   the kernels above;
11. bench: ``python -m horovod_tpu_torch.bench.resnet`` in its
   ``HOROVOD_BENCH_SMOKE=1`` shrink (its compiled-step and serve rows
   checked for no fallback and their cache hit rates; its flagship row
   at 1 iteration and 2 of the 8 layers) and ``python -m
   horovod_tpu_torch.bench.transformer --iters 2 --layers 2`` (the
   flagship's widths; phase 6 and the compiled train phase time its
   whole depth), each line checked for its metric, a positive value, a
   numeric MFU and its depth.

The eager engine (ops/engine.py) has two phases of its own, the first
after the train phase (6), the second beside the launcher phase, and a
bench line after the bench phase:

- eager engine (main path eager_engine): the flagship at 4 x 4096 as a
  Horovod user writes the loop: each gradient handed to
  ``hvd.allreduce_async_`` from its hook as autograd produces it, every
  handle synchronized, then AdamW's step; 3 + 4 steps beside the same
  model under the bucketed ``DistributedOptimizer`` in the same session.
  The parameters after every step are bitwise equal to the bucketed
  run's (one rank: the average is a copy and a division by 1); the
  fused all-reduces of a step are exactly what the planner
  (:func:`plan_fusion_plain`, csrc/fusion.cc in plain Python) gives for
  the hooks' order at the 64 MiB threshold; the response cache answers
  at least EAGER_HIT_RATE_MIN of the negotiations from step 2 on;
  ``profiler.txt`` holds exactly those all-reduces by message size (and
  the bucketed one); ``HOROVOD_TIMELINE``'s file holds one negotiate
  and one op span per tensor a step; every flash launch takes the
  tensor-core route; and a profiled exchange of every gradient, in a
  session of its own, copies nothing from the card to the host. It
  prints the step time and the exchange's wall time (first hook to last
  synchronize), each beside the bucketed figure; the span of the
  engine's stream in the step (copy-in and unfuse events, a stream that
  shares the SMs with the backward: not a device time), beside the
  bucketed exchange's span on the caller's stream; and the device time
  of the exchange's kernels, summed by torch.profiler over that
  profiled exchange of every gradient;
- eager 2 ranks: two processes on this card over gloo
  (``chip_smoke.py --eager-rank R PORT OUT``; gloo moves card tensors
  through the host, so not a speed figure): 24 names of f32, bf16 and
  i32 in opposite orders equal to the host's sums and means, an
  allgather of dim-0 sizes 3 and 5, a broadcast from root 1, a shape
  mismatch raising MismatchError with the reference's message on both
  ranks, the coordinator's bypass within 10 identical cycles, and a
  stall (rank 1 withholds a name, stall check 1 s, shutdown 3 s) that
  logs "Stalled ranks:" and raises StalledTensorError;
- eager bench: ``python -m horovod_tpu_torch.bench.eager`` at one rank,
  its JSON line checked for ``eager_allreduce_mbytes_sec``.

The bench phase also runs ``horovod_tpu_torch.bench.scaling``'s
``main()`` at its defaults (the reference's MLP, batch 64 a rank, 8 steps) alone:
one card gives the size-1 row only (NCCL refuses two ranks on one
card), so its line must read ``per_n`` ``{"1": 100.0}`` and ``devices``
1, with a positive size-1 img/s on its ``# n=1`` line and no other row.

The hot loop's CUDA graphs (ops/step_program.py) have two phases of
their own, each after the eager phase it mirrors; the eager serve phase
(5) runs with ``HOROVOD_STEP_PROGRAM=0``:

- compiled serve (main path 5, after 5): the serving workload through
  ``serve.Engine`` with graph-replayed prefill and decode beside the same
  engine run eagerly in this call (tokens identical, steady decode hit
  rate >= 0.9, no fallback; decode step, prefill, token latency p50/p99,
  TTFT and the card's busy share of a round, each beside the eager
  figure), then ``generate`` on the flagship: its graph-replayed greedy
  tokens equal the eager ``decode_step``'s argmax, whose logits lie within
  LOGITS_ATOL of a full forward over the same prefix;
- compiled train (main path 6, after 6): the flagship at 4 x 4096
  through ``compiled_train_step`` with capturable AdamW: parameters after
  3 steps bitwise equal to the same optimizer's eager run, 1 cache miss
  and 0 fallbacks, per replay 8 launches of each static kernel on the
  tensor-core route and one ``allreduce_jit`` a bucket, and the replay's
  time beside the eager step's.

Mixture-of-Experts has three phases of its own on flagship-moe
(``MOE_MODEL``: the flagship with an MoE FFN in layers 1 and 3 of 4
(the flagship's depth cut in half), 8 experts, top-2, capacity factor
1.25; 780 M parameters, drawn once on the host from seed 0, beside
nvcc): its parity phase beside the tp phase, the other two after the
tp phase:

- moe parity: the MoE layer at full width (d 2048, ff 8192, 4 x 4096
  tokens, f32, a router skewed so that capacity drops happen) in index
  form against its dense plain version on the card (routing tables
  equal to the dense tensors, aux and counts equal, outputs within
  MOE_LAYER_REL), and flagship-moe cut to 2 layers (dense attention,
  full capacity) on the card against the CPU (router probabilities
  within MOE_PROB_ATOL, logits within LOGITS_ATOL wherever both sides
  pick the same experts);
- moe train (main path 7): flagship-moe at 4 x 4096 as the compiled
  train phase runs the flagship (3 eager steps, 3 compiled steps and 4
  replays, bitwise against eager; the expert stacks' gradients on the
  expert keys), with step time, tokens/s and peak memory; then the
  step traced by phase: MOE_TRACE_STEPS replays (a window again, up to
  MOE_TRACE_TRIES, while the profiler drops device records),
  MOE_TRACE_STEPS eager steps and one ``torch.no_grad()`` forward of the
  batch, each window
  through the trace phase's ``check_trace`` (its device ms a step by
  phase; the phases plus ``other`` equal to its device time within
  TRACE_SUM_REL; a step's flash kernels in forward and backward alone),
  the replay's phases within TRACE_PHASE_REL of the eager step's, a
  train step's ``expert`` at least MOE_EXPERT_TRAIN_MIN times the
  forward's (the MoE ranges cover the backward, as the JAX package's
  scopes do), the traced steps' launches by route an untraced step's,
  and the backward markers' idle cost under TRACE_OVERHEAD_MAX of a
  step; then the ``hvd_moe_*`` counters of one evaluation: dropped =
  t * k * MoE layers - routed;
- moe serve (main path 8): the serving workload on flagship-moe through
  the eager and the graph engine (tokens identical, steady decode hit
  rate 1.0, no fallback), MoE layers at full capacity: nothing dropped.

The bench phase also runs ``bench.transformer --moe --expert-parallel
1`` and checks the ``moe`` rows, and checks that bench.resnet's
``zero_profile`` row is filled (at one rank: no DCN stage, so
``dcn_bytes_saved_frac`` is None and the stripes are the whole row).

The ZeRO ladder has a phase of its own, after the compiled train phase:

- zero train (main path 9): the flagship at 4 x 4096 through
  ``DistributedOptimizer(AdamW(..., capturable=True), zero_stage=s)``,
  s = 1, 2, 3, as the compiled train phase runs it (3 eager steps, 3
  compiled steps and 4 replays): parameters after 3 steps bitwise equal
  to the eager run's and to stage 0's compiled run (one rank: the
  scatter and gather are copies, the division by 1), zero3's
  ``unshard_params(shard_params(p)) == p``, per replay 8 launches of
  each static kernel on the tensor-core route and one reduce-scatter
  and one all-gather record a chunk, 1 cache miss and no fallback;
  step time, tokens/s, peak memory and the ``hvd_zero_stripe_bytes``
  gauges beside stage 0's. The three stages share one session: a
  dropped step leaves the program cache, so each peak lies within 0.5
  GiB of the one the stage reaches in a session of its own. The staged
  exchange needs two ranks and NCCL refuses two on one card: it is
  checked on the CPU only, and the phase says so.

Tensor parallelism has a phase of its own, after the zero train phase:
two processes on this card (``chip_smoke.py --tp-rank R PORT OUT``),
one model group joined by gloo, which moves card tensors through the
host (NCCL refuses two ranks on one card); each checks first that gloo
carries card tensors, then ``hvd.init()`` keeps that group and builds
the 3-D mesh. The flagship at full width, each rank H 8 / H_kv 2:

- tp serve (main path 10): the 8 requests through ``ServeEngine(mesh,
  tp_axis)`` in lockstep, teacher-forced on the unsharded engine's
  greedy streams (logits within LOGITS_ATOL; the argmax equal wherever
  the unsharded top-2 gap exceeds TP_NEAR_TIE) and free running (each
  stream equal to the unsharded one up to such a near-tie); each rank's
  KV pool holds H_kv 2; 16 ``flash_fwd`` launches a rank. Off the
  counted path, the same 8 requests in f32 activations: every TP token
  identical to the unsharded engine's;
- tp train (main path 11): B 1 x 4096 through the sharded trunk and
  ``DistributedOptimizer(AdamW, model_keys=...)``: the loss within
  TRAIN_LOSS_ATOL of the unsharded model's, every gathered gradient
  within TRAIN_GRAD_REL (a model leaf's divided by the group's size:
  the reference's psum transposes to a psum), the loss falling over 3
  AdamW steps; 8 launches of each static kernel a step.

Its times are gloo's through the host with two ranks on one card, not
a TP speed figure, and the phase prints them so.

The tp train phase also runs an f32-activation leg of the same step,
off the counted path: the gathered gradients against the unsharded f32
model's within TP_F32_GRAD_REL, its worst and median relative L2
printed (how far the bf16 gap is the order of the sums).

Ulysses and the SP step in graphs (PR 11), after the SP train phase,
and the pipeline (PR 11), beside the launcher phase:

- kernels: ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` at
  Ulysses' shard shape (B 2, S 8192, H 4 / H_kv 1, D 128, bf16, causal,
  window 4096) on head-sliced views of the projections, against their
  plain versions (the backward's at B 1) and timed beside SDPA with the
  window as a mask (``ulysses_shape`` in the kernels line);
- ulysses parity: the sp parity phase also runs ``sp_impl="ulysses"``
  over a local axis of 4 against the unsharded flash model (bitwise
  equal or not, max|d| printed; within TRAIN_LOSS_ATOL and
  TRAIN_GRAD_REL) and a small f32 model's Ulysses against dense within
  SMALL_GRAD_ATOL;
- ulysses train (main path 12): that model trained as the SP train
  phase trains the ring, 32 launches of each static kernel and no band
  kernel a step, all on the tensor cores, its step time, tokens/s and
  peak beside the ring's;
- compiled sp (main path 13): the ring's and Ulysses' SP step through
  ``compiled_train_step`` with capturable AdamW as the compiled train
  phase runs the flagship (parameters after 3 steps bitwise equal to
  eager, 1 cache miss, no fallback; per replay the ring 32 static and
  40 band launches of each kernel, Ulysses 32 static);
- pipeline (main path 14): the flagship's 8 layers over a local pp
  axis of 4 at 4 x 4096 in 4 microbatches: GPipe, 1F1B and 1F1B at V 2
  against the unpipelined ``loss_fn`` (loss within TRAIN_LOSS_ATOL,
  gradients within TRAIN_GRAD_REL; a small f32 model within
  SMALL_GRAD_ATOL); then 3 AdamW steps each of the unpipelined model,
  GPipe and 1F1B, each loss falling, their step times (a local schedule
  on one card, beside the launcher phase: not a speed) and peaks (1F1B's
  below GPipe's), and
  each pipelined step's launches exact: 32 ``flash_fwd`` (GPipe) or 64
  (1F1B: the backward phase's recompute) and 32 of each backward kernel.

The phase trace (diag/xla_trace.py) has a phase of its own, after the
compiled train phase:

- trace (main path 15): the flagship at 4 x 4096 with capturable AdamW
  under ``DistributedOptimizer``, random weights from seed 0:
  ``hvd.trace_steps(4)`` over the ``compiled_train_step`` replay (the
  program re-captures once for its phase map), over the eager step
  ticked by ``TelemetryCallback`` (its regions under the same phase
  ranges), and over one graph serve round of the 8 requests. Each
  prints its device ms a step by phase, ``other``, its device time and
  ``exchange_hidden_frac``; the step also prints ``flops_per_step``
  (FlopCounterMode and the flash kernels' own counts), MFU and the idle
  tracer's and flight recorder's cost over a loop of 3 eager steps. Its
  gates: each window's phases plus ``other`` equal the device time of
  its kernels, copies and sets summed from the capture files within
  TRACE_SUM_REL; a step's ``other`` stays under TRACE_OTHER_MAX of it,
  replayed or eager; each replayed phase above TRACE_PHASE_FLOOR of the
  step lies within TRACE_PHASE_REL of the eager step's; the serve round
  keeps TRACE_SERVE_MIN of its device time in prefill and decode;
  ``flash_fwd_wgmma_kernel`` lands in forward alone and the two
  backward kernels in backward alone; both idle costs stay under
  TRACE_OVERHEAD_MAX of the loop; and the traced replays' launches by
  route equal an untraced replay's, and the parameters after the 7
  compiled steps the compiled train phase's after its 7 (the same seed
  and batch), bitwise.

The bench phase checks bench.resnet's trace rows too: the compiled
step's ``step_phase_breakdown``, ``wire_stage_ms``,
``exchange_hidden_frac``, ``overlap_ab`` and ``overlap_microbench``,
``flight_step_phase_breakdown`` and both overhead fractions filled,
``control_plane`` filled, and the MoE rows'
all-to-all keys None at ``--expert-parallel 1`` beside their phase
breakdown.

Fault tolerance has four phases of its own, after the zero train phase:

- zero guard (main path zero_guard): the flagship at 4 x 4096 through
  the compiled ``DistributedOptimizer(AdamW, zero_stage=s)`` step under
  ``HOROVOD_GUARD=1`` for s in 1, 2, 3, one rank, 1 + 4 healthy calls
  and one whose backward a chaos spec seeds with NaN. Gates: the stripe
  (and below zero3 every parameter) after the healthy calls bitwise the
  unguarded zero train run's after as many steps; the NaN call skipped
  with the stripe, AdamW's state and the parameters bitwise kept; one
  health row a step; every flash launch on the tensor-core route.
  Prints ``guard_overhead_frac`` a stage against the zero train phase's
  replays. A spec or a staged DCN exchange needs two ranks, which NCCL
  refuses on one card: their guard is checked on the CPU over gloo;

- guard (main path guard): the flagship cut to 2 layers (``FT_MODEL``)
  at 4 x 4096, AdamW with its rate
  a card tensor, through ``compiled_train_step`` and the eager
  ``DistributedOptimizer``, 1 + 4 steps each without the guard and
  under ``HOROVOD_GUARD=1`` in one run, host ms a step between
  synchronisations (median of 4) and ``guard_overhead_frac`` each, the
  health rows a step. Gates: the guarded parameters after 5 healthy
  steps bitwise equal to the unguarded ones (both paths); a NaN seeded
  through ``HOROVOD_GUARD_INJECT`` at call 5 skipped with every
  parameter and AdamW tensor bitwise unchanged and ``parameter_digest``
  the same bits across it; the next bad step backs the rate off in place
  and the following replay's update is AdamW's at the new rate
  (GUARD_LR_REL) and not the old one; three bad steps roll back to the
  State commit bitwise, into the same storage; the State commit's time
  is printed. The guarded calls run one program, whose
  backward starts from a device seed of 1.0, or NaN where the chaos spec
  fires: the program a user's ``HOROVOD_GUARD=1`` runs;
- elastic state (main path elastic_state): one rank under
  ``HOROVOD_ELASTIC=1`` trains the flagship cut to 2 layers
  (``FT_MODEL``) through the compiled step
  under ``hvd.elastic.run``, fed by ``DistributedDataset`` (seeded token
  samples through pinned memory), a ``State`` commit every 2 steps
  (times printed); a ``CheckpointManager`` saves the commit and
  restores it bitwise (times printed); on a small checkpoint of two
  steps a flipped byte fails the sidecar, ``latest_valid_step`` falls
  back and an explicit restore raises; the input wait share of the steps
  is printed, and so is any recovery's exception (the gate is that none
  happens);
- elastic ranks (main path elastic_ranks; parity, not a speed; the
  kill run beside the launcher phase, the term run alone): three
  processes on this card over a gloo group of their own, which
  ``hvd.init()`` adopts (``chip_smoke.py --elastic-rank R PORT OUT MODE
  DEVICE``), a narrow transformer (d_model 256, 2 layers,
  flash attention at D 64) under ``hvd.elastic.run``: rank 2 SIGKILLed
  before its step-2 exchange, then in a second run sent SIGTERM before
  step 1 (the preemption grace: exit 79, a grace file, a planned
  departure recovered faster than the settle window); the survivors
  re-rendezvous, ``init(comm=[0, 1])``, restore and finish with every
  sample exactly once and equal parameters; the recovery wall time of
  each run and the exception each survivor recovered from are printed.

Their figures are repeated in a ``{"fault_tolerance": ...}`` line before
the kernels line.

The autotuner and the launchers have four phases of their own, after
the eager engine phase (the launched ranks' beside the launcher phase,
Spark's beside the tp phase), and the control plane's rows after the
bench phase:

- spark (main path spark; parity, not a speed): ``spark.run`` with the
  local backend, two task processes on this card over a gloo group of
  their own (``chip_smoke.spark_rank``, imported by name), each
  training the narrow transformer 2 steps on one seeded batch; the
  results come back through the driver service. Gates: ranks in order,
  both ranks' parameters bitwise equal to each other and to the same
  steps run in this process at one rank, equal losses, every flash
  launch on the tensor-core route; the wall time of ``spark.run`` is
  printed;

- autotune (main path autotune): the flagship at 4 x 4096 as the eager
  engine phase trains it, under ``HOROVOD_AUTOTUNE=1`` (one warm-up
  sample, a window of 59 collectives: one step's at threshold 0), 12
  steps. Gates: one log row a sample, at least 4; every applied
  (fusion, cycle, padding, depth) in the reference's domain; every
  cycle's buckets what :func:`plan_fusion_plain` gives at the threshold
  in force, and a step the threshold held through what
  :func:`predict_buckets` gives for the hooks' order; the losses of the
  eager phase's 7 steps equal bitwise; the step programs' misses within
  the distinct plans (the engine captures none) and the wire layouts'
  within the distinct bucket signatures. Prints the step median before
  and after the first apply, each sample's score, the misses and the
  peak memory;
- launcher (main path launcher): ``python -m horovod_tpu_torch.run -np 1
  --max-restarts 1`` on ``chip_smoke.py --launched-worker MARKER OUT``:
  the first generation trains the flagship one step and exits 1, the
  gang restart's second trains 2 steps from seed 0 on the train phase's
  batch; exit 0, two generations, the losses the train phase's first
  two bitwise; the time from the launch to the first step and the
  restart time printed;
- launcher ranks (main path launcher_ranks; parity, not a speed): (a)
  ``-np 2`` with ``HOROVOD_LAUNCH_RPC=1`` (the driver and task
  services) and ``HOROVOD_AUTOTUNE=1`` on ``chip_smoke.py
  --launched-rank OUT``, the narrow transformer over gloo on this card:
  equal applied autotune lists at equal decision indices, equal
  parameters, each rank's output streamed with its prefix; (b) the churn
  soak's short mode (tests/torch_soak_churn.py) through
  ``launch_elastic(autoscale=True)``, beside the tp phase (its workers
  share the card): 2 -> 3 through the grace drain, one worker
  SIGTERMed, 3 -> 2 in the job, every sample exactly once, 2
  generations, exit 0; each recovery's wall time printed, taken beside
  the tp phase (not a speed figure);
- control plane: bench.resnet's ``control_plane`` row at worlds 8, 64
  and 256, fanout 32, the star and the tree at CONTROL_ROUNDS rounds a
  world (simrank on the host, in a process of its own, last, with
  nothing else running), and ``bench.eager --multihost 2`` on this
  card
  (``eager_multihost_cycle_ms``, bypass on and off, over gloo: a
  control-plane time).

Their figures are repeated in an ``{"autotune_launcher": ...}`` line
before the kernels line. The bench phase checks that bench.resnet's
``control_plane`` row is filled (its smoke curve).

The port's own examples (examples/torch_port/) have a phase of their
own, before the tp phase, whose subprocesses run beside it:

- examples (main path examples): first the six kernels against their
  plain versions at the long-context example's shapes (B 2, a shard of
  S 512, H 8 / H_kv 8, D 64, bf16, causal, window 1024; the band kernels
  at offsets 512 and 1024), each on the tensor-core route; then, as
  subprocesses on this card, ``transformer_long_context.py --attention
  ring-flash --sp 4 --window 1024`` at its default width (d_model 512, 8
  heads, 4 layers, seq 2048, vocab 32768, bf16, AdamW 3e-4) for 2 + 3
  steps (the window, two shards as SP_WINDOW is, sends the ring's
  visiting tiles through the band kernels: without one they are wholly
  visible and take the static kernel unmasked),
  beside the first of two invocations of
  ``pytorch_imagenet_resnet50.py`` (ResNet-50 at 224 x 224, 1000
  classes: 2 epochs of 2 steps, then a second invocation to 3 epochs
  that must print that it resumes from epoch 2). Each exits 0 with a
  finite, falling loss (the resumed run's first loss below the first
  run's); the long-context run's kernel launches, its own process's
  counts, are the path's: each kernel on the tensor-core route at D 64,
  none on the loop, static and band as many as its ring gives. Beside
  them ``mxnet_mnist.py --shim`` runs the MXNet binding over
  tests/mxnet_mock.py with the engine on this card (the machine has
  neither MXNet nor TensorFlow): it must exit 0, print ``DONE`` and end
  with a falling loss. The subprocesses run while the tp phase runs
  (parity, not a speed), as does the spark phase (the tp phase's ranks
  wait in a thread), and the phase prints its own seconds and theirs.

Phases whose figures are parity and exit codes, not speeds, run side by
side to keep the run inside its 1200 s: the launcher, launched ranks,
elastic ranks' kill run, eager 2-rank and pipeline phases together
(the pipeline's step times are not speeds), and the tp,
spark, examples, MoE parity, churn soak and parity phases together.
Nothing runs beside a timed phase.

Every flagship-sized phase starts from one seed-0 host draw of its
parameter layout (``seed0_params``: the bits of a fresh
``TransformerLM(generator=seed 0)``), and the run's child processes (the
TP ranks, the launcher's generations) load main()'s file of it.

The kernels phases also run the CUDA-core loop at head dims 256 and 320
(the latter in 256-column pieces) against the plain versions and time
it (off every main path).

On every main path each kernel launch takes the tensor-core route: the
loop's counters stay at 0 there, and the route's counters are exact (8
``flash_fwd`` a prefill, replayed or not; 8 of each static kernel a
data-parallel step, replayed or not, traced or not, or a TP step; 32
static and 40 band of each a ring SP step, replayed or not; 32 static a
Ulysses step; the pipeline's above). A graph's replay counts the
launches its capture recorded; a TP path's launches are one rank's.

Each main path runs with the kernel launch counts zeroed just before it
and read just after. The first line is the card's name and power limit
as ``nvidia-smi`` gives them; the run's wall time and a line of the
eager phases' figures (``{"eager_engine": ...}``), of the
fault-tolerance phases (``{"fault_tolerance": ...}``) and of the
autotune and launcher phases (``{"autotune_launcher": ...}``) are
printed before
the last two lines, which are
``{"kernels": [...]}``, one entry per kernel, and the result,
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO_DIR = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s of
# the bf16 tensor cores and of f32 outside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

FLAGSHIP = dict(vocab_size=32768, d_model=2048, n_heads=16, n_kv_heads=4,
                n_layers=8, d_ff=8192, max_seq=4096, positional="rope")
N_REQUESTS, PROMPT_LEN, NEW_TOKENS, PAGE_SIZE = 8, 512, 64, 16
# bench_transformer.py's training defaults: batch per chip, sequence,
# loss chunk, optax.adamw(3e-4) (weight decay 1e-4, betas, eps).
TRAIN_BATCH, TRAIN_SEQ, LOSS_CHUNK = 4, 4096, 512
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
WARMUP_STEPS, TIMED_STEPS = 1, 4
# Sequence parallelism: a local ring of 4 on one card, Mistral-7B's
# sliding window, 2 x 8192 tokens a step (the 16,384 of the step above).
SP_RING, SP_BATCH, SP_SEQ, SP_WINDOW = 4, 2, 8192, 4096
SP_SHARD = SP_SEQ // SP_RING
# The ring's steps, 1 + ceil((window - 1) / shard), and its band tiles a
# layer: at step t the shards t..3 hold a live visiting tile at offset
# t * shard (the rest wrap into the future and launch nothing).
SP_STEPS = min(SP_RING, 1 + -(-(SP_WINDOW - 1) // SP_SHARD))
SP_BAND_OFFSETS = [t * SP_SHARD for t in range(1, SP_STEPS)
                   for _ in range(t, SP_RING)]
SP_MODEL = dict(FLAGSHIP, max_seq=SP_SEQ, attention_window=SP_WINDOW)
# flagship-moe: the flagship with an MoE FFN in every other layer (as
# GShard and Switch place them, and tests/test_moe.py:201), 8 experts and
# top-2 routing (bench_transformer.py's --moe defaults, Mixtral's), the
# MoEConfig capacity factor 1.25; the expert stacks are the expert keys.
# The MoE phases cut its depth to 4 of the flagship's 8 layers (widths as
# they are) to keep the whole run inside its 1200 s limit: whole, the
# run's earlier phases took up to 943 s on an H100, and the autotune,
# launcher, soak and control-plane phases add about 250 s. chip_profile.py
# profiles it whole.
MOE_MODEL_FULL = dict(FLAGSHIP, moe_layers=(1, 3, 5, 7), moe_num_experts=8,
                      moe_top_k=2)
MOE_MODEL = dict(MOE_MODEL_FULL, n_layers=4, moe_layers=(1, 3))
# The guard and elastic state phases cut the flagship's depth to 2 of
# its 8 layers (widths as they are): what they check is the mechanism
# (skips, back-off, rollback, commits, checkpoints), at any depth, and
# at the flagship's depth their steps and 5.8 GB checkpoint took about
# 80 s of the run on an H100. The zero guard phase keeps the whole flagship (its
# stripes are held to the zero train phase's).
FT_MODEL = dict(FLAGSHIP, n_layers=2)
MOE_EXPERT_KEYS = ("moe.w1", "moe.w2")

# Kernel vs plain version: f32 outputs differ by summation order only;
# a bf16 output by at most one rounding of a value below 4 (2^-6); lse
# is f32 on both sides. The forward's tensor-core route rounds p to bf16
# before p.v, and is held at these bands to the plain version that
# rounds it likewise (``operand_dtype=torch.bfloat16``), and to the f32
# plain version within ``fwd_bf16_rounding_bound`` B (p moved by at most
# 2^-8 of itself: 2^-8 of sum p|v| / l), element by element, plus the
# output's own rounding: half a bf16 ulp, at most OUT_ROUNDING of the
# unrounded value, which lies within B of the exact one.
F32_ATOL, BF16_ATOL, LSE_ATOL = 2e-5, 2e-2, 1e-4
OUT_ROUNDING = 2.0 ** -8
# Flash vs dense prefill logits at full width (bf16 activations): the
# two attention paths round differently (dense casts the normalised p to
# bf16 before p.v; flash rounds p against its running max, and divides
# by the l it summed in f32), and 8 layers carry that into logits of
# magnitude up to ~5 (0.0375 observed on an H100).
LOGITS_ATOL = 0.15
# A small f32 model: serve prefill + decode against its own forward.
SMALL_ATOL = 1e-4
# Backward kernels vs plain versions: f32 gradients are sums over a
# whole row or column of the score matrix, in another order (1e-4, the
# reference's gradient band); a bf16 gradient may differ by one bf16
# rounding (2^-7 relative) of its largest magnitude.
GRAD_F32_ATOL, GRAD_BF16_REL = 1e-4, 2.0 ** -7
# The tensor-core route rounds P and dS to bf16 before the second
# products, and is held to the plain version that rounds them likewise
# (``operand_dtype=torch.bfloat16``): the static kernels at
# GRAD_BF16_REL, and the band kernels' f32 gradients, which the loop
# held to GRAD_F32_ATOL, at BAND_BF16_REL of their largest magnitude: a
# P or dS value whose f32 sum came in another order can round to the
# neighbouring bf16 value, moving its terms by one bf16 ulp (2^-7).
# Against the f32 plain version each route's gradient holds within
# ``bf16_rounding_bound`` (P and dS each moved by at most 2^-8 of
# itself: 2^-8 of the same sums over absolute values) plus the band
# above: GRAD_BF16_REL of the largest magnitude for a bf16 gradient,
# GRAD_F32_ATOL for an f32 one.
BAND_BF16_REL = 2.0 ** -7
# Training parity, flash vs dense: the loss, and each parameter gradient
# by relative L2 difference; a small f32 model to the reference's 1e-4.
# Dense rounds the normalised p to bf16 before p.v, and the transpose of
# that cast rounds dP to bf16 before dS = P * (dP - delta), which
# cancels. The kernels round p against the running max in the forward
# and P and dS in the backward, each at another place than dense; dP
# stays f32. That puts single leaves at 0.02 (0.02118 at layers.7.wq on
# an H100), so the band is 3e-2. The f32 dense model is the yardstick of
# both bf16 paths: flash may be no farther from it than YARDSTICK_RATIO
# times the dense path is (worst leaf against worst leaf; 0.02272
# against 0.01912, a ratio of 1.188, on an H100).
TRAIN_LOSS_ATOL, TRAIN_GRAD_REL, SMALL_GRAD_ATOL = 1e-2, 3e-2, 1e-4
YARDSTICK_RATIO = 1.5
# The MoE layer's index form against its dense plain version, f32, on
# the card: the same routing (tables equal the dense tensors exactly),
# the same expert rows, aux and counts; the dense combine's GEMM sums
# each token's two gate-weighted rows (and zeros) with fused multiply-
# adds in its own order, so an output may differ by a few f32 roundings
# of the largest magnitude: MOE_LAYER_REL of it.
MOE_LAYER_REL = 2.0 ** -20
# flagship-moe cut to 2 layers (layer 1 MoE) on the card against the CPU
# at B 1 x MOE_PARITY_SEQ: layer 1's router probabilities within
# MOE_PROB_ATOL, and the logits within LOGITS_ATOL at every position
# where both sides pick the same experts, which must be all but
# MOE_FLIPS of them. Routing is discrete: where two experts' router
# probabilities lie closer than the two sides' difference, each side may
# pick another (both answers right), and that position's output differs
# by a whole expert's. The sides differ in f32 summation order, which
# flips a bf16 rounding now and then; a flipped rounding of a dominant
# softmax weight moves a whole head's output, so the router's input of
# that position moves on most of its elements. Both sides run dense
# attention (the same torch ops; the flash route rounds every P to bf16
# where the CPU's plain version does not) and the MoE layer at full
# capacity (nothing drops, so a position depends on its own routing only;
# in capacity mode a token's queue position, and so what drops, depends
# on every earlier token's routing). The flash route and the capacity
# mode are held by the kernel and layer checks above and by the CPU
# tests.
MOE_PARITY_SEQ, MOE_PROB_ATOL, MOE_FLIPS = 256, 2e-2, 256 // 50


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _demangle(names):
    """{mangled: readable} through c++filt where the machine has it."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return dict(zip(names, out.splitlines()))


def sass_hgmma(_build, source):
    """{mangled kernel: HGMMA (wgmma) instructions} in ``source``'s SASS
    (cuobjdump -sass), or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return {part.split()[0]: part.count("HGMMA")
            for part in sass.split("Function : ")[1:]}


def kernel_usage(fa, source, log, hgmma):
    """Print each kernel of ``source``'s registers, spills and shared
    memory from nvcc's -Xptxas -v ``log``, and the HGMMA (wgmma)
    instructions in its SASS (``hgmma``, :func:`sass_hgmma`'s). A
    tensor-core kernel without HGMMA fails the run."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[name].update(stack=int(m[1]), spill_stores=int(m[2]),
                               spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m[1])
            smem = re.search(r"(\d+) bytes smem", line)
            usage[name]["static_smem"] = int(smem[1]) if smem else 0
    readable = _demangle(sorted(usage))
    for mangled in sorted(usage, key=lambda n: readable[n]):
        u, text = usage[mangled], readable[mangled]
        wgmma = "wgmma_kernel" in text
        d = 128 if re.search(r"[<, ]128>|Li128E", text) else 64
        kind = "flash_fwd" if "flash_fwd" in text else (
            "flash_bwd_dkv" if "dkv" in text else "flash_bwd_dq")
        dyn = fa.wgmma_smem_bytes(kind, d) if wgmma else None
        n = None if hgmma is None else hgmma.get(mangled, 0)
        short = re.search(r"flash_\w+(<[^>]*>)?", text)
        print(f"build {source} kernel {short[0] if short else text}: "
              f"{u.get('registers')} registers, {u.get('spill_stores')} "
              f"bytes spill stores, {u.get('spill_loads')} bytes spill "
              f"loads, {u.get('stack')} bytes stack, static smem "
              f"{u.get('static_smem')} bytes"
              + (f", dynamic smem {dyn} bytes" if wgmma else "")
              + ("; SASS not read (no cuobjdump)" if n is None
                 else f"; {n} HGMMA in its SASS"), flush=True)
        check(not wgmma or n is None or n > 0,
              f"{text}: a tensor-core kernel without HGMMA")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _averaged_device_us(prof):
    """torch.profiler's device time: the self time of its CUDA rows."""
    from torch.autograd import DeviceType
    return sum(getattr(r, "self_device_time_total", 0)
               for r in prof.key_averages() if r.device_type == DeviceType.CUDA)


def _raw_device_us(prof):
    """The same sum as :func:`_averaged_device_us`, read from the raw
    kineto events (the events ``key_averages()`` keeps: CUDA, not
    filtered, hidden or async), without building ``key_averages()``'s
    tree of every CPU op, which took 64 s of an H100 run for the serving
    rounds' ~10^5 events."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name
    total = 0
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or _filter_name(e.name())
                or getattr(e, "is_hidden_event", lambda: False)()
                or e.is_async() or e.start_thread_id() != e.end_thread_id()):
            continue
        total += e.end_ns() - e.start_ns()
    return total / 1e3


_raw_sum_checked = False


def device_ms(fn, iters, warm=True):
    """Device time of one call of ``fn``: the self time of the CUDA
    kernels it launches, summed by torch.profiler over ``iters`` calls
    (:func:`_raw_device_us`, held to ``key_averages()``'s sum on the
    run's first call). Where the host's enqueueing is slower than the
    kernels (a wrapper call at a small shape), ``time_ms`` measures the
    host instead. ``warm``: one untimed call first (a caller whose
    ``fn`` has just run passes False)."""
    global _raw_sum_checked
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = _raw_device_us(prof)
    if not _raw_sum_checked:
        averaged = _averaged_device_us(prof)
        check(abs(us - averaged) <= 1e-6 * averaged + 1e-3,
              f"raw kineto device time {us} us != key_averages' "
              f"{averaged} us")
        _raw_sum_checked = True
    return us / iters / 1e3


def attention_work(b, s, h, h_kv, d, dtype, causal, window):
    """(bytes, flops) one attention forward must move and do on these
    shapes: q, k, v read once, out and the f32 lse written once; 4*D
    FLOPs per (query, key) pair the mask keeps."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * s * h * d + 2 * b * s * h_kv * d) * itemsize \
        + 4 * b * h * s
    if not causal:
        pairs = s * s
    else:
        w = s if window is None else min(window, s)
        pairs = w * (w + 1) // 2 + (s - w) * w
    return nbytes, 4 * d * pairs * b * h


def hold_forward(fa, name, out, lse, args, extra, bound_args, rows=None):
    """Hold one forward kernel's (out, lse) on ``rows`` (None: all) to the
    plain version of the route it took, and on the tensor-core route also
    to the f32 plain version, at the bands of the header. ``extra``
    follows q, k, v in the plain version's call, ``bound_args`` in
    ``fwd_bf16_rounding_bound``'s. Returns (error against the route's
    plain version, against the f32 one (0 on the loop), route, report)."""
    tc = fa.tensor_core_route(*args)
    ref = getattr(fa, name + "_reference")
    rows = slice(None) if rows is None else rows
    want, want_lse = ref(*args, *extra,
                         operand_dtype=torch.bfloat16 if tc else None)
    tol = BF16_ATOL if args[0].dtype == torch.bfloat16 else F32_ATOL
    err = (out[:, rows].float() - want[:, rows].float()).abs().max().item()
    err_lse = (lse[:, :, rows] - want_lse[:, :, rows]).abs().max().item()
    text = (f"out max|d|={err:.3g} (tol {tol:g}), lse {err_lse:.3g} (tol "
            f"{LSE_ATOL:g})")
    check(err <= tol and err_lse <= LSE_ATOL,
          f"{name} disagrees with its plain version")
    err32 = 0.0
    if tc:
        exact = ref(*args, *extra)[0][:, rows].float()
        bound = fa.fwd_bf16_rounding_bound(*args, *bound_args)
        diff = (out[:, rows].float() - exact).abs()
        err32 = diff.max().item()
        text += (f"; f32 plain {err32:.3g} (tol {bound:.3g} + 2^-8 |out| "
                 f"an element)")
        check(bool((diff <= (1 + OUT_ROUNDING) * bound
                    + OUT_ROUNDING * exact.abs()).all()),
              f"{name} is farther from the f32 plain version than the "
              f"bf16 rounding of p allows")
    return err, err32, tc, text


def phase_kernels(fa, card, gen):
    """Kernel vs plain version at every listed shape (the training shape
    at B 1, for the plain version's memory); timings at the prefill
    shape. Returns the kernel's entry for the kernels line."""
    cases = [  # (B, S, H, H_kv, D, dtype, causal, window)
        (8, PROMPT_LEN, 16, 4, 128, torch.bfloat16, True, None),  # prefill
        (1, TRAIN_SEQ, 16, 4, 128, torch.bfloat16, True, None),  # training
        (8, PROMPT_LEN, 8, 2, 128, torch.bfloat16, True, None),  # TP prefill
        (1, TRAIN_SEQ, 8, 2, 128, torch.bfloat16, True, None),   # TP training
        (SP_BATCH, SP_SHARD, 16, 4, 128, torch.bfloat16, True,
         SP_WINDOW),                                    # SP diagonal tile
        (2, 1000, 16, 4, 128, torch.bfloat16, True, None),        # ragged
        (2, 1000, 16, 4, 128, torch.bfloat16, True, 256),         # window
        (2, 700, 8, 8, 64, torch.bfloat16, False, None),          # non-causal
        (2, 130, 4, 2, 8, torch.float32, True, None),             # small f32
        (2, 300, 4, 2, 256, torch.bfloat16, True, None),          # D 256
        (1, 200, 4, 1, 256, torch.float32, True, 50),     # D 256, window
        (2, 300, 4, 2, 320, torch.bfloat16, True, None),  # D 320, pieces
        (1, 200, 4, 1, 320, torch.float32, True, 50),     # D 320, window
    ]
    worst = worst32 = 0.0
    entry = None
    for b, s, h, h_kv, d, dtype, causal, window in cases:
        q = torch.randn(b, s, h, d, generator=gen, device=card).to(dtype)
        k = torch.randn(b, s, h_kv, d, generator=gen, device=card).to(dtype)
        v = torch.randn(b, s, h_kv, d, generator=gen, device=card).to(dtype)
        before = read_launches(fa)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal, window)
        torch.cuda.synchronize()
        err, err32, tc, text = hold_forward(
            fa, "flash_attention", out, lse, (q, k, v), (causal, window),
            (causal, window))
        check(tc == (dtype == torch.bfloat16 and d in (64, 128)),
              f"flash_fwd took the wrong route at {(b, s, h, d, dtype)}")
        route = "flash_fwd_wgmma" if tc else "flash_fwd"
        check(read_launches(fa)[route] == before[route] + 1,
              f"flash_fwd was not counted on its route at {(b, s, h, d)}")
        print(f"kernel flash_fwd B={b} S={s} H={h} H_kv={h_kv} D={d} "
              f"{str(dtype)[6:]} causal={causal} window={window} "
              f"[{'tensor cores' if tc else 'loop'}]: {text}", flush=True)
        worst, worst32 = max(worst, err), max(worst32, err32)
        if entry is not None:
            continue
        # The prefill shape: the one the main path gives the kernel.
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal, window),
                     50)
        plain_ms = time_ms(
            lambda: fa.flash_attention_reference(
                q, k, v, causal, window, operand_dtype=torch.bfloat16), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        library_ms = time_ms(sdpa, 50)
        # the wrapper call at this shape is host-bound: the kernels'
        # device times too
        dev_ms = device_ms(
            lambda: fa.flash_attention(q, k, v, causal, window), 50)
        library_dev_ms = device_ms(sdpa, 50)
        nbytes, flops = attention_work(b, s, h, h_kv, d, dtype, causal,
                                       window)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        entry = {
            "name": "flash_fwd", "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "horovod_tpu/ops/flash_attention.py:72",
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": library_ms,
            "device_ms": dev_ms, "library_device_ms": library_dev_ms,
        }
        print(f"kernel flash_fwd timing at the prefill shape: {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
              f"{flops / ms / 1e9:.1f} TFLOP/s); device time (profiler) "
              f"{dev_ms:.4f} ms, SDPA {library_dev_ms:.4f} ms", flush=True)
    entry["max_abs_err"] = worst
    entry["max_abs_err_f32_plain"] = worst32
    return entry


def prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, PROMPT_LEN).tolist()
            for _ in range(N_REQUESTS)]


def phase_parity(tfm, ServeEngine, params, card):
    """Full-width prefill logits through flash vs dense attention, and
    a small f32 model's serve path against its own forward."""
    ids = list(range(N_REQUESTS))
    logits = {}
    for impl in ("flash", "dense"):
        cfg = tfm.TransformerConfig(dtype=torch.bfloat16,
                                    attention_impl=impl, **FLAGSHIP)
        eng = ServeEngine(params, cfg, page_size=PAGE_SIZE, device=card)
        for sid in ids:
            eng.cache.allocate(sid, PROMPT_LEN + NEW_TOKENS)
        logits[impl] = eng.prefill(ids, prompts(cfg.vocab_size))
        del eng
    flash, dense = logits["flash"], logits["dense"]
    check(flash.shape == (N_REQUESTS, FLAGSHIP["vocab_size"])
          and np.isfinite(flash).all(), "prefill logits shape or finiteness")
    diff = float(np.abs(flash - dense).max())
    agree = float((flash.argmax(-1) == dense.argmax(-1)).mean())
    print(f"parity prefill logits flash vs dense (8 x 512, full width): "
          f"max|d|={diff:.4g} (tol {LOGITS_ATOL:g}), max|logit|="
          f"{float(np.abs(dense).max()):.3g}, argmax agreement {agree:.3f}",
          flush=True)
    check(diff <= LOGITS_ATOL, "flash and dense prefill logits disagree")

    small = tfm.TransformerConfig(
        vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=256, max_seq=64, dtype=torch.float32, positional="rope",
        attention_impl="flash")
    sp = tfm.init_params(small, torch.Generator().manual_seed(1), card)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 24))
    ref = tfm.forward(sp, torch.from_numpy(tokens).to(card), small)
    eng = ServeEngine(sp, small, num_pages=16, page_size=8, device=card)
    for sid in (0, 1):
        eng.cache.allocate(sid, 24)
    rows = [eng.prefill([0, 1], [tokens[0, :16].tolist(),
                                 tokens[1, :16].tolist()])]
    for i in range(16, 24):
        rows.append(eng.decode([0, 1], tokens[:, i], [i, i]))
    want = ref.cpu().numpy()[:, 15:24].transpose(1, 0, 2)
    small_diff = float(np.abs(np.stack(rows) - want).max())
    print(f"parity small f32 model, serve prefill+decode vs forward: "
          f"max|d|={small_diff:.3g} (tol {SMALL_ATOL:g})", flush=True)
    check(small_diff <= SMALL_ATOL, "serve path disagrees with forward")


@contextlib.contextmanager
def step_program(value):
    """HOROVOD_STEP_PROGRAM set to ``value`` ("0": programs run eagerly,
    "1": captured as CUDA graphs) while the block builds programs."""
    old = os.environ.get("HOROVOD_STEP_PROGRAM")
    os.environ["HOROVOD_STEP_PROGRAM"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("HOROVOD_STEP_PROGRAM")
        else:
            os.environ["HOROVOD_STEP_PROGRAM"] = old


def phase_serve(fa, serve, metrics, lm, card, where):
    """The main path: serve.Engine, 8 requests, counts zeroed around;
    every program eager (HOROVOD_STEP_PROGRAM=0), as before the graphs."""
    with step_program("0"):
        return _phase_serve(fa, serve, metrics, lm, card, where)


def _phase_serve(fa, serve, metrics, lm, card, where):
    engine = serve.Engine(lm, lm.params, page_size=PAGE_SIZE,
                          max_batch=N_REQUESTS, device=card)
    try:
        warm = engine.submit(prompts(lm.cfg.vocab_size)[0], 4)
        check(len(warm.result()) == 4, "warm-up request")
        engine.batcher.recent_ttft.clear()
        engine.batcher.recent_token_latency.clear()
        prefill_hist = metrics.SERVE_STEP_SECONDS.labels(phase="prefill")
        decode_hist = metrics.SERVE_STEP_SECONDS.labels(phase="decode")
        p0, d0 = prefill_hist.value(), decode_hist.value()

        zero_launches(fa)
        t0 = time.perf_counter()
        handles = [engine.submit(p, NEW_TOKENS)
                   for p in prompts(lm.cfg.vocab_size)]
        outs = [h.result() for h in handles]
        wall = time.perf_counter() - t0
        routes = read_launches(fa)
        launches = routes["flash_fwd_wgmma"]
    finally:
        engine.close()

    prefill_calls = prefill_hist.value()["count"] - p0["count"]
    decode_calls = decode_hist.value()["count"] - d0["count"]
    check(all(len(o) == NEW_TOKENS for o in outs),
          f"streams yielded {[len(o) for o in outs]} tokens")
    check(all(0 <= t < lm.cfg.vocab_size for o in outs for t in o),
          "token ids out of range")
    check(prefill_calls >= 1 and launches == lm.cfg.n_layers * prefill_calls,
          f"flash_fwd launched {launches} times on the tensor cores over "
          f"{prefill_calls} prefill calls of {lm.cfg.n_layers} layers")
    check(sum(routes.values()) == launches,
          f"serving launched other kernels or routes: {routes}")
    ttft = np.asarray(engine.batcher.recent_ttft) * 1e3
    tok = np.asarray(engine.batcher.recent_token_latency) * 1e3
    generated = sum(len(o) for o in outs)
    prefill_ms = (prefill_hist.value()["sum"] - p0["sum"]) / prefill_calls \
        * 1e3
    decode_ms = (decode_hist.value()["sum"] - d0["sum"]) / decode_calls * 1e3
    print(f"serve {N_REQUESTS} x ({PROMPT_LEN} + {NEW_TOKENS}) tokens "
          f"[{where}]: ttft p50 {np.percentile(ttft, 50):.2f} ms p99 "
          f"{np.percentile(ttft, 99):.2f} ms; token latency p50 "
          f"{np.percentile(tok, 50):.2f} ms p99 {np.percentile(tok, 99):.2f}"
          f" ms; {generated / wall:.1f} tokens/s", flush=True)
    print(f"serve steps [{where}]: {prefill_calls} prefill calls, mean "
          f"{prefill_ms:.2f} ms; {decode_calls} decode steps, mean "
          f"{decode_ms:.2f} ms; flash_fwd launches {launches} (tensor "
          f"cores)", flush=True)
    return routes


def serve_round(engine, metrics, vocab):
    """One round of the serving workload driven on this thread: the 8
    requests submitted, then the batcher drained. Returns the streams,
    the wall time and the round's TTFT, token latencies and mean prefill
    and decode step times (ms)."""
    b = engine.batcher
    b.recent_ttft.clear()
    b.recent_token_latency.clear()
    hists = {ph: metrics.SERVE_STEP_SECONDS.labels(phase=ph)
             for ph in ("prefill", "decode")}
    h0 = {ph: h.value() for ph, h in hists.items()}
    t0 = time.perf_counter()
    handles = [engine.submit(p, NEW_TOKENS) for p in prompts(vocab)]
    b.drain()
    wall = time.perf_counter() - t0
    out = {"outs": [list(h.request.generated) for h in handles],
           "wall_ms": wall * 1e3,
           "ttft": np.asarray(b.recent_ttft) * 1e3,
           "tok": np.asarray(b.recent_token_latency) * 1e3}
    for ph, h in hists.items():
        v = h.value()
        calls = v["count"] - h0[ph]["count"]
        out[f"{ph}_calls"] = calls
        out[f"{ph}_ms"] = (v["sum"] - h0[ph]["sum"]) / max(calls, 1) * 1e3
    return out


def serve_both_engines(fa, serve, metrics, lm, card, where, label):
    """The serving workload through ``serve.Engine`` eagerly and through
    its graphs, each engine serving the 8 requests three times from this
    thread: a round that builds its programs (the graphs' warm-up and
    capture), a timed round (launch counts zeroed just before it and
    read just after), and a round under torch.profiler for the device
    time, whose ratio to the timed round's wall is the card's busy
    share. The graph engine's tokens must equal the eager one's, its
    timed round must hit its program cache on >= 0.9 of the decode
    steps with no fallback, and each prefill launches flash_fwd once a
    layer on the tensor cores. Prints each engine's prefill, decode
    step, token latency p50/p99, TTFT, tokens/s and busy share. Returns
    {mode: round}."""
    vocab = lm.cfg.vocab_size
    res = {}
    for mode, value in (("eager", "0"), ("graphs", "1")):
        with step_program(value):
            engine = serve.Engine(lm, lm.params, page_size=PAGE_SIZE,
                                  max_batch=N_REQUESTS, start=False,
                                  device=card)
            se = engine.engine
            built = serve_round(engine, metrics, vocab)
            c0 = (se.decode_hits, se.decode_misses)
            zero_launches(fa)
            timed = serve_round(engine, metrics, vocab)
            timed["launches"] = read_launches(fa)
            hits, misses = (se.decode_hits - c0[0], se.decode_misses - c0[1])
            timed["steady_hit_rate"] = hits / max(hits + misses, 1)
            # the built and the timed rounds have warmed it
            timed["device_ms"] = device_ms(
                lambda: serve_round(engine, metrics, vocab), 1, warm=False)
            timed["busy"] = timed["device_ms"] / timed["wall_ms"]
            timed["built_outs"] = built["outs"]
            timed["captured"] = [p.captured
                                 for p in se._local_progs.values()]
            timed["fallback_steps"] = se.fallback_steps
            res[mode] = timed
            engine.close()
            del engine, se
            gc.collect()
            torch.cuda.empty_cache()
    eager, graphs = res["eager"], res["graphs"]
    check(graphs["captured"] and all(graphs["captured"])
          and not any(eager["captured"]),
          f"graph capture by engine: graphs {graphs['captured']}, eager "
          f"{eager['captured']}")
    check(graphs["outs"] == eager["outs"] == graphs["built_outs"]
          == eager["built_outs"],
          "graph-served tokens differ from the eager engine's")
    check(graphs["steady_hit_rate"] >= 0.9 and graphs["fallback_steps"] == 0,
          f"decode hit rate {graphs['steady_hit_rate']}, fallbacks "
          f"{graphs['fallback_steps']}")
    launches = graphs["launches"]
    check(graphs["prefill_calls"] >= 1 and launches["flash_fwd_wgmma"]
          == lm.cfg.n_layers * graphs["prefill_calls"]
          and sum(launches.values()) == launches["flash_fwd_wgmma"],
          f"graph serving launches {launches} over "
          f"{graphs['prefill_calls']} prefill replays")
    for mode, r in res.items():
        print(f"{label} [{mode}] {N_REQUESTS} x ({PROMPT_LEN} + "
              f"{NEW_TOKENS}) [{where}]: prefill {r['prefill_ms']:.2f} ms "
              f"({r['prefill_calls']} call); decode step "
              f"{r['decode_ms']:.2f} ms (mean of {r['decode_calls']}); "
              f"token latency p50 {np.percentile(r['tok'], 50):.2f} ms p99 "
              f"{np.percentile(r['tok'], 99):.2f} ms; ttft p50 "
              f"{np.percentile(r['ttft'], 50):.2f} ms; "
              f"{N_REQUESTS * NEW_TOKENS / r['wall_ms'] * 1e3:.1f} tokens/s; "
              f"device {r['device_ms']:.2f} ms of a {r['wall_ms']:.2f} ms "
              f"round, busy {r['busy']:.3f}", flush=True)
    print(f"{label}: tokens identical to eager; steady decode hit "
          f"rate {graphs['steady_hit_rate']:.3f}; decode step "
          f"{eager['decode_ms']:.2f} -> {graphs['decode_ms']:.2f} ms",
          flush=True)
    return res


def phase_compiled_serve(fa, serve, metrics, tfm, lm, card, where):
    """Main path 5: the serving workload through graph-replayed prefill
    and decode, beside the same engine run eagerly in this call
    (:func:`serve_both_engines`). Then ``generate``
    on the flagship: its graph-replayed greedy tokens against the eager
    ``decode_step``'s argmax, whose logits must lie within LOGITS_ATOL of
    a full forward over the same prefix. Returns {kernel: launches} of
    the graph engine's timed round and of ``generate``."""
    res = serve_both_engines(fa, serve, metrics, lm, card, where,
                             "compiled serve")
    graphs = res["graphs"]
    launches = graphs["launches"]
    vocab = lm.cfg.vocab_size

    # generate on the flagship: graph-replayed decode against eager
    # decode_step and a full forward over the same prefix
    cfg, params = lm.cfg, lm.params
    gen_prompt, gen_new = 64, 16
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, vocab, (2, gen_prompt))).to(card)
    zero_launches(fa)
    with step_program("1"):
        out = tfm.generate(params, prompt, cfg, gen_new)
    gen_launches = read_launches(fa)
    total = gen_prompt + gen_new
    with torch.inference_mode():
        cache = tfm.init_cache(cfg, 2, total, device=card)
        logits, cache = tfm.prefill_cache(params, cache, out[:, :gen_prompt],
                                          cfg)
        rows = [logits]
        for i in range(gen_prompt, total - 1):
            logits, cache = tfm.decode_step(params, cache, out[:, i], cfg)
            rows.append(logits)
        rows = torch.stack(rows, dim=1)
        ref = tfm.forward(params, out[:, :total - 1], cfg)[:, gen_prompt - 1:]
    diff = float((rows - ref).abs().max())
    greedy = torch.equal(rows.argmax(-1), out[:, gen_prompt:])
    print(f"generate 2 x ({gen_prompt} + {gen_new}) on the flagship: "
          f"decode_step logits vs forward max|d|={diff:.4g} (tol "
          f"{LOGITS_ATOL:g}); graph tokens equal eager decode_step's argmax "
          f"{greedy}; launches {gen_launches}", flush=True)
    check(diff <= LOGITS_ATOL, "decode_step logits disagree with forward")
    check(greedy, "generate's graph tokens differ from eager decode_step's")
    check(gen_launches["flash_fwd_wgmma"] == cfg.n_layers
          and sum(gen_launches.values()) == cfg.n_layers,
          f"generate launches {gen_launches}: one prefill expected")
    return {k: launches[k] + gen_launches[k] for k in launches}


def causal_pairs(s, causal, window, off=0):
    """(query, key) pairs the mask keeps in one (b, h) row of a tile whose
    query row i sits at position off + i (0 <= off + i - j < window)."""
    if not causal:
        return s * s
    from horovod_tpu_torch.ops.flash_attention import band_key_span
    lo, hi = band_key_span(s, off, window)
    return int((hi - lo + 1).clamp(min=0).sum())


def bound(nbytes, flops, dtype):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def backward_work(b, s, h, h_kv, d, dtype, causal, window):
    """{kernel: (bytes, flops)} of the two backward kernels on these
    shapes. dq reads q, dO, k, v, lse and delta and writes dq, 6*D FLOPs
    per live pair (s, dp, dS.K); dkv reads the same and writes dk and
    dv, 8*D FLOPs per live pair (s, dp, P^T.dO, dS^T.Q)."""
    item = torch.tensor([], dtype=dtype).element_size()
    q_side = b * s * h * d * item
    kv_side = b * s * h_kv * d * item
    vectors = 2 * 4 * b * h * s
    pairs = causal_pairs(s, causal, window) * b * h
    return {
        "flash_bwd_dq": (3 * q_side + 2 * kv_side + vectors, 6 * d * pairs),
        "flash_bwd_dkv": (2 * q_side + 4 * kv_side + vectors, 8 * d * pairs),
    }


def bwd_inputs(fa, card, gen, b, s, h, h_kv, d, dtype, causal, window,
               shard=None, unit_batch_stride=False):
    """q, k, v, dO in ``dtype`` and the forward's lse and delta. With
    ``shard`` i, lse and delta are the strided views of shard i of a
    (B, H, SP_RING * S) pair, as a chunk of the ring's lse is. With
    ``unit_batch_stride`` (B 1), dO's batch stride is 1, as autograd
    hands it to the tensor-parallel step's backward."""
    q = torch.randn(b, s, h, d, generator=gen, device=card).to(dtype)
    k = torch.randn(b, s, h_kv, d, generator=gen, device=card).to(dtype)
    v = torch.randn(b, s, h_kv, d, generator=gen, device=card).to(dtype)
    do = torch.randn(b, s, h, d, generator=gen, device=card).to(dtype)
    if unit_batch_stride:
        check(b == 1, "a batch stride of 1 needs B 1")
        do = do.as_strided(do.shape, (1,) + do.stride()[1:])
    out, lse = fa.flash_attention_with_lse(q, k, v, causal, window)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if shard is not None:
        lse, delta = ring_view(lse, shard, gen), ring_view(delta, shard, gen)
    return q, k, v, do, lse, delta


def ring_view(x, shard, gen):
    """``x`` (B, H, S) as shard ``shard`` of a (B, H, SP_RING * S) tensor
    of random rows: the strided view that ``lse.chunk(SP_RING, dim=2)``
    gives ring attention's backward."""
    b, h, s = x.shape
    wide = torch.randn(b, h, SP_RING * s, generator=gen, device=x.device)
    wide[..., shard * s:(shard + 1) * s] = x
    view = wide.chunk(SP_RING, dim=2)[shard]
    check(not view.is_contiguous(), "a ring view is contiguous")
    return view


def _tuple(x):
    return (x,) if torch.is_tensor(x) else tuple(x)


def hold_backward(fa, name, got, args, extra, bound_args):
    """Hold one backward kernel's gradients ``got`` to the plain version
    of the route it took, and on the tensor-core route also to the f32
    plain version, at the bands of the header. ``extra`` follows the
    operands in the plain version's call, ``bound_args`` in
    ``bf16_rounding_bound``'s. Returns (worst error against the route's
    plain version, worst against the f32 one, route, report)."""
    tc = fa.tensor_core_route(*args[:4])
    ref = getattr(fa, name + "_reference")
    want = _tuple(ref(*args, *extra,
                      operand_dtype=torch.bfloat16 if tc else None))
    exact = _tuple(ref(*args, *extra)) if tc else want
    bound = fa.bf16_rounding_bound(*args, *bound_args) if tc else None
    outs = ("dq",) if name.endswith("dq") else ("dk", "dv")
    worst, worst32, text = 0.0, 0.0, []
    for out, g, w, x in zip(outs, got, want, exact):
        f32_out = g.dtype == torch.float32
        top = w.float().abs().max().item()
        if tc:
            tol = (BAND_BF16_REL if f32_out else GRAD_BF16_REL) * top
        else:
            tol = GRAD_F32_ATOL if f32_out else GRAD_BF16_REL * top
        err = (g.float() - w.float()).abs().max().item()
        text.append(f"{out} max|d|={err:.3g} (tol {tol:.3g})")
        check(err <= tol, f"{name} disagrees with its plain version")
        worst = max(worst, err)
        if tc:
            tol32 = bound["dq dk dv".split().index(out)] + (
                GRAD_F32_ATOL if f32_out else
                GRAD_BF16_REL * x.float().abs().max().item())
            err32 = (g.float() - x.float()).abs().max().item()
            text[-1] += f", f32 plain {err32:.3g} (tol {tol32:.3g})"
            check(err32 <= tol32,
                  f"{name} is farther from the f32 plain version than "
                  f"the bf16 rounding of P and dS allows")
            worst32 = max(worst32, err32)
    return worst, worst32, tc, "; ".join(text)


# The TP training shape of the backward kernels: a rank's H 8 / H_kv 2
# at B 1, whose dO autograd hands over with a batch stride of 1.
TP_TRAIN_BWD = (1, TRAIN_SEQ, 8, 2, 128, torch.bfloat16, True, None)


def phase_backward_kernels(fa, card, gen):
    """flash_bwd_dq and flash_bwd_dkv against their plain versions at
    every listed shape; the kernels and SDPA's backward timed at the
    training shape, the plain versions at B 1. Returns the two entries
    of the kernels line (launches filled in by the main paths)."""
    cases = [  # (B, S, H, H_kv, D, dtype, causal, window)
        (1, TRAIN_SEQ, 16, 4, 128, torch.bfloat16, True, None),  # training
        (8, PROMPT_LEN, 8, 2, 128, torch.bfloat16, True, None),  # TP prefill
        TP_TRAIN_BWD,                      # TP training, dO batch stride 1
        # the SP path's diagonal tile, lse and delta strided as the ring's
        (SP_BATCH, SP_SHARD, 16, 4, 128, torch.bfloat16, True, SP_WINDOW),
        (1, 1000, 16, 4, 128, torch.bfloat16, True, None),       # ragged
        (1, 1000, 16, 4, 128, torch.bfloat16, True, 256),        # window
        (1, 700, 8, 8, 64, torch.bfloat16, False, None),         # non-causal
        (2, 130, 4, 2, 8, torch.float32, True, None),            # small f32
        (2, 300, 4, 2, 256, torch.bfloat16, True, None),         # D 256
        (1, 200, 4, 1, 256, torch.float32, True, 50),    # D 256, window
        (2, 300, 4, 2, 320, torch.bfloat16, True, None),  # D 320, pieces
        (1, 200, 4, 1, 320, torch.float32, True, 50),    # D 320, window
    ]
    names = ("flash_bwd_dq", "flash_bwd_dkv")
    worst = dict.fromkeys(names, 0.0)
    worst32 = dict.fromkeys(names, 0.0)
    plain_ms = {}
    for i, (b, s, h, h_kv, d, dtype, causal, window) in enumerate(cases):
        unit = cases[i] == TP_TRAIN_BWD
        args = bwd_inputs(fa, card, gen, b, s, h, h_kv, d, dtype, causal,
                          window, shard=1 if s == SP_SHARD else None,
                          unit_batch_stride=unit)
        got = {"flash_bwd_dq": (fa.flash_bwd_dq(*args, causal, window),),
               "flash_bwd_dkv": fa.flash_bwd_dkv(*args, causal, window)}
        torch.cuda.synchronize()
        line = []
        for name in names:
            err, err32, tc, text = hold_backward(
                fa, name, got[name], args, (causal, window),
                (causal, window))
            check(tc == (dtype == torch.bfloat16 and d in (64, 128)),
                  f"{name} took the wrong route at {(b, s, h, d, dtype)}")
            line.append(text)
            worst[name] = max(worst[name], err)
            worst32[name] = max(worst32[name], err32)
        print(f"kernel backward B={b} S={s} H={h} H_kv={h_kv} D={d} "
              f"{str(dtype)[6:]} causal={causal} window={window}"
              f"{' dO batch stride 1' if unit else ''} "
              f"[{'tensor cores' if tc else 'loop'}]: " + "; ".join(line),
              flush=True)
        if i == 0:
            # the plain version of the route the training shape takes
            plain_ms = {
                "flash_bwd_dq": time_ms(
                    lambda: fa.flash_bwd_dq_reference(
                        *args, True, None, operand_dtype=torch.bfloat16), 3),
                "flash_bwd_dkv": time_ms(
                    lambda: fa.flash_bwd_dkv_reference(
                        *args, True, None, operand_dtype=torch.bfloat16), 3),
            }
        del args, got
        torch.cuda.empty_cache()

    # The training shape: B 4, S 4096, as the main path gives it.
    shape = (TRAIN_BATCH, TRAIN_SEQ, 16, 4, 128, torch.bfloat16, True, None)
    args = bwd_inputs(fa, card, gen, *shape)
    ms = {"flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(*args), 5),
          "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv(*args), 5)}
    fwd_ms = time_ms(lambda: fa.flash_attention(*args[:3]), 10)
    q, k, v = (x.transpose(1, 2).detach().requires_grad_()
               for x in args[:3])
    g = args[3].transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                    enable_gqa=True), 10)
    sdpa_both = time_ms(lambda: torch.autograd.grad(
        sdpa(q, k, v, is_causal=True, enable_gqa=True), (q, k, v), g), 10)
    library_ms = sdpa_both - sdpa_fwd
    fwd_bytes, fwd_flops = attention_work(*shape)
    print(f"kernel flash_fwd timing at the training shape (B 4, S 4096): "
          f"{fwd_ms:.4f} ms, SDPA forward {sdpa_fwd:.4f} ms, bound "
          f"{bound(fwd_bytes, fwd_flops, torch.bfloat16)[0]:.4f} ms "
          f"({fwd_flops / fwd_ms / 1e9:.1f} TFLOP/s)", flush=True)
    work = backward_work(*shape)
    entries = {}
    for name, replaces in (("flash_bwd_dq", 125), ("flash_bwd_dkv", 169)):
        bound_ms, bound_by = bound(*work[name], torch.bfloat16)
        entries[name] = {
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"horovod_tpu/ops/flash_attention.py:{replaces}",
            "ms": ms[name], "plain_ms": plain_ms[name],
            "plain_shape": "B 1, S 4096 (the kernel's ms is at B 4)",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention backward (forward + "
                       "backward less forward), dq, dk and dv together",
            "max_abs_err": worst[name],
            "max_abs_err_f32_plain": worst32[name],
        }
        print(f"kernel {name} timing at the training shape: {ms[name]:.4f} "
              f"ms, plain (B 1) {plain_ms[name]:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; "
              f"{work[name][1] / ms[name] / 1e9:.1f} TFLOP/s)", flush=True)
    print(f"kernel backward pair at the training shape: "
          f"{ms['flash_bwd_dq'] + ms['flash_bwd_dkv']:.4f} ms; SDPA backward "
          f"{library_ms:.4f} ms (forward + backward {sdpa_both:.4f} ms)",
          flush=True)
    train_fwd = {"ms": fwd_ms, "library_ms": sdpa_fwd,
                 "bound_ms": bound(fwd_bytes, fwd_flops, torch.bfloat16)[0]}
    del args, q, k, v, g
    torch.cuda.empty_cache()
    for d in LOOP_WIDE_DIMS:
        wide = loop_wide_timings(fa, card, gen, d)
        train_fwd[f"loop_d{d}_ms"] = wide["flash_fwd"]
        for name in names:
            entries[name][f"loop_d{d}_ms"] = wide[name]
    return entries, train_fwd


# Head dims 256 and 320 run the CUDA-core loop only (off every main
# path; 320 in two 256-column pieces): their times at B 1 x S 4096,
# H 8 / H_kv 2, bf16, causal.
LOOP_WIDE_DIMS = (256, 320)


def loop_wide_timings(fa, card, gen, d):
    """{kernel: ms} of the three static kernels at head dim ``d`` (B 1,
    S 4096, H 8 / 2, bf16, causal), each with its bound (operations, at
    the f32 rate: the loop multiplies on the CUDA cores). The times are
    wall times on the card's stream (CUDA events)."""
    shape = (1, TRAIN_SEQ, 8, 2, d, torch.bfloat16, True, None)
    args = bwd_inputs(fa, card, gen, *shape)
    check(not fa.tensor_core_route(*args[:4]),
          f"D {d} took the tensor cores")
    ms = {"flash_fwd": time_ms(lambda: fa.flash_attention(*args[:3]), 3),
          "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(*args), 3),
          "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv(*args), 3)}
    work = backward_work(*shape)
    work["flash_fwd"] = attention_work(*shape)
    for name, t in ms.items():
        b_ms, by = bound(*work[name], torch.float32)
        print(f"kernel {name} on the loop at D {d} (B 1, S 4096, H 8/2, "
              f"bf16, causal): {t:.4f} ms, bound {b_ms:.4f} ms ({by}, f32 "
              f"rate; {work[name][1] / t / 1e9:.1f} TFLOP/s)", flush=True)
    del args
    torch.cuda.empty_cache()
    return ms


def band_work(b, s, h, h_kv, d, dtype, off, window):
    """{kernel: (bytes, flops)} of the three band kernels on these shapes:
    each input read once, each output written once (out in ``dtype``,
    lse and the gradients f32), 4, 6 and 8 x D FLOPs per live pair."""
    item = torch.tensor([], dtype=dtype).element_size()
    q_side, kv_side = b * s * h * d, b * s * h_kv * d
    vec = 4 * b * h * s
    pairs = causal_pairs(s, True, window, off) * b * h
    return {
        "flash_band_fwd": ((2 * q_side + 2 * kv_side) * item + vec,
                           4 * d * pairs),
        "flash_band_dq": ((2 * q_side + 2 * kv_side) * item + 2 * vec
                          + 4 * q_side, 6 * d * pairs),
        "flash_band_dkv": ((2 * q_side + 2 * kv_side) * item + 2 * vec
                           + 2 * 4 * kv_side, 8 * d * pairs),
    }


def live_rows(fa, s, off, window):
    """Rows of a band tile at offset ``off`` with at least one live key."""
    lo, hi = fa.band_key_span(s, off, window)
    return lo <= hi


def top_kernel(fn):
    """Name of the CUDA kernel with the most device time in one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(getattr(r, "self_device_time_total", 0), r.key)
            for r in prof.key_averages() if r.device_type == DeviceType.CUDA]
    return max(rows)[1][:90] if rows else "not measured"


def band_inputs(fa, card, gen, b, s, h, h_kv, d, dtype, off, window):
    """q, k, v, dO in ``dtype``; a finite global lse (the band tile's
    merged with a diagonal tile's, as the ring merges them) and
    delta = rowsum(dO * out) of the band tile's out. At the path's shard
    length, lse and delta are strided views, as the ring's chunks are."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=card).to(dtype)
    q, do = randn(b, s, h, d), randn(b, s, h, d)
    k, v, k2, v2 = (randn(b, s, h_kv, d) for _ in range(4))
    out, lse_band = fa.flash_band_fwd_reference(q, k, v, off, window)
    _, lse_diag = fa.flash_attention_reference(q, k2, v2, True, window)
    lse = torch.logaddexp(lse_band, lse_diag)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if s == SP_SHARD:
        shard = off // s
        lse, delta = ring_view(lse, shard, gen), ring_view(delta, shard, gen)
    return q, k, v, do, lse, delta


def phase_band_kernels(fa, card, gen):
    """The three band kernels against their plain versions at every
    listed shape; each timed with its plain version and SDPA (explicit
    band mask) at the ring's two offsets. Returns their entries of the
    kernels line: times are means per launch over the path's mix of
    offsets (SP_BAND_OFFSETS)."""
    path = (SP_BATCH, SP_SHARD, 16, 4, 128, torch.bfloat16)
    cases = [  # (B, S, H, H_kv, D, dtype, off, window)
        path + (SP_SHARD, SP_WINDOW),       # fully visible tile
        path + (2 * SP_SHARD, SP_WINDOW),   # half band, its last row dead
        (2, 130, 4, 2, 8, torch.float32, 130, 100),     # ragged, dead rows
        (1, 1000, 8, 8, 64, torch.float32, 2000, 1500),  # off 2S, dead rows
        (1, 700, 16, 4, 128, torch.bfloat16, 700, 1000),  # ragged, window > S
        (1, 200, 4, 2, 320, torch.bfloat16, 200, 150),  # D 320, dead rows
    ]
    names = ("flash_band_fwd", "flash_band_dq", "flash_band_dkv")
    worst = dict.fromkeys(names, 0.0)
    worst32 = dict.fromkeys(names, 0.0)
    timed = {}
    for b, s, h, h_kv, d, dtype, off, window in cases:
        q, k, v, do, lse, delta = band_inputs(fa, card, gen, b, s, h, h_kv,
                                              d, dtype, off, window)
        before = read_launches(fa)
        out, lse_t = fa.flash_band_fwd(q, k, v, off, window)
        torch.cuda.synchronize()
        after = read_launches(fa)
        dq = fa.flash_band_dq(q, k, v, do, lse, delta, off, window)
        dk, dv = fa.flash_band_dkv(q, k, v, do, lse, delta, off, window)
        torch.cuda.synchronize()
        live = live_rows(fa, s, off, window).to(card)
        check(torch.isfinite(out).all() and torch.isfinite(lse_t).all(),
              "flash_band_fwd gave a NaN or an infinity")
        check((lse_t[:, :, ~live] <= -1e29).all(),
              "flash_band_fwd: a row with no live key kept weight")
        err_o, err32, tc, fwd_text = hold_forward(
            fa, "flash_band_fwd", out, lse_t, (q, k, v), (off, window),
            (True, window, off), rows=live)
        check(tc == (dtype == torch.bfloat16 and d in (64, 128)),
              f"flash_band_fwd took the wrong route at {(b, s, h, d, dtype)}")
        route = "flash_band_fwd_wgmma" if tc else "flash_band_fwd"
        check(after[route] == before[route] + 1,
              f"flash_band_fwd was not counted on its route at "
              f"{(b, s, h, d)}")
        worst32["flash_band_fwd"] = max(worst32["flash_band_fwd"], err32)
        args = (q, k, v, do, lse, delta)
        grads = []
        for name, got in (("flash_band_dq", (dq,)),
                          ("flash_band_dkv", (dk, dv))):
            err, err32, tc, text = hold_backward(
                fa, name, got, args, (off, window), (True, window, off))
            check(tc == (dtype == torch.bfloat16 and d in (64, 128)),
                  f"{name} took the wrong route at {(b, s, h, d, dtype)}")
            grads.append(text)
            worst[name] = max(worst[name], err)
            worst32[name] = max(worst32[name], err32)
        print(f"kernel band B={b} S={s} H={h} H_kv={h_kv} D={d} "
              f"{str(dtype)[6:]} off={off} window={window} "
              f"({int((~live).sum())} rows with no key) "
              f"[{'tensor cores' if tc else 'loop'}]: {fwd_text}; f32 "
              f"gradients " + "; ".join(grads), flush=True)
        worst["flash_band_fwd"] = max(worst["flash_band_fwd"], err_o)
        if (b, s, h, h_kv, d, dtype) == path:
            # timed on dense lse and delta, as the ring passes them
            timed[off] = band_timings(
                fa, (q, k, v, do, lse.contiguous(), delta.contiguous()), off,
                window, band_work(*path, off, window))
        del q, k, v, do, lse, delta, out, dq, dk, dv, args
        torch.cuda.empty_cache()

    entries = []
    mix = SP_BAND_OFFSETS
    for name, replaces in zip(names, (242, 283, 317)):
        def mean(key):
            return sum(timed[o][name][key] for o in mix) / len(mix)
        by = {timed[o][name]["bound_by"] for o in mix}
        entries.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/" + (
                "flash_fwd.cu" if name == "flash_band_fwd" else
                "flash_bwd.cu"),
            "replaces": f"horovod_tpu/ops/flash_attention.py:{replaces}",
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": by.pop() if len(by) == 1 else "operations",
            "library_ms": mean("library_ms"),
            "library": timed[mix[0]][name]["library"],
            "by_offset": {o: timed[o][name] for o in sorted(timed)},
            "shape": "B 2, S 2048, H 16, H_kv 4, D 128, bf16, window 4096; "
                     "times are means per launch over the path's offsets "
                     f"{mix}",
            "max_abs_err": worst[name],
            "max_abs_err_f32_plain": worst32[name],
        })
    return entries


def band_timings(fa, args, off, window, work):
    """{kernel: ms, plain_ms, bound_ms, bound_by, library_ms, library} at
    one offset of the path's shape. The library call is SDPA with the
    tile's band as an explicit boolean ``attn_mask`` (the flash backend
    takes no arbitrary mask), k and v expanded to the query heads before
    the timed calls; its backward is forward + backward less forward, dq,
    dk and dv together."""
    q, k, v, do, lse, delta = args
    s = q.shape[1]
    ms = {
        "flash_band_fwd": time_ms(lambda: fa.flash_band_fwd(q, k, v, off,
                                                            window), 20),
        "flash_band_dq": time_ms(lambda: fa.flash_band_dq(*args, off,
                                                          window), 10),
        "flash_band_dkv": time_ms(lambda: fa.flash_band_dkv(*args, off,
                                                            window), 10),
    }
    bf16 = torch.bfloat16  # the tensor-core route's plain versions
    plain = {
        "flash_band_fwd": time_ms(lambda: fa.flash_band_fwd_reference(
            q, k, v, off, window, operand_dtype=bf16), 3),
        "flash_band_dq": time_ms(lambda: fa.flash_band_dq_reference(
            *args, off, window, operand_dtype=bf16), 3),
        "flash_band_dkv": time_ms(lambda: fa.flash_band_dkv_reference(
            *args, off, window, operand_dtype=bf16), 3),
    }
    group = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(group, dim=2).transpose(1, 2).detach()
              .requires_grad_() for x in (k, v))
    g = do.transpose(1, 2)
    pos = torch.arange(s, device=q.device)
    dist = off + pos[:, None] - pos[None, :]
    mask = (dist >= 0) & (dist < window)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd():
        return sdpa(qt, kt, vt, attn_mask=mask)

    def both():
        return torch.autograd.grad(fwd(), (qt, kt, vt), g)

    lib_fwd, lib_both = time_ms(fwd, 10), time_ms(both, 10)
    kernel_fwd, kernel_both = top_kernel(fwd), top_kernel(both)
    library = {
        "flash_band_fwd": (lib_fwd, f"scaled_dot_product_attention with a "
                                    f"band attn_mask (kernel {kernel_fwd})"),
        "flash_band_dq": (lib_both - lib_fwd,
                          f"scaled_dot_product_attention backward with a "
                          f"band attn_mask, dq, dk and dv together (kernel "
                          f"{kernel_both})"),
    }
    library["flash_band_dkv"] = library["flash_band_dq"]
    out = {}
    for name in ms:
        nbytes, flops = work[name]
        bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
        out[name] = {"ms": ms[name], "plain_ms": plain[name],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library[name][0],
                     "library": library[name][1]}
        print(f"kernel {name} timing at off {off}: {ms[name]:.4f} ms, plain "
              f"{plain[name]:.4f} ms, SDPA {library[name][0]:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {flops / ms[name] / 1e9:.1f} "
              f"TFLOP/s)", flush=True)
    print(f"kernel band SDPA at off {off}: forward {kernel_fwd}; backward "
          f"{kernel_both}", flush=True)
    return out


# Ulysses' shard shape on the SP path: the SP model's q over a local
# axis of SP_RING, H 16 / H_kv 4 cut to H 4 / H_kv 1 a shard, over the
# whole sequence of 2 x 8192 at the window.
ULYSSES_SHAPE = (SP_BATCH, SP_SEQ, 16 // SP_RING, 4 // SP_RING, 128)


def ulysses_views(card, gen, b):
    """Shard 1's q, k and v as Ulysses hands them to the kernels: head
    slices of a (B, S, 16, D) q and of the (B, S, 2, 4, D) kv
    projection, their base pointers (H/n)*D elements on."""
    _, s, h, h_kv, d = ULYSSES_SHAPE
    q = torch.randn(b, s, h * SP_RING, d, generator=gen, device=card).to(
        torch.bfloat16)
    kv = torch.randn(b, s, 2, h_kv * SP_RING, d, generator=gen,
                     device=card).to(torch.bfloat16)
    views = (q[:, :, h:2 * h], kv[:, :, 0, h_kv:2 * h_kv],
             kv[:, :, 1, h_kv:2 * h_kv])
    check(all(not x.is_contiguous() for x in views)
          and views[0].data_ptr() == q.data_ptr() + h * d * 2,
          "the Ulysses views are not head slices")
    return views


def phase_ulysses_kernels(fa, card, gen, entries):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv at Ulysses' shard shape
    (B 2, S 8192, H 4, H_kv 1, D 128, bf16, causal, window 4096) on
    head-sliced views, against their plain versions at the phase's
    tolerances (the backward's at B 1), and timed beside SDPA with the
    window as a boolean mask at B 2. Adds ``ulysses_shape`` to each
    kernel's entry of the kernels line (``entries`` by name)."""
    b, s, h, h_kv, d = ULYSSES_SHAPE
    dtype, window = torch.bfloat16, SP_WINDOW
    q, k, v = ulysses_views(card, gen, b)
    check(fa.tensor_core_route(q, k, v),
          "Ulysses' head slices do not take the tensor cores")
    before = read_launches(fa)
    out, lse = fa.flash_attention_with_lse(q, k, v, True, window)
    torch.cuda.synchronize()
    check(read_launches(fa)["flash_fwd_wgmma"]
          == before["flash_fwd_wgmma"] + 1,
          "flash_fwd on Ulysses' views was not counted on the tensor cores")
    err, _, _, text = hold_forward(fa, "flash_attention", out, lse,
                                   (q, k, v), (True, window), (True, window))
    print(f"kernel flash_fwd Ulysses shard B={b} S={s} H={h} H_kv={h_kv} "
          f"D={d} window={window}, head-sliced views [tensor cores]: {text}",
          flush=True)
    errs = {"flash_fwd": err}
    do = torch.randn(b, s, h, d, generator=gen, device=card).to(dtype)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    one = tuple(x[:1] for x in args)   # the plain backward at B 1
    check(fa.tensor_core_route(*one[:4]),
          "the Ulysses backward does not take the tensor cores")
    got = {"flash_bwd_dq": (fa.flash_bwd_dq(*one, True, window),),
           "flash_bwd_dkv": fa.flash_bwd_dkv(*one, True, window)}
    torch.cuda.synchronize()
    line = []
    for name in got:
        errs[name], _, _, text = hold_backward(fa, name, got[name], one,
                                               (True, window), (True, window))
        line.append(text)
    print(f"kernel backward Ulysses shard B=1 S={s} H={h} H_kv={h_kv} D={d} "
          f"window={window} [tensor cores]: " + "; ".join(line), flush=True)
    del got
    ms = {"flash_fwd": time_ms(lambda: fa.flash_attention(q, k, v, True,
                                                          window), 10),
          "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(
              *args, True, window), 5),
          "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv(
              *args, True, window), 5)}
    plain = {"flash_fwd": time_ms(lambda: fa.flash_attention_reference(
        q, k, v, True, window, operand_dtype=dtype), 1),
             "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq_reference(
                 *one, True, window, operand_dtype=dtype), 1),
             "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv_reference(
                 *one, True, window, operand_dtype=dtype), 1)}
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(h // h_kv, dim=2).transpose(1, 2)
              .detach().requires_grad_() for x in (k, v))
    g = do.transpose(1, 2)
    pos = torch.arange(s, device=card)
    gap = pos[:, None] - pos[None, :]
    mask = (gap >= 0) & (gap < window)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), 5)
    lib_both = time_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, attn_mask=mask), (qt, kt, vt), g), 5)
    work = backward_work(b, s, h, h_kv, d, dtype, True, window)
    work["flash_fwd"] = attention_work(b, s, h, h_kv, d, dtype, True, window)
    for name in ms:
        bound_ms, bound_by = bound(*work[name], dtype)
        lib = lib_fwd if name == "flash_fwd" else lib_both - lib_fwd
        entries[name]["ulysses_shape"] = {
            "shape": f"B {b}, S {s}, H {h} / H_kv {h_kv}, D {d}, window "
                     f"{window}, head-sliced views",
            "ms": ms[name], "plain_ms": plain[name],
            "plain_shape": "B 2" if name == "flash_fwd" else "B 1",
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
            "library": "scaled_dot_product_attention with the window as a "
                       "boolean attn_mask" + ("" if name == "flash_fwd" else
                                              " (backward: dq, dk, dv)"),
            "max_abs_err": errs[name]}
        print(f"kernel {name} timing at Ulysses' shard shape: {ms[name]:.4f}"
              f" ms, plain {plain[name]:.4f} ms, SDPA {lib:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; "
              f"{work[name][1] / ms[name] / 1e9:.1f} TFLOP/s)", flush=True)
    del q, k, v, out, lse, do, delta, args, one, qt, kt, vt, g, mask
    torch.cuda.empty_cache()


def phase_sp_parity(tfm, RingAxis, card):
    """One step's loss and gradients through the sp-4 ring and through
    Ulysses over a local axis of 4, each against the model without SP
    at the same window, full width on one batch of 2 x 8192, with each
    run's peak memory; and a small f32 model's ring (flash tiles, band
    tiles with rows that see no key, a pruned ring) and Ulysses (the
    CUDA-core loop at H/4 heads) against dense attention. Ulysses' shards
    hold whole GQA groups and the kernels compute each head alone, so
    its run should equal the unsharded one bit for bit but where the
    products around the attention differ: the phase prints max|d| and
    the leaves that are bitwise equal."""
    rng = np.random.default_rng(4)
    # 8 / 4 heads: Ulysses over 4 shards needs the K/V heads to divide
    small = dict(vocab_size=256, d_model=128, n_heads=8, n_kv_heads=4,
                 n_layers=2, d_ff=256, max_seq=256, positional="rope",
                 attention_window=100)
    # (name, attention impl, sp_impl or None without SP); the second run
    # is the yardstick of the others
    runs = (("full width 2 x 8192", SP_MODEL, SP_BATCH, SP_SEQ,
             torch.bfloat16, (("ring", "flash", "ring"),
                              ("flash", "flash", None),
                              ("ulysses", "flash", "ulysses"))),
            ("small f32", small, 2, 256, torch.float32,
             (("ring", "flash", "ring"), ("dense", "dense", None),
              ("ulysses", "flash", "ulysses"))))
    for label, kw, batch, seq, dtype, triple in runs:
        tokens = torch.from_numpy(rng.integers(0, kw["vocab_size"],
                                               (batch, seq))).to(card)
        targets = torch.roll(tokens, -1, dims=1)
        params, loss, grads, peak = None, {}, {}, {}
        for name, impl, sp_impl in triple:
            cfg = tfm.TransformerConfig(dtype=dtype, attention_impl=impl,
                                        sp_impl=sp_impl or "ring",
                                        loss_chunk=min(LOSS_CHUNK, seq), **kw)
            if params is None:
                params = tfm.init_params(cfg, torch.Generator().manual_seed(5),
                                         card)
            axes = (None if sp_impl is None
                    else tfm.ShardAxes(sp=RingAxis.local(SP_RING)))
            for t in _leaves(params):
                t.grad = None
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss[name], g = _loss_and_grads(tfm, params, cfg, tokens, targets,
                                            axes)
            peak[name] = torch.cuda.max_memory_allocated() - base
            grads[name] = {k: v.float().clone() for k, v in g.items()}
            del g
        b = triple[1][0]
        for a in (triple[0][0], triple[2][0]):
            dl = abs(loss[a] - loss[b])
            diff = {k: (grads[a][k] - grads[b][k]).abs().max().item()
                    for k in grads[b]}
            same = sum(d == 0.0 for d in diff.values())
            err = max(diff.values())
            head = (f"parity sp {label}: {a} vs {b}: loss {loss[a]:.6f} vs "
                    f"{loss[b]:.6f} (|d|={dl:.3g}); max|dgrad|={err:.3g}, "
                    f"{same} of {len(diff)} leaves bitwise equal"
                    + (" (loss too)" if dl == 0.0 else ""))
            if dtype == torch.float32:
                print(f"{head} (tol {SMALL_GRAD_ATOL:g})", flush=True)
                check(err <= SMALL_GRAD_ATOL and dl <= SMALL_GRAD_ATOL,
                      f"small f32 model: {a} and {b} gradients disagree")
                continue
            rel = _rel_l2(grads[a], grads[b])
            worst = max(rel, key=rel.get)
            print(f"{head}; loss tol {TRAIN_LOSS_ATOL:g}; gradient "
                  f"relative L2 worst {rel[worst]:.4g} at {worst} (tol "
                  f"{TRAIN_GRAD_REL:g}), median "
                  f"{float(np.median(list(rel.values()))):.4g}; peak memory "
                  f"of loss and backward above what was allocated before "
                  f"(the new gradients included): {a} "
                  f"{peak[a] / 2 ** 30:.2f} GiB, {b} "
                  f"{peak[b] / 2 ** 30:.2f} GiB", flush=True)
            check(dl <= TRAIN_LOSS_ATOL, f"{a} and {b} losses disagree")
            check(rel[worst] <= TRAIN_GRAD_REL,
                  f"{a} and {b} gradients disagree")
        del params, grads
        torch.cuda.empty_cache()


def _flat_grads(params):
    out = {k: v.grad for k, v in params.items() if k != "layers"}
    for i, layer in enumerate(params["layers"]):
        out.update({f"layers.{i}.{k}": v.grad for k, v in layer.items()})
    return out


def _leaves(params):
    return [v for k, v in params.items() if k != "layers"] + \
        [v for layer in params["layers"] for v in layer.values()]


def _loss_and_grads(tfm, params, cfg, tokens, targets, axes=None):
    for t in _leaves(params):
        t.grad = None
        t.requires_grad_()
    loss = tfm.loss_fn(params, tokens, targets, cfg, axes)
    loss.backward()
    return loss.item(), _flat_grads(params)


def _rel_l2(a, b):
    """{leaf: |a - b| / |b|} over two gradient dicts."""
    return {k: ((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)).item()
            for k in b}


def phase_train_parity(tfm, card):
    """loss_fn and every parameter gradient through flash against dense:
    full width at B 1, S 1024 (bf16, with the f32 dense model as the
    yardstick of both), and a small f32 model."""
    rng = np.random.default_rng(2)
    small = dict(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2,
                 n_layers=2, d_ff=256, max_seq=128, positional="rope")
    for label, kw, seq, dtype in (
            ("full width B 1 x 1024", FLAGSHIP, 1024, torch.bfloat16),
            ("small f32", small, 128, torch.float32)):
        tokens = torch.from_numpy(rng.integers(0, kw["vocab_size"],
                                               (1, seq))).to(card)
        targets = torch.roll(tokens, -1, dims=1)
        runs = [("flash", "flash", dtype), ("dense", "dense", dtype)]
        if dtype != torch.float32:
            runs.append(("f32 dense", "dense", torch.float32))
        params = None
        loss, grads = {}, {}
        for name, impl, dt in runs:
            cfg = tfm.TransformerConfig(dtype=dt, attention_impl=impl,
                                        loss_chunk=min(LOSS_CHUNK, seq), **kw)
            if params is None:
                params = tfm.init_params(cfg, torch.Generator().manual_seed(3),
                                         card)
            loss[name], g = _loss_and_grads(tfm, params, cfg, tokens,
                                            targets)
            grads[name] = {k: v.float().clone() for k, v in g.items()}
        dl = abs(loss["flash"] - loss["dense"])
        if dtype == torch.float32:
            err = max((grads["flash"][k] - grads["dense"][k]).abs().max()
                      .item() for k in grads["dense"])
            print(f"parity train {label}: loss {loss['flash']:.6f} vs "
                  f"{loss['dense']:.6f}; max|dgrad|={err:.3g} (tol "
                  f"{SMALL_GRAD_ATOL:g})", flush=True)
            check(err <= SMALL_GRAD_ATOL and dl <= SMALL_GRAD_ATOL,
                  "small f32 model: flash and dense gradients disagree")
            continue
        rel = {pair: _rel_l2(grads[pair[0]], grads[pair[1]])
               for pair in (("flash", "dense"), ("flash", "f32 dense"),
                            ("dense", "f32 dense"))}
        print(f"parity train {label}: loss flash {loss['flash']:.6f}, dense "
              f"{loss['dense']:.6f} (|d|={dl:.3g}, tol {TRAIN_LOSS_ATOL:g}), "
              f"f32 dense {loss['f32 dense']:.6f}", flush=True)
        for (a, b), r in rel.items():
            worst = max(r, key=r.get)
            print(f"parity train {label}: gradient relative L2 {a} vs {b}: "
                  f"worst {r[worst]:.4g} at {worst}, median "
                  f"{float(np.median(list(r.values()))):.4g}", flush=True)
        check(dl <= TRAIN_LOSS_ATOL, "flash and dense losses disagree")
        worst = {pair: max(r.values()) for pair, r in rel.items()}
        check(worst[("flash", "dense")] <= TRAIN_GRAD_REL,
              "flash and dense gradients disagree")
        check(worst[("flash", "f32 dense")]
              <= YARDSTICK_RATIO * worst[("dense", "f32 dense")],
              "flash gradients are farther from the f32 model than the "
              "dense path's")
        del params, grads
        torch.cuda.empty_cache()


def flops_per_token(params, cfg, seq):
    """bench_transformer.py's convention: 6 x the matrix-product
    parameters (q/k/v, o, the MLP, the LM head; not the embedding or the
    norms) plus 6 x n_layers x seq x d_model of causal attention (no
    discount for a window)."""
    p_mm = sum(v.numel() for layer in params["layers"]
               for k, v in layer.items()
               if k.startswith(("wq", "wk", "wo", "w1", "w2")))
    # an MoE layer: the router and the top_k experts a token is sent to
    p_mm += sum(layer["moe"]["w_router"].numel() + cfg.moe_top_k
                * (layer["moe"]["w1"].numel() + layer["moe"]["w2"].numel())
                // cfg.moe_num_experts
                for layer in params["layers"] if "moe" in layer)
    p_mm += params["lm_head"].numel()
    return 6 * p_mm + 6 * cfg.n_layers * seq * cfg.d_model


# Each kernel's launch counter in ops/flash_attention.py on the CUDA-core
# loop (the kernel's name) and on the tensor-core route (<name>_wgmma).
PREFIXES = {"flash_fwd": "", "flash_band_fwd": "band_", "flash_bwd_dq": "dq_",
            "flash_bwd_dkv": "dkv_", "flash_band_dq": "band_dq_",
            "flash_band_dkv": "band_dkv_"}
WGMMA = {n: n + "_wgmma" for n in PREFIXES}
COUNTERS = {**{n: f"{p}launches" for n, p in PREFIXES.items()},
            **{WGMMA[n]: f"{p}wgmma_launches" for n, p in PREFIXES.items()}}


def read_launches(fa):
    """{kernel route (the loop as the kernel's name, the tensor cores as
    <name>_wgmma): launches}."""
    return {n: getattr(fa, c) for n, c in COUNTERS.items()}


def zero_launches(fa):
    for c in COUNTERS.values():
        setattr(fa, c, 0)


def phase_train(hvd, fa, tfm, card, where, ring=None, sp_impl="ring"):
    """Main path 2 (``ring`` None: batch 4 x 4096), 3 (``ring`` a
    RingAxis: the SP model at batch 2 x 8192 through the ring) or 12
    (the same through Ulysses, ``sp_impl="ulysses"``): init ->
    broadcast_parameters -> DistributedOptimizer -> loss_fn, warm-up plus
    timed steps on one batch, counts zeroed around it. Returns ({kernel:
    launches}, {"step_ms", "tok_s", "peak"}: the median timed step, its
    tokens/s and the peak memory)."""
    dump = os.path.join(tempfile.mkdtemp(), "profiler.txt")
    os.environ["HOROVOD_PROFILER_PATH"] = dump
    os.environ.pop("HOROVOD_PROFILER_DISABLE", None)
    hvd.init(device=card)
    check(hvd.size() == 1 and hvd.runtime.device().type == card.type,
          f"init: {hvd.size()} ranks on {hvd.runtime.device()}")
    if ring is None:
        label, batch, seq, model, axes = ("train", TRAIN_BATCH, TRAIN_SEQ,
                                          FLAGSHIP, None)
    else:
        label = "sp train" if sp_impl == "ring" else "ulysses train"
        batch, seq, model = SP_BATCH, SP_SEQ, SP_MODEL
        axes = tfm.ShardAxes(sp=ring)
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, sp_impl=sp_impl,
                                **model)
    lm = tfm.TransformerLM(cfg, seed0_params(tfm, cfg, card), device=card,
                           axes=axes)
    hvd.broadcast_parameters(lm.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), **ADAMW),
        named_parameters=lm.named_parameters())
    n_buckets = len(opt.exchange_buckets)
    grad_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (batch, seq))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)
    stats = hvd.runtime.live_state().stats
    calls0 = stats.counter("allreduce")
    time0 = stats.total_time_us("allreduce")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    steps = WARMUP_STEPS + TIMED_STEPS
    zero_launches(fa)
    events, losses = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.zero_grad(set_to_none=True)
        loss = lm.loss(tokens, targets)
        loss.backward()
        opt.step()
        end.record()
        events.append((start, end))
        losses.append(loss.detach())
    torch.cuda.synchronize()
    launches = read_launches(fa)

    losses = [x.item() for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in events[WARMUP_STEPS:]]
    peak = torch.cuda.max_memory_allocated()
    calls = stats.counter("allreduce") - calls0
    exchange_ms = (stats.total_time_us("allreduce") - time0) / 1e3 / steps
    hist = stats.histogram("allreduce")
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    # a step's launches per layer: one of each static kernel per local
    # shard (the ring's diagonal tiles, Ulysses' head slices), one of
    # each band kernel per live visiting tile of the ring; every launch
    # on the tensor-core route, none on the loop
    shards = 1 if ring is None else len(ring.shards)
    bands = 0 if ring is None or sp_impl != "ring" else len(SP_BAND_OFFSETS)
    for name, n in launches.items():
        per_layer = bands if name.startswith("flash_band") else shards
        if name in WGMMA:
            per_layer = 0
        check(n == steps * cfg.n_layers * per_layer,
              f"{name} launched {n} times in {steps} steps of "
              f"{cfg.n_layers} layers, {per_layer} a layer expected")
    check(calls == steps * n_buckets,
          f"{calls} all-reduces in {steps} steps of {n_buckets} buckets")
    check(hist.get(grad_bytes, (0, 0))[0] == steps,
          f"all-reduce sizes {hist} do not cover {grad_bytes} gradient "
          f"bytes once a step")
    median = float(np.median(step_ms))
    tok_s = batch * seq / (median / 1e3)
    fpt = flops_per_token(lm.params, cfg, seq)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"{label} losses: {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    print(f"{label} {batch} x {seq} tokens"
          f"{'' if ring is None else f' over {ring} ({sp_impl}), window '}"
          f"{'' if ring is None else SP_WINDOW}, "
          f"{n_params / 1e6:.1f} M "
          f"parameters [{where}]: step {median:.1f} ms (median of "
          f"{TIMED_STEPS}; {' '.join(f'{t:.1f}' for t in step_ms)}); "
          f"{tok_s:.1f} tokens/s; {fpt / 1e9:.3f} GFLOP/token; MFU "
          f"{fpt * tok_s / PEAK_FLOPS[torch.bfloat16]:.4f} against 989 "
          f"TFLOP/s bf16 (the port's products run in f32); exchange "
          f"{exchange_ms:.3f} ms/step over {calls // steps} bucket(s) of "
          f"{grad_bytes / 1e9:.3f} GB; peak memory "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    print(f"{label} launches in {steps} steps: {launches}", flush=True)
    del opt, lm
    gc.collect()
    hvd.shutdown()
    with open(dump) as f:
        counter = next((line for line in f if
                        line.startswith("Counter allreduce,")), None)
    check(counter is not None and int(counter.split(",")[1]) >= calls,
          f"profiler dump {dump}: {counter!r}")
    print(f"{label} shutdown: profiler dump {counter.strip()}", flush=True)
    torch.cuda.empty_cache()
    return launches, {"step_ms": median, "tok_s": tok_s, "peak": peak,
                      "losses": losses}


COMPILED_STEPS, REPLAYS = 3, 4


def to_card(tree, card):
    """A copy of a parameter tree (dicts, lists of layers) on the card."""
    if isinstance(tree, dict):
        return {k: to_card(v, card) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_card(v, card) for v in tree]
    return tree.to(card, copy=True)


# The seed-0 host trees, by parameter layout: tfm.init_params draws on
# the host from a CPU generator (a flagship draw took ~10 s of the card
# machine's host), and the phases start from the same tree again and
# again. main() draws each once, and writes it under the directory in
# SEED0_ENV for the run's child processes (the TP ranks, the launcher's
# generations), which load it instead of drawing.
_SEED0 = {}
SEED0_ENV = "CHIP_SMOKE_SEED0_DIR"
_seed0_writer = False  # main() sets it: children only read


def seed0_host(tfm, cfg):
    """``tfm.init_params(cfg, Generator seeded 0, "cpu")``, drawn once a
    parameter layout (or loaded from the run's file of it); callers only
    copy it."""
    import hashlib
    key = repr((tfm.param_shapes(cfg), cfg.param_dtype, cfg.d_ff,
                cfg.moe_cfg if cfg.moe_layers else None))
    if key in _SEED0:
        return _SEED0[key]
    path = None
    if os.environ.get(SEED0_ENV):
        path = os.path.join(os.environ[SEED0_ENV], hashlib.sha256(
            key.encode()).hexdigest()[:16] + ".pt")
    if path is not None and os.path.exists(path):
        tree = torch.load(path, weights_only=True)
    else:
        tree = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        if path is not None and _seed0_writer:
            torch.save(tree, path + ".tmp")
            os.replace(path + ".tmp", path)
    _SEED0[key] = tree
    return tree


def seed0_draws(tfm):
    """The run's host draws of seed 0, made once: the flagship's,
    FT_MODEL's and SP_MODEL's trees (:func:`seed0_host`, with their files
    for the child processes) and flagship-moe's, which it returns."""
    for model in (FLAGSHIP, FT_MODEL, SP_MODEL):
        seed0_host(tfm, tfm.TransformerConfig(**model))
    moe_init = tfm.init_params(tfm.TransformerConfig(**MOE_MODEL),
                               torch.Generator().manual_seed(0), "cpu")
    print(f"flagship-moe: "
          f"{sum(t.numel() for t in tfm._leaves(moe_init)) / 1e6:.1f} M "
          f"parameters drawn", flush=True)
    return moe_init


def seed0_params(tfm, cfg, card):
    """A copy on ``card`` of the seed-0 tree of ``cfg``: the bits of
    ``TransformerLM(cfg, generator=Generator seeded 0, device=card)``."""
    return to_card(seed0_host(tfm, cfg), card)


def phase_compiled_train(hvd, fa, tfm, card, where, model=FLAGSHIP,
                         label="compiled train", expert_keys=None,
                         init=None, shape=(TRAIN_BATCH, TRAIN_SEQ),
                         axes=None, per_replay=None, then=None):
    """Main path 6 (``model`` the flagship) or 7 (flagship-moe, with
    ``expert_keys``): the model at batch 4 x 4096 through
    ``compiled_train_step`` over ``DistributedOptimizer(AdamW(...,
    capturable=True))``, under HOROVOD_PROFILER_JIT_CALLBACKS=1. First
    COMPILED_STEPS eager steps of the same optimizer from the same init
    (the last ones timed); then COMPILED_STEPS compiled steps (the
    first runs eagerly and captures the graph, the rest replay it), whose
    parameters must equal the eager run's bitwise, with 1 cache miss, the
    rest hits and no fallback; then REPLAYS timed replays, each with 8
    launches of each static kernel on the tensor-core route and the
    eager path's one all-reduce a bucket (a bucket a group with expert
    keys: the experts' over the data group, the rest over the world).
    The losses must be finite and fall. ``init`` (a parameter tree on
    the host) starts both runs, else seed 0 does. Main path 13 runs the
    SP model at ``shape`` 2 x 8192 over ``axes`` (a local axis of 4,
    the ring's or Ulysses', ``model``'s ``sp_impl``), each replay with
    ``per_replay`` launches ({route counter: launches}; default one of
    each static kernel a layer). ``then(lm, opt, step, tokens, targets,
    per_replay)``, if given, runs after the checks, on the trained model
    and its step (``per_replay`` the launches of an untraced replay by
    route). Returns ({kernel:
    launches} of the compiled steps, the trained parameters, the batch,
    {"params": the parameters after COMPILED_STEPS compiled steps on the
    host, by name, "step_ms", "tok_s", "peak": the replays' median, its
    tokens/s and the peak memory})."""
    os.environ["HOROVOD_PROFILER_JIT_CALLBACKS"] = "1"
    hvd.init(device=card)
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **model)
    batch, seq = shape
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (batch, seq))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)

    def build():
        lm = tfm.TransformerLM(
            cfg, seed0_params(tfm, cfg, card) if init is None
            else to_card(init, card), device=card, axes=axes)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(lm.parameters(), capturable=True, **ADAMW),
            named_parameters=lm.named_parameters(), expert_keys=expert_keys)
        return lm, opt

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        loss = fn()
        host = time.perf_counter() - t0
        end.record()
        return loss, (start, end), host

    lm, opt = build()
    eager = []
    for _ in range(COMPILED_STEPS):
        def step():
            opt.zero_grad(set_to_none=True)
            loss = lm.loss(tokens, targets)
            loss.backward()
            opt.step()
            return loss.detach()
        eager.append(timed(step))
    torch.cuda.synchronize()
    want = {n: p.detach().cpu() for n, p in lm.named_parameters()}
    eager_losses = [x[0].item() for x in eager]
    eager_ms = [a.elapsed_time(b) for _, (a, b), _ in eager[1:]]
    del lm, opt, eager
    gc.collect()
    torch.cuda.empty_cache()

    lm, opt = build()
    # one all-reduce per bucket and exchange group (expert or world)
    n_buckets = sum(len({opt._group_of[p] for p in b})
                    for b in opt.exchange_buckets)
    step = hvd.compiled_train_step(lm.loss, opt)
    stats = hvd.runtime.live_state().stats
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(fa)
    runs = [timed(lambda: step(tokens, targets))
            for _ in range(COMPILED_STEPS)]
    torch.cuda.synchronize()
    losses = [x[0].item() for x in runs]
    got = {n: p.detach().cpu() for n, p in lm.named_parameters()}
    deltas = {n: float((got[n] - want[n]).abs().max()) for n in want}
    differ = {n: deltas[n] for n in want if not torch.equal(got[n], want[n])}
    del want
    prog = next(iter(hvd.runtime.live_state().programs._programs.values()))
    jit0 = stats.counter("allreduce_jit")
    replay_launches0 = read_launches(fa)
    replays = [timed(lambda: step(tokens, targets)) for _ in range(REPLAYS)]
    torch.cuda.synchronize()
    launches = read_launches(fa)
    replay_counts = {k: (launches[k] - replay_launches0[k]) / REPLAYS
                     for k in launches}
    jit_calls = stats.counter("allreduce_jit") - jit0
    replay_ms = [a.elapsed_time(b) for _, (a, b), _ in replays]
    host_ms = [h * 1e3 for _, _, h in replays]
    losses += [x[0].item() for x in replays]
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(replay_ms))
    tok_s = batch * seq / (median / 1e3)
    fpt = flops_per_token(lm.params, cfg, seq)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"{label} losses: {' '.join(f'{x:.4f}' for x in losses)} "
          f"(eager {' '.join(f'{x:.4f}' for x in eager_losses)})", flush=True)
    print(f"{label} {batch} x {seq}, {n_params / 1e6:.1f} M "
          f"parameters [{where}]: step {median:.1f} ms (replay, median of "
          f"{REPLAYS}); {tok_s:.1f} tokens/s; {fpt / 1e9:.3f} GFLOP/token "
          f"(active); MFU {fpt * tok_s / PEAK_FLOPS[torch.bfloat16]:.4f} "
          f"against 989 TFLOP/s bf16; peak memory {peak / 2 ** 30:.2f} GiB",
          flush=True)
    print(f"{label} vs eager after {COMPILED_STEPS} steps: "
          f"{len(differ)} of {len(deltas)} parameters differ, max|d| "
          f"{max(deltas.values()):.3g}"
          + (f" (worst {max(differ, key=differ.get)})" if differ else ""),
          flush=True)
    print(f"{label} {batch} x {seq} [{where}]: replay "
          f"{np.median(replay_ms):.1f}"
          f" ms (median of {REPLAYS}; {' '.join(f'{t:.1f}' for t in replay_ms)})"
          f" against eager {np.median(eager_ms):.1f} ms (steps 2-"
          f"{COMPILED_STEPS} of the same optimizer); step() returns in "
          f"{np.median(host_ms):.3f} ms on the host; cache hits "
          f"{step.cache_hits} misses {step.cache_misses} fallbacks "
          f"{step.fallback_steps}; per replay {replay_counts}; "
          f"{jit_calls} allreduce_jit records in {REPLAYS} replays",
          flush=True)
    check(not differ, f"compiled parameters differ from eager: {differ}")
    check(losses[:COMPILED_STEPS] == eager_losses,
          f"losses {losses} vs eager {eager_losses}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: losses not finite or not falling: {losses}")
    check((step.cache_misses, step.fallback_steps) == (1, 0)
          and step.cache_hits == COMPILED_STEPS + REPLAYS - 1,
          f"cache {step.cache_hits}/{step.cache_misses}, fallbacks "
          f"{step.fallback_steps}")
    if per_replay is None:
        per_replay = dict.fromkeys(("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                                    "flash_bwd_dkv_wgmma"), cfg.n_layers)
    for name, n in replay_counts.items():
        want_n = per_replay.get(name, 0)
        check(n == want_n, f"{name}: {n} launches a replay, {want_n} "
                           "expected")
    check(len(prog.collectives) == n_buckets and jit_calls
          == REPLAYS * n_buckets,
          f"all-reduces a replay: {prog.collectives}, {jit_calls} records "
          f"in {REPLAYS} replays of {n_buckets} bucket(s)")
    if then is not None:
        then(lm, opt, step, tokens, targets, replay_counts)
    params = lm.params
    del step, prog, opt
    gc.collect()
    hvd.shutdown()
    os.environ.pop("HOROVOD_PROFILER_JIT_CALLBACKS")
    return launches, params, tokens, {"params": got, "step_ms": median,
                                      "tok_s": tok_s, "peak": peak}


# The phase trace (main path 15): steps traced a window, and its gates.
TRACE_STEPS = 4
TRACE_SUM_REL, TRACE_OTHER_MAX, TRACE_PHASE_REL = 0.01, 0.05, 0.10
TRACE_PHASE_FLOOR, TRACE_SERVE_MIN, TRACE_OVERHEAD_MAX = 0.01, 0.95, 0.01
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_device_us(trace_dir):
    """The device time (us) of every kernel, copy and set in a capture,
    summed straight from its kineto files: the phase join's yardstick."""
    total = 0.0
    for name in os.listdir(trace_dir):
        if name.endswith(".trace.json"):
            with open(os.path.join(trace_dir, name)) as f:
                events = json.load(f)["traceEvents"]
            total += sum(float(e.get("dur") or 0.0) for e in events
                         if e.get("ph") == "X"
                         and e.get("cat") in _DEVICE_CATS)
    return total


def check_trace(label, summary, trace_dir, steps, where, phases=None):
    """Print a traced window's device ms a step by phase, ``other``, its
    device time and ``exchange_hidden_frac``; hold the phases plus other
    to the capture's device time (TRACE_SUM_REL) and, for a step,
    ``other`` under TRACE_OTHER_MAX of it. Returns {phase: ms a step}."""
    check(summary is not None, f"{label}: the capture parsed to nothing")
    total_us = trace_device_us(trace_dir)
    got = summary["total_s"] * 1e6
    per = {p: v * 1e3 / steps for p, v in summary["phases"].items()}
    ex = summary.get("exchange")
    hidden = None if not ex else round(ex["hidden_frac"], 4)
    shown = {p: round(v, 3) for p, v in per.items() if v > 0 or p == "other"}
    lost = sum(g["lost"] for g in summary["graphs"].values())
    print(f"trace {label} [{where}]: device ms a step by phase {shown}; "
          f"device time {total_us / 1e3 / steps:.3f} ms a step over "
          f"{summary['events']} events ({summary['graph_events']} replayed, "
          f"{summary['unmatched']} unmatched, {lost} dropped by the "
          f"profiler) on {summary['lanes']} stream(s); "
          f"exchange_hidden_frac {hidden}", flush=True)
    check(abs(got - total_us) <= TRACE_SUM_REL * total_us,
          f"{label}: phases plus other {got:.1f} us against the capture's "
          f"device time {total_us:.1f} us")
    if phases == "step":
        check(per["other"] * 1e3 * steps <= TRACE_OTHER_MAX * total_us,
              f"{label}: other is {per['other']:.3f} ms of "
              f"{total_us / 1e3 / steps:.3f} ms a step")
        for name, want in (("flash_fwd_wgmma_kernel", "forward"),
                           ("flash_bwd_dq_wgmma_kernel", "backward"),
                           ("flash_bwd_dkv_wgmma_kernel", "backward")):
            where_ = {}
            for k, by in summary["kernels"].items():
                if name in k:
                    for ph, sec in by.items():
                        where_[ph] = where_.get(ph, 0.0) + sec
            check(where_ and set(where_) == {want},
                  f"{label}: {name} lands in {where_}, not {want} alone")
    return per


def phase_trace(hvd, fa, tfm, serve, metrics, card, where, untraced):
    """Main path 15: the phase trace (diag/xla_trace.py) of the flagship
    at 4 x 4096 with capturable AdamW under DistributedOptimizer:

    - a compiled step (warm-up and capture), an untraced replay (its
      launches by route kept), then ``hvd.trace_steps(4)`` over the next
      4 replays, ticked by the step, and one more replay: 7 steps, as
      the compiled train phase runs from the same seed. The traced
      replays' launches by route must equal the untraced one's, and the
      parameters after the 7 steps ``untraced`` (that phase's, on the
      card), bitwise;
    - on that model, 3 eager steps timed for the idle costs (the
      tracer's tick and phase ranges, the flight recorder's events; each
      under 1% of the loop), then ``trace_steps(4)`` over the eager
      step, ticked by ``TelemetryCallback``, its regions under the phase
      ranges as the compiled step's;
    - one graph serve round of the 8 requests, traced.

    Each window's phases plus ``other`` must equal the capture's device
    time within TRACE_SUM_REL; a step's ``other`` stays under
    TRACE_OTHER_MAX; the replay's phases above TRACE_PHASE_FLOOR of the
    step lie within TRACE_PHASE_REL of the eager step's; the flash
    kernels land in forward and backward alone; the serve round keeps
    TRACE_SERVE_MIN of its device time in prefill and decode. Returns
    {kernel: launches} of the compiled run."""
    from torch.profiler import record_function

    from horovod_tpu_torch.bench.resnet import (flight_attribution,
                                                trace_attribution)
    from horovod_tpu_torch.callbacks import TelemetryCallback
    from horovod_tpu_torch.diag import recorder
    diag_dir = tempfile.mkdtemp(prefix="chip-trace-")
    hvd.init(device=card)
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (TRAIN_BATCH, TRAIN_SEQ))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)
    lm = tfm.TransformerLM(cfg, seed0_params(tfm, cfg, card), device=card)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), capturable=True, **ADAMW),
        named_parameters=lm.named_parameters())
    step = hvd.compiled_train_step(lm.loss, opt)

    def replay_counts(calls):
        before = read_launches(fa)
        for _ in range(calls):
            step(tokens, targets)
        torch.cuda.synchronize()
        after = read_launches(fa)
        return {k: (after[k] - before[k]) / calls for k in after}

    zero_launches(fa)
    step(tokens, targets)
    plain = replay_counts(1)
    tracer = hvd.trace_steps(TRACE_STEPS, out_dir=diag_dir)
    traced = replay_counts(TRACE_STEPS + 1)
    launches = read_launches(fa)
    steps = 2 + TRACE_STEPS + 1
    check(steps == COMPILED_STEPS + REPLAYS, f"{steps} steps traced")
    differ = sum(not torch.equal(a, b) for a, b in zip(
        _leaves(lm.params), _leaves(untraced)))
    replay = check_trace("compiled replay", tracer.last_summary,
                         tracer.last_dir, TRACE_STEPS, where, "step")
    flops = step.flops_per_step
    print(f"trace compiled replay: launches a replay {traced} (untraced "
          f"{plain}); {differ} parameters differ from the untraced "
          f"run's after {steps} steps; {flops / 1e12:.3f} TFLOP a step "
          f"(FlopCounterMode and the flash kernels' own counts)",
          flush=True)
    check(traced == plain, f"traced replays launch {traced}, untraced "
                           f"{plain}")
    check(not differ, f"tracing changed {differ} parameters")

    def eager_step():
        opt.zero_grad(set_to_none=True)
        with record_function("hvd_forward"):
            loss = lm.loss(tokens, targets)
        with record_function("hvd_backward"):
            loss.backward()
        with record_function("hvd_optimizer"):
            opt.step()
        torch.cuda.synchronize()

    eager_step()
    flight = recorder.get()
    phase0, events0 = flight.phase_totals(), flight.events_recorded
    t0 = time.perf_counter()
    for _ in range(3):
        eager_step()
    loop_wall = time.perf_counter() - t0
    _, flight_frac = flight_attribution(flight, phase0, events0, loop_wall, 3)
    trace_frac = trace_attribution(loop_wall, 3)  # 5 phase ranges a step
    step_ms = loop_wall / 3 * 1e3
    tracer = hvd.trace_steps(TRACE_STEPS, out_dir=diag_dir)
    cb = TelemetryCallback(batch_size=TRAIN_BATCH, skew_interval=0)
    for i in range(TRACE_STEPS + 1):
        cb.on_batch_begin(i)
        eager_step()
        cb.on_batch_end(i)
    check(not tracer.active and tracer.captures == 2,
          f"the eager window did not close: {tracer.captures} captures")
    eager = check_trace("eager step", tracer.last_summary, tracer.last_dir,
                        TRACE_STEPS, where, "step")
    mfu = flops / (step_ms / 1e3 * PEAK_FLOPS[torch.bfloat16])
    print(f"trace flagship step [{where}]: {step_ms:.1f} ms eager, "
          f"flops_per_step {flops:.6g}, MFU {mfu:.4f} against 989 TFLOP/s "
          f"bf16; idle costs over the loop: trace_overhead_frac "
          f"{trace_frac:.6f}, flight_overhead_frac {flight_frac:.6f}",
          flush=True)
    check(trace_frac < TRACE_OVERHEAD_MAX and flight_frac
          < TRACE_OVERHEAD_MAX, f"idle costs {trace_frac}, {flight_frac}")
    total = sum(eager.values())
    for ph, ms in eager.items():
        if ph != "other" and ms > TRACE_PHASE_FLOOR * total:
            check(abs(replay[ph] - ms) <= TRACE_PHASE_REL * ms,
                  f"{ph}: replay {replay[ph]:.3f} ms against eager "
                  f"{ms:.3f} ms a step")
    del lm, opt, step, untraced
    gc.collect()
    torch.cuda.empty_cache()

    serve_cfg = tfm.TransformerConfig(dtype=torch.bfloat16,
                                      attention_impl="flash", **FLAGSHIP)
    lm = tfm.TransformerLM(serve_cfg, seed0_params(tfm, serve_cfg, card),
                           device=card)
    with step_program("1"):
        engine = serve.Engine(lm, lm.params, page_size=PAGE_SIZE,
                              max_batch=N_REQUESTS, start=False,
                              device=card)
        serve_round(engine, metrics, lm.cfg.vocab_size)
        tracer = hvd.trace_steps(1, out_dir=diag_dir)
        tracer.tick(owner=phase_trace)
        serve_round(engine, metrics, lm.cfg.vocab_size)
        tracer.tick(owner=phase_trace)
        engine.close()
    summary = tracer.last_summary
    served = check_trace("graph serve round", summary, tracer.last_dir, 1,
                         where)
    share = (served["prefill"] + served["decode"]) / sum(served.values())
    print(f"trace graph serve round: prefill and decode hold {share:.4f} "
          f"of its device time", flush=True)
    check(share >= TRACE_SERVE_MIN, f"serve round: {share:.4f} in prefill "
                                    f"and decode")
    del engine, lm
    gc.collect()
    hvd.shutdown()
    torch.cuda.empty_cache()
    shutil.rmtree(diag_dir, ignore_errors=True)
    return launches


# Pipeline parallelism: the flagship's 8 layers over a local pp axis of
# 4 stages (2 layers a stage, 1 a chunk interleaved at V 2), the
# training batch 4 x 4096 in 4 microbatches of 1 x 4096.
PP_STAGES, PP_MICROBATCHES, PP_STEPS = 4, 4, 3


def _pp_want(tfm, grads, cfg, interleave=1):
    """The unpipelined gradients (``_flat_grads`` names) in the stacked
    layout's names and shapes (layer (c*S + s)*L' + l at [c, s, l])."""
    want = {k: g for k, g in grads.items() if not k.startswith("layers.")}
    for k in {n.split(".", 2)[2] for n in grads if n.startswith("layers.")}:
        g = torch.stack([grads[f"layers.{i}.{k}"]
                         for i in range(cfg.n_layers)])
        if interleave > 1:
            g = g.reshape((interleave, PP_STAGES, -1) + tuple(g.shape[1:]))
        want[f"layers.{k}"] = g
    return want


def _pp_run(tfm, fa, cfg, stacked, tokens, targets, schedule, interleave=1):
    """(loss, {name: gradient}, launches, peak above the allocation
    before) of one pipelined loss and backward over the local pp axis:
    GPipe under autograd, or 1F1B's own gradients."""
    from horovod_tpu_torch.parallel.ring_attention import RingAxis
    pp = RingAxis.local(PP_STAGES)
    for t in tfm._leaves(stacked):
        t.grad = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(fa)
    if schedule == "gpipe":
        loss = tfm.pipeline_loss_fn(stacked, tokens, targets, cfg,
                                    num_microbatches=PP_MICROBATCHES, pp=pp)
        loss.backward()
        grads = {k: t.grad for k, t in tfm._named_leaves(stacked)}
    else:
        loss, tree = tfm.pipeline_value_and_grad_1f1b(
            stacked, tokens, targets, cfg, num_microbatches=PP_MICROBATCHES,
            pp=pp, interleave=interleave)
        grads = dict(tfm._named_leaves(tree))
    torch.cuda.synchronize()
    return (loss.item(), grads, read_launches(fa),
            torch.cuda.max_memory_allocated() - base)


def pp_launches(cfg, schedule):
    """One pipelined step's launches of each static kernel on the tensor
    cores, by the port's rule (parallel/pipeline.py: inactive slots
    skipped): every (stage, microbatch) runs its layers' forward once
    under GPipe, twice under 1F1B (the forward phase and the backward
    phase's recompute), and their backward once."""
    fwd = cfg.n_layers * PP_MICROBATCHES
    return {"flash_fwd_wgmma": fwd * (1 if schedule == "gpipe" else 2),
            "flash_bwd_dq_wgmma": fwd, "flash_bwd_dkv_wgmma": fwd}


def phase_pipeline(fa, tfm, card, where):
    """Main path 14: the flagship over a local pp axis of PP_STAGES on
    this card, batch 4 x 4096 in PP_MICROBATCHES microbatches, loss
    chunk 512. Parity: GPipe (``pipeline_loss_fn`` under autograd), 1F1B
    at V 1 and at V 2 (one layer a chunk) against the unpipelined
    ``loss_fn`` on one batch (loss within TRAIN_LOSS_ATOL, every
    gradient within TRAIN_GRAD_REL), and a small f32 model's three
    within SMALL_GRAD_ATOL. Then PP_STEPS AdamW steps of the
    unpipelined model, of GPipe and of 1F1B from the same weights, each
    loss falling, with step times (a local schedule on one card, not a
    PP speed), peak memory (1F1B's below GPipe's) and each pipelined
    step's launches exactly as ``pp_launches`` says. Returns ({kernel:
    launches} of GPipe's steps, of 1F1B's)."""
    from horovod_tpu_torch.parallel.ring_attention import RingAxis
    rng = np.random.default_rng(6)
    small = dict(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2,
                 n_layers=8, d_ff=256, max_seq=128, positional="rope")
    for label, kw, batch, seq, dtype in (
            ("full width 4 x 4096", FLAGSHIP, TRAIN_BATCH, TRAIN_SEQ,
             torch.bfloat16),
            ("small f32", small, 4, 128, torch.float32)):
        cfg = tfm.TransformerConfig(dtype=dtype, attention_impl="flash",
                                    loss_chunk=min(LOSS_CHUNK, seq), **kw)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (batch, seq))).to(card)
        targets = torch.roll(tokens, -1, dims=1)
        params = tfm.init_params(cfg, torch.Generator().manual_seed(7), card)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ref_loss, g = _loss_and_grads(tfm, params, cfg, tokens, targets)
        ref_peak = torch.cuda.max_memory_allocated() - base
        grads = {k: v.float().clone() for k, v in g.items()}
        del g
        for t in _leaves(params):
            t.grad = None
            t.requires_grad_(False)
        peaks = {"unpipelined": ref_peak}
        for name, schedule, v in (("gpipe", "gpipe", 1), ("1f1b", "1f1b", 1),
                                  ("1f1b V 2", "1f1b", 2)):
            stacked = tfm.stack_pipeline_params(params, interleave=v,
                                                num_stages=PP_STAGES)
            for t in tfm._leaves(stacked):
                t.requires_grad_()
            loss, got, launches, peaks[name] = _pp_run(
                tfm, fa, cfg, stacked, tokens, targets, schedule, v)
            want = _pp_want(tfm, grads, cfg, v)
            dl = abs(loss - ref_loss)
            head = (f"parity pp {label} {name} vs unpipelined: loss "
                    f"{loss:.6f} vs {ref_loss:.6f} (|d|={dl:.3g})")
            if dtype == torch.float32:
                err = max((got[k].float() - want[k]).abs().max().item()
                          for k in want)
                print(f"{head}; max|dgrad|={err:.3g} (tol "
                      f"{SMALL_GRAD_ATOL:g})", flush=True)
                check(err <= SMALL_GRAD_ATOL and dl <= SMALL_GRAD_ATOL,
                      f"small f32 pipeline {name} disagrees with loss_fn")
            else:
                rel = _rel_l2({k: got[k].float() for k in want}, want)
                worst = max(rel, key=rel.get)
                print(f"{head} (tol {TRAIN_LOSS_ATOL:g}); gradient relative "
                      f"L2 worst {rel[worst]:.4g} at {worst} (tol "
                      f"{TRAIN_GRAD_REL:g}), median "
                      f"{float(np.median(list(rel.values()))):.4g}; peak "
                      f"above the weights {peaks[name] / 2 ** 30:.2f} GiB "
                      f"(unpipelined {ref_peak / 2 ** 30:.2f}); launches "
                      f"{launches}", flush=True)
                check(dl <= TRAIN_LOSS_ATOL,
                      f"pipeline {name} loss disagrees with loss_fn")
                check(rel[worst] <= TRAIN_GRAD_REL,
                      f"pipeline {name} gradients disagree with loss_fn")
                want_n = pp_launches(cfg, schedule)
                check(all(launches[k] == want_n.get(k, 0) for k in launches),
                      f"pipeline {name} launches {launches}, {want_n} "
                      "expected")
            del stacked, got, want
        del params, grads
        torch.cuda.empty_cache()

    # ---- training: PP_STEPS AdamW steps of each schedule
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (TRAIN_BATCH, TRAIN_SEQ))).to(card)
    targets = torch.roll(tokens, -1, dims=1)
    init = seed0_host(tfm, cfg)
    stats, paths = {}, {}
    for schedule in ("unpipelined", "gpipe", "1f1b"):
        params = to_card(init, card)
        if schedule != "unpipelined":
            params = tfm.stack_pipeline_params(params,
                                               num_stages=PP_STAGES)
        leaves = list(tfm._leaves(params))
        for t in leaves:
            t.requires_grad_()
        opt = torch.optim.AdamW(leaves, **ADAMW)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(fa)
        losses, events = [], []
        for _ in range(PP_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            opt.zero_grad(set_to_none=True)
            if schedule == "1f1b":
                loss, tree = tfm.pipeline_value_and_grad_1f1b(
                    params, tokens, targets, cfg,
                    num_microbatches=PP_MICROBATCHES,
                    pp=RingAxis.local(PP_STAGES))
                for (_, t), (_, g) in zip(tfm._named_leaves(params),
                                          tfm._named_leaves(tree)):
                    t.grad = g
                del tree
            else:
                if schedule == "gpipe":
                    loss = tfm.pipeline_loss_fn(
                        params, tokens, targets, cfg,
                        num_microbatches=PP_MICROBATCHES,
                        pp=RingAxis.local(PP_STAGES))
                else:
                    loss = tfm.loss_fn(params, tokens, targets, cfg)
                loss.backward()
            opt.step()
            end.record()
            events.append((start, end))
            losses.append(loss.detach())
        torch.cuda.synchronize()
        launches = read_launches(fa)
        losses = [x.item() for x in losses]
        step_ms = [a.elapsed_time(b) for a, b in events]
        peak = torch.cuda.max_memory_allocated()
        stats[schedule] = (step_ms, peak)
        print(f"pp train {schedule} [{where}] (a local schedule of "
              f"{PP_STAGES} stages on one card, beside the launcher phase: "
              f"not a speed): 4 x 4096 "
              f"in {PP_MICROBATCHES} microbatches, steps "
              f"{' '.join(f'{t:.1f}' for t in step_ms)} ms, losses "
              f"{' '.join(f'{x:.4f}' for x in losses)}, peak memory "
              f"{peak / 2 ** 30:.2f} GiB; launches {launches}", flush=True)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"pp train {schedule}: losses not finite or not falling: "
              f"{losses}")
        if schedule != "unpipelined":
            want_n = {k: PP_STEPS * n
                      for k, n in pp_launches(cfg, schedule).items()}
            check(all(launches[k] == want_n.get(k, 0) for k in launches),
                  f"pp train {schedule} launches {launches}, {want_n} "
                  "expected")
            paths[schedule] = launches
        del params, leaves, opt
        gc.collect()
        torch.cuda.empty_cache()
    stash_mib = (2 * PP_STAGES - 1) * TRAIN_SEQ * cfg.d_model * 2 / 2 ** 20
    gib = {k: v[1] / 2 ** 30 for k, v in stats.items()}
    print(f"pp train peaks: unpipelined {gib['unpipelined']:.2f} GiB, GPipe "
          f"{gib['gpipe']:.2f} GiB, 1F1B {gib['1f1b']:.2f} GiB (a stage "
          f"stashes at most "
          f"{2 * PP_STAGES - 1} inputs of 1 x {TRAIN_SEQ} x {cfg.d_model} "
          f"bf16, {stash_mib:.0f} MiB); 1F1B below GPipe: "
          f"{stats['1f1b'][1] < stats['gpipe'][1]}", flush=True)
    check(stats["1f1b"][1] < stats["gpipe"][1],
          "1F1B's peak memory is not below GPipe's")
    return paths["gpipe"], paths["1f1b"]


ZERO_STAGES = (1, 2, 3)
# Each stage's peak memory at 4 x 4096 when it ran in a session of its
# own (GiB; this phase before the stages shared a session, on an NVIDIA
# H100 80GB HBM3 at 700 W): in one session a stage may not read more
# than ZERO_PEAK_SLACK_GIB above it, as it did while dropped steps stayed
# in the program cache (+9.1 GiB a stage).
ZERO_SESSION_PEAK_GIB = {1: 25.89, 2: 25.96, 3: 26.02}
ZERO_PEAK_SLACK_GIB = 0.5


def phase_zero_train(hvd, fa, tfm, metrics, card, where, stage0):
    """Main path 9: the flagship at 4 x 4096 through
    ``DistributedOptimizer(AdamW(..., capturable=True), zero_stage=s)``
    for s in 1, 2, 3, one rank: COMPILED_STEPS eager steps, then
    COMPILED_STEPS compiled steps and REPLAYS replays from the same start
    (seed 0, drawn once on the host). The parameters after
    COMPILED_STEPS steps must equal, bit for bit, both the eager run's
    and stage 0's compiled run's (``stage0``, from
    :func:`phase_compiled_train`: at one rank the scatter and the gather
    are copies, the division is by 1 and AdamW is elementwise); zero3's
    are read through ``unshard_params``, and its
    ``unshard_params(shard_params(p))`` must be ``p``. Each stage: 1
    cache miss, 0 fallbacks, per replay 8 launches of each static kernel
    on the tensor-core route and one ``reducescatter_jit`` and one
    ``allgather_jit`` a chunk. Prints step time, tokens/s, peak memory
    and the ``hvd_zero_stripe_bytes`` gauges beside stage 0's. The three
    stages run in one session: a dropped step's program leaves the
    session's cache with its model and optimizer, so each stage's peak
    must lie within ZERO_PEAK_SLACK_GIB of the peak it reached in a
    session of its own (ZERO_SESSION_PEAK_GIB). Returns ({kernel:
    launches} of the compiled steps, summed over the stages, and for
    :func:`phase_zero_guard` the weights, the batch and each stage's
    stripe (and parameters below stage 3) after GUARD_STEPS steps and
    its replay median)."""
    print("zero train: no staged step on this card: two DCN stages need "
          "two ranks at least and NCCL refuses two ranks on one card, so "
          "the staged exchange and its bf16/int8 hops are checked on the "
          "CPU over gloo only (tests/test_torch_zero.py, "
          "tests/test_torch_sharding_spec.py)", flush=True)
    os.environ["HOROVOD_PROFILER_JIT_CALLBACKS"] = "1"
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    init = seed0_host(tfm, cfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (TRAIN_BATCH, TRAIN_SEQ))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)
    total = {}

    def build(stage):
        lm = tfm.TransformerLM(cfg, to_card(init, card), device=card)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(lm.parameters(), capturable=True, **ADAMW),
            named_parameters=lm.named_parameters(), zero_stage=stage)
        return lm, opt

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = fn()
        end.record()
        return loss, (start, end)

    hvd.init(device=card)
    stats = hvd.runtime.live_state().stats
    plain = {"init": init, "tokens": tokens, "targets": targets}
    for stage in ZERO_STAGES:
        t0 = time.perf_counter()
        lm, opt = build(stage)
        eager_losses = []
        for _ in range(COMPILED_STEPS):
            opt.zero_grad(set_to_none=True)
            loss = lm.loss(tokens, targets)
            loss.backward()
            opt.step()
            eager_losses.append(loss.detach())
        want = {n: p.detach().cpu() for n, p in lm.named_parameters()}
        eager_losses = [x.item() for x in eager_losses]
        del lm, opt, loss
        gc.collect()
        torch.cuda.empty_cache()

        lm, opt = build(stage)
        names = [n for n, _ in lm.named_parameters()]
        step = hvd.compiled_train_step(lm.loss, opt)
        if stage == 3:
            start = [p.detach().clone() for p in lm.parameters()]
            back = step.unshard_params(step.shard_params())
            check(all(torch.equal(a, b) for a, b in zip(start, back)),
                  "zero3: unshard_params(shard_params(p)) != p")
            del start, back
        chunks = len(opt.exchange_buckets)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(fa)
        runs = [timed(lambda: step(tokens, targets))
                for _ in range(COMPILED_STEPS)]
        torch.cuda.synchronize()
        losses = [x[0].item() for x in runs]
        now = (step.unshard_params() if stage == 3
               else [p.detach() for p in lm.parameters()])
        got = {n: t.cpu() for n, t in zip(names, now)}
        del now
        vs_eager = [n for n in names if not torch.equal(got[n], want[n])]
        vs_stage0 = [n for n in names
                     if not torch.equal(got[n], stage0["params"][n])]
        del got, want
        prog = list(hvd.runtime.live_state().programs._programs.values())[-1]
        rs0, ag0 = (stats.counter("reducescatter_jit"),
                    stats.counter("allgather_jit"))
        launches0 = read_launches(fa)
        replays = []
        for i in range(REPLAYS):
            replays.append(timed(lambda: step(tokens, targets)))
            if COMPILED_STEPS + i + 1 == GUARD_STEPS:
                # the state after 1 + 4 steps, which the guarded stage
                # must reach bit for bit (phase_zero_guard); host copies,
                # so the peak below does not move
                plain[stage] = {"stripe": opt.stripe.detach().cpu(),
                                "params": None if stage == 3 else
                                [p.detach().cpu() for p in lm.parameters()]}
        torch.cuda.synchronize()
        launches = read_launches(fa)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        per_replay = {k: (launches[k] - launches0[k]) / REPLAYS
                      for k in launches}
        rs = (stats.counter("reducescatter_jit") - rs0) / REPLAYS
        ag = (stats.counter("allgather_jit") - ag0) / REPLAYS
        losses += [x[0].item() for x in replays]
        replay_ms = [a.elapsed_time(b) for _, (a, b) in replays]
        median = float(np.median(replay_ms))
        plain[stage]["step_ms"] = median
        peak = torch.cuda.max_memory_allocated()
        gauges = metrics.ZERO_STRIPE_BYTES.collect()
        stripe = opt.stripe.numel()
        print(f"zero{stage} train {TRAIN_BATCH} x {TRAIN_SEQ} [{where}]: "
              f"step {median:.1f} ms (replay, median of {REPLAYS}; "
              f"{' '.join(f'{t:.1f}' for t in replay_ms)}) against stage "
              f"0's {stage0['step_ms']:.1f} ms; "
              f"{TRAIN_BATCH * TRAIN_SEQ / (median / 1e3):.1f} tokens/s "
              f"against {stage0['tok_s']:.1f}; peak memory "
              f"{peak / 2 ** 30:.2f} GiB against "
              f"{stage0['peak'] / 2 ** 30:.2f} GiB; stripe {stripe} elements in {chunks} chunk(s); "
              f"hvd_zero_stripe_bytes {gauges}; per replay {per_replay}, "
              f"{rs} reducescatter_jit and {ag} allgather_jit records; "
              f"cache hits {step.cache_hits} misses {step.cache_misses} "
              f"fallbacks {step.fallback_steps}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        print(f"zero{stage} train losses: "
              f"{' '.join(f'{x:.4f}' for x in losses)} (eager "
              f"{' '.join(f'{x:.4f}' for x in eager_losses)}); after "
              f"{COMPILED_STEPS} steps {len(vs_eager)} of {len(names)} "
              f"parameters differ from eager, {len(vs_stage0)} from stage "
              "0", flush=True)
        check(not vs_eager, f"zero{stage}: compiled differs from eager: "
                            f"{vs_eager}")
        check(not vs_stage0, f"zero{stage}: differs from stage 0: "
                             f"{vs_stage0}")
        check(losses[:COMPILED_STEPS] == eager_losses,
              f"zero{stage}: losses {losses} vs eager {eager_losses}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"zero{stage}: losses not finite or not falling: {losses}")
        check((step.cache_misses, step.fallback_steps) == (1, 0)
              and step.cache_hits == COMPILED_STEPS + REPLAYS - 1,
              f"zero{stage}: cache {step.cache_hits}/{step.cache_misses}, "
              f"fallbacks {step.fallback_steps}")
        for name, n in per_replay.items():
            want_n = cfg.n_layers if name in (
                "flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                "flash_bwd_dkv_wgmma") else 0
            check(n == want_n, f"zero{stage} {name}: {n} launches a "
                               f"replay, {want_n} expected")
        ops = sorted(op for op, _ in prog.collectives)
        check(ops == ["allgather_jit"] * chunks
              + ["reducescatter_jit"] * chunks and rs == ag == chunks,
              f"zero{stage}: a replay records {ops}; {rs}/{ag} a replay, "
              f"{chunks} chunk(s)")
        check(gauges['kind="grads"'] == stripe * 4
              and gauges['kind="params"'] == (stripe * 4 if stage == 3
                                              else 0)
              and gauges['kind="opt"'] == 2 * stripe * 4 + 4,
              f"zero{stage}: gauges {gauges} for a stripe of {stripe}")
        alone = ZERO_SESSION_PEAK_GIB[stage]
        print(f"zero{stage} peak in one session with the earlier stages: "
              f"{peak / 2 ** 30:.2f} GiB against {alone:.2f} GiB in a "
              f"session of its own (slack {ZERO_PEAK_SLACK_GIB} GiB); "
              f"programs cached {len(hvd.runtime.live_state().programs)}",
              flush=True)
        check(abs(peak / 2 ** 30 - alone) <= ZERO_PEAK_SLACK_GIB,
              f"zero{stage}: peak {peak / 2 ** 30:.2f} GiB in one session, "
              f"{alone:.2f} GiB alone")
        del step, prog, opt, lm
        gc.collect()
        torch.cuda.empty_cache()
        check(len(hvd.runtime.live_state().programs) == 0,
              f"zero{stage}: the dropped step's program is still cached")
    hvd.shutdown()
    del init
    os.environ.pop("HOROVOD_PROFILER_JIT_CALLBACKS")
    return total, plain


# The guard over a ZeRO stripe (main path zero_guard): each stage's
# compiled step under HOROVOD_GUARD=1, 1 + 4 healthy calls, then one
# whose backward the chaos spec seeds with NaN.
ZERO_GUARD_INJECT = "nan,name=zero.guard,step=5"


def _zero_gated(lm, opt, stage):
    """Card copies of what a skipped ZeRO step must keep: the stripe,
    AdamW's state over it, and the parameters unless the stripe is
    resident (zero3 gathers them anew each step)."""
    out = [opt.stripe.detach().clone()] + [
        v.clone() for _, v in sorted(opt.state[opt.stripe].items())]
    if stage != 3:
        out += [p.detach().clone() for p in lm.parameters()]
    return out


def phase_zero_guard(hvd, fa, tfm, card, where, plain):
    """Main path zero_guard: the flagship at 4 x 4096 through the
    compiled ``DistributedOptimizer(AdamW, zero_stage=s)`` step under
    HOROVOD_GUARD=1 for s in 1, 2, 3, one rank, from the zero train
    phase's weights and batch (``plain``): 1 + 4 healthy calls, then a
    call whose backward the chaos spec seeds with NaN. Gates: after the
    healthy calls the stripe (and, below zero3, every parameter) equals
    the unguarded run's after as many steps bit for bit (at one rank
    that run equals stage 0's, checked in the zero train phase); the NaN
    call is skipped with the stripe, AdamW's state and the parameters
    bitwise unchanged; one health row a step; 1 cache miss, 0
    fallbacks; every flash launch on the tensor-core route. Prints
    ``guard_overhead_frac`` a stage: the replay median (CUDA events
    around the call, as the zero train phase times the unguarded
    replays; the guarded call reads the previous step's row first)
    against the unguarded one. Returns ({kernel: launches}, row)."""
    print("zero guard: no guarded spec or staged DCN step on this card: "
          "they need two ranks at least and NCCL refuses two ranks on one "
          "card, so the guard over a sharding spec and over the staged "
          "exchange is checked on the CPU over gloo only "
          "(tests/test_torch_zero_guard.py)", flush=True)
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    tokens, targets = plain["tokens"], plain["targets"]
    row = {}

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        return start, end

    os.environ.update(HOROVOD_GUARD="1", HOROVOD_GUARD_INJECT=ZERO_GUARD_INJECT)
    try:
        hvd.init(device=card)
        zero_launches(fa)
        for stage in ZERO_STAGES:
            t0 = time.perf_counter()
            lm = tfm.TransformerLM(cfg, to_card(plain["init"], card),
                                   device=card)
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(lm.parameters(), capturable=True,
                                  **ADAMW),
                named_parameters=lm.named_parameters(), zero_stage=stage)
            step = hvd.compiled_train_step(lm.loss, opt,
                                           name=f"zero.guard.{stage}")
            if stage == 3:
                step.shard_params()
            runs = [timed(lambda: step(tokens, targets))
                    for _ in range(GUARD_STEPS)]
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in runs[WARMUP_STEPS:]]
            median = float(np.median(ms))
            want = plain[stage]
            stripe_same = torch.equal(opt.stripe.detach().cpu(),
                                      want["stripe"])
            differ = 0 if want["params"] is None else sum(
                not torch.equal(p.detach().cpu(), w)
                for p, w in zip(lm.parameters(), want["params"]))
            check(stripe_same and differ == 0,
                  f"zero{stage} guard: after {GUARD_STEPS} healthy steps "
                  f"the stripe equals the unguarded run's: {stripe_same}; "
                  f"{differ} parameters differ")
            check(opt.guard_health.shape == (1, 2),
                  f"zero{stage} guard: rows {tuple(opt.guard_health.shape)}")
            before = _zero_gated(lm, opt, stage)
            step(tokens, targets)                  # the NaN call
            torch.cuda.synchronize()
            kept = all(torch.equal(a, b) for a, b in
                       zip(before, _zero_gated(lm, opt, stage)))
            del before
            verdict = step.finish()
            check(kept, f"zero{stage} guard: the skipped step changed the "
                        "stripe, AdamW's state or a parameter")
            check(verdict["action"] == "skip",
                  f"zero{stage} guard: the NaN step's verdict {verdict}")
            check((step.cache_misses, step.fallback_steps) == (1, 0),
                  f"zero{stage} guard: {step.cache_misses} misses, "
                  f"{step.fallback_steps} fallbacks")
            frac = median / want["step_ms"] - 1.0
            row[f"zero{stage}"] = {"guard_ms": median,
                                   "plain_ms": want["step_ms"],
                                   "guard_overhead_frac": frac}
            print(f"zero{stage} guard 4 x 4096 [{where}]: step {median:.1f} "
                  f"ms (replay, median of {TIMED_STEPS}; "
                  f"{' '.join(f'{t:.1f}' for t in ms)}) against "
                  f"{want['step_ms']:.1f} unguarded: guard_overhead_frac "
                  f"{frac:.4f} (stage 0: 0.0165-0.0221); healthy stripe "
                  f"bitwise the unguarded one's; NaN skipped with the "
                  f"stripe, AdamW's state and the parameters bitwise kept; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            del step, opt, lm
            gc.collect()
            torch.cuda.empty_cache()
        launches = read_launches(fa)
    finally:
        hvd.shutdown()
        for k in ("HOROVOD_GUARD", "HOROVOD_GUARD_INJECT"):
            os.environ.pop(k, None)
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[k] == 0, f"{k}: the zero guard runs took the loop")
    calls = len(ZERO_STAGES) * (GUARD_STEPS + 1)
    for k in ("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
              "flash_bwd_dkv_wgmma"):
        check(launches[k] == calls * cfg.n_layers,
              f"{k}: {launches[k]} launches over {calls} guarded calls")
    return launches, row


# Tensor parallelism on one card: two processes, one model group, joined
# by gloo (NCCL refuses two ranks on one card; gloo moves card tensors
# through the host). The flagship at full width, each rank holding half
# of every head, FFN and vocabulary stripe: H 8 / H_kv 2 a rank. Serving
# the 8 requests above; training at B 1 x 4096, one step checked against
# the unsharded model and TP_STEPS more AdamW steps.
TP_RANKS, TP_BATCH, TP_STEPS = 2, 1, 3
TP_TIMEOUT_S = 900
# A top-2 gap of the unsharded logits at or below which a bf16 argmax is
# left to the rounding: TP sums ``wo`` and ``w2`` over heads and columns
# in another order, and the bf16 residual carries that. Fixed between
# the largest gap an H100 run flipped at (0.015) and the smallest twice
# a flipped row's max|d| (0.0586); at f32 the tokens must be identical.
TP_NEAR_TIE = 2.0 ** -5


def _gloo_carries_cuda(dist, card):
    """gloo's all_reduce, all_gather and broadcast on card tensors, each
    against its answer on both ranks."""
    r = dist.get_rank()
    x = torch.full((4,), float(r + 1), device=card)
    dist.all_reduce(x)
    parts = [torch.empty(2, device=card) for _ in range(TP_RANKS)]
    dist.all_gather(parts, torch.full((2,), float(r), device=card))
    b = torch.full((3,), float(r + 7), device=card)
    dist.broadcast(b, src=0)
    return (x.tolist() == [3.0] * 4 and b.tolist() == [7.0] * 3
            and [p.tolist() for p in parts] == [[0.0, 0.0], [1.0, 1.0]])


def _tp_greedy(eng):
    """The 8 greedy requests through a batcher on ``eng``: (streams,
    wall seconds, scheduler steps)."""
    from horovod_tpu_torch.serve.scheduler import ContinuousBatcher, Request
    batcher = ContinuousBatcher(eng, max_batch=N_REQUESTS)
    reqs = [Request(p, NEW_TOKENS) for p in prompts(eng.cfg.vocab_size)]
    for q in reqs:
        batcher.submit(q)
    t0 = time.perf_counter()
    batcher.drain()
    return [q.generated for q in reqs], time.perf_counter() - t0, \
        batcher.steps


def _tp_teacher_forced(eng, streams):
    """The logits rows (NEW_TOKENS, 8, V) of the 8 prompts' prefill and
    of NEW_TOKENS - 1 decode steps fed ``streams``, and the prefill's
    time (ms); the pages freed after."""
    ids = list(range(N_REQUESTS))
    for sid in ids:
        eng.cache.allocate(sid, PROMPT_LEN + NEW_TOKENS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = [eng.prefill(ids, prompts(eng.cfg.vocab_size))]
    prefill_ms = (time.perf_counter() - t0) * 1e3
    for i in range(NEW_TOKENS - 1):
        rows.append(eng.decode(ids, [s[i] for s in streams],
                               [PROMPT_LEN + i] * N_REQUESTS))
    for sid in ids:
        eng.cache.free(sid)
    return np.stack(rows), prefill_ms


def _tp_serve_checks(rows, ref_rows, tokens, streams):
    """The TP engine against the unsharded one: ``(ok, message)`` pairs.
    Teacher-forced on the unsharded greedy streams, every logit lies
    within LOGITS_ATOL, and the argmax agrees wherever the unsharded
    row's top-2 gap exceeds TP_NEAR_TIE; each free-running TP stream
    equals the unsharded one up to its first difference, and that
    difference is one of those near-ties, teacher-forced."""
    diff = np.abs(rows - ref_rows)
    got, want = rows.argmax(-1), ref_rows.argmax(-1)
    top2 = np.sort(ref_rows, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    row_d = diff.max(-1)
    flips = list(zip(*np.nonzero(got != want)))
    decided = [(int(p), int(i)) for p, i in flips if gap[p, i] > TP_NEAR_TIE]
    first = [next((p for p, (a, b) in enumerate(zip(t, s)) if a != b), None)
             for t, s in zip(tokens, streams)]
    unexplained = [(i, p) for i, p in enumerate(first) if p is not None
                   and (got[p, i] == want[p, i] or got[p, i] != tokens[i][p])]
    print(f"tp serve vs unsharded, teacher-forced on its 8 x {NEW_TOKENS} "
          f"greedy tokens: logits max|d| {float(diff.max()):.4g} (tol "
          f"{LOGITS_ATOL:g}; prefill {float(diff[0].max()):.4g}); argmax "
          f"differs at {len(flips)} of {got.size} positions, top-2 gaps "
          f"{[round(float(gap[p, i]), 4) for p, i in flips]} (near-tie at "
          f"<= {TP_NEAR_TIE:g}; the rows' max|d| "
          f"{[round(float(row_d[p, i]), 4) for p, i in flips]}); "
          f"free-running streams identical {first.count(None)} of "
          f"{len(first)} (first difference at {first})", flush=True)
    return [(np.isfinite(rows).all() and float(diff.max()) <= LOGITS_ATOL,
             "tp logits disagree with the unsharded engine's"),
            (not decided, f"tp argmax differs where the unsharded choice "
                          f"is clear: {decided}"),
            (not unexplained, f"tp streams diverge where teacher forcing "
                              f"agrees: {unexplained}")]


# The f32 leg of TP training: the gathered gradients against the
# unsharded f32 model's differ by the f32 sums' order only (the wo and w2
# psums add two halves where the unsharded product adds one row).
TP_F32_GRAD_REL = 1e-4


def _tp_grad_rel(dist, tfm, grads, specs, tp, rank, want):
    """{leaf: relative L2} on rank 0 of the rank's gradients gathered
    over the model group against ``want`` (the unsharded model's, by
    name, on the host): a model leaf's gradient is tp times its block of
    the unsharded one (the reference's psum transposes to a psum), a
    replicated leaf's the unsharded gradient itself. Collective."""
    rel = {}
    spec_of = dict(tfm._named_leaves(specs))
    for k, g in grads.items():
        if "model" in spec_of[k]:
            parts = [torch.empty_like(g) for _ in range(TP_RANKS)]
            dist.all_gather(parts, g.contiguous(), group=tp)
            g = torch.cat(parts, spec_of[k].index("model")) / TP_RANKS
        if rank == 0:
            w = want[k].float()
            g = g.float().cpu()
            rel[k] = float((g - w).norm() / w.norm().clamp_min(1e-30))
    return rel


def tp_worker(rank, port, out_path):
    """One rank of the TP phase (``chip_smoke.py --tp-rank R PORT OUT``):
    joins the gloo group, checks that gloo carries card tensors, then
    ``hvd.init()`` takes the group and builds the model mesh
    (HOROVOD_MODEL_PARALLEL=2; programs eager, HOROVOD_STEP_PROGRAM=0: a
    gloo collective cannot be captured). Rank 0 also runs the unsharded
    model for the comparisons and writes the results to ``out_path``."""
    import torch.distributed as dist
    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    os.environ.update(HOROVOD_MODEL_PARALLEL=str(TP_RANKS),
                      HOROVOD_STEP_PROGRAM="0", HOROVOD_PROFILER_DISABLE="1")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=TP_RANKS)
    check(_gloo_carries_cuda(dist, card),
          "gloo does not carry card tensors for all_reduce, all_gather "
          "and broadcast: the TP phase cannot run on one card")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serve.engine import ServeEngine
    hvd.init(device=card)
    mesh = hvd.model_mesh()
    tp = mesh.get_group("model")
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    full = seed0_host(tfm, cfg)
    specs = tfm.param_specs(cfg)
    label = "gloo through the host, 2 ranks on one card: not a TP speed " \
            "figure"
    res = {"gloo_cuda": True}

    # ---- serving: the unsharded engine on rank 0, then the TP engine,
    # each free-running and teacher-forced on the unsharded streams
    on_card = to_card(full, card)  # the TP engine cuts its shard
    streams = [None]
    if rank == 0:
        ref = ServeEngine(on_card, cfg, page_size=PAGE_SIZE, device=card)
        streams[0], _, _ = _tp_greedy(ref)
        ref_rows, _ = _tp_teacher_forced(ref, streams[0])
        del ref
        torch.cuda.empty_cache()
    dist.broadcast_object_list(streams, src=0)
    eng = ServeEngine(on_card, cfg, mesh=mesh, tp_axis="model",
                      page_size=PAGE_SIZE, device=card)
    h_kv = eng._k_pool.shape[3]
    zero_launches(fa)
    rows, prefill_ms = _tp_teacher_forced(eng, streams[0])
    tokens, wall, steps = _tp_greedy(eng)
    torch.cuda.synchronize()
    serve_launches = read_launches(fa)
    del eng
    # the same requests in f32 activations, where the TP tokens must be
    # those of the unsharded engine
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    if rank == 0:
        ref32, _, _ = _tp_greedy(ServeEngine(
            on_card, cfg32, page_size=PAGE_SIZE, device=card))
    tokens32, _, _ = _tp_greedy(ServeEngine(
        on_card, cfg32, mesh=mesh, tp_axis="model", page_size=PAGE_SIZE,
        device=card))
    del on_card
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tp serve rank {rank} ({label}): prefill 8 x 512 "
          f"{prefill_ms:.1f} ms; {steps} scheduler steps in "
          f"{wall * 1e3:.1f} ms ({wall * 1e3 / steps:.1f} ms a step); "
          f"KV pool H_kv {h_kv}; launches {serve_launches}", flush=True)
    checks = [(h_kv == FLAGSHIP["n_kv_heads"] // TP_RANKS,
               f"rank {rank}: the KV pool holds {h_kv} kv heads"),
              (serve_launches["flash_fwd_wgmma"] == 2 * cfg.n_layers
               and sum(serve_launches.values()) == 2 * cfg.n_layers,
               f"rank {rank} tp_serve launches {serve_launches}: "
               f"{2 * cfg.n_layers} flash_fwd on the tensor cores expected")]
    if rank == 0:
        checks += _tp_serve_checks(rows, ref_rows, tokens, streams[0])
        same = [a == b for a, b in zip(tokens32, ref32)]
        print(f"tp serve f32 vs unsharded f32: {sum(same)} of "
              f"{len(same)} streams of {NEW_TOKENS} tokens identical",
              flush=True)
        checks.append((all(same), "tp f32 tokens differ from the "
                                  "unsharded f32 engine's"))
        res.update(prefill_ms=prefill_ms, decode_step_ms=wall * 1e3 / steps,
                   logits_max_abs=float(np.abs(rows - ref_rows).max()))
        del rows, ref_rows

    # ---- training: the unsharded step on rank 0, then the TP steps
    rng = np.random.default_rng(1)
    batch = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (TP_BATCH, TRAIN_SEQ))).to(card)
    targets = torch.roll(batch, -1, dims=1)
    ref_grads = ref32 = None
    if rank == 0:
        ref = tfm.TransformerLM(cfg, to_card(full, card), device=card)
        loss = ref.loss(batch, targets)
        loss.backward()
        ref_loss = loss.item()
        ref_grads = {k: v.grad.float().cpu()
                     for k, v in tfm._named_leaves(ref.params)}
        del ref, loss
        torch.cuda.empty_cache()
    shard = to_card(tfm.slice_param_shards(full, specs, mesh), card)
    dist.barrier()
    lm = tfm.TransformerLM(cfg, shard, device=card,
                           axes=tfm.ShardAxes(tp=tp))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), **ADAMW),
        named_parameters=lm.named_parameters(),
        model_keys=tfm.model_parallel_keys(cfg))
    zero_launches(fa)
    losses, step_ms = [], []
    for i in range(1 + TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = lm.loss(batch, targets)
        loss.backward()
        opt.synchronize()
        if i == 0:
            grads = {k: v.grad for k, v in tfm._named_leaves(lm.params)}
        opt.step(synchronize=False)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            rel = _tp_grad_rel(dist, tfm, grads, specs, tp, rank, ref_grads)
            del grads
    torch.cuda.synchronize()
    train_launches = read_launches(fa)
    del lm, opt
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the f32 leg: the same step in f32 activations (the CUDA-core
    # loop's exact arithmetic, off the counted path), its gathered
    # gradients against the unsharded f32 model's
    if rank == 0:
        ref = tfm.TransformerLM(cfg32, to_card(full, card), device=card)
        loss = ref.loss(batch, targets)
        loss.backward()
        ref32_loss = loss.item()
        ref32 = {k: v.grad.cpu() for k, v in tfm._named_leaves(ref.params)}
        del ref, loss
        torch.cuda.empty_cache()
    dist.barrier()
    lm = tfm.TransformerLM(cfg32, to_card(tfm.slice_param_shards(
        full, specs, mesh), card), device=card, axes=tfm.ShardAxes(tp=tp))
    del full
    # the exchange as the bf16 step's (a replicated leaf's gradients
    # summed over the group make tp times the unsharded one)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(lm.parameters(), lr=0.0),
        named_parameters=lm.named_parameters(),
        model_keys=tfm.model_parallel_keys(cfg))
    loss32 = lm.loss(batch, targets)
    loss32.backward()
    opt.synchronize()
    rel32 = _tp_grad_rel(dist, tfm, {k: v.grad for k, v in
                                     tfm._named_leaves(lm.params)},
                         specs, tp, rank, ref32)
    loss32 = loss32.item()
    del lm, opt
    want_n = (1 + TP_STEPS) * cfg.n_layers
    check(all(train_launches[k] == want_n for k in (
        "flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"))
        and sum(train_launches.values()) == 3 * want_n,
        f"rank {rank} tp_train launches {train_launches}: {want_n} of each "
        "static kernel on the tensor cores expected")
    print(f"tp train rank {rank} ({label}): B {TP_BATCH} x {TRAIN_SEQ}, "
          f"steps {' '.join(f'{t:.1f}' for t in step_ms)} ms, losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; launches "
          f"{train_launches}", flush=True)
    for ok, msg in checks:
        check(ok, msg)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"tp train: losses not finite or not falling: {losses}")
    if rank == 0:
        worst = max(rel, key=rel.get)
        print(f"tp train vs unsharded: loss {losses[0]:.6f} vs "
              f"{ref_loss:.6f} (|d| {abs(losses[0] - ref_loss):.3g}, tol "
              f"{TRAIN_LOSS_ATOL:g}); gathered gradients relative L2 worst "
              f"{rel[worst]:.4g} at {worst} (tol {TRAIN_GRAD_REL:g}), median "
              f"{float(np.median(list(rel.values()))):.4g} over {len(rel)} "
              "leaves", flush=True)
        worst32 = max(rel32, key=rel32.get)
        print(f"tp train f32 vs unsharded f32: loss {loss32:.6f} vs "
              f"{ref32_loss:.6f} (|d| {abs(loss32 - ref32_loss):.3g}); "
              f"gathered gradients relative L2 worst {rel32[worst32]:.4g} "
              f"at {worst32} (tol {TP_F32_GRAD_REL:g}), median "
              f"{float(np.median(list(rel32.values()))):.4g} over "
              f"{len(rel32)} leaves", flush=True)
        check(abs(losses[0] - ref_loss) <= TRAIN_LOSS_ATOL,
              "tp loss differs from the unsharded model's")
        check(rel[worst] <= TRAIN_GRAD_REL,
              "tp gradients differ from the unsharded model's")
        check(rel32[worst32] <= TP_F32_GRAD_REL,
              "tp f32 gradients differ from the unsharded f32 model's")
        res.update(launches={"tp_serve": serve_launches,
                             "tp_train": train_launches},
                   step_ms=step_ms, losses=losses, ref_loss=ref_loss,
                   grad_rel_worst=rel[worst],
                   f32_grad_rel_worst=rel32[worst32])
        with open(out_path, "w") as f:
            json.dump(res, f)
    hvd.shutdown()
    dist.destroy_process_group()


def phase_tp(where):
    """Tensor parallelism at full width, two ranks on this card
    (:func:`tp_worker`, main paths tp_serve and tp_train): the TP
    engine against the unsharded one (:func:`_tp_serve_checks`: logits
    within LOGITS_ATOL teacher-forced, argmax and free-running tokens
    equal but at near-ties of at most TP_NEAR_TIE; in f32 every token
    equal); each rank's KV pool holds H_kv 2; the TP
    step's loss lies within TRAIN_LOSS_ATOL of the unsharded model's and
    every gathered gradient within TRAIN_GRAD_REL; the loss falls over
    TP_STEPS AdamW steps; every flash launch (H 8 / H_kv 2) takes the
    tensor-core route. Returns ({kernel: launches} of tp_serve, of
    tp_train), rank 0's."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = os.path.join(tempfile.mkdtemp(), "tp.json")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--tp-rank", str(r), str(port), out])
             for r in range(TP_RANKS)]
    try:
        codes = [p.wait(timeout=TP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(codes == [0] * TP_RANKS, f"tp ranks exited with {codes}")
    with open(out) as f:
        res = json.load(f)
    print(f"tp phase [{where}]: 2 ranks over gloo on one card, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return res["launches"]["tp_serve"], res["launches"]["tp_train"]


# ------------------------------------------------------- fault tolerance

# The guard phase (main path guard): FT_MODEL at 4 x 4096, AdamW
# with its learning rate a card tensor (a replay reads it), through the
# compiled step and the eager DistributedOptimizer, unguarded and under
# HOROVOD_GUARD=1. The guarded compiled run's calls: 0-4 healthy (as the
# unguarded run's 5), 5-6 a NaN seeded into the backward (skip, then the
# back-off at the next call), 7 healthy at half the rate, 8-10 NaN (the
# third bad step rolls back to the State commit taken after call 4). The
# second spec counts only the calls the first one does not fire at.
GUARD_STEPS = WARMUP_STEPS + TIMED_STEPS
GUARD_INJECT = "nan,name=hvd.step,step=5,count=2;nan,name=hvd.step,step=6,count=3"
GUARD_ENV = {"HOROVOD_GUARD": "1", "HOROVOD_GUARD_LR_BACKOFF_STEPS": "2",
             "HOROVOD_GUARD_BAD_STEPS": "3",
             "HOROVOD_GUARD_LR_BACKOFF_FACTOR": "0.5",
             "HOROVOD_GUARD_INJECT": GUARD_INJECT}
# The back-off check: the replay's update of the smallest parameter
# against AdamW at the backed-off rate on the step's own gradient (the
# same foreach kernels, one tensor), relative.
GUARD_LR_REL = 1e-6
# Elastic state (main path elastic_state): a State commit every
# ELASTIC_COMMIT_EVERY steps of FT_MODEL under elastic.run, fed by
# DistributedDataset; ELASTIC_STATE_STEPS steps in all.
ELASTIC_STATE_STEPS, ELASTIC_COMMIT_EVERY = 6, 2
# Elastic ranks (main path elastic_ranks): three processes over gloo on
# this card, a narrow transformer (flash attention, D 64: the tensor
# cores), 48 samples of 257 tokens, 2 a rank a step.
ELASTIC_RANKS, ELASTIC_SAMPLES, ELASTIC_BATCH, ELASTIC_SEQ = 3, 48, 2, 256
ELASTIC_MODEL = dict(vocab_size=4096, d_model=256, n_heads=4, n_kv_heads=2,
                     n_layers=2, d_ff=1024, max_seq=ELASTIC_SEQ,
                     positional="rope")
ELASTIC_ENV = {"HOROVOD_ELASTIC": "1", "HOROVOD_ELASTIC_TIMEOUT_SECONDS": "20",
               "HOROVOD_ELASTIC_SETTLE_SECONDS": "2",
               "HOROVOD_PROFILER_DISABLE": "1"}
ELASTIC_TIMEOUT_S = 240


def _adamw_tensor_lr(params, card):
    """AdamW as the train phases build it, its rate a tensor on the
    card (capturable there)."""
    kw = dict(ADAMW, lr=torch.tensor(ADAMW["lr"], device=card))
    return torch.optim.AdamW(params, capturable=card.type == "cuda", **kw)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _sync_ms(fn):
    """Host ms of ``fn()`` between two synchronisations (what a step
    costs the loop, its host waits included)."""
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, (time.perf_counter() - t0) * 1e3


def _device_clone(lm, opt):
    """Card copies of every parameter and AdamW state tensor."""
    return [t.detach().clone() for t in _gated_tensors(lm, opt)]


def _gated_tensors(lm, opt):
    return [p for p in lm.parameters()] + [
        v for p in lm.parameters() for _, v in sorted(opt.state[p].items())
        if torch.is_tensor(v)]


def _guard_run(hvd, tfm, card, cfg, tokens, targets, compiled, calls):
    """``calls`` steps of the flagship (seed 0) through the compiled step
    or the eager DistributedOptimizer; returns (model, optimizer, step,
    host ms a call)."""
    lm = tfm.TransformerLM(cfg, seed0_params(tfm, cfg, card), device=card)
    opt = hvd.DistributedOptimizer(_adamw_tensor_lr(lm.parameters(), card),
                                   named_parameters=lm.named_parameters())
    step = None
    if compiled:
        step = hvd.compiled_train_step(lm.loss, opt)
        call = lambda: step(tokens, targets)  # noqa: E731
    else:
        def call():
            opt.zero_grad(set_to_none=True)
            loss = lm.loss(tokens, targets)
            loss.backward()
            opt.step()
            return loss.detach()
    ms = [_sync_ms(call)[1] for _ in range(calls)]
    return lm, opt, step, ms


def phase_guard(hvd, fa, tfm, card, where, model=FT_MODEL,
                shape=(TRAIN_BATCH, TRAIN_SEQ)):
    """Main path guard (see GUARD_STEPS): unguarded, then under
    HOROVOD_GUARD=1, the compiled and eager steps of the flagship cut to
    FT_MODEL's depth, 1 + 4 each,
    host ms a step (between synchronisations) median of the last 4,
    ``guard_overhead_frac`` each. Gates: the guarded parameters after 5
    healthy steps equal the unguarded ones bitwise (compiled and eager);
    the seeded NaN's step leaves every parameter and AdamW tensor bitwise
    as it was, and ``parameter_digest`` reads the same bits across that
    replay; the next bad step backs the rate off (the tensor halves in
    place) and the following replay's update is AdamW's at the new rate
    within GUARD_LR_REL (and not at the old one); the third bad step
    rolls back to the State commit bitwise, into the same storage. Every
    flash launch of the guarded runs takes the tensor-core route.
    Returns ({kernel: launches} of the guarded runs, the phase's row)."""
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **model)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, shape)
    targets = torch.from_numpy(np.roll(tok, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tok).to(card)
    row = {}
    hvd.init(device=card)
    want = {}
    for compiled in (True, False):
        lm, opt, step, ms = _guard_run(hvd, tfm, card, cfg, tokens, targets,
                                       compiled, GUARD_STEPS)
        kind = "compiled" if compiled else "eager"
        want[kind] = [p.detach().cpu() for p in lm.parameters()]
        row[f"{kind}_plain_ms"] = float(np.median(ms[WARMUP_STEPS:]))
        del lm, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    hvd.shutdown()
    os.environ.update(GUARD_ENV)
    # the rollback's post-mortem (the flight recorder's dump)
    os.environ["HOROVOD_DIAG_DIR"] = tempfile.mkdtemp()
    try:
        hvd.init(device=card)
        mon = hvd.guard.get()
        check(mon is not None, "HOROVOD_GUARD=1 installed no monitor")
        zero_launches(fa)
        lm, opt, step, ms = _guard_run(hvd, tfm, card, cfg, tokens,
                                       targets, True, GUARD_STEPS)
        row["compiled_guard_ms"] = float(np.median(ms[WARMUP_STEPS:]))
        got = [p.detach().cpu() for p in lm.parameters()]
        differ = sum(not torch.equal(a, b)
                     for a, b in zip(got, want["compiled"]))
        check(differ == 0, f"guarded compiled step: {differ} parameters "
                           f"differ from the unguarded step's after "
                           f"{GUARD_STEPS} healthy steps")
        rows = int(opt.guard_health.shape[0])
        check(step.cache_misses == 1 and step.fallback_steps == 0,
              f"guarded step: {step.cache_misses} misses, "
              f"{step.fallback_steps} fallbacks")
        # the State commit the rollback returns to (parameters and both
        # moments to pinned host memory)
        state = hvd.elastic.State(model=lm, optimizer=opt)
        mon.attach_state(state)
        mon.attach_optimizer(opt)
        _, row["commit_ms"] = _sync_ms(state.commit)
        committed = _device_clone(lm, opt)
        storage = [t.data_ptr() for t in _gated_tensors(lm, opt)]
        digest0 = hvd.guard.parameter_digest(lm)
        before = _device_clone(lm, opt)
        step(tokens, targets)                      # call 5: NaN, skipped
        _sync()
        same = all(torch.equal(a, b) for a, b in
                   zip(before, _gated_tensors(lm, opt)))
        digest1 = hvd.guard.parameter_digest(lm)
        check(same, "the skipped step changed a parameter or AdamW tensor")
        check(digest0.tobytes() == digest1.tobytes(),
              f"parameter_digest moved across a skipped replay: {digest0} "
              f"-> {digest1}")
        check(hvd.guard.parameter_digest(lm).tobytes() == digest1.tobytes(),
              "parameter_digest differs between two reads")
        del before
        step(tokens, targets)                      # call 6: NaN, back-off
        verdict = step._flush_guard(mon)
        check(verdict["action"] == "skip" and "lr_backoff" in verdict,
              f"the second bad step's verdict: {verdict}")
        lr = opt.param_groups[0]["lr"]
        half = float(np.float32(ADAMW["lr"])) * 0.5
        check(float(lr) == half, f"the rate read {float(lr)}, not {half}")
        small = min(lm.parameters(), key=lambda p: p.numel())
        held = (small.detach().clone(),
                {k: v.clone() for k, v in opt.state[small].items()})
        step(tokens, targets)                      # call 7: healthy, lr/2
        _sync()
        rels = {}
        for rate in (half, ADAMW["lr"]):
            q = torch.nn.Parameter(held[0].clone())
            ref = _adamw_tensor_lr([q], card)
            ref.param_groups[0]["lr"].fill_(rate)
            q.grad = small.grad.detach().clone()
            ref.state[q] = {k: v.clone() for k, v in held[1].items()}
            ref.step()
            rels[rate] = float((q.detach() - small.detach()).norm()
                               / (small.detach() - held[0]).norm())
        check(rels[half] <= GUARD_LR_REL < rels[ADAMW["lr"]],
              f"the replay after the back-off: relative distance "
              f"{rels[half]:.3g} from AdamW at the new rate, "
              f"{rels[ADAMW['lr']]:.3g} at the old")
        for _ in range(3):
            step(tokens, targets)                  # calls 8-10: NaN
        verdict = step.finish()
        _sync()
        check(verdict["action"] == "rollback",
              f"the third bad step's verdict: {verdict}")
        now = _gated_tensors(lm, opt)
        check([t.data_ptr() for t in now] == storage,
              "the rollback moved a tensor's storage")
        check(all(torch.equal(a, b) for a, b in zip(committed, now)),
              "the rollback is not the commit bitwise")
        del committed, state
        launches = read_launches(fa)
        skipped = hvd.metrics.GUARD_SKIPPED_STEPS.value()
        del lm, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        lm, opt, _, ms = _guard_run(hvd, tfm, card, cfg, tokens, targets,
                                    False, GUARD_STEPS)
        row["eager_guard_ms"] = float(np.median(ms[WARMUP_STEPS:]))
        got = [p.detach().cpu() for p in lm.parameters()]
        differ = sum(not torch.equal(a, b)
                     for a, b in zip(got, want["eager"]))
        check(differ == 0, f"guarded eager step: {differ} parameters differ "
                           f"from the unguarded step's")
        eager_launches = read_launches(fa)
        del lm, opt, got, want
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
        for k in (*GUARD_ENV, "HOROVOD_DIAG_DIR"):
            os.environ.pop(k, None)
    for k, v in eager_launches.items():
        check(not k.endswith("_wgmma") or v >= launches[k],
              "launch counters went backwards")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(eager_launches[k] == 0, f"{k}: the guard runs took the loop")
    steps_run = GUARD_STEPS + 6 + GUARD_STEPS
    check(eager_launches["flash_fwd_wgmma"] == steps_run * cfg.n_layers,
          f"flash_fwd_wgmma {eager_launches['flash_fwd_wgmma']} launches "
          f"over {steps_run} steps")
    for kind in ("compiled", "eager"):
        row[f"{kind}_guard_overhead_frac"] = (
            row[f"{kind}_guard_ms"] / row[f"{kind}_plain_ms"] - 1.0)
    row.update(health_rows=rows, skipped_steps=skipped,
               lr_rel=rels[half])
    print(f"guard {shape[0]} x {shape[1]}, {cfg.n_layers} layers [{where}]: "
          f"compiled {row['compiled_plain_ms']:.1f}"
          f" -> guarded {row['compiled_guard_ms']:.1f} ms a step "
          f"(guard_overhead_frac {row['compiled_guard_overhead_frac']:.4f});"
          f" eager {row['eager_plain_ms']:.1f} -> {row['eager_guard_ms']:.1f}"
          f" ms ({row['eager_guard_overhead_frac']:.4f}); host ms a step "
          f"between synchronisations, median of {TIMED_STEPS}; {rows} health "
          f"rows a step; State commit {row['commit_ms']:.1f} ms; healthy "
          f"guarded parameters bitwise equal to unguarded; NaN skipped with "
          f"parameters and AdamW state bitwise unchanged; back-off read by "
          f"the replay (rel {rels[half]:.2g}); rollback bitwise to the "
          f"commit", flush=True)
    return eager_launches, row


@contextlib.contextmanager
def recovery_log():
    """The elastic runner's recoveries while the block runs: for each,
    the warning with the exception it recovered from and its cause,
    traceback included (a list, filled as they happen)."""
    import logging
    from horovod_tpu_torch.utils.logging import get_logger
    seen = []

    class _Keep(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("elastic: recovery"):
                seen.append(logging.Formatter().format(record))

    keep = _Keep(logging.WARNING)
    get_logger().addHandler(keep)
    try:
        yield seen
    finally:
        get_logger().removeHandler(keep)


def _token_samples(n, seq, vocab, seed):
    """``n`` seeded samples of ``seq + 1`` tokens: the input and its
    targets, shifted by one."""
    return np.random.default_rng(seed).integers(
        0, vocab, (n, seq + 1)).astype(np.int64)


def _split_tokens(batch):
    return batch["t"][:, :-1], batch["t"][:, 1:]


def phase_elastic_state(hvd, fa, tfm, card, where, model=FT_MODEL,
                        shape=(TRAIN_BATCH, TRAIN_SEQ)):
    """Main path elastic_state: one rank (HOROVOD_ELASTIC=1) trains the
    flagship cut to FT_MODEL's depth at 4 x 4096 under ``hvd.elastic.run``
    through the compiled
    step, fed by ``DistributedDataset`` (seeded token samples, pinned
    memory, a side stream, prefetch 2), an ``elastic.State`` commit every
    ELASTIC_COMMIT_EVERY steps (time printed: parameters and AdamW
    moments to pinned memory). Then a CheckpointManager saves the
    commit once (time, sidecar digest included) and restores it (time),
    bitwise equal to the commit. On a small checkpoint of its own (the
    digest fails alike at any size; the commit's would be hashed twice
    more, about 30 s), a flipped byte in the newer step's file fails the
    sidecar, ``latest_valid_step`` falls back to the older step and an
    explicit restore of it raises CheckpointCorruptError. Prints the
    input wait share of the steps. Returns ({kernel: launches}, row)."""
    from horovod_tpu_torch.exceptions import CheckpointCorruptError
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **model)
    batch, seq = shape
    os.environ["HOROVOD_ELASTIC"] = "1"
    row = {}
    root = tempfile.mkdtemp(dir=os.environ.get("TMPDIR"))
    try:
        hvd.init(device=card)
        lm = tfm.TransformerLM(cfg, seed0_params(tfm, cfg, card),
                               device=card)
        opt = hvd.DistributedOptimizer(_adamw_tensor_lr(lm.parameters(), card),
                                       named_parameters=lm.named_parameters())
        step = hvd.compiled_train_step(lm.loss, opt)
        ds = hvd.data.DistributedDataset(
            {"t": _token_samples(ELASTIC_STATE_STEPS * batch, seq,
                                 cfg.vocab_size, 2)},
            batch, seed=3, prefetch=2, device=card)
        state = hvd.elastic.State(model=lm, optimizer=opt, step=0)
        hvd.data.attach_to_state(state, ds)
        commit_ms, step_ms, losses = [], [], []
        zero_launches(fa)
        ds.take_wait()

        calls = []

        @hvd.elastic.run
        def train(state):
            calls.append(state.step)
            for batch in ds:
                t0 = time.perf_counter()
                losses.append(step(*_split_tokens(batch)))
                _sync()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                state.step += 1
                if state.step % ELASTIC_COMMIT_EVERY == 0:
                    commit_ms.append(_sync_ms(state.commit)[1])

        t_loop = time.perf_counter()
        with recovery_log() as recovered:
            train(state)
        loop_s = time.perf_counter() - t_loop
        for text in recovered:
            print(f"elastic state [{where}]: {text}", flush=True)
        wait_s = ds.take_wait()
        launches = read_launches(fa)
        losses = [float(x) for x in losses]
        check(len(losses) == ELASTIC_STATE_STEPS and all(
            np.isfinite(losses)), f"elastic state losses {losses}")
        check(state.step == ELASTIC_STATE_STEPS and state.commits == len(
            commit_ms), f"step {state.step}, {state.commits} commits")
        check(calls == [0], f"one rank recovered from nothing: the "
                            f"training function ran from steps {calls}")
        row["input_wait_share"] = wait_s / loop_s
        # the first two commits allocate the two pinned buffer sets
        row["commit_ms"] = commit_ms
        row["step_ms"] = float(np.median(step_ms[WARMUP_STEPS:]))
        snap = state.committed
        mgr = hvd.checkpoint.CheckpointManager(os.path.join(root, "ckpt"))
        t0 = time.perf_counter()
        check(mgr.save(1, snap), "checkpoint step 1 not written")
        saves = [(time.perf_counter() - t0) * 1e3]
        row["save_ms"] = saves
        nbytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(os.path.join(root, "ckpt", "1"))
                     for f in fs)
        t0 = time.perf_counter()
        back = mgr.restore()
        row["restore_ms"] = (time.perf_counter() - t0) * 1e3
        from torch.utils import _pytree as pytree
        a, b = pytree.tree_leaves(back), pytree.tree_leaves(snap)
        check(len(a) == len(b) and all(
            (torch.equal(x, y) if torch.is_tensor(x) else x == y)
            for x, y in zip(a, b)), "the checkpoint restore is not bitwise")
        del back, a, b
        small = hvd.checkpoint.CheckpointManager(os.path.join(root, "small"))
        tiny = {"step": 0, "w": torch.arange(1 << 16, dtype=torch.float32)}
        for s in (1, 2):
            check(small.save(s, tiny), f"small checkpoint step {s} not "
                                       f"written")
        path = os.path.join(root, "small", "2", "state-0.pt")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x01]))
        fails = hvd.metrics.CHECKPOINT_INTEGRITY_FAILURES.value()
        latest = small.latest_valid_step()
        check(latest == 1 and hvd.metrics.CHECKPOINT_INTEGRITY_FAILURES
              .value() == fails + 1, f"latest_valid_step {latest}, not 1, "
              f"after a flipped byte in step 2")
        try:
            small.restore(2)
            check(False, "the corrupted step restored")
        except CheckpointCorruptError:
            pass
        row["checkpoint_gb"] = nbytes / 1e9
        del lm, opt, step, state, snap, ds
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
        os.environ.pop("HOROVOD_ELASTIC", None)
        shutil.rmtree(root, ignore_errors=True)
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[k] == 0, f"{k}: the elastic run took the loop")
    check(launches["flash_fwd_wgmma"] == ELASTIC_STATE_STEPS * cfg.n_layers,
          f"flash_fwd_wgmma: {launches['flash_fwd_wgmma']} launches")
    print(f"elastic state {batch} x {seq}, {cfg.n_layers} layers [{where}]: "
          f"{ELASTIC_STATE_STEPS} steps "
          f"under elastic.run, step {row['step_ms']:.1f} ms (host, median); "
          f"input wait share {row['input_wait_share']:.5f}; State commits "
          f"{' / '.join(f'{t:.0f}' for t in commit_ms)} ms (the first two "
          f"allocate the pinned buffers, the third reuses them); "
          f"checkpoint {row['checkpoint_gb']:.2f} GB: save "
          f"{' / '.join(f'{t:.0f}' for t in saves)} ms (sidecar digest "
          f"included), restore {row['restore_ms']:.0f} ms (digest "
          f"verified), bitwise; on a small checkpoint a flipped byte "
          f"failed the sidecar and latest_valid_step fell back to step 1",
          flush=True)
    return launches, row


def elastic_worker(rank, port, out_dir, mode, device="cuda"):
    """One rank of the elastic-ranks phase (``chip_smoke.py
    --elastic-rank R PORT OUT MODE``): the launcher's variables, a gloo
    group on this card over the job's store with the elastic timeout
    (``hvd.init()`` adopts it; NCCL refuses three ranks on one card, and
    the survivors' group takes its backend), the narrow
    transformer under ``hvd.elastic.run`` fed by DistributedDataset. Rank
    2 leaves at a known step: ``kill`` SIGKILLs itself before its step-2
    exchange, ``term`` sends itself SIGTERM before step 1 (the
    preemption grace: it finishes the step, commits, leaves). Each rank
    logs a batch's sample ids once its exchange went through, and writes
    its record to OUT/rank<R>.json. ``device`` is the phase's (a
    rehearsal on the CPU passes ``cpu``)."""
    import signal
    os.environ.update(ELASTIC_ENV, HOROVOD_TPU_COORDINATOR=f"127.0.0.1:{port}",
                      HOROVOD_TPU_NUM_PROCESSES=str(ELASTIC_RANKS),
                      HOROVOD_TPU_PROCESS_ID=str(rank),
                      HOROVOD_TPU_LOCAL_RANK="0",
                      HOROVOD_TPU_LOCAL_SIZE="1")
    if mode == "term":
        os.environ.update(HOROVOD_ELASTIC_GRACE_SECONDS="60",
                          HOROVOD_ELASTIC_GRACE_DIR=os.path.join(out_dir,
                                                                 "grace"))
    card = torch.device(device)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    import datetime

    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.PrefixStore("smoke/pg/", hvd.runtime.job_store()),
        rank=rank, world_size=ELASTIC_RANKS,
        timeout=datetime.timedelta(
            seconds=float(ELASTIC_ENV["HOROVOD_ELASTIC_TIMEOUT_SECONDS"])))
    hvd.init(device=card)
    card = hvd.runtime.device()
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                **ELASTIC_MODEL)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device=card)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), **ADAMW),
        named_parameters=lm.named_parameters())
    ds = hvd.data.DistributedDataset(
        {"t": _token_samples(ELASTIC_SAMPLES, ELASTIC_SEQ, cfg.vocab_size, 4),
         "i": np.arange(ELASTIC_SAMPLES)}, ELASTIC_BATCH, seed=5,
        device=card)
    state = hvd.elastic.State(model=lm, optimizer=opt, step=0)
    hvd.data.attach_to_state(state, ds)
    state.commit()
    zero_launches(fa)
    victim, at_step = ELASTIC_RANKS - 1, 2 if mode == "kill" else 1
    rec = {"rank": rank, "sizes": [], "recovery_s": None, "ids": [],
           "losses": []}
    mark = [None]

    @hvd.elastic.run
    def train(state):
        if mark[0] is not None:
            rec["recovery_s"] = time.perf_counter() - mark[0]
        rec["sizes"].append(hvd.size())
        for batch in ds:
            if rank == victim and state.step == at_step:
                os.kill(os.getpid(), signal.SIGKILL if mode == "kill"
                        else signal.SIGTERM)
            opt.zero_grad(set_to_none=True)
            loss = lm.loss(*_split_tokens(batch))
            loss.backward()
            mark[0] = time.perf_counter()
            opt.step()
            rec["ids"] += batch["i"].tolist()
            rec["losses"].append(float(loss))
            with open(os.path.join(out_dir, f"ids{rank}.json"), "w") as f:
                json.dump(rec["ids"], f)
            state.step += 1
            state.commit()

    with recovery_log() as recovered:
        train(state)
    # the exception each recovery caught and its cause, last line each
    rec["recovered"] = [[line for line in text.splitlines() if line][-1]
                        for text in recovered]
    rec["step"] = state.step
    rec["launches"] = read_launches(fa)
    rec["digest"] = hvd.guard.parameter_digest(lm).tolist()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    hvd.shutdown()


def phase_elastic_ranks(where, device="cuda", modes=("kill", "term")):
    """Main path elastic_ranks, parity only (gloo moves card tensors
    through the host): :func:`elastic_worker` on three processes of this
    card, twice. ``kill``: rank 2 SIGKILLs itself before its step-2
    exchange; ranks 0 and 1 raise WorkerLostError, re-rendezvous,
    ``init(comm=[0, 1])``, restore the commit and finish the epoch.
    ``term``: rank 2 gets SIGTERM before step 1, finishes it, commits,
    writes its grace file, announces its departure and exits 79; the
    survivors recover without waiting out the liveness timeout. Gates:
    the exit codes, every sample exactly once across the membership
    change, the survivors' parameters bitwise equal (their digests),
    finite losses, every flash launch on the tensor-core route. Prints
    each run's recovery wall time (the failed exchange to the resumed
    loop). ``modes`` picks the runs (main() runs the kill run beside
    the launcher phase, the term run, whose recovery is gated on time,
    alone).
    Returns ({kernel: launches} summed over the survivors of the runs,
    row)."""
    import socket
    from horovod_tpu_torch.elastic import EX_PREEMPTED
    total = {}
    row = {}
    codes = {"kill": -9, "term": EX_PREEMPTED}
    for mode in modes:
        code = codes[mode]
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        out = tempfile.mkdtemp()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--elastic-rank",
             str(r), str(port), out, mode, device])
            for r in range(ELASTIC_RANKS)]
        try:
            codes = [p.wait(timeout=ELASTIC_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        want = [0] * (ELASTIC_RANKS - 1) + [code]
        check(codes == want, f"elastic {mode}: ranks exited with {codes}, "
                             f"{want} expected")
        recs = []
        for r in range(ELASTIC_RANKS - 1):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        ids = []
        for r in range(ELASTIC_RANKS):
            with open(os.path.join(out, f"ids{r}.json")) as f:
                ids += json.load(f)
        check(sorted(ids) == list(range(ELASTIC_SAMPLES)),
              f"elastic {mode}: {len(ids)} samples consumed, not each of "
              f"{ELASTIC_SAMPLES} once")
        check(all(r["sizes"] == [ELASTIC_RANKS, ELASTIC_RANKS - 1]
                  for r in recs), f"elastic {mode}: sizes "
                                  f"{[r['sizes'] for r in recs]}")
        check(recs[0]["digest"] == recs[1]["digest"],
              f"elastic {mode}: the survivors' parameters differ")
        check(all(np.isfinite(r["losses"]).all() for r in recs),
              f"elastic {mode}: a loss is not finite")
        if mode == "term":
            check(os.path.exists(os.path.join(out, "grace", "grace-2.pt")),
                  "the departing rank wrote no grace file")
        for r in recs:
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        for r in recs:
            print(f"elastic ranks {mode} [{where}]: rank {r['rank']} "
                  f"recovered from {r['recovered']}", flush=True)
        recovery = max(r["recovery_s"] for r in recs)
        row[f"{mode}_recovery_s"] = recovery
        row[f"{mode}_wall_s"] = time.perf_counter() - t0
        print(f"elastic ranks {mode} [{where}]: 3 ranks over gloo on one "
              f"card, rank 2 {'SIGKILLed at step 2' if mode == 'kill' else 'SIGTERMed at step 1 (grace)'};"
              f" recovery {recovery:.2f} s (failed exchange to the resumed "
              f"loop), every one of {ELASTIC_SAMPLES} samples once, "
              f"survivors bitwise equal; run {row[f'{mode}_wall_s']:.1f} s",
              flush=True)
        shutil.rmtree(out, ignore_errors=True)
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(total.get(k, 0) == 0, f"{k}: the elastic ranks took the loop")
    check(total["flash_fwd_wgmma"] > 0, "the elastic ranks launched no "
                                        "flash kernel")
    if "term" in modes:
        check(row["term_recovery_s"] < float(
            ELASTIC_ENV["HOROVOD_ELASTIC_SETTLE_SECONDS"]),
            f"the planned departure took {row['term_recovery_s']:.2f} s: "
            f"it waited for the settle window or the liveness timeout")
    return total, row


# ------------------------------------------------------------ eager engine

EAGER_WARMUP, EAGER_TIMED = 3, 4
# The share of a steady step's negotiations the response cache answers.
EAGER_HIT_RATE_MIN = 0.9
EAGER_RANKS, EAGER_TIMEOUT_S = 2, 300
EAGER_STALL_ENV = {"HOROVOD_STALL_CHECK_TIME_SECONDS": "1",
                   "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "3"}


# The Spark launcher (main path spark): spark.run's local backend, one
# task process a rank over gloo on this card (NCCL refuses two ranks on
# one card), the elastic ranks' narrow transformer, 2 steps.
SPARK_RANKS, SPARK_STEPS, SPARK_START_S = 2, 2, 300


def _spark_train(hvd, tfm, card, steps):
    """``steps`` AdamW steps of the narrow transformer (seed 0) through
    ``DistributedOptimizer`` on one seeded batch, the same on every
    rank (the average of equal gradients is their bits); returns (model,
    losses)."""
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                **ELASTIC_MODEL)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device=card)
    hvd.broadcast_parameters(lm.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), **ADAMW),
        named_parameters=lm.named_parameters())
    batch = {"t": torch.from_numpy(_token_samples(
        ELASTIC_BATCH, ELASTIC_SEQ, cfg.vocab_size, 6)).to(card)}
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = lm.loss(*_split_tokens(batch))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return lm, losses


def _param_hashes(lm):
    """sha256 of each parameter's bytes, by name."""
    import hashlib
    return {n: hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
            for n, p in lm.named_parameters()}


def spark_rank(steps, device="cuda"):
    """What a Spark task runs (``horovod_tpu_torch.spark.run``): the
    launcher's variables the task set, a gloo group over the job's store
    (``hvd.init()`` adopts it), the narrow model's ``steps`` steps on the
    card (``device``: a rehearsal on the CPU passes ``cpu``); returns its
    parameters' hashes, losses and kernel launches."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    rank, size = int(os.environ["HOROVOD_RANK"]), int(os.environ["HOROVOD_SIZE"])
    # every task shares the one card: its local rank names no card here
    card = torch.device("cuda", 0) if device == "cuda" else torch.device(
        device)
    dist.init_process_group(
        "gloo", store=dist.PrefixStore("smoke/spark/", hvd.runtime.job_store()),
        rank=rank, world_size=size)
    hvd.init(device=card)
    zero_launches(fa)
    lm, losses = _spark_train(hvd, tfm, hvd.runtime.device(), steps)
    out = {"rank": hvd.rank(), "size": hvd.size(), "losses": losses,
           "hashes": _param_hashes(lm), "launches": read_launches(fa)}
    hvd.shutdown()
    return out


def phase_spark(hvd, fa, tfm, card, where):
    """Main path spark (parity, not a speed: gloo moves card tensors
    through the host): ``spark.run(spark_rank, backend="local",
    num_proc=2)``, each task a process that inits the port on this card
    and trains the narrow transformer 2 steps; the results come back
    through the driver service in rank order. Gates: ranks 0 and 1 in
    order, size 2, both ranks' parameters bitwise equal to each other and
    to the same 2 steps run in this process at one rank, equal losses,
    every flash launch on the tensor-core route. Prints the wall time of
    ``spark.run``. Returns ({kernel: launches} summed over the ranks,
    row)."""
    import chip_smoke as module  # the task imports the function by name
    from horovod_tpu_torch import spark
    env = {"PYTHONPATH": os.pathsep.join(
        [REPO_DIR] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    t0 = time.perf_counter()
    results = spark.run(module.spark_rank, args=(SPARK_STEPS, card.type),
                        num_proc=SPARK_RANKS, backend="local",
                        start_timeout=SPARK_START_S, env=env)
    wall = time.perf_counter() - t0
    hvd.init(device=card)
    try:
        lm, losses = _spark_train(hvd, tfm, card, SPARK_STEPS)
        want = _param_hashes(lm)
        del lm
    finally:
        hvd.shutdown()
    check([r["rank"] for r in results] == list(range(SPARK_RANKS))
          and all(r["size"] == SPARK_RANKS for r in results),
          f"spark: ranks {[(r['rank'], r['size']) for r in results]}")
    for r in results:
        differ = [n for n in want if r["hashes"][n] != want[n]]
        check(not differ, f"spark rank {r['rank']}: {len(differ)} "
                          f"parameters differ from the in-process run")
        check(r["losses"] == losses,
              f"spark rank {r['rank']}: losses {r['losses']} vs {losses}")
    launches = {k: sum(r["launches"][k] for r in results)
                for k in results[0]["launches"]}
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[k] == 0, f"{k}: the spark ranks took the loop")
    want_n = SPARK_RANKS * SPARK_STEPS * ELASTIC_MODEL["n_layers"]
    check(launches["flash_fwd_wgmma"] == want_n,
          f"spark: {launches['flash_fwd_wgmma']} forward launches, "
          f"{want_n} expected")
    print(f"spark [{where}]: spark.run(local, num_proc={SPARK_RANKS}) of "
          f"{SPARK_STEPS} steps {wall:.1f} s wall; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; both ranks' parameters "
          f"bitwise equal to each other and to the in-process run",
          flush=True)
    return launches, {"wall_s": wall, "losses": losses}


def _align(n, unit=64):
    return -(-n // unit) * unit


def plan_fusion_plain(nbytes, threshold, unit=64):
    """csrc/fusion.cc's PlanFusion for one dtype, in plain Python: each
    unassigned entry opens a group and takes every later one that still
    fits (sizes aligned to the 64-byte atomic unit against the
    threshold). Returns each group's payload bytes, in group order."""
    taken = [False] * len(nbytes)
    groups = []
    for i, nb in enumerate(nbytes):
        if taken[i]:
            continue
        taken[i] = True
        used, payload = _align(nb, unit), nb
        for j in range(i + 1, len(nbytes)):
            if not taken[j] and used + _align(nbytes[j], unit) <= threshold:
                taken[j] = True
                used += _align(nbytes[j], unit)
                payload += nbytes[j]
        groups.append(payload)
    return groups


def predict_buckets(order_bytes, threshold):
    """The fused all-reduces of one step whose f32 gradients reach the
    engine in this order: a cycle runs at the enqueue that brings the
    pending bytes to the threshold, and one more at the first
    synchronize; each cycle fuses what is pending as the planner does."""
    pending, out = [], []
    for nb in order_bytes:
        pending.append(nb)
        if sum(pending) >= threshold:
            out += plan_fusion_plain(pending, threshold)
            pending = []
    if pending:
        out += plan_fusion_plain(pending, threshold)
    return out


def read_profiler(path, ops=("allreduce", "allreduce cached")):
    """{message size: calls} summed over the ``ops`` sections of a
    profiler.txt dump."""
    hist, section = {}, None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("Counter "):
                section = line[len("Counter "):].rsplit(",", 1)[0]
                continue
            if section in ops and line and line[0].isdigit():
                size, count = (int(v) for v in line.split(",")[:2])
                hist[size] = hist.get(size, 0) + count
    return hist


def timeline_spans(path):
    """{tensor name: {span name: opened}} of a timeline file."""
    with open(path) as f:
        events = [e for e in json.load(f) if e]
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    out = {}
    for e in events:
        if e.get("ph") == "B" and e.get("pid") in names:
            spans = out.setdefault(names[e["pid"]], {})
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    return out


def phase_eager_engine(hvd, fa, tfm, card, where):
    """Main path eager_engine: the flagship at 4 x 4096 trained as a
    Horovod user writes the loop, each gradient handed to
    ``hvd.allreduce_async_`` from its hook as autograd produces it,
    every handle synchronized, then ``opt.step()`` (AdamW), beside the
    same model under the bucketed ``DistributedOptimizer`` in the same
    session, step for step. Gates: parameters bitwise equal after every
    step; the fused all-reduces a step exactly what the planner gives for
    the hooks' order; the response cache's hit rate from step 2 on;
    ``profiler.txt`` (written at shutdown) holding exactly those
    all-reduces by message size, and the bucketed ones; the timeline
    holding one negotiate and one op span per tensor a step; every flash
    launch on the tensor-core route; and, in a session of its own, no
    device-to-host copy in a profiled exchange of every gradient.
    Returns the engine steps' {kernel: launches} and its figures (the
    engine steps' losses and the peak memory of the two models' steps
    among them)."""
    tmp = tempfile.mkdtemp()
    dump = os.path.join(tmp, "profiler.txt")
    trace = os.path.join(tmp, "timeline.json")
    os.environ.update(HOROVOD_PROFILER_PATH=dump, HOROVOD_TIMELINE=trace)
    os.environ.pop("HOROVOD_PROFILER_DISABLE", None)
    hvd.init(device=card)
    engine = hvd.runtime.engine()
    threshold = engine.config.fusion_threshold
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    lm_e = tfm.TransformerLM(cfg, seed0_params(tfm, cfg, card), device=card)
    lm_b = tfm.TransformerLM(cfg, seed0_params(tfm, cfg, card), device=card)
    opt_e = torch.optim.AdamW(lm_e.parameters(), **ADAMW)
    opt_b = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm_b.parameters(), **ADAMW),
        named_parameters=lm_b.named_parameters())
    names = {p: n for n, p in lm_e.named_parameters()}
    grad_bytes = sum(p.numel() * p.element_size() for p in lm_e.parameters())
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (TRAIN_BATCH, TRAIN_SEQ))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)

    pending = []   # (parameter, handle) of the step, in hook order
    first = []     # event at the step's first hook

    def hook(p):
        if not first:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            first.append(ev)
        pending.append((p, hvd.allreduce_async_(p.grad, name=names[p])))

    hooks = [p.register_post_accumulate_grad_hook(hook)
             for p in lm_e.parameters()]

    def engine_step():
        pending.clear()
        first.clear()
        opt_e.zero_grad(set_to_none=True)
        loss = lm_e.loss(tokens, targets)
        loss.backward()
        order = [names[p] for p, _ in pending]
        for p, h in pending:
            out = hvd.synchronize(h)
            check(out is p.grad and out.is_cuda,
                  f"{names[p]}: the in-place result is not the card "
                  f"gradient")
        last = torch.cuda.Event(enable_timing=True)
        last.record()
        opt_e.step()
        return loss.detach(), order, first[0], last

    steps = EAGER_WARMUP + EAGER_TIMED
    stats = hvd.runtime.live_state().stats
    cache = engine.response_cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = dict.fromkeys(COUNTERS, 0)
    rows = []
    orders = []
    engine.bucket_spans.clear()
    for i in range(steps):
        if i == 1:
            hits0, misses0 = cache.hits, cache.misses
        calls0 = stats.counter("allreduce") + stats.counter("allreduce_cached")
        zero_launches(fa)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        loss_e, order, ev_first, ev_last = engine_step()
        e1.record()
        torch.cuda.synchronize()
        for name, n in read_launches(fa).items():
            launches[name] += n
        engine_calls = (stats.counter("allreduce")
                        + stats.counter("allreduce_cached") - calls0)
        spans = list(engine.bucket_spans)
        engine.bucket_spans.clear()
        exch_stream = sum(a.elapsed_time(b) + c.elapsed_time(d)
                          for a, b, c, d in spans)
        b0 = torch.cuda.Event(enable_timing=True)
        b1 = torch.cuda.Event(enable_timing=True)
        bt0 = stats.total_time_us("allreduce")
        b0.record()
        opt_b.zero_grad(set_to_none=True)
        loss_b = lm_b.loss(tokens, targets)
        loss_b.backward()
        opt_b.step()
        b1.record()
        torch.cuda.synchronize()
        check(torch.equal(loss_e, loss_b),
              f"step {i}: engine loss {loss_e.item()} != bucketed "
              f"{loss_b.item()}")
        same = all(torch.equal(a, b) for a, b in zip(lm_e.parameters(),
                                                     lm_b.parameters()))
        check(same, f"step {i}: parameters differ from the bucketed "
                    f"DistributedOptimizer's")
        orders.append(order)
        rows.append({"step_ms": e0.elapsed_time(e1),
                     "bucketed_ms": b0.elapsed_time(b1),
                     "exchange_wall_ms": ev_first.elapsed_time(ev_last),
                     "exchange_stream_ms": exch_stream,
                     "buckets": engine_calls, "spans": len(spans),
                     "bucketed_exchange_ms": (stats.total_time_us("allreduce")
                                              - bt0) / 1e3,
                     "loss": loss_e.item()})
    hits, misses = cache.hits - hits0, cache.misses - misses0
    peak = torch.cuda.max_memory_allocated()
    for h in hooks:
        h.remove()
    check(all(o == orders[0] for o in orders),
          "the hooks' submission order changed between steps")
    sizes = {n: p.numel() * p.element_size()
             for p, n in names.items()}
    predicted = predict_buckets([sizes[n] for n in orders[0]], threshold)
    for i, r in enumerate(rows):
        check(r["buckets"] == len(predicted),
              f"step {i}: {r['buckets']} fused all-reduces, "
              f"{len(predicted)} planned")
        check(r["spans"] == len(predicted),
              f"step {i}: {r['spans']} engine buckets, {len(predicted)} "
              f"planned")
    rate = hits / max(hits + misses, 1)
    check(rate >= EAGER_HIT_RATE_MIN,
          f"response cache hit rate {rate:.4f} from step 2 on")
    for name, n in launches.items():
        want = 0 if name in WGMMA else steps * cfg.n_layers
        if name.startswith("flash_band"):
            want = 0
        check(n == want, f"{name} launched {n} times in {steps} engine "
                         f"steps, {want} expected")
    timed = rows[EAGER_WARMUP:]
    med = {k: float(np.median([r[k] for r in timed]))
           for k in ("step_ms", "bucketed_ms", "exchange_wall_ms",
                     "exchange_stream_ms", "bucketed_exchange_ms")}
    print(f"eager engine [{where}]: flagship 4 x {TRAIN_SEQ}, "
          f"{len(predicted)} fused all-reduces a step at threshold "
          f"{threshold} (planned: {predicted}); cache hit rate {rate:.4f} "
          f"({hits} hits, {misses} misses, steps 2-{steps}); losses "
          f"{' '.join(f'{r['loss']:.4f}' for r in rows)}", flush=True)
    print(f"eager engine [{where}]: step {med['step_ms']:.1f} ms beside the "
          f"bucketed optimizer's {med['bucketed_ms']:.1f} ms (medians of "
          f"{EAGER_TIMED}; engine {' '.join(f'{r['step_ms']:.1f}' for r in timed)}"
          f"; bucketed {' '.join(f'{r['bucketed_ms']:.1f}' for r in timed)}); "
          f"exchange wall (first hook to last synchronize) "
          f"{med['exchange_wall_ms']:.2f} ms; the engine stream's span "
          f"(copy-in and unfuse events, beside the backward) "
          f"{med['exchange_stream_ms']:.2f} ms, the bucketed exchange's "
          f"span on the caller's stream "
          f"{med['bucketed_exchange_ms']:.2f} ms", flush=True)
    del opt_e, opt_b, lm_b
    gc.collect()
    hvd.shutdown()
    got = read_profiler(dump)
    want = {}
    for nb in predicted:
        want[nb] = want.get(nb, 0) + steps
    want[grad_bytes] = want.get(grad_bytes, 0) + steps
    check(got == want, f"profiler.txt all-reduces {got}, expected {want}")
    spans = timeline_spans(trace)
    for name in orders[0]:
        s = spans.get(name, {})
        check(s.get("NEGOTIATE_ALLREDUCE") == steps
              and s.get("ALLREDUCE") == steps,
              f"timeline spans of {name}: {s}, {steps} of each expected")
    print(f"eager engine: profiler.txt {sum(got.values())} all-reduces in "
          f"{len(got)} sizes as planned; timeline {len(spans)} tensors, one "
          f"negotiate and one op span each a step", flush=True)
    for k in ("HOROVOD_PROFILER_PATH", "HOROVOD_TIMELINE"):
        os.environ.pop(k, None)
    dtoh, exch_dev = eager_no_host_copy(hvd, lm_e, names, card)
    del lm_e
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {**med, "exchange_device_ms": exch_dev,
                      "buckets": len(predicted), "hit_rate": rate,
                      "dtoh": dtoh, "peak": peak,
                      "losses": [r["loss"] for r in rows]}


def eager_no_host_copy(hvd, lm, names, card):
    """Every gradient of ``lm`` through ``allreduce_async_`` and
    ``synchronize`` in a ``torch.profiler`` window, in a session of its
    own: the window must show device work and no device-to-host copy.
    Returns the host copies (0) and the device time of the exchange's
    kernels and copies in the window, ms (the engine's copy-in, NCCL and
    unfuse, the self time of every device event, as :func:`device_ms`
    sums it; every thread's launches, the completion thread's
    included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    hvd.init(device=card)
    params = [p for p in lm.parameters() if p.grad is not None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        handles = [hvd.allreduce_async_(p.grad, name=names[p])
                   for p in params]
        for h in handles:
            hvd.synchronize(h)
        torch.cuda.synchronize()
    hvd.shutdown()
    evs = prof.events()
    device = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA]
    dtoh = [e.name for e in evs if "DtoH" in e.name
            or "Device -> Pageable" in e.name or "Device -> Pinned" in e.name]
    check(device, "the profiled exchange shows no device work")
    check(not dtoh, f"the exchange copied to the host: {dtoh[:4]}")
    dev_ms = sum(getattr(r, "self_device_time_total", 0)
                 for r in prof.key_averages()
                 if r.device_type == DeviceType.CUDA) / 1e3
    check(dev_ms > 0, "the profiled exchange shows no device time")
    print(f"eager engine: {len(params)} card gradients exchanged with "
          f"{len(device)} device events and no device-to-host copy; the "
          f"exchange's device time {dev_ms:.3f} ms (torch.profiler, the "
          f"kernels and copies of one exchange of every gradient)",
          flush=True)
    return len(dtoh), dev_ms


def eager_worker(rank, port, out_path):
    """One rank of the two-rank eager phase (``chip_smoke.py --eager-rank
    R PORT OUT``): joins a gloo group, ``hvd.init()`` keeps it, then the
    negotiation checks of :func:`phase_eager_engine_2ranks`. Writes its
    results to ``out_path`` + rank."""
    import logging

    import torch.distributed as dist
    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    os.environ.update(HOROVOD_PROFILER_DISABLE="1", **EAGER_STALL_ENV)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=EAGER_RANKS)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils.logging import get_logger
    hvd.init(device=card)
    res = {"rank": rank}
    warnings = []

    class _Catch(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    get_logger().addHandler(_Catch())

    # 24 names, mixed dtypes and shapes, submitted in opposite orders
    dtypes = (torch.float32, torch.bfloat16, torch.int32)
    specs = [(f"eager.{i}", dtypes[i % 3], (i % 5 + 1, 3 + i % 4),
              i % 2 == 0) for i in range(24)]

    def value(i, r, dtype, shape):
        g = torch.Generator().manual_seed(100 * i + r)
        x = torch.randint(-8, 9, shape, generator=g)
        return x.to(dtype)

    order = specs if rank == 0 else specs[::-1]
    handles = {}
    for name, dtype, shape, average in order:
        i = int(name.split(".")[1])
        handles[name] = hvd.allreduce_async(
            value(i, rank, dtype, shape).to(card), average=average,
            name=name)
    ok = True
    for name, dtype, shape, average in specs:
        i = int(name.split(".")[1])
        got = hvd.synchronize(handles[name])
        total = sum(value(i, r, torch.float64, shape)
                    for r in range(EAGER_RANKS))
        want = total / EAGER_RANKS if average else total
        if not dtype.is_floating_point and average:
            want = torch.floor(want)
        ok &= (got.is_cuda and got.dtype == dtype
               and torch.equal(got.cpu().double(), want.to(dtype).double()))
    res["allreduce_ok"] = bool(ok)
    g = hvd.allgather(torch.full((3 if rank == 0 else 5, 2), float(rank),
                                 device=card), name="eager.gather")
    res["allgather"] = g.cpu().tolist()
    b = hvd.broadcast(torch.full((4,), float(rank + 10), device=card),
                      root_rank=1, name="eager.bcast")
    res["broadcast"] = b.cpu().tolist()
    try:
        hvd.allreduce(torch.ones(2 + rank, device=card), name="eager.mismatch")
        res["mismatch"] = None
    except hvd.MismatchError as e:
        res["mismatch"] = str(e)
    coord = hvd.runtime.engine().coordinator
    for step in range(10):
        hs = [hvd.allreduce_async(torch.full((64,), float(step), device=card),
                                  name=f"eager.steady.{j}")
              for j in range(8)]
        for h in hs:
            hvd.synchronize(h)
    res["fast_lane_cycles"] = coord.fast_lane_cycles
    res["token_publishes"] = coord.token_publishes
    # the stall: rank 1 withholds one name
    t0 = time.perf_counter()
    h = hvd.allreduce_async(torch.ones(4, device=card), name="eager.both")
    if rank == 0:
        hs = hvd.allreduce_async(torch.ones(4, device=card),
                                 name="eager.withheld")
    hvd.synchronize(h)
    res["stalled"] = None
    if rank == 0:
        try:
            hvd.synchronize(hs)
        except hvd.StalledTensorError as e:
            res["stalled"] = str(e)
    res["stall_s"] = time.perf_counter() - t0
    dist.barrier()
    res["stall_warning"] = any("Stalled ranks:" in w for w in warnings)
    res["warnings"] = [w for w in warnings if "Stalled ranks:" in w][:1]
    hvd.shutdown()
    with open(f"{out_path}{rank}", "w") as f:
        json.dump(res, f)


def phase_eager_engine_2ranks(where):
    """The engine's negotiation across two processes on this card over
    gloo (:func:`eager_worker`; NCCL refuses two ranks on one card):
    24 names of mixed dtypes and shapes submitted in opposite orders,
    each result equal to the sum or mean computed on the host; an
    allgather of dim-0 sizes 3 and 5; a broadcast from root 1; a shape
    mismatch raising MismatchError with the reference's message on both
    ranks; the coordinator's steady-state bypass within 10 identical
    cycles; a stall (rank 1 withholds one name) that logs "Stalled
    ranks:" and raises StalledTensorError on rank 0. A negotiation
    check, not a speed figure: gloo moves card tensors through the
    host."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = os.path.join(tempfile.mkdtemp(), "eager")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--eager-rank", str(r), str(port), out])
             for r in range(EAGER_RANKS)]
    try:
        codes = [p.wait(timeout=EAGER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(codes == [0] * EAGER_RANKS, f"eager ranks exited with {codes}")
    res = []
    for r in range(EAGER_RANKS):
        with open(f"{out}{r}") as f:
            res.append(json.load(f))
    want_gather = [[0.0, 0.0]] * 3 + [[1.0, 1.0]] * 5
    mismatch = ("Mismatched allreduce tensor shapes: One rank sent a tensor "
                "of shape [2], but another rank sent a tensor of shape [3].")
    for r in res:
        check(r["allreduce_ok"], f"rank {r['rank']}: a sum or mean differs "
                                 f"from the host's")
        check(r["allgather"] == want_gather,
              f"rank {r['rank']}: allgather {r['allgather']}")
        check(r["broadcast"] == [11.0] * 4,
              f"rank {r['rank']}: broadcast {r['broadcast']}")
        check(r["mismatch"] == mismatch,
              f"rank {r['rank']}: mismatch message {r['mismatch']!r}")
        check(r["fast_lane_cycles"] > 0,
              f"rank {r['rank']}: no bypass cycle in 10 identical cycles "
              f"({r['fast_lane_cycles']} fast-lane, {r['token_publishes']} "
              f"token publishes)")
    check(res[0]["stall_warning"], "rank 0 logged no 'Stalled ranks:'")
    check(res[0]["stalled"] is not None and res[0]["stalled"].startswith(
        "One or more rank is stalled for longer than 3 seconds"),
        f"rank 0's stall: {res[0]['stalled']!r}")
    wall = time.perf_counter() - t0
    print(f"eager 2 ranks [{where}]: gloo through the host, not a speed "
          f"figure; 24 mixed-dtype names in opposite orders, allgather 3+5, "
          f"broadcast from 1, the mismatch and the stall as the reference "
          f"words them; bypass cycles {[r['fast_lane_cycles'] for r in res]}"
          f" of 10, stall raised after {res[0]['stall_s']:.1f} s; phase "
          f"{wall:.1f} s", flush=True)
    return {"wall_s": wall, "fast_lane": [r["fast_lane_cycles"] for r in res]}


def phase_eager_bench(where):
    """``python -m horovod_tpu_torch.bench.eager`` once at one rank on
    this card: its JSON line, checked for the metric and a positive
    value."""
    line = _bench_line(["horovod_tpu_torch.bench.eager"],
                       dict(os.environ), 600)
    check(line.get("metric") == "eager_allreduce_mbytes_sec"
          and line.get("value", 0) > 0, f"eager bench line {line}")
    print(f"eager bench [{where}]: {json.dumps(line)}", flush=True)
    return line


def moe_stats(tfm, moe, metrics, params, tokens, cfg, full_capacity):
    """One evaluation of the model on ``tokens`` whose MoE layers run
    with ``with_stats`` (the other layers as the model runs them), each
    layer's counts recorded in the hvd_moe_* families
    (``metrics.record_moe_step``). Returns (routed, dropped) summed over
    the MoE layers."""
    routed = dropped = 0.0
    with torch.no_grad():
        x = tfm.embed_tokens(params, tokens, cfg)
        for p in params["layers"]:
            x, _, _ = tfm._attention_block_kv(p, x, cfg)
            if "moe" not in p:
                x, _ = tfm._mlp_block(p, x, cfg)
                continue
            h = tfm._rmsnorm(x, p["ln2"]).to(cfg.dtype)
            y, _, st = moe.moe_layer(p["moe"], h, cfg.moe_cfg,
                                     with_stats=True,
                                     full_capacity=full_capacity)
            x = x + y.to(cfg.dtype)
            r, d = st["routed_tokens"].item(), st["dropped_tokens"].item()
            metrics.record_moe_step(r, d, st["load_balance_loss"].item(),
                                    st["chunks"])
            routed, dropped = routed + r, dropped + d
    return routed, dropped


def full_capacity_logits(tfm, params, tokens, cfg):
    """The model's f32 logits with its MoE layers at full capacity (the
    serving mode)."""
    with torch.no_grad():
        x = tfm.embed_tokens(params, tokens, cfg)
        for p in params["layers"]:
            x, _, _ = tfm._attention_block_kv(p, x, cfg)
            x, _ = tfm._mlp_block(p, x, cfg, moe_full_capacity=True)
        return tfm._head(params, x, cfg)


def router_probs(tfm, moe, params, tokens, cfg, layer):
    """The router probabilities (t, E) of MoE layer ``layer`` (the model
    run up to it) on the host, and each position's k experts (sorted)."""
    with torch.no_grad():
        x = tfm.embed_tokens(params, tokens, cfg)
        for p in params["layers"][:layer]:
            x, _ = tfm._one_layer(p, x, cfg, tfm.ShardAxes())
        p = params["layers"][layer]
        x, _, _ = tfm._attention_block_kv(p, x, cfg)
        h = tfm._rmsnorm(x, p["ln2"]).to(cfg.dtype)
        probs = moe._router(h.reshape(-1, cfg.d_model),
                            p["moe"]["w_router"])
        picks = moe._top_k(probs, cfg.moe_top_k)[1]
        return probs.cpu(), torch.sort(picks, dim=-1).values.cpu()


def phase_moe_parity(tfm, moe, card, init):
    """The MoE layer at full width (d 2048, ff 8192, E 8, top-2, 4 x 4096
    tokens, f32) on the card: its routing tables rebuilt as dense
    tensors equal ``_top_k_dispatch``'s exactly, and ``moe_layer``
    against ``moe_layer_reference`` (the dense einsums): the same aux and
    counts, outputs within MOE_LAYER_REL of the largest (untimed: the
    phase runs beside the tp phase).
    Then flagship-moe cut to 2 layers (the first two of ``init``, a
    host tree: layer 1 MoE), B 1 x MOE_PARITY_SEQ, dense attention and
    full capacity, on the card against the same weights on the CPU:
    router probabilities within MOE_PROB_ATOL, logits within LOGITS_ATOL
    wherever both pick the same experts (all but MOE_FLIPS positions)."""
    cfg = moe.MoEConfig(d_model=FLAGSHIP["d_model"], d_ff=FLAGSHIP["d_ff"],
                        num_experts=MOE_MODEL["moe_num_experts"],
                        top_k=MOE_MODEL["moe_top_k"], dtype=torch.float32)
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(4), card)
    # a router leaning on expert 0, so that its queue overflows and the
    # drop path runs (random rows alone spread over the experts evenly)
    params["w_router"][:, 0] *= 4
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, device=card,
                    generator=torch.Generator(device=card).manual_seed(5))
    t = TRAIN_BATCH * TRAIN_SEQ
    cap = moe.capacity(t, cfg)
    probs = moe._router(x.reshape(t, -1), params["w_router"])
    dense = moe._top_k_dispatch(probs, cfg.top_k, cap)
    tables = moe.routing_to_dense(moe._route(probs, cfg.top_k, cap), cap)
    same = [torch.equal(a, b) for a, b in zip(tables, dense)]
    del dense, tables
    torch.cuda.empty_cache()
    y, aux, st = moe.moe_layer(params, x, cfg, with_stats=True)
    y_ref, aux_ref, st_ref = moe.moe_layer_reference(params, x, cfg,
                                                     with_stats=True)
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    counts = [(st[k].item(), st_ref[k].item())
              for k in ("routed_tokens", "dropped_tokens")]
    print(f"moe parity layer (d {cfg.d_model}, ff {cfg.d_ff}, E "
          f"{cfg.num_experts}, top-{cfg.top_k}, {t} tokens, capacity {cap}, "
          f"f32): tables equal dispatch/combine {same}; routed/dropped "
          f"{counts}; aux {aux.item():.6f} vs {aux_ref.item():.6f}; "
          f"max|dy| {err:.3g} of max|y| {scale:.3g} (tol "
          f"{MOE_LAYER_REL * scale:.3g})", flush=True)
    check(all(same), "MoE routing tables differ from the dense dispatch")
    check(all(a == b for a, b in counts) and aux.item() == aux_ref.item(),
          "MoE counts or aux differ from the dense plain version")
    check(counts[1][0] > 0, "the parity layer dropped nothing")
    check(err <= MOE_LAYER_REL * scale,
          "MoE index form disagrees with the dense plain version")
    del params, x, probs, y, y_ref
    torch.cuda.empty_cache()

    kw = dict(MOE_MODEL, n_layers=2, moe_layers=(1,))
    tcfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="dense",
                                 **kw)
    host = dict(init, layers=init["layers"][:2])
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (1, MOE_PARITY_SEQ)))
    with torch.no_grad():
        want = full_capacity_logits(tfm, host, tokens, tcfg)
        probs, picks = router_probs(tfm, moe, host, tokens, tcfg, 1)
    params = to_card(host, card)
    with torch.no_grad():
        got = full_capacity_logits(tfm, params, tokens.to(card), tcfg).cpu()
    card_probs, card_picks = router_probs(tfm, moe, params, tokens.to(card),
                                          tcfg, 1)
    dp = float((probs - card_probs).abs().max())
    same = (picks == card_picks).all(-1).view(tokens.shape)
    err = (got - want).abs().amax(-1)
    diff = float(err[same].max())
    worst_flip = float(err[~same].max()) if (~same).any() else 0.0
    print(f"moe parity flagship-moe 2 layers (layer 1 MoE, full capacity, "
          f"dense attention) B 1 x {MOE_PARITY_SEQ}, card vs CPU: router "
          f"probabilities max|d| {dp:.3g} (tol {MOE_PROB_ATOL:g}); "
          f"{int((~same).sum())} positions picked other experts (at most "
          f"{MOE_FLIPS}; their max|d logits| {worst_flip:.4g}); max|d "
          f"logits| {diff:.4g} (tol {LOGITS_ATOL:g}) over the "
          f"{int(same.sum())} others; argmax agreement "
          f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.3f}",
          flush=True)
    check(torch.isfinite(got).all() and got.shape == want.shape,
          "flagship-moe logits shape or finiteness")
    check(dp <= MOE_PROB_ATOL, "flagship-moe router: card and CPU disagree")
    check(int((~same).sum()) <= MOE_FLIPS,
          f"{int((~same).sum())} of {MOE_PARITY_SEQ} positions routed apart")
    check(diff <= LOGITS_ATOL, "flagship-moe logits: card and CPU disagree")
    del params
    torch.cuda.empty_cache()


# flagship-moe's traced steps a window. A train step's expert phase
# holds the FFN's forward products and their backward (two products for
# each), a forward alone the first: about 3 times it.
MOE_TRACE_STEPS, MOE_EXPERT_TRAIN_MIN = 2, 2.5
# Replay windows traced at most, until one keeps every device record.
# CUPTI drops records now and then (ROADMAP, item 16's leftovers): a
# replay short of k events places each event only where the k + 1 nodes
# it may be share a phase, and flagship-moe's phases change every few
# nodes, so 29 records lost in one window of a full run put 252 events
# (208 ms a step) in ``other``.
MOE_TRACE_TRIES = 3


def marker_cost(device, n=2000):
    """Host seconds the backward markers of one MoE region add to a
    step when nothing traces (diag/xla_trace.py ``phase_region``): a
    region's forward and backward on a small tensor with them, less the
    same with the forward range alone."""
    from torch.profiler import record_function

    from horovod_tpu_torch.diag.xla_trace import phase_region
    x = torch.ones(8, device=device, requires_grad=True)

    def unmarked(name, fn, *tensors):
        with record_function(name):
            return fn(*tensors)

    def per_call(region):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            region("hvd_expert", lambda t: t * 2.0, x).sum().backward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    per_call(phase_region)  # warm-up
    return max(per_call(phase_region) - per_call(unmarked), 0.0)


def trace_moe_train(hvd, fa, where, lm, opt, step, tokens, targets, plain):
    """flagship-moe's step by phase (diag/xla_trace.py): MOE_TRACE_STEPS
    replays of ``step`` (the program re-captures once for its phase
    map; traced again, up to MOE_TRACE_TRIES windows, while the profiler
    drops device records, and read from the window that lost the
    fewest), then one untraced eager step and
    MOE_TRACE_STEPS traced ones
    (the trace phase's eager step, its regions under the phase ranges),
    then one ``torch.no_grad()`` forward of the batch. Each window goes
    through :func:`check_trace`; the replay's phases above
    TRACE_PHASE_FLOOR of the step lie within TRACE_PHASE_REL of the eager
    step's; each train window's ``expert`` is at least
    MOE_EXPERT_TRAIN_MIN times the forward's; the traced replays launch
    by route ``plain`` (an untraced replay's) and the traced eager steps
    the untraced one's; the backward markers' idle cost
    (:func:`marker_cost`, a region a MoE layer) stays under
    TRACE_OVERHEAD_MAX of the untraced eager step."""
    from torch.profiler import record_function
    diag_dir = tempfile.mkdtemp(prefix="chip-moe-trace-")

    def launches_a_call(fn, calls):
        before = read_launches(fa)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        after = read_launches(fa)
        return {k: (after[k] - before[k]) / calls for k in after}

    def eager_step():
        opt.zero_grad(set_to_none=True)
        with record_function("hvd_forward"):
            loss = lm.loss(tokens, targets)
        with record_function("hvd_backward"):
            loss.backward()
        with record_function("hvd_optimizer"):
            opt.step()

    def ticked():
        tracer.tick(owner=trace_moe_train)
        eager_step()

    best = None
    for window in range(1, MOE_TRACE_TRIES + 1):
        tracer = hvd.trace_steps(MOE_TRACE_STEPS, out_dir=diag_dir)
        replayed = launches_a_call(lambda: step(tokens, targets),
                                   MOE_TRACE_STEPS + 1)
        graphs = (tracer.last_summary or {}).get("graphs", {})
        lost = sum(g["lost"] for g in graphs.values())
        if best is None or lost < best[0]:
            best = (lost, tracer.last_summary, tracer.last_dir)
        if not lost:
            break
        print(f"moe compiled replay window {window}: the profiler dropped "
              f"{lost} device records "
              f"({tracer.last_summary['unmatched']} events unplaced)",
              flush=True)
    replay = check_trace("moe compiled replay", best[1], best[2],
                         MOE_TRACE_STEPS, where, "step")
    t0 = time.perf_counter()
    untraced = launches_a_call(eager_step, 1)
    step_s = time.perf_counter() - t0
    marker_frac = (marker_cost(lm.params["embed"].device)
                   * len(MOE_MODEL["moe_layers"]) / step_s)
    tracer = hvd.trace_steps(MOE_TRACE_STEPS, out_dir=diag_dir)
    traced = launches_a_call(ticked, MOE_TRACE_STEPS + 1)
    eager = check_trace("moe eager step", tracer.last_summary,
                        tracer.last_dir, MOE_TRACE_STEPS, where, "step")

    tracer = hvd.trace_steps(1, out_dir=diag_dir)
    tracer.tick(owner=trace_moe_train)
    with torch.no_grad():
        lm.loss(tokens, targets)
    tracer.tick(owner=trace_moe_train)
    alone = check_trace("moe forward only", tracer.last_summary,
                        tracer.last_dir, 1, where)
    ratio = {name: ms["expert"] / alone["expert"]
             for name, ms in (("eager", eager), ("replay", replay))}

    def shown(counts):
        return {k: v for k, v in counts.items() if v}

    print(f"moe train trace [{where}]: expert a train step over the "
          f"no_grad forward's ({alone['expert']:.3f} ms): eager "
          f"{ratio['eager']:.3f}, replay {ratio['replay']:.3f} (at least "
          f"{MOE_EXPERT_TRAIN_MIN}); launches a traced replay "
          f"{shown(replayed)} (untraced {shown(plain)}), a traced eager "
          f"step {shown(traced)} (untraced {shown(untraced)}); the backward "
          f"markers' idle cost {marker_frac:.6f} of the eager step "
          f"({step_s * 1e3:.1f} ms)", flush=True)
    check(marker_frac < TRACE_OVERHEAD_MAX,
          f"the backward markers cost {marker_frac} of a step")
    check(replayed == plain, f"traced replays launch {replayed}, untraced "
                             f"{plain}")
    check(traced == untraced, f"traced eager steps launch {traced}, "
                              f"untraced {untraced}")
    check(min(ratio.values()) >= MOE_EXPERT_TRAIN_MIN,
          f"expert a train step over a forward's: {ratio}")
    total = sum(eager.values())
    for ph, ms in eager.items():
        if ph != "other" and ms > TRACE_PHASE_FLOOR * total:
            check(abs(replay[ph] - ms) <= TRACE_PHASE_REL * ms,
                  f"moe {ph}: replay {replay[ph]:.3f} ms against eager "
                  f"{ms:.3f} ms a step")
    shutil.rmtree(diag_dir, ignore_errors=True)


def phase_moe_train(hvd, fa, tfm, moe, metrics, card, where, init):
    """Main path 7: flagship-moe at 4 x 4096 through
    :func:`phase_compiled_train` (3 eager steps, then 3 compiled steps
    and 4 replays, bitwise against eager, expert keys on the exchange),
    then its step traced by phase (:func:`trace_moe_train`); then one
    evaluation of the trained model on the batch with the MoE layers'
    counts recorded: the hvd_moe_* counters must give ``dropped == t * k
    * moe_layers - routed``. Returns {kernel: launches} of the compiled
    steps."""
    launches, params, tokens, _ = phase_compiled_train(
        hvd, fa, tfm, card, where, model=MOE_MODEL, label="moe train",
        expert_keys=MOE_EXPERT_KEYS, init=init,
        then=lambda *run: trace_moe_train(hvd, fa, where, *run))
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                **MOE_MODEL)
    r0 = metrics.MOE_ROUTED_TOKENS.value()
    d0 = metrics.MOE_DROPPED_TOKENS.value()
    routed, dropped = moe_stats(tfm, moe, metrics, params, tokens, cfg,
                                False)
    got_r = metrics.MOE_ROUTED_TOKENS.value() - r0
    got_d = metrics.MOE_DROPPED_TOKENS.value() - d0
    assigned = TRAIN_BATCH * TRAIN_SEQ * cfg.moe_top_k * len(cfg.moe_layers)
    print(f"moe train routing after the steps: {got_r:.0f} routed, "
          f"{got_d:.0f} dropped of {assigned} assignments "
          f"({got_d / assigned:.4f}); load-balance loss "
          f"{metrics.MOE_LOAD_BALANCE_LOSS.value():.4f} (last layer)",
          flush=True)
    check((got_r, got_d) == (routed, dropped) and got_d == assigned - got_r,
          f"hvd_moe counters: routed {got_r}, dropped {got_d} of {assigned}")
    del params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_moe_serve(fa, serve, metrics, tfm, moe, card, where, init):
    """Main path 8: the serving workload on flagship-moe through the
    eager engine and the graph engine (:func:`serve_both_engines`), MoE
    layers at full capacity: tokens identical, steady decode hit rate
    1.0, no fallback; then the prompts' MoE counts at full capacity:
    nothing dropped. Returns {kernel: launches} of both timed rounds."""
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                **MOE_MODEL)
    lm = tfm.TransformerLM(cfg, to_card(init, card), device=card)
    res = serve_both_engines(fa, serve, metrics, lm, card, where,
                             "moe serve")
    graphs = res["graphs"]
    check(graphs["steady_hit_rate"] == 1.0,
          f"moe serve: steady decode hit rate {graphs['steady_hit_rate']}")
    d0 = metrics.MOE_DROPPED_TOKENS.value()
    tokens = torch.tensor(prompts(cfg.vocab_size), device=card)
    routed, dropped = moe_stats(tfm, moe, metrics, lm.params, tokens, cfg,
                                True)
    print(f"moe serve at full capacity: {routed:.0f} routed, {dropped:.0f} "
          f"dropped over the prompts' {len(cfg.moe_layers)} MoE layers",
          flush=True)
    check(dropped == 0 and metrics.MOE_DROPPED_TOKENS.value() == d0
          and routed == tokens.numel() * cfg.moe_top_k * len(cfg.moe_layers),
          f"full capacity dropped {dropped} of {routed + dropped}")
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return {k: res["eager"]["launches"][k] + graphs["launches"][k]
            for k in graphs["launches"]}


# bench.py's ResNet-50: 224 x 224, bf16, the per-chip batch its sweep
# picks on this card (256), SGD(0.01); one warm-up and RESNET_STEPS timed
# steps on one batch (numpy seed 2).
RESNET_BATCH, RESNET_SIZE, RESNET_STEPS = 256, 224, 5
# bench.py's MFU constant: 3 x 4.09 G multiply-adds per image (x2 for
# FLOPs), over the bf16 peak.
RESNET_TRAIN_MACS_PER_IMAGE = 3 * 4.09e9
# The f32 forward at batch 2 (train mode) on the card against the same
# weights on the CPU: both exact f32 (TF32 off for cuDNN and matmuls), in
# other summation orders through 53 convolutions and batch norms; held
# to 1e-3 of the largest |logit|.
RESNET_F32_REL = 1e-3
# Running statistics after one bf16 train step against Flax's rule
# computed here in f64 from each batch norm's input: the port sums in
# f32 over up to 3.2 M values a channel.
BN_STATS_ATOL, BN_STATS_RTOL = 1e-5, 1e-4
# Batch norms whose statistics are checked: the stem's, a zero-scale
# third one, the one after a stride-2 3x3 (SAME pads it (0, 1)), a
# projection's and the last.
BN_CHECKED = ("bn_init", "BottleneckBlock_0.BatchNorm_2",
              "BottleneckBlock_3.BatchNorm_1", "BottleneckBlock_3.proj_bn",
              "BottleneckBlock_15.BatchNorm_2")


def phase_resnet(hvd, card, where):
    """ResNet-50 as bench.py trains it: the f32 forward against the CPU,
    then the bf16 channels_last model at batch RESNET_BATCH through
    init -> broadcast_parameters -> DistributedOptimizer(SGD(0.01)): the
    batch-norm statistics after one step against Flax's rule, a falling
    loss over RESNET_STEPS more, the bucket all-reduces counted, img/s and
    MFU printed. The convolutions run on cuDNN: the reference has no hand
    kernel for them, so this path launches none of the kernels above."""
    from horovod_tpu_torch import hardware
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.models._flax_ops import BatchNorm

    # The f32 forward, card against CPU, on the same weights; the batch
    # norms' scales and biases drawn so that no block passes through.
    gen = torch.Generator().manual_seed(0)
    cpu = ResNet50(dtype=torch.float32, generator=gen, device="cpu")
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, BatchNorm):
                m.scale.normal_(1.0, 0.2, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
    on_card = ResNet50(dtype=torch.float32, device=card)
    on_card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 3, RESNET_SIZE, RESNET_SIZE, generator=gen)
    with torch.no_grad():
        want = cpu(x)
        got = on_card(x.to(card)).cpu()
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    print(f"resnet f32 forward B 2 x {RESNET_SIZE}^2, card against CPU: "
          f"max|d| {err:.3g} of max|logit| {top:.3g} (tol "
          f"{RESNET_F32_REL:g} of it); TF32 for cuDNN "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    check(err <= RESNET_F32_REL * top, "f32 ResNet-50 card != CPU")
    del cpu, on_card

    hvd.init(device=card)
    model = ResNet50(generator=torch.Generator().manual_seed(0),
                     device=card).to(memory_format=torch.channels_last)
    model.train()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters())
    n_buckets = len(opt.exchange_buckets)
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE), dtype=np.float32)).to(
        card, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    labels = torch.from_numpy(rng.integers(0, 1000, RESNET_BATCH)).to(card)
    stats = hvd.runtime.live_state().stats
    calls0 = stats.counter("allreduce")
    bns = dict(model.named_modules())
    before = {n: (bns[n].mean.clone(), bns[n].var.clone())
              for n in BN_CHECKED}
    seen = {}
    hooks = [bns[n].register_forward_pre_hook(
        lambda mod, inp, n=n: seen.__setitem__(n, inp[0].detach()))
        for n in BN_CHECKED]

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step()]
    for h in hooks:
        h.remove()
    worst = 0.0
    for n in BN_CHECKED:
        x = seen.pop(n).double()
        mean = x.mean(dim=(0, 2, 3))
        var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
        for got_s, old, batch in ((bns[n].mean, before[n][0], mean),
                                  (bns[n].var, before[n][1], var)):
            want_s = 0.9 * old.double() + 0.1 * batch
            err = (got_s.double() - want_s).abs()
            check(bool((err <= BN_STATS_ATOL
                        + BN_STATS_RTOL * want_s.abs()).all()),
                  f"{n}: running statistics off Flax's rule by "
                  f"{err.max().item():.3g}")
            worst = max(worst, (err / (want_s.abs() + 1e-3)).max().item())
        del x
    print(f"resnet batch-norm statistics after one step, {len(BN_CHECKED)} "
          f"layers against Flax's rule in f64: worst relative "
          f"{worst:.3g} (tol {BN_STATS_ATOL:g} + {BN_STATS_RTOL:g} "
          f"relative)", flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(RESNET_STEPS):
        losses.append(step())
    end.record()
    torch.cuda.synchronize()
    losses = [x.item() for x in losses]
    ms = start.elapsed_time(end) / RESNET_STEPS
    calls = stats.counter("allreduce") - calls0
    check(all(np.isfinite(losses)), f"resnet losses {losses}")
    check(losses[-1] < losses[0], f"resnet loss did not fall: {losses}")
    check(calls == (1 + RESNET_STEPS) * n_buckets,
          f"{calls} all-reduces in {1 + RESNET_STEPS} steps of "
          f"{n_buckets} buckets")
    img_s = RESNET_BATCH / (ms / 1e3)
    peak = hardware.peak_flops_per_chip(None, card)
    mfu = RESNET_TRAIN_MACS_PER_IMAGE * img_s / peak if peak else None
    print(f"resnet losses: {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    print(f"resnet50 train B {RESNET_BATCH} x {RESNET_SIZE}^2 bf16 "
          f"channels_last [{where}]: step {ms:.1f} ms (mean of "
          f"{RESNET_STEPS}), {img_s:.1f} img/s, MFU "
          f"{'n/a' if mfu is None else f'{mfu:.4f}'} (bench.py's constant: "
          f"multiply-adds, x2 for FLOPs) against {peak / 1e12:.0f} TFLOP/s "
          f"bf16; {calls // (1 + RESNET_STEPS)} all-reduce(s) a step; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    del opt, model, images
    gc.collect()
    hvd.shutdown()
    torch.cuda.empty_cache()


# bench.transformer's depth in the bench phase (its widths the flagship's)
BENCH_LAYERS = 2


def _bench_line(args, env, timeout):
    """Run a bench module; its one JSON line (the last of its output)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    check(out.returncode == 0,
          f"{' '.join(args)} exited {out.returncode}: {out.stderr[-3000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"bench {' '.join(args)} in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(line)[:1500]}", flush=True)
    return line


def phase_scaling(where):
    """``horovod_tpu_torch.bench.scaling``'s ``main()`` at its defaults,
    from this process (one torch import fewer than ``python -m``; its
    size-1 rank is launched as a user's run launches it): on one card the
    size-1 row alone, said so on a ``#`` line, and no other row. Returns
    the line."""
    import contextlib
    import io

    from horovod_tpu_torch.bench import scaling
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        scaling.main([])
    out = buf.getvalue()
    line = json.loads(out.strip().splitlines()[-1])
    print(f"bench horovod_tpu_torch.bench.scaling in "
          f"{time.perf_counter() - t0:.1f} s: {json.dumps(line)}", flush=True)
    rows = [ln for ln in out.splitlines() if ln.startswith("# n=")]
    img_sec = float(rows[0].split()[2]) if len(rows) == 1 else 0.0
    check(line.get("metric") == "weak_scaling_efficiency"
          and line.get("per_n") == {"1": 100.0} and line.get("devices") == 1
          and line.get("backend") == "nccl",
          f"bench.scaling line {line}")
    check(rows and rows[0].startswith("# n=1:") and len(rows) == 1
          and img_sec > 0 and "# one rank only" in out,
          f"bench.scaling rows {rows}")
    print(f"bench.scaling [{where}]: size 1 {img_sec} img/s "
          f"(settings {line['settings']}), per_n {line['per_n']}",
          flush=True)
    return line


def phase_bench(where):
    """Both bench modules as a user runs them: bench.resnet in its
    HOROVOD_BENCH_SMOKE shrink (with the flagship's row at 1 iteration
    and 2 of its 8 layers), bench.transformer at --iters 2 --layers 2
    (the flagship's widths; the compiled train and trace phases time its
    whole depth). Each line must name its metric, with a positive value
    and a numeric MFU on this card. Then bench.scaling alone
    (:func:`phase_scaling`), whose line it returns."""
    env = {**os.environ, "HOROVOD_BENCH_SMOKE": "1"}
    res = _bench_line(["horovod_tpu_torch.bench.resnet"], env, 600)
    env.pop("HOROVOD_BENCH_SMOKE")
    tfm = _bench_line(["horovod_tpu_torch.bench.transformer", "--iters",
                       "2", "--layers", str(BENCH_LAYERS)], env, 600)
    moe = _bench_line(["horovod_tpu_torch.bench.transformer", "--moe",
                       "--expert-parallel", "1"], env, 300)
    for line, metric in ((res, "resnet50_img_sec_per_chip"),
                         (res["transformer"],
                          "transformer_tokens_per_sec_per_chip"),
                         (tfm, "transformer_tokens_per_sec_per_chip")):
        check(line.get("metric") == metric and line["value"] > 0
              and isinstance(line["mfu_pct"], (int, float)),
              f"bench line {line}")
    check(tfm["attention"] == "flash" and tfm["layers"] == BENCH_LAYERS
          and res["transformer"]["layers"] == BENCH_LAYERS,
          f"bench attention {tfm['attention']}, layers {tfm['layers']} and "
          f"{res['transformer']['layers']}")
    compiled, srv = res["compiled_step"], res["serve"]
    check(compiled["fallback_steps"] == 0
          and compiled["step_program_cache_hit_rate"] == 1.0
          and compiled["img_sec_per_chip"] > 0,
          f"bench compiled_step row {compiled}")
    check(srv["decode_cache_hit_rate"] >= 0.9 and srv["fallback_steps"] == 0
          and srv["tokens_per_sec"] > 0, f"bench serve row {srv}")
    for row in (moe["moe"], res["moe"]):
        check(row["tokens_per_sec_per_chip"] > 0 and row["fallback_steps"]
              == 0 and row["step_program_cache_hit_rate"] == 1.0
              and row["expert_parallel"] == 1,
              f"bench moe row {row}")
    check(moe["metric"] == "moe_tokens_per_sec_per_chip",
          f"bench moe line {moe}")
    check("divisible by 8" in res["mesh3d"].get("skipped", ""),
          f"bench mesh3d row {res['mesh3d']}: one card cannot hold the "
          "2x2x2 mesh")
    # the phase trace's rows (bench.py's): filled, none skipped
    flight = res["flight_step_phase_breakdown"]
    check(isinstance(flight, dict) and flight["compute_ms"] > 0
          and 0 <= res["flight_overhead_frac"] < TRACE_OVERHEAD_MAX
          and 0 <= res["trace_overhead_frac"] < TRACE_OVERHEAD_MAX
          and res["control_plane"]["acceptance"]["decisions_bit_identical"]
          and res["control_plane"]["acceptance"]["graduated_o1_reads_ok"],
          f"bench flight rows {flight}, {res['flight_overhead_frac']}, "
          f"{res['trace_overhead_frac']}, {res['control_plane']}")
    phases, ab = compiled["step_phase_breakdown"], compiled["overlap_ab"]
    micro = compiled["overlap_microbench"]
    check(isinstance(phases, dict) and phases["forward"] > 0
          and phases["backward"] > 0 and phases["optimizer"] > 0
          and isinstance(compiled["wire_stage_ms"], dict)
          and isinstance(compiled["exchange_hidden_frac"], float)
          and ab["step_ms_base"] > 0 and ab["step_ms_tuned"] > 0
          and micro["step_ms_base"] > 0 and micro["step_ms_tuned"] > 0
          and 0 <= compiled["trace_overhead_frac"] < TRACE_OVERHEAD_MAX,
          f"bench compiled trace rows {phases}, {ab}, {micro}")
    for row in (moe["moe"], res["moe"]):
        check(row["alltoall_ms_per_step"] is None
              and row["alltoall_hidden_frac"] is None
              and row["step_phase_breakdown"]["expert"] > 0,
              f"bench moe trace rows {row}")
    print(f"bench trace rows [{where}]: step_phase_breakdown {phases}; "
          f"wire_stage_ms {compiled['wire_stage_ms']}; exchange_hidden_frac "
          f"{compiled['exchange_hidden_frac']}; overlap_ab {ab}; "
          f"overlap_microbench {micro}; flight_step_phase_breakdown "
          f"{flight}; flight_overhead_frac {res['flight_overhead_frac']}; "
          f"trace_overhead_frac {res['trace_overhead_frac']}; moe "
          f"step_phase_breakdown {moe['moe']['step_phase_breakdown']}",
          flush=True)
    zero = res["zero_profile"]
    check("skipped" not in zero and zero["dcn_bytes_saved_frac"] is None
          and zero["dcn_loss_delta"] == 0.0
          and zero["zero_memory"]["params_stripe_bytes"]
          == zero["zero_memory"]["params_full_bytes"] > 0,
          f"bench zero_profile row {zero}")
    print(f"bench [{where}]: resnet smoke {res['value']} img/s (MFU "
          f"{res['mfu_pct']}%, multiply-adds), compiled "
          f"{compiled['img_sec_per_chip']} img/s (python overhead "
          f"{compiled['python_overhead_ms']} ms a step); serve row "
          f"{srv['tokens_per_sec']} tokens/s, token latency p50/p99 "
          f"{srv['token_latency_p50_ms']}/{srv['token_latency_p99_ms']} ms; "
          f"transformer {tfm['value']} tokens/s (MFU {tfm['mfu_pct']}%); "
          f"moe {moe['value']} tokens/s (drop fraction "
          f"{moe['moe']['drop_fraction']}, resnet's row "
          f"{res['moe']['tokens_per_sec_per_chip']}); zero_profile "
          f"{json.dumps(zero)}", flush=True)
    return phase_scaling(where)


# ------------------------------------------------- autotune and launcher
# The autotuner (autotune.py) on the eager engine, and the launcher
# (run/): the flagship tuned at one rank, the flagship through a gang
# restart, two launched ranks tuned in lockstep over gloo, the churn
# soak, and the control plane's bench rows.
AUTOTUNE_STEPS = 12
AUTOTUNE_FUSION_MAX = 64 * 1024 * 1024
AUTOTUNE_CYCLE = (1.0, 25.0)
LAUNCH_TIMEOUT_S = 600
LAUNCH_RANKS, LAUNCH_STEPS = 2, 8
# The control-plane curve's star and tree rounds a world (bench.py's 30
# and 20): a round of world 256 takes its 256 simulated members about
# 1.5 s of host time, and the curve runs alone, after the timed phases,
# inside the run's 1200 s: 4 (6 before). At 2 rounds the curve took
# 27 s less but the star's rate read high (its first rounds are its
# cheapest) and the tree's speedup at world 256 fell to 3.5, under
# simrank's acceptance of 4.
CONTROL_ROUNDS = 4


def _autotune_domain(tuner, fusion, cycle, padding, depth):
    return (0 <= fusion <= AUTOTUNE_FUSION_MAX
            and AUTOTUNE_CYCLE[0] <= cycle <= AUTOTUNE_CYCLE[1]
            and padding in tuner.COMBOS and depth in tuner._depths)


def phase_autotune(hvd, fa, tfm, card, where, eager_row):
    """Main path autotune: the flagship at 4 x 4096 as
    :func:`phase_eager_engine` trains it (each gradient to
    ``hvd.allreduce_async_`` from its hook, AdamW), under
    ``HOROVOD_AUTOTUNE=1`` with one warm-up sample and a window of one
    step's collectives at threshold 0 (one a gradient). Gates: the log
    holds one row a sample, at least 4; every applied (fusion, cycle,
    padding, depth) lies in the reference's domain; every cycle fuses
    what :func:`plan_fusion_plain` gives for its gradients at the
    threshold in force, the step's fused all-reduces are those cycles'
    and, in a step the threshold held through, what
    :func:`predict_buckets` gives for the hooks' order; the losses of
    the eager phase's steps equal its losses bitwise (one rank: the
    bucketing cannot change the sum); the program misses stay within
    the distinct plans (the engine runs no captured program) and the
    wire layout misses within the distinct bucket signatures; every
    bucket feeds the tuner its exposed time (the consumer stream's stall
    at the hand-over, 0 or more), all but the last step's by the next
    step. Returns ({kernel: launches}, its figures)."""
    log = os.path.join(tempfile.mkdtemp(), "autotune.csv")
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    lm = tfm.TransformerLM(cfg, seed0_params(tfm, cfg, card), device=card)
    params = list(lm.parameters())
    env = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
           "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": str(len(params)),
           "HOROVOD_AUTOTUNE_LOG": log, "HOROVOD_PROFILER_DISABLE": "1"}
    os.environ.update(env)
    hvd.init(device=card)
    state = hvd.runtime.live_state()
    engine, tuner = state.engine, state.autotuner
    check(tuner is not None and engine.autotuner is tuner,
          "HOROVOD_AUTOTUNE=1: process 0 holds no tuner, or the engine "
          "does not feed it")
    opt = torch.optim.AdamW(params, **ADAMW)
    names = {p: n for n, p in lm.named_parameters()}
    sizes = {n: p.numel() * p.element_size() for p, n in names.items()}
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (TRAIN_BATCH, TRAIN_SEQ))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)
    step_now = [0]
    cycles = []    # (step, threshold, padding, [bytes], [group payloads], sigs)
    applied = []   # (step, fusion, cycle, padding, depth)
    samples = []   # (step, wire layout misses so far)
    plan, apply_, finish = (engine._plan_fusion, tuner._apply,
                            tuner._finish_sample)

    def recording_plan(allreduces):
        out = plan(allreduces)
        cycles.append((step_now[0], int(engine.config.fusion_threshold),
                       int(engine.config.padding_algo),
                       [e.nbytes for e, _, _ in allreduces],
                       [sum(e.nbytes for e, _ in b) for b, _ in out],
                       [tuple(e.name for e, _ in b) for b, _ in out]))
        return out

    def recording_apply(fusion, cycle, combo=None, depth=None):
        apply_(fusion, cycle, combo, depth)
        applied.append((step_now[0], int(fusion), float(cycle),
                        tuner._combo, tuner._depth))

    def recording_finish():
        finish()
        samples.append((step_now[0], engine.wire_cache.misses))

    exposures = []  # (step, exposed s): one a bucket, from the hand-over
    overlap = tuner.record_overlap

    def recording_overlap(hidden, exposed):
        exposures.append((step_now[0], exposed))
        overlap(hidden, exposed)

    engine._plan_fusion = recording_plan
    tuner._apply = recording_apply
    tuner._finish_sample = recording_finish
    tuner.record_overlap = recording_overlap
    pending, order = [], []

    def hook(p):
        order.append(names[p])
        pending.append(hvd.allreduce_async_(p.grad, name=names[p]))

    hooks = [p.register_post_accumulate_grad_hook(hook) for p in params]
    stats = state.stats
    programs0 = state.programs.misses
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(fa)
    rows = []
    for i in range(AUTOTUNE_STEPS):
        step_now[0] = i
        thr0 = engine.config.fusion_threshold
        calls0 = stats.counter("allreduce") + stats.counter("allreduce_cached")
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        pending.clear()
        order.clear()
        opt.zero_grad(set_to_none=True)
        loss = lm.loss(tokens, targets)
        loss.backward()
        for h in pending:
            hvd.synchronize(h)
        opt.step()
        e1.record()
        torch.cuda.synchronize()
        rows.append({"step_ms": e0.elapsed_time(e1), "loss": loss.item(),
                     "order": list(order),
                     "thr0": thr0, "thr1": engine.config.fusion_threshold,
                     "buckets": stats.counter("allreduce")
                     + stats.counter("allreduce_cached") - calls0})
    launches = read_launches(fa)
    peak = torch.cuda.max_memory_allocated()
    for h in hooks:
        h.remove()
    engine._plan_fusion = plan
    program_misses = state.programs.misses - programs0
    wire_misses = engine.wire_cache.misses
    with open(log) as f:
        header, *log_rows = [line.rstrip("\n").split(",") for line in f]
    check(len(log_rows) == tuner._samples >= 4,
          f"autotune log {len(log_rows)} rows for {tuner._samples} samples "
          f"(4 or more expected)")
    for r in log_rows:
        check(_autotune_domain(tuner, float(r[1]), float(r[2]), int(r[3]),
                               int(r[4])),
              f"autotune log row outside the domain: {r}")
    check(applied, "the tuner applied nothing")
    for _, fusion, cycle, pad, depth in applied:
        check(_autotune_domain(tuner, fusion, cycle, pad, depth),
              f"applied {fusion, cycle, pad, depth} outside the domain")
    for step, thr, pad, nbytes, groups, _ in cycles:
        want = plan_fusion_plain(nbytes, thr)
        check(groups == want, f"step {step}: a cycle at threshold {thr} "
                              f"fused {groups}, the planner gives {want}")
    held = 0
    for i, r in enumerate(rows):
        mine = [c for c in cycles if c[0] == i]
        check(r["buckets"] == sum(len(c[4]) for c in mine),
              f"step {i}: {r['buckets']} fused all-reduces, its cycles "
              f"planned {sum(len(c[4]) for c in mine)}")
        if r["thr0"] == r["thr1"] and all(c[1] == r["thr0"] for c in mine):
            held += 1
            want = predict_buckets([sizes[n] for n in r["order"]], r["thr0"])
            check(r["buckets"] == len(want),
                  f"step {i}: {r['buckets']} fused all-reduces at threshold "
                  f"{r['thr0']}, {len(want)} planned for the hooks' order")
    plans = {(c[1], c[2]) for c in cycles}
    sigs = {(c[2], s) for c in cycles for s in c[5]}
    check(program_misses <= len(plans),
          f"{program_misses} program misses for {len(plans)} plans")
    check(wire_misses <= len(sigs),
          f"{wire_misses} wire layout misses for {len(sigs)} distinct "
          f"bucket signatures")
    # every bucket's exposure is fed at its first hand-over, once its
    # events complete: by the next step's for all but the last step's
    buckets = [r["buckets"] for r in rows]
    check(sum(buckets[:-1]) <= len(exposures) <= sum(buckets)
          and all(e >= 0 for _, e in exposures),
          f"{len(exposures)} exposure records for {buckets} buckets")
    exposed_ms = [1e3 * sum(e for s, e in exposures if s == i)
                  for i in range(AUTOTUNE_STEPS - 1)]
    hidden_fracs = [float(r[header.index("comm_hidden_frac")])
                    for r in log_rows]
    want_losses = eager_row["losses"]
    got_losses = [r["loss"] for r in rows[:len(want_losses)]]
    check(got_losses == want_losses,
          f"tuned losses {got_losses} != the eager engine's {want_losses}")
    for name, n in launches.items():
        want = 0 if name in WGMMA or name.startswith("flash_band") \
            else AUTOTUNE_STEPS * cfg.n_layers
        check(n == want, f"{name} launched {n} times in {AUTOTUNE_STEPS} "
                         f"tuned steps, {want} expected")
    first = applied[0][0]
    before = [r["step_ms"] for r in rows[1:first]] or [rows[0]["step_ms"]]
    after = [r["step_ms"] for r in rows[first + 1:]] or [rows[-1]["step_ms"]]
    med_before, med_after = float(np.median(before)), float(np.median(after))
    scores = [float(r[-1]) for r in log_rows]
    print(f"autotune [{where}]: flagship {TRAIN_BATCH} x {TRAIN_SEQ}, window "
          f"{len(params)} collectives, {tuner._samples} samples after 1 "
          f"warm-up, {len(applied)} applied (fusion, cycle ms, padding, "
          f"depth): {[a[1:] for a in applied]}; first applied in step "
          f"{first}", flush=True)
    print(f"autotune [{where}]: step {med_before:.1f} ms before the first "
          f"apply (median of steps 1-{first - 1 if first > 1 else 0}), "
          f"{med_after:.1f} ms after (median of steps {first + 1}-"
          f"{AUTOTUNE_STEPS - 1}); buckets a step "
          f"{[r['buckets'] for r in rows]} ({held} steps at one threshold "
          f"held to the hooks' plan); exposed wire time a step (the "
          f"consumer stream's stall at the hand-over) "
          f"{[round(e, 3) for e in exposed_ms]} ms; samples' hidden "
          f"fractions {hidden_fracs}; scores (overlap-adjusted B/s) "
          f"{[round(s, 1) for s in scores]}; program misses "
          f"{program_misses} for {len(plans)} plans, wire layout misses "
          f"{wire_misses} for {len(sigs)} bucket signatures (by sample "
          f"{[m for _, m in samples]}); peak memory {peak / 2 ** 30:.2f} "
          f"GiB beside the eager phase's {eager_row['peak'] / 2 ** 30:.2f} "
          f"GiB (two models there); losses equal the eager phase's "
          f"{len(want_losses)} bitwise", flush=True)
    del opt, lm, params
    gc.collect()
    hvd.shutdown()
    for k in env:
        os.environ.pop(k, None)
    torch.cuda.empty_cache()
    return launches, {"samples": tuner._samples, "applied": len(applied),
                      "step_ms_before": med_before,
                      "step_ms_after": med_after, "scores": scores,
                      "exposed_ms": exposed_ms,
                      "hidden_fracs": hidden_fracs,
                      "program_misses": program_misses,
                      "wire_misses": wire_misses, "peak": peak,
                      "buckets": [r["buckets"] for r in rows]}


def launched_worker(marker, out_dir):
    """One generation of the launcher phase (``python -m
    horovod_tpu_torch.run -np 1 --max-restarts 1 python chip_smoke.py
    --launched-worker MARKER OUT``): ``hvd.init()`` from the launcher's
    variables (NCCL on ``cuda:<local rank>``), the flagship as
    :func:`phase_train` builds and trains it. Without MARKER (the first
    generation) it trains one step, writes MARKER and exits 1; with it,
    2 steps. Writes OUT/gen<1|2>.json: losses, launches, wall times."""
    first = not os.path.exists(marker)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    hvd.init()
    card = hvd.runtime.device()
    rec = {"size": hvd.size(), "rank": hvd.rank(), "device": str(card),
           "backend": hvd.runtime.live_state().backend,
           "restarts": os.environ.get("HOROVOD_TPU_ELASTIC_RESTARTS")}
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                loss_chunk=LOSS_CHUNK, **FLAGSHIP)
    lm = tfm.TransformerLM(cfg, seed0_params(tfm, cfg, card), device=card)
    hvd.broadcast_parameters(lm.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lm.parameters(), **ADAMW),
        named_parameters=lm.named_parameters())
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (TRAIN_BATCH, TRAIN_SEQ))
    targets = torch.from_numpy(np.roll(tokens, -1, axis=1)).to(card)
    tokens = torch.from_numpy(tokens).to(card)
    zero_launches(fa)
    losses = []
    for i in range(1 if first else 2):
        opt.zero_grad(set_to_none=True)
        loss = lm.loss(tokens, targets)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if i == 0:
            rec["first_step_wall"] = time.time()
    rec.update(losses=losses, launches=read_launches(fa))
    print(f"launched generation {1 if first else 2}: losses {losses}",
          flush=True)
    path = os.path.join(out_dir, f"gen{1 if first else 2}.json")
    if first:
        with open(marker, "w") as f:
            f.write("failed once\n")
        rec["exit_wall"] = time.time()
        with open(path, "w") as f:
            json.dump(rec, f)
        sys.exit(1)
    hvd.shutdown()
    with open(path, "w") as f:
        json.dump(rec, f)


def phase_launcher(fa, where, train_losses):
    """Main path launcher: ``python -m horovod_tpu_torch.run -np 1
    --max-restarts 1`` on :func:`launched_worker`. The first generation
    trains the flagship one step and fails; the launcher's gang restart
    brings up the second, which trains 2 steps from seed 0 on the train
    phase's batch. Gates: exit 0, two generations, the second's losses
    equal the train phase's first two bitwise, every flash launch on the
    tensor cores. Prints the time from the launch to the first step's
    end and the restart time (the first generation's exit to the
    second's first step). Returns ({kernel: launches} of both
    generations, its figures)."""
    out = tempfile.mkdtemp()
    marker = os.path.join(out, "gen1-failed")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_AUTOTUNE", "HOROVOD_PROFILER_PATH",
                                "HOROVOD_TIMELINE"))}
    env["HOROVOD_PROFILER_DISABLE"] = "1"
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1",
           "--max-restarts", "1", sys.executable, os.path.abspath(__file__),
           "--launched-worker", marker, out]
    t0 = time.time()
    p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=LAUNCH_TIMEOUT_S, cwd=REPO_DIR)
    wall = time.time() - t0
    check(p.returncode == 0, f"the launcher exited {p.returncode}: "
                             f"{p.stderr[-3000:]}")
    check("restarting (attempt 2/2)" in p.stderr,
          f"no gang restart in the launcher's output: {p.stderr[-2000:]}")
    gens = []
    for g in (1, 2):
        with open(os.path.join(out, f"gen{g}.json")) as f:
            gens.append(json.load(f))
    for g in gens:
        check((g["size"], g["rank"], g["backend"]) == (1, 0, "nccl")
              and g["device"] == "cuda:0",
              f"a launched generation ran as {g}")
    check(gens[1]["losses"] == train_losses[:2],
          f"the restarted generation's losses {gens[1]['losses']} != the "
          f"train phase's {train_losses[:2]}")
    check(gens[0]["losses"] == train_losses[:1],
          f"the first generation's loss {gens[0]['losses']} != the train "
          f"phase's {train_losses[:1]}")
    launches = {k: gens[0]["launches"][k] + gens[1]["launches"][k]
                for k in gens[0]["launches"]}
    n_layers = FLAGSHIP["n_layers"]
    for name, n in launches.items():
        want = 0 if name in WGMMA or name.startswith("flash_band") \
            else 3 * n_layers
        check(n == want, f"{name} launched {n} times in the launched "
                         f"generations' 3 steps, {want} expected")
    to_first = gens[0]["first_step_wall"] - t0
    restart = gens[1]["first_step_wall"] - gens[0]["exit_wall"]
    print(f"launcher [{where}]: python -m horovod_tpu_torch.run -np 1 "
          f"--max-restarts 1, the flagship at {TRAIN_BATCH} x {TRAIN_SEQ}: generation 1 "
          f"trained 1 step and failed, the gang restart's generation 2 "
          f"trained 2 (losses {gens[1]['losses']}, the train phase's "
          f"bitwise); launch to the first step's end {to_first:.1f} s, "
          f"restart (exit to the next first step's end) {restart:.1f} s, "
          f"the whole launch {wall:.1f} s", flush=True)
    return launches, {"launch_to_first_step_s": to_first,
                      "restart_s": restart, "wall_s": wall}


def launched_rank(out_dir):
    """One rank of the launcher ranks phase (``python -m
    horovod_tpu_torch.run -np 2`` with ``HOROVOD_LAUNCH_RPC=1`` and
    ``HOROVOD_AUTOTUNE=1`` on ``chip_smoke.py --launched-rank OUT``): a
    gloo group of its own on this card over the job's store
    (``hvd.init()`` adopts it; NCCL refuses two ranks on one card), the
    narrow transformer (flash attention at D 64), each gradient to
    ``hvd.allreduce_async_`` from its hook, AdamW, LAUNCH_STEPS steps on
    rank-specific batches. Records the applied autotune decisions, the
    indices of the autotune decisions in this rank's decision stream,
    a digest of the parameters and the launches in OUT/rank<R>.json."""
    import datetime
    import hashlib

    import torch.distributed as dist
    rank = int(os.environ["HOROVOD_TPU_PROCESS_ID"])
    size = int(os.environ["HOROVOD_TPU_NUM_PROCESSES"])
    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    dist.init_process_group(
        "gloo", store=dist.PrefixStore("smoke/launch/pg/",
                                       hvd.runtime.job_store()),
        rank=rank, world_size=size, timeout=datetime.timedelta(seconds=120))
    hvd.init(device=card)
    state = hvd.runtime.live_state()
    engine = state.engine
    stream = []
    fetch = engine.coordinator.fetch_decisions

    def logged_fetch(*a, **kw):
        got = fetch(*a, **kw)
        stream.extend(bool(d.get("autotune")) for d in got)
        return got

    engine.coordinator.fetch_decisions = logged_fetch
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                **ELASTIC_MODEL)
    lm = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                           device=card)
    params = list(lm.parameters())
    opt = torch.optim.AdamW(params, **ADAMW)
    names = {p: n for n, p in lm.named_parameters()}
    pending = []
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p: pending.append(hvd.allreduce_async_(p.grad,
                                                      name=names[p])))
        for p in params]
    data = torch.from_numpy(_token_samples(
        LAUNCH_RANKS * LAUNCH_STEPS * ELASTIC_BATCH, ELASTIC_SEQ,
        cfg.vocab_size, 6)).to(card)
    zero_launches(fa)
    losses = []
    for s in range(LAUNCH_STEPS):
        i = (s * LAUNCH_RANKS + rank) * ELASTIC_BATCH
        batch = data[i:i + ELASTIC_BATCH]
        pending.clear()
        opt.zero_grad(set_to_none=True)
        loss = lm.loss(batch[:, :-1], batch[:, 1:])
        loss.backward()
        for h in pending:
            hvd.synchronize(h)
        opt.step()
        losses.append(loss.item())
    launches = read_launches(fa)
    for h in hooks:
        h.remove()
    if state.autotuner is not None:
        state.autotuner.active = False
    # a collective after the tuner stopped: every decision process 0
    # published before it precedes it in the log, so each rank has
    # applied all of them once it completes
    hvd.allreduce(torch.zeros(1, device=card), name="launch.barrier")
    digest = hashlib.sha256()
    for p in params:
        digest.update(p.detach().float().cpu().numpy().tobytes())
    rec = {"rank": rank, "tuner": state.autotuner is not None,
           "applied": [list(a) for a in engine.applied_autotune],
           "indices": [i for i, a in enumerate(stream) if a],
           "digest": digest.hexdigest(), "losses": losses,
           "launches": launches, "grads": len(params)}
    print(f"launched rank {rank}: {len(rec['applied'])} autotune decisions "
          f"applied at stream indices {rec['indices']}; digest "
          f"{rec['digest'][:16]}", flush=True)
    hvd.shutdown()
    if dist.is_initialized():
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def phase_launcher_ranks(where):
    """Main path launcher_ranks (parity, not a speed: gloo on one card).
    (a) ``python -m horovod_tpu_torch.run -np 2`` with
    ``HOROVOD_LAUNCH_RPC=1`` (through the driver and task services) and
    ``HOROVOD_AUTOTUNE=1`` on :func:`launched_rank`: both ranks' applied
    autotune lists equal and applied at the same indices of their
    decision streams, only process 0 tuning, parameter digests equal,
    each rank's output streamed back with its prefix. (b), the churn
    soak, runs later (:func:`phase_churn_soak`). Returns ({kernel:
    launches} of (a)'s ranks, its figures)."""
    out = tempfile.mkdtemp()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_AUTOTUNE", "HOROVOD_PROFILER_PATH",
                                "HOROVOD_TIMELINE"))}
    n_grads = 3 + 7 * ELASTIC_MODEL["n_layers"]
    # a sample a fused collective: the narrow model's step is one to
    # three buckets on the card
    env.update(HOROVOD_LAUNCH_RPC="1", HOROVOD_AUTOTUNE="1",
               HOROVOD_AUTOTUNE_WARMUP_SAMPLES="0",
               HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE="1",
               HOROVOD_PROFILER_DISABLE="1")
    t0 = time.time()
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np",
         str(LAUNCH_RANKS), sys.executable, os.path.abspath(__file__),
         "--launched-rank", out],
        env=env, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S,
        cwd=REPO_DIR)
    wall_a = time.time() - t0
    check(p.returncode == 0, f"the launched ranks exited {p.returncode}: "
                             f"{p.stdout[-2000:]} {p.stderr[-2000:]}")
    for r in range(LAUNCH_RANKS):
        check(f"[{r}]<stdout>: launched rank {r}:" in p.stdout,
              f"rank {r}'s output did not stream back with its prefix")
    recs = []
    for r in range(LAUNCH_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    check([r["tuner"] for r in recs] == [True] + [False] * (LAUNCH_RANKS - 1),
          f"tuners {[r['tuner'] for r in recs]}: only process 0 tunes")
    check(recs[0]["grads"] == n_grads, f"{recs[0]['grads']} gradients, "
                                       f"{n_grads} expected")
    check(recs[0]["applied"], "no autotune decision was applied")
    for r in recs[1:]:
        check(r["applied"] == recs[0]["applied"]
              and r["indices"] == recs[0]["indices"],
              f"rank {r['rank']} applied {r['applied']} at {r['indices']}, "
              f"rank 0 {recs[0]['applied']} at {recs[0]['indices']}")
        check(r["digest"] == recs[0]["digest"],
              f"rank {r['rank']}'s parameters differ from rank 0's")
    launches = {k: sum(r["launches"][k] for r in recs)
                for k in recs[0]["launches"]}
    for name, n in launches.items():
        want = 0 if name in WGMMA or name.startswith("flash_band") \
            else LAUNCH_RANKS * LAUNCH_STEPS * ELASTIC_MODEL["n_layers"]
        check(n == want, f"{name} launched {n} times in the launched "
                         f"ranks' steps, {want} expected")
    print(f"launcher ranks [{where}]: -np {LAUNCH_RANKS} through the "
          f"driver and task services (gloo on one card, not a speed "
          f"figure): {len(recs[0]['applied'])} autotune decisions "
          f"{recs[0]['applied']} applied at decision indices "
          f"{recs[0]['indices']} on every rank, parameters equal; "
          f"{wall_a:.1f} s", flush=True)
    return launches, {"wall_a_s": wall_a}


def phase_churn_soak(where):
    """Main path launcher_ranks, part (b): the churn soak's short mode
    (tests/torch_soak_churn.py) through ``launch_elastic(autoscale=True)``
    with its scripted policy, its workers on this card over gloo, beside
    the tp phase (so its recovery times are not speed figures): 2 -> 3 through the grace drain, one worker
    SIGTERMed, 3 -> 2 with an in-job re-shard; every sample exactly
    once (pads as the soak's replay predicts them), 2 generations, the
    resize in the summary, exit 0. Prints each recovery's wall time."""
    sys.path.insert(0, os.path.join(REPO_DIR, "tests"))
    from torch_soak_churn import run_soak
    t0 = time.time()
    soak = run_soak(tempfile.mkdtemp(), short=True, device="cuda")
    summary = {k: v for k, v in soak.items() if k != "workers"}
    check(soak["ok"] and soak["exit_code"] == 0,
          f"churn soak: {json.dumps(summary)[:3000]}")
    check(soak["launcher"]["generations"] == 2
          and [r["direction"] for r in soak["launcher"]["resizes"]] == ["up"],
          f"churn soak summary {soak['launcher']}")
    check(all(w["device"] == "cuda:0" for w in soak["workers"]),
          f"soak workers on {[w['device'] for w in soak['workers']]}")
    recoveries = [s for w in soak["workers"]
                  for s in w["recovery_wall_seconds"]]
    print(f"launcher ranks [{where}]: churn soak (short) through "
          f"launch_elastic(autoscale=True): 2 -> 3 through the grace "
          f"drain, one SIGTERMed, 3 -> 2 "
          f"in the job; {soak['samples_total']} samples each exactly once "
          f"({max(w['pad_duplicates'] for w in soak['workers'])} pad "
          f"repeats, as the replay predicts); recovery wall "
          f"{[round(s, 3) for s in recoveries]} s (survivors' last step "
          f"start to the resumed loop), hvd_elastic_recovery_seconds sums "
          f"{[round(w['recovery_seconds_sum'], 3) for w in soak['workers']]}"
          f"; {soak['elapsed_seconds']:.1f} s ({time.time() - t0:.1f} s "
          f"with its set-up)", flush=True)
    return {"soak_wall_s": soak["elapsed_seconds"], "recovery_s": recoveries,
            "preemptions": soak["preemptions"]}


def phase_control_plane(where):
    """The control plane's bench rows, after the timed phases, with the
    host to themselves. ``control_plane``: simrank's curve (bench.resnet's
    row: worlds 8, 64 and 256, fanout 32) in a process of its own, the
    star and the tree cut to CONTROL_ROUNDS rounds a world: rounds a
    second of the root's ``coordinate()`` and end to end for star, tree
    and graduated, the tree's speedup over the star, root reads a round;
    gated on bit-identical decisions, O(1) static rounds and demotion on
    a membership change. ``eager_multihost_cycle_ms``: ``python -m
    horovod_tpu_torch.bench.eager --multihost 2`` on this card, the
    bypass on and off (gloo: a control-plane time, not an NCCL one)."""
    path = os.path.join(tempfile.mkdtemp(), "control_plane.json")
    code = ("import json, sys\n"
            "from horovod_tpu_torch.controlplane import simrank\n"
            "row = simrank.scaling_curve(worlds=(8, 64, 256), fanout=32, "
            f"rounds={CONTROL_ROUNDS})\n"
            "with open(sys.argv[1], 'w') as f:\n"
            "    json.dump(row, f)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, path], cwd=REPO_DIR,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=LAUNCH_TIMEOUT_S)
    log = proc.stdout
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the control-plane curve exited "
                                f"{proc.returncode}: {log[-3000:]}")
    with open(path) as f:
        ctrl = json.load(f)
    acc = ctrl["acceptance"]
    check(acc["decisions_bit_identical"] and acc["graduated_o1_reads_ok"]
          and acc["demotion_on_membership_change"],
          f"control plane acceptance {acc}")
    for cell in ctrl["cells"]:
        check(all(cell[m]["decision_streams_identical"]
                  for m in ("star", "tree", "graduated")),
              f"world {cell['world']}: decision streams differ")
        print(f"control plane world {cell['world']} fanout "
              f"{ctrl['fanout']} (host, no device): coordinate() rounds/s "
              + ", ".join(f"{m} {cell[m]['coordinator_rounds_per_sec']:.1f}"
                          for m in ("star", "tree", "graduated"))
              + "; end to end "
              + ", ".join(f"{m} {cell[m]['end_to_end_rounds_per_sec']:.2f}"
                          for m in ("star", "tree", "graduated"))
              + f"; tree speedup {cell['tree_speedup_over_star']}; root "
              f"reads a round (mean) "
              + ", ".join(f"{m} {cell[m]['root_reads_per_round']['mean']:.1f}"
                          for m in ("star", "tree", "graduated")),
              flush=True)
    print(f"control plane curve: {wall:.1f} s (star and tree "
          f"{CONTROL_ROUNDS} rounds a world); acceptance {acc}", flush=True)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.bench.eager",
                        "--multihost", "2", "--device", "cuda"],
                       env=dict(os.environ, HOROVOD_PROFILER_DISABLE="1"),
                       capture_output=True, text=True,
                       timeout=LAUNCH_TIMEOUT_S, cwd=REPO_DIR)
    check(p.returncode == 0, f"bench.eager --multihost 2 exited "
                             f"{p.returncode}: {p.stderr[-3000:]}")
    line = next((ln.split(": ", 1)[1] for ln in p.stdout.splitlines()
                 if ln.startswith("[0]<stdout>: {")), None)
    check(line is not None, f"no multihost line: {p.stdout[-2000:]}")
    mh = json.loads(line)
    check(mh["metric"] == "eager_multihost_cycle_ms" and mh["value"] > 0
          and mh["processes"] == 2 and mh["backend"] == "gloo",
          f"multihost line {mh}")
    print(f"eager multihost [{where}]: {json.dumps(mh)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"control_plane": {
        "worlds": ctrl["worlds"], "fanout": ctrl["fanout"],
        "cells": [{"world": c["world"],
                   "tree_speedup_over_star": c["tree_speedup_over_star"],
                   **{m: {"coordinator_rounds_per_sec":
                          c[m]["coordinator_rounds_per_sec"],
                          "end_to_end_rounds_per_sec":
                          c[m]["end_to_end_rounds_per_sec"],
                          "root_reads_per_round":
                          c[m]["root_reads_per_round"]}
                      for m in ("star", "tree", "graduated")}}
                  for c in ctrl["cells"]],
        "acceptance": acc, "wall_s": wall},
        "eager_multihost": mh}


# The port's own examples (main path examples): the long-context
# script at its default width (head dim 64) over a local ring of 4, and
# the ResNet-50 recipe's resume path.
EXAMPLES_DIR = os.path.join(REPO_DIR, "examples", "torch_port")
EXAMPLES_SP, EXAMPLES_STEPS, EXAMPLES_WINDOW = 4, 3, 1024
EXAMPLES_LC = ("transformer_long_context.py", "--attention", "ring-flash",
               "--sp", str(EXAMPLES_SP), "--steps", str(EXAMPLES_STEPS),
               "--window", str(EXAMPLES_WINDOW))
EXAMPLES_LC_LAYERS, EXAMPLES_LC_SEQ = 4, 2048  # the script's defaults
# (B, S of a shard, H, H_kv, D, dtype): the script's batch of 2, 8 heads
# of d_model 512 (D 64), no GQA
EXAMPLES_SHAPE = (2, EXAMPLES_LC_SEQ // EXAMPLES_SP, 8, 8, 64,
                  torch.bfloat16)
EXAMPLES_RESNET = ("pytorch_imagenet_resnet50.py", "--steps-per-epoch", "2")
# the MXNet binding over the mock, its engine on the card
EXAMPLES_MXNET = ("mxnet_mnist.py", "--shim")
EXAMPLES_TIMEOUT_S = 300


def _example(args, out_dir, env):
    """Run one example script on this card to its end (cwd ``out_dir``,
    environment ``env``); returns (stdout, the JSON summary it ends
    with) and fails the run unless it exited 0."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(EXAMPLES_DIR, args[0]), *args[1:]],
        cwd=out_dir, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        out = proc.communicate(timeout=EXAMPLES_TIMEOUT_S)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0,
          f"example {args[0]} exited {proc.returncode}:\n{out[-3000:]}")
    return out, json.loads(out.strip().splitlines()[-1])


def start_examples(fa, card, gen):
    """Main path examples, first half: the six kernels against their
    plain versions at the long-context example's shapes, then the two
    examples started as subprocesses (header), which run on while the
    caller goes on. Returns the handle :func:`finish_examples` takes."""
    b, s, h, h_kv, d, dtype = EXAMPLES_SHAPE
    w = EXAMPLES_WINDOW
    # the ring's live visiting tiles: ring_attention._ring_steps
    ring_steps = min(EXAMPLES_SP, max(1, 2 + (w - 2) // s))
    offsets = [t * s for t in range(1, ring_steps)]
    q, k, v, do, lse, delta = bwd_inputs(fa, card, gen, b, s, h, h_kv, d,
                                         dtype, True, w)
    out, lse_t = fa.flash_attention_with_lse(q, k, v, True, w)
    texts = [hold_forward(fa, "flash_attention", out, lse_t, (q, k, v),
                          (True, w), (True, w))]
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, w)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, w)
    for name, got in (("flash_bwd_dq", (dq,)), ("flash_bwd_dkv", (dk, dv))):
        texts.append(hold_backward(fa, name, got, (q, k, v, do, lse, delta),
                                   (True, w), (True, w)))
    for off in offsets:
        q, k, v, do, lse, delta = band_inputs(fa, card, gen, b, s, h, h_kv,
                                              d, dtype, off, w)
        live = live_rows(fa, s, off, w).to(card)
        out, lse_t = fa.flash_band_fwd(q, k, v, off, w)
        texts.append(hold_forward(fa, "flash_band_fwd", out, lse_t,
                                  (q, k, v), (off, w), (True, w, off),
                                  rows=live))
        args = (q, k, v, do, lse, delta)
        dq = fa.flash_band_dq(*args, off, w)
        dk, dv = fa.flash_band_dkv(*args, off, w)
        for name, got in (("flash_band_dq", (dq,)),
                          ("flash_band_dkv", (dk, dv))):
            texts.append(hold_backward(fa, name, got, args, (off, w),
                                       (True, w, off)))
    check(all(tc for _, _, tc, _ in texts),
          "a kernel left the tensor-core route at D 64")
    worst = max(err for err, _, _, _ in texts)
    print(f"examples kernels B={b} S={s} H={h} H_kv={h_kv} D={d} bf16 "
          f"causal, window {w}, band offsets {offsets} "
          f"[tensor cores]: worst max|d| {worst:.3g} against the plain "
          f"versions; " + " | ".join(t for _, _, _, t in texts[:3]),
          flush=True)
    del q, k, v, do, lse, delta, out, dq, dk, dv
    torch.cuda.empty_cache()

    from concurrent.futures import ThreadPoolExecutor
    out_dir = tempfile.mkdtemp(prefix="hvd-examples-")
    fmt = os.path.join(out_dir, "ckpt", "checkpoint-{epoch}.pth")
    # taken now: the phases beside them may change this process's
    env = dict(os.environ, HOROVOD_PROFILER_DISABLE="1")

    def resume():
        first = _example(EXAMPLES_RESNET + (
            "--epochs", "2", "--checkpoint-format", fmt), out_dir, env)
        return first, _example(EXAMPLES_RESNET + (
            "--epochs", "3", "--checkpoint-format", fmt), out_dir, env)

    pool = ThreadPoolExecutor(3)
    return {"pool": pool, "dir": out_dir, "t0": time.perf_counter(),
            "ring_steps": ring_steps,
            "lc": pool.submit(_example, EXAMPLES_LC, out_dir, env),
            "resnet": pool.submit(resume),
            "mxnet": pool.submit(_example, EXAMPLES_MXNET, out_dir, env)}


def finish_examples(handle, where):
    """Main path examples, second half: wait for the subprocesses and
    hold them to the header's gates. Returns ({kernel route: launches}
    of the long-context run, row)."""
    try:
        lc_out, lc_sum = handle["lc"].result()
        (rn_out, rn_sum), (rn2_out, rn2_sum) = handle["resnet"].result()
        mx_out, mx_sum = handle["mxnet"].result()
    finally:
        handle["pool"].shutdown()
        shutil.rmtree(handle["dir"], ignore_errors=True)
    wall = time.perf_counter() - handle["t0"]

    def finite(xs):
        return bool(xs) and all(np.isfinite(xs))
    losses = lc_sum["losses"]
    check(finite(losses) and losses[-1] < losses[0],
          f"long-context example: the loss did not fall: {losses}")
    check(lc_sum["head_dim"] == EXAMPLES_SHAPE[4],
          f"long-context head dim {lc_sum['head_dim']}, not "
          f"{EXAMPLES_SHAPE[4]}")
    check(finite(rn_sum["losses"])
          and rn_sum["losses"][-1] < rn_sum["losses"][0],
          f"ResNet-50 example: the loss did not fall: {rn_sum['losses']}")
    check("Resuming from epoch 2" in rn2_out and rn2_sum["resumed_from"] == 2
          and finite(rn2_sum["losses"])
          and rn2_sum["losses"][0] < rn_sum["losses"][0],
          f"ResNet-50 example did not resume: {rn2_out[-2000:]}")
    check("DONE" in mx_out and mx_sum["engine_device"] == "cuda:0"
          and mx_sum["backend"] == "nccl"
          and finite(mx_sum["losses"])
          and mx_sum["losses"][-1] < mx_sum["losses"][0],
          f"MXNet example on the card: {mx_out[-2000:]}")
    by_counter = lc_sum["launches"]
    launches = {n: by_counter[c] for n, c in COUNTERS.items()}
    steps = 2 + EXAMPLES_STEPS  # the script's two untimed steps first
    # a layer's tiles: one diagonal a shard, and each shard's live
    # visiting tiles (shard i visited from shard i - t, t < ring_steps)
    tiles = {"static": EXAMPLES_SP,
             "band": sum(EXAMPLES_SP - t
                         for t in range(1, handle["ring_steps"]))}
    for name in PREFIXES:
        check(launches[name] == 0, f"{name}: the example took the loop")
        want = steps * EXAMPLES_LC_LAYERS * tiles[
            "band" if name.startswith("flash_band") else "static"]
        check(launches[WGMMA[name]] == want,
              f"{name}: {launches[WGMMA[name]]} tensor-core launches in "
              f"the long-context example, {want} expected")
    print(f"examples [{where}]: transformer_long_context ring-flash sp "
          f"{EXAMPLES_SP} window {EXAMPLES_WINDOW} losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; "
          f"{lc_sum['tokens_per_sec']:.1f} tokens/s; launches "
          f"{ {n: c for n, c in launches.items() if c} }; ResNet-50 "
          f"losses {' '.join(f'{x:.4f}' for x in rn_sum['losses'])}, "
          f"resumed from epoch 2: "
          f"{' '.join(f'{x:.4f}' for x in rn2_sum['losses'])}; "
          f"mxnet_mnist --shim losses "
          f"{' '.join(f'{x:.4f}' for x in mx_sum['losses'])}; "
          f"subprocesses {wall:.1f} s", flush=True)
    return launches, {"lc_losses": losses,
                      "lc_tokens_per_sec": lc_sum["tokens_per_sec"],
                      "resnet_losses": rn_sum["losses"],
                      "resnet_resumed_losses": rn2_sum["losses"],
                      "mxnet_losses": mx_sum["losses"],
                      "subprocess_s": wall}


def phase_examples(fa, card, gen, where):
    """Main path examples, both halves at once (the card test's and a
    debugging drive's form)."""
    return finish_examples(start_examples(fa, card, gen), where)


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    global _seed0_writer
    _seed0_writer = True
    os.environ[SEED0_ENV] = tempfile.mkdtemp(prefix="hvd-seed0-")
    try:
        return _main(t_start)
    finally:
        shutil.rmtree(os.environ.pop(SEED0_ENV), ignore_errors=True)


def _main(t_start):
    where = card_line()
    print(where, flush=True)
    card = torch.device("cuda")

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, serve
    from horovod_tpu_torch.models import moe
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.ring_attention import RingAxis
    from horovod_tpu_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    # the eager engine's native control plane (g++) builds beside nvcc
    from concurrent.futures import ThreadPoolExecutor

    from horovod_tpu_torch import native
    with ThreadPoolExecutor(2) as pool:
        control = pool.submit(native.build)
        # the host draws of seed 0 the phases copy, beside nvcc
        draws = pool.submit(seed0_draws, tfm)
        logs = _build.build()
        control = control.result()
        moe_init = draws.result()
    print(f"build: {sorted(logs) or 'up to date'} and {control.name} in "
          f"{time.perf_counter() - t0:.1f} s, with the seed-0 draws beside "
          f"it", flush=True)
    with ThreadPoolExecutor(max(len(logs), 1)) as pool:
        # each library's SASS read beside the other's
        sass = dict(zip(logs, pool.map(
            lambda name: sass_hgmma(_build, name), logs)))
    for name, log in logs.items():
        kernel_usage(fa, name, log, sass[name])

    gen = torch.Generator(device=card).manual_seed(0)
    t0 = time.perf_counter()
    entry = phase_kernels(fa, card, gen)
    bwd_entries, train_fwd = phase_backward_kernels(fa, card, gen)
    entry["train_shape"] = train_fwd
    band_entries = phase_band_kernels(fa, card, gen)
    phase_ulysses_kernels(fa, card, gen, {"flash_fwd": entry, **bwd_entries})
    print(f"kernel phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()

    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                                **FLAGSHIP)
    lm = tfm.TransformerLM(cfg, seed0_params(tfm, cfg, card), device=card)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"model: {n_params / 1e6:.1f} M parameters (f32), "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}", flush=True)

    serve_launches = phase_serve(fa, serve, metrics, lm, card, where)
    print(f"serve phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    compiled_serve_launches = phase_compiled_serve(fa, serve, metrics, tfm,
                                                   lm, card, where)
    print(f"compiled serve phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    del lm
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches, train_row = phase_train(hvd, fa, tfm, card, where)
    print(f"train phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    eager_launches, eager_row = phase_eager_engine(hvd, fa, tfm, card, where)
    print(f"eager engine phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    autotune_launches, launch_row = phase_autotune(hvd, fa, tfm, card, where,
                                                   eager_row)
    launch_row = {"autotune": launch_row}
    print(f"autotune phase: {time.perf_counter() - t0:.1f} s", flush=True)
    # Phases whose figures are parity and exit codes, not speeds, run
    # side by side: the launcher's generations (the flagship on the card)
    # here, the launched ranks, and the elastic ranks' kill run followed
    # by the eager engine's two ranks (narrow or tiny models over gloo)
    # and the pipeline phase (this process's only kernels in the block,
    # so its launch counts are its own), in threads of this process.
    from concurrent.futures import ThreadPoolExecutor

    def kill_eager2_pipeline():
        got = phase_elastic_ranks(where, "cuda", ("kill",))
        eager2 = phase_eager_engine_2ranks(where)
        t1 = time.perf_counter()
        pp = phase_pipeline(fa, tfm, card, where)
        print(f"pipeline phase: {time.perf_counter() - t1:.1f} s (beside "
              f"the launcher phase)", flush=True)
        return got, eager2, pp

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(phase_launcher_ranks, where)
        kill = pool.submit(kill_eager2_pipeline)
        launcher_launches, launch_row["launcher"] = phase_launcher(
            fa, where, train_row["losses"])
        print(f"launcher phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        launcher_ranks_launches, launch_row["launcher_ranks"] = \
            ranks.result()
        ((kill_launches, kill_row), eager_row["two_ranks"],
         (pp_gpipe, pp_1f1b)) = kill.result()
    print(f"launcher, launcher ranks, elastic kill, eager 2 ranks and "
          f"pipeline side by side: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    compiled_train_launches, params, _, stage0 = phase_compiled_train(
        hvd, fa, tfm, card, where)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"compiled train phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    trace_launches = phase_trace(hvd, fa, tfm, serve, metrics, card, where,
                                 params)
    del params
    print(f"trace phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    zero_launches_by_stage, zero_plain = phase_zero_train(
        hvd, fa, tfm, metrics, card, where, stage0)
    del stage0
    gc.collect()
    print(f"zero train phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zero_guard_launches, zero_guard_row = phase_zero_guard(
        hvd, fa, tfm, card, where, zero_plain)
    del zero_plain
    gc.collect()
    torch.cuda.empty_cache()
    print(f"zero guard phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    guard_launches, fault_row = phase_guard(hvd, fa, tfm, card, where)
    fault_row["zero_guard"] = zero_guard_row
    print(f"guard phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    elastic_state_launches, fault_row["elastic_state"] = \
        phase_elastic_state(hvd, fa, tfm, card, where)
    print(f"elastic state phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the term run alone: its recovery is timed against the settle window
    t0 = time.perf_counter()
    term_launches, term_row = phase_elastic_ranks(where, modes=("term",))
    elastic_ranks_launches = {k: kill_launches.get(k, 0) + v
                              for k, v in term_launches.items()}
    fault_row["elastic_ranks"] = {**kill_row, **term_row}
    print(f"elastic ranks phase: {time.perf_counter() - t0:.1f} s (the term "
          f"run; the kill run beside the launcher phase)", flush=True)
    # Phases whose figures are parity, not speed, run side by side: the
    # examples' subprocesses, then the spark, MoE parity, churn soak and
    # flash-vs-dense parity phases in turn, beside the tp phase (its ranks in a thread of this
    # process: they only spawn and wait).
    t0 = time.perf_counter()
    examples = start_examples(fa, card, gen)
    own = time.perf_counter() - t0
    with ThreadPoolExecutor(1) as pool:
        tp = pool.submit(phase_tp, where)
        t1 = time.perf_counter()
        spark_launches, launch_row["spark"] = phase_spark(hvd, fa, tfm, card,
                                                          where)
        print(f"spark phase: {time.perf_counter() - t1:.1f} s (beside the "
              f"tp phase)", flush=True)
        t1 = time.perf_counter()
        phase_moe_parity(tfm, moe, card, moe_init)
        print(f"moe parity phase: {time.perf_counter() - t1:.1f} s (beside "
              f"the tp phase)", flush=True)
        t1 = time.perf_counter()
        launch_row["launcher_ranks"].update(phase_churn_soak(where))
        print(f"churn soak phase: {time.perf_counter() - t1:.1f} s (beside "
              f"the tp phase)", flush=True)
        t1 = time.perf_counter()
        lm = tfm.TransformerLM(cfg, seed0_params(tfm, cfg, card),
                               device=card)
        phase_parity(tfm, ServeEngine, lm.params, card)
        del lm
        torch.cuda.empty_cache()
        phase_train_parity(tfm, card)
        print(f"parity phases: {time.perf_counter() - t1:.1f} s (beside "
              f"the tp phase)", flush=True)
        tp_serve_launches, tp_train_launches = tp.result()
    t1 = time.perf_counter()
    examples_launches, examples_row = finish_examples(examples, where)
    own += time.perf_counter() - t1
    print(f"examples phase: {own:.1f} s of its own (the kernel checks and "
          f"the wait past the tp phase; its subprocesses "
          f"{examples_row['subprocess_s']:.1f} s beside it); the tp block "
          f"(tp, examples, spark, moe parity, churn soak, parity): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    moe_train_launches = phase_moe_train(hvd, fa, tfm, moe, metrics, card,
                                         where, moe_init)
    print(f"moe train phase: {time.perf_counter() - t0:.1f} s", flush=True)
    moe_serve_launches = phase_moe_serve(fa, serve, metrics, tfm, moe, card,
                                         where, moe_init)
    del moe_init
    print(f"moe phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_sp_parity(tfm, RingAxis, card)
    sp_launches, ring_step = phase_train(hvd, fa, tfm, card, where,
                                         RingAxis.local(SP_RING))
    ulysses_launches, ulysses_step = phase_train(
        hvd, fa, tfm, card, where, RingAxis.local(SP_RING), "ulysses")
    print(f"sp train 2 x 8192 [{where}]: Ulysses step "
          f"{ulysses_step['step_ms']:.1f} ms ({ulysses_step['tok_s']:.1f} "
          f"tokens/s, peak {ulysses_step['peak'] / 2 ** 30:.2f} GiB) beside "
          f"the ring's {ring_step['step_ms']:.1f} ms "
          f"({ring_step['tok_s']:.1f} tokens/s, peak "
          f"{ring_step['peak'] / 2 ** 30:.2f} GiB)", flush=True)
    print(f"sp parity and sp train phases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    static = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")
    band = ("flash_band_fwd_wgmma", "flash_band_dq_wgmma",
            "flash_band_dkv_wgmma")
    n_layers = FLAGSHIP["n_layers"]
    compiled_sp = {}
    for sp_impl in ("ring", "ulysses"):
        per_replay = dict.fromkeys(static, SP_RING * n_layers)
        if sp_impl == "ring":
            per_replay.update(dict.fromkeys(
                band, len(SP_BAND_OFFSETS) * n_layers))
        compiled_sp[sp_impl], params, _, _ = phase_compiled_train(
            hvd, fa, tfm, card, where,
            model=dict(SP_MODEL, sp_impl=sp_impl),
            label=f"compiled sp {sp_impl}", shape=(SP_BATCH, SP_SEQ),
            axes=tfm.ShardAxes(sp=RingAxis.local(SP_RING)),
            per_replay=per_replay)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(f"compiled sp phases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    phase_resnet(hvd, card, where)
    scaling = phase_bench(where)
    eager_row["bench"] = phase_eager_bench(where)
    print(f"resnet and bench phases: {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the control plane's host rows last, alone: nothing runs beside them
    t0 = time.perf_counter()
    launch_row.update(phase_control_plane(where))
    print(f"control plane phase: {time.perf_counter() - t0:.1f} s",
          flush=True)

    entries = [entry, bwd_entries["flash_bwd_dq"],
               bwd_entries["flash_bwd_dkv"], *band_entries]
    paths = {"serve": serve_launches, "train": train_launches,
             "eager_engine": eager_launches,
             "sp_train": sp_launches,
             "compiled_serve": compiled_serve_launches,
             "compiled_train": compiled_train_launches,
             "zero_train": zero_launches_by_stage,
             "moe_train": moe_train_launches,
             "moe_serve": moe_serve_launches,
             "tp_serve": tp_serve_launches, "tp_train": tp_train_launches,
             "ulysses_train": ulysses_launches,
             "sp_compiled": compiled_sp["ring"],
             "ulysses_compiled": compiled_sp["ulysses"],
             "pp_gpipe": pp_gpipe, "pp_1f1b": pp_1f1b,
             "trace": trace_launches, "guard": guard_launches,
             "elastic_state": elastic_state_launches,
             "elastic_ranks": elastic_ranks_launches,
             "autotune": autotune_launches, "launcher": launcher_launches,
             "launcher_ranks": launcher_ranks_launches,
             "zero_guard": zero_guard_launches, "spark": spark_launches,
             "examples": examples_launches}
    for e in entries:
        # a kernel's launches are its tensor-core route's: the main paths
        # launch its loop never (checked in phase_serve and phase_train)
        counted = WGMMA[e["name"]]
        by_path = {p: n[counted] for p, n in paths.items()}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        e["route_on_main_paths"] = "tensor cores (wgmma)"
        check(e["launches"] > 0, f"{e['name']} never ran on a main path")
    print(f"chip_smoke: wall time {time.perf_counter() - t_start:.1f} s",
          flush=True)
    # the eager phases' figures, repeated here where the tail of a long
    # run's output still holds them
    print(json.dumps({"eager_engine": eager_row, "card": where}))
    print(json.dumps({"fault_tolerance": fault_row, "card": where}))
    print(json.dumps({"autotune_launcher": launch_row, "card": where}))
    print(json.dumps({"examples": examples_row, "card": where}))
    print(json.dumps({"scaling": scaling, "card": where}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:
        tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--eager-rank"]:
        eager_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--launched-worker"]:
        launched_worker(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--launched-rank"]:
        launched_rank(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--elastic-rank"]:
        elastic_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                       sys.argv[5], sys.argv[6])
        sys.exit(0)
    sys.exit(main())
