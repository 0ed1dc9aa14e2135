"""The benchmark's yardstick: everything a later change to the program
cannot move.

- :mod:`spec` reads ``BENCHMARK.json`` and finds each configuration,
  traffic mix, entry, per-layer metric, limit file and reference by its
  name, as files under the benchmark's folder;
- :mod:`traffic` is the one generator every traffic file feeds;
- :mod:`weights` makes a configuration's parameters on the device from
  the seed;
- :mod:`arith` holds the operation and byte counts, percentiles and
  interval folds; :mod:`peaks` the card's published peaks;
- :mod:`kineto` reads the profiler's raw trace;
- :mod:`judge` compares the program's training readings with the plain
  reference's and decides ``correct``;
- :mod:`imports` is the check that no JAX module is loaded;
- :mod:`cell` runs one cell end to end.

Nothing here imports JAX or the JAX package; :mod:`cell` imports the
program (``horovod_tpu_torch``) only inside the functions that drive it.
"""
