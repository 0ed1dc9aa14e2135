"""The port's benches, the counterparts of the repo's root scripts
``bench.py`` (:mod:`.resnet`), ``bench_transformer.py``
(:mod:`.transformer`), ``bench_eager.py`` (:mod:`.eager`) and
``bench_scaling.py`` (:mod:`.scaling`). Each prints one JSON line; run
them as ``python -m horovod_tpu_torch.bench.resnet``, ``.transformer``,
``.eager`` and ``.scaling``."""
