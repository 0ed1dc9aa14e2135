"""The port's benches, the counterparts of the repo's root scripts
``bench.py`` (:mod:`.resnet`) and ``bench_transformer.py``
(:mod:`.transformer`). Each prints one JSON line; run them as
``python -m horovod_tpu_torch.bench.resnet`` and
``python -m horovod_tpu_torch.bench.transformer``."""
