"""The launcher: ``python -m horovod_tpu_torch.run -np N cmd`` (counterpart
of horovod_tpu/run/)."""

from .run import launch, launch_elastic, main, parse_args  # noqa: F401
