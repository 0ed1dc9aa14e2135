"""CLI entry: ``python -m horovod_tpu_torch.analysis``."""

import sys

from .core import main

if __name__ == "__main__":
    sys.exit(main())
