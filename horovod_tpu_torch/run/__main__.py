"""``python -m horovod_tpu_torch.run``: the port's ``horovodrun``
(counterpart of ``python -m horovod_tpu.run``)."""

import sys

from .run import main

if __name__ == "__main__":
    sys.exit(main())
