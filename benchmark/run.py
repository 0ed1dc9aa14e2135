"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for. The last line of standard output is the result (one JSON
object); earlier lines carry the step times, the card, the readings
compared and the reference's time. The numbers compared, each with its
limit, are also the last lines of standard error. See
``yardstick/cell.py`` for what a run does.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))
# a library that would load JAX by itself must not (transformers)
os.environ.setdefault("USE_FLAX", "0")

from yardstick import cell  # noqa: E402

if __name__ == "__main__":
    sys.exit(cell.main())
