"""Signal transport to the autoscale policy: a file drop.

Counterpart of horovod_tpu/elastic/policy.py, carrying only
:func:`write_signal`, which the serve engine uses for its SLO signal.
The policy that reads the files comes with the elastic slice
(ROADMAP.md, Queue 1).
"""

import json
import os


def write_signal(policy_dir, rank, payload):
    """Atomically drop one reporter's signal file (tmp + rename so the
    supervisor never reads a torn write). Best-effort by design — a
    missed signal only delays the policy one interval."""
    path = os.path.join(policy_dir, f"signals-{rank}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
