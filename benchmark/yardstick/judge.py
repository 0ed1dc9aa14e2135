"""What decides ``correct``: the program's first training steps held to
the plain reference's.

The set-up drives the timed step object through its first
``check_steps`` steps on rows that all differ, and reads:

- each step's loss, on every rank;
- the first gradient as the optimizer got it (AdamW's first moment
  after one step over ``1 - beta1``), its norm leaf by leaf;
- the second, likewise (from the first moments after steps 1 and 2):
  a compiled step's first call runs eagerly, so this is the first
  gradient a replayed graph computed;
- the parameters' change after the last of those steps, its norm leaf
  by leaf, on every rank.

The reference follows the same steps from the same inputs. Seven
numbers are worked out:

- ``loss_gap``: the largest gap between a step's losses, over the
  reference's loss; ``loss1_gap``: the same of the first step alone;
- ``grad_gap``, ``grad2_gap`` and ``change_gap``: for the worst leaf,
  the gap between the program's norm and the reference's, over the
  larger of the reference's norm of that leaf and of the median leaf.

and ``grad_med_gap`` and ``grad2_med_gap``, the median leaf's gradient
gaps, where one small leaf's noise swings the worst (an MoE router's
gradient turns on which tokens flip their experts). A cell compares
those its limit file (``limits/<cell>.json``) gives a limit; a number
with no upper reading there (none of the control and the faults reads
it far enough above the program) is shown, not compared.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of both. A number that
is not finite is over any limit.
"""

import math
import statistics

#: A leaf whose reference gradient norm is under this share of the
#: median leaf's is left out of the comparison.
NEGLIGIBLE = 1e-3
NAMES = ("loss_gap", "loss1_gap", "grad_gap", "grad_med_gap", "grad2_gap",
         "grad2_med_gap", "change_gap")


def _gap(a, b):
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b)


def leaf_gaps(program, reference, keep):
    """``{leaf: gap}`` between two ``{leaf: norm}`` readings, each over
    the larger of the reference's norm of that leaf and of the median
    leaf; a leaf the program lacks reads infinite."""
    med = statistics.median(reference[k] for k in keep)
    return {k: _gap(program.get(k, math.inf), reference[k])
            / max(reference[k], med, 1e-30) for k in keep}


def compared_leaves(ref_grad):
    med = statistics.median(ref_grad.values())
    return sorted(k for k, v in ref_grad.items() if v >= NEGLIGIBLE * med)


def checks(program, reference):
    """``{name: (value, worst leaf or None)}`` of the seven numbers.

    ``program``: ``{"losses": [[step loss] a rank], "grad_norms":
    [{leaf: norm}] a rank, "grad2_norms": the same, "change_norms":
    [{leaf: norm}] a rank}``; ``reference``: ``{"losses": [[step loss]
    a rank], "grad_norms": {leaf: norm}, "grad2_norms": {leaf: norm},
    "change_norms": {leaf: norm}}``."""
    gaps = [[_gap(a, b) / max(abs(b), 1e-30) for a, b in zip(got, want)]
            if len(got) == len(want) else [math.inf]
            for got, want in zip(program["losses"], reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]):
        gaps.append([math.inf])
    keep = compared_leaves(reference["grad_norms"])
    grads, grads2 = ([leaf_gaps(r, reference[key], keep)
                      for r in program[key]]
                     for key in ("grad_norms", "grad2_norms"))
    changes = [leaf_gaps(r, reference["change_norms"], keep)
               for r in program["change_norms"]]
    return {"loss_gap": (max(max(g) for g in gaps), None),
            "loss1_gap": (max(g[0] for g in gaps), None),
            "grad_gap": _worst(grads),
            "grad_med_gap": _median(grads),
            "grad2_gap": _worst(grads2),
            "grad2_med_gap": _median(grads2),
            "change_gap": _worst(changes)}


def _median(per_rank):
    """``(gap, None)`` of the median leaf, on the rank where it is
    widest."""
    return max(statistics.median(r.values()) for r in per_rank), None


def _worst(per_rank):
    """``(gap, leaf)`` of the widest leaf over every rank."""
    return max(((g, k) for r in per_rank for k, g in r.items()),
               key=lambda x: x[0])


def verdict(values, limits):
    """``correct`` and ``{name: {"value", "limit"}}`` of the numbers
    ``limits`` holds: each at or under its limit."""
    shown = {n: {"value": values[n][0], "limit": limits[n]} for n in NAMES
             if n in limits}
    if not shown:
        raise ValueError("a limit file compares no number")
    return all(v["value"] <= v["limit"] for v in shown.values()), shown
