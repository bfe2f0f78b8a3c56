"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each beside the cell's limit
(``bench/limits/<cell>.json``; PERF.md gives the readings each limit was set
from)."""

from __future__ import annotations

import statistics
from typing import Dict, List, Mapping, Sequence, Tuple

Check = Tuple[str, float, float]
#: a leaf whose reference gradient is under this share of the median
#: leaf's moves by round-off alone, so its change is not compared
STILL_LEAF = 1e-3


def worst_leaf(got: Mapping[str, float], want: Mapping[str, float],
               names: Sequence[str]) -> float:
    """The largest gap between two norms of a leaf, over the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    median = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], median) for n in names)


def moving_leaves(ref_grads: Mapping[str, float]) -> List[str]:
    """Leaves whose first reference gradient is at least ``STILL_LEAF``
    of the median leaf's."""
    median = statistics.median(ref_grads.values())
    return sorted(n for n, g in ref_grads.items() if g >= STILL_LEAF * median)


def train_numbers(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``grad_gap``: the worst leaf of the first clipped gradient's norms;
    ``change_gap``: the worst moving leaf of the change's norms over the
    check's steps."""
    loss = max(abs(p - r) / abs(r)
               for p, r in zip(prog["losses"], ref["losses"]))
    grads = worst_leaf(prog["grad_norms"], ref["grad_norms"],
                       sorted(ref["grad_norms"]))
    change = worst_leaf(prog["change_norms"], ref["change_norms"],
                        moving_leaves(ref["grad_norms"]))
    return {"loss_gap": loss, "grad_gap": grads, "change_gap": change}


def served_numbers(gaps: Sequence[float]) -> Dict[str, float]:
    """``logit_gap``: the widest gap by which a served token's reference
    logit lies below the reference's best."""
    return {"logit_gap": max(gaps)}


def against(numbers: Mapping[str, float],
            limits: Mapping[str, float]) -> List[Check]:
    """The numbers the cell's limits name, each beside its limit.  A
    number without a limit is not compared: PERF.md gives why (its
    control reads no higher than rounding does)."""
    return [(name, float(numbers[name]), float(limit))
            for name, limit in limits.items()]


def passed(checks: Sequence[Check]) -> bool:
    return all(value <= limit for _, value, limit in checks)
