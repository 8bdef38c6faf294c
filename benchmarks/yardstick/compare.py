"""The numbers that decide ``correct``, each held to its limit.

Training (the first steps of a run, program against reference from the
same weights, batches and draws):

* ``loss_gap``: the largest ``|L_prog - L_ref| / |L_ref|`` over the
  compared steps;
* ``grad_gap``: the first gradient as Adam holds it after one step
  (``exp_avg / (1 - beta1)``), by the worst leaf: ``|n_prog - n_ref|``
  of the two norms over ``max(n_ref, median leaf n_ref)``;
* ``change_gap``: the parameters' change over the compared steps, by
  the worst leaf, measured the same way, over the leaves the reference
  moves: a leaf whose reference gradient is under a thousandth of the
  median leaf's (a bias under softmax, a head off this step's graph)
  moves under Adam by round-off alone and is left out.

Render (sampled chunks of an image rendered in the window against the
reference's render of the same rays):

* ``rgb_gap``: the largest absolute difference of a colour channel over
  the rays both sides include;
* ``included_mismatch``: rays that one side includes and the other
  drops (exact: limit 0).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

GRAD_FLOOR = 1e-3  # leaves under this share of the median leaf's gradient
TRAIN_NUMBERS = ("loss_gap", "loss_gap_first", "grad_gap", "grad_gap_median",
                 "change_gap", "change_gap_median")


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               leaves: List[str]) -> List[float]:
    if not leaves:
        return [math.nan]
    med = float(np.median([ref[k] for k in leaves]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300)
            for k in leaves]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{"loss": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}`` of the same compared steps."""
    losses = [abs(a - b) / abs(b) if b != 0 else abs(a - b)
              for a, b in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        losses.append(math.inf)
    leaves = sorted(ref["grad"])
    if set(leaves) != set(prog["grad"]) or set(leaves) != set(prog["change"]):
        return {k: math.inf for k in TRAIN_NUMBERS}
    med = float(np.median([ref["grad"][k] for k in leaves]))
    moved = [k for k in leaves if ref["grad"][k] >= GRAD_FLOOR * med]
    grad = _leaf_gaps(prog["grad"], ref["grad"], leaves)
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    return {"loss_gap": max(losses), "loss_gap_first": losses[0],
            "grad_gap": max(grad), "grad_gap_median": float(np.median(grad)),
            "change_gap": max(change),
            "change_gap_median": float(np.median(change))}


def render_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{"rgb": [N, 3], "included": [N]}`` numpy
    arrays of the same rays."""
    both = prog["included"] & ref["included"]
    gap = np.abs(prog["rgb"][both].astype(np.float64)
                 - ref["rgb"][both].astype(np.float64))
    finite = bool(np.isfinite(prog["rgb"][both]).all())
    return {"rgb_gap": float(gap.max()) if gap.size and finite
            else (0.0 if finite else math.inf),
            "included_mismatch": float((prog["included"]
                                        != ref["included"]).sum())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that ``limits`` names finite and at or under its
    limit; a limit without its number fails."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= lim for k, lim in limits.items())


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """``{name: {"value": v, "limit": l}}`` of the numbers compared."""
    return {k: {"value": numbers.get(k), "limit": lim}
            for k, lim in sorted(limits.items())}
