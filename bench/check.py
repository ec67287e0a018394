"""How ``correct`` is decided for a training cell.

The program's readings against the reference's (``reference.readings``),
each number against its limit in ``bench/workloads/<cell>.json``:

* ``loss_gap``: the largest relative gap of a checked step's loss;
* ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first clipped gradient, over the larger of
  the reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same of the norm of the weights' change over the
  checked steps;
* ``nonfinite_losses``: the window's steps whose loss is not finite.

A leaf whose reference gradient is under a thousandth of the median
leaf's moves under AdamW by round-off alone; it is left out of both gaps.
"""
from __future__ import annotations

import math
import statistics

QUIET_LEAF = 1e-3       # a gradient under this share of the median leaf's


def _gap(p: float, r: float, floor: float) -> float:
    g = abs(p - r) / floor
    return g if math.isfinite(g) else math.inf


def leaf_gaps(prog: dict, ref: dict, counted: list) -> dict:
    """Each counted leaf's gap, over the larger of its reference norm and
    the median leaf's."""
    floor = statistics.median(ref[k] for k in counted)
    return {k: _gap(prog[k], ref[k], max(ref[k], floor)) for k in counted}


def counted_leaves(ref) -> list:
    median = statistics.median(ref.grads.values())
    return [k for k in ref.grads if ref.grads[k] >= QUIET_LEAF * median]


def numbers(prog, ref) -> dict:
    """The compared numbers of two ``Readings``."""
    if sorted(prog.grads) != sorted(ref.grads) or len(prog.losses) != len(ref.losses):
        raise ValueError("the program's and the reference's readings cover different leaves or steps")
    counted = counted_leaves(ref)
    return {
        "loss_gap": max(_gap(p, r, abs(r)) for p, r in zip(prog.losses, ref.losses)),
        "grad_gap": max(leaf_gaps(prog.grads, ref.grads, counted).values()),
        "change_gap": max(leaf_gaps(prog.changes, ref.changes, counted).values()),
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its limit."""
    if sorted(values) != sorted(limits):
        raise ValueError(f"numbers {sorted(values)} against limits {sorted(limits)}")
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
