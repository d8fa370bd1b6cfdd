"""The numbers that decide `correct`, and their limits.

Training: each of the first steps' losses against the reference's
(relative), the first gradient as the optimizer holds it (Adam's first
moment after one step, over 1 - b1), and the parameters' change over the
followed steps. Gradients and changes are compared leaf by leaf as the
gap between the program's norm and the reference's, and as the norm of
their difference, over the larger of that leaf's reference norm and the
median leaf's.
Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone and are left out of the change.

Views: the mean absolute gap over a view's rays of the coarse and fine
rgb, depth (over far - near) and alpha; the worst head counts, and over
a sample of views the worst view and the median one.

`limits/<workload>.json` holds each number's limit and the readings it
was set from.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

ZERO_GRAD_SHARE = 1e-3


def _leaf_norm_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                    names) -> Tuple[List[float], List[float]]:
    """Each leaf's gap of norms, and the norm of its difference, over the
    larger of its reference norm and the median leaf's."""
    ref_norm = {n: float(ref[n].double().norm()) for n in names}
    scale = max(statistics.median(ref_norm.values()), 1e-30)
    gaps, errs = [], []
    for n in names:
        p, r, s = prog[n].double(), ref[n].double(), max(ref_norm[n], scale)
        gaps.append(abs(float(p.norm()) - ref_norm[n]) / s)
        errs.append(float((p - r).norm()) / s)
    return gaps, errs


def moving_leaves(grad_ref: Dict[str, torch.Tensor]) -> List[str]:
    norms = {n: float(g.double().norm()) for n, g in grad_ref.items()}
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= ZERO_GRAD_SHARE * med]


def train_numbers(prog: dict, ref: dict, p0: Dict[str, torch.Tensor],
                  groups: Dict[str, str]) -> Dict[str, float]:
    """prog and ref: losses (list), grad1 and params ({name: tensor} on one
    device); p0 the weights both started from; groups the family's
    `LEAF_GROUPS` ({group: prefix of its leaves' names}).

    loss_gap: the worst step's relative loss gap. grad_gap / update_gap:
    the worst leaf's gap of norms of the first gradient / of the change;
    grad_gap_median / update_gap_median: the median leaf's.
    <group>_grad_err_median: the median leaf of a group's norm of the
    first gradient's difference. Unbiased rounding moves it at first
    order, where it moves a gap of norms at second. pixelNeRF's `mlp`
    (the heads) leaves the trunk out, since its bfloat16 gradients read
    tens of percent off the reference's (PERF.md); its `trunk` is the
    same over the trunk's leaves, which a float32 configuration computes
    in float32."""
    names = sorted(ref["grad1"])
    if len(prog["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, prog["losses"])):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(prog["losses"], ref["losses"]))
    moving = moving_leaves(ref["grad1"])
    delta = lambda side: {n: side["params"][n] - p0[n] for n in moving}
    grad, grad_err = _leaf_norm_gaps(prog["grad1"], ref["grad1"], names)
    update, _ = _leaf_norm_gaps(delta(prog), delta(ref), moving)
    out = {
        "loss_gap": loss_gap,
        "grad_gap": max(grad),
        "grad_gap_median": statistics.median(grad),
        **{f"{group}_grad_err_median": statistics.median(
            e for n, e in zip(names, grad_err) if n.startswith(prefix))
           for group, prefix in groups.items()},
        "update_gap": max(update),
        "update_gap_median": statistics.median(update),
    }
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def view_numbers(prog: dict, ref: dict, depth_range: float) -> Dict[str, float]:
    """One view's gaps, the worst head's; prog and ref {'coarse'|'fine':
    {'rgb', 'depth', 'alpha'}}."""
    keys = ("rgb_mae", "depth_mae", "alpha_mae")
    if set(prog) != set(ref):
        return dict.fromkeys(keys, math.inf)
    gaps = []
    for head in ref:
        p, r = prog[head], ref[head]
        gap = lambda k: float((p[k].float().to(r[k].device) - r[k]).abs().mean())
        gaps.append({"rgb_mae": gap("rgb"), "depth_mae": gap("depth") / depth_range,
                     "alpha_mae": gap("alpha")})
    out = {k: max(g[k] for g in gaps) for k in keys}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def over_views(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """A sample of views: each number's worst view, and the median view's
    rgb gap (`rgb_mae_median`)."""
    out = worst(readings)
    out["rgb_mae_median"] = statistics.median(r["rgb_mae"] for r in readings)
    return out


def judge(numbers: Dict[str, float], limits: dict) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number that is not finite fails."""
    table, ok = {}, True
    for name, spec in limits["numbers"].items():
        value = numbers.get(name, math.inf)
        passed = math.isfinite(value) and value <= spec["limit"]
        ok &= passed
        table[name] = {"value": value if math.isfinite(value) else None, "limit": spec["limit"]}
    return ok, table
