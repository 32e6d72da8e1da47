"""Judge the states a run produced against the plain reference.

For every episode and every lane, the first step (from the reference's own
initial state) and the last step (from the program's state before it) are
checked:

- ``newton_ratio``: the step's f64 residual over the configuration's
  Newton bound (``check.step_measures``);
- ``residual_gap``: the gap between the residual norm the program reported
  for the step and the reference's own, over the same bound: the program
  claims its answer converged on the f64 residual, and this checks the
  claim;
- ``start_gap``: the largest difference between the program's initial
  state and the reference's (exact: limit 0);
- ``unconverged``: lane-steps the program itself reported as not
  converged (limit 0).

A missing lane, or a number that is not finite, reads infinite.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import check, fem, transport


def _lanes(t, n):
    """A (N, f) state or (V, N, f) lane states -> list of (N, f) of n lanes
    (None where a lane is missing)."""
    if t.dim() == 2:
        t = t[None]
    return [t[v] if v < t.shape[0] else None for v in range(n)]


def _finite(x):
    return x if math.isfinite(x) else math.inf


def judge(cfg, states, unconverged, device):
    """states: [(voltages, first, last)] per episode, first and last each
    (u_prev, u_new, dt_scale, reported residual norms, step index), one
    lane per voltage. Returns {name: {value, limit}}."""
    g = cfg["guarantee"]
    limits = cfg["checks"]
    problems = {}
    space = None
    ratio, gap, start = 0.0, 0.0, 0.0
    for volts, first, last in states:
        for v in volts:
            if v not in problems:
                problems[v] = transport.problem(cfg, v, device)
        if space is None:
            pb = problems[volts[0]]
            space = fem.P1Space(pb.points, pb.cells,
                                cfg["program"]["quad_degree"], device,
                                torch.float64)
        n = len(volts)
        for which, (u_prev, u_new, scale, rn, idx) in (("first", first),
                                                       ("last", last)):
            prevs = _lanes(u_prev.to(device, torch.float64), n)
            news = _lanes(u_new.to(device, torch.float64), n)
            for k, v in enumerate(volts):
                pb = problems[v]
                if news[k] is None or prevs[k] is None or k >= len(rn):
                    ratio = gap = math.inf
                    continue
                up = prevs[k]
                if which == "first":
                    u0 = pb.initial_state()
                    start = max(start, float((up - u0).abs().max()))
                    up = u0
                r, bound = check.step_measures(space, pb, up, news[k], idx,
                                               g, float(scale[k]))
                ratio = max(ratio, _finite(r / bound))
                gap = max(gap, _finite(abs(float(rn[k]) - r) / bound))
    if not states:
        ratio = gap = math.inf
    return {"newton_ratio": {"value": ratio, "limit": limits["newton_ratio"]},
            "residual_gap": {"value": gap, "limit": limits["residual_gap"]},
            "start_gap": {"value": start, "limit": limits["start_gap"]},
            "unconverged": {"value": float(unconverged),
                            "limit": limits["unconverged"]}}
