"""The measures of one step that decide ``correct`` (``judge.py``).

The configuration states its guarantee: every step's Newton converges on
the f64 residual, ``||F(u_new; u_prev)|| < atol`` or
``< rtol * ||F(u_start; u_prev)||``, where ``u_start`` is the step's start
state with its Dirichlet values set. The reference evaluates both norms
itself, in f64, with its own assembly of the model, at the states the
program produced.

The step parameters (dt, the Sechenov entry value) are worked out again
from u_prev; the program's only input here is ``dt_scale``, the factor by
which its dt-cut recovery shortened the step, which the state alone cannot
show.
"""

from __future__ import annotations

import torch

from benchmark.reference import fem


def step_measures(space, problem, u_prev, u_new, step_index, guarantee,
                  dt_scale=1.0):
    """(||F(u_new)||, the step's bound max(atol, rtol ||F(u_start)||))."""
    theta = problem.theta(u_prev, step_index, dt_scale)
    mask, values = problem.dirichlet(theta)
    u_start = torch.where(mask, values, u_prev)
    r = float(fem.l2(space.residual(problem, u_new, u_prev, theta)))
    r0 = float(fem.l2(space.residual(problem, u_start, u_prev, theta)))
    return r, max(guarantee["atol"], guarantee["rtol"] * r0)

