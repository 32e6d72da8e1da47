"""Damped Newton with DOLFIN-compatible convergence semantics.

Replicates dolfin::NewtonSolver as configured by the reference's
``solver_parameters`` dicts (3D/MPNP_CO2ER_pore.py:789-799):

- convergence test on the l2 norm of the BC-applied residual:
  converged iff ||r|| < atol  OR  ||r|| < rtol * ||r0||
  (checked on the initial residual and after every update);
- update u <- u - relaxation * du with J du = r;
- hard cap on iterations (`maximum_iterations`), non-convergence reported,
  not raised (the time loop decides what to do).

The reference's bounded ``fori_loop`` with a ``cond`` skip becomes a Python
loop that tests convergence before every iteration and stops at
``max_iter``: the same iteration counts.  Each iteration reads the new
residual norm back to the host once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from gmpnp_tpu_torch.sync import to_host


class NewtonResult(NamedTuple):
    u: torch.Tensor
    iterations: int
    converged: bool
    residual_norm: float
    initial_residual_norm: float
    linear_iters: int


def _l2(r):
    # Scale-safe l2 (the reference's form): entries are pre-scaled by the
    # max magnitude so the squares cannot overflow during a divergence
    # excursion; healthy norms agree with the naive form to machine
    # precision.
    amax = torch.max(torch.abs(r))
    scale = torch.clamp_min(amax, 1e-30)
    return scale * torch.sqrt(torch.sum((r / scale) ** 2))


def newton_solve(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    linear_solve_fn: Callable[[torch.Tensor, torch.Tensor],
                              Tuple[torch.Tensor, int]],
    u0: torch.Tensor,
    rtol: float = 1e-4,
    atol: float = 1e-4,
    max_iter: int = 50,
    relaxation: float = 1.0,
    backtracking: int = 0,
    bt_growth: float = 0.0,
    carry_residual: bool = True,
    du_max: float = 1.0e6,
    stall_atol: float = None,
    stall_iters: int = 4,
) -> NewtonResult:
    """Solve F(u) = 0.

    Parameters (the reference's; see ``gmpnp_tpu.solve.newton``)
    ----------
    residual_fn : u -> r (BC-applied residual, any shape)
    linear_solve_fn : (u, r) -> (du, linear_iters); assembles the Jacobian
        at u internally and solves J du = r.
    u0 : initial iterate (should satisfy Dirichlet BCs).
    backtracking : halvings of the step length per iteration (0 = plain
        damped Newton).  The first accepted trial wins; if none passes, the
        smallest trial step is taken.
    bt_growth : 0 = strict Armijo, ||r_try|| <= (1 - 1e-4 lam) ||r||;
        g > 0 = accept while ||r_try|| <= g ||r|| (non-monotone).
    carry_residual : reuse the post-update residual as the next solve's
        right-hand side (one residual assembly per iteration); off, the
        residual is reassembled at the top of each iteration.
    du_max : cap on the max-norm of an update (the step is scaled, so its
        direction is preserved); None disables.
    stall_atol : stagnation acceptance (None = off): exit converged when the
        best residual has not improved by >5% for ``stall_iters``
        consecutive iterations and is below stall_atol.
    """
    r = residual_fn(u0)
    n0 = to_host(_l2(r))

    def converged(rn):
        return (rn < atol) or (rn < rtol * n0)

    carry_r = carry_residual and backtracking == 0
    stall = stall_atol is not None
    u, rn, it, lin = u0, n0, 0, 0
    best, ct = n0, 0

    def done():
        c = converged(rn)
        if stall:
            c = c or (ct >= stall_iters and best < stall_atol)
        return c

    while it < max_iter and not done():
        if not carry_r:
            r = residual_fn(u)
        du, klin = linear_solve_fn(u, r)
        if du_max is not None:
            mag = torch.max(torch.abs(du))
            du = du * torch.clamp(du_max / torch.clamp_min(mag, 1e-30),
                                  max=1.0)
        if backtracking > 0:
            lams = [relaxation * 0.5 ** k for k in range(backtracking + 1)]
            for lam in lams:
                u_try = u - lam * du
                rn_try = to_host(_l2(residual_fn(u_try)))
                if bt_growth > 0.0:
                    # non-monotone bounded-growth acceptance
                    armijo = rn_try <= bt_growth * rn
                else:
                    armijo = rn_try <= (1.0 - 1e-4 * lam) * rn
                # first accepted lambda wins; otherwise the last (smallest)
                # trial is the fallback iterate
                if armijo or lam == lams[-1]:
                    break
            u, rn_new = u_try, rn_try
        else:
            u = u - relaxation * du
            r = residual_fn(u)
            rn_new = to_host(_l2(r))
        it += 1
        lin += int(klin)
        if stall:
            # consecutive iterations with < 5% improvement over the best
            improved = rn_new < 0.95 * best
            best = min(best, rn_new)
            ct = 0 if improved else ct + 1
        rn = rn_new

    stalled_ok = stall and ct >= stall_iters and best < stall_atol
    return NewtonResult(
        u=u,
        iterations=it,
        converged=converged(rn) or stalled_ok,
        residual_norm=rn,
        initial_residual_norm=n0,
        linear_iters=lin,
    )


class NewtonLanesResult(NamedTuple):
    """``NewtonResult`` of V lanes: ``u`` (V, ...), the rest (V,) numpy
    arrays."""
    u: torch.Tensor
    iterations: np.ndarray
    converged: np.ndarray
    residual_norm: np.ndarray
    initial_residual_norm: np.ndarray
    linear_iters: np.ndarray


def _l2_lanes(r):
    """``_l2`` of every lane of r (V, ...) -> (V,)."""
    a = r.reshape(r.shape[0], -1)
    scale = torch.clamp_min(torch.max(torch.abs(a), dim=1).values, 1e-30)
    return scale * torch.sqrt(torch.sum((a / scale[:, None]) ** 2, dim=1))


def _lanes(mask, like):
    """(V,) numpy bool -> a tensor that broadcasts over ``like`` (V, ...)."""
    return torch.as_tensor(mask, device=like.device).reshape(
        (-1,) + (1,) * (like.dim() - 1))


def newton_solve_lanes(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    linear_solve_fn: Callable,
    u0: torch.Tensor,
    rtol: float = 1e-4,
    atol: float = 1e-4,
    max_iter: int = 50,
    relaxation: float = 1.0,
    backtracking: int = 0,
    bt_growth: float = 0.0,
    carry_residual: bool = True,
    du_max: float = 1.0e6,
    stall_atol: float = None,
    stall_iters: int = 4,
) -> NewtonLanesResult:
    """``newton_solve`` of V independent lanes at once (the reference's
    vmapped ``while_loop``; its sweeps' loop='while').

    residual_fn : u (V, ...) -> r (V, ...), one call for all lanes
    linear_solve_fn : (u, r, active) -> (du, linear_iters (V,)); ``active``
        (V,) bool names the lanes whose direction is used
    u0 : (V, ...) initial iterates

    Each lane keeps its own convergence test, du_max cap, backtracking
    trials and acceptance and stall count.  The loop runs while any lane is
    unconverged and under ``max_iter``; a lane that is done is frozen (its
    iterate, residual and counts no longer change), as the vmapped
    ``while_loop`` selects its old state.  Each iteration reads the (V,)
    residual norms back once (plus once per further backtracking trial
    that some lane still needs), whatever V is.
    """
    r = residual_fn(u0)
    n0 = to_host(_l2_lanes(r))
    V = n0.shape[0]

    def converged(rn):
        return (rn < atol) | (rn < rtol * n0)

    carry_r = carry_residual and backtracking == 0
    stall = stall_atol is not None
    u, rn = u0, n0.copy()
    it = np.zeros(V, np.int64)
    lin = np.zeros(V, np.int64)
    best, ct = n0.copy(), np.zeros(V, np.int64)

    def done():
        c = converged(rn)
        if stall:
            c = c | ((ct >= stall_iters) & (best < stall_atol))
        return c

    active = (it < max_iter) & ~done()
    while active.any():
        if not carry_r:
            r = residual_fn(u)
        du, klin = linear_solve_fn(u, r, active)
        if du_max is not None:
            mag = torch.amax(torch.abs(du.reshape(V, -1)), dim=1)
            du = du * torch.clamp(
                du_max / torch.clamp_min(mag, 1e-30), max=1.0).reshape(
                    (-1,) + (1,) * (du.dim() - 1))
        if backtracking > 0:
            lams = [relaxation * 0.5 ** k for k in range(backtracking + 1)]
            u_new, rn_new = u, rn.copy()
            pending = active.copy()
            for lam in lams:
                u_try = u - lam * du
                rn_try = to_host(_l2_lanes(residual_fn(u_try)))
                if bt_growth > 0.0:
                    armijo = rn_try <= bt_growth * rn
                else:
                    armijo = rn_try <= (1.0 - 1e-4 * lam) * rn
                # per lane: the first accepted lambda wins, else the last
                take = pending & (armijo | (lam == lams[-1]))
                u_new = torch.where(_lanes(take, u), u_try, u_new)
                rn_new = np.where(take, rn_try, rn_new)
                pending &= ~take
                if not pending.any():
                    break
        else:
            u_try = u - relaxation * du
            r_try = residual_fn(u_try)
            rn_try = to_host(_l2_lanes(r_try))
            keep = _lanes(active, u)
            u_new = torch.where(keep, u_try, u)
            r = torch.where(keep, r_try, r)
            rn_new = np.where(active, rn_try, rn)
        u = u_new
        it += active
        lin += np.where(active, np.asarray(klin, np.int64), 0)
        if stall:
            improved = rn_new < 0.95 * best
            ct = np.where(active, np.where(improved, 0, ct + 1), ct)
            best = np.where(active, np.minimum(best, rn_new), best)
        rn = rn_new
        active = (it < max_iter) & ~done()

    stalled_ok = ((ct >= stall_iters) & (best < stall_atol) if stall
                  else np.zeros(V, bool))
    return NewtonLanesResult(
        u=u,
        iterations=it,
        converged=converged(rn) | stalled_ok,
        residual_norm=rn,
        initial_residual_norm=n0,
        linear_iters=lin,
    )
