"""Implicit time integration loop.

Backward-Euler transient with a damped Newton solve per step.  The
reference compiles the whole transient into one ``lax.scan``; here it is a
Python loop over steps that runs eagerly on the tensors' device.

Data-dependent per-step behavior of the reference — staged dt schedules,
Sechenov Dirichlet updates (3D/MPNP_CO2ER_pore.py:815-838) — enters through
``theta``: a dict produced per step by a model-supplied carry update.

Kinds: the 3D slab path (``kind='slab_direct'``, ``slab_mode`` 'thomas'
or 'cr', ``refresh`` in {'iter', 'step', 'carried'}), the 1D
block-tridiagonal kinds (``tridiag_cr``, also carried, and
``tridiag_thomas``), the Krylov fallbacks (``gmres``, ``bicgstab``, with
block-Jacobi, multicolor SSOR or AMG preconditioning) and the dense test
solver.  ``refresh='auto'`` is resolved by timing both modes
(``calibrate_refresh``) before a step is built.

Spans (``utils.profiling``): ``run_transient`` opens ``step`` around each
step and ``step.update`` around the model's carry update (the step's
parameters before it, the carry and the record after it), all under one
step id.  Counters: every factorization of a Jacobian for a direct solve
adds its lanes to ``factors.<reason>``: the refresh mode (``step``,
``iter``) or, in the carried chord step, ``init``, ``fallback`` (the
exact re-solve after a failed chord attempt and the factor at its end)
and ``refresh`` (proactive, after more than ``refresh_iters``
iterations).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gmpnp_tpu_torch.fem.assembly import BlockELL, FemSpace
from gmpnp_tpu_torch.fem.dirichlet import DirichletBC
from gmpnp_tpu_torch.fem.forms import WeakForm
from gmpnp_tpu_torch.ops.ell_spmv import lane_aligned
from gmpnp_tpu_torch.solve.linear import (
    bicgstab,
    bicgstab_lanes,
    block_jacobi_preconditioner,
    block_tridiag_apply_cr,
    block_tridiag_factor_cr,
    block_tridiag_from_ell,
    block_tridiag_solve_cr,
    block_tridiag_solve_thomas,
    dense_solve,
    gmres,
    gmres_lanes,
    multicolor_ssor_preconditioner,
    tridiag_mp_solve,
)
from gmpnp_tpu_torch.solve.newton import newton_solve, newton_solve_lanes
from gmpnp_tpu_torch.solve.slab import (
    SlabPlan,
    full_f32_precision,
    slab_apply,
    slab_apply_f32,
    slab_direct_solve,
    slab_prepare,
)
from gmpnp_tpu_torch.solve.smallblock import block_inv
from gmpnp_tpu_torch.sync import to_host
from gmpnp_tpu_torch.utils.profiling import begin_step, count, end_step, span


@dataclass(frozen=True)
class NewtonConfig:
    """Mirror of the reference solver_parameters newton_solver blocks (the
    fields and defaults of ``gmpnp_tpu.solve.timeloop.NewtonConfig``, less
    ``loop``: the iteration is one Python loop here)."""
    max_iter: int = 50
    rtol: float = 1.0e-4
    atol: float = 1.0e-4
    relaxation: float = 1.0
    # backtracking halvings per iteration (0 = plain damped Newton)
    backtracking: int = 0
    # backtracking acceptance: 0.0 = strict Armijo; g > 0 = bounded growth
    bt_growth: float = 0.0
    # assemble the residual once per iteration
    carry_residual: bool = True
    # cap on ||du||_inf per Newton update; None disables
    du_max: Optional[float] = 1.0e6
    # stagnation acceptance bound (None = off) and its patience
    stall_atol: Optional[float] = None
    stall_iters: int = 4


@dataclass(frozen=True)
class LinearConfig:
    """Linear-solver selection per model: the fields and defaults of
    ``gmpnp_tpu.solve.timeloop.LinearConfig`` (see its docstring).

    kind: 'slab_direct' (z-slab mixed-precision direct solver, solve.slab;
    ``slab_mode`` 'thomas' or 'cr'), 'tridiag_cr' (1D block cyclic
    reduction) and 'tridiag_thomas' (1D oracle), 'gmres' and 'bicgstab'
    (Krylov fallbacks; ``precond`` 'block_jacobi', 'ssor' or 'amg';
    ``solve_dtype='f32'`` equilibrates in f64 and iterates in f32), 'dense'
    (tests).  refresh: 'iter' (exact Newton), 'step' (one slab
    factorization per step), 'carried' (factorization carried across
    steps, chord Newton — ``make_carried_step``) or 'auto' (resolved by
    ``calibrate_refresh``).  ``solve_dtype='f32'`` with 'tridiag_cr'
    selects ``tridiag_mp_solve``.  ``jac_dtype='f32'`` evaluates element
    Jacobians in f32.  The reference's ``matvec`` selector has no
    counterpart: a CUDA tensor always takes the kernel."""
    kind: str = "tridiag_cr"
    tol: float = 1.0e-8
    atol: float = 0.0
    restart: int = 30
    maxiter: int = 300
    precond: str = "block_jacobi"   # 'block_jacobi' | 'ssor' | 'amg'
    ssor_sweeps: int = 1
    max_refine: int = 40
    max_slabs: Optional[int] = None
    slab_mode: str = "thomas"
    refresh: str = "iter"
    refresh_iters: int = 8
    chord_max_iter: int = 16
    chord_tol: Optional[float] = 1.0e-6
    chord_dtype: str = "f32"
    chord_predict: bool = True
    jac_dtype: str = "f64"
    solve_dtype: str = "f64"


class StepStats(NamedTuple):
    newton_iters: int
    converged: bool
    residual_norm: float
    linear_iters: int
    # dt actually used / scheduled dt: 1.0 on the plain path; 0.5**k after
    # k divergence-triggered halvings by make_recovering_step
    dt_scale: Any = 1.0


_LINEAR_KINDS = ("tridiag_cr", "tridiag_thomas", "dense", "slab_direct",
                 "gmres", "bicgstab")


def _validate_linear_config(cfg: LinearConfig) -> None:
    """Fail fast on unrecognized string knobs."""
    if cfg.kind not in _LINEAR_KINDS:
        raise ValueError(
            f"unknown linear solver kind {cfg.kind!r}; one of {_LINEAR_KINDS}")
    if cfg.refresh not in ("iter", "step", "carried", "auto"):
        raise ValueError(f"refresh must be 'iter', 'step', 'carried' or "
                         f"'auto', got {cfg.refresh!r}")
    if cfg.slab_mode not in ("thomas", "cr"):
        raise ValueError(f"slab_mode must be 'thomas' or 'cr', got "
                         f"{cfg.slab_mode!r}")
    if cfg.precond not in ("block_jacobi", "ssor", "amg"):
        raise ValueError(f"precond must be 'block_jacobi', 'ssor' or "
                         f"'amg', got {cfg.precond!r}")
    for name in ("jac_dtype", "chord_dtype", "solve_dtype"):
        if getattr(cfg, name) not in ("f32", "f64"):
            raise ValueError(f"{name} must be 'f32' or 'f64', got "
                             f"{getattr(cfg, name)!r}")


def _dt_of(theta, dt_key: str = "dt") -> float:
    """The step's dt as a float; theta[dt_key] may be a float or a 0-d
    tensor."""
    if isinstance(theta, dict) and dt_key in theta:
        return float(to_host(theta[dt_key]))
    return 1.0


def _slab_plan(space: FemSpace, cfg: LinearConfig) -> SlabPlan:
    return SlabPlan.build(
        np.asarray(space.adj), np.asarray(space.points)[:, -1],
        space.n_fields, np.asarray(space.diag_slot),
        max_slabs=cfg.max_slabs)


def _assemble(space: FemSpace, form: WeakForm, cfg: LinearConfig, bc, u,
              u_prev, theta) -> BlockELL:
    """The BC-applied Jacobian at u; with ``jac_dtype='f32'`` the element
    Jacobians are evaluated in f32 (inexact Newton) and the assembled
    values are held in u's dtype."""
    aux = theta.get("_aux") if isinstance(theta, dict) else None
    jdt = torch.float32 if cfg.jac_dtype == "f32" else None
    return bc.apply_to_jacobian(
        space.jacobian(form, u, u_prev, theta, aux=aux, dtype=jdt))


def make_linear_solver(space: FemSpace, form: WeakForm, cfg: LinearConfig,
                       factor_reason: Optional[str] = None):
    """(bc, u_prev, theta) -> callable (u, r) -> (du, linear_iters).

    Each factorization of a direct kind is counted under
    ``factors.<factor_reason>`` (default: the refresh mode)."""
    _validate_linear_config(cfg)
    if cfg.refresh == "carried":
        raise ValueError(
            "refresh='carried' carries the factorization across time steps "
            "and needs the stateful step protocol — build the step with "
            "make_carried_step (models wire this automatically)")
    if cfg.refresh == "auto":
        raise ValueError(
            "refresh='auto' must be resolved to a concrete mode before "
            "building a step — call calibrate_refresh (models wire this "
            "automatically in their run() paths)")
    full_f32_precision()
    factors = f"factors.{factor_reason or cfg.refresh}"
    slab_plan = _slab_plan(space, cfg) if cfg.kind == "slab_direct" else None
    amg_plan = None
    if cfg.precond == "amg" and cfg.kind in ("gmres", "bicgstab"):
        # aggregation structure depends only on the mesh graph: built once
        # per space, shared by every assembled matrix (solve.amg)
        from gmpnp_tpu_torch.solve.amg import AMGPlan
        amg_plan = AMGPlan.build(np.asarray(space.adj), space.n_fields)

    @span("linear.solve")
    def krylov(ell, r):
        out_dtype = r.dtype
        if cfg.solve_dtype == "f32":
            # equilibrate in f64 first (every block row O(1)), then iterate
            # in native f32: the raw system's ~1e8 row-scale range is more
            # than f32 rounding resolves
            Dinv = block_inv(ell.diag_blocks())
            ell = ell.scale_rows(Dinv)
            ell = BlockELL(ell.adj, ell.flat.to(torch.float32),
                           ell.diag_slot)
            r = torch.einsum("nfg,ng->nf", Dinv, r).to(torch.float32)
        if cfg.precond == "ssor":
            pc = multicolor_ssor_preconditioner(
                ell, space.colors, sweeps=cfg.ssor_sweeps)
        elif cfg.precond == "amg":
            from gmpnp_tpu_torch.solve.amg import amg_preconditioner
            pc = amg_preconditioner(ell, amg_plan)
        else:
            pc = block_jacobi_preconditioner(ell)
        if cfg.kind == "gmres":
            res = gmres(ell.matvec, r, Minv=pc, tol=cfg.tol, atol=cfg.atol,
                        restart=cfg.restart, maxiter=cfg.maxiter)
        else:
            res = bicgstab(ell.matvec, r, Minv=pc, tol=cfg.tol,
                           atol=cfg.atol, maxiter=cfg.maxiter)
        return res.x.to(out_dtype), res.iters

    def solver(bc: DirichletBC, u_prev, theta):
        def assemble(u):
            return _assemble(space, form, cfg, bc, u, u_prev, theta)

        if cfg.kind == "slab_direct" and cfg.refresh == "step":
            # modified Newton: factor once at the step's start iterate,
            # reuse for all iterations
            prep = slab_prepare(assemble(bc.project(u_prev)), slab_plan,
                                mode=cfg.slab_mode)
            count(factors)

            def lin_frozen(u, r):
                res = slab_apply(prep, r, slab_plan, tol=cfg.tol,
                                 max_refine=cfg.max_refine)
                return res.x, res.iters

            return lin_frozen

        def lin(u, r):
            ell = assemble(u)
            if cfg.kind in ("gmres", "bicgstab"):
                return krylov(ell, r)
            count(factors)
            if cfg.kind == "tridiag_cr":
                if cfg.solve_dtype == "f32":
                    res = tridiag_mp_solve(ell, r, tol=cfg.tol,
                                           max_refine=cfg.max_refine)
                    return res.x, res.iters
                return block_tridiag_solve_cr(*block_tridiag_from_ell(ell),
                                              r), 0
            if cfg.kind == "tridiag_thomas":
                return block_tridiag_solve_thomas(
                    *block_tridiag_from_ell(ell), r), 0
            if cfg.kind == "dense":
                return dense_solve(ell, r), 0
            res = slab_direct_solve(ell, r, slab_plan, tol=cfg.tol,
                                    max_refine=cfg.max_refine,
                                    mode=cfg.slab_mode)
            return res.x, res.iters

        return lin

    return solver


def _newton_kwargs(newton_cfg: NewtonConfig) -> dict:
    return dict(rtol=newton_cfg.rtol, atol=newton_cfg.atol,
                relaxation=newton_cfg.relaxation,
                backtracking=newton_cfg.backtracking,
                bt_growth=newton_cfg.bt_growth,
                carry_residual=newton_cfg.carry_residual,
                du_max=newton_cfg.du_max, stall_atol=newton_cfg.stall_atol,
                stall_iters=newton_cfg.stall_iters)


def make_implicit_step(
    space: FemSpace,
    form: WeakForm,
    newton_cfg: NewtonConfig,
    linear_cfg: LinearConfig,
    bc_of_theta: Callable[[Any], DirichletBC],
):
    """Build the per-step solve: (u_prev, theta) -> (u_new, StepStats)."""
    lin_builder = make_linear_solver(space, form, linear_cfg)

    def step(u_prev: torch.Tensor, theta) -> Tuple[torch.Tensor, StepStats]:
        bc = bc_of_theta(theta)
        aux = theta.get("_aux") if isinstance(theta, dict) else None

        def residual(u):
            return bc.apply_to_residual(
                space.residual(form, u, u_prev, theta, aux=aux), u)

        lin = lin_builder(bc, u_prev, theta)
        res = newton_solve(residual, lin, bc.project(u_prev),
                           max_iter=newton_cfg.max_iter,
                           **_newton_kwargs(newton_cfg))
        stats = StepStats(
            newton_iters=res.iterations,
            converged=res.converged,
            residual_norm=res.residual_norm,
            linear_iters=res.linear_iters)
        return res.u, stats

    return step


# ---------------------------------------------------------------------------
# Sweep lanes: V independent transients of one program, batched
# ---------------------------------------------------------------------------

def stack_lane_theta(thetas, device):
    """Per-lane step parameters -> one lane theta: a key whose value is the
    same Python scalar in every lane stays that scalar; any other becomes a
    tensor with a leading lane axis (V, ...) on ``device``."""
    out = {}
    for key in thetas[0]:
        vals = [th[key] for th in thetas]
        if (not any(isinstance(v, torch.Tensor) for v in vals)
                and all(v == vals[0] for v in vals)):
            out[key] = vals[0]
        else:
            out[key] = torch.stack([
                torch.as_tensor(v, dtype=torch.float64, device=device)
                for v in vals])
    return out


def lane_theta(theta, lane: int):
    """Lane ``lane``'s own theta out of a lane theta."""
    return {k: v[lane] if isinstance(v, torch.Tensor) else v
            for k, v in theta.items()}


def _assemble_lanes(space: FemSpace, form: WeakForm, cfg: LinearConfig, bc,
                    u, u_prev, theta) -> BlockELL:
    """``_assemble`` of V lanes: one lane-batched BlockELL."""
    aux = theta.get("_aux") if isinstance(theta, dict) else None
    jdt = torch.float32 if cfg.jac_dtype == "f32" else None
    return bc.apply_to_jacobian(
        space.jacobian_lanes(form, u, u_prev, theta, aux=aux, dtype=jdt))


def make_linear_solver_lanes(space: FemSpace, form: WeakForm,
                             cfg: LinearConfig):
    """Lane counterpart of ``make_linear_solver``: (bc, u_prev, theta) of V
    lanes -> callable (u, r, active) -> (du (V, N, f), linear_iters (V,)).

    Every kind is one lane-batched linear solve per Newton iteration: one
    lane-batched Jacobian, then the kind's lane solver (the slab
    factorization, Thomas or CR, under f64 GMRES; the 1D CR, Thomas and
    mixed-precision solves; GMRES or BiCGStab with a lane-batched
    preconditioner, after the f64 equilibration of ``solve_dtype='f32'``;
    the dense solve), whose Krylov lanes each stop where their single-lane
    solve stops.  The matvec of every Krylov lane solve is one launch of
    the block-ELL kernel's lane axis."""
    _validate_linear_config(cfg)
    if cfg.refresh not in ("iter", "step"):
        raise ValueError(
            f"lane-batched steps take refresh 'iter' or 'step', got "
            f"{cfg.refresh!r} (sweeps downgrade or resolve the others)")
    full_f32_precision()
    factors = f"factors.{cfg.refresh}"
    plan = _slab_plan(space, cfg) if cfg.kind == "slab_direct" else None
    amg_plan = None
    if cfg.precond == "amg" and cfg.kind in ("gmres", "bicgstab"):
        from gmpnp_tpu_torch.solve.amg import AMGPlan
        amg_plan = AMGPlan.build(np.asarray(space.adj), space.n_fields)

    @span("linear.solve")
    def krylov(ell, r, active):
        out_dtype = r.dtype
        if cfg.solve_dtype == "f32":
            Dinv = block_inv(ell.diag_blocks())
            ell = ell.scale_rows(Dinv)
            ell = BlockELL(ell.adj, ell.flat.to(torch.float32),
                           ell.diag_slot)
            r = torch.einsum("vnfg,vng->vnf", Dinv, r).to(torch.float32)
        ell = BlockELL(ell.adj, lane_aligned(ell.flat), ell.diag_slot)
        if cfg.precond == "ssor":
            pc = multicolor_ssor_preconditioner(
                ell, space.colors, sweeps=cfg.ssor_sweeps)
        elif cfg.precond == "amg":
            from gmpnp_tpu_torch.solve.amg import amg_preconditioner
            pc = amg_preconditioner(ell, amg_plan)
        else:
            pc = block_jacobi_preconditioner(ell)
        if cfg.kind == "gmres":
            res = gmres_lanes(ell.matvec, r, Minv=pc, tol=cfg.tol,
                              atol=cfg.atol, restart=cfg.restart,
                              maxiter=cfg.maxiter, active=active)
        else:
            res = bicgstab_lanes(ell.matvec, r, Minv=pc, tol=cfg.tol,
                                 atol=cfg.atol, maxiter=cfg.maxiter,
                                 active=active)
        return res.x.to(out_dtype), res.iters

    def solver(bc, u_prev, theta):
        def assemble(u):
            return _assemble_lanes(space, form, cfg, bc, u, u_prev, theta)

        if cfg.kind == "slab_direct":
            def prepare(u):
                prep = slab_prepare(assemble(u), plan, mode=cfg.slab_mode)
                count(factors, prep.Dinv0.shape[0])
                return prep

            frozen = (prepare(bc.project(u_prev)) if cfg.refresh == "step"
                      else None)

            def lin_slab(u, r, active):
                prep = frozen if frozen is not None else prepare(u)
                res = slab_apply(prep, r, plan, tol=cfg.tol,
                                 max_refine=cfg.max_refine, active=active)
                return res.x, res.iters

            return lin_slab

        def lin(u, r, active):
            ell = assemble(u)
            if cfg.kind in ("gmres", "bicgstab"):
                return krylov(ell, r, active)
            none = np.zeros(r.shape[0], np.int64)
            count(factors, r.shape[0])
            if cfg.kind == "tridiag_cr":
                if cfg.solve_dtype == "f32":
                    res = tridiag_mp_solve(ell, r, tol=cfg.tol,
                                           max_refine=cfg.max_refine,
                                           active=active)
                    return res.x, res.iters
                return block_tridiag_solve_cr(*block_tridiag_from_ell(ell),
                                              r), none
            if cfg.kind == "tridiag_thomas":
                return block_tridiag_solve_thomas(
                    *block_tridiag_from_ell(ell), r), none
            if cfg.kind == "dense":
                return dense_solve(ell, r), none

        return lin

    return solver


def make_implicit_step_lanes(
    space: FemSpace,
    form: WeakForm,
    newton_cfg: NewtonConfig,
    linear_cfg: LinearConfig,
    bc_of_theta: Callable[[Any], DirichletBC],
):
    """``make_implicit_step`` of V lanes: (u_prev (V, N, f), lane theta)
    -> (u_new (V, N, f), StepStats of (V,) arrays).  One Newton iteration is
    one batched residual, Jacobian and linear solve for all lanes
    (``newton_solve_lanes``); ``bc_of_theta`` takes the lane theta and
    gives a BC with (V, N, f) values (``ArithDirichletBC``)."""
    lin_builder = make_linear_solver_lanes(space, form, linear_cfg)

    def step(u_prev, theta):
        bc = bc_of_theta(theta)
        aux = theta.get("_aux") if isinstance(theta, dict) else None

        def residual(u):
            return bc.apply_to_residual(
                space.residual_lanes(form, u, u_prev, theta, aux=aux), u)

        lin = lin_builder(bc, u_prev, theta)
        res = newton_solve_lanes(residual, lin, bc.project(u_prev),
                                 max_iter=newton_cfg.max_iter,
                                 **_newton_kwargs(newton_cfg))
        stats = StepStats(
            newton_iters=res.iterations,
            converged=res.converged,
            residual_norm=res.residual_norm,
            linear_iters=res.linear_iters,
            dt_scale=np.ones(len(res.iterations)))
        return res.u, stats

    return step


def run_transient_lanes(step: Callable, carry0, n_steps: int,
                        update_carry: Optional[Callable] = None,
                        theta_of_carry: Optional[Callable] = None):
    """``run_transient`` of a lane step (``make_implicit_step_lanes``), with
    the records' lane axis first: returns (final_carry, (u_hist (V, steps,
    N, f), StepStats of (V, steps) arrays))."""
    final, (u_hist, stats) = run_transient(
        step, carry0, n_steps, update_carry=update_carry,
        theta_of_carry=theta_of_carry, lanes=carry0[0].shape[0])
    return final, (u_hist.transpose(0, 1),
                   StepStats(*(np.asarray(a).T for a in stats)))


class ChordCarry(NamedTuple):
    """State of the carried-factor chord Newton step, threaded from step to
    step (all of it derived data):

    - ``prep``: the stale factorization (solve.slab.SlabPrepared in 3D,
      solve.linear.CRFactors in 1D);
    - ``du``: the previous accepted step's increment u_n - u_{n-1} (zeros
      at init — the first step predicts u_prev);
    - ``dt_prev``: the dt that produced ``du``;
    - ``du_nrm_prev``: ||u_{n-1} - u_{n-2}||, for the decay estimate
      rho = ||du|| / du_nrm_prev of the chord predictor.
    """
    prep: Any
    du: torch.Tensor
    dt_prev: float
    du_nrm_prev: float


def make_carried_step(
    space: FemSpace,
    form: WeakForm,
    newton_cfg: NewtonConfig,
    linear_cfg: LinearConfig,
    bc_of_theta: Callable[[Any], DirichletBC],
    dt_key: str = "dt",
):
    """Carried-factor transient step (``LinearConfig.refresh='carried'``).

    Returns ``(step, prep_init)`` where

        step: (u_prev, theta, carry) -> (u_new, StepStats, carry_new)
        prep_init: (u0, theta) -> ChordCarry

    Each step first runs Newton against the carried (stale) factorization —
    a chord iteration certified on the true f64 residual, with a budget of
    ``linear_cfg.chord_max_iter`` iterations, started from the decay-scaled
    extrapolation ``u_prev + clip(rho*dt/dt_prev, 0, 1.5) * du`` when
    ``chord_predict`` (its rtol is measured at the safe start, u_prev with
    its Dirichlet values, as in exact Newton: ``newton_solve``'s
    ``start_residual``).  The carried factorization is the slab one
    (``kind='slab_direct'``; with ``chord_dtype='f32'`` the chord directions
    come from ``slab_apply_f32``, f32 GMRES whose matvec is the block-ELL
    kernel) or, in 1D (``kind='tridiag_cr'``), the all-f64 CR factorization,
    whose apply is exact for the stale matrix (no linear iterations).  The
    factorization is rebuilt only when

    - the chord attempt does not converge: the step is re-solved with exact
      Newton from the safe u_prev (identical to refresh='iter') and the
      factor is refreshed at the accepted state; or
    - it converges but needs more than ``linear_cfg.refresh_iters``
      iterations (the factor is refreshed for the next step).

    The re-solve and its refactor run in a ``step.fallback`` span.  Its
    ``StepStats`` hold the re-solve's iterations alone; the abandoned chord
    attempts are counted in ``chord.failed``, their Newton and Krylov
    iterations in ``chord.failed_iters`` and ``chord.failed_krylov``
    (``utils.profiling.count``: host integers the step already holds).
    """
    _validate_linear_config(linear_cfg)
    if linear_cfg.kind not in ("slab_direct", "tridiag_cr"):
        raise ValueError(
            "make_carried_step requires a direct kind whose factorization "
            "can ride the carry ('slab_direct' for 3D, 'tridiag_cr' for "
            f"1D), got {linear_cfg.kind!r}")
    full_f32_precision()

    def assemble(u, u_prev, theta, bc):
        return _assemble(space, form, linear_cfg, bc, u, u_prev, theta)

    if linear_cfg.kind == "slab_direct":
        plan = _slab_plan(space, linear_cfg)

        def prep_of(u, u_prev, theta, bc):
            return slab_prepare(assemble(u, u_prev, theta, bc), plan,
                                mode=linear_cfg.slab_mode)
    else:
        def prep_of(u, u_prev, theta, bc):
            return block_tridiag_factor_cr(
                *block_tridiag_from_ell(assemble(u, u_prev, theta, bc)))

    def prep_init(u0, theta):
        bc = bc_of_theta(theta)
        count("factors.init")
        return ChordCarry(
            prep=prep_of(bc.project(u0), u0, theta, bc),
            du=torch.zeros_like(u0),
            dt_prev=_dt_of(theta, dt_key),
            du_nrm_prev=0.0)

    # exact-Newton fallback: per-iterate assemble+factor, as refresh='iter'
    exact_lin_builder = make_linear_solver(
        space, form, dataclasses.replace(linear_cfg, refresh="iter"),
        factor_reason="fallback")

    chord_tol = (linear_cfg.tol if linear_cfg.chord_tol is None
                 else linear_cfg.chord_tol)
    if linear_cfg.kind == "tridiag_cr":
        def lin_of(p):
            def lin(u, r):
                return block_tridiag_apply_cr(p, r), 0
            return lin
    elif linear_cfg.chord_dtype == "f32":
        # the f32 Givens recursion stalls below ~1e-6 relative, so the
        # tolerance is floored there (the reference's rule)
        tol32 = max(chord_tol, 1.0e-6)

        def lin_of(p):
            def lin(u, r):
                res = slab_apply_f32(
                    p, r, plan, tol=tol32,
                    max_refine=min(linear_cfg.max_refine, 16))
                return res.x, res.iters
            return lin
    else:
        def lin_of(p):
            def lin(u, r):
                res = slab_apply(p, r, plan, tol=chord_tol,
                                 max_refine=linear_cfg.max_refine)
                return res.x, res.iters
            return lin

    def step(u_prev, theta, carry):
        prep = carry.prep
        bc = bc_of_theta(theta)
        aux = theta.get("_aux") if isinstance(theta, dict) else None

        def residual(u):
            return bc.apply_to_residual(
                space.residual(form, u, u_prev, theta, aux=aux), u)

        u0_safe = bc.project(u_prev)
        nrm_du = to_host(torch.linalg.norm(carry.du))
        start = None
        if linear_cfg.chord_predict:
            # decay-aware extrapolated start for the chord attempt only
            dt = _dt_of(theta, dt_key)
            rho = (nrm_du / max(carry.du_nrm_prev, 1e-300)
                   if carry.du_nrm_prev > 0 else 0.0)
            ratio = dt / carry.dt_prev if carry.dt_prev > 0 else 0.0
            factor = min(max(rho * ratio, 0.0), 1.5)
            u0_chord = bc.project(u_prev + factor * carry.du)
            if factor > 0.0:
                # rtol stays relative to the safe start's residual: a
                # predicted start that overshoots has the larger one
                start = lambda: residual(u0_safe)
        else:
            u0_chord = u0_safe

        res1 = newton_solve(
            residual, lin_of(prep), u0_chord,
            max_iter=min(linear_cfg.chord_max_iter, newton_cfg.max_iter),
            start_residual=start, **_newton_kwargs(newton_cfg))
        if res1.converged:
            res, prep_used = res1, prep
        else:
            # the abandoned attempt's work, which StepStats leaves out
            count("chord.failed")
            count("chord.failed_iters", res1.iterations)
            count("chord.failed_krylov", res1.linear_iters)
            # exact-Newton re-solve from the SAFE start
            with span("step.fallback"):
                res = newton_solve(
                    residual, exact_lin_builder(bc, u_prev, theta), u0_safe,
                    max_iter=newton_cfg.max_iter,
                    **_newton_kwargs(newton_cfg))
                prep_used = prep_of(res.u, u_prev, theta, bc)
            count("factors.fallback")

        # proactive refresh for the NEXT step when the stale factor made
        # this (converged) step slow
        if res1.converged and res1.iterations > linear_cfg.refresh_iters:
            prep_new = prep_of(res.u, u_prev, theta, bc)
            count("factors.refresh")
        else:
            prep_new = prep_used

        stats = StepStats(
            newton_iters=res.iterations,
            converged=res.converged,
            residual_norm=res.residual_norm,
            linear_iters=res.linear_iters)
        carry_new = ChordCarry(prep=prep_new, du=res.u - u_prev,
                               dt_prev=_dt_of(theta, dt_key),
                               du_nrm_prev=nrm_du)
        return res.u, stats, carry_new

    return step, prep_init


def _halved(theta, dt_key: str, k: int):
    th = dict(theta)
    th[dt_key] = theta[dt_key] * 0.5 ** k
    return th


def make_retrying_step(
    step: Callable,
    max_retries: int = 3,
    dt_key: str = "dt",
):
    """Wrap a ``(u_prev, theta) -> (u_new, StepStats)`` step with
    divergence-triggered dt halving: a non-converged attempt is retried
    with ``theta[dt_key]`` halved, up to ``max_retries`` times.  Returns
    ``(u_new, stats, dt_scale)`` for the accepted attempt."""

    def retry_step(u_prev, theta):
        k = 0
        u, st = step(u_prev, theta)
        while not st.converged and k < max_retries:
            k += 1
            u, st = step(u_prev, _halved(theta, dt_key, k))
        return u, st, 0.5 ** k

    return retry_step


def make_recovering_step(
    space: FemSpace,
    form: WeakForm,
    newton_cfg: NewtonConfig,
    linear_cfg: LinearConfig,
    bc_of_theta: Callable[[Any], DirichletBC],
    max_retries: int = 3,
):
    """``make_implicit_step`` wrapped in ``make_retrying_step``, with the
    accepted attempt's dt factor recorded in ``StepStats.dt_scale``."""
    base = make_implicit_step(space, form, newton_cfg, linear_cfg,
                              bc_of_theta)
    retry = make_retrying_step(base, max_retries=max_retries)

    def step(u_prev, theta):
        u, st, scale = retry(u_prev, theta)
        return u, st._replace(dt_scale=scale)

    return step


def make_recovering_carried_step(
    space: FemSpace,
    form: WeakForm,
    newton_cfg: NewtonConfig,
    linear_cfg: LinearConfig,
    bc_of_theta: Callable[[Any], DirichletBC],
    max_retries: int = 3,
    dt_key: str = "dt",
):
    """Carried-factor step with divergence-triggered dt halving.  Each
    retry rebuilds the carried factorization at the halved dt (prep_init,
    which also zeroes du so the retry's chord attempt starts from the safe
    u_prev)."""
    base, prep_init = make_carried_step(space, form, newton_cfg,
                                        linear_cfg, bc_of_theta)

    def step(u_prev, theta, prep):
        k = 0
        u, st, p = base(u_prev, theta, prep)
        while not st.converged and k < max_retries:
            k += 1
            th = _halved(theta, dt_key, k)
            u, st, p = base(u_prev, th, prep_init(u_prev, th))
        return u, st._replace(dt_scale=0.5 ** k), p

    return step, prep_init


def _stack(items):
    """Stack per-step records: tensors along a new leading axis, tuples and
    NamedTuples field by field, host scalars into numpy arrays."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, tuple):
        cols = [_stack([it[i] for it in items]) for i in range(len(first))]
        return type(first)(*cols) if hasattr(first, "_fields") else tuple(cols)
    return np.asarray(items)


def run_transient(
    step: Callable,
    carry0,
    n_steps: int,
    update_carry: Optional[Callable] = None,
    theta_of_carry: Optional[Callable] = None,
    record: Optional[Callable] = None,
    record_stride: int = 1,
    step_state0=None,
    lanes: int = 1,
):
    """Generic transient loop.

    carry = (u, extra); per step i:
        theta = theta_of_carry(carry, i)
        u_new, stats = step(u, theta)
        extra_new = update_carry(extra, u_new, i)
        y = record(u_new, stats)

    Returns (final_carry, stacked_ys), with every ``record_stride``-th
    step's record (steps k-1, 2k-1, ...; requires k | n_steps).

    ``step_state0`` opts into the stateful step protocol (the carried slab
    factorization of ``make_carried_step``): the step is called as
    ``step(u, theta, state) -> (u_new, stats, state_new)`` and the return
    becomes ``((u_final, extra_final, state_final), stacked_ys)``.

    Each step runs in a ``step`` span (attributes ``index`` and ``lanes``)
    between two ``step.update`` spans, all three under one step id.
    """
    if update_carry is None:
        update_carry = lambda extra, u, i: extra
    if theta_of_carry is None:
        theta_of_carry = lambda carry, i: None
    if record is None:
        record = lambda u, stats: (u, stats)
    k = max(record_stride, 1)
    if n_steps % k:
        raise ValueError(f"record_stride {k} must divide n_steps {n_steps}")

    stateful = step_state0 is not None
    u, extra = carry0
    st = step_state0
    ys = []
    for i in range(n_steps):
        outer = begin_step()
        with span("step.update"):
            theta = theta_of_carry((u, extra), i)
        with span("step", index=i, lanes=lanes):
            if stateful:
                u, stats, st = step(u, theta, st)
            else:
                u, stats = step(u, theta)
        with span("step.update"):
            extra = update_carry(extra, u, i)
            if (i + 1) % k == 0:
                ys.append(record(u, stats))
        end_step(outer)
    final = (u, extra, st) if stateful else (u, extra)
    return final, (_stack(ys) if ys else None)


def _sync_device(u: torch.Tensor) -> None:
    if u.device.type == "cuda":
        torch.cuda.synchronize(u.device)


def calibrate_refresh(
    space,
    form,
    newton_cfg: NewtonConfig,
    linear_cfg: LinearConfig,
    bc_of_theta: Callable,
    u0: torch.Tensor,
    theta_of_carry: Callable,
    extra0=None,
    warm_steps: int = 2,
    probe_steps: int = 4,
    reps: int = 2,
):
    """Resolve ``LinearConfig.refresh='auto'`` by measurement.

    Carried-factor chord Newton against exact Newton is a regime-dependent
    trade (block size, mesh, physics, hardware), so it is picked per run by
    timing both step programs from one warm state.

    Protocol (the reference's): advance ``warm_steps`` exact steps from
    ``u0`` in windows of ``probe_steps`` (at least one window), then time
    ``probe_steps``-step windows of each mode from that same warm state,
    one untimed execution and then best of ``reps``.  The carried window
    includes its initial factorization.  Times are wall clock around work
    that ends in ``torch.cuda.synchronize()`` on the card.

    Returns ``(mode, times)``: mode 'carried' or 'iter', times the window
    seconds.  Non-slab kinds are not timed: 'carried' for 'tridiag_cr',
    'iter' otherwise, with empty times (the reference's fixed answers).
    """
    import time as _time

    if linear_cfg.kind != "slab_direct":
        return "carried" if linear_cfg.kind == "tridiag_cr" else "iter", {}

    if extra0 is None:
        extra0 = 0.0
    step_e = make_implicit_step(
        space, form, newton_cfg,
        dataclasses.replace(linear_cfg, refresh="iter"),
        bc_of_theta=bc_of_theta)
    step_c, prep_init = make_carried_step(
        space, form, newton_cfg,
        dataclasses.replace(linear_cfg, refresh="carried"),
        bc_of_theta=bc_of_theta)

    def win_exact(u):
        (u2, _), _ = run_transient(step_e, (u, extra0), probe_steps,
                                   theta_of_carry=theta_of_carry)
        return u2

    def win_carried(u):
        prep0 = prep_init(u, theta_of_carry((u, extra0), 0))
        (u2, _, _), _ = run_transient(step_c, (u, extra0), probe_steps,
                                      theta_of_carry=theta_of_carry,
                                      step_state0=prep0)
        return u2

    u_warm = u0
    for _ in range(max(1, -(-warm_steps // probe_steps))):
        u_warm = win_exact(u_warm)
    _sync_device(u_warm)

    def best_of(fn):
        fn(u_warm)                      # warm-up execution
        ts = []
        for _ in range(reps):
            t0 = _time.perf_counter()
            out = fn(u_warm)
            _sync_device(out)
            ts.append(_time.perf_counter() - t0)
        return min(ts)

    t_c = best_of(win_carried)
    t_e = best_of(win_exact)
    mode = "carried" if t_c <= t_e else "iter"
    return mode, {"carried_window_s": round(t_c, 4),
                  "iter_window_s": round(t_e, 4),
                  "probe_steps": probe_steps}
