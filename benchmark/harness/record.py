"""What a run records: every step of the window on the host clock, the
program's own counters, and, in a traced run, spans around the layers.

``Recorder.wrap_run`` replaces a transient loop of the program (the
models' ``run_transient``, the sweeps' ``run_transient_lanes``) with one
that times each step: the step ends in a device synchronize and
its wall time, Newton and Krylov counts and convergence are kept, with the
states the correctness check needs (each episode's first and last step).
The program is not edited: the wrappers are set on its modules' names for
the run and taken off again.

``Spans`` wraps the assembly entry points of ``FemSpace`` and the linear
solvers that the time loop calls, each call ended in a synchronize, and
sums their wall time per layer. Only a traced run sets them.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@dataclass
class Episode:
    volts: list
    start: float
    end: float = 0.0
    first_converged_end: Optional[float] = None
    steps: int = 0
    # (u_prev, u_new, dt_scale (V,), reported residual norm (V,), index)
    first: Optional[tuple] = None
    last: Optional[tuple] = None


@dataclass
class Recorder:
    sync: Callable[[], None]
    episodes: List[Episode] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)
    lane_steps: int = 0
    converged_lane_steps: int = 0
    newton_iters: int = 0
    linear_iters: int = 0

    def begin(self, volts):
        self.episodes.append(Episode(volts=list(volts),
                                     start=time.perf_counter()))

    def finish(self):
        self.episodes[-1].end = time.perf_counter()

    def step(self, u_prev, u_new, stats, t0, t1):
        ep = self.episodes[-1]
        conv = np.atleast_1d(np.asarray(stats.converged, bool))
        self.step_s.append(t1 - t0)
        self.lane_steps += conv.size
        self.converged_lane_steps += int(conv.sum())
        self.newton_iters += int(np.sum(stats.newton_iters))
        self.linear_iters += int(np.sum(stats.linear_iters))
        if ep.first_converged_end is None and conv.all():
            ep.first_converged_end = t1
        scale = np.atleast_1d(np.asarray(stats.dt_scale, np.float64))
        rn = np.atleast_1d(np.asarray(stats.residual_norm, np.float64))
        ep.last = (u_prev, u_new, scale, rn, ep.steps)
        if ep.steps == 0:
            ep.first = ep.last
        ep.steps += 1

    @contextlib.contextmanager
    def wrap_run(self, module, name):
        """Time every step of ``module.<name>`` (a transient loop whose
        first argument is the step) while the context is open."""
        orig = getattr(module, name)

        def timed_loop(step, *args, **kw):
            def timed(*a):
                t0 = time.perf_counter()
                out = step(*a)
                self.sync()
                self.step(a[0], out[0], out[1], t0, time.perf_counter())
                return out
            return orig(timed, *args, **kw)

        setattr(module, name, timed_loop)
        try:
            yield
        finally:
            setattr(module, name, orig)


#: layer -> names wrapped in ``gmpnp_tpu_torch.solve.timeloop``: the linear
#: solvers the time loop builds its steps from
LINEAR_NAMES = (
    "slab_prepare", "slab_prepare_lanes", "slab_apply", "slab_apply_f32",
    "slab_apply_lanes", "slab_direct_solve", "block_tridiag_from_ell",
    "block_tridiag_from_ell_lanes", "block_tridiag_factor_cr",
    "block_tridiag_apply_cr", "block_tridiag_solve_cr",
    "block_tridiag_solve_cr_lanes", "block_tridiag_solve_thomas",
    "block_tridiag_solve_thomas_lanes", "tridiag_mp_solve",
    "tridiag_mp_solve_lanes", "gmres", "gmres_lanes", "bicgstab",
    "bicgstab_lanes", "dense_solve", "dense_solve_lanes", "block_inv",
    "block_jacobi_preconditioner", "block_jacobi_preconditioner_lanes",
    "multicolor_ssor_preconditioner", "multicolor_ssor_preconditioner_lanes")
#: ``FemSpace`` methods of the assembly layer
ASSEMBLY_NAMES = ("residual", "jacobian", "residual_lanes", "jacobian_lanes")


class Spans:
    """Host-clock spans, each ended in a synchronize, summed per layer.
    A call inside another call of the same layer is not counted twice."""

    def __init__(self, sync):
        self._sync = sync
        self.seconds = {"assembly": 0.0, "linear": 0.0}
        self.calls = {"assembly": 0, "linear": 0}
        self._depth = {"assembly": 0, "linear": 0}

    def _wrap(self, layer, fn):
        def spanned(*a, **kw):
            if self._depth[layer]:
                return fn(*a, **kw)
            self._sync()
            t0 = time.perf_counter()
            self._depth[layer] += 1
            try:
                return fn(*a, **kw)
            finally:
                self._depth[layer] -= 1
                self._sync()
                self.seconds[layer] += time.perf_counter() - t0
                self.calls[layer] += 1
        return spanned

    @contextlib.contextmanager
    def active(self):
        from gmpnp_tpu_torch.fem.assembly import FemSpace
        from gmpnp_tpu_torch.solve import timeloop

        saved = []
        for name in ASSEMBLY_NAMES:
            saved.append((FemSpace, name, getattr(FemSpace, name)))
        for name in LINEAR_NAMES:
            if hasattr(timeloop, name):
                saved.append((timeloop, name, getattr(timeloop, name)))
        for owner, name, fn in saved:
            layer = "assembly" if owner is FemSpace else "linear"
            setattr(owner, name, self._wrap(layer, fn))
        try:
            yield self
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)


def counters():
    """A copy of the program's counters: host syncs and kernel launches
    per shape."""
    from gmpnp_tpu_torch import ops, sync

    return {"syncs": sync.SYNCS,
            "shapes": {k: dict(v[1]) for k, v in ops.COUNTERS.items()}}


def counter_delta(before, after):
    shapes = {}
    for kernel, table in after["shapes"].items():
        old = before["shapes"].get(kernel, {})
        d = {k: n - old.get(k, 0) for k, n in table.items()
             if n - old.get(k, 0)}
        shapes[kernel] = d
    return {"syncs": after["syncs"] - before["syncs"], "shapes": shapes}
