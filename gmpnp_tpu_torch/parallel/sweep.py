"""Parameter sweeps: voltage (and cation) lanes of the EDL and pore models.

Port of ``gmpnp_tpu/parallel/sweep.py``.  The reference's production
parallelism is many independent cluster jobs over CLI flags
(README.md:37-39); a sweep runs those jobs as lanes of one call.  The swept
voltage enters each lane only through ``theta`` and a Dirichlet value
(``ArithDirichletBC``), so every lane shares one program.

``chunk`` picks how the lanes run on one device, as in the reference
(``_run_lanes``): ``chunk >= lanes`` runs all lanes as one lane-batched
transient (the reference's ``vmap``), ``1 < chunk < lanes`` runs batches of
``chunk`` lanes one after another (lanes padded to a multiple of ``chunk``
with the last voltage, the pad dropped), and ``chunk`` 0 or 1 runs the
lanes one at a time.  A batched transient carries every state with a
leading lane axis (V, N, f): each Newton iteration is one residual, one
Jacobian and one linear solve for all lanes, lanes that have converged are
frozen, and the loop runs until every lane is done
(``solve.timeloop.make_implicit_step_lanes``), as the reference's vmapped
``while_loop``.  The default ``chunk`` is the reference's ``_auto_chunk``:
every lane batched under 2,000 vertices, one at a time above.

Under ``chunk != 0`` a carried pore factorization is downgraded to
``refresh='step'``, as in the reference; a carried EDL configuration keeps
its lanes one at a time (the reference would raise; ROADMAP queue 3 item
8).  ``devices=`` runs the lanes one per device instead
(``run_lanes_on_devices``).

Spans (``utils.profiling``): ``sweep.build`` around a sweep's program
build and refresh resolution, ``sweep.batch`` (attribute ``lanes``)
around each transient of a batch of lanes, or of one lane.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from gmpnp_tpu_torch.models import edl_1d, pore_3d
from gmpnp_tpu_torch.solve.timeloop import (
    StepStats,
    calibrate_refresh,
    make_carried_step,
    make_implicit_step,
    make_implicit_step_lanes,
    run_transient,
    run_transient_lanes,
    stack_lane_theta,
)
from gmpnp_tpu_torch.utils.profiling import span


def _auto_chunk(lanes: int, num_vertices: int) -> int:
    """Lanes per batched chunk in the reference (0 = one lane at a time):
    all lanes batched under ~2k vertices, one at a time above."""
    return lanes if num_vertices < 2000 else 0


def _stack_lanes(outs, device):
    """[(u_hist (steps, N, f), StepStats of (steps,) arrays)] per lane ->
    (u_hist (V, steps, N, f) on ``device``, StepStats of (V, steps))."""
    u = torch.stack([o[0].to(device) for o in outs])
    stats = StepStats(*(np.stack([np.asarray(o[1][i]) for o in outs])
                        for i in range(len(StepStats._fields))))
    return u, stats


def _run_lanes(single: Callable, batched: Optional[Callable],
               volts: Sequence[float], chunk: int, device):
    """Run the lanes in the reference's three modes: ``batched(voltages) ->
    (u_hist (V, steps, N, f), stats of (V, steps))`` over all lanes when
    ``chunk >= lanes``, over batches of ``chunk`` lanes one after another
    when ``1 < chunk < lanes`` (padded with the last voltage, the pad
    dropped); ``single(voltage) -> (u_hist, stats)`` lane after lane when
    ``chunk`` is 0 or 1 or there is no ``batched``."""
    volts = [float(v) for v in volts]
    lanes = len(volts)
    if chunk <= 1 or batched is None:
        return _stack_lanes([single(v) for v in volts], device)
    if chunk >= lanes:
        return batched(volts)
    padded = volts + volts[-1:] * ((-lanes) % chunk)
    outs = [batched(padded[i:i + chunk])
            for i in range(0, len(padded), chunk)]
    u = torch.cat([o[0] for o in outs])[:lanes]
    stats = StepStats(*(np.concatenate([o[1][i] for o in outs])[:lanes]
                        for i in range(len(StepStats._fields))))
    return u, stats


def _default_devices():
    """Every CUDA device; ValueError when there is none (a CPU run passes
    ``devices=`` itself)."""
    if not torch.cuda.is_available():
        raise ValueError("run_lanes_on_devices: no CUDA devices; pass "
                         "devices= (e.g. ['cpu']) to run the lanes on the "
                         "host")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def run_lanes_on_devices(single_on: Callable, volts: Sequence[float],
                         devices: Optional[Sequence] = None):
    """Lane-per-device sweep: the lanes are split into equal contiguous
    blocks, one per device (the reference's shard_map over a 1-D lane
    mesh), and each device's lanes run there one after another.  The lanes
    are independent, as the reference's jobs are.

    ``single_on(device)`` returns the single-lane closure
    ``single(voltage) -> (u_hist, stats)`` of a program built on that
    device.  Lanes must be a multiple of the device count.  Results are
    stacked on the first device.
    """
    devices = (_default_devices() if devices is None
               else [torch.device(d) for d in devices])
    n_dev = len(devices)
    lanes = len(volts)
    if lanes % n_dev:
        raise ValueError(
            f"{lanes} lanes must be a multiple of {n_dev} devices "
            f"(pad the sweep or pass fewer devices)")
    per = lanes // n_dev
    outs = []
    for d, dev in enumerate(devices):
        single = single_on(dev)
        outs += [single(float(v)) for v in volts[d * per:(d + 1) * per]]
    return _stack_lanes(outs, devices[0])


def _sweep_newton(newton):
    """Sweep variant of the Newton config: backtracking on (4 halvings,
    non-monotone bounded-growth acceptance, bt_growth=10) when the caller
    left ``backtracking=0`` — a sweep spans the voltage range from one cold
    start, where plain damped Newton converges only the shallow lanes.  The
    growth rule accepts exactly the plain damped-Newton step on every
    iteration whose residual grows by < 10x, so steps with no rejection
    keep the plain iterate sequence.  (The reference also forces its
    ``loop='while'``; the port's Newton loops are while loops, single-lane
    and batched.)"""
    if newton.backtracking == 0:
        newton = dataclasses.replace(newton, backtracking=4, bt_growth=10.0)
    return newton


def _resolve_refresh(lin, space, form, newton, bc_of_theta, u0, theta_of,
                     info):
    """``refresh='auto'`` resolved at sweep entry by ``calibrate_refresh``
    on the first lane; the choice goes into ``info``."""
    if lin.refresh != "auto":
        return lin
    mode, times = calibrate_refresh(space, form, newton, lin, bc_of_theta,
                                    u0, theta_of)
    if info is not None:
        info["refresh_calibration"] = dict(times, mode=mode)
    return dataclasses.replace(lin, refresh=mode)


def _theta_with_voltage(theta_of_carry, voltage):
    def theta_of(carry, i):
        th = theta_of_carry(carry, i)
        th["voltage"] = voltage
        return th
    return theta_of


def _lane_runner(prog, step_args, lin, n, carried, extra0, bc_of_theta,
                 update_carry=None):
    """single(voltage) -> (u_hist, stats) for one program: every lane starts
    from the cold state with fresh per-lane state (the carried
    factorization included)."""
    space, form, newton = step_args
    if carried:
        step, prep_init = make_carried_step(space, form, newton, lin,
                                            bc_of_theta=bc_of_theta)
    else:
        step = make_implicit_step(space, form, newton, lin,
                                  bc_of_theta=bc_of_theta)

    @span("sweep.batch", lanes=1)
    def single(voltage):
        theta_of = _theta_with_voltage(prog._theta_of_carry, voltage)
        u0 = prog.initial_state()
        state0 = (prep_init(u0, theta_of((u0, extra0), 0)) if carried
                  else None)
        _, ys = run_transient(step, (u0, extra0), n,
                              theta_of_carry=theta_of,
                              update_carry=update_carry,
                              step_state0=state0)
        return ys

    return single


def _batched_runner(prog, step_args, lin, n, extra0, bc_of_theta,
                    update_carry=None):
    """batched(voltages) -> (u_hist (V, steps, N, f), stats of (V, steps)):
    the lanes as one lane-batched transient from the cold state.  The
    per-step parameters are the model's own, lane by lane
    (``_theta_of_carry`` and ``update_carry`` of each lane's state), joined
    into one lane theta."""
    space, form, newton = step_args
    step = make_implicit_step_lanes(space, form, newton, lin,
                                    bc_of_theta=bc_of_theta)

    def batched(volts):
        V = len(volts)
        dev = prog.device

        def theta_of(carry, i):
            u, extras = carry
            thetas = [prog._theta_of_carry((u[v], extras[v]), i)
                      for v in range(V)]
            for th, volt in zip(thetas, volts):
                th["voltage"] = volt
            return stack_lane_theta(thetas, dev)

        def update(extras, u, i):
            if update_carry is None:
                return extras
            return [update_carry(e, u[v], i) for v, e in enumerate(extras)]

        with span("sweep.batch", lanes=V):
            u0 = prog.initial_state()
            u0 = u0.expand((V,) + tuple(u0.shape)).clone()
            _, ys = run_transient_lanes(step, (u0, [extra0] * V), n,
                                        update_carry=update,
                                        theta_of_carry=theta_of)
        return ys

    return batched


def run_edl_voltage_sweep(
    cfg: "edl_1d.EDL1DConfig",
    voltages: Sequence[float],
    n_steps: Optional[int] = None,
    chunk: Optional[int] = None,
    devices: Optional[Sequence] = None,
    device="cuda",
    info: Optional[dict] = None,
):
    """1D EDL solve over OHP voltage multipliers.

    chunk: lanes per batch (None = ``_auto_chunk``; see ``_run_lanes``); a
    carried configuration runs its lanes one at a time whatever ``chunk``
    is.  devices: run lane-per-device over these devices instead
    (run_lanes_on_devices).  ``info``, when given, receives the chunk, the
    resolved refresh mode (and the ``refresh='auto'`` calibration).
    Returns (u_hist (V, steps, N, 7), stats batched over V).
    """
    devices = None if devices is None else [torch.device(d) for d in devices]
    lane_per_device = devices is not None and len(devices) > 1
    home = devices[0] if devices else torch.device(device)
    P = edl_1d.P
    newton = _sweep_newton(cfg.newton)
    chf0 = 0.001 if cfg.H_OHP is not None else 0.0

    def bc_of(p):
        # per-lane Dirichlet value by arithmetic blend (the reference's
        # sweep BC)
        return lambda theta: p.bc.arith().set_value_arith(
            left, P, theta["voltage"])

    with span("sweep.build"):
        prog = edl_1d.build(cfg, device=home)
        n = prog.tot_num_steps if n_steps is None else n_steps
        left = np.unique(
            prog.mesh.facets[prog.mesh.facet_markers == 1].reshape(-1))
        lin = _resolve_refresh(
            cfg.linear, prog.space, prog.form, newton, bc_of(prog),
            prog.initial_state(),
            _theta_with_voltage(prog._theta_of_carry, float(voltages[0])),
            info)
    carried = lin.kind == "tridiag_cr" and lin.refresh == "carried"
    if chunk is None:
        chunk = _auto_chunk(len(voltages), prog.space.num_vertices)
    if info is not None:
        info["chunk"] = chunk
        info["refresh"] = lin.refresh

    def single_on(dev):
        p = prog if dev == home else edl_1d.build(cfg, device=dev)
        return _lane_runner(p, (p.space, p.form, newton), lin, n, carried,
                            chf0, bc_of(p), update_carry=p._update_carry)

    if lane_per_device:
        return run_lanes_on_devices(single_on, voltages, devices)
    batched = None if carried else _batched_runner(
        prog, (prog.space, prog.form, newton), lin, n, chf0, bc_of(prog),
        update_carry=prog._update_carry)
    return _run_lanes(single_on(home), batched, voltages, chunk, home)


def run_pore_voltage_sweep(
    cfg: "pore_3d.Pore3DConfig",
    voltages: Sequence[float],
    n_steps: Optional[int] = None,
    chunk: Optional[int] = None,
    devices: Optional[Sequence] = None,
    device="cuda",
    info: Optional[dict] = None,
):
    """3D GMPNP pore solve over wall voltage multipliers — the BASELINE
    config-5 sweep (voltage x cation; the cation varies in
    ``run_pore_voltage_cation_sweep``).

    chunk: lanes per batch (None = ``_auto_chunk``; see ``_run_lanes``); a
    carried slab factorization is downgraded to ``refresh='step'`` when
    ``chunk != 0`` and the lanes are not per device, as in the reference.
    devices: run lane-per-device over these devices (lanes must divide
    evenly); lane-per-device lanes keep the carried mode.  ``info``, when
    given, receives the chunk, the resolved refresh mode and the
    ``refresh='auto'`` calibration.
    Returns (u_hist (V, steps, N, 9), stats batched over V).
    """
    assert cfg.physics == "GMPNP"
    devices = None if devices is None else [torch.device(d) for d in devices]
    lane_per_device = devices is not None and len(devices) > 1
    home = devices[0] if devices else torch.device(device)
    ns = len(cfg.species)
    newton = _sweep_newton(cfg.newton)

    def bc_of(p):
        def bc_of_theta(theta):
            bc = p.bc.arith()
            bc = bc.set_value_arith(p.s1_verts, p.idx["CO2"],
                                    theta["co2_s1"])
            return bc.set_value_arith(s2, ns, theta["voltage"])
        return bc_of_theta

    with span("sweep.build"):
        prog = pore_3d.build(cfg, device=home)
        n = prog.num_steps if n_steps is None else n_steps
        s2 = np.unique(prog.mesh.facets[
            prog.mesh.facet_markers == pore_3d.S2].reshape(-1))
        lin = _resolve_refresh(
            cfg.linear, prog.space, prog.form, newton, bc_of(prog),
            prog.initial_state(),
            _theta_with_voltage(prog._theta_of_carry, float(voltages[0])),
            info)
    if chunk is None:
        chunk = _auto_chunk(len(voltages), prog.space.num_vertices)
    carried = lin.kind == "slab_direct" and lin.refresh == "carried"
    if carried and chunk != 0 and not lane_per_device:
        # the reference's batched lanes would execute both branches of the
        # carried mode's refreshes every step; it downgrades them to the
        # once-per-step factorization, and so does the port, for the same
        # numbers
        lin = dataclasses.replace(lin, refresh="step")
        carried = False
    if info is not None:
        info["chunk"] = chunk
        info["refresh"] = lin.refresh

    def single_on(dev):
        p = prog if dev == home else pore_3d.build(cfg, device=dev)
        return _lane_runner(p, (p.space, p.form, newton), lin, n, carried,
                            0.0, bc_of(p))

    if lane_per_device:
        return run_lanes_on_devices(single_on, voltages, devices)
    batched = None if carried else _batched_runner(
        prog, (prog.space, prog.form, newton), lin, n, 0.0, bc_of(prog))
    return _run_lanes(single_on(home), batched, voltages, chunk, home)


def run_pore_voltage_cation_sweep(
    cfg: "pore_3d.Pore3DConfig",
    voltages: Sequence[float],
    cations: Sequence[str] = ("K",),
    n_steps: Optional[int] = None,
    chunk: Optional[int] = None,
    device="cuda",
) -> Dict[str, tuple]:
    """voltage x cation sweep: a voltage sweep per cation, each run in the
    ``chunk`` mode (the cation changes the program's constants, so it stays
    an outer loop, as in the reference)."""
    out = {}
    for cat in cations:
        c = dataclasses.replace(cfg, cation=cat)
        out[cat] = run_pore_voltage_sweep(c, voltages, n_steps=n_steps,
                                          chunk=chunk, device=device)
    return out
