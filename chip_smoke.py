"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: the CUDA kernels compiled from ``gmpnp_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together, linked into one library);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of every path of phase 4 (the L=50 nm, R=5 nm pore: N=2,501,
   K=15, f=9 for GMPNP and f=7 for reaction-diffusion, each on the kernel
   with a warp per vertex written for its f; the 1D EDL model at L_n=50
   um: N=5,991, K=3, f=7, the f=7 kernel with a thread per row; the
   pore's first AMG coarse level: N=98, K=15, f=9, f32 and f64) and at an
   edge shape (N=1,000, K=7, f=3, the run-time-f kernel), in turns
   (plain, kernel, kernel, plain): median times over 30
   CUDA-event-timed calls (host launch cost included); device time per
   call from a replayed CUDA graph, hot (one matrix, re-read from L2) and
   cold (each launch reads another copy of the matrix, at least 256 MB of
   copies in rotation, so every read comes from device memory); the bound
   computed from the shapes and the share of it the cold time reaches; one
   library call (``torch.sparse_bsr_tensor @ x``) timed the same way as a
   yardstick; the device time of a one-tile launch as the floor; the
   lane axis at the batched pore sweep's shape (3 lanes of N=2,501, K=15,
   f=9, f32 and f64): each lane bitwise equal to a one-lane launch, from a
   contiguous (V, N, f, K*f) tensor and from the lane-aligned layout, the
   copy path each lane takes, the twin, times, the bound and the library
   call (the lanes as one block-diagonal ``torch.sparse_bsr_tensor``); and
   ragged, single-neighbour and misaligned shapes (f=5 and f=7 at K=3 and
   K=15 among them) for correctness and bitwise repeatability only.
   Then the sorted-segment sum and the batched block inverse at every
   path shape (the pores' and the EDL's residual and Jacobian rows, three
   lanes of the pore Jacobian; the slab equilibration's (2,501, 9 or 7)
   blocks, the 1D cyclic reduction's first level (4,096, 7 or 5; f32 for
   ``tridiag_mp_solve``; 3 x 4,096 over lanes)): ``block_inv`` bitwise
   equal to its plain version (f32 and f64, f=5, 7, 9, blocks that take
   every branch, a NaN), the segment sum bitwise equal to the sequential
   sum in sorted order and to a second launch and within the cumsum's
   own rounding of it (2 M eps max|prefix|, the largest gap printed), its
   lane axis bitwise per lane; and their times as above, with
   ``torch.zeros(...).index_add_`` and ``torch.linalg.inv_ex`` as the
   library yardsticks and a one-value launch as the floor; then, bitwise
   and repeatable only, the segment sum on rows of 0, 1, 31, 32, 33 and
   100 entries at d = 1, 5, 7, 9, 16, 17, 49, 81 and 129 (three lanes,
   and on a side stream) and ``block_inv`` at every f from 1 to 16 at
   batches of 1, 31, 37 and 130 (with a NaN).  Then the pore's element
   residuals (GMPNP f=9, reaction-diffusion f=7, three GMPNP lanes under
   vmap): within 1e-12 per field of the plain version, bitwise repeatable,
   one launch a call, each lane bitwise its one-lane launch; times as
   above, with the torch.func element loop the kernel replaced as the
   yardstick and a one-element launch as the floor.  Then the pores'
   Sechenov value (GMPNP (2,501, 9), reaction-diffusion (2,501, 7)): its
   four medians and the value bitwise the plain version's (four
   ``torch.sort``s and the scalar operations), bitwise repeatable, one
   launch a call; times as above beside the plain version's, no library
   call, a one-row launch as the floor.  Then the 1D cyclic-reduction
   apply (the EDL's (5,991, 7) in f64 and f32, three f64 lanes of it, the
   1D reaction-diffusion's (5,991, 5)): within 1e-13 (f64) / 1e-5 (f32)
   of its plain version, bitwise repeatable, one launch a call, each lane
   bitwise its one-lane launch; times as above beside the plain
   version's, a one-row apply as the floor; and one carried episode of
   the benchmark cell ``edl_mpnp.carried20`` per OHP voltage through the
   kernel and through the plain version: the same Newton counts, the
   largest state difference printed;
4. the paths, each with every launch count (all five kernels) set to 0
   before it and read after it; per-step wall time, Newton and linear
   iterations, host syncs and kernel launches; outputs present and finite;
   every model path launched the segment-sum and ``block_inv`` kernels:
   - ``python -m gmpnp_tpu_torch.cli.pore_3d`` at L=50 nm, R=5 nm: 5 steps
     in carried mode (f32 chord GMRES over the f32 kernel) and 2 in exact
     mode (f64 GMRES over the f64 kernel);
   - ``python -m gmpnp_tpu_torch.cli.rxn_diff_3d`` at the same size and
     the same 5 + 2 steps (the f=7 kernel);
   - ``python -m gmpnp_tpu_torch.cli.edl_1d --dry_run Y`` at the default
     L_n=50 um: 20 carried and 5 exact steps (the all-f64 CR, no kernel);
   - ``models.rxn_diff_1d.run(cfg, n_steps=20)`` at L_n=50 um;
   - ``solve.linear.tridiag_mp_solve`` on the EDL cold-start Jacobian at
     N=5,991 (f64 GMRES over the f64 kernel), held to the all-f64 CR
     solve, with both solves' times;
   - checkpoint/resume through the CLIs: the pore at L50R5, exact then
     carried, 2 steps checkpointed every step and then 4 from the same
     directory (only steps 2-3 run), against an uninterrupted 4-step run
     (exact: within 1e-12; carried: every step converged, the distances
     printed — a resume rebuilds the factorization, so it stops at another
     point inside the Newton tolerance); the EDL CLI (H_OHP 1.1, exact),
     5 + 5 steps against 10, within 1e-12 with the same proton current;
   - sweeps: ``run_pore_voltage_sweep`` at L50R5 (carried, -0.5/-1.0/-1.5
     V, 2 steps) and ``run_edl_voltage_sweep`` at L_n=50 um (-0.5/-1.0/-2.0,
     3 steps, no kernel), each lane against its single-lane sweep (1e-12)
     and the model's own run at that voltage (1e-5), and a K/Cs x 2-lane x
     2-step ``run_pore_voltage_cation_sweep``, with per-lane lines;
   - batched sweep lanes (the reference's chunk vmap modes), after one
     untimed batched step: the pore at L50R5 with ``chunk=3`` (-0.5 /
     -1.0 / -1.5 V, the carried config downgraded to ``refresh='step'``,
     3 steps, f64 GMRES over the kernel's lane axis), the EDL at L_n=50 um
     with ``chunk=3`` (5 steps) and the pore at the (3, 40) mesh
     (N=1,517) with the default chunk, each against its lanes run with
     ``chunk=0``: a line per batched step (ms, each lane's Newton and
     Krylov iterations, host syncs, launches), a line per lane (distance,
     iterations, converged flags, the chunk=0 run's ms per step), and per
     sweep ms per step and per lane-step beside chunk=0's, host syncs per
     step and peak device memory;
   - the Krylov fallbacks on the L50R5 cold-start Jacobian (BiCGStab +
     block-Jacobi f64, GMRES + block-Jacobi f32, GMRES + SSOR f64, GMRES +
     AMG f64 and f32): iterations, the true residual recomputed in f64
     (converged => at most 1.5 tol), ms, host syncs, launches by shape; the
     same solves of one (2, 10) pore system, assembled on the CPU, on the
     card and on the CPU (same converged flags; iterations within 10%,
     but for f64 GMRES + AMG, whose count rounding alone moves: the card's
     inside the CPU's counts on the system and on eight copies perturbed
     at 1e-15, with the true residual within 1.5 tol on both devices);
   - one exact Newton step with BiCGStab (tol 1e-10, 20,000 iterations)
     against slab_direct: at L50R5 when a cold-start BiCGStab solve there
     converges (printed), and held at tests/test_slab.py's (L=100 nm,
     R=10 nm, (2, 8)) to its bar; 2 exact steps each with
     ``slab_mode='cr'`` (against Thomas: the same Newton iterations, 1e-6,
     both factorizations timed) and ``jac_dtype='f32'``; the pore CLI with
     ``--linear_refresh auto`` (3 steps, the calibration printed);
   - z-slab domain decomposition (``parallel.shard``): the pore CLI with
     ``--shard 1`` (3 carried steps at L=50 nm, R=5 nm), then four ranks
     sharing the card: ``make_sharded_pore_transient`` carried, 3 steps
     at Newton tol 1e-9 and Krylov tol 1e-10, against the single-device
     carried run at the same tolerances (1e-6); one exact step with the
     replicated seam twice (bitwise equal) and with ``seam='ring'``
     (1e-7); BiCGStab + block-Jacobi against slab_direct and a forced
     ``max_retries`` step (dt_scale 0.5) at the (3, 40) mesh (N=1,517);
     ``_run_sharded`` with a checkpoint directory, 2 steps then resumed
     to 4, equal to an uninterrupted 4-step run.  The plan's per-rank
     sizes and the bytes reckoned per rank are printed first; each
     sharded step line adds Krylov iterations, ranks, devices, peak
     device memory and the carried state's bytes per rank, each path
     line host syncs per Krylov iteration;
5. checks: 3-step carried runs on the (2, 10) mesh on the card and on the
   CPU for both pore physics (same Newton iterations; states within 1e-6,
   for reaction-diffusion at tight Newton tolerances), 3-step exact runs on
   the card against the goldens ``tests/goldens/pore_3d_gmpnp_3steps.json``
   and ``pore_3d_rxn_diff_3steps.json`` at their tolerance 5e-4, and
   5-step runs of the 1D models at L_n=1 um against
   ``rxn_diff_1d_5steps.json`` and ``edl_1d_mpnp_5steps.json`` at 1e-7 with
   the same Newton counts.

The last three lines are the kernels record (one entry per kernel and
shape), the card's name and power limit, and ``{"ok": true, "device":
{...}}``.  Without a CUDA device the
script exits non-zero before printing any result.

    python3 chip_smoke.py --profile

runs phases 1-2 and then, in place of 3-5, the profile of the L=50 nm,
R=5 nm pore: the time of each layer's call at the cold start; the
residual, the Jacobian and the 1D CR solve and factor through the kernels
and through their plain versions (ms and device operations per call);
and a ``torch.profiler`` window over carried and exact steps with the
device's busy share and its largest kernels.

    python3 chip_smoke.py --kernel-times [--package-root DIR]

runs phases 1-2 and the timings of phase 3 at the paths' shapes (every
record of the kernels line that DIR's package has), without the library
calls, with ``gmpnp_tpu_torch`` taken from DIR (default: beside this
script).  To compare two commits on one card, unpack the other one with
``git archive`` into an ignored directory and run on the card, one after
the other: other, this, this, other.

    python3 chip_smoke.py --krylov-spread

runs phases 1-2 and then phase 4d's (2, 10) f64 GMRES + AMG solve on the
card and on the CPU, for the system assembled on each device and for eight
copies of the CPU's with its Jacobian perturbed at 1e-15: the iteration
counts that rounding alone gives.
"""

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "out", "chip_smoke")
SLICE = ["--L", "50e-9", "--R", "5e-9"]
PORE_KW = {"L": 50e-9, "R": 5e-9}   # the same pore as Pore3DConfig fields
EDL_L_N = 50e-6                 # the 1D models' default system size
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
LANES = 3                       # lanes of the batched sweeps (chunk=3)
BATCHED_SMALL_MESH = (3, 40)    # N=1,517: under 2,000, _auto_chunk batches
# NVIDIA H100 SXM data sheet: device memory rate; f32 and f64 rates outside
# the tensor cores (the kernel uses none)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
COLD_ROTATION_BYTES = 256 << 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps=30, warmup=5) -> float:
    """Median of ``reps`` CUDA-event timings of fn(), after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_us(fns, n=100, reps=10) -> float:
    """Device time per call in microseconds: the calls of ``fns``, taken in
    rotation at least ``n`` times and each at least once, captured in one
    CUDA graph and replayed ``reps`` times (median), so host launch
    overhead drops out.  One callable gives the hot time (its operands stay
    in L2); callables over enough distinct copies of an operand give the
    cold one."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    n = max(n, len(fns))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / n)
    return float(np.median(times))


def spmv_bound(N, K, f, dtype, lanes=1):
    """The least time the card could take for one product: every input read
    once and the output written once over the memory rate, or the
    operations over the peak rate of their type, whichever is larger.
    Over ``lanes`` lanes every lane's matrix, x and y count and the shared
    adjacency once."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = lanes * (N * f * K * f * size + 2 * N * f * size) + N * K * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * lanes * N * f * K * f / PEAK_FLOPS[dtype]
    return {"bytes": nbytes, "bound_us": max(t_bytes, t_ops) * 1e6,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bsr_structure(adj):
    """Block-CSR structure of a block-ELL adjacency: slots of one row that
    name the same column (the padded ones alias the row's own vertex) are
    merged.  Returns crow, col and, per ELL slot, its block's index."""
    a = adj.cpu().numpy().astype(np.int64)
    N = a.shape[0]
    key = (np.arange(N)[:, None] * N + a).reshape(-1)
    uniq, inv = np.unique(key, return_inverse=True)
    crow = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(np.bincount(uniq // N, minlength=N), out=crow[1:])
    dev = adj.device
    return (torch.as_tensor(crow, device=dev),
            torch.as_tensor(uniq % N, device=dev),
            torch.as_tensor(inv.reshape(-1), device=dev))


def library_times(flats, adj, x, ref):
    """The yardstick: the same matrix as one ``torch.sparse_bsr_tensor``,
    times x as a column, checked against the plain version.  Called by
    nothing in the package.  Returns the times, or the reason there is no
    single PyTorch call."""
    N, f, Kf = flats[0].shape
    K = Kf // f
    try:
        crow, col, slot = bsr_structure(adj)
        mats = []
        for flat in flats:
            blocks = flat.reshape(N, f, K, f).permute(0, 2, 1, 3)
            vals = torch.zeros((col.shape[0], f, f), dtype=flat.dtype,
                               device=flat.device)
            vals.index_add_(0, slot, blocks.reshape(N * K, f, f))
            with warnings.catch_warnings():  # "BSR support is in beta"
                warnings.simplefilter("ignore")
                mats.append(torch.sparse_bsr_tensor(
                    crow, col, vals, size=(N * f, N * f),
                    check_invariants=False))
        xc = x.reshape(-1, 1)
        got = (mats[0] @ xc).reshape(N, f)
        torch.cuda.synchronize()
        rel = float((got - ref).norm() / ref.norm())
        if not rel <= KERNEL_TOL[x.dtype]:
            raise AssertionError(
                f"BSR result misses the plain version: rel_l2 {rel}")
        return {"library_ms": time_ms(lambda: mats[0] @ xc),
                "library_us": graph_us([lambda: mats[0] @ xc]),
                "library_us_cold": graph_us(
                    [(lambda m=m: m @ xc) for m in mats]),
                "library_rel_l2": rel}
    except Exception as e:  # the yardstick may be refused; the run goes on
        return {"library_ms": None, "library_us": None,
                "library_us_cold": None,
                "library_note": f"no single PyTorch call: "
                                f"{type(e).__name__}: {e}"[:300]}


def kernel_times(label, flat, adj, x, library=True):
    """Times of ell_spmv and its plain version at one shape and type, in
    turns (plain, kernel, kernel, plain), with the bound; prints one line
    and returns the record.  A lane-batched ``flat`` (V, N, f, K*f) is
    timed as one launch over its lanes, its copies laid out as it is
    (``lane_aligned``), and its library call is the V lanes as one
    block-diagonal matrix."""
    from gmpnp_tpu_torch.ops.ell_spmv import (
        ell_spmv, ell_spmv_reference, lane_aligned)

    lanes = flat.shape[0] if flat.dim() == 4 else 1
    N, f, Kf = flat.shape[-3:]
    K = Kf // f
    bound = spmv_bound(N, K, f, flat.dtype, lanes)
    copies = -(-COLD_ROTATION_BYTES // (flat.numel() * flat.element_size()))
    copy = ((lambda m: lane_aligned(m.contiguous())) if lanes > 1
            else (lambda m: m.clone()))
    flats = [flat] + [copy(flat) for _ in range(copies - 1)]
    turns = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = ell_spmv if name == "kernel" else ell_spmv_reference
        turns[name].append((
            time_ms(lambda: fn(flat, adj, x)),
            graph_us([lambda: fn(flat, adj, x)]),
            graph_us([(lambda m=m: fn(m, adj, x)) for m in flats])))
    (ms, hot, cold), (plain_ms, plain_hot, plain_cold) = (
        tuple(float(np.mean(v)) for v in zip(*turns[name]))
        for name in ("kernel", "plain"))
    rec = {"ms": ms, "plain_ms": plain_ms, "device_us": hot,
           "device_us_cold": cold, "plain_device_us": plain_hot,
           "plain_device_us_cold": plain_cold,
           "bound_us": bound["bound_us"], "bound_ms": bound["bound_us"] / 1e3,
           "bound_by": bound["bound_by"],
           "share_of_bound_cold": bound["bound_us"] / cold}
    if library and lanes > 1:
        # the lanes as one block-diagonal matrix: lane v's columns shifted
        # by v*N
        shift = torch.arange(lanes, device=adj.device,
                             dtype=adj.dtype)[:, None, None] * N
        adj_bd = (adj[None] + shift).reshape(lanes * N, K).contiguous()
        rec.update(library_times(
            [m.reshape(lanes * N, f, Kf) for m in flats], adj_bd,
            x.reshape(lanes * N, f),
            ell_spmv_reference(flat, adj, x).reshape(lanes * N, f)))
    elif library:
        rec.update(library_times(flats, adj, x,
                                 ell_spmv_reference(flat, adj, x)))
    lane_txt = f"V={lanes} " if lanes > 1 else ""
    print(f"kernel ell_spmv {label} {lane_txt}N={N} K={K} f={f} {flat.dtype}: "
          f"bytes={bound['bytes']} cold_copies={copies} turns="
          f"{json.dumps(turns)} " + json.dumps(rec), flush=True)
    if rec["share_of_bound_cold"] > 1.0:
        raise AssertionError(
            f"ell_spmv {label} {flat.dtype}: cold time {cold} us is under "
            f"the bound {bound['bound_us']} us: the rotation did not keep "
            f"the matrix out of L2")
    return rec


def slice_adj(dev):
    """The adjacency of the L=50 nm, R=5 nm pore (both physics)."""
    from gmpnp_tpu_torch.fem.assembly import FemSpace
    from gmpnp_tpu_torch.mesh import cylinder_mesh, pore_boundary_markers

    mesh = pore_boundary_markers(cylinder_mesh(50e-9, 5e-9), 50e-9, 5e-9)
    return FemSpace.build(mesh, 9, quad_degree=2, device=dev).dev["adj"]


def amg_coarse_adj(dev):
    """The adjacency of the first AMG coarse level of the L=50 nm, R=5 nm
    pore (the AMG plan of the Krylov paths)."""
    from gmpnp_tpu_torch.solve.amg import AMGPlan

    plan = AMGPlan.build(slice_adj("cpu").numpy(), 9)
    return torch.as_tensor(plan.levels[0].coarse_adj, device=dev)


def edl_adj(dev):
    """The adjacency of the 1D models' mesh at L_n=50 um."""
    from gmpnp_tpu_torch.fem.assembly import FemSpace
    from gmpnp_tpu_torch.models import base

    mesh = base.interval_mesh_marked("variable", EDL_L_N)
    return FemSpace.build(mesh, 7, quad_degree=3, device=dev).dev["adj"]


#: (record name, phase-3 label, dtype, phase-4 path whose launches at the
#: record's shape it counts) of every record in the kernels line
KERNEL_RECORDS = [
    ("ell_spmv_f32", "slice", torch.float32, "pore_3d carried"),
    ("ell_spmv_f64", "slice", torch.float64, "pore_3d iter"),
    ("ell_spmv_f32_rxn_diff_3d", "rxn_diff_3d", torch.float32,
     "rxn_diff_3d carried"),
    ("ell_spmv_f64_rxn_diff_3d", "rxn_diff_3d", torch.float64,
     "rxn_diff_3d iter"),
    ("ell_spmv_f64_edl_1d", "edl_1d", torch.float64, "tridiag_mp_solve"),
    ("ell_spmv_f32_amg_coarse", "amg_coarse", torch.float32,
     "krylov gmres amg f32"),
    ("ell_spmv_f64_amg_coarse", "amg_coarse", torch.float64,
     "krylov gmres amg f64"),
]


#: the lane axis: (record name, phase-3 label, dtype, phase-4 path)
LANE_RECORDS = [
    ("ell_spmv_f64_lanes", "slice_lanes", torch.float64,
     "sweep pore_3d batched"),
    ("ell_spmv_f32_lanes", "krylov_mesh_lanes", torch.float32,
     "sweep pore_3d gmres block_jacobi f32 batched"),
    ("ell_spmv_f64_lanes_edl_1d", "edl_1d_lanes", torch.float64,
     "sweep edl_1d tridiag_mp_solve f32 batched"),
    ("ell_spmv_f64_lanes_amg_coarse", "amg_coarse_lanes", torch.float64,
     "sweep pore_3d gmres amg f64 batched"),
]
#: the mesh of the batched f32 GMRES + block-Jacobi sweep (BATCHED_KINDS):
#: phase 4d's (2, 10), N=209, where its single-lane solves converge in
#: every Newton iteration (at L50R5 they stop at maxiter in the cold
#: step's last Newton iterations)
KRYLOV_F32_MESH = (2, 10)


def krylov_mesh_adj(dev):
    """The adjacency of the L=50 nm, R=5 nm pore on KRYLOV_F32_MESH."""
    from gmpnp_tpu_torch.fem.assembly import FemSpace
    from gmpnp_tpu_torch.mesh import cylinder_mesh, pore_boundary_markers

    n_rings, n_layers = KRYLOV_F32_MESH
    mesh = pore_boundary_markers(
        cylinder_mesh(50e-9, 5e-9, n_rings=n_rings, n_layers=n_layers),
        50e-9, 5e-9)
    return FemSpace.build(mesh, 9, quad_degree=2, device=dev).dev["adj"]


def lane_shapes(dev):
    """(phase-3 label, adjacency, f, dtypes) of the lane axis's shapes."""
    labels = {"slice_lanes": (slice_adj, 9),
              "krylov_mesh_lanes": (krylov_mesh_adj, 9),
              "edl_1d_lanes": (edl_adj, 7),
              "amg_coarse_lanes": (amg_coarse_adj, 9)}
    out = []
    for label, (adj_of, f) in labels.items():
        dtypes = [dt for _, lb, dt, _ in LANE_RECORDS if lb == label]
        out.append((label, adj_of(dev), f, dtypes))
    return out


def path_shapes(dev):
    """(phase-3 label, adjacency, f, dtype) of every KERNEL_RECORDS entry."""
    adjs = {"slice": slice_adj(dev), "edl_1d": edl_adj(dev),
            "amg_coarse": amg_coarse_adj(dev)}
    adjs["rxn_diff_3d"] = adjs["slice"]
    widths = {"slice": 9, "rxn_diff_3d": 7, "edl_1d": 7, "amg_coarse": 9}
    return [(label, adjs[label], widths[label], dtype)
            for _, label, dtype, _ in KERNEL_RECORDS]


def random_operands(rng, adj, f, dtype, offset=0):
    """flat and x for an adjacency, from the seeded generator; ``offset``
    shifts flat's pointer by that many elements (a contiguous view that is
    not 16-byte aligned)."""
    N, K = adj.shape
    buf = torch.as_tensor(rng.normal(size=(N * f * K * f + offset,)),
                          dtype=dtype, device=adj.device)
    flat = buf[offset:].view(N, f, K * f)
    x = torch.as_tensor(rng.normal(size=(N, f)), dtype=dtype,
                        device=adj.device)
    return flat, x


def check_kernels(dev):
    """Phase 3: ell_spmv vs its plain version; returns the records at the
    paths' shapes, keyed by (label, dtype)."""
    from gmpnp_tpu_torch.ops.ell_spmv import ell_spmv, ell_spmv_reference

    def compare(label, flat, adj, x):
        y = ell_spmv(flat, adj, x)
        again = ell_spmv(flat, adj, x)
        ref = ell_spmv_reference(flat, adj, x)
        torch.cuda.synchronize()
        rel = float((y - ref).norm() / ref.norm().clamp_min(1e-300))
        err = float((y - ref).abs().max())
        if not rel <= KERNEL_TOL[flat.dtype]:
            raise AssertionError(
                f"ell_spmv {label} {tuple(flat.shape)} {flat.dtype}: "
                f"rel_l2 {rel} > {KERNEL_TOL[flat.dtype]}")
        if not torch.equal(y, again):
            raise AssertionError(
                f"ell_spmv {label} {tuple(flat.shape)} {flat.dtype}: two "
                f"launches on the same operands differ")
        return rel, err

    rng = np.random.default_rng(2024)

    def random_adj(N, K):
        return torch.as_tensor(
            rng.integers(0, N, size=(N, K)).astype(np.int32), device=dev)

    # what a launch costs whatever it moves: one tile, 16 bytes of matrix
    floor = {}
    for dtype in (torch.float32, torch.float64):
        adj = random_adj(4, 1)
        flat, x = random_operands(rng, adj, 1, dtype)
        floor[dtype] = graph_us([lambda: ell_spmv(flat, adj, x)])
        print(f"kernel ell_spmv launch floor N=4 K=1 f=1 {dtype}: "
              f"device_us={floor[dtype]!r}", flush=True)

    from gmpnp_tpu_torch.ops.ell_spmv import MODE_NAMES, launch_plan

    records = {}
    for label, adj, f, dtype in path_shapes(dev) + [
            ("edge", random_adj(1000, 7), 3, dt)
            for dt in (torch.float32, torch.float64)]:
        flat, x = random_operands(rng, adj, f, dtype)
        rel, err = compare(label, flat, adj, x)
        rec = kernel_times(label, flat, adj, x)
        plan = launch_plan(f, adj.shape[1], flat.element_size())
        print(f"  rel_l2={rel!r} max_abs_err={err!r} plan={plan}",
              flush=True)
        if label != "edge":
            records[label, dtype] = {
                "shape": [adj.shape[0], adj.shape[1], f],
                "plan": {"mode": MODE_NAMES[plan.mode],
                         "lanes_per_vertex": plan.lanes,
                         "tile": plan.tile},
                "max_abs_err": err, **rec, "floor_us": floor[dtype]}

    # the lane axis at the batched sweeps' shapes (3 lanes each): each lane
    # bitwise equal to a one-lane launch, from a contiguous tensor and from
    # the lane-aligned layout the paths use, the copy path of each lane, the
    # twin, times and the bound
    from gmpnp_tpu_torch.ops.ell_spmv import lane_aligned, lane_copy_paths

    for label, adj, f, dtypes in lane_shapes(dev):
        N, K = adj.shape
        for dtype in dtypes:
            flat = torch.as_tensor(
                rng.normal(size=(LANES, N, f, K * f)), dtype=dtype,
                device=dev)
            x = torch.as_tensor(rng.normal(size=(LANES, N, f)),
                                dtype=dtype, device=dev)
            single = torch.stack([ell_spmv(flat[v], adj, x[v])
                                  for v in range(LANES)])
            ref = ell_spmv_reference(flat, adj, x)
            aligned = lane_aligned(flat)
            for name, operand in (("contiguous", flat),
                                  ("lane_aligned", aligned)):
                y = ell_spmv(operand, adj, x)
                torch.cuda.synchronize()
                rels = [float((y[v] - ref[v]).norm() / ref[v].norm())
                        for v in range(LANES)]
                line = (f"kernel ell_spmv lanes {name} V={LANES} N={N} "
                        f"K={K} f={f} {dtype}: copy paths "
                        f"{lane_copy_paths(operand)}, every lane bitwise "
                        f"equal to its one-lane launch: "
                        f"{torch.equal(y, single)}, rel_l2 per lane {rels}")
                print(line, flush=True)
                if not (torch.equal(y, single)
                        and max(rels) <= KERNEL_TOL[dtype]):
                    raise AssertionError(line)
            if lane_copy_paths(aligned) != ["bulk"] * LANES:
                raise AssertionError(
                    f"lane_aligned lanes {lane_copy_paths(aligned)}")
            rec = kernel_times(label, aligned, adj, x)
            err = float((ell_spmv(aligned, adj, x) - ref).abs().max())
            plan = launch_plan(f, K, flat.element_size())
            records[label, dtype] = {
                "shape": [LANES, N, K, f],
                "plan": {"mode": MODE_NAMES[plan.mode],
                         "lanes_per_vertex": plan.lanes, "tile": plan.tile,
                         "lane_copy_paths": lane_copy_paths(aligned)},
                "max_abs_err": err, **rec, "floor_us": floor[dtype]}

    # correctness and repeatability only: ragged last tiles, one neighbour,
    # widths on every kernel (f=5 and f=7 at the 1D meshes' K=3 and the
    # pores' K=15), and a matrix that is not 16-byte aligned
    shapes = [(N, 1, f) for N in (1, 3, 4, 5) for f in (1, 8, 9)]
    shapes += [(N, K, f) for N in (1, 3, 5, 53) for K in (3, 15)
               for f in (5, 7)]
    shapes += [(53, 15, 8), (130, 31, 9), (2501, 15, 9), (1000, 7, 3),
               (2501, 15, 7), (2501, 15, 5), (5991, 3, 7), (5991, 3, 5)]
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for N, K, f in shapes:
        adj = random_adj(N, K)
        for dtype in worst:
            for offset in (0, 1):
                flat, x = random_operands(rng, adj, f, dtype, offset)
                rel, _ = compare(f"offset={offset}", flat, adj, x)
                worst[dtype] = max(worst[dtype], rel)
    print(f"kernel ell_spmv {len(shapes)} more shapes x 2 types x "
          f"(aligned, misaligned view): worst rel_l2 "
          f"{ {str(k): v for k, v in worst.items()} }, every pair of "
          f"launches bitwise equal", flush=True)
    return records


def kernel_times_only(dev):
    """--kernel-times: the paths' shapes, no library call."""
    rng = np.random.default_rng(2024)
    for label, adj, f, dtype in path_shapes(dev):
        flat, x = random_operands(rng, adj, f, dtype)
        kernel_times(label, flat, adj, x, library=False)


#: the sorted-segment sum at the paths' shapes: (record name, mesh, table,
#: d, lanes, phase-4 path whose launches at the record's shape it counts);
#: all f64 (the paths reduce in the state's dtype)
SEGMENT_RECORDS = [
    ("segment_sum_f64_pore_jacobian", "pore", "jac", 81, 1,
     "pore_3d carried"),
    ("segment_sum_f64_pore_residual", "pore", "res", 9, 1, "pore_3d carried"),
    ("segment_sum_f64_rxn_diff_3d_jacobian", "pore", "jac", 49, 1,
     "rxn_diff_3d carried"),
    ("segment_sum_f64_rxn_diff_3d_residual", "pore", "res", 7, 1,
     "rxn_diff_3d carried"),
    ("segment_sum_f64_edl_jacobian", "edl", "jac", 49, 1, "edl_1d iter"),
    ("segment_sum_f64_edl_residual", "edl", "res", 7, 1, "edl_1d iter"),
    ("segment_sum_f64_pore_jacobian_lanes", "pore", "jac", 81, LANES,
     "sweep pore_3d batched"),
]
#: the batched block inverse at the paths' shapes: (record name, batch
#: rule, f, dtype, phase-4 path): the slab equilibration (one block per
#: vertex of the pore), the first level of the 1D cyclic reduction (half
#: the next power of two of the EDL mesh's vertices), over lanes the
#: batched EDL sweeps' first level (f64 CR, f32 ``tridiag_mp_solve``)
BLOCK_INV_RECORDS = [
    ("block_inv_f64_slab_gmpnp", "pore", 9, torch.float64, "pore_3d carried"),
    ("block_inv_f64_slab_rxn_diff_3d", "pore", 7, torch.float64,
     "rxn_diff_3d carried"),
    ("block_inv_f64_cr_edl", "cr", 7, torch.float64, "edl_1d iter"),
    ("block_inv_f32_cr_tridiag_mp", "cr", 7, torch.float32,
     "tridiag_mp_solve"),
    ("block_inv_f64_cr_rxn_diff_1d", "cr", 5, torch.float64, "rxn_diff_1d"),
    ("block_inv_f64_cr_edl_lanes", "cr_lanes", 7, torch.float64,
     "sweep edl_1d batched"),
    ("block_inv_f32_cr_tridiag_mp_lanes", "cr_lanes", 7, torch.float32,
     "sweep edl_1d tridiag_mp_solve f32 batched"),
]
#: the pore's element residuals at the paths' shapes (the L=50 nm, R=5 nm
#: pore, f64): (record name, physics, lanes, phase-4 path)
PORE_RESIDUAL_RECORDS = [
    ("pore_residual_f64_gmpnp", "GMPNP", 1, "pore_3d carried"),
    ("pore_residual_f64_rxn_diff_3d", "rxn_diff", 1, "rxn_diff_3d carried"),
    ("pore_residual_f64_gmpnp_lanes", "GMPNP", LANES,
     "sweep pore_3d batched"),
]
#: the Sechenov value at the pores' shapes (the L=50 nm, R=5 nm pore, f64):
#: (record name, physics, phase-4 path)
SECHENOV_RECORDS = [
    ("sechenov_f64_gmpnp", "GMPNP", "pore_3d carried"),
    ("sechenov_f64_rxn_diff_3d", "rxn_diff", "rxn_diff_3d carried"),
]
#: the 1D cyclic-reduction apply at the paths' shapes (L_n = 50 um):
#: (record name, N, f, lanes or None, dtype, phase-4 path or None: no path
#: of phase 4 applies that shape)
CR_APPLY_RECORDS = [
    ("cr_apply_f64_edl", 5991, 7, None, torch.float64, "edl_1d carried"),
    ("cr_apply_f64_edl_lanes", 5991, 7, LANES, torch.float64, None),
    ("cr_apply_f32_edl", 5991, 7, None, torch.float32, "tridiag_mp_solve"),
    ("cr_apply_f64_rxn_diff_1d", 5991, 5, None, torch.float64, None),
]
#: the CR apply against its plain version (another order of summation)
CR_APPLY_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
HOT_SOURCES = {
    "segment_sum": ("gmpnp_tpu_torch/csrc/segment_sum.cu",
                    "gmpnp_tpu/fem/assembly.py:167"),
    "block_inv": ("gmpnp_tpu_torch/csrc/block_inv.cu",
                  "gmpnp_tpu/solve/smallblock.py:46"),
    "pore_residual": ("gmpnp_tpu_torch/csrc/pore_residual.cu",
                      "gmpnp_tpu/fem/assembly.py:332"),
    "sechenov": ("gmpnp_tpu_torch/csrc/sechenov.cu",
                 "gmpnp_tpu/models/pore_3d.py:203"),
    "cr_apply": ("gmpnp_tpu_torch/csrc/cr_apply.cu",
                 "gmpnp_tpu/solve/linear.py:234"),
}


def path_spaces(dev):
    """The FEM spaces (tables only) of the L=50 nm, R=5 nm pore and of the
    1D models' mesh at L_n = 50 um."""
    from gmpnp_tpu_torch.fem.assembly import FemSpace
    from gmpnp_tpu_torch.mesh import cylinder_mesh, pore_boundary_markers
    from gmpnp_tpu_torch.models import base

    pore = pore_boundary_markers(cylinder_mesh(50e-9, 5e-9), 50e-9, 5e-9)
    edl = base.interval_mesh_marked("variable", EDL_L_N)
    return {"pore": FemSpace.build(pore, 9, quad_degree=2, device=dev),
            "edl": FemSpace.build(edl, 7, quad_degree=3, device=dev)}


def segment_bound(M, n_dest, d, dtype, lanes=1):
    """Every value, table entry and output once over the memory rate, or
    the M*d additions over the peak rate of their type."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = lanes * (M + n_dest) * d * size + (M + 2 * n_dest) * 8
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = lanes * M * d / PEAK_FLOPS[dtype]
    return {"bytes": nbytes, "bound_us": max(t_bytes, t_ops) * 1e6,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def block_inv_bound(batch, f, dtype):
    """Every block read once and its inverse written once, or the
    2 f^2 (2f - 1) multiplies, subtractions and divisions per block."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * batch * f * f * size
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = batch * 2 * f * f * (2 * f - 1) / PEAK_FLOPS[dtype]
    return {"bytes": nbytes, "bound_us": max(t_bytes, t_ops) * 1e6,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def pore_residual_bound(C, N, f, Q, lanes=1):
    """The cells, gradients and volumes read once, u and u_prev read and
    the element residuals written once per lane; or about 64 f + 40 f64
    operations per element and quadrature point, whichever is longer."""
    nbytes = C * (4 + 12 + 1) * 8 + lanes * (2 * N * f + C * 4 * f) * 8
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = lanes * C * Q * (64 * f + 40) / PEAK_FLOPS[torch.float64]
    return {"bytes": nbytes, "bound_us": max(t_bytes, t_ops) * 1e6,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_pore_residual(dev, rng, library=True):
    """Phase 3, the pore's element residuals: at every path shape the
    kernel within KERNEL_TOL per field of its plain version, bitwise
    repeatable, over lanes (under vmap, one launch) bitwise equal to
    one-lane launches; then the times, with the torch.func element loop
    the kernel replaced (FemSpace's vmap over the form's integrand) as the
    yardstick.  Returns the timed records keyed by name."""
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.ops import pore_residual, pore_residual_reference
    from gmpnp_tpu_torch.testing import pore_states

    records = {}
    progs = {}
    for name, physics, lanes, path in PORE_RESIDUAL_RECORDS:
        if physics not in progs:
            progs[physics] = pore_3d.build(
                pore_3d.Pore3DConfig(physics=physics, **PORE_KW), device=dev)
        prog = progs[physics]
        sp, form = prog.space, prog.form
        d = sp.dev
        C, Q, N, f = (sp.cells.shape[0], sp.Nq.shape[0], sp.num_vertices,
                      sp.n_fields)
        seeds = [int(s) for s in rng.integers(0, 2 ** 31, size=lanes)]
        states = [pore_states(prog, s) for s in seeds]
        U = torch.stack([a for a, _ in states])
        UP = torch.stack([b for _, b in states])
        dt = prog._theta_of_carry((U[0], 0.0), 0)["dt"]
        theta = {"dt": dt}
        tables = (d["cells"], d["gradN"], d["vols"], d["Nq"], d["wq"])

        def kernel(u, up, tabs):
            if lanes == 1:
                return pore_residual(u[0], up[0], dt, *tabs, form.spec)
            return torch.func.vmap(lambda a, b: pore_residual(
                a, b, dt, *tabs, form.spec))(u, up)

        def plain(u, up, tabs):
            return torch.func.vmap(lambda a, b: pore_residual_reference(
                a, b, dt, *tabs, form.spec))(u, up)

        def old_loop(u, up, tabs):
            cells, gradN, vols = tabs[:3]
            return torch.func.vmap(lambda a, b: torch.func.vmap(
                lambda ue, upe, g, v, x: sp._local_volume_residual(
                    form, ue, upe, g, v, x, theta))(
                        a[cells], b[cells], gradN, vols, d["xq"]))(u, up)

        n0 = sum(_launch_counts("pore_residual").values())
        got = kernel(U, UP, tables)
        again = kernel(U, UP, tables)
        launched = sum(_launch_counts("pore_residual").values()) - n0
        ref = plain(U, UP, tables).reshape(got.shape)
        torch.cuda.synchronize()
        rel = max(float((got[..., i] - ref[..., i]).norm()
                        / ref[..., i].norm()) for i in range(f))
        ok = {"within_tol": rel <= KERNEL_TOL[torch.float64],
              "bitwise_repeatable": torch.equal(got, again),
              "one_launch_a_call": launched == 2}
        if lanes > 1:
            one = torch.stack([pore_residual(U[v], UP[v], dt, *tables,
                                             form.spec)
                               for v in range(lanes)])
            ok["lanes_bitwise_one_lane"] = torch.equal(got, one)
        shape = (lanes, C, 4, f) if lanes > 1 else (C, 4, f)
        line = (f"kernel pore_residual {name} {'x'.join(map(str, shape))} "
                f"f64: {ok} max_rel_l2_per_field={rel!r}")
        print(line, flush=True)
        if not all(ok.values()):
            raise AssertionError(line)
        bound = pore_residual_bound(C, N, f, Q, lanes)
        copies = max(1, -(-COLD_ROTATION_BYTES // bound["bytes"]))
        ops = [(U, UP, tables)] + [
            (U.clone(), UP.clone(), tuple(t.clone() for t in tables[:3])
             + tables[3:]) for _ in range(copies - 1)]
        rec = hot_times(
            f"pore_residual {name} {'x'.join(map(str, shape))}",
            bound["bytes"], bound, lambda i: kernel(*ops[i]),
            lambda i: plain(*ops[i]),
            (lambda i: old_loop(*ops[i])) if library else None, copies)
        records[name] = {
            "shape": list(shape), "dtype": "float64", "path": path,
            "launch_key": _shape_key(((lanes,) if lanes > 1 else ())
                                     + (C, Q, f, "float64")),
            "max_rel_l2_per_field": rel,
            "library": "FemSpace's vmap of _local_volume_residual over the "
                       "form's integrand (the path the kernel replaced)",
            **ok, **rec}
    return records


def sechenov_bound(N):
    """The four columns read once and the value written once over the
    memory rate (the selection's compares are not counted: a few per value
    and pass)."""
    nbytes = 4 * N * 8 + 8
    return {"bytes": nbytes, "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
            "bound_by": "bytes"}


def check_sechenov(dev, rng):
    """Phase 3, the pore's Sechenov value: at the pores' shapes the
    kernel's four medians and its value bitwise the plain version's on the
    card (four torch.sorts and the scalar operations the kernel replaced),
    bitwise repeatable, one launch a call; then the times, the plain
    version beside them.  Returns the timed records keyed by name."""
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.ops import sechenov_co2, sechenov_co2_reference
    from gmpnp_tpu_torch.ops.sechenov import median
    from gmpnp_tpu_torch.testing import pore_states

    def bits(t):
        return t.reshape(-1).cpu().view(torch.int64)

    records = {}
    for name, physics, path in SECHENOV_RECORDS:
        prog = pore_3d.build(
            pore_3d.Pore3DConfig(physics=physics, **PORE_KW), device=dev)
        c = prog.sechenov
        u, _ = pore_states(prog, int(rng.integers(0, 2 ** 31)))
        N, f = u.shape
        med = torch.empty(4, dtype=torch.float64, device=dev)
        n0 = sum(_launch_counts("sechenov").values())
        got = sechenov_co2(u, c, medians=med)
        again = sechenov_co2(u, c)
        launched = sum(_launch_counts("sechenov").values()) - n0
        want_med = torch.stack([median(u[:, i]) for i in c.fields])
        want = sechenov_co2_reference(u, c)
        torch.cuda.synchronize()
        ok = {"medians_bitwise": torch.equal(bits(med), bits(want_med)),
              "value_bitwise": torch.equal(bits(got), bits(want)),
              "bitwise_repeatable": torch.equal(bits(got), bits(again)),
              "one_launch_a_call": launched == 2}
        line = (f"kernel sechenov {name} {N}x{f} f64: {ok} "
                f"value={float(got)!r} medians={med.tolist()!r}")
        print(line, flush=True)
        if not all(ok.values()):
            raise AssertionError(line)
        bound = sechenov_bound(N)
        copies = _copies(u)
        us = [u] + [u.clone() for _ in range(copies - 1)]
        rec = hot_times(
            f"sechenov {name} {N}x{f}", bound["bytes"], bound,
            lambda i: sechenov_co2(us[i], c),
            lambda i: sechenov_co2_reference(us[i], c), None, copies)
        records[name] = {
            "shape": [N, f], "dtype": "float64", "path": path,
            "launch_key": _shape_key((N, f, "float64")),
            "library": None, **ok, **rec}
    return records


def cr_apply_bound(M, N, f, lanes, dtype):
    """The factor read once (five (M - 1) f x f blocks and Binv_top a lane)
    and rhs read and x written once, over the memory rate (the ~2 (5 M f^2)
    f64 operations take far less)."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = lanes * ((5 * (M - 1) + 1) * f * f + 2 * N * f) * size
    return {"bytes": nbytes, "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
            "bound_by": "bytes"}


def _cr_copy(fac):
    from gmpnp_tpu_torch.solve.linear import CRFactors

    return CRFactors(tuple(type(lev)(*(t.clone() for t in lev))
                           for lev in fac.levels), fac.Binv_top.clone())


def check_cr_apply(dev, rng):
    """Phase 3, the 1D cyclic-reduction apply: at the paths' shapes (the
    EDL's (5,991, 7) in f64 and f32, three lanes of it, the 1D
    reaction-diffusion's (5,991, 5)) the kernel within CR_APPLY_TOL of its
    plain version (the former eager apply), bitwise repeatable, one launch
    a call, each lane bitwise its single-lane launch; then the times, the
    plain version beside them (no library call computes it).  Returns the
    timed records keyed by name."""
    from gmpnp_tpu_torch.ops import cr_apply, cr_apply_reference
    from gmpnp_tpu_torch.solve.linear import block_tridiag_factor_cr
    from gmpnp_tpu_torch.testing import tridiag_bands

    cra = importlib.import_module("gmpnp_tpu_torch.ops.cr_apply")
    records = {}
    for name, N, f, lanes, dtype, path in CR_APPLY_RECORDS:
        lo, di, up, rhs = tridiag_bands(N, f, lanes,
                                        seed=int(rng.integers(0, 2 ** 31)),
                                        dtype=dtype, device=dev)
        fac = block_tridiag_factor_cr(lo, di, up)
        n0 = sum(_launch_counts("cr_apply").values())
        got = cr_apply(fac.levels, fac.Binv_top, rhs)
        again = cr_apply(fac.levels, fac.Binv_top, rhs)
        launched = sum(_launch_counts("cr_apply").values()) - n0
        ref = cr_apply_reference(fac.levels, fac.Binv_top, rhs)
        torch.cuda.synchronize()
        rel = float((got - ref).norm() / ref.norm())
        ok = {"within_tol": rel <= CR_APPLY_TOL[dtype],
              "bitwise_repeatable": torch.equal(got, again),
              "one_launch_a_call": launched == 2}
        if lanes:
            ok["lanes_bitwise_one_lane"] = all(torch.equal(got[v], cr_apply(
                [type(lev)(*(t[v] for t in lev)) for lev in fac.levels],
                fac.Binv_top[v], rhs[v])) for v in range(lanes))
        L = len(fac.levels)
        plan = cra.cr_plan(L, f)
        shape = ((lanes,) if lanes else ()) + (N, f)
        dname = str(dtype).replace("torch.", "")
        line = (f"kernel cr_apply {name} {'x'.join(map(str, shape))} {dname}: "
                f"{ok} max_rel_l2={rel!r} plan={plan._asdict()}")
        print(line, flush=True)
        if not all(ok.values()):
            raise AssertionError(line)
        bound = cr_apply_bound(2 ** L, N, f, lanes or 1, dtype)
        copies = max(1, -(-COLD_ROTATION_BYTES // bound["bytes"]))
        facs = [fac] + [_cr_copy(fac) for _ in range(copies - 1)]
        rec = hot_times(
            f"cr_apply {name} {'x'.join(map(str, shape))} {dname}",
            bound["bytes"], bound,
            lambda i: cr_apply(facs[i].levels, facs[i].Binv_top, rhs),
            lambda i: cr_apply_reference(facs[i].levels, facs[i].Binv_top,
                                         rhs), None, copies)
        records[name] = {
            "shape": list(shape), "dtype": dname, "path": path,
            "launch_key": _shape_key(shape + (dname,)),
            "max_rel_l2": rel, "plan": plan._asdict(), "library": None,
            **ok, **rec}
        del facs
    return records


@contextlib.contextmanager
def cr_plain_route():
    """solve.linear.block_tridiag_apply_cr through the plain version (the
    eager apply the kernel replaced), on every device."""
    from gmpnp_tpu_torch.solve import linear

    saved = getattr(linear, "_cr_apply", None)
    if saved is None:   # a checkout before the kernel: the eager apply
        yield
        return
    linear._cr_apply = importlib.import_module(
        "gmpnp_tpu_torch.ops.cr_apply").cr_apply_reference
    try:
        yield
    finally:
        linear._cr_apply = saved


def cr_apply_episodes(dev_name):
    """One carried EDL episode per OHP voltage of the benchmark's cell
    ``edl_mpnp.carried20`` (its configuration and workload files), through
    the kernel and through the plain version: the Newton counts must be
    equal; the largest state difference is printed."""
    from benchmark.harness.program import program_config

    def load(*parts):
        with open(os.path.join(ROOT, "benchmark", *parts)) as fh:
            return json.load(fh)

    cfg = load("configs", "edl_mpnp_50um.json")
    wl = load("workloads", "edl_mpnp.carried20.json")
    n_steps = wl["run"]["n_steps"]
    for volt in wl["voltages"]:
        mod, pcfg = program_config(cfg, wl, volt)
        runs = {}
        for route in ("kernel", "plain"):
            ctx = cr_plain_route() if route == "plain" else (
                contextlib.nullcontext())
            with ctx:
                n0 = sum(_launch_counts("cr_apply").values())
                prog = mod.build(pcfg, device=dev_name)
                t0 = time.perf_counter()
                _, hist, st, _ = prog.run(n_steps=n_steps)
                torch.cuda.synchronize()
                runs[route] = (np.asarray(st.newton_iters),
                               torch.stack(list(hist)).cpu(),
                               time.perf_counter() - t0,
                               sum(_launch_counts("cr_apply").values()) - n0)
        (it_k, h_k, s_k, n_k), (it_p, h_p, s_p, n_p) = (runs["kernel"],
                                                        runs["plain"])
        diff = float((h_k - h_p).abs().max())
        scale = float(h_p.abs().max())
        line = (f"cr_apply episode edl_mpnp.carried20 V={volt}: "
                f"newton_equal={bool(np.array_equal(it_k, it_p))} "
                f"newton_kernel={int(it_k.sum())} "
                f"newton_plain={int(it_p.sum())} "
                f"max_state_diff={diff!r} max_state={scale!r} "
                f"wall_s kernel/plain={s_k!r}/{s_p!r} "
                f"launches kernel/plain={n_k}/{n_p}")
        print(line, flush=True)
        if not np.array_equal(it_k, it_p) or n_k <= 0 or n_p != 0:
            raise AssertionError(line)


def _launch_counts(kernel):
    """A kernel's launches per dtype (``ops.COUNTERS``)."""
    from gmpnp_tpu_torch import ops

    return ops.COUNTERS[kernel][0]


def hot_times(label, nbytes, bound, kernel, plain, library, copies):
    """Times of a kernel and its plain version at one shape, in turns
    (plain, kernel, kernel, plain), and of the library call once (None:
    not timed): CUDA-event ms per call, device us per call from a replayed
    CUDA graph, hot (operand copy 0 every call) and cold (the calls rotate
    over ``copies`` copies, >= 256 MB).  ``kernel``, ``plain`` and
    ``library`` take the copy's index.  A library call that fails (or that
    a graph cannot capture) leaves its times None and says why in
    ``library_note``."""
    def turn(fn):
        # a call over 1 ms (the plain versions at the Jacobian's shape)
        # takes fewer calls and replays: the time is long enough to read
        ms = time_ms(lambda: fn(0), reps=5, warmup=2)
        slow = ms > 1.0
        if not slow:
            ms = time_ms(lambda: fn(0))
        n = 2 if slow else (100 if nbytes < (16 << 20) else 20)
        reps = 3 if slow else 10
        return (ms, graph_us([lambda: fn(0)], n=n, reps=reps),
                graph_us([(lambda i=i: fn(i)) for i in range(copies)], n=n,
                         reps=reps))

    turns = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        turns[name].append(turn(kernel if name == "kernel" else plain))
    (ms, hot, cold), (plain_ms, plain_hot, plain_cold) = (
        tuple(float(np.mean(v)) for v in zip(*turns[name]))
        for name in ("kernel", "plain"))
    rec = {"ms": ms, "plain_ms": plain_ms, "device_us": hot,
           "device_us_cold": cold, "plain_device_us": plain_hot,
           "plain_device_us_cold": plain_cold,
           "bound_us": bound["bound_us"], "bound_ms": bound["bound_us"] / 1e3,
           "bound_by": bound["bound_by"],
           "share_of_bound_cold": bound["bound_us"] / cold,
           "library_ms": None, "library_us": None, "library_us_cold": None}
    try:
        if library is None:
            raise LookupError("not timed (--kernel-times, or no library "
                              "call computes it)")
        rec["library_ms"], rec["library_us"], rec["library_us_cold"] = (
            turn(library))
    except Exception as e:  # the yardstick may be refused; the run goes on
        torch.cuda.synchronize()
        rec["library_note"] = f"{type(e).__name__}: {e}"[:300]
    print(f"kernel {label}: bytes={bound['bytes']} cold_copies={copies} "
          f"turns={json.dumps(turns)} " + json.dumps(rec), flush=True)
    if rec["share_of_bound_cold"] > 1.0:
        raise AssertionError(
            f"{label}: cold time {cold} us is under the bound "
            f"{bound['bound_us']} us")
    return rec


def _copies(t):
    return max(1, -(-COLD_ROTATION_BYTES // (t.numel() * t.element_size())))


def check_segment_sum(dev, spaces, rng, library=True):
    """Phase 3, the sorted-segment sum: at every path shape the kernel
    bitwise equal to the sequential sum in sorted order and to a second
    launch, within the cumsum twin's own rounding of it (2 M eps
    max|prefix| per column), over lanes bitwise equal to one-lane launches
    and to the custom op's vmap; then, at the paths' shapes, the times.
    Returns the timed records keyed by name."""
    from gmpnp_tpu_torch.ops import (
        segment_sum, segment_sum_op, segment_sum_reference)
    from gmpnp_tpu_torch.testing import sequential_segment_sum

    records = {}
    checks = SEGMENT_RECORDS + [
        ("segment_sum_f32_pore_jacobian", "pore", "jac", 81, 1, None)]
    for name, mesh, table, d, lanes, path in checks:
        dtype = torch.float32 if "_f32_" in name else torch.float64
        order, start, end = spaces[mesh].dev[f"{table}_tables"]
        M, n_dest = order.shape[0], start.shape[0]
        shape = (lanes, M, d) if lanes > 1 else (M, d)
        values = torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                                 device=dev)
        got = segment_sum(values, order, start, end)
        again = segment_sum(values, order, start, end)
        seq = sequential_segment_sum(values, order, start, end)
        twin = segment_sum_reference(values, order, start, end)
        prefix = torch.cumsum(values.index_select(-2, order), dim=-2)
        bound = 2 * M * torch.finfo(dtype).eps * prefix.abs().amax(dim=-2)
        gap = (got - twin).abs()
        ratio = float(torch.where(gap > 0, gap / bound.unsqueeze(-2),
                                  0.0).max())
        torch.cuda.synchronize()
        ok = {"bitwise_equal_sequential": torch.equal(got, seq),
              "bitwise_repeatable": torch.equal(got, again),
              "within_cumsum_rounding": ratio <= 1.0}
        if lanes > 1:
            one = torch.stack([segment_sum(values[v], order, start, end)
                               for v in range(lanes)])
            via_vmap = torch.func.vmap(
                lambda v: segment_sum_op(v, order, start, end))(values)
            ok["lanes_bitwise_one_lane"] = (torch.equal(got, one)
                                            and torch.equal(via_vmap, one))
        err = float(gap.max())
        plan = getattr(importlib.import_module(
            "gmpnp_tpu_torch.ops.segment_sum"), "segment_plan", None)
        plan = (plan(d, values.element_size())._asdict() if plan
                else {"path": "warp per row"})
        line = (f"kernel segment_sum {name} {'x'.join(map(str, shape))} -> "
                f"{n_dest} {dtype}: {ok} max_abs_err_vs_cumsum={err!r} "
                f"largest gap / (2 M eps max|prefix|) = {ratio!r} "
                f"plan={plan}")
        print(line, flush=True)
        if not all(ok.values()):
            raise AssertionError(line)
        if path is None:
            continue
        copies = _copies(values)
        vals = [values] + [values.clone() for _ in range(copies - 1)]
        # the library yardstick: index_add_ of every value row onto its
        # destination (atomics; called nowhere in the package)
        dest = torch.empty(M, dtype=torch.int64, device=dev)
        dest[order] = torch.repeat_interleave(
            torch.arange(n_dest, device=dev), end - start)
        if lanes > 1:
            dest = (dest[None] + n_dest * torch.arange(
                lanes, device=dev)[:, None]).reshape(-1)
        lib = torch.zeros(lanes * n_dest, d, dtype=dtype, device=dev
                          ).index_add_(0, dest, values.reshape(-1, d))
        torch.cuda.synchronize()
        lib_rel = float((lib.reshape(got.shape) - twin).norm()
                        / twin.norm())
        rec = hot_times(
            f"segment_sum {name} {'x'.join(map(str, shape))}",
            values.numel() * values.element_size(),
            segment_bound(M, n_dest, d, dtype, lanes),
            lambda i: segment_sum(vals[i], order, start, end),
            lambda i: segment_sum_reference(vals[i], order, start, end),
            (lambda i: torch.zeros(lanes * n_dest, d, dtype=dtype,
                                   device=dev).index_add_(
                0, dest, vals[i].reshape(-1, d))) if library else None,
            copies)
        records[name] = {"shape": list(shape), "n_dest": n_dest, "dtype":
                         str(dtype).replace("torch.", ""), "path": path,
                         "launch_key": _shape_key(
                             ((lanes,) if lanes > 1 else ()) +
                             (M, n_dest, d, str(dtype).replace("torch.", ""))),
                         "plan": plan, "max_abs_err": err,
                         "gap_over_bound": ratio,
                         "library": "torch.zeros(n_dest, d).index_add_(0, "
                                    "dest, values)",
                         "library_rel_l2": lib_rel, **ok, **rec}
    return records


def cr_level0(spaces):
    """The first level's batch of the 1D cyclic reduction: half the next
    power of two of the 1D mesh's vertices."""
    from gmpnp_tpu_torch.solve.linear import _pow2

    return _pow2(spaces["edl"].num_vertices) // 2


def check_block_inv(dev, spaces, rng, library=True):
    """Phase 3, the batched block inverse: at every path shape (and f=5,
    7, 9 in both types) the kernel bitwise equal to its plain version and
    to a second launch, on seeded blocks whose first ten take every branch
    of the algorithm; a NaN lands where the plain version puts it; then,
    at the paths' shapes, the times.  Returns the timed records keyed by
    name."""
    from gmpnp_tpu_torch.ops import block_inv, block_inv_reference
    from gmpnp_tpu_torch.testing import guard_blocks

    batches = {"pore": spaces["pore"].num_vertices, "cr": cr_level0(spaces),
               "cr_lanes": LANES * cr_level0(spaces)}
    checks = list(BLOCK_INV_RECORDS)
    checks += [(f"block_inv_{tag}_f{f}", "pore", f, dt, None)
               for f in (5, 7, 9)
               for tag, dt in (("f32", torch.float32),
                               ("f64", torch.float64))]
    records = {}
    for name, rule, f, dtype, path in checks:
        batch = batches[rule]
        A = torch.as_tensor(guard_blocks(rng, batch, f), dtype=dtype,
                            device=dev)
        got = block_inv(A)
        again = block_inv(A)
        ref = block_inv_reference(A)
        nan = A[:16].clone()
        nan[1, 0, 0] = float("nan")
        same_nan = torch.equal(torch.isnan(block_inv(nan)),
                               torch.isnan(block_inv_reference(nan)))
        torch.cuda.synchronize()
        finite = torch.isfinite(ref)
        ok = {"bitwise_equal_plain": torch.equal(got, ref),
              "bitwise_repeatable": torch.equal(got, again),
              "nan_as_plain": same_nan}
        err = float((got - ref)[finite].abs().max())
        line = (f"kernel block_inv {name} ({batch}, {f}, {f}) {dtype}: {ok} "
                f"max_abs_err={err!r}")
        print(line, flush=True)
        if not all(ok.values()):
            raise AssertionError(line)
        if path is None:
            continue
        copies = _copies(A)
        mats = [A] + [A.clone() for _ in range(copies - 1)]
        rec = hot_times(
            f"block_inv {name} ({batch}, {f}, {f})",
            A.numel() * A.element_size(), block_inv_bound(batch, f, dtype),
            lambda i: block_inv(mats[i]),
            lambda i: block_inv_reference(mats[i]),
            # the library yardstick, called nowhere in the package: LU
            # inverse without the error check's host sync
            (lambda i: torch.linalg.inv_ex(mats[i])[0]) if library else None,
            copies)
        per_warp = getattr(importlib.import_module(
            "gmpnp_tpu_torch.ops.block_inv"), "blocks_per_warp", None)
        records[name] = {"shape": [batch, f, f], "dtype":
                         str(dtype).replace("torch.", ""), "path": path,
                         "plan": {"blocks_per_warp": per_warp(f)
                                  if per_warp else 32 // (2 * f)},
                         "launch_key": _shape_key(
                             (batch, f, str(dtype).replace("torch.", ""))),
                         "max_abs_err": err,
                         "library": "torch.linalg.inv_ex(A)[0]", **ok, **rec}
    return records


#: widths of phase 3's edge checks of the segment sum: every packed width
#: the paths use (5, 7, 9) and the packed path's ends (1, 16), the
#: warp-per-row path's first width (17), the Jacobians' (49, 81) and one
#: that takes two column blocks (129)
SEGMENT_EDGE_WIDTHS = (1, 5, 7, 9, 16, 17, 49, 81, 129)
#: batches of phase 3's edge checks of block_inv: under one warp's blocks
#: (3: a row of the batched block-Thomas solve, a block per lane), and not
#: a whole number of warps or CUDA blocks at any f
BLOCK_INV_EDGE_BATCHES = (1, 3, 31, 37, 130)


def check_segment_sum_edges(dev, rng):
    """Phase 3, bitwise and repeatable only: the segment sum on a table
    whose rows take 0, 1, 31, 32, 33 and 100 entries
    (``testing.edge_segment_tables``) at every width of
    SEGMENT_EDGE_WIDTHS, f32 and f64, one lane and three: equal to the
    sequential sum in sorted order and to a second launch, each lane equal
    to its one-lane launch, on the current and on a side stream."""
    from gmpnp_tpu_torch.ops import segment_sum
    from gmpnp_tpu_torch.testing import (
        edge_segment_tables, sequential_segment_sum)

    order, start, end = edge_segment_tables(rng, dev)
    side = torch.cuda.Stream(device=dev)
    failed = []
    for d in SEGMENT_EDGE_WIDTHS:
        for dtype in (torch.float32, torch.float64):
            values = torch.as_tensor(
                rng.normal(size=(LANES, order.shape[0], d)), dtype=dtype,
                device=dev)
            got = segment_sum(values, order, start, end)
            again = segment_sum(values, order, start, end)
            one = torch.stack([segment_sum(values[v].contiguous(), order,
                                           start, end)
                               for v in range(LANES)])
            torch.cuda.synchronize()
            with torch.cuda.stream(side):
                on_side = segment_sum(values, order, start, end)
            side.synchronize()
            seq = sequential_segment_sum(values, order, start, end)
            if not (torch.equal(got, seq) and torch.equal(got, again)
                    and torch.equal(got, one) and torch.equal(got, on_side)):
                failed.append((d, str(dtype)))
    line = (f"kernel segment_sum edges: rows of {(end - start).tolist()} "
            f"entries, d in {SEGMENT_EDGE_WIDTHS}, f32 and f64, {LANES} "
            f"lanes: bitwise sequential, repeatable, per lane and on a side "
            f"stream except {failed}")
    print(line, flush=True)
    if failed:
        raise AssertionError(line)


def check_block_inv_edges(dev, rng):
    """Phase 3, bitwise and repeatable only: ``block_inv`` at every f from
    1 to 16, f32 and f64, at each batch of BLOCK_INV_EDGE_BATCHES, on
    blocks whose first ten take every guard branch
    (``testing.guard_blocks``): equal to the plain version and to a second
    launch; a NaN in a block lands where the plain version puts it."""
    from gmpnp_tpu_torch.ops import block_inv, block_inv_reference
    from gmpnp_tpu_torch.testing import guard_blocks

    failed = []
    for f in range(1, 17):
        for dtype in (torch.float32, torch.float64):
            for batch in BLOCK_INV_EDGE_BATCHES:
                A = torch.as_tensor(guard_blocks(rng, batch, f), dtype=dtype,
                                    device=dev)
                got, again = block_inv(A), block_inv(A)
                nan = A.clone()
                nan[-1, 0, 0] = float("nan")
                same_nan = torch.equal(
                    torch.isnan(block_inv(nan)),
                    torch.isnan(block_inv_reference(nan)))
                if not (torch.equal(got, block_inv_reference(A))
                        and torch.equal(got, again) and same_nan):
                    failed.append((f, str(dtype), batch))
    line = (f"kernel block_inv edges: f 1..16, f32 and f64, batches "
            f"{BLOCK_INV_EDGE_BATCHES}: bitwise plain, repeatable, NaN as "
            f"plain except {failed}")
    print(line, flush=True)
    if failed:
        raise AssertionError(line)


def launch_floors(dev):
    """The device time of a launch that does almost nothing, per kernel
    and type: one row of one value, one 1 x 1 block, one element."""
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.ops import block_inv, pore_residual, segment_sum

    floors = {}
    i64 = dict(dtype=torch.int64, device=dev)
    for dtype in (torch.float32, torch.float64):
        v = torch.ones((1, 1), dtype=dtype, device=dev)
        z = torch.zeros(1, **i64)
        o = torch.ones(1, **i64)
        floors["segment_sum", dtype] = graph_us(
            [lambda: segment_sum(v, z, z, o)])
        A = torch.ones((1, 1, 1), dtype=dtype, device=dev)
        floors["block_inv", dtype] = graph_us([lambda: block_inv(A)])
    prog = pore_3d.build(pore_3d.Pore3DConfig(mesh_resolution=(2, 10)),
                         device=dev)
    u = prog.initial_state()
    t = prog.space.dev
    one = (t["cells"][:1], t["gradN"][:1], t["vols"][:1], t["Nq"], t["wq"])
    floors["pore_residual", torch.float64] = graph_us(
        [lambda: pore_residual(u, u, 1.0, *one, prog.form.spec)])
    if hasattr(prog, "sechenov"):   # not in checkouts before it
        from gmpnp_tpu_torch.ops import sechenov_co2

        floors["sechenov", torch.float64] = graph_us(
            [lambda: sechenov_co2(u[:1], prog.sechenov)])
    ops_mod = importlib.import_module("gmpnp_tpu_torch.ops")
    if hasattr(ops_mod, "cr_apply"):   # not in checkouts before it
        from gmpnp_tpu_torch.solve.linear import block_tridiag_factor_cr

        for dtype in (torch.float32, torch.float64):
            one = torch.ones((1, 1, 1), dtype=dtype, device=dev)
            fac = block_tridiag_factor_cr(one * 0, one, one * 0)
            b = torch.ones((1, 1), dtype=dtype, device=dev)
            floors["cr_apply", dtype] = graph_us(
                [lambda: ops_mod.cr_apply(fac.levels, fac.Binv_top, b)])
    print(f"kernel launch floors (segment_sum one value, block_inv one 1x1 "
          f"block, pore_residual one element, sechenov one row, cr_apply "
          f"one row): "
          f"{ {f'{k} {t}': v for (k, t), v in floors.items()} }", flush=True)
    return floors


def check_hot_kernels(dev, library=True):
    """Phase 3 for the segment-sum and block_inv kernels, with their times
    (and the library calls' with ``library``); returns the records at the
    paths' shapes keyed by name, each with its launch floor."""
    rng = np.random.default_rng(909)
    spaces = path_spaces(dev)
    floors = launch_floors(dev)
    records = check_segment_sum(dev, spaces, rng, library)
    records.update(check_block_inv(dev, spaces, rng, library))
    records.update(check_pore_residual(dev, rng, library))
    if hasattr(importlib.import_module("gmpnp_tpu_torch.ops"),
               "sechenov_co2"):   # not in checkouts before it
        records.update(check_sechenov(dev, rng))
    if hasattr(importlib.import_module("gmpnp_tpu_torch.ops"),
               "cr_apply"):   # not in checkouts before it
        records.update(check_cr_apply(dev, rng))
    if hasattr(importlib.import_module("gmpnp_tpu_torch.testing"),
               "edge_segment_tables"):   # not in checkouts before it
        check_segment_sum_edges(dev, rng)
    check_block_inv_edges(dev, rng)
    for name, rec in records.items():
        dtype = (torch.float32 if rec["dtype"] == "float32"
                 else torch.float64)
        rec["floor_us"] = floors[_kernel_of(name), dtype]
    return records


def kernel_records(records, hot, launches):
    """The kernels line: phase 3's records of every kernel at the paths'
    shapes, each with the launches counted on its path at its shape (at
    least one, or the run fails)."""
    kernels = []
    for name, label, dtype, path in KERNEL_RECORDS:
        rec = records[label, dtype]
        N, K, f = rec["shape"]
        n = launches[path]["ell_spmv"]["shapes"].get(
            f"{N}x{K}x{f} {str(dtype).replace('torch.', '')}", 0)
        if n <= 0:
            raise AssertionError(f"{name}: path {path} launched no kernel at "
                                 f"{rec['shape']}")
        kernels.append({"name": name, "route": "cuda",
                        "source": "gmpnp_tpu_torch/csrc/ell_spmv.cu",
                        "replaces": "gmpnp_tpu/ops/ell_spmv.py:70",
                        "path": path, "launches": n, **rec})
    for name, label, dtype, path in LANE_RECORDS:
        rec = records[label, dtype]
        n = launches[path]["ell_spmv"]["shapes"].get(
            "x".join(map(str, rec["shape"]))
            + f" {str(dtype).replace('torch.', '')}", 0)
        if n <= 0:
            raise AssertionError(f"{name}: path {path} launched no kernel at "
                                 f"{rec['shape']}")
        kernels.append({"name": name, "route": "cuda",
                        "source": "gmpnp_tpu_torch/csrc/ell_spmv.cu",
                        "replaces": "gmpnp_tpu/ops/ell_spmv.py:70",
                        "path": path, "launches": n, **rec})
    return kernels + hot_kernel_records(hot, launches)


def hot_kernel_records(hot, launches):
    """The kernels line's records of the segment-sum and block_inv kernels:
    phase 3's records with the launches counted on each one's path at its
    shape (at least one, or the run fails)."""
    out = []
    for name, rec in hot.items():
        if rec["path"] is None:   # a shape no phase-4 path runs
            continue
        kernel = _kernel_of(name)
        n = launches[rec["path"]][kernel]["shapes"].get(rec["launch_key"], 0)
        if n <= 0:
            raise AssertionError(f"{name}: path {rec['path']} launched no "
                                 f"{kernel} kernel at {rec['launch_key']}")
        source, replaces = HOT_SOURCES[kernel]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": n,
                    **{k: v for k, v in rec.items() if k != "launch_key"}})
    return out


def _kernel_of(record_name):
    return next(k for k in HOT_SOURCES if record_name.startswith(k))


@contextlib.contextmanager
def timed_steps(model, steps_log):
    """Wraps the model's run_transient so that each step ends in a
    synchronize and records wall ms, iterations, host syncs and kernel
    launches."""
    from gmpnp_tpu_torch import sync
    from gmpnp_tpu_torch.io import checkpoint

    orig = model.run_transient
    orig_ck = checkpoint.run_transient

    def timed_run_transient(step, *args, _orig=orig, **kw):
        def timed(*a):
            torch.cuda.synchronize()
            l0 = _launches()
            s0, t0 = sync.SYNCS, time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            st = out[1]
            steps_log.append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "newton": int(st.newton_iters),
                "linear": int(st.linear_iters),
                "converged": bool(st.converged),
                "host_syncs": sync.SYNCS - s0,
                "launches": _step_launches(l0)})
            return out
        return _orig(timed, *args, **kw)

    model.run_transient = timed_run_transient
    checkpoint.run_transient = functools.partial(timed_run_transient,
                                                 _orig=orig_ck)
    try:
        yield
    finally:
        model.run_transient = orig
        checkpoint.run_transient = orig_ck


def check_outputs(res, n_steps, n_vtk):
    run_dir = res["run_dir"]
    n_vertices = res["coor_array"].shape[0]
    for name in ("arrays_unscaled.npz", "arrays_scaled.npz"):
        with np.load(os.path.join(run_dir, name)) as z:
            for k in z.files:
                if not np.all(np.isfinite(z[k])):
                    raise AssertionError(f"{name}:{k} not finite")
            if (name == "arrays_unscaled.npz"
                    and z["H"].shape != (n_steps + 1, n_vertices)):
                raise AssertionError(f"H history shape {z['H'].shape}")
    with open(os.path.join(run_dir, "metadata.json")) as fh:
        meta = json.load(fh)
    if not meta["all_steps_converged"]:
        raise AssertionError(f"not every step converged: {meta}")
    vtu = [f for f in os.listdir(run_dir) if f.endswith(".vtu")]
    if len(vtu) != n_vtk:
        raise AssertionError(f"expected {n_vtk} VTK files, found {vtu}")
    return meta


def _shape_key(key):
    return "x".join(map(str, key[:-1])) + f" {key[-1]}"


def _launches():
    """Launches since the last _zero_launches, keyed by each kernel's name
    in ``ops.COUNTERS``: per dtype, and per shape under "shapes"
    ("ell_spmv": "NxKxf dtype", "segment_sum": "MxNdestxd dtype",
    "block_inv": "batchxf dtype"; a lane count first over lanes)."""
    from gmpnp_tpu_torch import ops

    out = {}
    for name, (per_dtype, per_shape) in ops.COUNTERS.items():
        rec = {str(k).replace("torch.", ""): v for k, v in per_dtype.items()}
        rec["shapes"] = {_shape_key(key): n for key, n in sorted(
            per_shape.items(), key=lambda kv: str(kv[0]))}
        out[name] = rec
    return out


def _step_launches(before, key="dtype"):
    """What was launched since ``before`` (a _launches reading), for the
    per-step lines: each kernel's launches per dtype, or with
    ``key="shape"`` its nonzero launches per shape."""
    out = {}
    for name, rec in _launches().items():
        if key == "shape":
            was = before[name]["shapes"]
            diff = {k: n - was.get(k, 0) for k, n in rec["shapes"].items()
                    if n != was.get(k, 0)}
            if diff:
                out[name] = diff
        else:
            out[name] = {k: n - before[name][k] for k, n in rec.items()
                         if k != "shapes"}
    return out


def _zero_launches():
    from gmpnp_tpu_torch import ops

    for per_dtype, per_shape in ops.COUNTERS.values():
        for k in per_dtype:
            per_dtype[k] = 0
        per_shape.clear()


def run_path(label, model_name, fn, n_steps, n_vtk, full=False):
    """One path: launch counts set to 0 before it and read after it.
    Returns the launches, or with ``full`` (launches, result, steps)."""
    from gmpnp_tpu_torch import sync

    model = importlib.import_module(f"gmpnp_tpu_torch.models.{model_name}")
    steps = []
    _zero_launches()
    s0, t0 = sync.SYNCS, time.perf_counter()
    with timed_steps(model, steps):
        res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    meta = check_outputs(res, n_steps, n_vtk)
    print(f"path {label} n_steps={n_steps}: wall_s={wall!r} "
          f"newton_total={meta['newton_iters_total']} "
          f"linear_total={meta.get('linear_iters_total')} "
          f"host_syncs={sync.SYNCS - s0} launches={launches}", flush=True)
    for i, st in enumerate(steps):
        print(f"  step {i}: " + json.dumps(st), flush=True)
    if len(steps) != n_steps or not all(st["converged"] for st in steps):
        raise AssertionError(f"{label}: steps {steps}")
    return (launches, res, steps) if full else launches


def mp_solve_path(dev_name):
    """tridiag_mp_solve (f32 CR factorization, f64 GMRES over the f64
    kernel) on the EDL cold-start Jacobian at L_n=50 um, held to the
    all-f64 CR solve; both solves timed (host clock, synchronized, median
    of 5)."""
    from gmpnp_tpu_torch import sync
    from gmpnp_tpu_torch.models import edl_1d
    from gmpnp_tpu_torch.solve.linear import (
        block_tridiag_from_ell, block_tridiag_solve_cr, tridiag_mp_solve)

    prog = edl_1d.build(edl_1d.EDL1DConfig(L_n=EDL_L_N), device=dev_name)
    u0 = prog.initial_state()
    theta = prog._theta_of_carry((u0, 0.0), 0)
    u = prog.bc.project(u0)
    ell = prog.bc.apply_to_jacobian(
        prog.space.jacobian(prog.form, u, u0, theta))
    r = prog.bc.apply_to_residual(
        prog.space.residual(prog.form, u, u0, theta), u)
    x_cr = block_tridiag_solve_cr(*block_tridiag_from_ell(ell), r)
    torch.cuda.synchronize()

    _zero_launches()
    s0, t0 = sync.SYNCS, time.perf_counter()
    res = tridiag_mp_solve(ell, r, tol=1e-8, max_refine=40)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = _launches()
    syncs = sync.SYNCS - s0
    rel = float((res.x - x_cr).norm() / x_cr.norm())

    def median_ms(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    mp_ms = median_ms(lambda: tridiag_mp_solve(ell, r, tol=1e-8,
                                               max_refine=40))
    cr_ms = median_ms(lambda: block_tridiag_solve_cr(
        *block_tridiag_from_ell(ell), r))
    print(f"path tridiag_mp_solve N={ell.flat.shape[0]} f="
          f"{ell.flat.shape[1]}: converged={res.converged} "
          f"gmres_iters={res.iters} first_call_ms={wall_ms!r} "
          f"host_syncs={syncs} launches={launches} "
          f"rel_l2_vs_f64_cr={rel!r} mp_ms={mp_ms!r} f64_cr_ms={cr_ms!r}",
          flush=True)
    if not res.converged or launches["ell_spmv"]["float64"] <= 0:
        raise AssertionError("tridiag_mp_solve did not converge or "
                             "launched no f64 kernel")
    return launches


def main_path(dev_name):
    """Phase 4: every path; returns each path's launches."""
    from gmpnp_tpu_torch.models import rxn_diff_1d

    torch.cuda.reset_peak_memory_stats()
    launches = {}
    for cli_name, model_name, head, n_vtk, runs in (
            ("pore_3d", "pore_3d", SLICE, 9, (("carried", 5), ("iter", 2))),
            ("rxn_diff_3d", "pore_3d", SLICE, 7,
             (("carried", 5), ("iter", 2))),
            ("edl_1d", "edl_1d", ["--dry_run", "Y", "--L_n", str(EDL_L_N)], 0,
             (("carried", 20), ("iter", 5)))):
        cli = importlib.import_module(f"gmpnp_tpu_torch.cli.{cli_name}")
        for refresh, n in runs:
            argv = [*head, "--linear_refresh", refresh, "--n_steps", str(n),
                    "--out_root", os.path.join(OUT, cli_name, refresh),
                    "--device", dev_name]
            label = f"{cli_name} {refresh}"
            launches[label] = run_path(label, model_name,
                                       lambda: cli.main(argv), n, n_vtk)
    cfg = rxn_diff_1d.RxnDiff1DConfig(L_n=EDL_L_N)
    launches["rxn_diff_1d"] = run_path(
        "rxn_diff_1d", "rxn_diff_1d",
        lambda: rxn_diff_1d.run(cfg, out_root=os.path.join(OUT,
                                                           "rxn_diff_1d"),
                                n_steps=20, device=dev_name), 20, 0)
    launches["tridiag_mp_solve"] = mp_solve_path(dev_name)
    print(f"peak device memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)
    for label, dtype in (("pore_3d carried", "float32"),
                         ("pore_3d iter", "float64"),
                         ("rxn_diff_3d carried", "float32"),
                         ("rxn_diff_3d iter", "float64")):
        if launches[label]["ell_spmv"][dtype] <= 0:
            raise AssertionError(f"{label} launched no {dtype} kernel")
    # every model path assembles through the segment-sum kernel and inverts
    # blocks through the block_inv kernel (the slab equilibration, the 1D
    # cyclic reduction); the 1D mixed-precision solve only inverts
    for label, counts in launches.items():
        for kernel in ("segment_sum", "block_inv"):
            if kernel == "segment_sum" and label == "tridiag_mp_solve":
                continue
            if not counts[kernel]["shapes"]:
                raise AssertionError(f"{label} launched no {kernel} kernel")
    return launches


def _digest(*tensors) -> str:
    """sha256 of the tensors' bytes (host copies), in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _repeat_runs(dev_name):
    """(label, run) of the repeatability phase: run() -> (states, projected
    field, Newton counts, Krylov counts), each from the cold start."""
    from gmpnp_tpu_torch.fem.projection import project_gradient
    from gmpnp_tpu_torch.models import edl_1d
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.parallel import sweep

    def pore(physics):
        def run():
            prog = pore_3d.build(_pore_cfg(refresh="carried",
                                           physics=physics), device=dev_name)
            _, hist, st, u = prog.run(n_steps=5)
            # the field of the potential (GMPNP) or of CO2, as the outputs
            # project it
            col = (len(prog.config.species) if physics == "GMPNP"
                   else prog.idx["CO2"])
            field = project_gradient(prog.space, u[:, col], sign=-1.0)
            return hist, field, st.newton_iters, st.linear_iters
        return run

    def edl():
        cfg = edl_1d.EDL1DConfig(L_n=EDL_L_N)
        cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
            cfg.linear, refresh="iter"))
        prog = edl_1d.build(cfg, device=dev_name)
        _, hist, st, _ = prog.run(n_steps=5)
        field = project_gradient(prog.space, hist[-1][:, edl_1d.P],
                                 sign=-1.0)
        return hist, field, st.newton_iters, st.linear_iters

    def batched():
        u, st = sweep.run_pore_voltage_sweep(
            _pore_cfg(refresh="carried"), [-0.5, -1.0, -1.5], n_steps=3,
            chunk=LANES, device=dev_name)
        space = pore_3d.build(_pore_cfg(), device=dev_name).space
        field = torch.stack([project_gradient(space, u[v, -1, :, 8],
                                              sign=-1.0)
                             for v in range(u.shape[0])])
        return u, field, st.newton_iters, st.linear_iters

    return [("pore_3d carried L50R5", pore("GMPNP")),
            ("rxn_diff_3d carried L50R5", pore("rxn_diff")),
            ("edl_1d iter L_n=50um", edl),
            ("sweep pore_3d batched L50R5", batched)]


def repeat_paths(dev_name):
    """Phase 4 "repeatable": each path run twice in this process from the
    same cold start; the final states of every step, the projected field,
    and the Newton and Krylov counts of every step must be bitwise equal.
    Prints one ``repeatable`` line per path whose sha256 (over the states
    and the field) two calls of the script on one tree must share."""
    for label, run in _repeat_runs(dev_name):
        t0 = time.perf_counter()
        first, second = run(), run()
        torch.cuda.synchronize()
        states, field, newton, krylov = first
        same = (torch.equal(states, second[0])
                and torch.equal(field, second[1])
                and np.array_equal(newton, second[2])
                and np.array_equal(krylov, second[3]))
        line = (f"repeatable {label}: steps={states.shape[-3]} newton="
                f"{np.asarray(newton).tolist()} krylov="
                f"{np.asarray(krylov).tolist()} sha256="
                f"{_digest(states, field)}")
        print(f"{line} (two runs in {time.perf_counter() - t0!r} s)",
              flush=True)
        if not same:
            raise AssertionError(
                f"{label}: two runs from one cold start differ: second "
                f"newton {np.asarray(second[2]).tolist()} krylov "
                f"{np.asarray(second[3]).tolist()} sha256 "
                f"{_digest(second[0], second[1])}; {line}")


PORE_NAMES = ["H", "OH", "HCO3", "CO32", "CO2", "CO", "H2", "cat", "p"]
EDL_NAMES = ["H", "OH", "HCO3", "CO32", "CO2", "cat", "p"]


def _states(res, names):
    """(steps + 1, N, f) states from a CLI result's unscaled fields."""
    return np.stack([res["unscaled"][nm] for nm in names], axis=-1)


def _pore_cfg(**kw):
    from gmpnp_tpu_torch.models import pore_3d

    cfg = pore_3d.Pore3DConfig(**PORE_KW)
    lin = {k: kw.pop(k) for k in list(kw) if k in (
        "refresh", "slab_mode", "jac_dtype", "tol")}
    cfg = dataclasses.replace(cfg, **kw)
    return dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, **lin))


def _last_step_residual(prog, hist, step_index):
    """||r|| of the last recorded step at its final state (the Newton
    acceptance quantity)."""
    dev = prog.device
    u_prev = torch.as_tensor(hist[-2], dtype=torch.float64, device=dev)
    u = torch.as_tensor(hist[-1], dtype=torch.float64, device=dev)
    theta = prog._theta_of_carry((u_prev, 0.0), step_index)
    bc = prog._bc_of_theta(theta)
    r = bc.apply_to_residual(
        prog.space.residual(prog.form, u, u_prev, theta), u)
    return float(r.norm())


def checkpoint_paths(dev_name):
    """Phase 4b: checkpoint/resume through the CLIs.  Pore (exact, then
    carried): 2 steps checkpointed every step, then 4 steps from the same
    directory (only steps 2-3 run), against an uninterrupted 4-step run.
    EDL (exact, H_OHP controller on): 5 + 5 steps against 10."""
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.testing import rel_l2

    launches = {}
    pore_cli = importlib.import_module("gmpnp_tpu_torch.cli.pore_3d")
    edl_cli = importlib.import_module("gmpnp_tpu_torch.cli.edl_1d")
    prog = None
    for refresh in ("iter", "carried"):
        ck = os.path.join(OUT, "checkpoints", f"pore_3d_{refresh}")
        res = {}
        for tag, n, n_run, extra in (
                ("uninterrupted", 4, 4, []),
                ("first", 2, 2, ["--checkpoint_dir", ck,
                                 "--checkpoint_every", "1"]),
                ("resumed", 4, 2, ["--checkpoint_dir", ck,
                                   "--checkpoint_every", "1"])):
            argv = [*SLICE, "--linear_refresh", refresh, "--n_steps", str(n),
                    "--out_root", os.path.join(OUT, "checkpoint_runs",
                                               f"{refresh}_{tag}"),
                    "--device", dev_name, *extra]
            label = f"checkpoint pore_3d {refresh} {tag}"
            launches[label], res[tag], _ = run_path(
                label, "pore_3d", lambda: pore_cli.main(argv), n_run, 9,
                full=True)
        full = _states(res["uninterrupted"], PORE_NAMES)
        resumed = _states(res["resumed"], PORE_NAMES)
        if sorted(os.listdir(ck)) != ["1", "2", "3", "4"]:
            raise AssertionError(f"checkpoints {os.listdir(ck)}")
        dist = rel_l2(resumed[-1], full[-1])
        line = (f"checkpoint pore_3d {refresh}: resumed run took steps 2-3 "
                f"({resumed.shape[0] - 1} records), final state "
                f"{dist!r} from the uninterrupted run")
        if refresh == "iter":
            print(line, flush=True)
            if not dist <= 1e-12:
                raise AssertionError(line)
            exact_final = full[-1]
        else:
            if prog is None:
                prog = pore_3d.build(_pore_cfg(), device=dev_name)
            # every step converged (run_path checks it); the resume stops
            # at another point inside the Newton tolerance, as far from
            # the uninterrupted carried run as that run is from exact
            print(f"{line}; {rel_l2(full[-1], exact_final)!r} between the "
                  f"uninterrupted carried and exact runs; resumed step 3 "
                  f"residual {_last_step_residual(prog, resumed, 3)!r} "
                  f"(Newton atol {prog.config.newton.atol})", flush=True)

    # what one checkpoint costs: the L50R5 state saved (copied to the
    # host, written, moved into place) and read back onto the card
    from gmpnp_tpu_torch.io.checkpoint import TransientCheckpointer
    state = torch.as_tensor(full[-1], dtype=torch.float64, device=dev_name)
    ckt = TransientCheckpointer(os.path.join(OUT, "checkpoints", "timing"))
    save_ms = [_timed(lambda i=i: ckt.save(i, (state, 0.0)))[1]
               for i in range(1, 6)]
    load_ms = [_timed(lambda: ckt.latest(device=dev_name))[1]
               for _ in range(5)]
    print(f"checkpoint of the L50R5 state ({state.numel() * 8} bytes): save "
          f"ms median {float(np.median(save_ms))!r} (of {save_ms}), load ms "
          f"median {float(np.median(load_ms))!r}", flush=True)

    ck = os.path.join(OUT, "checkpoints", "edl_1d")
    res = {}
    for tag, n, n_run, extra in (
            ("uninterrupted", 10, 10, []),
            ("first", 5, 5, ["--checkpoint_dir", ck,
                             "--checkpoint_every", "5"]),
            ("resumed", 10, 5, ["--checkpoint_dir", ck,
                                "--checkpoint_every", "5"])):
        argv = ["--dry_run", "Y", "--L_n", str(EDL_L_N), "--H_OHP", "1.1",
                "--n_steps", str(n), "--out_root",
                os.path.join(OUT, "checkpoint_runs", f"edl_{tag}"),
                "--device", dev_name, *extra]
        label = f"checkpoint edl_1d {tag}"
        launches[label], res[tag], _ = run_path(
            label, "edl_1d", lambda: edl_cli.main(argv), n_run, 0, full=True)
    dist = rel_l2(_states(res["resumed"], EDL_NAMES)[-1],
                  _states(res["uninterrupted"], EDL_NAMES)[-1])
    cur = [res[tag]["metadata"]["current_H"]
           for tag in ("resumed", "uninterrupted")]
    line = (f"checkpoint edl_1d: resumed 5 + 5 steps, final state {dist!r} "
            f"from the uninterrupted 10, proton current {cur[0]!r} vs "
            f"{cur[1]!r}")
    print(line, flush=True)
    if not (dist <= 1e-12 and cur[0] == cur[1]):
        raise AssertionError(line)
    return launches


def _sweep(label, fn, n_steps, n_lanes):
    """One sweep: launch counts set to 0 before and read after; a line per
    lane with its per-step ms, Newton iterations, host syncs and
    launches."""
    from gmpnp_tpu_torch import sync
    from gmpnp_tpu_torch.parallel import sweep

    steps = []
    _zero_launches()
    s0, t0 = sync.SYNCS, time.perf_counter()
    with timed_steps(sweep, steps):
        u, stats = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    print(f"path {label}: lanes={n_lanes} n_steps={n_steps} wall_s={wall!r} "
          f"host_syncs={sync.SYNCS - s0} launches={launches}", flush=True)
    if len(steps) != n_lanes * n_steps:
        raise AssertionError(f"{label}: {len(steps)} step records")
    for i in range(n_lanes):
        lane = steps[i * n_steps:(i + 1) * n_steps]
        print(f"  lane {i}: ms/step {[round(st['ms'], 1) for st in lane]} "
              f"newton {[st['newton'] for st in lane]} host_syncs "
              f"{sum(st['host_syncs'] for st in lane)} launches "
              f"{[st['launches'] for st in lane]}", flush=True)
    if not (np.all(stats.converged) and torch.isfinite(u).all()):
        raise AssertionError(f"{label}: not converged or not finite")
    return launches, u, stats


def sweep_paths(dev_name):
    """Phase 4c: voltage sweeps (pore carried at L50R5, EDL at L_n = 50 um)
    and a voltage x cation sweep; each lane against the single-lane sweep
    of its voltage (1e-12) and against the model's own run at that voltage
    under the sweep's Newton settings (1e-5: another Dirichlet blend)."""
    from gmpnp_tpu_torch.models import edl_1d, pore_3d
    from gmpnp_tpu_torch.parallel import sweep
    from gmpnp_tpu_torch.testing import rel_l2

    launches = {}
    cfg = _pore_cfg(refresh="carried")
    volts, n = [-0.5, -1.0, -1.5], 2
    info = {}
    launches["sweep pore_3d"], u, _ = _sweep(
        "sweep pore_3d", lambda: sweep.run_pore_voltage_sweep(
            cfg, volts, n_steps=n, device=dev_name, info=info), n, len(volts))
    if info != {"chunk": 0, "refresh": "carried"}:
        raise AssertionError(f"pore sweep ran {info}")
    for i, v in enumerate(volts):
        u1, _ = sweep.run_pore_voltage_sweep(cfg, [v], n_steps=n,
                                             device=dev_name)
        c = dataclasses.replace(cfg, voltage_multiplier=v,
                                newton=sweep._sweep_newton(cfg.newton))
        _, _, st, up = pore_3d.build(c, device=dev_name).run(n_steps=n)
        d1 = rel_l2(u[i, -1].cpu().numpy(), u1[0, -1].cpu().numpy())
        d2 = rel_l2(u[i, -1].cpu().numpy(), up.cpu().numpy())
        line = (f"sweep pore_3d lane {v}: {d1!r} from its single-lane sweep, "
                f"{d2!r} from Pore3DProgram.run (DirichletBC)")
        print(line, flush=True)
        if not (d1 <= 1e-12 and d2 <= 1e-5 and np.all(st.converged)):
            raise AssertionError(line)

    ecfg = edl_1d.EDL1DConfig(L_n=EDL_L_N)
    volts, n = [-0.5, -1.0, -2.0], 3
    launches["sweep edl_1d"], u, _ = _sweep(
        "sweep edl_1d", lambda: sweep.run_edl_voltage_sweep(
            ecfg, volts, n_steps=n, device=dev_name), n, len(volts))
    ell = launches["sweep edl_1d"]["ell_spmv"]
    if ell["float32"] or ell["float64"]:
        raise AssertionError("the EDL sweep (all-f64 CR) launched a "
                             "block-ELL kernel")
    for i, v in enumerate(volts):
        u1, _ = sweep.run_edl_voltage_sweep(ecfg, [v], n_steps=n,
                                            device=dev_name)
        c = dataclasses.replace(ecfg, voltage_multiplier=v, backtracking=4,
                                newton=sweep._sweep_newton(ecfg.newton))
        _, h, st, _ = edl_1d.build(c, device=dev_name).run(n_steps=n)
        d1 = rel_l2(u[i, -1].cpu().numpy(), u1[0, -1].cpu().numpy())
        d2 = rel_l2(u[i, -1].cpu().numpy(), h[-1].cpu().numpy())
        line = (f"sweep edl_1d lane {v}: {d1!r} from its single-lane sweep, "
                f"{d2!r} from EDL1DProgram.run (DirichletBC)")
        print(line, flush=True)
        if not (d1 <= 1e-12 and d2 <= 1e-5 and np.all(st.converged)):
            raise AssertionError(line)

    steps = []
    _zero_launches()
    t0 = time.perf_counter()
    with timed_steps(sweep, steps):
        out = sweep.run_pore_voltage_cation_sweep(
            cfg, [-0.5, -1.0], cations=("K", "Cs"), n_steps=2,
            device=dev_name)
    torch.cuda.synchronize()
    launches["sweep pore_3d cations"] = _launches()
    print(f"path sweep pore_3d cations K, Cs x lanes -0.5, -1.0 x 2 steps: "
          f"wall_s={time.perf_counter() - t0!r} launches="
          f"{launches['sweep pore_3d cations']}", flush=True)
    for i, st in enumerate(steps):
        print(f"  cation {('K', 'Cs')[i // 4]} lane {(i // 2) % 2} step "
              f"{i % 2}: " + json.dumps(st), flush=True)
    for cat, (u, st) in out.items():
        if not (np.all(st.converged) and torch.isfinite(u).all()):
            raise AssertionError(f"cation sweep {cat}")
    return launches


@contextlib.contextmanager
def timed_lane_steps(steps_log):
    """Wraps the sweeps' run_transient_lanes so that each batched step ends
    in a synchronize and records wall ms, each lane's Newton and Krylov
    iterations, host syncs and kernel launches (per kernel and shape)."""
    from gmpnp_tpu_torch import sync
    from gmpnp_tpu_torch.parallel import sweep

    orig = sweep.run_transient_lanes

    def timed_run(step, *args, **kw):
        def timed(*a):
            torch.cuda.synchronize()
            l0, s0 = _launches(), sync.SYNCS
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            st = out[1]
            steps_log.append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "newton": st.newton_iters.tolist(),
                "linear": st.linear_iters.tolist(),
                "converged": st.converged.tolist(),
                "host_syncs": sync.SYNCS - s0,
                "launches": _step_launches(l0, key="shape")})
            return out
        return orig(timed, *args, **kw)

    sweep.run_transient_lanes = timed_run
    try:
        yield
    finally:
        sweep.run_transient_lanes = orig


def batched_sweep(label, fn, seq_fn, volts, n_steps, chunk, bar,
                  newton_gap=0):
    """One batched sweep (``chunk`` lanes a batch) against the same lanes
    run one at a time (``chunk=0``, the same linear settings): launch
    counts set to 0 before each and read after; per-step and per-lane
    lines, ms per step and per lane-step beside the one-at-a-time run's,
    host syncs per step, peak device memory.  Each lane within ``bar``
    (relative L2 over its whole history) of its one-at-a-time run, Newton
    counts within ``newton_gap`` of its, the same converged flags, and
    every step after the cold first one converged.  (Under
    ``refresh='step'`` the modified Newton of a deep lane's cold step may
    spend its 50 iterations: the -1.5 V pore lane does at L50R5 and at
    (3, 40), in both modes, as the reference's downgraded sweep does on its
    test meshes.  Such a lane's iterates at the budget are not a solution
    and take the roundings of either mode, so its distance is printed and
    not held to ``bar``.)"""
    from gmpnp_tpu_torch import sync
    from gmpnp_tpu_torch.parallel import sweep
    from gmpnp_tpu_torch.testing import rel_l2

    V = len(volts)
    runs = {}
    for mode, run in (("batched", fn), ("chunk0", seq_fn)):
        steps = []
        _zero_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s0, t0 = sync.SYNCS, time.perf_counter()
        timer = (timed_lane_steps(steps) if mode == "batched"
                 else timed_steps(sweep, steps))
        with timer:
            u, stats = run()
        torch.cuda.synchronize()
        runs[mode] = {
            "wall_s": time.perf_counter() - t0, "steps": steps,
            "host_syncs": sync.SYNCS - s0, "launches": _launches(),
            "peak_bytes": torch.cuda.max_memory_allocated(), "u": u,
            "stats": stats}
    b, c = runs["batched"], runs["chunk0"]
    n_batches = -(-V // chunk)
    if len(b["steps"]) != n_batches * n_steps or len(c["steps"]) != (
            V * n_steps):
        raise AssertionError(f"{label}: {len(b['steps'])} batched and "
                             f"{len(c['steps'])} single step records")
    ms_b = [st["ms"] for st in b["steps"]]
    ms_c = [st["ms"] for st in c["steps"]]
    print(f"path {label}: lanes={V} chunk={chunk} n_steps={n_steps} "
          f"batched wall_s={b['wall_s']!r} ms/step {[round(t, 1) for t in ms_b]} "
          f"ms/lane-step {sum(ms_b) / (V * n_steps)!r} host_syncs/step "
          f"{b['host_syncs'] / (n_batches * n_steps)!r} peak_bytes "
          f"{b['peak_bytes']} launches={b['launches']}; chunk=0 wall_s="
          f"{c['wall_s']!r} ms/lane-step {sum(ms_c) / (V * n_steps)!r} "
          f"host_syncs/lane-step {c['host_syncs'] / (V * n_steps)!r} "
          f"peak_bytes {c['peak_bytes']} launches={c['launches']}",
          flush=True)
    for i, st in enumerate(b["steps"]):
        print(f"  batched step {i}: " + json.dumps(st), flush=True)
    failed = []
    for v, volt in enumerate(volts):
        lane_c = c["steps"][v * n_steps:(v + 1) * n_steps]
        d = rel_l2(b["u"][v].cpu().numpy(), c["u"][v].cpu().numpy())
        nb = b["stats"].newton_iters[v]
        nc = c["stats"].newton_iters[v]
        line = (f"  lane {volt}: {d!r} from its chunk=0 run; newton "
                f"{nb.tolist()} (chunk=0 {nc.tolist()}), krylov "
                f"{b['stats'].linear_iters[v].tolist()} (chunk=0 "
                f"{c['stats'].linear_iters[v].tolist()}), converged "
                f"{b['stats'].converged[v].tolist()} (chunk=0 "
                f"{c['stats'].converged[v].tolist()}), chunk=0 ms/step "
                f"{[round(st['ms'], 1) for st in lane_c]}")
        print(line, flush=True)
        converged = np.all(b["stats"].converged[v])
        if not ((d <= bar or not converged)
                and np.abs(nb - nc).max() <= newton_gap
                and np.array_equal(b["stats"].converged[v],
                                   c["stats"].converged[v])
                and np.all(b["stats"].converged[v][1:])):
            failed.append(line)
    if failed:
        raise AssertionError(f"{label}: {failed}")
    return b["launches"], b["u"]


def batched_sweep_paths(dev_name):
    """Phase 4c, batched lanes (the reference's chunk vmap modes): the
    GMPNP pore at L50R5 with chunk=3 (the carried config downgraded to
    refresh='step', as the reference does), the EDL at L_n = 50 um with
    chunk=3, and the pore at the (3, 40) mesh (N=1,517) with the default
    chunk (_auto_chunk batches every lane under 2,000 vertices), each
    against its lanes run with chunk=0 and the same linear settings.  Bars:
    the pore 1e-4 relative L2 and Newton counts within 1 (its f32 slab
    preconditioner, batched, rounds otherwise, so the f64 GMRES stops at
    tol 1e-6 at another point and Newton stops at another point inside its
    tolerance 1e-4: 1.4e-5 apart with one more iteration on the (2, 8)
    mesh on the CPU), the EDL 1e-10 (all-f64 CR) with the same Newton
    counts."""
    from gmpnp_tpu_torch.models import edl_1d
    from gmpnp_tpu_torch.parallel import sweep

    launches = {}
    cfg = _pore_cfg(refresh="carried")
    cfg_step = _pore_cfg(refresh="step")
    volts = [-0.5, -1.0, -1.5]
    # the first lane-batched run of a process pays one-time costs (~12 s
    # at L50R5 in the first batched step, against ~2.8 s in a second run
    # in the same process): one untimed batched step at this size first
    t0 = time.perf_counter()
    sweep.run_pore_voltage_sweep(cfg, volts, n_steps=1, chunk=LANES,
                                 device=dev_name)
    sweep.run_edl_voltage_sweep(edl_1d.EDL1DConfig(L_n=EDL_L_N), volts,
                                n_steps=1, chunk=LANES, device=dev_name)
    torch.cuda.synchronize()
    print(f"batched sweeps: untimed warm-up (one batched step of the pore "
          f"at L50R5 and of the EDL) {time.perf_counter() - t0!r} s",
          flush=True)
    info = {}
    launches["sweep pore_3d batched"], u = batched_sweep(
        "sweep pore_3d batched L50R5",
        lambda: sweep.run_pore_voltage_sweep(
            cfg, volts, n_steps=3, chunk=LANES, device=dev_name, info=info),
        lambda: sweep.run_pore_voltage_sweep(
            cfg_step, volts, n_steps=3, chunk=0, device=dev_name),
        volts, 3, LANES, 1e-4, newton_gap=1)
    if info != {"chunk": LANES, "refresh": "step"}:
        raise AssertionError(f"batched pore sweep ran {info}")
    key = f"{LANES}x{u.shape[2]}x15x9 float64"
    if not launches["sweep pore_3d batched"]["ell_spmv"]["shapes"].get(key):
        raise AssertionError(f"the batched pore sweep launched no {key}")

    ecfg = edl_1d.EDL1DConfig(L_n=EDL_L_N)
    evolts = [-0.5, -1.0, -2.0]
    launches["sweep edl_1d batched"], _ = batched_sweep(
        "sweep edl_1d batched L_n=50um",
        lambda: sweep.run_edl_voltage_sweep(
            ecfg, evolts, n_steps=5, chunk=LANES, device=dev_name),
        lambda: sweep.run_edl_voltage_sweep(
            ecfg, evolts, n_steps=5, chunk=0, device=dev_name),
        evolts, 5, LANES, 1e-10)

    small = dataclasses.replace(cfg, mesh_resolution=BATCHED_SMALL_MESH)
    small_step = dataclasses.replace(cfg_step,
                                     mesh_resolution=BATCHED_SMALL_MESH)
    info = {}
    launches["sweep pore_3d batched small"], _ = batched_sweep(
        "sweep pore_3d batched (3, 40) default chunk",
        lambda: sweep.run_pore_voltage_sweep(
            small, volts, n_steps=3, device=dev_name, info=info),
        lambda: sweep.run_pore_voltage_sweep(
            small_step, volts, n_steps=3, chunk=0, device=dev_name),
        volts, 3, LANES, 1e-4, newton_gap=1)
    if info != {"chunk": LANES, "refresh": "step"}:
        raise AssertionError(f"the (3, 40) sweep ran {info}")
    launches.update(batched_kind_paths(dev_name))
    return launches


#: the batched sweeps of every other linear kind (phase 4c): (label, model,
#: LinearConfig fields, model config fields, steps, bar, Newton gap).
#: Bars: f64 solves 1e-10 with the same Newton counts; a kind that solves
#: in f32 (or preconditions in f32: the slab factorization) 1e-4 with
#: Newton counts within 1, since its batched f32 products round otherwise
#: than single ones and Newton stops at another point inside its
#: tolerance.  The pore's Krylov kinds run the staged first step
#: (dt_first_scale 1e-3) at L50R5, where the single-lane f64 solves
#: converge in every Newton iteration (at the full first dt the cold-start
#: Krylov solves stall at L50R5, ROADMAP queue 3), f32 GMRES at
#: KRYLOV_F32_MESH; the dense kind runs at the (2, 8) mesh only (a test
#: kind: (N f)^2 dense matrices).  The f64 Krylov kinds solve to 1e-10:
#: each lane's Krylov arithmetic is its single-lane solve's, but the
#: lane-batched residual and Jacobian (vmapped element products) round
#: otherwise on the card, and at tol 1e-8 BiCGStab + SSOR carries that
#: into states 1e-10 to 2e-9 apart from chunk=0's.
BATCHED_KINDS = [
    ("edl_1d tridiag_thomas", "edl", dict(kind="tridiag_thomas"), {}, 1,
     1e-10, 0),
    ("edl_1d tridiag_mp_solve f32", "edl", dict(solve_dtype="f32"), {}, 3,
     1e-4, 1),
    ("pore_3d slab cr", "pore", dict(slab_mode="cr", refresh="step"), {}, 2,
     1e-4, 1),
    ("pore_3d gmres block_jacobi f32", "pore",
     dict(kind="gmres", precond="block_jacobi", solve_dtype="f32", tol=1e-5,
          maxiter=1000),
     dict(dt_first_scale=1e-3, mesh_resolution=KRYLOV_F32_MESH), 1, 1e-4,
     1),
    ("pore_3d bicgstab ssor f64", "pore",
     dict(kind="bicgstab", precond="ssor", tol=1e-10, maxiter=2000),
     dict(dt_first_scale=1e-3), 1, 1e-10, 0),
    ("pore_3d gmres amg f64", "pore",
     dict(kind="gmres", precond="amg", tol=1e-10, maxiter=1000),
     dict(dt_first_scale=1e-3), 1, 1e-10, 0),
    ("pore_3d dense (2, 8)", "pore", dict(kind="dense"),
     dict(mesh_resolution=(2, 8)), 1, 1e-10, 0),
]


def batched_kind_paths(dev_name):
    """Phase 4c, every linear kind batched: each BATCHED_KINDS sweep with
    chunk=3 against its lanes run with chunk=0 (``batched_sweep``)."""
    from gmpnp_tpu_torch.models import edl_1d
    from gmpnp_tpu_torch.parallel import sweep

    launches = {}
    for label, model, lin, extra, n, bar, gap in BATCHED_KINDS:
        if model == "edl":
            cfg = edl_1d.EDL1DConfig(L_n=EDL_L_N, **extra)
            run, volts = sweep.run_edl_voltage_sweep, [-0.5, -1.0, -2.0]
        else:
            cfg = dataclasses.replace(_pore_cfg(), **extra)
            run, volts = sweep.run_pore_voltage_sweep, [-0.5, -1.0, -1.5]
        cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
            cfg.linear, **lin))
        launches[f"sweep {label} batched"], _ = batched_sweep(
            f"sweep {label} batched",
            lambda: run(cfg, volts, n_steps=n, chunk=LANES,
                        device=dev_name),
            lambda: run(cfg, volts, n_steps=n, chunk=0, device=dev_name),
            volts, n, LANES, bar, newton_gap=gap)
    return launches


#: (label, kind, preconditioner, solve dtype, tol, maxiter) of the Krylov
#: solves of phase 4d
KRYLOV_SOLVES = [
    ("bicgstab block_jacobi f64", "bicgstab", "block_jacobi", "f64", 1e-6,
     20000),
    ("gmres block_jacobi f32", "gmres", "block_jacobi", "f32", 1e-5, 3000),
    ("gmres ssor f64", "gmres", "ssor", "f64", 1e-6, 3000),
    ("gmres amg f64", "gmres", "amg", "f64", 1e-6, 3000),
    ("gmres amg f32", "gmres", "amg", "f32", 1e-5, 3000),
]


def _cold_start_system(prog):
    """The BC-applied Jacobian and residual at the pore's cold start (the
    system ``--profile`` assembles)."""
    u0 = prog.initial_state()
    theta = prog._theta_of_carry((u0, 0.0), 0)
    bc = prog._bc_of_theta(theta)
    u = bc.project(u0)
    ell = bc.apply_to_jacobian(
        prog.space.jacobian(prog.form, u, u0, theta))
    r = bc.apply_to_residual(
        prog.space.residual(prog.form, u, u0, theta), u)
    return ell, r


def krylov_solve(ell, r, space, amg_plan, kind, precond, dtype, tol,
                 maxiter):
    """One Krylov solve as make_linear_solver runs it; returns the result,
    the system solved (f32: equilibrated) and its true relative residual
    recomputed in f64."""
    from gmpnp_tpu_torch.fem.assembly import BlockELL
    from gmpnp_tpu_torch.ops.ell_spmv import ell_spmv_reference
    from gmpnp_tpu_torch.solve.amg import amg_preconditioner
    from gmpnp_tpu_torch.solve.linear import (
        bicgstab, block_jacobi_preconditioner, gmres,
        multicolor_ssor_preconditioner)
    from gmpnp_tpu_torch.solve.smallblock import block_inv

    if dtype == "f32":
        Dinv = block_inv(ell.diag_blocks())
        ell = ell.scale_rows(Dinv)
        ell = BlockELL(ell.adj, ell.flat.to(torch.float32), ell.diag_slot)
        r = torch.einsum("nfg,ng->nf", Dinv, r).to(torch.float32)
    if precond == "ssor":
        pc = multicolor_ssor_preconditioner(ell, space.colors)
    elif precond == "amg":
        pc = amg_preconditioner(ell, amg_plan)
    else:
        pc = block_jacobi_preconditioner(ell)
    if kind == "gmres":
        res = gmres(ell.matvec, r, Minv=pc, tol=tol, restart=30,
                    maxiter=maxiter)
    else:
        res = bicgstab(ell.matvec, r, Minv=pc, tol=tol, maxiter=maxiter)
    b64 = r.to(torch.float64)
    Ax = ell_spmv_reference(ell.flat.to(torch.float64), ell.adj,
                            res.x.to(torch.float64))
    true = float((b64 - Ax).norm() / b64.norm())
    return res, true


def _small_system(device="cpu"):
    """The (2, 10) pore's cold-start system assembled on ``device``, its
    space and its AMG plan."""
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.solve.amg import AMGPlan

    p = pore_3d.build(_pore_cfg(mesh_resolution=(2, 10)), device=device)
    e, b = _cold_start_system(p)
    return e, b, p.space, AMGPlan.build(np.asarray(p.space.adj),
                                        p.space.n_fields)


def _solve_on(dev, e, b, space, plan, spec):
    """One of KRYLOV_SOLVES on a copy of the system on ``dev``: the result
    and its true relative residual."""
    from gmpnp_tpu_torch.fem.assembly import BlockELL

    e = BlockELL(*(t.to(dev) for t in e))
    return krylov_solve(e, b.to(dev), space, plan, *spec[1:])


def _perturbed(e, seed):
    """The system's Jacobian with every entry scaled by 1 + 1e-15 N(0, 1)
    (torch's CPU generator at ``seed``): a change of the order of assembly
    rounding."""
    g = torch.Generator().manual_seed(seed)
    return e._replace(flat=e.flat * (1 + 1e-15 * torch.randn(
        e.flat.shape, generator=g, dtype=e.flat.dtype)))


#: the phase-4d solve whose iteration count is rounding-bound, and the
#: perturbation seeds whose CPU counts bound the card's on that system
SPREAD_SOLVE = "gmres amg f64"
SPREAD_SEEDS = range(8)


def krylov_spread(dev_name, seeds=SPREAD_SEEDS):
    """--krylov-spread: the (2, 10) f64 GMRES + AMG iteration count on the
    card and on the CPU, for the system assembled on each device and for
    copies of the CPU's whose Jacobian entries are scaled by
    1 + 1e-15 N(0, 1) (one seed each): how far rounding alone moves the
    count that phase 4d compares."""
    spec = next(s for s in KRYLOV_SOLVES if s[0] == SPREAD_SOLVE)
    systems = [(f"assembled on {d}", *_small_system(d))
               for d in ("cpu", dev_name)]
    e, b, space, plan = systems[0][1:]
    for seed in seeds:
        systems.append((f"cpu system, perturbation seed {seed}",
                        _perturbed(e, seed), b, space, plan))
    for label, *system in systems:
        iters = {d: _solve_on(d, *system, spec)[0].iters
                 for d in (dev_name, "cpu")}
        print(f"krylov spread (2,10) {spec[0]} {label}: card "
              f"{iters[dev_name]}, cpu {iters['cpu']}", flush=True)


def krylov_paths(dev_name):
    """Phase 4d: the Krylov fallbacks on the L50R5 cold-start Jacobian, each
    solve's contract checked on its true residual; the same solves of the
    (2, 10) pore's system, assembled on the CPU, on the card and on the
    CPU."""
    from gmpnp_tpu_torch import sync
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.solve.amg import AMGPlan

    launches = {}
    prog = pore_3d.build(_pore_cfg(), device=dev_name)
    space = prog.space
    ell, r = _cold_start_system(prog)
    plan = AMGPlan.build(np.asarray(space.adj), space.n_fields)
    colors = np.asarray(space.colors)
    print(f"krylov system: N={space.num_vertices} K={space.adj.shape[1]} "
          f"f={space.n_fields}; AMG levels "
          f"{[(lv.nagg, lv.coarse_adj.shape[1]) for lv in plan.levels]}, "
          f"coarsest dense solve {plan.levels[-1].nagg * space.n_fields} "
          f"dofs; SSOR {colors.max() + 1} colors, largest "
          f"{np.bincount(colors).max()}", flush=True)
    torch.cuda.synchronize()
    for label, kind, precond, dtype, tol, maxiter in KRYLOV_SOLVES:
        _zero_launches()
        s0, t0 = sync.SYNCS, time.perf_counter()
        res, true = krylov_solve(ell, r, space, plan, kind, precond, dtype,
                                 tol, maxiter)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[f"krylov {label}"] = _launches()
        line = (f"path krylov {label}: iterations={res.iters} converged="
                f"{res.converged} true_rel_residual={true!r} tol={tol} "
                f"ms={ms!r} host_syncs={sync.SYNCS - s0} launches="
                f"{launches[f'krylov {label}']}")
        print(line, flush=True)
        if res.converged and not true <= 1.5 * tol:
            raise AssertionError(f"converged above 1.5 x tol: {line}")
        if not res.converged and res.iters < maxiter and kind == "gmres":
            raise AssertionError(f"GMRES stopped early unconverged: {line}")
        if launches[f"krylov {label}"]["ell_spmv"][
                "float32" if dtype == "f32" else "float64"] <= 0:
            raise AssertionError(f"no kernel launch: {line}")

    small_krylov_checks(dev_name)
    return launches


def small_krylov_checks(dev_name):
    """Phase 4d's KRYLOV_SOLVES of the (2, 10) pore's cold-start system on
    the card and on the CPU."""
    # the (2, 10) system is assembled once, on the CPU, and both devices
    # solve the same bits: assembly rounding of order 1e-15 alone moves the
    # f64 AMG count by more than a 10% bar (--krylov-spread).  That solve's
    # card count must fall inside the range of the CPU's counts on the
    # system and on SPREAD_SEEDS' perturbed copies of it; the other four
    # keep the 10% bar.  Every solve: the same converged flag on both
    # devices; the spread solve's true residual, where it converged, within
    # 1.5 x tol on both.
    e, b, space, pl = _small_system()
    small = {dev: [_solve_on(dev, e, b, space, pl, spec)
                   for spec in KRYLOV_SOLVES] for dev in (dev_name, "cpu")}
    for spec, (rd, td), (rc, tc) in zip(KRYLOV_SOLVES, small[dev_name],
                                        small["cpu"]):
        tol = spec[4]
        line = (f"krylov (2,10) {spec[0]}: card {rd.iters} {rd.converged} "
                f"true_rel_residual={td!r}, cpu {rc.iters} {rc.converged} "
                f"true_rel_residual={tc!r}")
        if spec[0] == SPREAD_SOLVE:
            t0 = time.perf_counter()
            counts = [rc.iters] + [
                _solve_on("cpu", _perturbed(e, seed), b, space, pl,
                          spec)[0].iters for seed in SPREAD_SEEDS]
            lo, hi = min(counts), max(counts)
            line += (f"; cpu counts on the system and its perturbed copies "
                     f"(seeds {SPREAD_SEEDS.start}-{SPREAD_SEEDS.stop - 1}) "
                     f"{counts}: card inside [{lo}, {hi}] "
                     f"({len(SPREAD_SEEDS)} cpu solves in "
                     f"{time.perf_counter() - t0!r} s)")
            within = lo <= rd.iters <= hi and all(
                t <= 1.5 * tol for r, t in ((rd, td), (rc, tc))
                if r.converged)
        else:
            within = abs(rd.iters - rc.iters) <= max(1, rc.iters // 10)
            line += "; card within 10% of cpu"
        print(line, flush=True)
        if not within or rd.converged != rc.converged:
            raise AssertionError(line)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def newton_mode_paths(dev_name):
    """Phase 4e: one exact Newton step with BiCGStab against slab_direct;
    slab_mode='cr' against Thomas; jac_dtype='f32'; refresh='auto' through
    the CLI."""
    from gmpnp_tpu_torch import sync
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.solve import slab
    from gmpnp_tpu_torch.solve.timeloop import (
        LinearConfig, make_implicit_step)
    from gmpnp_tpu_torch.testing import rel_l2

    launches = {}
    # BiCGStab exact step (tests/test_slab.py's settings) against the
    # slab_direct one: at L50R5 when one cold-start BiCGStab solve to 1e-10
    # converges within 20,000 iterations (reported), and at that test's own
    # (L=100 nm, R=10 nm, (2, 8)), where its bar is held
    prog = pore_3d.build(_pore_cfg(), device=dev_name)
    ell, r = _cold_start_system(prog)
    probe, true = krylov_solve(ell, r, prog.space, None, "bicgstab",
                               "block_jacobi", "f64", 1e-10, 20000)
    print(f"bicgstab L50R5 cold-start solve to 1e-10: iterations="
          f"{probe.iters} converged={probe.converged} true_rel_residual="
          f"{true!r}", flush=True)
    progs = [("L50R5", prog)] if probe.converged else []
    progs.append(("test_slab", pore_3d.build(pore_3d.Pore3DConfig(
        L=100e-9, R=10e-9, mesh_resolution=(2, 8)), device=dev_name)))
    for where, prog in progs:
        cfg = prog.config
        theta = {"dt": prog.dt_scaled,
                 "co2_s1": prog.eq_conc["CO2"] / prog.bulk_conc["CO2"]}
        u0 = prog.initial_state()
        out = {}
        for kind, lin in (("bicgstab", LinearConfig(
                kind="bicgstab", tol=1e-10, maxiter=20000)),
                          ("slab_direct", LinearConfig(kind="slab_direct",
                                                       tol=1e-10))):
            step = make_implicit_step(prog.space, prog.form, cfg.newton, lin,
                                      bc_of_theta=prog._bc_of_theta)
            _zero_launches()
            s0 = sync.SYNCS
            (u, st), ms = _timed(lambda: step(u0, theta))
            label = f"newton step {kind} {where}"
            launches[label] = _launches()
            out[kind] = (u, st)
            print(f"path {label} (N={prog.space.num_vertices}): newton="
                  f"{st.newton_iters} linear={st.linear_iters} converged="
                  f"{st.converged} ms={ms!r} host_syncs={sync.SYNCS - s0} "
                  f"launches={launches[label]}", flush=True)
        (u_k, st_k), (u_d, st_d) = out["bicgstab"], out["slab_direct"]
        err = float(((u_d - u_k).abs() - 2e-6 * u_k.abs()).max())
        ok = (st_k.converged and st_d.converged and err <= 2e-8
              and st_d.newton_iters <= st_k.newton_iters)
        print(f"newton step bicgstab vs slab_direct {where}: max(|du| - "
              f"2e-6|u|) = {err!r} (bar 2e-8), rel_l2 "
              f"{rel_l2(u_k.cpu().numpy(), u_d.cpu().numpy())!r}: "
              f"{'held' if ok else 'missed'}", flush=True)
        if where == "test_slab" and not ok:
            raise AssertionError("bicgstab step vs slab_direct step")

    # slab_mode='cr' against Thomas, and f32 element Jacobians, 2 exact
    # steps each at L50R5; CR against Thomas at the model's linear tol 1e-6
    # (the two f32 factorizations precondition GMRES differently, so the
    # runs stop at different points inside the Newton tolerance: printed)
    # and at linear tol 1e-10, where the 1e-6 bar is held
    prog = pore_3d.build(_pore_cfg(), device=dev_name)
    ell, _ = _cold_start_system(prog)
    plan = slab.SlabPlan.build(
        np.asarray(prog.space.adj), np.asarray(prog.space.points)[:, -1],
        prog.space.n_fields, np.asarray(prog.space.diag_slot))
    runs = {}
    for label, kw in (("thomas", {}), ("cr", {"slab_mode": "cr"}),
                      ("jac f32", {"jac_dtype": "f32"}),
                      ("thomas tol 1e-10", {"tol": 1e-10}),
                      ("cr tol 1e-10", {"slab_mode": "cr", "tol": 1e-10})):
        p = pore_3d.build(_pore_cfg(**kw), device=dev_name)
        steps = []
        _zero_launches()
        with timed_steps(pore_3d, steps):
            _, _, st, u = p.run(n_steps=2)
        launches[f"exact {label}"] = _launches()
        runs[label] = (st, u)
        print(f"path exact {label} 2 steps: newton "
              f"{np.asarray(st.newton_iters).tolist()} launches "
              f"{launches[f'exact {label}']}", flush=True)
        for i, rec in enumerate(steps):
            print(f"  step {i}: " + json.dumps(rec), flush=True)
        if not np.all(st.converged):
            raise AssertionError(f"exact {label} not converged")
    slab.full_f32_precision()
    factor_ms = {}
    for mode in ("thomas", "cr"):
        slab.slab_prepare(ell, plan, mode=mode)
        factor_ms[mode] = float(np.median(
            [_timed(lambda: slab.slab_prepare(ell, plan, mode=mode))[1]
             for _ in range(3)]))
    dist = {}
    for tag in ("", " tol 1e-10"):
        (st_t, u_t), (st_c, u_c) = runs[f"thomas{tag}"], runs[f"cr{tag}"]
        dist[tag] = rel_l2(u_c.cpu().numpy(), u_t.cpu().numpy())
        if not np.array_equal(st_c.newton_iters, st_t.newton_iters):
            raise AssertionError(f"cr vs thomas{tag}: Newton iterations")
    line = (f"slab_mode cr vs thomas: newton "
            f"{runs['cr'][0].newton_iters.tolist()} vs "
            f"{runs['thomas'][0].newton_iters.tolist()}, states "
            f"{dist['']!r} apart at linear tol 1e-6 and "
            f"{dist[' tol 1e-10']!r} at 1e-10 (bar 1e-6); slab_prepare ms "
            f"thomas {factor_ms['thomas']!r} cr {factor_ms['cr']!r}")
    print(line, flush=True)
    if not dist[" tol 1e-10"] <= 1e-6:
        raise AssertionError(line)
    st_t, u_t = runs["thomas"]
    st_f, u_f = runs["jac f32"]
    print(f"jac_dtype f32: newton {st_f.newton_iters.tolist()} vs f64 "
          f"{st_t.newton_iters.tolist()}, states "
          f"{rel_l2(u_f.cpu().numpy(), u_t.cpu().numpy())!r} apart",
          flush=True)

    cli = importlib.import_module("gmpnp_tpu_torch.cli.pore_3d")
    argv = [*SLICE, "--linear_refresh", "auto", "--n_steps", "3",
            "--out_root", os.path.join(OUT, "pore_3d", "auto"),
            "--device", dev_name]
    launches["pore_3d auto"], res, _ = run_path(
        "pore_3d auto", "pore_3d", lambda: cli.main(argv), 3, 9, full=True)
    cal = res["metadata"].get("refresh_calibration")
    print(f"refresh auto: {cal}", flush=True)
    if not cal or cal["mode"] not in ("carried", "iter"):
        raise AssertionError(f"refresh_calibration {cal}")
    return launches


SHARD_RANKS = 4             # ranks of the sharded phase, all on one card
SHARD_NEWTON_TOL, SHARD_KRYLOV_TOL = 1e-9, 1e-10
SHARD_MID_MESH = (3, 40)    # N=1,517


def _tensor_bytes(leaves):
    return sum(t.numel() * t.element_size() for t in leaves)


@contextlib.contextmanager
def timed_shard_steps(steps_log):
    """Wraps parallel.shard.make_sharded_step so that each sharded step
    (a retry is a step of its own) ends in a synchronize and records wall
    ms, Newton and Krylov iterations, host syncs, ranks and devices, peak
    device memory, the carried state's bytes per rank and kernel
    launches."""
    from gmpnp_tpu_torch import sync
    from gmpnp_tpu_torch.parallel import shard

    orig = shard.make_sharded_step

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        step, group = out[0], out[-1]

        def timed(*a):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            l0 = _launches()
            s0, t0 = sync.SYNCS, time.perf_counter()
            res = step(*a)
            torch.cuda.synchronize()
            st = res[1]
            rec = {"ms": (time.perf_counter() - t0) * 1e3,
                   "newton": int(st[0]), "krylov": int(st[3]),
                   "converged": bool(st[1]),
                   "host_syncs": sync.SYNCS - s0, "ranks": group.n,
                   "devices": sorted({str(d) for d in group.devices}),
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "launches": _step_launches(l0)}
            if len(res) == 3:
                dev, rep = res[2]
                rec["carry_bytes_per_rank"] = [
                    _tensor_bytes(d) + _tensor_bytes(r)
                    for d, r in zip(dev, rep)]
            steps_log.append(rec)
            return res

        return (timed,) + tuple(out[1:])

    shard.make_sharded_step = wrapped
    try:
        yield
    finally:
        shard.make_sharded_step = orig


def shard_path(label, fn):
    """One sharded path: launch counts set to 0 before it and read after
    it, a path line and a line per sharded step.  Returns (launches, fn's
    result, steps)."""
    from gmpnp_tpu_torch import sync

    steps = []
    _zero_launches()
    s0, t0 = sync.SYNCS, time.perf_counter()
    with timed_shard_steps(steps):
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    newton = sum(st["newton"] for st in steps)
    krylov = sum(st["krylov"] for st in steps)
    syncs = sync.SYNCS - s0
    print(f"path {label}: wall_s={wall!r} steps={len(steps)} "
          f"newton_total={newton} krylov_total={krylov} host_syncs={syncs} "
          f"syncs_per_krylov={syncs / max(krylov, 1)!r} "
          f"launches={launches}", flush=True)
    for i, st in enumerate(steps):
        print(f"  step {i}: " + json.dumps(st), flush=True)
    return launches, out, steps


def _band_bytes_per_rank(prog, n_ranks):
    """The distributed SPIKE solver's per-rank band tables and f64 band
    sums, reckoned from the plans before a run."""
    from gmpnp_tpu_torch.parallel import shard

    cfg = prog.config
    plan = shard.ZShardPlan.build(
        prog.mesh, cfg.n_fields, n_ranks, prog.bc.mask.cpu().numpy(),
        prog.bc.values.cpu().numpy(), quad_degree=cfg.quad_degree)
    markers = [m for m in plan.facets if prog.form.boundary.get(m)]
    pp = shard.SlabPrecondPlan.build(plan, facet_markers=markers)
    n_dest, n_pairs, f = pp.start.shape[1], pp.order.shape[1], pp.f
    return plan, pp, {"band_sums_f64": n_dest * f * f * 8,
                      "tables_int64": (2 * n_dest + n_pairs) * 8,
                      "band_f32": pp.S * pp.m * 3 * pp.m * 4,
                      "spikes_f32": 2 * pp.S * pp.m * pp.h * 4,
                      "seam_blocks_f32": 3 * (n_ranks - 1) * (2 * pp.h) ** 2
                      * 4}


def shard_paths(dev_name):
    """Phase 4f: z-slab domain decomposition (parallel.shard), four ranks
    sharing the card.  The pore CLI with --shard 1 (3 carried steps); the
    sharded carried transient at L50R5 on 4 ranks (3 steps, Newton tol
    1e-9, Krylov 1e-10) against the single-device carried run at the same
    tolerances (1e-6); one exact step with the replicated seam twice
    (bitwise equal) and with seam='ring' (1e-7); BiCGStab + block-Jacobi
    and max_retries at the (3, 40) mesh, 1 step each; _run_sharded with a
    checkpoint directory, 2 steps then resumed to 4, against an
    uninterrupted 4-step sharded run (equal)."""
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.parallel import shard
    from gmpnp_tpu_torch.solve.timeloop import NewtonConfig
    from gmpnp_tpu_torch.testing import rel_l2

    launches = {}
    dev = torch.device(dev_name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    ranks = [dev] * SHARD_RANKS
    tight = NewtonConfig(max_iter=50, rtol=SHARD_NEWTON_TOL,
                         atol=SHARD_NEWTON_TOL, relaxation=0.9)
    tight_kw = {"krylov_tol": SHARD_KRYLOV_TOL, "krylov_maxiter": 4000}

    cli = importlib.import_module("gmpnp_tpu_torch.cli.pore_3d")
    argv = [*SLICE, "--linear_refresh", "carried", "--n_steps", "3",
            "--shard", "1", "--out_root", os.path.join(OUT, "shard_cli"),
            "--device", dev_name]
    launches["pore_3d --shard 1"], res, _ = shard_path(
        "pore_3d --shard 1 carried", lambda: cli.main(argv))
    check_outputs(res, 3, 9)

    prog = pore_3d.build(_pore_cfg(refresh="carried", tol=SHARD_KRYLOV_TOL,
                                   newton=tight), device=dev_name)
    plan, pp, reckoned = _band_bytes_per_rank(prog, SHARD_RANKS)
    print(f"sharded plan at N={plan.N}, {SHARD_RANKS} ranks: N_p={plan.N_p} "
          f"H={plan.H} cells per rank={plan.cells_l.shape[1]} S={pp.S} "
          f"m_v={pp.m_v} m={pp.m} h_v={pp.h_v} h={pp.h} pad={pp.pad}; "
          f"reckoned bytes per rank {reckoned} (sum "
          f"{sum(reckoned.values())})", flush=True)

    def carried_run():
        run, u0, _ = shard.make_sharded_pore_transient(
            prog, ranks, n_steps=3, refresh="carried", **tight_kw)
        return run(u0)

    label = f"sharded carried L50R5 {SHARD_RANKS} ranks"
    launches[label], ((u_sh, _), st), _ = shard_path(label, carried_run)
    _, _, st1, u1 = prog.run(n_steps=3)
    dist = rel_l2(u_sh.cpu().numpy(), u1.cpu().numpy())
    line = (f"sharded carried vs single-device carried (3 steps, Newton tol "
            f"{SHARD_NEWTON_TOL}): newton {np.asarray(st[0]).tolist()} vs "
            f"{np.asarray(st1.newton_iters).tolist()}, krylov "
            f"{np.asarray(st[3]).tolist()} vs "
            f"{np.asarray(st1.linear_iters).tolist()}, rel_l2 {dist!r} "
            f"(bar 1e-6)")
    print(line, flush=True)
    if not (np.asarray(st[1]).all() and np.asarray(st1.converged).all()
            and dist <= 1e-6):
        raise AssertionError(line)

    prog_x = pore_3d.build(_pore_cfg(tol=SHARD_KRYLOV_TOL, newton=tight),
                           device=dev_name)
    exact = {}
    for tag, seam in (("replicated", "replicated"),
                      ("replicated again", "replicated"), ("ring", "ring")):
        def one_step(seam=seam):
            run, u0, _ = shard.make_sharded_pore_transient(
                prog_x, ranks, n_steps=1, refresh="iter", seam=seam,
                **tight_kw)
            return run(u0)

        label = f"sharded exact step L50R5 seam {tag}"
        launches[label], ((u, _), st), _ = shard_path(label, one_step)
        if not np.asarray(st[1]).all():
            raise AssertionError(f"{label}: not converged")
        exact[tag] = u
    same = torch.equal(exact["replicated"], exact["replicated again"])
    ring = rel_l2(exact["ring"].cpu().numpy(),
                  exact["replicated"].cpu().numpy())
    line = (f"sharded exact step: two replicated-seam runs bitwise equal "
            f"{same}; ring seam {ring!r} from the replicated (bar 1e-7)")
    print(line, flush=True)
    if not (same and ring <= 1e-7):
        raise AssertionError(line)

    prog_m = pore_3d.build(_pore_cfg(mesh_resolution=SHARD_MID_MESH),
                           device=dev_name)
    mid = {}
    for tag, kw in (("slab_direct", {}),
                    ("bicgstab_jacobi", {"linear": "bicgstab_jacobi",
                                         "krylov_maxiter": 20000})):
        def one_step(kw=kw):
            run, u0, _ = shard.make_sharded_pore_transient(
                prog_m, ranks, n_steps=1, **kw)
            return run(u0)

        label = f"sharded exact step {SHARD_MID_MESH} {tag}"
        launches[label], ((u, _), st), _ = shard_path(label, one_step)
        if not np.asarray(st[1]).all():
            raise AssertionError(f"{label}: not converged")
        mid[tag] = u
    dist = rel_l2(mid["bicgstab_jacobi"].cpu().numpy(),
                  mid["slab_direct"].cpu().numpy())
    print(f"sharded {SHARD_MID_MESH} bicgstab_jacobi vs slab_direct step: "
          f"rel_l2 {dist!r}", flush=True)

    def forced_retry():
        # a Newton budget of 2 at tol 1e-10 fails at any dt: the step is
        # retried once at dt/2 (the carried factors rebuilt there)
        run, u0, _ = shard.make_sharded_pore_transient(
            prog_m, ranks, n_steps=1, refresh="carried", newton_max_iter=2,
            newton_rtol=1e-10, newton_atol=1e-10, max_retries=1)
        return run(u0)

    label = f"sharded max_retries {SHARD_MID_MESH}"
    launches[label], ((u, _), st), _ = shard_path(label, forced_retry)
    line = (f"{label}: dt_scale {np.asarray(st[4]).tolist()} converged "
            f"{np.asarray(st[1]).tolist()}")
    print(line, flush=True)
    if not (np.asarray(st[4]).tolist() == [0.5]
            and bool(torch.isfinite(u).all())):
        raise AssertionError(line)

    cfg_c = _pore_cfg()
    prog_c = pore_3d.build(cfg_c, device=dev_name)
    ck = os.path.join(OUT, "checkpoints", "shard")
    runs = {}
    for tag, n, kw in (("uninterrupted", 4, {}),
                       ("first", 2, {"checkpoint_dir": ck,
                                     "checkpoint_every": 1}),
                       ("resumed", 4, {"checkpoint_dir": ck,
                                       "checkpoint_every": 1})):
        label = f"sharded checkpoint {tag} ({n} steps)"
        launches[label], runs[tag], _ = shard_path(
            label, lambda n=n, kw=kw: pore_3d._run_sharded(
                prog_c, cfg_c, SHARD_RANKS, n_steps=n, record_stride=1,
                devices=ranks, **kw))
    u_full, u_res = runs["uninterrupted"][3], runs["resumed"][3]
    if sorted(os.listdir(ck)) != ["1", "2", "3", "4"]:
        raise AssertionError(f"checkpoints {os.listdir(ck)}")
    line = (f"sharded checkpoint: resumed 2 + 2 steps "
            f"({runs['resumed'][1].shape[0]} records) bitwise equal to the "
            f"uninterrupted 4: "
            f"{torch.equal(u_res, u_full)} (rel_l2 "
            f"{rel_l2(u_res.cpu().numpy(), u_full.cpu().numpy())!r})")
    print(line, flush=True)
    if not torch.equal(u_res, u_full):
        raise AssertionError(line)
    return launches


def _card_vs_cpu(label, cfg, dev_name, bar):
    """A 3-step run of a pore config on the card and on the CPU: the same
    Newton iterations, and the states within ``bar`` when one is given."""
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.testing import rel_l2

    out = {}
    for dev in (dev_name, "cpu"):
        _, _, stats, u = pore_3d.build(cfg, device=dev).run(n_steps=3)
        out[dev] = (np.asarray(stats.newton_iters), u.cpu().numpy(),
                    bool(np.asarray(stats.converged).all()))
    (it_d, u_d, ok_d), (it_c, u_c, ok_c) = out[dev_name], out["cpu"]
    rel = rel_l2(u_d, u_c)
    print(f"cuda vs cpu {label} (2,10) carried 3 steps: newton "
          f"{it_d.tolist()} vs {it_c.tolist()}, rel_l2 {rel!r}", flush=True)
    if (not (ok_d and ok_c) or not np.array_equal(it_d, it_c)
            or (bar is not None and rel > bar)):
        raise AssertionError(f"cuda vs cpu parity failed: {label}")


def _golden(name, data, rtol, converged):
    from gmpnp_tpu_torch.testing import GoldenFile

    msg = GoldenFile(os.path.join(ROOT, "tests", "goldens", name),
                     rtol=rtol).check(data)
    print(f"golden {name} (cuda): {'match' if msg is None else msg}",
          flush=True)
    if msg is not None or not converged:
        raise AssertionError(f"golden check failed: {name}: {msg}")


def checks(dev_name):
    """Phase 5: card vs CPU through the port, and the goldens."""
    from gmpnp_tpu_torch.models import edl_1d, pore_3d, rxn_diff_1d
    from gmpnp_tpu_torch.solve.timeloop import LinearConfig, NewtonConfig
    from gmpnp_tpu_torch.testing import field_summary

    def carried(cfg):
        return dataclasses.replace(cfg, linear=dataclasses.replace(
            cfg.linear, refresh="carried"))

    gmpnp = pore_3d.Pore3DConfig(mesh_resolution=(2, 10))
    rxn = pore_3d.Pore3DConfig(physics="rxn_diff", mesh_resolution=(2, 10))
    _card_vs_cpu("gmpnp", carried(gmpnp), dev_name, 1e-6)
    # at the production tolerance the f32 chord directions, rounded
    # differently on the card, reach another point inside the Newton
    # tolerance (H moves most); the state bar holds at tight tolerances
    _card_vs_cpu("rxn_diff", carried(rxn), dev_name, None)
    _card_vs_cpu("rxn_diff tight", dataclasses.replace(
        rxn, newton=NewtonConfig(max_iter=50, rtol=1e-11, atol=1e-11,
                                 relaxation=0.9),
        linear=LinearConfig(kind="slab_direct", tol=1e-12,
                            refresh="carried")), dev_name, 1e-6)

    for cfg, golden in ((gmpnp, "pore_3d_gmpnp_3steps.json"),
                        (rxn, "pore_3d_rxn_diff_3steps.json")):
        _, _, stats, u = pore_3d.build(cfg, device=dev_name).run(n_steps=3)
        names = list(cfg.species) + (["p"] if cfg.physics == "GMPNP" else [])
        _golden(golden, {"fields": field_summary(u.cpu().numpy(), names)},
                5e-4, bool(np.asarray(stats.converged).all()))

    rd = rxn_diff_1d.build(rxn_diff_1d.RxnDiff1DConfig(L_n=1e-6),
                           device=dev_name)
    _, hist, stats = rd.run(n_steps=5)
    edl = edl_1d.build(edl_1d.EDL1DConfig(L_n=1e-6), device=dev_name)
    _, hist_e, stats_e, _ = edl.run(n_steps=5)
    for golden, h, st, names in (
            ("rxn_diff_1d_5steps.json", hist, stats, rxn_diff_1d.SPECIES),
            ("edl_1d_mpnp_5steps.json", hist_e, stats_e,
             list(edl.config.species) + ["p"])):
        _golden(golden, {
            "fields": field_summary(h[-1].cpu().numpy(), names),
            "newton_iters": int(np.asarray(st.newton_iters).sum())},
            1e-7, bool(np.asarray(st.converged).all()))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_calls(dev, mesh_resolution=None, reps=5):
    """Median host-clock ms of each layer's call at the cold start (state
    at bulk, first step's theta), each call ended by a synchronize, with
    the host syncs it made; the Jacobian's peak device memory.  Then the
    lane-batched layers at three lanes (the batched sweep's voltages) and
    the f32 inverse of one slab's three blocks, batched against one call
    per block."""
    from gmpnp_tpu_torch import sync
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.solve.slab import (
        SlabPlan, SlabPrepared, full_f32_precision, slab_apply,
        slab_apply_f32, slab_factor_fused, slab_prepare, slab_solve)
    from gmpnp_tpu_torch.solve.smallblock import block_inv

    full_f32_precision()
    cfg = pore_3d.Pore3DConfig(L=50e-9, R=5e-9,
                               mesh_resolution=mesh_resolution)
    prog = pore_3d.build(cfg, device=dev)
    space, form = prog.space, prog.form
    u0 = prog.initial_state()
    theta = prog._theta_of_carry((u0, 0.0), 0)
    bc = prog._bc_of_theta(theta)
    u = bc.project(u0)
    plan = SlabPlan.build(np.asarray(space.adj),
                          np.asarray(space.points)[:, -1], space.n_fields,
                          np.asarray(space.diag_slot))
    r = bc.apply_to_residual(space.residual(form, u, u0, theta), u)
    ell = bc.apply_to_jacobian(space.jacobian(form, u, u0, theta))
    Dinv0 = block_inv(ell.diag_blocks())
    ell_eq = ell.scale_rows(Dinv0)
    prep = SlabPrepared(ell_eq=ell_eq, Dinv0=Dinv0,
                        factors=slab_factor_fused(ell_eq, plan))
    r32 = plan.to_slabs(r.to(torch.float32))
    calls = [
        ("FemSpace.residual", lambda: space.residual(form, u, u0, theta)),
        ("FemSpace.jacobian", lambda: space.jacobian(form, u, u0, theta)),
        ("block_inv (diagonal blocks)",
         lambda: block_inv(ell.diag_blocks())),
        ("BlockELL.scale_rows", lambda: ell.scale_rows(Dinv0)),
        ("slab_factor_fused", lambda: slab_factor_fused(ell_eq, plan)),
        ("slab_solve", lambda: slab_solve(prep.factors, r32)),
        ("slab_apply_f32 tol 1e-6",
         lambda: slab_apply_f32(prep, r, plan, tol=1e-6, max_refine=16)),
        ("slab_apply f64 tol 1e-6",
         lambda: slab_apply(prep, r, plan, tol=1e-6, max_refine=40)),
    ]
    # the lane-batched layers, 3 lanes of the same cold start (the
    # batched sweep's -0.5 / -1.0 / -1.5 V), and the f32 inverse of one
    # slab's 3 blocks as one batched call against one call per block
    from gmpnp_tpu_torch.solve.slab import _inv_refined
    from gmpnp_tpu_torch.solve.smallblock import lane_by_lane
    from gmpnp_tpu_torch.solve.timeloop import stack_lane_theta

    thetas = []
    for volt in (-0.5, -1.0, -1.5):
        thetas.append(dict(theta, voltage=volt))
    lth = stack_lane_theta(thetas, dev)
    U = u0.expand((LANES,) + tuple(u0.shape)).clone()
    lbc = prog.bc.arith().set_value_arith(prog.s1_verts, prog.idx["CO2"],
                                          lth["co2_s1"])
    Ul = lbc.project(U)
    lell = lbc.apply_to_jacobian(space.jacobian_lanes(form, Ul, U, lth))
    lprep = slab_prepare(lell, plan)
    lr = lbc.apply_to_residual(space.residual_lanes(form, Ul, U, lth), Ul)
    blocks = lprep.factors.Dinv[:, 0].contiguous()
    calls += [
        ("FemSpace.residual_lanes (3 lanes)",
         lambda: space.residual_lanes(form, Ul, U, lth)),
        ("FemSpace.jacobian_lanes (3 lanes)",
         lambda: space.jacobian_lanes(form, Ul, U, lth)),
        ("slab_prepare (1 lane)",
         lambda: slab_prepare(ell, plan)),
        ("slab_prepare_lanes (3 lanes)",
         lambda: slab_prepare(lell, plan)),
        ("slab_apply_lanes f64 tol 1e-6 (3 lanes)",
         lambda: slab_apply(lprep, lr, plan, tol=1e-6, max_refine=40)),
        ("torch.linalg.inv of 3 f32 slab blocks, one batched call",
         lambda: torch.linalg.inv(blocks)),
        ("torch.linalg.inv of 3 f32 slab blocks, one call each",
         lambda: [torch.linalg.inv(b) for b in blocks]),
        ("_inv_refined_lanes of 3 f32 slab blocks",
         lambda: lane_by_lane(_inv_refined, True, blocks)),
    ]
    print(f"profile: N={space.num_vertices} K={space.adj.shape[1]} "
          f"S={plan.S} m={plan.m}", flush=True)
    for name, fn in calls:
        out = fn()
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        times = []
        s0 = sync.SYNCS
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        extra = ""
        if hasattr(out, "iters"):
            extra += f" gmres_iters={out.iters}"
        if name.startswith("FemSpace.jacobian") and dev.type == "cuda":
            extra += (f" peak_bytes="
                      f"{torch.cuda.max_memory_allocated(dev)}")
        print(f"  call {name}: ms={float(np.median(times))!r} host_syncs="
              f"{(sync.SYNCS - s0) // reps}{extra}", flush=True)


@contextlib.contextmanager
def plain_route():
    """FemSpace's segment sums and pore element residuals, the solvers'
    block inverses and the 1D CR apply through the torch ops the kernels
    replaced (the plain versions; FemSpace's vmapped element loop for the
    element residuals), for comparing the two routes inside one run."""
    from gmpnp_tpu_torch.fem import assembly
    from gmpnp_tpu_torch.ops import block_inv_reference, segment_sum_reference
    from gmpnp_tpu_torch.solve import smallblock

    space = assembly.FemSpace
    saved = (assembly.segment_sum_op, smallblock._block_inv,
             space.uses_residual_kernel)
    assembly.segment_sum_op = segment_sum_reference
    smallblock._block_inv = block_inv_reference
    space.uses_residual_kernel = lambda self, form, device: False
    try:
        with cr_plain_route():
            yield
    finally:
        (assembly.segment_sum_op, smallblock._block_inv,
         space.uses_residual_kernel) = saved


def profile_hot_paths(dev, reps=5):
    """The calls the segment-sum, block_inv and pore residual kernels
    serve, through the kernels and through the torch ops they replaced
    (``plain_route``), in turns (plain, kernel,
    kernel, plain): FemSpace.residual and .jacobian at the L=50 nm, R=5 nm
    pore's cold start (GMPNP), and the fused f64 1D CR solve and the f32
    CR factorization on the EDL cold-start Jacobian at L_n = 50 um.  Per
    call: host-clock ms (median of ``reps``, synchronized) and the device
    operations one call issues (torch.profiler: kernels, copies and
    fills)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gmpnp_tpu_torch.models import edl_1d, pore_3d
    from gmpnp_tpu_torch.solve.linear import (
        block_tridiag_factor_cr, block_tridiag_from_ell,
        block_tridiag_solve_cr)

    prog = pore_3d.build(pore_3d.Pore3DConfig(**PORE_KW), device=dev)
    space, form = prog.space, prog.form
    u0 = prog.initial_state()
    theta = prog._theta_of_carry((u0, 0.0), 0)
    u = prog._bc_of_theta(theta).project(u0)
    eprog = edl_1d.build(edl_1d.EDL1DConfig(L_n=EDL_L_N), device=dev)
    e0 = eprog.initial_state()
    eth = eprog._theta_of_carry((e0, 0.0), 0)
    eu = eprog.bc.project(e0)
    ell = eprog.bc.apply_to_jacobian(eprog.space.jacobian(eprog.form, eu, e0,
                                                          eth))
    rhs = eprog.bc.apply_to_residual(
        eprog.space.residual(eprog.form, eu, e0, eth), eu)
    tri = block_tridiag_from_ell(ell)
    tri32 = [t.to(torch.float32) for t in tri]
    calls = [
        ("FemSpace.residual (GMPNP L50R5)",
         lambda: space.residual(form, u, u0, theta)),
        ("FemSpace.jacobian (GMPNP L50R5)",
         lambda: space.jacobian(form, u, u0, theta)),
        (f"block_tridiag_solve_cr f64 (EDL N={ell.flat.shape[0]})",
         lambda: block_tridiag_solve_cr(*tri, rhs)),
        ("block_tridiag_factor_cr f32 (EDL)",
         lambda: block_tridiag_factor_cr(*tri32)),
    ]
    for name, fn in calls:
        out = {}
        for route in ("plain", "kernel", "kernel", "plain"):
            ctx = plain_route() if route == "plain" else (
                contextlib.nullcontext())
            with ctx:
                fn()
                _sync(dev)
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    fn()
                    _sync(dev)
                    times.append((time.perf_counter() - t0) * 1e3)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    fn()
                    _sync(dev)
            ops_n = sum(1 for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
            out.setdefault(route, []).append((float(np.median(times)),
                                              ops_n))
        print(f"  hot call {name}: " + json.dumps(
            {route: {"ms": [t for t, _ in v],
                     "device_ops_per_call": [n for _, n in v]}
             for route, v in out.items()}), flush=True)


def profile_steps(dev, mesh_resolution=None, top=12):
    """Device time over wall for 5 carried steps (after one warm run), 2
    exact steps and 2 steps of the batched pore sweep (3 lanes, chunk=3,
    refresh='step'; after one warm batched step), from torch.profiler,
    with the largest kernels' shares."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.parallel import sweep

    cfg = pore_3d.Pore3DConfig(L=50e-9, R=5e-9,
                               mesh_resolution=mesh_resolution)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def model_run(refresh):
        c = dataclasses.replace(cfg, linear=dataclasses.replace(
            cfg.linear, refresh=refresh))
        prog = pore_3d.build(c, device=dev)
        return lambda n: prog.run(n_steps=n)[2]

    def batched_run(n):
        # the carried config, downgraded to refresh='step' by chunk != 0
        c = dataclasses.replace(cfg, linear=dataclasses.replace(
            cfg.linear, refresh="carried"))
        return sweep.run_pore_voltage_sweep(
            c, [-0.5, -1.0, -1.5], n_steps=n, chunk=LANES, device=dev)[1]

    for label, run, n in (("refresh=carried", model_run("carried"), 5),
                          ("refresh=iter", model_run("iter"), 2),
                          ("batched sweep chunk=3 refresh=step",
                           batched_run, 2)):
        run(1)
        _sync(dev)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            stats = run(n)
            _sync(dev)
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        dev_us = {e.key: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
                  for e in kernels}
        total = sum(dev_us.values()) / 1e3
        print(f"profile {label} n_steps={n}: wall_ms={wall!r} "
              f"device_ms={total!r} busy_share="
              f"{total / wall if wall else 0.0!r} newton="
              f"{np.asarray(stats.newton_iters).tolist()}", flush=True)
        for k in sorted(dev_us, key=dev_us.get, reverse=True)[:top]:
            print(f"  {dev_us[k] / 1e3 / total if total else 0.0:.4f} "
                  f"{dev_us[k] / 1e3!r} ms {k[:110]}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", action="store_true",
                   help="profile the main path in place of phases 3-5")
    p.add_argument("--kernel-times", action="store_true",
                   help="time the kernel at the main path's shape in place "
                        "of phases 3-5")
    p.add_argument("--krylov-spread", action="store_true",
                   help="phase 4d's (2, 10) f64 AMG iteration counts under "
                        "rounding perturbations, in place of phases 3-5")
    p.add_argument("--package-root", default=None,
                   help="directory that holds the gmpnp_tpu_torch to load "
                        "(default: beside this script)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    from gmpnp_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch: {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build: {lib} in {time.perf_counter() - t0!r} s", flush=True)
    print(_build.BUILD_LOG.strip(), flush=True)

    if args.kernel_times:
        from gmpnp_tpu_torch import ops

        kernel_times_only(dev)
        if hasattr(ops, "segment_sum"):   # not in checkouts before them
            check_hot_kernels(dev, library=False)
        print(card_line(), flush=True)
        return 0

    if args.krylov_spread:
        krylov_spread("cuda")
        print(card_line(), flush=True)
        return 0

    if args.profile:
        profile_calls(dev)
        profile_hot_paths(dev)
        profile_steps(dev)
        print(card_line(), flush=True)
        return 0

    shutil.rmtree(OUT, ignore_errors=True)
    t0 = time.perf_counter()
    records = check_kernels(dev)
    hot = check_hot_kernels(dev)
    cr_apply_episodes("cuda")
    print(f"phase 3 kernels: {time.perf_counter() - t0!r} s", flush=True)
    launches = {}
    for phase in (main_path, repeat_paths, checkpoint_paths, sweep_paths,
                  batched_sweep_paths, krylov_paths, newton_mode_paths,
                  shard_paths, checks):
        t0 = time.perf_counter()
        launches.update(phase("cuda") or {})
        print(f"phase {phase.__name__}: {time.perf_counter() - t0!r} s",
              flush=True)

    kernels = kernel_records(records, hot, launches)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
