"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: the CUDA kernels compiled from ``gmpnp_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of every path of phase 4 (the L=50 nm, R=5 nm pore: N=2,501,
   K=15, f=9 for GMPNP, the f=9 kernel, and f=7 for reaction-diffusion,
   the generic-f kernel; the 1D EDL model at L_n=50 um: N=5,991, K=3, f=7)
   and at an edge shape (N=1,000, K=7, f=3), in turns (plain, kernel,
   kernel, plain): median times over 30
   CUDA-event-timed calls (host launch cost included); device time per
   call from a replayed CUDA graph, hot (one matrix, re-read from L2) and
   cold (each launch reads another copy of the matrix, at least 256 MB of
   copies in rotation, so every read comes from device memory); the bound
   computed from the shapes and the share of it the cold time reaches; one
   library call (``torch.sparse_bsr_tensor @ x``) timed the same way as a
   yardstick; the device time of a one-tile launch as the floor; and
   ragged, single-neighbour and misaligned shapes for correctness and
   bitwise repeatability only;
4. the paths, each with every launch count set to 0 before it and read
   after it; per-step wall time, Newton and linear iterations, host syncs
   and kernel launches; outputs present and finite:
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
R=5 nm pore: the time of each layer's call at the cold start, and a
``torch.profiler`` window over carried and exact steps with the device's
busy share and its largest kernels.

    python3 chip_smoke.py --kernel-times [--package-root DIR]

runs phases 1-2 and the timings of phase 3 at the main path's shape only,
with ``gmpnp_tpu_torch`` taken from DIR (default: beside this script).  To
compare two commits on one card, unpack the other one with ``git archive``
into an ignored directory and run on the card, one after the other: other,
this, this, other.
"""

import argparse
import contextlib
import dataclasses
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
EDL_L_N = 50e-6                 # the 1D models' default system size
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
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


def spmv_bound(N, K, f, dtype):
    """The least time the card could take for one product: every input read
    once and the output written once over the memory rate, or the
    operations over the peak rate of their type, whichever is larger."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = N * f * K * f * size + N * K * 4 + 2 * N * f * size
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * N * f * K * f / PEAK_FLOPS[dtype]
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
    and returns the record."""
    from gmpnp_tpu_torch.ops.ell_spmv import ell_spmv, ell_spmv_reference

    N, f, Kf = flat.shape
    K = Kf // f
    bound = spmv_bound(N, K, f, flat.dtype)
    copies = -(-COLD_ROTATION_BYTES // (flat.numel() * flat.element_size()))
    flats = [flat] + [flat.clone() for _ in range(copies - 1)]
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
    if library:
        rec.update(library_times(flats, adj, x,
                                 ell_spmv_reference(flat, adj, x)))
    print(f"kernel ell_spmv {label} N={N} K={K} f={f} {flat.dtype}: "
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


def edl_adj(dev):
    """The adjacency of the 1D models' mesh at L_n=50 um."""
    from gmpnp_tpu_torch.fem.assembly import FemSpace
    from gmpnp_tpu_torch.models import base

    mesh = base.interval_mesh_marked("variable", EDL_L_N)
    return FemSpace.build(mesh, 7, quad_degree=3, device=dev).dev["adj"]


#: (record name, phase-3 label, dtype, phase-4 path whose launches it
#: counts) of every record in the kernels line
KERNEL_RECORDS = [
    ("ell_spmv_f32", "slice", torch.float32, "pore_3d carried"),
    ("ell_spmv_f64", "slice", torch.float64, "pore_3d iter"),
    ("ell_spmv_f32_rxn_diff_3d", "rxn_diff_3d", torch.float32,
     "rxn_diff_3d carried"),
    ("ell_spmv_f64_rxn_diff_3d", "rxn_diff_3d", torch.float64,
     "rxn_diff_3d iter"),
    ("ell_spmv_f64_edl_1d", "edl_1d", torch.float64, "tridiag_mp_solve"),
]


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

    records = {}
    both = (torch.float32, torch.float64)
    pore = slice_adj(dev)
    for label, adj, f, dtypes in (("slice", pore, 9, both),
                                  ("rxn_diff_3d", pore, 7, both),
                                  ("edl_1d", edl_adj(dev), 7,
                                   (torch.float64,)),
                                  ("edge", random_adj(1000, 7), 3, both)):
        for dtype in dtypes:
            flat, x = random_operands(rng, adj, f, dtype)
            rel, err = compare(label, flat, adj, x)
            rec = kernel_times(label, flat, adj, x)
            print(f"  rel_l2={rel!r} max_abs_err={err!r}", flush=True)
            if label != "edge":
                records[label, dtype] = {
                    "shape": [adj.shape[0], adj.shape[1], f],
                    "max_abs_err": err, **rec, "floor_us": floor[dtype]}

    # correctness and repeatability only: ragged last tiles, one neighbour,
    # widths on both kernels, and a matrix that is not 16-byte aligned
    shapes = [(N, 1, f) for N in (1, 3, 4, 5) for f in (1, 8, 9)]
    shapes += [(53, 15, 8), (130, 31, 9), (2501, 15, 9), (1000, 7, 3),
               (2501, 15, 7), (5991, 3, 7), (5991, 3, 5)]
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
    """--kernel-times: the main path's shape, both types, no library call."""
    rng = np.random.default_rng(2024)
    adj = slice_adj(dev)
    for dtype in (torch.float32, torch.float64):
        flat, x = random_operands(rng, adj, 9, dtype)
        kernel_times("slice", flat, adj, x, library=False)


@contextlib.contextmanager
def timed_steps(model, steps_log):
    """Wraps the model's run_transient so that each step ends in a
    synchronize and records wall ms, iterations, host syncs and kernel
    launches."""
    from gmpnp_tpu_torch import ops, sync

    orig = model.run_transient

    def timed_run_transient(step, *args, **kw):
        def timed(*a):
            torch.cuda.synchronize()
            l0 = dict(ops.LAUNCHES)
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
                "launches": {str(k).replace("torch.", ""): v - l0[k]
                             for k, v in ops.LAUNCHES.items()}})
            return out
        return orig(timed, *args, **kw)

    model.run_transient = timed_run_transient
    try:
        yield
    finally:
        model.run_transient = orig


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


def _launches():
    from gmpnp_tpu_torch import ops

    return {str(k).replace("torch.", ""): v for k, v in ops.LAUNCHES.items()}


def _zero_launches():
    from gmpnp_tpu_torch import ops

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0


def run_path(label, model_name, fn, n_steps, n_vtk):
    """One path: launch counts set to 0 before it and read after it."""
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
    return launches


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
    if not res.converged or launches["float64"] <= 0:
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
        if launches[label][dtype] <= 0:
            raise AssertionError(f"{label} launched no {dtype} kernel")
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
    the host syncs it made; the Jacobian's peak device memory."""
    from gmpnp_tpu_torch import sync
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.solve.slab import (
        SlabPlan, SlabPrepared, full_f32_precision, slab_apply,
        slab_apply_f32, slab_factor_fused, slab_solve)
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
        if name == "FemSpace.jacobian" and dev.type == "cuda":
            extra += (f" peak_bytes="
                      f"{torch.cuda.max_memory_allocated(dev)}")
        print(f"  call {name}: ms={float(np.median(times))!r} host_syncs="
              f"{(sync.SYNCS - s0) // reps}{extra}", flush=True)


def profile_steps(dev, mesh_resolution=None, top=12):
    """Device time over wall for 5 carried steps (after one warm run) and 2
    exact steps, from torch.profiler, with the largest kernels' shares."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gmpnp_tpu_torch.models import pore_3d

    cfg = pore_3d.Pore3DConfig(L=50e-9, R=5e-9,
                               mesh_resolution=mesh_resolution)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for refresh, n in (("carried", 5), ("iter", 2)):
        c = dataclasses.replace(cfg, linear=dataclasses.replace(
            cfg.linear, refresh=refresh))
        prog = pore_3d.build(c, device=dev)
        prog.run(n_steps=1)
        _sync(dev)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _, _, stats, _ = prog.run(n_steps=n)
            _sync(dev)
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        dev_us = {e.key: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
                  for e in kernels}
        total = sum(dev_us.values()) / 1e3
        print(f"profile refresh={refresh} n_steps={n}: wall_ms={wall!r} "
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
        kernel_times_only(dev)
        print(card_line(), flush=True)
        return 0

    if args.profile:
        profile_calls(dev)
        profile_steps(dev)
        print(card_line(), flush=True)
        return 0

    shutil.rmtree(OUT, ignore_errors=True)
    records = check_kernels(dev)
    launches = main_path("cuda")
    checks("cuda")

    kernels = [
        {"name": name, "route": "cuda",
         "source": "gmpnp_tpu_torch/csrc/ell_spmv.cu",
         "replaces": "gmpnp_tpu/ops/ell_spmv.py:70", "path": path,
         "launches": launches[path][str(dtype).replace("torch.", "")],
         **records[label, dtype]}
        for name, label, dtype, path in KERNEL_RECORDS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
