"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: the CUDA kernels compiled from ``gmpnp_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (the L=50 nm, R=5 nm pore: N=2,501, K=15, f=9)
   and at an edge shape: median times over 30 CUDA-event-timed calls
   (host launch cost included), and device time per call from a replayed
   CUDA graph of 100 calls;
4. main path: ``python -m gmpnp_tpu_torch.cli.pore_3d`` at L=50 nm,
   R=5 nm — 5 steps in carried mode (f32 chord GMRES over the f32 kernel)
   and 2 steps in exact mode (f64 GMRES over the f64 kernel) — with every
   launch count set to 0 before and read after; per-step wall time, Newton
   and linear iterations and host syncs; outputs present and finite;
5. checks: a 3-step carried run on the (2, 10) mesh on the card and on the
   CPU (same Newton iterations, states within 1e-6), and a 3-step exact
   run on the card against the golden ``tests/goldens/pore_3d_gmpnp_3steps
   .json`` at its own tolerance 5e-4.

The last three lines are the kernels record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits non-zero before printing any result.

    python3 chip_smoke.py --profile

runs phases 1-2 and then, in place of 3-5, the profile of the L=50 nm,
R=5 nm pore: the time of each layer's call at the cold start, and a
``torch.profiler`` window over carried and exact steps with the device's
busy share and its largest kernels.
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "out", "chip_smoke")
SLICE = ["--L", "50e-9", "--R", "5e-9"]
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


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


def graph_us(fn, n=100, reps=10) -> float:
    """Device time per call in microseconds: ``n`` calls captured in one
    CUDA graph, replayed ``reps`` times (median), so host launch overhead
    drops out."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
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


def check_kernels(dev):
    """Phase 3: ell_spmv vs its plain version; returns per-dtype records at
    the main path's shape."""
    from gmpnp_tpu_torch.fem.assembly import FemSpace
    from gmpnp_tpu_torch.mesh import cylinder_mesh, pore_boundary_markers
    from gmpnp_tpu_torch.ops.ell_spmv import ell_spmv, ell_spmv_reference

    mesh = pore_boundary_markers(cylinder_mesh(50e-9, 5e-9), 50e-9, 5e-9)
    adj_slice = FemSpace.build(mesh, 9, quad_degree=2, device=dev).dev["adj"]
    rng = np.random.default_rng(2024)
    edge_adj = torch.as_tensor(
        rng.integers(0, 1000, size=(1000, 7)).astype(np.int32), device=dev)
    records = {}
    for label, adj, f in (("slice", adj_slice, 9), ("edge", edge_adj, 3)):
        N, K = adj.shape
        for dtype in (torch.float32, torch.float64):
            flat = torch.as_tensor(rng.normal(size=(N, f, K * f)),
                                   dtype=dtype, device=dev)
            x = torch.as_tensor(rng.normal(size=(N, f)), dtype=dtype,
                                device=dev)
            y = ell_spmv(flat, adj, x)
            ref = ell_spmv_reference(flat, adj, x)
            torch.cuda.synchronize()
            rel = float((y - ref).norm() / ref.norm())
            err = float((y - ref).abs().max())
            ms = time_ms(lambda: ell_spmv(flat, adj, x))
            plain_ms = time_ms(lambda: ell_spmv_reference(flat, adj, x))
            dev_us = graph_us(lambda: ell_spmv(flat, adj, x))
            plain_dev_us = graph_us(lambda: ell_spmv_reference(flat, adj, x))
            print(f"kernel ell_spmv {label} N={N} K={K} f={f} {dtype}: "
                  f"rel_l2={rel!r} max_abs_err={err!r} "
                  f"kernel_ms={ms!r} plain_ms={plain_ms!r} "
                  f"graph_kernel_us={dev_us!r} graph_plain_us="
                  f"{plain_dev_us!r}", flush=True)
            if not rel <= KERNEL_TOL[dtype]:
                raise AssertionError(
                    f"ell_spmv {label} {dtype}: rel_l2 {rel} > "
                    f"{KERNEL_TOL[dtype]}")
            if label == "slice":
                records[dtype] = {"max_abs_err": err, "ms": ms,
                                  "plain_ms": plain_ms}
    return records


def run_cli(argv, steps_log):
    """One CLI run with per-step timing: wraps the model's run_transient so
    each step ends in a synchronize and records wall ms, iterations and
    host syncs."""
    import gmpnp_tpu_torch.models.pore_3d as model
    from gmpnp_tpu_torch import sync
    from gmpnp_tpu_torch.cli import pore_3d as cli

    orig = model.run_transient

    def timed_run_transient(step, *args, **kw):
        def timed(*a):
            torch.cuda.synchronize()
            s0, t0 = sync.SYNCS, time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            st = out[1]
            steps_log.append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "newton": int(st.newton_iters),
                "linear": int(st.linear_iters),
                "converged": bool(st.converged),
                "host_syncs": sync.SYNCS - s0})
            return out
        return orig(timed, *args, **kw)

    model.run_transient = timed_run_transient
    try:
        return cli.main(argv)
    finally:
        model.run_transient = orig


def check_outputs(res, n_steps, n_vertices):
    run_dir = res["run_dir"]
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
    if len(vtu) != 9:
        raise AssertionError(f"expected 9 VTK files, found {vtu}")
    return meta


def main_path(dev_name):
    """Phase 4: the CLI at the slice size, carried then exact."""
    from gmpnp_tpu_torch import ops, sync

    runs = [("carried", 5), ("iter", 2)]
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    per_run = {}
    for refresh, n in runs:
        before = dict(ops.LAUNCHES)
        s0, t0 = sync.SYNCS, time.perf_counter()
        steps = []
        res = run_cli([*SLICE, "--linear_refresh", refresh, "--n_steps",
                       str(n), "--out_root", os.path.join(OUT, refresh),
                       "--device", dev_name], steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        meta = check_outputs(res, n, res["coor_array"].shape[0])
        launches = {str(k).replace("torch.", ""): ops.LAUNCHES[k] - before[k]
                    for k in ops.LAUNCHES}
        per_run[refresh] = launches
        print(f"main path refresh={refresh} n_steps={n}: wall_s={wall!r} "
              f"newton_total={meta['newton_iters_total']} "
              f"linear_total={meta['linear_iters_total']} "
              f"host_syncs={sync.SYNCS - s0} launches={launches}",
              flush=True)
        for i, st in enumerate(steps):
            print(f"  step {i}: " + json.dumps(st), flush=True)
        if len(steps) != n or not all(st["converged"] for st in steps):
            raise AssertionError(f"{refresh}: steps {steps}")
    launches = dict(ops.LAUNCHES)
    print(f"peak device memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)
    if per_run["carried"]["float32"] <= 0:
        raise AssertionError("carried run launched no f32 kernel")
    if per_run["iter"]["float64"] <= 0:
        raise AssertionError("exact run launched no f64 kernel")
    return launches


def checks(dev_name):
    """Phase 5: card vs CPU through the port, and the golden."""
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.testing import GoldenFile, field_summary, rel_l2

    cfg = pore_3d.Pore3DConfig(mesh_resolution=(2, 10))
    carried = dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, refresh="carried"))
    out = {}
    for dev in (dev_name, "cpu"):
        _, _, stats, u = pore_3d.build(carried, device=dev).run(n_steps=3)
        out[dev] = (np.asarray(stats.newton_iters), u.cpu().numpy(),
                    bool(np.asarray(stats.converged).all()))
    (it_d, u_d, ok_d), (it_c, u_c, ok_c) = out[dev_name], out["cpu"]
    rel = rel_l2(u_d, u_c)
    print(f"cuda vs cpu (2,10) carried 3 steps: newton {it_d.tolist()} vs "
          f"{it_c.tolist()}, rel_l2 {rel!r}", flush=True)
    if not (ok_d and ok_c) or not np.array_equal(it_d, it_c) or rel > 1e-6:
        raise AssertionError("cuda vs cpu parity failed")

    _, _, stats, u = pore_3d.build(cfg, device=dev_name).run(n_steps=3)
    names = list(cfg.species) + ["p"]
    msg = GoldenFile(os.path.join(ROOT, "tests", "goldens",
                                  "pore_3d_gmpnp_3steps.json"),
                     rtol=5e-4).check(
        {"fields": field_summary(u.cpu().numpy(), names)})
    print(f"golden pore_3d_gmpnp_3steps (exact, cuda): "
          f"{'match' if msg is None else msg}", flush=True)
    if msg is not None or not bool(np.asarray(stats.converged).all()):
        raise AssertionError(f"golden check failed: {msg}")


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
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gmpnp_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch: {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build: {lib} in {time.perf_counter() - t0!r} s", flush=True)
    print(_build.BUILD_LOG.strip(), flush=True)

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
        {"name": f"ell_spmv_{tag}", "route": "cuda",
         "source": "gmpnp_tpu_torch/csrc/ell_spmv.cu",
         "replaces": "gmpnp_tpu/ops/ell_spmv.py:70",
         "launches": launches[dtype], **records[dtype]}
        for tag, dtype in (("f32", torch.float32), ("f64", torch.float64))]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
