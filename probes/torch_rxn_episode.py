"""The reaction-diffusion pore's whole published episode through the
benchmark cell's program, step by step:

    python probes/torch_rxn_episode.py [--steps 1000] [--device cuda] \
        [--small] [--out out/rxn_episode]

The program is ``rxndiff_pore.carried50``'s (its configuration and
traffic files: carried chord Newton over the f32 slab factor, dt cuts on),
run for ``--steps`` steps (1,000: the published schedule) after a two-step
warm-up. Each step ends in a synchronize; its wall time, Newton and
Krylov iterations, dt factor and the program's counters (abandoned chord
attempts and their iterations, factor builds by reason) are kept. On the
card the episode's device busy time comes from CUPTI
(``benchmark/harness/devicebusy.py``). ``--small`` runs the (2, 10) mesh,
to rehearse on the CPU.

Prints one JSON line (also written to ``<out>/episode.json``): per block
of 100 steps (``blocks``) and for the first 50 steps (``first50``, the
cell's episode) the sums of those numbers, the whole episode's, and each
sum's share in the first 50 steps.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELL = "rxndiff_pore.carried50"
COUNTERS = ("chord.failed", "chord.failed_iters", "chord.failed_krylov",
            "factors.init", "factors.fallback", "factors.refresh")
KEYS = ("steps", "wall_s", "newton", "krylov", "dt_cuts") + COUNTERS


def sums(rows):
    out = dict.fromkeys(KEYS, 0)
    for r in rows:
        out["steps"] += 1
        out["wall_s"] += r["wall_s"]
        out["newton"] += r["newton"]
        out["krylov"] += r["krylov"]
        out["dt_cuts"] += r["dt_scale"] < 1.0
        for k in COUNTERS:
            out[k] += r[k]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--out", default=os.path.join("out", "rxn_episode"))
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from benchmark import run as bench
    from benchmark.harness.program import program_config
    from gmpnp_tpu_torch.utils import profiling

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    wl = bench.load_json("benchmark", "workloads", f"{CELL}.json")
    cfg = bench.load_json("benchmark", "configs", f"{wl['config']}.json")
    if args.small:
        torch.set_num_threads(1)
        cfg["program"]["mesh_resolution"] = [2, 10]
    print(bench.kernel_line(device), file=sys.stderr)
    module, pcfg = program_config(cfg, wl, wl["voltages"][0])
    prog = module.build(pcfg, device=device)
    prog.run(n_steps=2, record_full=False)
    sync()

    rows = []
    orig = module.run_transient

    def timed_loop(step, *a, **kw):
        def timed(*s):
            c0 = dict(profiling.COUNTS)
            t0 = time.perf_counter()
            out = step(*s)
            sync()
            st = out[1]
            row = {"wall_s": time.perf_counter() - t0,
                   "newton": int(np.sum(st.newton_iters)),
                   "krylov": int(np.sum(st.linear_iters)),
                   "dt_scale": float(np.min(st.dt_scale)),
                   "converged": bool(np.all(st.converged))}
            row.update({k: profiling.COUNTS.get(k, 0) - c0.get(k, 0)
                        for k in COUNTERS})
            rows.append(row)
            return out
        return orig(timed, *a, **kw)

    busy = None
    module.run_transient = timed_loop
    try:
        t0 = time.perf_counter()
        if cuda:
            from benchmark.harness import devicebusy

            with devicebusy.Window() as busy:
                prog.run(n_steps=args.steps, record_full=False)
                sync()
        else:
            prog.run(n_steps=args.steps, record_full=False)
        wall = time.perf_counter() - t0
    finally:
        module.run_transient = orig

    whole = sums(rows)
    first = sums(rows[:50])
    result = {
        "cell": CELL, "steps": len(rows),
        "card": torch.cuda.get_device_name(device) if cuda else "cpu",
        "wall_s": wall,
        "device_busy_s": busy.busy_s if busy else None,
        "unconverged": sum(not r["converged"] for r in rows),
        "blocks": [sums(rows[i:i + 100]) for i in range(0, len(rows), 100)],
        "first50": first, "whole": whole,
        "first50_share": {k: first[k] / whole[k] if whole[k] else None
                          for k in KEYS},
        "per_step": {k: [r[k] for r in rows]
                     for k in ("newton", "krylov", "chord.failed")},
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "episode.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "per_step"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
