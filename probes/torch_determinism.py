"""Order-dependent sums on the PyTorch port's paths, and repeat runs.

    python probes/torch_determinism.py [--device cuda] [--small]

1. Op scan.  Runs the paths once under a ``TorchDispatchMode`` that
   records every aten op they dispatch, and prints each op whose CUDA
   kernel adds into its output in an order that can change from run to
   run (atomic adds: ``index_add``, ``scatter_add``, ``index_put`` with
   ``accumulate=True``, ...), with its call count and the port's frame
   that called it.  The ops a path dispatches do not depend on the
   device, so ``--device cpu --small`` lists them in seconds.
2. Repeats.  Runs the GMPNP and reaction-diffusion pores' carried paths
   (5 steps at L=50 nm, R=5 nm, whatever ``--small`` says) twice with
   ``torch.use_deterministic_algorithms`` off and twice with it on
   (``CUBLAS_WORKSPACE_CONFIG=:4096:8``), and prints each run's Newton
   and Krylov counts and a sha256 of its final state and field.  The flag
   only serves the search: the port's paths never set it.

Paths: the GMPNP and reaction-diffusion pores carried (2 steps each), the
EDL exact (2 steps) with its
field projection, the pore's field projection, and a batched GMPNP pore
sweep (chunk=3, 1 step) under each linear kind.  Full size: L=50 nm, R=5
nm and L_n=50 um; ``--small``: the (2, 10) mesh and L_n=1 um.
"""

import argparse
import collections
import dataclasses
import hashlib
import os
import sys
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: aten ops whose CUDA kernels add with atomics (torch's own list of ops
#: that ``use_deterministic_algorithms`` replaces or refuses)
ATOMIC = {"index_add", "index_add_", "scatter_add", "scatter_add_",
          "scatter_reduce", "scatter_reduce_", "index_reduce",
          "index_reduce_", "put_", "put", "bincount", "histc",
          "embedding_dense_backward", "_embedding_bag",
          "_embedding_bag_backward", "segment_reduce"}
#: ops that add only when their ``accumulate`` argument is true
ACCUMULATE = {"index_put", "index_put_", "_index_put_impl_",
              "_unsafe_index_put"}


class OpScan(TorchDispatchMode):
    """Counts the order-dependent ops dispatched, keyed by op and the
    innermost frame of the port that called it."""

    def __init__(self):
        super().__init__()
        self.hits = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        hit = name in ATOMIC
        if name in ACCUMULATE:
            acc = kwargs.get("accumulate", args[3] if len(args) > 3
                             else False)
            hit = bool(acc)
        if hit:
            frame = next((f for f in reversed(traceback.extract_stack())
                          if "gmpnp_tpu_torch" in f.filename), None)
            where = (f"{os.path.relpath(frame.filename)}:{frame.lineno}"
                     if frame else "?")
            self.hits[(name, where)] += 1
        return func(*args, **kwargs)


def paths(dev, small):
    """(label, callable) of every path scanned."""
    from gmpnp_tpu_torch.fem.projection import project_gradient
    from gmpnp_tpu_torch.models import edl_1d, pore_3d
    from gmpnp_tpu_torch.parallel import sweep

    mesh = {"mesh_resolution": (2, 10)} if small else {}
    L_n = 1e-6 if small else 50e-6

    def pore(physics, mesh=mesh, n=2):
        def go():
            cfg = pore_3d.Pore3DConfig(L=50e-9, R=5e-9, physics=physics,
                                       **mesh)
            cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
                cfg.linear, refresh="carried"))
            prog = pore_3d.build(cfg, device=dev)
            _, _, st, u = prog.run(n_steps=n)
            field = project_gradient(prog.space, u[:, -1], sign=-1.0)
            return u, field, st
        return go

    def edl():
        cfg = edl_1d.EDL1DConfig(L_n=L_n)
        cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
            cfg.linear, refresh="iter"))
        prog = edl_1d.build(cfg, device=dev)
        _, h, st, _ = prog.run(n_steps=2)
        field = project_gradient(prog.space, h[-1][:, -1], sign=-1.0)
        return h[-1], field, st

    out = [("pore_3d carried", pore("GMPNP")),
           ("rxn_diff_3d carried", pore("rxn_diff")),
           ("edl_1d exact", edl)]
    kinds = [dict(refresh="step"), dict(slab_mode="cr", refresh="step"),
             dict(kind="gmres", precond="block_jacobi", solve_dtype="f32",
                  tol=1e-5, maxiter=300),
             dict(kind="bicgstab", precond="ssor", tol=1e-6, maxiter=300),
             dict(kind="gmres", precond="amg", tol=1e-6, maxiter=300)]
    if small:
        kinds.append(dict(kind="dense"))
    for kw in kinds:
        def go(kw=kw):
            cfg = pore_3d.Pore3DConfig(L=50e-9, R=5e-9, **mesh)
            cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
                cfg.linear, **kw))
            u, st = sweep.run_pore_voltage_sweep(
                cfg, [-0.5, -1.0, -1.5], n_steps=1, chunk=3, device=dev)
            return u, None, st
        out.append((f"sweep batched {kw}", go))
    return out, [("pore_3d carried L50R5", pore("GMPNP", {}, 5)),
                 ("rxn_diff_3d carried L50R5", pore("rxn_diff", {}, 5))]


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    ps, repeats = paths(args.device, args.small)
    for label_p, fn_p in ps:
        scan = OpScan()
        with scan:
            fn_p()
        print(f"scan {label_p}: " + (", ".join(
            f"{op} x{n} at {where}" for (op, where), n in
            sorted(scan.hits.items())) or "no order-dependent op"),
            flush=True)
    for label, fn in repeats:
        for flag in (False, True):
            torch.use_deterministic_algorithms(flag)
            for rep in range(2):
                try:
                    u, field, st = fn()
                except RuntimeError as exc:     # an op with no
                    print(f"repeat {label} deterministic={flag}: {exc}",
                          flush=True)            # deterministic kernel
                    break
                print(f"repeat {label} deterministic={flag} run {rep}: "
                      f"newton {np.asarray(st.newton_iters).tolist()} "
                      f"krylov {np.asarray(st.linear_iters).tolist()} "
                      f"sha256 {digest(u, field)}", flush=True)
    torch.use_deterministic_algorithms(False)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.exit(main())
