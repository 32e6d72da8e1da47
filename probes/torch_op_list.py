"""The aten ops the PyTorch port's paths dispatch, in order, one file per
path: two trees that write the same files run the same operations on the
same shapes.

    python probes/torch_op_list.py --out DIR [--device cpu]

Each path runs at the small sizes of ``torch_determinism.py --small``
under a ``TorchDispatchMode`` that writes one line per op: its name, then
each schema argument, defaults filled in: a tensor as dtype, shape and
strides (a size-1 dimension's stride written '*'), a negative dim counted
from the front, any other value as its repr.  An op that returns a view of
its input is written with a leading 'view ': ``grep -v '^view '`` leaves
the ops that compute.  Prints each path's count of ops and the sha256 of
its list, of all ops and of the computing ones.  To compare two trees, run
each tree's copy of this file and ``diff -r`` the two directories.

Paths: those of ``torch_determinism.py --small`` (the GMPNP and
reaction-diffusion pores carried, the EDL exact, a batched pore sweep
under each linear kind), the EDL carried (2 steps), a batched EDL sweep
under each 1D kind, the single pore under the slab CR and each Krylov
preconditioner and the single EDL under the 1D Thomas and
mixed-precision solves (1 step each), and ``torch_lane_bits.py --small``.
"""

import argparse
import contextlib
import dataclasses
import hashlib
import io
import os
import re
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: schema argument names that hold a dimension
DIMS = {"dim", "dim0", "dim1", "dims", "source", "destination"}
#: ops whose dim counts in their output's rank, one more than the input's
OUT_RANK = {"stack", "unsqueeze"}


def _tensor(t):
    strides = ",".join("*" if n == 1 else str(s)
                       for n, s in zip(t.shape, t.stride()))
    return f"{str(t.dtype)[6:]}{list(t.shape)}[{strides}]"


def _value(v):
    if isinstance(v, torch.Tensor):
        return _tensor(v)
    if isinstance(v, (list, tuple)):
        return "(" + ",".join(_value(x) for x in v) + ")"
    return repr(v)


def _rank(args, name):
    first = args[0] if args else None
    if isinstance(first, (list, tuple)):
        first = first[0] if first else None
    rank = first.dim() if isinstance(first, torch.Tensor) else 0
    return rank + (name in OUT_RANK)


def _dims(v, rank):
    if isinstance(v, int) and not isinstance(v, bool):
        return v + rank if v < 0 else v
    if isinstance(v, (list, tuple)):
        return type(v)(_dims(x, rank) for x in v)
    return v


class OpList(TorchDispatchMode):
    """One line per aten op dispatched (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        name = schema.name.split("::")[-1]
        rank = _rank(args, name)
        vals = []
        for i, a in enumerate(schema.arguments):
            if i < len(args):
                v = args[i]
            elif a.name in kwargs:
                v = kwargs[a.name]
            else:
                v = getattr(a, "default_value", None)
            if a.name in DIMS:
                v = _dims(v, rank)
            vals.append(f"{a.name}={_value(v)}")
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)
        self.lines.append(("view " if view else "")
                          + f"{func} " + " ".join(vals))
        return func(*args, **kwargs)


def paths(dev):
    """(label, callable) of every path."""
    import torch_determinism
    import torch_lane_bits
    from gmpnp_tpu_torch.models import edl_1d, pore_3d
    from gmpnp_tpu_torch.parallel import sweep

    mesh = {"mesh_resolution": (2, 10)}

    def lin(cfg, **kw):
        return dataclasses.replace(cfg, linear=dataclasses.replace(
            cfg.linear, **kw))

    def edl(n, **kw):
        def go():
            cfg = lin(edl_1d.EDL1DConfig(L_n=1e-6), **kw)
            edl_1d.build(cfg, device=dev).run(n_steps=n)
        return go

    def pore(**kw):
        def go():
            cfg = lin(pore_3d.Pore3DConfig(L=50e-9, R=5e-9, **mesh), **kw)
            pore_3d.build(cfg, device=dev).run(n_steps=1)
        return go

    def edl_sweep(**kw):
        def go():
            cfg = lin(edl_1d.EDL1DConfig(L_n=1e-6), **kw)
            sweep.run_edl_voltage_sweep(cfg, [-0.5, -1.0, -1.5], n_steps=1,
                                        chunk=3, device=dev)
        return go

    out, _ = torch_determinism.paths(dev, True)
    out.append(("edl_1d carried", edl(2, refresh="carried")))
    for kw in (dict(), dict(solve_dtype="f32"), dict(kind="tridiag_thomas"),
               dict(kind="dense")):
        out.append((f"edl sweep batched {kw}", edl_sweep(**kw)))
    for kw in (dict(slab_mode="cr", refresh="step"),
               dict(kind="gmres", precond="block_jacobi", solve_dtype="f32",
                    tol=1e-5, maxiter=300),
               dict(kind="bicgstab", precond="ssor", tol=1e-6, maxiter=300),
               dict(kind="gmres", precond="amg", tol=1e-6, maxiter=300)):
        out.append((f"pore_3d single {kw}", pore(**kw)))
    for kw in (dict(kind="tridiag_thomas"), dict(solve_dtype="f32")):
        out.append((f"edl_1d single {kw}", edl(1, **kw)))
    out.append(("lane_bits", lambda: torch_lane_bits.main(
        ["--device", dev, "--small"])))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cpu")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    os.makedirs(args.out, exist_ok=True)
    for label, fn in paths(args.device):
        rec = OpList()
        with rec, contextlib.redirect_stdout(io.StringIO()):
            fn()
        lines = rec.lines
        compute = [ln for ln in lines if not ln.startswith("view ")]
        slug = re.sub(r"[^A-Za-z0-9]+", "_", label).strip("_")
        with open(os.path.join(args.out, slug + ".txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")

        def sha(ls):
            return hashlib.sha256("\n".join(ls).encode()).hexdigest()[:16]

        print(f"ops {label}: {len(lines)} ({len(compute)} compute) "
              f"sha256 {sha(lines)} compute {sha(compute)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
