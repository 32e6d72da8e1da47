"""Each lane function of the batched sweeps against its single-lane
function on the same system, lane by lane: bitwise equal or not, and the
largest difference.

    python probes/torch_lane_bits.py [--device cuda] [--small]

Systems: three lanes (-0.5, -1.0, -1.5 V) of the GMPNP pore's cold-start
Jacobian and residual under the sweep's Dirichlet blend (L=50 nm, R=5 nm;
``--small``: the (2, 8) mesh), and three lanes of the EDL's (L_n=50 um;
``--small``: 1 um).  Functions: the block-Jacobi, SSOR and AMG
preconditioners, the f32 equilibration, GMRES and BiCGStab over each
preconditioner, the slab Thomas and CR factor and solve, the 1D CR,
Thomas and mixed-precision solves and the dense solve (``--small``
only).
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

VOLTS = (-0.5, -1.0, -1.5)


def pore_system(dev, small):
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.solve.timeloop import stack_lane_theta

    kw = {"mesh_resolution": (2, 8)} if small else {"L": 50e-9, "R": 5e-9}
    prog = pore_3d.build(pore_3d.Pore3DConfig(**kw), device=dev)
    ns = len(prog.config.species)
    s2 = np.unique(prog.mesh.facets[prog.mesh.facet_markers
                                    == pore_3d.S2].reshape(-1))
    u0 = prog.initial_state()
    ths = []
    for volt in VOLTS:
        th = prog._theta_of_carry((u0, 0.0), 0)
        th["voltage"] = volt
        ths.append(th)
    theta = stack_lane_theta(ths, dev)
    bc = prog.bc.arith().set_value_arith(
        prog.s1_verts, prog.idx["CO2"], theta["co2_s1"]).set_value_arith(
            s2, ns, theta["voltage"])
    U = bc.project(u0.expand(len(VOLTS), *u0.shape).clone())
    ell = bc.apply_to_jacobian(prog.space.jacobian_lanes(
        prog.form, U, u0.expand_as(U), theta))
    r = bc.apply_to_residual(prog.space.residual_lanes(
        prog.form, U, u0.expand_as(U), theta), U)
    return prog, ell, r


def edl_system(dev, small):
    from gmpnp_tpu_torch.models import edl_1d
    from gmpnp_tpu_torch.solve.timeloop import stack_lane_theta

    prog = edl_1d.build(edl_1d.EDL1DConfig(L_n=1e-6 if small else 50e-6),
                        device=dev)
    left = np.unique(prog.mesh.facets[prog.mesh.facet_markers
                                      == 1].reshape(-1))
    u0 = prog.initial_state()
    ths = []
    for volt in VOLTS:
        th = prog._theta_of_carry((u0, 0.0), 0)
        th["voltage"] = volt
        ths.append(th)
    theta = stack_lane_theta(ths, dev)
    bc = prog.bc.arith().set_value_arith(left, edl_1d.P, theta["voltage"])
    U = bc.project(u0.expand(len(VOLTS), *u0.shape).clone())
    ell = bc.apply_to_jacobian(prog.space.jacobian_lanes(
        prog.form, U, u0.expand_as(U), theta))
    r = bc.apply_to_residual(prog.space.residual_lanes(
        prog.form, U, u0.expand_as(U), theta), U)
    return prog, ell, r


def report(name, lanes, singles):
    eq = [bool(torch.equal(a, b)) for a, b in zip(lanes, singles)]
    diff = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
            for a, b in zip(lanes, singles)]
    print(f"lanes {name}: bitwise {eq} max rel diff {diff}", flush=True)


def main(argv=None):
    from gmpnp_tpu_torch.fem.assembly import BlockELL
    from gmpnp_tpu_torch.ops.ell_spmv import lane_aligned
    from gmpnp_tpu_torch.solve import amg, linear, slab

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    dev = args.device
    torch.backends.cuda.matmul.allow_tf32 = False

    prog, ell, r = pore_system(dev, args.small)
    V = ell.lanes
    one = [BlockELL(ell.adj, ell.flat[v], ell.diag_slot) for v in range(V)]
    ella = BlockELL(ell.adj, lane_aligned(ell.flat), ell.diag_slot)
    colors = prog.space.colors
    plan = amg.AMGPlan.build(np.asarray(prog.space.adj), 9)
    pcs = {
        "block_jacobi": (linear.block_jacobi_preconditioner_lanes(ella),
                         [linear.block_jacobi_preconditioner(o)
                          for o in one]),
        "ssor": (linear.multicolor_ssor_preconditioner_lanes(ella, colors),
                 [linear.multicolor_ssor_preconditioner(o, colors)
                  for o in one]),
        "amg": (amg.amg_preconditioner_lanes(ella, plan),
                [amg.amg_preconditioner(o, plan) for o in one]),
    }
    for name, (pl, ps) in pcs.items():
        report(f"pore {name} apply", pl(r), [f(r[v]) for v, f in
                                             enumerate(ps)])
        for kind, lanes_fn, one_fn in (
                ("gmres", linear.gmres_lanes, linear.gmres),
                ("bicgstab", linear.bicgstab_lanes, linear.bicgstab)):
            res = lanes_fn(ella.matvec, r, Minv=pl, tol=1e-10, maxiter=400)
            singles = [one_fn(one[v].matvec, r[v], Minv=ps[v], tol=1e-10,
                              maxiter=400) for v in range(V)]
            report(f"pore {kind} {name} x", res.x, [o.x for o in singles])
            print(f"  iters {res.iters.tolist()} vs "
                  f"{[o.iters for o in singles]}", flush=True)
    Dinv = linear.block_inv(ell.diag_blocks())
    e32 = ell.scale_rows(Dinv)
    report("pore f32 equilibration", e32.flat.to(torch.float32),
           [o.scale_rows(Dinv[v]).flat.to(torch.float32)
            for v, o in enumerate(one)])
    sp = slab.SlabPlan.build(np.asarray(prog.space.adj),
                             np.asarray(prog.space.points)[:, -1], 9,
                             np.asarray(prog.space.diag_slot))
    for mode in ("thomas", "cr"):
        pl = slab.slab_prepare_lanes(ell, sp, mode=mode)
        p1 = [slab.slab_prepare(o, sp, mode=mode) for o in one]
        res = slab.slab_apply_lanes(pl, r, sp, tol=1e-10, max_refine=40)
        singles = [slab.slab_apply(p, r[v], sp, tol=1e-10, max_refine=40)
                   for v, p in enumerate(p1)]
        report(f"pore slab {mode} apply x", res.x, [o.x for o in singles])
        print(f"  iters {res.iters.tolist()} vs "
              f"{[o.iters for o in singles]}", flush=True)
    if args.small:
        report("pore dense", linear.dense_solve_lanes(ell, r),
               [linear.dense_solve(o, r[v]) for v, o in enumerate(one)])

    prog, ell, r = edl_system(dev, args.small)
    one = [BlockELL(ell.adj, ell.flat[v], ell.diag_slot) for v in range(V)]
    bands = linear.block_tridiag_from_ell_lanes(ell)
    singles = [linear.block_tridiag_from_ell(o) for o in one]
    report("edl cr solve", linear.block_tridiag_solve_cr_lanes(*bands, r),
           [linear.block_tridiag_solve_cr(*b, r[v])
            for v, b in enumerate(singles)])
    report("edl thomas solve",
           linear.block_tridiag_solve_thomas_lanes(*bands, r),
           [linear.block_tridiag_solve_thomas(*b, r[v])
            for v, b in enumerate(singles)])
    res = linear.tridiag_mp_solve_lanes(ell, r, tol=1e-8, max_refine=40)
    mp = [linear.tridiag_mp_solve(o, r[v], tol=1e-8, max_refine=40)
          for v, o in enumerate(one)]
    report("edl tridiag_mp_solve x", res.x, [o.x for o in mp])
    print(f"  iters {res.iters.tolist()} vs {[o.iters for o in mp]}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
