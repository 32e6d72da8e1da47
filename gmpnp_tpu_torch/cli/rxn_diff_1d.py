"""CLI for the 1D reaction-diffusion model (PyTorch port).

Flags mirror 1D/rxn_diff_planar.py:495-552 and gmpnp_tpu.cli.rxn_diff_1d
(the reference has no step-count flag), plus ``--device`` (default
``cuda``):

    python -m gmpnp_tpu_torch.cli.rxn_diff_1d --L_n 50e-6
"""

import argparse

from gmpnp_tpu_torch.models import rxn_diff_1d


def build_parser():
    p = argparse.ArgumentParser(description="experiment parameters")
    p.add_argument("--concentration_KHCO3", type=float, default=0.1,
                   help="electrolyte concentration in M")
    p.add_argument("--mesh_structure", type=str, default="variable",
                   help="uniform/variable")
    p.add_argument("--H2_FE", type=float, default=0.2,
                   help="faradaic efficiency for hydrogen (fraction)")
    p.add_argument("--L_n", type=float, default=50.0e-6,
                   help="Nernst boundary layer thickness in m")
    p.add_argument("--current_OHP_ss", type=float, default=10.0,
                   help="steady state current in A/m2")
    p.add_argument("--params_file", type=str, default="parameters",
                   help="yaml file with parameter values")
    p.add_argument("--cation", type=str, default="K", help="K/Cs/Li/Na")
    p.add_argument("--out_root", type=str, default=None,
                   help="output root directory (default $GMPNP_OUT or ./out)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = rxn_diff_1d.RxnDiff1DConfig(
        concentration_KHCO3=args.concentration_KHCO3,
        H2_FE=args.H2_FE,
        L_n=args.L_n,
        mesh_structure=args.mesh_structure,
        current_OHP_ss=args.current_OHP_ss,
        cation=args.cation,
        params_file=(None if args.params_file == "parameters"
                     else args.params_file),
    )
    res = rxn_diff_1d.run(cfg, out_root=args.out_root, device=args.device)
    print(res["run_dir"])
    return res


if __name__ == "__main__":
    main()
