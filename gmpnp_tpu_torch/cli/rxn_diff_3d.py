"""CLI for the 3D reaction-diffusion pore model (PyTorch port).

Flags mirror 3D/rxn_diff_CO2ER_pore.py:787-942 and
gmpnp_tpu.cli.rxn_diff_3d (no voltage multiplier), plus ``--device``
(default ``cuda``):

    python -m gmpnp_tpu_torch.cli.rxn_diff_3d --L 50e-9 --R 5e-9 \
        --linear_refresh carried --n_steps 5
"""

import argparse

from gmpnp_tpu_torch.cli.pore_3d import add_common_pore_args, config_from_args
from gmpnp_tpu_torch.models import pore_3d


def build_parser():
    p = argparse.ArgumentParser(description="experiment parameters")
    add_common_pore_args(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args, "rxn_diff")
    res = pore_3d.run(cfg, out_root=args.out_root, n_steps=args.n_steps,
                      record_stride=args.record_stride,
                      checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every,
                      shard=args.shard, device=args.device)
    print(res["run_dir"])
    return res


if __name__ == "__main__":
    main()
