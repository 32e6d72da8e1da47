"""CLI mesh-marking verifier.

Generalizes 3D/mesh_tests.py: loads (or generates) a cylinder mesh, marks
the boundaries with the model predicates, assembles the marked wall area and
compares it with the analytic lateral surface 2*pi*(R/L) (ref :80-85), plus
entry/exit disc areas.
"""

import argparse
import math

import numpy as np

from gmpnp_tpu_torch.mesh.core import facet_measures
from gmpnp_tpu_torch.models.pore_3d import _load_pore_mesh, Pore3DConfig


def main(argv=None):
    p = argparse.ArgumentParser(description="mesh marking verifier")
    p.add_argument("--L", type=float, default=80e-9)
    p.add_argument("--R", type=float, default=5e-9)
    args = p.parse_args(argv)

    cfg = Pore3DConfig(L=args.L, R=args.R)
    mesh = _load_pore_mesh(cfg)
    aspect = args.R / args.L
    areas = facet_measures(mesh.points, mesh.facets)
    wall = areas[mesh.facet_markers == 2].sum()
    entry = areas[mesh.facet_markers == 1].sum()
    exit_ = areas[mesh.facet_markers == 3].sum()
    unmarked = (mesh.facet_markers == 9999).sum()

    A2 = 2 * math.pi * aspect
    A1 = math.pi * aspect ** 2
    print(f"wall  area: {wall:.6e} vs analytic {A2:.6e} "
          f"(ratio {wall / A2:.4f})")
    print(f"entry area: {entry:.6e} vs analytic {A1:.6e} "
          f"(ratio {entry / A1:.4f})")
    print(f"exit  area: {exit_:.6e} vs analytic {A1:.6e} "
          f"(ratio {exit_ / A1:.4f})")
    print(f"unmarked facets: {unmarked}")
    return wall, entry, exit_


if __name__ == "__main__":
    main()
