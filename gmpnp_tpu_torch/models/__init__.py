"""Reference models as first-class configs.

Model <-> reference map (ported so far):
- rxn_diff_1d : 1D/rxn_diff_planar.py       (solve_rxn_diff)
- edl_1d      : 1D/MPNP_CO2ER_EDL.py        (solve_EDL, PNP & MPNP)
- pore_3d     : 3D/MPNP_CO2ER_pore.py       (solveEDL, GMPNP) and
                3D/rxn_diff_CO2ER_pore.py   (physics='rxn_diff')

Each model module exposes a Config dataclass, a ``build(config, device)``
returning a program, and a ``run(config)`` producing the reference-compatible
outputs (npz/metadata/VTK).
"""
