"""Reference models as first-class configs.

Ported so far:
- pore_3d : 3D/MPNP_CO2ER_pore.py (solveEDL, GMPNP)

Each model module exposes a Config dataclass, a ``build(config, device)``
returning a program, and a ``run(config)`` producing the reference-compatible
outputs (npz/metadata/VTK).
"""
