"""Command-line entry points mirroring the reference scripts' flags.

    python -m gmpnp_tpu_torch.cli.edl_1d       ~  python 1D/MPNP_CO2ER_EDL.py
    python -m gmpnp_tpu_torch.cli.rxn_diff_1d  ~  python 1D/rxn_diff_planar.py
    python -m gmpnp_tpu_torch.cli.pore_3d      ~  python 3D/MPNP_CO2ER_pore.py
    python -m gmpnp_tpu_torch.cli.rxn_diff_3d  ~  python 3D/rxn_diff_CO2ER_pore.py

Flags match the ``gmpnp_tpu.cli`` module of the same name, plus
``--device`` (default ``cuda``).
"""
