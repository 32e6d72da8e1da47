"""Command-line entry points mirroring the reference scripts' flags.

    python -m gmpnp_tpu_torch.cli.pore_3d  ~  python 3D/MPNP_CO2ER_pore.py

Flags match ``gmpnp_tpu.cli.pore_3d``, plus ``--device`` (default ``cuda``).
"""
