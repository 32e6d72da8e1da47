"""Parallelism: parameter sweeps over voltage (and cation) lanes.

Port of the sweep half of ``gmpnp_tpu.parallel``; z-slab domain
decomposition (``gmpnp_tpu/parallel/shard.py``) is still to be ported
(ROADMAP queue 1).
"""

from gmpnp_tpu_torch.parallel.sweep import (
    run_edl_voltage_sweep,
    run_lanes_on_devices,
    run_pore_voltage_cation_sweep,
    run_pore_voltage_sweep,
)

__all__ = [
    "run_edl_voltage_sweep",
    "run_lanes_on_devices",
    "run_pore_voltage_cation_sweep",
    "run_pore_voltage_sweep",
]
