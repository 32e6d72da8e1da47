"""Parallelism: parameter sweeps over voltage (and cation) lanes, and z-slab
domain decomposition.

Port of ``gmpnp_tpu.parallel``:
- ``sweep``: lanes batched into one lane-batched transient on a card
  (``chunk`` lanes a batch), run one after another (``chunk=0``), or
  lane blocks on a list of devices;
- ``shard``: z-slab partition of the pore over a line of ranks (one
  process, one rank per entry of a device list) with ppermute halo
  exchange, psum reductions and a distributed SPIKE direct solver.
"""

from gmpnp_tpu_torch.parallel.sweep import (
    run_edl_voltage_sweep,
    run_lanes_on_devices,
    run_pore_voltage_cation_sweep,
    run_pore_voltage_sweep,
)
from gmpnp_tpu_torch.parallel.shard import (
    SlabPrecondPlan,
    ZShardPlan,
    make_sharded_pore_transient,
    make_sharded_step,
    make_sharded_transient,
)

__all__ = [
    "run_edl_voltage_sweep",
    "run_lanes_on_devices",
    "run_pore_voltage_cation_sweep",
    "run_pore_voltage_sweep",
    "SlabPrecondPlan",
    "ZShardPlan",
    "make_sharded_pore_transient",
    "make_sharded_step",
    "make_sharded_transient",
]
