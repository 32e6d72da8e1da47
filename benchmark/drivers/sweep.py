"""One voltage sweep per episode, through ``gmpnp_tpu_torch.parallel.sweep``:
``<entry>(config, voltages, n_steps=episode_steps, chunk=len(voltages))``,
which builds the program and runs the lanes from one cold start as one
lane-batched transient. A round is one episode, its lanes in the seed's
order.

Workload keys: ``entry`` (the sweep function), ``episode_steps``.
"""

from __future__ import annotations

import functools
import importlib

from benchmark.harness.program import program_config


class Driver:
    def __init__(self, cfg, workload, voltages, device):
        self.module = importlib.import_module("gmpnp_tpu_torch.parallel.sweep")
        self.fn = getattr(self.module, workload["entry"])
        _, self.pcfg = program_config(cfg, workload)
        self.volts = [float(v) for v in voltages]
        self.steps = workload["episode_steps"]
        self.device = device
        #: the loop the harness times: the sweeps' lane-batched transient
        self.loop = (self.module, "run_transient_lanes")

    def _sweep(self, n_steps):
        self.fn(self.pcfg, self.volts, n_steps=n_steps,
                chunk=len(self.volts), device=self.device)

    def warm(self):
        """One whole episode, as the single-run driver warms up."""
        self._sweep(self.steps)

    def episodes(self):
        """[(the episode's voltages, the episode)] of one round."""
        return [(self.volts, functools.partial(self._sweep, self.steps))]

    def close(self):
        pass
