"""One transient per episode, through the model's own entry:
``build(config).run(**run)``, one program per operating voltage, each built
in set-up. A round runs one episode at every voltage, in the seed's order.

Workload keys: ``run`` (keyword arguments of ``run``: ``n_steps`` null is
the model's whole schedule).
"""

from __future__ import annotations

import functools

from benchmark.harness.program import program_config


class Driver:
    def __init__(self, cfg, workload, voltages, device):
        self.progs = []
        for v in voltages:
            module, pcfg = program_config(cfg, workload, v)
            self.progs.append((v, module.build(pcfg, device=device)))
        self.run_kw = dict(workload.get("run", {}))
        #: the loop the harness times: the model module's run_transient
        self.loop = (module, "run_transient")

    def warm(self):
        """One whole episode of the round's first program: every voltage
        runs the same shapes, and a shorter run left the window's first
        episode about 2 s slower than the rest (EDL, H100)."""
        self.progs[0][1].run(**self.run_kw)

    def episodes(self):
        """[(the episode's voltages, the episode)] of one round."""
        return [([v], functools.partial(p.run, **self.run_kw))
                for v, p in self.progs]

    def close(self):
        self.progs = []
