"""The control: the reference put in the program's place, one precision
down (float32 for the configuration's float64), with TF32 off.

For each operating voltage it runs ``steps`` backward-Euler steps from the
initial state with the plain damped Newton of ``fem.newton_step`` in
float32, and reports each step as the program does: the state and the
residual norm it computed for it (in float32). ``judge.judge`` then reads
those states as it reads a run's. The benchmark's runs never run it; the
tests under ``benchmark/tests`` do, at a small size on the CPU and at the
cell's own size on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import fem, transport


def control_states(cfg, volts, steps, device, max_iter=None):
    """([(voltages, first, last)] of one episode with every voltage as a
    lane, the count of lane-steps whose Newton did not converge)."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    newton = dict(cfg["published"]["newton"])
    if max_iter is not None:
        newton["max_iter"] = min(newton["max_iter"], max_iter)
    qd = cfg["program"]["quad_degree"]
    lanes = []
    unconverged = 0
    for v in volts:
        pb = transport.problem(cfg, v, device, torch.float32)
        space = fem.P1Space(pb.points, pb.cells, qd, device, torch.float32)
        u = pb.initial_state()
        recs = []
        for i in range(steps):
            theta = pb.theta(u, i)
            un, _, ok = fem.newton_step(space, pb, u, theta, newton)
            rn = float(fem.l2(space.residual(pb, un, u, theta)))
            unconverged += not ok
            recs.append((u.double(), un.double(), rn, i))
            u = un
        lanes.append(recs)

    def joined(k):
        recs = [lane[k] for lane in lanes]
        return (torch.stack([r[0] for r in recs]),
                torch.stack([r[1] for r in recs]),
                np.ones(len(recs)), np.asarray([r[2] for r in recs]),
                recs[0][3])

    return [(list(volts), joined(0), joined(-1))], unconverged
