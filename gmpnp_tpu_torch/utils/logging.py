"""Structured per-step logging.

The reference's only observability is bare ``print()`` breadcrumbs (step
index, CO2_min, controller values — SURVEY.md §5).  This module provides a
structured replacement: per-step records (residual norms, Newton/Krylov
iteration counts, dt, divergence flags) accumulated from the device-side
StepStats after a run and emitted as ndjson or console lines, plus
convergence-failure summaries.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import IO, Optional

import numpy as np


@dataclass
class StepLogger:
    stream: Optional[IO] = None           # defaults to stdout
    ndjson_path: Optional[str] = None
    every: int = 1                        # console stride

    def log_run(self, stats, dt_phys: Optional[float] = None,
                extra: Optional[dict] = None) -> dict:
        """Consume a StepStats pytree (arrays with leading step axis) and
        emit per-step records; returns the summary dict."""
        out = self.stream or sys.stdout
        iters = np.asarray(stats.newton_iters)
        conv = np.asarray(stats.converged)
        res = np.asarray(stats.residual_norm)
        lin = np.asarray(stats.linear_iters)
        n = len(iters)

        nd = open(self.ndjson_path, "w") if self.ndjson_path else None
        try:
            for i in range(n):
                rec = {
                    "step": i,
                    "newton_iters": int(iters[i]),
                    "linear_iters": int(lin[i]),
                    "residual": float(res[i]),
                    "converged": bool(conv[i]),
                }
                if dt_phys is not None:
                    rec["dt"] = dt_phys
                if nd:
                    nd.write(json.dumps(rec) + "\n")
                if self.every and i % self.every == 0:
                    out.write(
                        f"[step {i:6d}] newton={rec['newton_iters']:3d} "
                        f"krylov={rec['linear_iters']:6d} "
                        f"|r|={rec['residual']:.3e}"
                        f"{'' if rec['converged'] else '  ** DIVERGED **'}\n")
        finally:
            if nd:
                nd.close()

        summary = {
            "steps": n,
            "newton_iters_total": int(iters.sum()),
            "linear_iters_total": int(lin.sum()),
            "steps_converged": int(conv.sum()),
            "all_converged": bool(conv.all()),
            "max_residual": float(res.max()) if n else 0.0,
        }
        if extra:
            summary.update(extra)
        if not summary["all_converged"]:
            bad = np.nonzero(~conv)[0]
            summary["diverged_steps"] = bad[:32].tolist()
            out.write(f"WARNING: {len(bad)} steps did not converge "
                      f"(first: {bad[:8].tolist()})\n")
        return summary
