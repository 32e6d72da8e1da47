"""Run-output writers.

Reproduces the reference's output contract — per-run folders named
``<stamp>_experiment/<identifier>`` holding ``arrays_unscaled.npz``,
``arrays_scaled.npz`` and ``metadata.json`` with the model-specific key sets
(e.g. 1D/MPNP_CO2ER_EDL.py:821-832,906-924,960-989) — with the hardcoded
machine-specific basepaths replaced by a configurable output root
(env ``GMPNP_OUT`` or argument; default ``./out``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from datetime import datetime
from typing import Dict, Optional

import numpy as np


@dataclass(frozen=True)
class RunPaths:
    run_dir: str

    def file(self, name: str) -> str:
        return os.path.join(self.run_dir, name)


def make_run_dir(
    identifier: str,
    out_root: Optional[str] = None,
    subdir: str = "",
    stamp: Optional[str] = None,
) -> RunPaths:
    """Create ``<out_root>/[subdir/]<stamp>_experiment/<identifier>``."""
    if out_root is None:
        out_root = os.environ.get("GMPNP_OUT", "out")
    if stamp is None:
        stamp = datetime.now().strftime("%y-%m-%d-%H-%M-%S")
    parts = [out_root]
    if subdir:
        parts.append(subdir)
    parts.append(f"{stamp}_experiment")
    parts.append(identifier)
    run_dir = os.path.join(*parts)
    os.makedirs(run_dir, exist_ok=True)
    return RunPaths(run_dir=run_dir)


def save_npz(path: str, **arrays) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def save_metadata(path: str, metadata: Dict) -> None:
    def clean(v):
        if isinstance(v, (np.floating, np.integer)):
            return v.item()
        if isinstance(v, np.ndarray):
            return v.tolist()
        return v

    with open(path, "w") as f:
        f.write(json.dumps({k: clean(v) for k, v in metadata.items()}, indent=0))
