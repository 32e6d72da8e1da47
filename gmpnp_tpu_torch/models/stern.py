"""Stern-layer Poisson post-solve.

Re-implements the reference ``Stern_CO2ER.py``: integrate the charge-free
Poisson equation backwards through a 4 Angstrom Stern layer, starting from
the OHP potential / field / permittivity produced by the 1D GMPNP model, in
two variants (ref 1D/Stern_CO2ER.py:82-156):

- ``BDM``: variable permittivity interpolated linearly between the OHP value
  and eps=6 at the catalyst surface; the ODE
      E' = -E * deps/dx / eps
  has the closed form (derived from (eps E)' = 0)
      E(x)   = E0 * (e0 * L) / (x*d + e0*L)
      psi(x) = psi0 + E0 * e0 * L / d * ln(1 + x*d/(e0*L))
  which this module evaluates exactly on the reference's sample grid
  (dx = 1e-11 m over [0, -L_stern], ref :91-94) — no ODE stepper needed.

- ``Stern_linear``: constant field, linear potential drop (ref :138-156).

NOTE the shipped reference calls ``odeint(BDM, ..., args=(eps_rel_OHP,
eps_rel_surface, L_stern))`` against the signature ``BDM(Y, x,
eps_rel_surface, eps_rel_OHP, ...)`` (ref :82,:98) — the two permittivities
arrive *swapped*.  ``arg_order='reference'`` (default) reproduces that
behavior bit-for-bit; ``'corrected'`` uses the physically-intended order.

The default voltage sweep uses the reference's hardcoded table of MPNP
results for V_mult in {-2.5 ... -12.5} (ref :66-68).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from gmpnp_tpu_torch.constants import DEFAULT_PARAMS, ParameterSet
from gmpnp_tpu_torch.io import make_run_dir, save_npz

L_STERN = 4.0e-10  # m; typical solvated monovalent-cation diameter (ref :60)
EPS_SURFACE = 6.0  # rigid-water permittivity at the catalyst surface (ref :80)

#: OHP field (V/nm) and permittivity from reference MPNP runs (ref :66-68)
DEFAULT_OHP_RESULTS: Dict[float, Dict[str, float]] = {
    -2.5: {"E": -0.08032108300135771, "eps": 74.56149297894756},
    -5.0: {"E": -0.2524415478848975, "eps": 57.64572780716129},
    -7.5: {"E": -0.4612956299192668, "eps": 50.16243860179017},
    -10.0: {"E": -0.6149631587776277, "eps": 49.311548142969336},
    -12.5: {"E": -0.7310301485096051, "eps": 49.2556833480052},
}


@dataclass(frozen=True)
class SternConfig:
    voltage_scaled_OHP: float = -2.5
    model: str = "BDM"            # 'BDM' | 'Stern_linear'
    field_OHP: float = -0.5       # V/nm at the OHP
    eps_rel_OHP: float = 80.0
    arg_order: str = "reference"  # 'reference' reproduces the swapped-args
                                  # call (ref :98); 'corrected' fixes it
    params: ParameterSet = field(default_factory=lambda: DEFAULT_PARAMS)


def _bdm_profile(x, psi0, E0, eps_a, eps_b, L):
    """Closed-form charge-free Poisson with permittivity linear from eps_a
    at x=0 toward eps_b; matches the rhs
        y2' = -y2 (eps_a - eps_b) / (x (eps_a - eps_b) + eps_a L)
    (the reference BDM rhs with eps_a bound to its ``eps_rel_OHP``
    parameter slot, ref :86)."""
    d = eps_a - eps_b
    den = x * d + eps_a * L
    E = E0 * (eps_a * L) / den
    if abs(d) < 1e-300:
        psi = psi0 + E0 * x
    else:
        psi = psi0 + E0 * (eps_a * L / d) * np.log(den / (eps_a * L))
    return psi, E


def solve_stern(cfg: SternConfig):
    """Single-voltage Stern solve; returns dict with profiles and surface
    values (ref Stern() :70-173)."""
    nat = cfg.params.nat_const
    thermal_voltage = nat.k_B * nat.T / nat.e_0
    voltage_OHP = cfg.voltage_scaled_OHP * thermal_voltage

    if cfg.model == "BDM":
        dx = 1.0e-11
        xmax = -L_STERN
        x = np.linspace(0, xmax, abs(int(xmax / dx)))  # 40 samples (ref :91-94)
        # y0 = [voltage_OHP, -field_OHP] (ref :96)
        E0 = -cfg.field_OHP
        if cfg.arg_order == "reference":
            # swapped: the rhs sees eps_rel_OHP := EPS_SURFACE,
            # eps_rel_surface := cfg.eps_rel_OHP  (ref :98 vs :82)
            eps_a, eps_b = EPS_SURFACE, cfg.eps_rel_OHP
        else:
            eps_a, eps_b = cfg.eps_rel_OHP, EPS_SURFACE
        y1, y2 = _bdm_profile(x, voltage_OHP, E0, eps_a, eps_b, L_STERN)
        y1_scaled = y1                     # V
        y2_scaled = -y2                    # V/nm convention flip (ref :102)
        x_scaled = x * 1.0e9               # nm
        return {
            "model": "BDM",
            "x": x,
            "x_scaled": x_scaled,
            "potential": y1_scaled,
            "field": y2_scaled,
            "voltage_OHP": voltage_OHP,
            "voltage_electrode": float(y1_scaled[-1]),
            "field_surf": float(y2_scaled[-1]),
            "eps_rel_OHP": cfg.eps_rel_OHP,
            "L_stern": L_STERN,
        }

    if cfg.model == "Stern_linear":
        # constant field, potential linear in x (nm units, ref :138-156)
        y1_surf = voltage_OHP - (-cfg.field_OHP * (L_STERN * 1.0e9))
        dx = 1.0e-2
        xmax = -L_STERN * 1.0e9
        x = np.linspace(0, xmax, abs(int(xmax / dx)))
        y1_x = -cfg.field_OHP * x + voltage_OHP
        return {
            "model": "Stern_linear",
            "x_scaled": x,
            "potential": y1_x,
            "field": np.full_like(x, cfg.field_OHP),
            "voltage_OHP": voltage_OHP,
            "voltage_electrode": float(y1_surf),
            "field_surf": cfg.field_OHP,
            "eps_rel_OHP": cfg.eps_rel_OHP,
            "L_stern": L_STERN,
        }

    raise ValueError(f"unknown Stern model {cfg.model!r}")


def _write_metadata_txt(path: str, res: Dict) -> None:
    """Text metadata matching the reference format (ref :32-43)."""
    with open(path, "w") as f:
        f.write(f"model={res['model']}\n")
        f.write(f"voltage_OHP={res['voltage_OHP']}V\n")
        f.write(f"field_OHP={res.get('field_OHP', '')}V/nm\n")
        f.write(f"Relative permittivity at the OHP is {res['eps_rel_OHP']} \n")
        f.write(f"voltage at the electrode is {res['voltage_electrode']} \n")
        f.write(f"Electric field at the surface is {res['field_surf']} m\n")
        f.write(f"Stern length is {res['L_stern']} m\n")


def run(
    model: str = "BDM",
    ohp_results: Optional[Dict[float, Dict[str, float]]] = None,
    out_root: Optional[str] = None,
    write: bool = True,
    arg_order: str = "reference",
    make_plots: bool = True,
):
    """Voltage sweep over the OHP-results table (ref :179-180), one output
    folder per voltage multiplier."""
    if ohp_results is None:
        ohp_results = DEFAULT_OHP_RESULTS
    out = {}
    for v, d in ohp_results.items():
        cfg = SternConfig(
            voltage_scaled_OHP=v, model=model,
            field_OHP=d["E"], eps_rel_OHP=d["eps"], arg_order=arg_order)
        res = solve_stern(cfg)
        res["field_OHP"] = d["E"]
        out[v] = res
        if write:
            paths = make_run_dir(f"voltage_scaled_OHP{v}", out_root=out_root,
                                 subdir="Stern")
            # positional arrays (arr_0, arr_1, ...) to match the
            # reference's np.savez calls (ref :108-109,:156)
            if model == "BDM":
                np.savez(paths.file(f"stern_unscaled_BDM{v}.npz"),
                         np.stack([res["potential"], -res["field"]], axis=1))
                np.savez(paths.file(f"stern_scaled_BDM{v}.npz"),
                         res["x_scaled"], res["potential"], res["field"])
            else:
                np.savez(paths.file(f"stern_scaled_linear{v}.npz"),
                         res["x_scaled"], res["potential"])
            _write_metadata_txt(paths.file("metadata.txt"), res)
            if make_plots:
                # the reference writes the profile PNGs unconditionally
                # (ref :118-136); gate only on matplotlib availability
                try:
                    _save_plots(paths, res, v)
                except ImportError:
                    pass
            res["run_dir"] = paths.run_dir
    return out


def _save_plots(paths, res, v):
    """Potential/field PNGs (ref :118-136); headless backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.plot(res["x_scaled"], res["potential"])
    plt.xlabel("distance (nm)")
    plt.ylabel("potential in V")
    plt.title(f"voltage_multiplier: {v}")
    plt.xticks(rotation=90)
    plt.tight_layout()
    plt.savefig(paths.file("V_x.png"))
    plt.close()

    plt.figure()
    plt.plot(res["x_scaled"], res["field"])
    plt.xlabel("distance (nm)")
    plt.ylabel("electric field in V/nm")
    plt.title(f"voltage_multiplier: {v}")
    plt.xticks(rotation=90)
    plt.tight_layout()
    plt.savefig(paths.file("field_x.png"))
    plt.close()
