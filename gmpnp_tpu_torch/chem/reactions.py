"""Homogeneous bicarbonate-buffer reaction kinetics.

Three reversible reactions (ref: 1D/MPNP_CO2ER_EDL.py:25-29):

    H2O         <=> H+  + OH-        (kw1 fwd, kw2 bwd)
    HCO3- + OH- <=> CO32- + H2O      (ka1 fwd, ka2 bwd)
    CO2  + OH-  <=> HCO3-            (kb1 fwd, kb2 bwd)

This module provides the *net volumetric production rates* R_i for every
species as one vectorized torch function.  It is the single shared source for
all five models — the reference duplicates these expressions in four scripts
(1D/MPNP_CO2ER_EDL.py:383-410 ≡ 1D/rxn_diff_planar.py:270-297 ≡
3D/MPNP_CO2ER_pore.py:505-532 ≡ 3D/rxn_diff_CO2ER_pore.py:451-478).

Convention: concentrations are *dimensionless* (scaled by the species bulk
concentration C0_i), as in the solvers; the returned rates are the scaled
rates  -R_i_scaled = scale_R_i * (dimensional net consumption), matching the
sign convention of the reference forms where ``- R_i * v_i * dx`` appears in
the residual with R_i already carrying the minus sign of consumption.

Here we return R_i such that the transport equation reads
    du_i/dtau = div(...) + R_i
i.e. R_i > 0 means net production, identical to the reference's ``R_i``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import torch

from gmpnp_tpu_torch.constants import RateConstants


@dataclass(frozen=True)
class BufferKinetics:
    """Precomputed coefficient bundle for the scaled buffer rates.

    Built once per model config; usable under ``torch.func`` transforms
    (all fields are plain floats / tuples).

    ``species``: ordered names; fields H, OH, HCO3, CO32, CO2 participate,
    all others (cations, CO, H2) have zero homogeneous rate.
    ``c0``: bulk concentrations per species (mol/m^3), for un-scaling.
    ``scale_R``: L^2 / (D_i * C0_i) per species (ref: 1D/MPNP_CO2ER_EDL.py:186-190).
    """

    species: tuple
    c0: tuple
    scale_R: tuple
    rates: RateConstants

    @classmethod
    def build(
        cls,
        species: Sequence[str],
        bulk_conc: Dict[str, float],
        diff_coeff: Dict[str, float],
        L: float,
        rates: RateConstants,
    ) -> "BufferKinetics":
        sr = tuple(
            (L ** 2) / (diff_coeff[s] * bulk_conc[s]) for s in species)
        c0 = tuple(bulk_conc[s] for s in species)
        return cls(species=tuple(species), c0=c0, scale_R=sr, rates=rates)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        """Scaled net production rates.

        Parameters
        ----------
        u : (..., n_species) dimensionless concentrations (order = species).

        Returns
        -------
        R : (..., n_species) scaled production rates (same order).
        """
        return buffer_rates(u, self.species, self.c0, self.scale_R, self.rates)


def buffer_rates(
    u: torch.Tensor,
    species: Sequence[str],
    c0: Sequence[float],
    scale_R: Sequence[float],
    k: RateConstants,
) -> torch.Tensor:
    """Vectorized scaled production rates for an arbitrary species ordering.

    Species not in {H, OH, HCO3, CO32, CO2} get rate 0 (ref: "cation is not
    being consumed or formed in any homogeneous reaction",
    1D/MPNP_CO2ER_EDL.py:382).
    """
    idx = {s: i for i, s in enumerate(species)}

    def conc(name):  # dimensional concentration, mol/m^3
        i = idx[name]
        return u[..., i] * c0[i]

    cH = conc("H") if "H" in idx else None
    cOH = conc("OH")
    cHCO3 = conc("HCO3")
    cCO32 = conc("CO32")
    cCO2 = conc("CO2")

    # net *dimensional* rates of the three reactions (production of products)
    r_w = (k.kw2 * cH * cOH - k.kw1) if cH is not None else None  # recombination - dissoc.
    r_a = k.ka1 * cHCO3 * cOH - k.ka2 * cCO32                      # HCO3+OH -> CO32
    r_b = k.kb1 * cCO2 * cOH - k.kb2 * cHCO3                       # CO2+OH -> HCO3

    out = []
    for i, s in enumerate(species):
        if s == "H":
            Ri = -scale_R[i] * r_w
        elif s == "OH":
            rw = r_w if r_w is not None else 0.0
            Ri = -scale_R[i] * (rw + r_a + r_b)
        elif s == "HCO3":
            Ri = -scale_R[i] * (r_a - r_b)
        elif s == "CO32":
            Ri = -scale_R[i] * (-r_a)
        elif s == "CO2":
            Ri = -scale_R[i] * r_b
        else:
            Ri = torch.zeros_like(cOH)
        out.append(Ri)
    return torch.stack(out, dim=-1)



def kinetics_0d(y: torch.Tensor, k: RateConstants) -> torch.Tensor:
    """0D batch-reactor RHS for [HCO3, OH, CO32, CO2] in mol/m^3.

    Water self-ionization is not tracked (H+ is slaved to OH- through Kw when
    post-processing pH).  ref: utilities/bulk_soln.py:21-30.
    """
    C_HCO3, C_OH, C_CO32, C_CO2 = y[0], y[1], y[2], y[3]
    r_a = k.ka1 * C_HCO3 * C_OH - k.ka2 * C_CO32
    r_b = k.kb1 * C_CO2 * C_OH - k.kb2 * C_HCO3
    return torch.stack([r_b - r_a, -r_b - r_a, r_a, -r_b])


def kinetics_0d_const_co2(
    y: torch.Tensor, k: RateConstants, C0_CO2: float
) -> torch.Tensor:
    """0D RHS for [HCO3, OH, CO32] with [CO2] held at saturation.

    ref: utilities/bulk_soln.py:56-64.
    """
    C_HCO3, C_OH, C_CO32 = y[0], y[1], y[2]
    r_a = k.ka1 * C_HCO3 * C_OH - k.ka2 * C_CO32
    r_b = k.kb1 * C0_CO2 * C_OH - k.kb2 * C_HCO3
    return torch.stack([r_b - r_a, -r_b - r_a, r_a])
