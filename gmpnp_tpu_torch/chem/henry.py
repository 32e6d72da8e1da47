"""Henry's-law CO2 solubility with Sechenov salting-out correction.

Pure functions on numpy values or torch tensors — the 3D pore model
re-evaluates the Sechenov-corrected CO2 Dirichlet value every time step from
the median ion concentrations (ref: 3D/MPNP_CO2ER_pore.py:70-93,815-838),
which here stays on the tensors' device with no host round trip.

Physics (ref: 3D/MPNP_CO2ER_pore.py:70-93 and utilities/bulk_soln.py:32-54):
    ln K_H = 93.4517*(100/T) - 60.2409 + 23.3585*ln(T/100)
    h_CO2(T) = h_CO2_0 + h_CO2_T*(T - 298.15)
    log10([CO2]/[CO2]_0) = -sum_i (h_ion_i + h_CO2) * c_i[kmol/m^3]
    [CO2]_sat = f_CO2 * K_H * 1000 * 10^(-sechenov)   (mol/m^3)
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from gmpnp_tpu_torch.constants import (
    DEFAULT_PARAMS,
    ParameterSet,
)

Scalar = Union[float, np.ndarray, torch.Tensor]


def _xp(*values):
    """numpy for host values, torch for tensors.

    Host-side callers (model builds, the bulk equilibrator) stay in numpy
    and give bit-identical results to the reference; per-step callers pass
    device tensors and get torch."""
    for v in values:
        if isinstance(v, torch.Tensor):
            return torch
    return np


def henry_K_CO2(temp: Scalar):
    """Henry's constant for CO2 (mol kg^-1 bar^-1 scale) as a function of T.

    [CO2]_aq,0 = K_H_CO2 * f_CO2.  ref: utilities/bulk_soln.py:40-41.
    """
    xp = _xp(temp)
    lnK = 93.4517 * (100.0 / temp) - 60.2409 + 23.3585 * xp.log(temp / 100.0)
    return xp.exp(lnK)


def sechenov_h_CO2(temp: Scalar, params: ParameterSet = DEFAULT_PARAMS):
    """h_CO2(T) = h_CO2_0 + h_CO2_T * (T - 298.15), m^3/kmol."""
    return params.sechenov_CO2_0 + params.sechenov_CO2_T * (temp - 298.15)


def saturation_prefactor(temp: float, fugacity_CO2: float) -> float:
    """fugacity_CO2 * K_H * 1000 (mol/m^3), the factor of 10^(-sechenov) in
    ``co2_saturation_conc``, as a host float computed as it computes it on
    tensors."""
    return fugacity_CO2 * float(henry_K_CO2(temp)) * 1000.0


def co2_saturation_conc(
    temp: Scalar,
    fugacity_CO2: Scalar,
    conc_ions: Optional[Mapping[str, Scalar]] = None,
    params: ParameterSet = DEFAULT_PARAMS,
    h_sechenov: Optional[Mapping[str, float]] = None,
) -> Scalar:
    """Dissolved-CO2 saturation concentration in mol/m^3.

    Equivalent of the reference ``CO2_conc`` (utilities/bulk_soln.py:32-54,
    3D/MPNP_CO2ER_pore.py:70-93).

    Parameters
    ----------
    temp: temperature in K (a float or a tensor).
    fugacity_CO2: CO2 fugacity in bar.
    conc_ions: mapping species-name -> concentration in mol/m^3 contributing
        to the salting-out sum.  Ions absent from the Sechenov table raise.
    h_sechenov: optional explicit Sechenov constants overriding the table
        (mapping name -> h_ion value, m^3/kmol).
    """
    if conc_ions is None:
        conc_ions = {}
    xp = _xp(temp, fugacity_CO2, *conc_ions.values())
    h_CO2 = sechenov_h_CO2(temp, params)

    # numpy keeps the reference's 0-d array start; on tensors a Python 0.0
    # adopts the first term's dtype and device
    sechenov = np.asarray(0.0) if xp is np else 0.0
    for ion, conc in conc_ions.items():
        h_ion = (h_sechenov[ion] if h_sechenov is not None
                 else params.sechenov_ion[ion])
        # concentrations enter in kmol/m^3
        sechenov = sechenov + (h_ion + h_CO2) * (conc / 1000.0)

    K_H = henry_K_CO2(temp)
    if xp is torch and not isinstance(K_H, torch.Tensor):
        K_H = float(K_H)
    return fugacity_CO2 * K_H * 1000.0 * 10.0 ** (-sechenov)



def equilibrium_gas_conc(
    gas: str,
    press_gas: Scalar,
    y_gas: Scalar,
    params: ParameterSet = DEFAULT_PARAMS,
):
    """Equilibrium dissolved-gas concentration at a gas/electrolyte interface
    via the constant Henry coefficients table (mol/m^3): a tensor when an
    argument is one, else a numpy value.

    eq_conc = H_gas * P * y_gas * density_water.  ref: 3D/MPNP_CO2ER_pore.py:253-255.
    """
    H = params.henry_const[gas]
    return _xp(press_gas, y_gas).asarray(
        H * press_gas * y_gas * params.sys_params.density_e)
