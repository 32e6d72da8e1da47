"""Electrolyte chemistry: buffer kinetics, gas solubility, bulk equilibration."""

from gmpnp_tpu_torch.chem.henry import co2_saturation_conc, henry_K_CO2
from gmpnp_tpu_torch.chem.reactions import buffer_rates, BufferKinetics
from gmpnp_tpu_torch.chem.bulk import equilibrate_electrolyte, BulkSolution

__all__ = [
    "co2_saturation_conc",
    "henry_K_CO2",
    "buffer_rates",
    "BufferKinetics",
    "equilibrate_electrolyte",
    "BulkSolution",
]
