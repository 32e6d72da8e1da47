"""The GMPNP pore of the benchmark's configuration files."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import mesh as meshes
from benchmark.reference.transport import Transport


class Problem(Transport):
    """The GMPNP pore: 8 species and the potential; Dirichlet values only
    (the published script's boundary-flux statements are no-ops); the CO2
    entry value follows Sechenov's salting-out from the medians of the
    state the step starts from."""

    def __init__(self, cfg, voltage, device, dtype):
        inp, prog = cfg["inputs"], cfg["program"]
        L, R = prog["L"], prog["R"]
        res = prog.get("mesh_resolution")
        pts, cells = meshes.cylinder(L, R, *(res or (None, None)))
        self.points, self.cells = pts, cells
        self.num_vertices = len(pts)
        self.device, self.dtype = device, dtype
        nat, sysp = inp["natural"], inp["system"]
        self.T = sysp["T"]
        species = tuple(inp["species"])
        self.cation = species[-1]
        por = inp["porous"]
        D = {s: inp["D"][s] * por["porosity"] * por["constrictivity"]
             * por["geom_multiplier"] / por["tortuosity"] ** 2
             for s in species}
        gas = inp["gas"]
        y_CO = 0.9 * (1.0 - gas["y_CO2"])
        y = {"CO2": gas["y_CO2"], "CO": y_CO, "H2": 1.0 - gas["y_CO2"] - y_CO}
        eq = {g: inp["henry"][g] * gas["press"] * y[g] * sysp["density_e"]
              for g in y}
        c0 = dict(inp["bulk"])
        c0["CO"], c0["H2"] = 0.01 * eq["CO"], 0.01 * eq["H2"]
        self.c0 = c0
        self._setup(species, c0, D, L, inp, device, dtype)
        self.time_scale = 1.0
        self.dt = prog["time_step"] / (L ** 2 / D["CO32"])
        self.fugacity = gas["y_CO2"] * gas["press"]
        self.sechenov = inp["sechenov"]
        sets = meshes.pore_vertex_sets(pts, L, R)
        mask = np.zeros((len(pts), self.ns + 1), bool)
        vals = np.zeros((len(pts), self.ns + 1))
        P, ix = self.P, self.idx
        for name, value in (("entry", 0.0), ("exit", 0.0),
                            ("wall", voltage)):
            mask[sets[name], P] = True
            vals[sets[name], P] = value
        for g in ("CO2", "CO", "H2"):
            mask[sets["entry"], ix[g]] = True
            vals[sets["entry"], ix[g]] = eq[g] / c0[g]
        self.entry = torch.as_tensor(sets["entry"], device=device)
        self.mask = torch.as_tensor(mask, device=device)
        self.values = torch.as_tensor(vals, dtype=dtype, device=device)

    @staticmethod
    def median(x):
        s = torch.sort(x).values
        n = s.shape[0]
        return (s[(n - 1) // 2] + s[n // 2]) * 0.5

    def co2_entry(self, u_prev):
        """Sechenov-corrected CO2 saturation over its bulk value."""
        sec, T = self.sechenov, self.T
        h_co2 = sec["h_CO2_0"] + sec["h_CO2_T"] * (T - 298.15)
        total = 0.0
        for ion in ("OH", "HCO3", "CO32", self.cation):
            c = self.median(u_prev[:, self.idx[ion]]) * self.c0[ion]
            total = total + (sec["ion"][ion] + h_co2) * (c / 1000.0)
        lnK = 93.4517 * (100.0 / T) - 60.2409 + 23.3585 * math.log(T / 100)
        sat = self.fugacity * math.exp(lnK) * 1000.0 * 10.0 ** (-total)
        return sat / self.c0["CO2"]

    def theta(self, u_prev, step_index, dt_scale=1.0):
        return {"dt": self.dt * dt_scale, "co2": self.co2_entry(u_prev)}

    def add_fluxes(self, r, u, theta):
        return r

    def dirichlet(self, theta):
        vals = self.values.clone()
        vals[self.entry, self.idx["CO2"]] = theta["co2"]
        return self.mask, vals
