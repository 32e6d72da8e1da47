"""The MPNP electric double layer of the benchmark's configuration
files."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import mesh as meshes
from benchmark.reference.transport import Transport


class Problem(Transport):
    """The MPNP double layer on [0, 1] (x over L_n): fluxes of H+, OH- and
    CO2 at the outer Helmholtz plane (x = 0), where the potential is the
    operating voltage; bulk values at x = 1."""

    def __init__(self, cfg, voltage, device, dtype):
        inp, prog = cfg["inputs"], cfg["program"]
        L = prog["L_n"]
        pts, cells = meshes.graded_interval(L)
        self.points, self.cells = pts, cells
        self.num_vertices = len(pts)
        self.device, self.dtype = device, dtype
        nat = inp["natural"]
        self.T = nat["T"]
        species = tuple(inp["species"])
        D = {s: inp["D"][s] for s in species}
        c0 = dict(inp["bulk"])
        self.c0 = c0
        self._setup(species, c0, D, L, inp, device, dtype)
        conc = prog["concentration_elec"]
        L_debye = math.sqrt(nat["eps_0"] * nat["eps_rel"] * nat["k_B"]
                            * nat["T"] / (2 * nat["e_0"] ** 2 * conc * 1.0e3
                                          * nat["N_A"]))
        self.time_scale = L_debye / L
        tau = L_debye * L / D["CO32"]
        sch = inp["schedule"]
        self.dt1, self.dt2, self.n1 = (sch["dt1_s"] / tau, sch["dt2_s"] / tau,
                                       sch["n1"])
        cur, h2 = prog["current_OHP_ss"], prog["H2_FE"]
        pref = {s: L / (D[s] * c0[s] * nat["F"]) for s in ("H", "OH", "CO2")}
        flux = np.zeros(self.ns + 1)
        flux[self.idx["OH"]] = -pref["OH"] * cur
        flux[self.idx["CO2"]] = pref["CO2"] * cur * 0.5 * (1.0 - h2)
        self.flux = torch.as_tensor(flux, dtype=dtype, device=device)
        x = pts[:, 0]
        self.left = int(np.nonzero(meshes.near(x, 0.0, 1e-14))[0][0])
        right = np.nonzero(meshes.near(x, 1.0, 1e-14))[0]
        mask = np.zeros((len(pts), self.ns + 1), bool)
        vals = np.zeros((len(pts), self.ns + 1))
        mask[right, :] = True
        vals[right, :self.ns] = 1.0
        mask[self.left, self.P] = True
        vals[self.left, self.P] = voltage
        self.mask = torch.as_tensor(mask, device=device)
        self.values = torch.as_tensor(vals, dtype=dtype, device=device)

    def theta(self, u_prev, step_index, dt_scale=1.0):
        dt = self.dt1 if step_index < self.n1 else self.dt2
        return {"dt": dt * dt_scale}

    def add_fluxes(self, r, u, theta):
        r = r.clone()
        r[self.left] = r[self.left] + self.flux
        return r

    def dirichlet(self, theta):
        return self.mask, self.values
