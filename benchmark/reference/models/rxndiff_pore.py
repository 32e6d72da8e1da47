"""The reaction-diffusion pore of the benchmark's configuration files."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import mesh as meshes
from benchmark.reference.transport import buffer_rates

#: the degree-2 rule on the triangle used for the boundary integrals: the
#: three edge midpoints in barycentric coordinates, weights 1/3 each (the
#: integrands are at most quadratic on a facet: a P1 shape function times
#: a constant or a P1 state)
FACET_POINTS = np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
FACET_WEIGHTS = np.full(3, 1.0 / 3.0)


def boundary_facets(points, cells, L, R):
    """{"wall": (F, 3), "exit": (F, 3)} vertex triples of the mesh's
    boundary facets: the faces that belong to one tetrahedron only, each
    marked when all three of its vertices satisfy a set's coordinate test
    (``meshes.pore_vertex_sets``), in the published order entry, exit,
    wall, a later mark replacing an earlier one."""
    faces = np.concatenate([cells[:, [1, 2, 3]], cells[:, [0, 2, 3]],
                            cells[:, [0, 1, 3]], cells[:, [0, 1, 2]]])
    key = np.sort(faces, axis=1)
    uniq, counts = np.unique(key, axis=0, return_counts=True)
    outer = uniq[counts == 1]
    sets = meshes.pore_vertex_sets(points, L, R)
    marker = np.zeros(len(outer), np.int64)
    for mark, name in ((1, "entry"), (3, "exit"), (2, "wall")):
        inside = np.zeros(len(points), bool)
        inside[sets[name]] = True
        marker[inside[outer].all(axis=1)] = mark
    return {"wall": outer[marker == 2], "exit": outer[marker == 3]}


def triangle_areas(points, tris):
    X = points[tris]
    return 0.5 * np.linalg.norm(
        np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]), axis=1)


class Problem:
    """The reaction-diffusion pore: seven neutral species (H+, OH-, HCO3-,
    CO32-, CO2, CO, H2) with the buffer reactions, diffusion at the
    porous-layer diffusivities and no migration, steric or Poisson terms;
    the gas species' saturation values at the entry (z = 0), the CO2 one
    from Sechenov's salting-out at the medians of the state the step
    starts from, the cation by electroneutrality; a constant electrode
    flux of OH-, CO2, CO and H2 through the wall; a Sherwood mass-transfer
    flux k (u - 1) of every species through the exit (z = 1). No
    voltage enters the model: the operating voltage is ignored."""

    def __init__(self, cfg, voltage, device, dtype):
        inp, prog = cfg["inputs"], cfg["program"]
        L, R = prog["L"], prog["R"]
        res = prog.get("mesh_resolution")
        pts, cells = meshes.cylinder(L, R, *(res or (None, None)))
        self.points, self.cells = pts, cells
        self.num_vertices = len(pts)
        self.device, self.dtype = device, dtype
        t = dict(device=device, dtype=dtype)
        nat, sysp = inp["natural"], inp["system"]
        self.T = sysp["T"]
        species = tuple(inp["species"])
        self.ns = len(species)
        self.idx = {s: i for i, s in enumerate(species)}
        por = inp["porous"]
        D_plain = {s: inp["D"][s] for s in species}
        D = {s: D_plain[s] * por["porosity"] * por["constrictivity"]
             * por["geom_multiplier"] / por["tortuosity"] ** 2
             for s in species}
        gas = inp["gas"]
        y_CO = 0.9 * (1.0 - gas["y_CO2"])
        y = {"CO2": gas["y_CO2"], "CO": y_CO, "H2": 1.0 - gas["y_CO2"] - y_CO}
        eq = {g: inp["henry"][g] * gas["press"] * y[g] * sysp["density_e"]
              for g in y}
        c0 = {s: inp["bulk"][s] for s in species if s in inp["bulk"]}
        c0["CO"], c0["H2"] = 0.01 * eq["CO"], 0.01 * eq["H2"]
        self.c0 = c0
        self.c0_t = torch.as_tensor([c0[s] for s in species], **t)
        self.scale_R = torch.as_tensor(
            [L ** 2 / (D[s] * c0[s]) for s in species], **t)
        self.rates = inp["rates"]
        self.dt = prog["time_step"] / (L ** 2 / D["CO32"])
        self.fugacity = gas["y_CO2"] * gas["press"]
        self.sechenov = inp["sechenov"]
        self.cation = inp["cation"]

        # the boundary fluxes, in the scaled units of the weak form
        wall, F = inp["wall"], nat["F"]
        i_planar = wall["current_rough"] / wall["roughness_factor"]
        co_fe = 1.0 - wall["H2_FE"]
        pref = {s: L / (D[s] * c0[s] * F) for s in species}
        g = np.zeros(self.ns)
        g[self.idx["CO2"]] = pref["CO2"] * i_planar * 0.5 * co_fe
        g[self.idx["CO"]] = -pref["CO"] * i_planar * 0.5 * co_fe
        g[self.idx["H2"]] = -pref["H2"] * i_planar * 0.5 * wall["H2_FE"]
        g[self.idx["OH"]] = -pref["OH"] * i_planar
        self.wall_flux = torch.as_tensor(g, **t)
        Re = (sysp["density_e"] * (sysp["vel_e"] / sysp["A_cross_e"])
              * sysp["L_electrode"] * sysp["flow_geom_multiplier"]
              / sysp["viscosity_e"])
        k = np.zeros(self.ns)
        for s in species:
            Sc = sysp["viscosity_e"] / (sysp["density_e"] * D_plain[s])
            Sh = 1.017 * (2.0 * sysp["L_electrode"] / sysp["L_cross_e"]
                          * Re * Sc) ** (1.0 / 3.0)
            k[self.idx[s]] = (L * (D_plain[s] / sysp["L_electrode"]) * Sh
                              / D[s])
        self.exit_coeff = torch.as_tensor(k, **t)
        facets = boundary_facets(pts, cells, L, R)
        self.facets = {}
        for name, tris in facets.items():
            self.facets[name] = (
                torch.as_tensor(tris, device=device),
                torch.as_tensor(triangle_areas(pts, tris), **t))
        self.facet_N = torch.as_tensor(FACET_POINTS, **t)
        self.facet_w = torch.as_tensor(FACET_WEIGHTS, **t)

        sets = meshes.pore_vertex_sets(pts, L, R)
        mask = np.zeros((len(pts), self.ns), bool)
        vals = np.zeros((len(pts), self.ns))
        for gname in ("CO2", "CO", "H2"):
            mask[sets["entry"], self.idx[gname]] = True
            vals[sets["entry"], self.idx[gname]] = eq[gname] / c0[gname]
        self.entry = torch.as_tensor(sets["entry"], device=device)
        self.mask = torch.as_tensor(mask, device=device)
        self.values = torch.as_tensor(vals, **t)

    def volume(self, u, gu, up, theta):
        R = buffer_rates(u, self.c0_t, self.scale_R, self.rates, self.idx)
        return (u - up) / theta["dt"] - R, gu

    def facet_rows(self, name, gq):
        """Rows (N, f) of the integral of N_a g over the named facets, from
        g's values at each facet's points, (F, Q, f)."""
        tris, area = self.facets[name]
        contrib = area[:, None, None] * torch.einsum(
            "q,qa,fqc->fac", self.facet_w, self.facet_N, gq)
        rows = torch.zeros((self.num_vertices, self.ns), dtype=self.dtype,
                           device=self.device)
        return rows.index_add_(0, tris.reshape(-1),
                               contrib.reshape(-1, self.ns))

    def add_fluxes(self, r, u, theta):
        n_wall, n_q = len(self.facets["wall"][0]), len(FACET_WEIGHTS)
        wall = self.wall_flux.expand(n_wall, n_q, self.ns)
        u_q = torch.einsum("qa,fac->fqc", self.facet_N,
                           u[self.facets["exit"][0]])
        return (r + self.facet_rows("wall", wall)
                + self.facet_rows("exit", self.exit_coeff * (u_q - 1.0)))

    @staticmethod
    def median(x):
        s = torch.sort(x).values
        n = s.shape[0]
        return (s[(n - 1) // 2] + s[n // 2]) * 0.5

    def co2_entry(self, u_prev):
        """Sechenov-corrected CO2 saturation over its bulk value; the
        cation's concentration is HCO3- + 2 CO32- + OH- - H+."""
        sec, T = self.sechenov, self.T
        h_co2 = sec["h_CO2_0"] + sec["h_CO2_T"] * (T - 298.15)
        c = {s: self.median(u_prev[:, self.idx[s]]) * self.c0[s]
             for s in ("H", "OH", "HCO3", "CO32")}
        c[self.cation] = c["HCO3"] + 2 * c["CO32"] + c["OH"] - c["H"]
        total = 0.0
        for ion in ("OH", "HCO3", "CO32", self.cation):
            total = total + (sec["ion"][ion] + h_co2) * (c[ion] / 1000.0)
        lnK = 93.4517 * (100.0 / T) - 60.2409 + 23.3585 * math.log(T / 100)
        sat = self.fugacity * math.exp(lnK) * 1000.0 * 10.0 ** (-total)
        return sat / self.c0["CO2"]

    def theta(self, u_prev, step_index, dt_scale=1.0):
        return {"dt": self.dt * dt_scale, "co2": self.co2_entry(u_prev)}

    def dirichlet(self, theta):
        vals = self.values.clone()
        vals[self.entry, self.idx["CO2"]] = theta["co2"]
        return self.mask, vals

    def initial_state(self):
        return torch.ones((self.num_vertices, self.ns), dtype=self.dtype,
                          device=self.device)
