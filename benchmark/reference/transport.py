"""What the benchmark's transport models share (``models/<model>.py``
holds each model, written out from its configuration file). Each is a
backward-Euler step of Nernst-Planck transport with steric fluxes, the bicarbonate buffer reactions and Poisson's
equation with a concentration-dependent permittivity, all in scaled
units (concentrations over their bulk values, potential over the thermal
voltage, lengths over the domain length).

A problem gives the reference's finite-element code four things: the
quadrature-point integrand ``volume``, the boundary ``add_fluxes``, the
Dirichlet rows ``dirichlet`` and the step parameters ``theta``, which the
reference works out from the state the step starts from.
"""

from __future__ import annotations

import torch


def buffer_rates(uc, c0, scale_R, k, idx):
    """Scaled net production rates of the three buffer reactions
    (H2O <=> H+ + OH-, HCO3- + OH- <=> CO32- + H2O,
    CO2 + OH- <=> HCO3-); species outside them get 0."""
    c = uc * c0
    cH, cOH = c[..., idx["H"]], c[..., idx["OH"]]
    cHCO3, cCO32, cCO2 = c[..., idx["HCO3"]], c[..., idx["CO32"]], \
        c[..., idx["CO2"]]
    r_w = k["kw2"] * cH * cOH - k["kw1"]
    r_a = k["ka1"] * cHCO3 * cOH - k["ka2"] * cCO32
    r_b = k["kb1"] * cCO2 * cOH - k["kb2"] * cHCO3
    zero = torch.zeros_like(cOH)
    net = {"H": -r_w, "OH": -(r_w + r_a + r_b), "HCO3": -(r_a - r_b),
           "CO32": r_a, "CO2": -r_b}
    cols = [net.get(s, zero) for s in idx]
    return torch.stack(cols, dim=-1) * scale_R


class Transport:
    """Shared integrand: species rows (u - u_prev) / (dt * time_scale) - R
    against diffusion, migration and steric fluxes; Poisson's row."""

    def _setup(self, species, c0, D, L, inp, device, dtype):
        t = dict(device=device, dtype=dtype)
        nat = inp["natural"]
        self.ns = len(species)
        self.P = self.ns
        self.idx = {s: i for i, s in enumerate(species)}
        self.c0_t = torch.as_tensor([c0[s] for s in species], **t)
        self.z = torch.as_tensor([inp["z"][s] for s in species], **t)
        self.scale_R = torch.as_tensor(
            [L ** 2 / (D[s] * c0[s]) for s in species], **t)
        self.scale_vol = torch.as_tensor(
            [inp["a"][s] ** 3 * c0[s] * nat["N_A"] for s in species], **t)
        self.q = nat["F"] ** 2 * L ** 2 / (nat["eps_0"] * nat["R"] * self.T)
        self.eps_rel = nat["eps_rel"]
        self.rates = inp["rates"]
        cat = species[-1]
        self.hyd = (inp["hydration"][cat] * c0[cat], inp["hydration"]["H"]
                    * c0["H"], self.idx[cat])
        self.clip = inp["steric_clip"]

    def volume(self, u, gu, up, theta):
        ns, P = self.ns, self.P
        uc, guc, gp = u[..., :ns], gu[..., :ns, :], gu[..., P, :]
        R = buffer_rates(uc, self.c0_t, self.scale_R, self.rates, self.idx)
        fval_c = (uc - up[..., :ns]) / (theta["dt"] * self.time_scale) - R
        fgrad_c = guc + (self.z * uc)[..., None] * gp[..., None, :]
        denom = torch.clamp(1.0 - torch.sum(self.scale_vol * uc, -1),
                            min=self.clip)
        common = torch.einsum("j,...jd->...d", self.scale_vol, guc)
        fgrad_c = fgrad_c + (uc / denom[..., None])[..., None] \
            * common[..., None, :]
        w_cat, w_H, cat_i = self.hyd
        hyd = (w_cat * u[..., cat_i] + w_H * u[..., 0]) * 1.0e-3
        eps = self.eps_rel * (55.0 - hyd) / 55.0 + 6.0 * hyd / 55.0
        fval_p = self.q * torch.sum(self.z * self.c0_t * uc, -1)
        fgrad_p = -eps[..., None] * gp
        return (torch.cat([fval_c, fval_p[..., None]], -1),
                torch.cat([fgrad_c, fgrad_p[..., None, :]], -2))

    def initial_state(self):
        u = torch.ones((self.num_vertices, self.ns + 1), dtype=self.dtype,
                       device=self.device)
        u[:, self.P] = 0.0
        return u


def problem(cfg, voltage, device, dtype=torch.float64):
    """The model that ``cfg['model']`` names, at one operating voltage."""
    import importlib

    mod = importlib.import_module(f"benchmark.reference.models.{cfg['model']}")
    return mod.Problem(cfg, voltage, device, dtype)
