"""3D cylindrical-pore models for CO2ER: GMPNP and reaction–diffusion.

Port of ``gmpnp_tpu/models/pore_3d.py``:

- GMPNP (``physics='GMPNP'``): 8 species (H+, OH-, HCO3-, CO32-, CO2, CO,
  H2, cat+) + potential, steric fluxes, eps(c) permittivity,
  wall-potential Dirichlet (3D/MPNP_CO2ER_pore.py:96-1085);
- reaction-diffusion (``physics='rxn_diff'``): the 7-species neutral
  comparison model (3D/rxn_diff_CO2ER_pore.py:95-784), the cation
  recovered by electroneutrality.

The Sechenov-corrected CO2 entry Dirichlet value is recomputed every step
from median ion concentrations (3D/MPNP_CO2ER_pore.py:815-838) on the
device, in one kernel launch on the card (``ops.sechenov``).

**Orphaned-flux quirk.**  ``faithful=True`` (default) reproduces the
published GMPNP script, whose boundary-flux terms are no-op statements, so
only the Dirichlet BCs drive the solve; ``faithful=False`` includes the wall
and exit fluxes (see the reference module's docstring).  The rxn-diff
physics always includes them.

``run(cfg, shard=K)`` runs the transient z-slab-sharded over K ranks
(``parallel.shard``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gmpnp_tpu_torch.chem.henry import saturation_prefactor, sechenov_h_CO2
from gmpnp_tpu_torch.chem.reactions import BufferKinetics
from gmpnp_tpu_torch.constants import ParameterSet
from gmpnp_tpu_torch.fem import DirichletBC, FemSpace, WeakForm
from gmpnp_tpu_torch.fem.projection import project_cellwise, project_gradient
from gmpnp_tpu_torch.io import make_run_dir, save_metadata, save_npz
from gmpnp_tpu_torch.io.checkpoint import (
    TransientCheckpointer,
    run_transient_checkpointed,
)
from gmpnp_tpu_torch.io.vtk import write_pvd, write_vtu
from gmpnp_tpu_torch.mesh import (
    cylinder_mesh,
    pore_boundary_markers,
    read_dolfin_xml,
)
from gmpnp_tpu_torch.models import base
from gmpnp_tpu_torch.ops.pore_residual import (
    MAX_FIELDS, MIN_FIELDS, pack_constants)
# median: the medians' midpoint rule, importable from here as before
from gmpnp_tpu_torch.ops.sechenov import (  # noqa: F401
    SechenovConstants, median, sechenov_co2)
from gmpnp_tpu_torch.solve.timeloop import (
    LinearConfig,
    NewtonConfig,
    StepStats,
    calibrate_refresh,
    make_carried_step,
    make_implicit_step,
    make_recovering_carried_step,
    make_recovering_step,
    run_transient,
)

S1, S2, S3 = 1, 2, 3  # entry, wall, exit markers (ref :377-379)


@dataclass(frozen=True)
class Pore3DConfig:
    """The fields and defaults of ``gmpnp_tpu.models.pore_3d.Pore3DConfig``
    (see its comments)."""
    # reference CLI flags (3D/MPNP_CO2ER_pore.py:1088-1235)
    physics: str = "GMPNP"             # 'GMPNP' | 'rxn_diff'
    # (rxn_diff ignores voltage_multiplier)
    concentration_elec: float = 1.0
    voltage_multiplier: float = -1.0
    H2_FE: float = 0.05
    current_rough: float = 3000.0      # A/m^2 on the rough electrode
    L: float = 100.0e-9
    R: float = 5.0e-9
    cation: str = "K"
    press_gas: float = 1.0             # bar
    pore_geom_multiplier: float = 1.0
    porosity_eff: float = 0.5
    tortuosity_eff: float = 1.5
    constrictivity_eff: float = 0.9
    params_file: Optional[str] = None
    y_CO2: float = 0.95
    electrolyte_flow_geom_multiplier: float = 1.0
    roughness_factor: float = 150.0
    # reference hardcoded schedule (ref :358-359)
    time_step: float = 1.0e-3
    total_sim_time: float = 1.0
    # framework knobs
    faithful: bool = True       # reproduce the orphaned-flux published solver
    # lower clamp on the steric denominator 1 - sum_j a_j^3 N_A C0_j u_j
    # (inactive at converged states, denom ~ 0.5); 0 disables
    steric_clip: float = 1.0e-6
    quad_degree: int = 2
    mesh_resolution: Optional[Tuple[int, int]] = None  # (n_rings, n_layers)
    # divergence recovery: retry a non-converged step with dt halved up to
    # this many times; None = 3 for full-length runs, 0 with n_steps
    dt_retries: Optional[int] = None
    # staged first step(s): dt * dt_first_scale on the first dt_first_steps
    dt_first_scale: float = 1.0
    dt_first_steps: int = 1
    newton: NewtonConfig = field(default_factory=lambda: NewtonConfig(
        max_iter=50, rtol=1.0e-4, atol=1.0e-4, relaxation=0.9))  # ref :789-799
    # the z-slab block-banded direct solver (solve.slab)
    linear: LinearConfig = field(default_factory=lambda: LinearConfig(
        kind="slab_direct", tol=1.0e-6, max_refine=40))

    @property
    def species(self) -> Tuple[str, ...]:
        if self.physics == "GMPNP":
            return ("H", "OH", "HCO3", "CO32", "CO2", "CO", "H2", self.cation)
        return ("H", "OH", "HCO3", "CO32", "CO2", "CO", "H2")

    @property
    def n_fields(self) -> int:
        return len(self.species) + (1 if self.physics == "GMPNP" else 0)

    @property
    def identifier(self) -> str:
        core = (f"L_{int(self.L * 1e9)}_R_{int(self.R * 1e9)}"
                f"_P_g_{self.press_gas}_D_eff_{self.pore_geom_multiplier}"
                f"_Re_{self.electrolyte_flow_geom_multiplier}"
                f"_rough_{self.roughness_factor}")
        if self.physics == "GMPNP":
            return f"v_{self.voltage_multiplier}_{core}"
        return core


def _load_pore_mesh(cfg: Pore3DConfig):
    """Reference mesh file (GMPNP_UTILITIES) if present, else the
    generator."""
    util = os.environ.get("GMPNP_UTILITIES")
    name = f"L_{int(cfg.L * 1e9)}_R_{int(cfg.R * 1e9)}.xml"
    if util and os.path.exists(os.path.join(util, name)):
        mesh = read_dolfin_xml(os.path.join(util, name))
    else:
        kw = {}
        if cfg.mesh_resolution is not None:
            kw = {"n_rings": cfg.mesh_resolution[0],
                  "n_layers": cfg.mesh_resolution[1]}
        mesh = cylinder_mesh(cfg.L, cfg.R, **kw)
    return pore_boundary_markers(mesh, cfg.L, cfg.R)


@dataclass(frozen=True)
class PoreVolumeSpec:
    """The pore's volume integrand and its constants (``build``):
    ``n_fields`` = species (+ the potential with ``gmpnp``), the buffer
    kinetics (species order, bulk concentrations c0, ``scale_R``, rate
    constants), and for the GMPNP terms the charges ``z``, the steric
    ``scale_vol``, the Poisson factor ``q``, ``steric_clip`` (0: off), the
    hydration constants and the cation and proton indices.  ``volume`` is
    the form's integrand; ``constants`` the same constants as the element
    kernel reads them (``ops.pore_residual``)."""

    n_fields: int
    kinetics: BufferKinetics
    gmpnp: bool
    z: tuple
    scale_vol: tuple
    q: float
    steric_clip: float
    w_cat: float = 0.0
    C0_cat: float = 0.0
    w_H: float = 0.0
    C0_H: float = 0.0
    eps_rel: float = 0.0
    cat_index: int = -1
    proton_index: int = 0
    #: ``volume``'s tensors and ``constants`` on each device they were made
    #: for
    _on_device: dict = field(default_factory=dict, init=False,
                             compare=False, repr=False)

    def __post_init__(self):
        ns = len(self.kinetics.species)
        if (self.n_fields != ns + int(self.gmpnp)
                or not MIN_FIELDS <= self.n_fields <= MAX_FIELDS):
            raise ValueError(f"PoreVolumeSpec: {ns} species and gmpnp="
                             f"{self.gmpnp} do not make {self.n_fields} "
                             f"fields, {MIN_FIELDS} to {MAX_FIELDS}")
        if len(self.z) != ns or len(self.scale_vol) != ns:
            raise ValueError("PoreVolumeSpec: z and scale_vol want one "
                             "entry per species")
        if self.gmpnp and not 0 <= self.cat_index < ns:
            raise ValueError(f"PoreVolumeSpec: cation index "
                             f"{self.cat_index} outside the species")

    def volume(self, u, gu, up, x, theta):
        """The integrand at one quadrature point (``WeakForm.volume``; pure
        torch, runs under vmap/jacfwd)."""
        ns = len(self.kinetics.species)
        uc, guc, upc = u[:ns], gu[:ns], up[:ns]
        R = self.kinetics(uc)
        fval_c = (uc - upc) / theta["dt"] - R
        if not self.gmpnp:
            return fval_c, guc
        z, scale_vol, c0, steric_clip = self._tensors(u.device)
        P = ns
        fgrad_c = guc + z[:, None] * uc[:, None] * gu[P][None, :]
        denom = 1.0 - torch.sum(scale_vol * uc)
        if self.steric_clip:
            # torch.maximum splits the derivative 0.5/0.5 at a tie, as
            # jnp.maximum does (torch.clamp_min would give 1/0)
            denom = torch.maximum(denom, steric_clip)
        common = torch.einsum("j,jd->d", scale_vol, guc)
        fgrad_c = fgrad_c + (uc / denom)[:, None] * common[None, :]
        hyd = (self.w_cat * u[self.cat_index] * self.C0_cat
               + self.w_H * u[self.proton_index] * self.C0_H) * 1.0e-3
        eps = self.eps_rel * (55.0 - hyd) / 55.0 + 6.0 * hyd / 55.0
        fval_p = self.q * torch.sum(z * c0 * uc)
        fgrad_p = -eps * gu[P]
        fval = torch.cat([fval_c, fval_p[None]])
        fgrad = torch.cat([fgrad_c, fgrad_p[None, :]])
        return fval, fgrad

    def warm(self, device) -> None:
        """Make ``volume``'s tensors and ``constants`` on ``device`` now
        (``build``), not inside the first call."""
        self._tensors(device)
        self.constants(device)

    def _tensors(self, device):
        """z, scale_vol, c0 and steric_clip as f64 tensors on ``device``."""
        key = ("tensors", str(torch.device(device)))
        if key not in self._on_device:
            f64 = dict(dtype=torch.float64, device=device)
            self._on_device[key] = tuple(
                torch.as_tensor(v, **f64) for v in (
                    self.z, self.scale_vol, self.kinetics.c0,
                    self.steric_clip))
        return self._on_device[key]

    def pack(self) -> tuple:
        """The constants as the kernel reads them
        (``ops.pore_residual.pack_constants``)."""
        species = self.kinetics.species
        idx = {s: i for i, s in enumerate(species)}
        k = self.kinetics.rates
        c0 = self.kinetics.c0
        return pack_constants(dict(
            f=self.n_fields, ns=len(species), gmpnp=int(self.gmpnp),
            clip_on=int(bool(self.steric_clip)), H=idx.get("H", -1),
            OH=idx["OH"], HCO3=idx["HCO3"], CO32=idx["CO32"],
            CO2=idx["CO2"], cat=self.cat_index, proton=self.proton_index,
            kw1=k.kw1, kw2=k.kw2, ka1=k.ka1, ka2=k.ka2, kb1=k.kb1,
            kb2=k.kb2, q=self.q, steric_clip=self.steric_clip,
            w_cat=self.w_cat, C0_cat=self.C0_cat, w_H=self.w_H,
            C0_H=self.C0_H, eps_rel=self.eps_rel, z=self.z,
            scale_vol=self.scale_vol, c0=c0, scale_R=self.kinetics.scale_R,
            zc0=tuple(a * b for a, b in zip(self.z, c0))))

    def constants(self, device) -> torch.Tensor:
        """``pack()`` as an f64 tensor on ``device``."""
        key = ("packed", str(torch.device(device)))
        if key not in self._on_device:
            self._on_device[key] = torch.tensor(
                self.pack(), dtype=torch.float64, device=device)
        return self._on_device[key]


@dataclass
class Pore3DProgram:
    config: Pore3DConfig
    space: FemSpace
    form: WeakForm
    bc: DirichletBC
    mesh: "base.Mesh"
    params: ParameterSet
    bulk_conc: Dict[str, float]
    diff_coeff: Dict[str, float]
    diff_coeff_eff: Dict[str, float]
    time_constant: float
    dt_scaled: float
    num_steps: int
    thermal_voltage: float
    eq_conc: Dict[str, float]          # eq CO2/CO/H2 at S1 (mol/m^3)
    fugacity_CO2: float
    h_sechenov: Dict[str, float]
    s1_verts: np.ndarray
    current_planar: float
    idx: Dict[str, int]
    sechenov: SechenovConstants
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        self._s1 = torch.as_tensor(self.s1_verts, dtype=torch.int64,
                                   device=self.device)

    def _theta_of_carry(self, carry, i):
        """Per-step Sechenov CO2 Dirichlet value from the previous solution's
        field medians (ref :815-838; rxn-diff recovers the cation by
        electroneutrality, 3D/rxn_diff_CO2ER_pore.py:556-568), one kernel
        launch on the card (``ops.sechenov_co2``), and the step's dt (staged
        on the first ``dt_first_steps`` steps)."""
        cfg = self.config
        u, _ = carry
        dt = self.dt_scaled
        if cfg.dt_first_scale != 1.0:
            dt = dt * (cfg.dt_first_scale if int(i) < cfg.dt_first_steps
                       else 1.0)
        return {"dt": dt, "co2_s1": sechenov_co2(u, self.sechenov)}

    def _bc_of_theta(self, theta):
        return self.bc.set_value(self._s1, self.idx["CO2"], theta["co2_s1"])

    def initial_state(self) -> torch.Tensor:
        """All concentrations at bulk (1.0), the GMPNP potential grounded."""
        cfg = self.config
        u0 = torch.ones((self.space.num_vertices, cfg.n_fields),
                        dtype=torch.float64, device=self.device)
        if cfg.physics == "GMPNP":
            u0[:, len(cfg.species)] = 0.0
        return u0

    def run(self, n_steps: Optional[int] = None,
            record_full: bool = True, record_stride: int = 1,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 100):
        """Run the transient; returns (u0, u_hist, stats, u_final).

        record_stride bounds the recorded history to every k-th step;
        checkpoint_dir enables chunked checkpointing with automatic resume
        from the latest step (io.checkpoint).  A run resumed at its final
        step returns the checkpointed state as the single history record
        and stats None.  ``refresh='auto'`` is resolved first by timing
        both modes (``calibrate_refresh``); the choice is kept in
        ``self.refresh_calibration``."""
        cfg = self.config
        n = self.num_steps if n_steps is None else n_steps
        retries = cfg.dt_retries
        if retries is None:
            retries = 3 if n_steps is None else 0
        if cfg.linear.refresh == "auto":
            mode, times = calibrate_refresh(
                self.space, self.form, cfg.newton, cfg.linear,
                self._bc_of_theta, self.initial_state(),
                self._theta_of_carry)
            self.refresh_calibration = dict(times, mode=mode)
            cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
                cfg.linear, refresh=mode))
        carried = (cfg.linear.kind == "slab_direct"
                   and cfg.linear.refresh == "carried")
        if carried:
            # carried-factor chord Newton: the slab factorization rides
            # from step to step and refreshes lazily
            make = (make_recovering_carried_step if retries > 0
                    else make_carried_step)
            kw = {"max_retries": retries} if retries > 0 else {}
            step, prep_init = make(self.space, self.form, cfg.newton,
                                   cfg.linear, bc_of_theta=self._bc_of_theta,
                                   **kw)
        elif retries > 0:
            step = make_recovering_step(
                self.space, self.form, cfg.newton, cfg.linear,
                bc_of_theta=self._bc_of_theta, max_retries=retries)
        else:
            step = make_implicit_step(
                self.space, self.form, cfg.newton, cfg.linear,
                bc_of_theta=self._bc_of_theta)
        u0 = self.initial_state()
        carry0 = (u0, 0.0)
        if checkpoint_dir:
            state_init = None
            if carried:
                state_init = lambda carry, i: prep_init(
                    carry[0], self._theta_of_carry(carry, i))
            ckpt = TransientCheckpointer(checkpoint_dir, cfg=cfg)
            (u_final, _), ys = run_transient_checkpointed(
                step, carry0, n, ckpt, chunk=checkpoint_every,
                theta_of_carry=self._theta_of_carry,
                step_state_init=state_init)
            if ys is None:
                # resumed at the final step: no steps ran; the checkpointed
                # final state is the single history record, so the writers
                # still produce the finished run's outputs
                return u0, u_final[None], None, u_final
            u_hist, stats = ys
            return u0, u_hist, stats, u_final
        record = None if record_full else (
            lambda u, stats: (u[self._s1[:1]], stats))
        state0 = (prep_init(u0, self._theta_of_carry(carry0, 0))
                  if carried else None)
        final, ys = run_transient(
            step, carry0, n, theta_of_carry=self._theta_of_carry,
            record=record, record_stride=record_stride, step_state0=state0)
        u_hist, stats = ys
        return u0, u_hist, stats, final[0]


def build(cfg: Pore3DConfig, device="cuda") -> Pore3DProgram:
    """Build the program on ``device`` (tables, BCs and form constants are
    device tensors)."""
    if cfg.physics not in ("GMPNP", "rxn_diff"):
        raise ValueError(f"unknown physics {cfg.physics!r}")
    gmpnp = cfg.physics == "GMPNP"
    device = torch.device(device)
    f64 = dict(dtype=torch.float64, device=device)
    params = base.load_params(cfg.params_file)
    nat = params.nat_const
    sysp = params.sys_params
    species = cfg.species
    ns = len(species)
    nf = cfg.n_fields
    idx = {s: i for i, s in enumerate(species)}
    P = ns if gmpnp else None

    # effective in-layer diffusivities (Brakel & Heertjes form, ref :147-158)
    diff_coeff = {s: params.D(s) for s in species}
    diff_coeff_eff = {
        s: (diff_coeff[s] * cfg.porosity_eff * cfg.constrictivity_eff
            * cfg.pore_geom_multiplier) / cfg.tortuosity_eff ** 2
        for s in species}

    # gas split at the CL/DM interface: 90% CO / 10% H2 of the non-CO2
    # fraction (ref :217-219)
    y_CO = 0.9 * (1.0 - cfg.y_CO2)
    y_H2 = 1.0 - cfg.y_CO2 - y_CO
    fugacity_CO2 = cfg.y_CO2 * cfg.press_gas

    bulk = base.load_bulk(cfg.concentration_elec, params)
    conc = bulk.concentrations("pre")   # 3D seeds from pre-CO2 (ref :236-238)
    bulk_conc = {s: conc.get(s, conc.get("K")) for s in species}

    # equilibrium dissolved-gas concentrations at S1 (ref :253-255)
    eq_conc = {
        "CO2": params.henry_const["CO2"] * cfg.press_gas * cfg.y_CO2
        * sysp.density_e,
        "CO": params.henry_const["CO"] * cfg.press_gas * y_CO
        * sysp.density_e,
        "H2": params.henry_const["H2"] * cfg.press_gas * y_H2
        * sysp.density_e,
    }
    # bulk CO/H2 assumed at 1% of the S1 equilibrium value (ref :257-259)
    bulk_conc["CO"] = 0.01 * eq_conc["CO"]
    bulk_conc["H2"] = 0.01 * eq_conc["H2"]

    time_constant = cfg.L ** 2 / diff_coeff_eff["CO32"]
    dt_scaled = cfg.time_step / time_constant
    num_steps = int(cfg.total_sim_time / cfg.time_step)

    kin = BufferKinetics.build(
        species, bulk_conc,
        {s: diff_coeff_eff[s] for s in species},
        cfg.L, params.rate_constants)

    q = (nat.F ** 2 * cfg.L ** 2) / (nat.eps_0 * nat.R * sysp.T)
    thermal_voltage = nat.k_B * sysp.T / nat.e_0

    J_pref = {s: cfg.L / (diff_coeff_eff[s] * bulk_conc[s]) for s in species}

    # Sherwood mass-transfer coefficients at the pore exit (ref :297-321;
    # note they use the *plain* diffusivities)
    Re = (sysp.density_e * (sysp.vel_e / sysp.A_cross_e) * sysp.L_electrode
          * cfg.electrolyte_flow_geom_multiplier) / sysp.viscosity_e
    k_elec = {}
    for s in species:
        Sc = sysp.viscosity_e / (sysp.density_e * diff_coeff[s])
        Sh = 1.017 * ((sysp.L_electrode * 2 / sysp.L_cross_e)
                      * Re * Sc) ** (1.0 / 3.0)
        k_elec[s] = (diff_coeff[s] / sysp.L_electrode) * Sh

    current_planar = cfg.current_rough / cfg.roughness_factor
    CO_FE = 1.0 - cfg.H2_FE
    wall_flux = {
        "CO2": (J_pref["CO2"] / nat.F) * current_planar * 0.5 * CO_FE,
        "CO": (J_pref["CO"] / nat.F) * current_planar * 0.5 * CO_FE * (-1.0),
        "H2": (J_pref["H2"] / nat.F) * current_planar * 0.5 * cfg.H2_FE
        * (-1.0),
        "OH": (J_pref["OH"] / nat.F) * current_planar * (-1.0),
    }
    exit_coeff = {s: J_pref[s] * k_elec[s] * bulk_conc[s] for s in species}

    if gmpnp:
        w_cat = params.w(cfg.cation)
        w_H = params.w("H")
        C0_cat = bulk_conc[cfg.cation]
        C0_H = bulk_conc["H"]
        eps_rel = nat.eps_rel
        cat_i = idx[cfg.cation]

    boundary = {}
    if not gmpnp or not cfg.faithful:
        wall_g = torch.zeros(nf, **f64)
        for s in ("OH", "CO2", "CO", "H2"):
            wall_g[idx[s]] = wall_flux[s]
        exit_c = torch.zeros(nf, **f64)
        for s in species:
            exit_c[idx[s]] = exit_coeff[s]
        exit_mask = torch.zeros(nf, **f64)
        exit_mask[:ns] = 1.0

        def wall(u, x, theta):
            # constant flux; written as a function of u so jacfwd sees a
            # (zero) dependence
            return u * 0.0 + wall_g

        def exit_(u, x, theta):
            return exit_c * (u - exit_mask)

        boundary = {S2: wall, S3: exit_}

    # the per-quadrature-point integrand, which the element kernel also
    # evaluates from the spec's constants on CUDA tensors
    spec = PoreVolumeSpec(
        n_fields=nf, kinetics=kin, gmpnp=gmpnp,
        z=tuple(params.z(s) for s in species),
        scale_vol=tuple(params.a(s) ** 3 * bulk_conc[s] * nat.N_A
                        for s in species),
        q=q, steric_clip=cfg.steric_clip,
        **(dict(w_cat=w_cat, C0_cat=C0_cat, w_H=w_H, C0_H=C0_H,
                eps_rel=eps_rel, cat_index=cat_i) if gmpnp else {}))
    spec.warm(device)
    form = WeakForm(nf, spec.volume, boundary=boundary, spec=spec)

    mesh = _load_pore_mesh(cfg)
    space = FemSpace.build(mesh, nf, quad_degree=cfg.quad_degree,
                           device=device)

    def marker_verts(m):
        return np.unique(mesh.facets[mesh.facet_markers == m].reshape(-1))

    s1_verts = marker_verts(S1)
    s2_verts = marker_verts(S2)
    s3_verts = marker_verts(S3)

    entries = []
    if gmpnp:
        # application order matters on shared rim vertices: the wall value
        # wins (ref bcs list :460-467, applied in order)
        entries += [(s1_verts, P, 0.0), (s3_verts, P, 0.0),
                    (s2_verts, P, cfg.voltage_multiplier)]
    entries += [
        (s1_verts, idx["CO2"], eq_conc["CO2"] / bulk_conc["CO2"]),
        (s1_verts, idx["CO"], eq_conc["CO"] / bulk_conc["CO"]),
        (s1_verts, idx["H2"], eq_conc["H2"] / bulk_conc["H2"]),
    ]
    bc = DirichletBC.from_vertex_sets(mesh.num_vertices, nf, entries,
                                      device=device)

    h_sechenov = {s: params.sechenov_ion.get(s, 0.0)
                  for s in ("OH", "HCO3", "CO32", cfg.cation)}
    # the Sechenov value's constants, as co2_saturation_conc computes them
    # (cations absent from the reference constant list salt out with
    # h_ion = 0); rxn-diff takes the H median for the cation's
    ions = ("OH", "HCO3", "CO32", cfg.cation)
    med_fields = ions[:3] + ((cfg.cation,) if gmpnp else ("H",))
    h_CO2 = sechenov_h_CO2(sysp.T, params)
    sechenov = SechenovConstants(
        fields=tuple(idx[s] for s in med_fields),
        bc0=tuple(bulk_conc[s] for s in med_fields),
        h=tuple(h_sechenov[s] + h_CO2 for s in ions), gmpnp=gmpnp,
        A=saturation_prefactor(sysp.T, fugacity_CO2),
        bc0_CO2=bulk_conc["CO2"])

    return Pore3DProgram(
        config=cfg, space=space, form=form, bc=bc, mesh=mesh, params=params,
        bulk_conc=bulk_conc, diff_coeff=diff_coeff,
        diff_coeff_eff=diff_coeff_eff, time_constant=time_constant,
        dt_scaled=dt_scaled, num_steps=num_steps,
        thermal_voltage=thermal_voltage, eq_conc=eq_conc,
        fugacity_CO2=fugacity_CO2, h_sechenov=h_sechenov,
        s1_verts=s1_verts, current_planar=current_planar, idx=idx,
        sechenov=sechenov, device=device)


def scale_conc_time(C, grad_c, bulk, tau, D_eff, L):
    """Reference ``scale_conc_time`` (3D/MPNP_CO2ER_pore.py:56-67)."""
    c = C * bulk
    t = tau * (L ** 2) / D_eff
    grad_scaled = grad_c * bulk / L
    return c, t, grad_scaled


def _sharded_stats(st):
    """StepStats from a sharded stats tuple (4-tuple, or 5-tuple when
    dt-cut recovery is on — see shard.make_sharded_transient)."""
    if len(st) == 5:
        iters, converged, resnorm, lin_iters, dt_scale = st
    else:
        iters, converged, resnorm, lin_iters = st
        dt_scale = np.ones_like(resnorm)
    return StepStats(newton_iters=iters, converged=converged,
                     residual_norm=resnorm, linear_iters=lin_iters,
                     dt_scale=dt_scale)


def shard_devices(shard: int, device="cuda"):
    """The ranks of a ``shard``-way run on ``device``: the first ``shard``
    CUDA devices (ValueError when there are fewer), or ``shard`` ranks
    sharing the host for ``device='cpu'``."""
    device = torch.device(device)
    if device.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < shard:
            raise ValueError(
                f"shard={shard} needs {shard} CUDA devices, have {have}; "
                f"pass device='cpu' to run the ranks on the host")
        return [torch.device("cuda", i) for i in range(shard)]
    return [device] * shard


def _run_sharded(prog: Pore3DProgram, cfg: Pore3DConfig, shard: int,
                 n_steps: Optional[int], record_stride: int,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 100, devices=None):
    """Sharded-transient analogue of Pore3DProgram.run: same
    (u0, u_hist, stats, u_final) contract, computed over ``shard`` ranks
    (parallel.shard), by default on the devices of
    :func:`shard_devices` for ``prog.device``; ``devices`` puts the ranks
    elsewhere (several ranks may share one card).

    dt-cut recovery follows the single-device auto rule (cfg.dt_retries:
    3 for full-length runs, 0 for short windows); refresh='auto' resolves
    statically to 'carried'.  checkpoint_dir enables chunked
    checkpointing with automatic resume: the transient runs in
    ``checkpoint_every``-step chunks, saving the GLOBAL (vertex-order)
    solution between chunks — checkpoints are therefore interchangeable
    with single-device ones (same layout; the carried SPIKE factorization
    is derived data and is rebuilt at each chunk start).  Chunked
    histories record every step (stride 1)."""
    from gmpnp_tpu_torch.parallel.shard import make_sharded_pore_transient

    devices = (shard_devices(shard, prog.device) if devices is None
               else [torch.device(d) for d in devices])

    if len(devices) != shard:
        raise ValueError(f"shard={shard} needs {shard} devices, got "
                         f"{len(devices)}")
    # the form's constants live on its program's device: ranks on other
    # devices get a program of their own
    def canon(d):       # 'cuda' and 'cuda:<current>' are one device
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    progs = {canon(prog.device): prog}
    for d in devices:
        if canon(d) not in progs:
            progs[canon(d)] = build(cfg, device=d)
    forms = [progs[canon(d)].form for d in devices]
    n = prog.num_steps if n_steps is None else n_steps
    if cfg.linear.refresh == "auto":
        # sharded runs resolve 'auto' statically to 'carried' (the
        # distributed chord keeps the SPIKE factors as carry leaves); the
        # timed calibration targets the single-device slab path
        cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
            cfg.linear, refresh="carried"))
    retries = cfg.dt_retries
    if retries is None:
        retries = 3 if n_steps is None else 0
    u0 = prog.initial_state()
    kw = dict(refresh=cfg.linear.refresh, max_retries=retries, forms=forms)

    if checkpoint_dir is None:
        run_s, u0_sharded, _plan = make_sharded_pore_transient(
            prog, devices, n_steps=n, record_stride=record_stride, **kw)
        (u_final, _), (u_hist, st) = run_s(u0_sharded)
        return u0, u_hist, _sharded_stats(st), u_final

    ckpt = TransientCheckpointer(checkpoint_dir, cfg=cfg)
    start, u_cur, extra = 0, u0, 0.0
    latest = ckpt.latest(device=devices[0])
    if latest is not None:
        start, (u_cur, extra) = latest
    if start >= n:
        # resumed at completion: the final state is the single history
        # record (mirrors Pore3DProgram.run)
        return u0, u_cur[None], None, u_cur

    runs = {}       # chunk length -> (run, plan)
    hist_chunks, stat_chunks = [], []
    i = start
    while i < n:
        k = min(checkpoint_every, n - i)
        if k not in runs:
            run_k, _u0, plan = make_sharded_pore_transient(
                prog, devices, n_steps=k, record_stride=1, **kw)
            runs[k] = (run_k, plan)
        run_k, plan = runs[k]
        u_pad = torch.as_tensor(plan.localize(u_cur.cpu().numpy()))
        u_sh = [b.to(d) for b, d in zip(u_pad.chunk(shard), devices)]
        # restored extra and the ABSOLUTE step index go into the chunk,
        # so theta sees the same values as an unchunked run
        (u_cur, extra), (u_hist_k, st_k) = run_k(u_sh, extra, i)
        hist_chunks.append(u_hist_k.cpu())
        stat_chunks.append(st_k)
        i += k
        ckpt.save(i, (u_cur, extra))
    u_hist = torch.cat(hist_chunks)
    st = tuple(np.concatenate(cols) for cols in zip(*stat_chunks))
    return u0, u_hist, _sharded_stats(st), u_cur


def run(cfg: Pore3DConfig, out_root: Optional[str] = None,
        write: bool = True, n_steps: Optional[int] = None,
        write_vtk: bool = True, verbose: bool = False,
        record_stride: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 100,
        shard: Optional[int] = None,
        device="cuda"):
    """Full reference-parity run (npz/metadata/VTK key sets per
    3D/MPNP_CO2ER_pore.py:862-1085 and 3D/rxn_diff_CO2ER_pore.py:602-784)
    on ``device``.

    record_stride=None (default) bounds the recorded history to ~1000
    snapshots for long runs (base.auto_record_stride); a checkpointed run
    records every step.  verbose prints per-step lines (utils.StepLogger).

    shard=K runs the transient z-slab-sharded over K ranks
    (parallel.shard.make_sharded_pore_transient: halo exchange, psum
    reductions, distributed SPIKE direct solve, cfg.linear.refresh
    honored including 'carried'), with identical output artifacts: on
    ``device='cuda'`` the ranks are the first K CUDA devices (ValueError
    when there are fewer), on ``device='cpu'`` K ranks share the host.
    Sharded runs support checkpoint/resume (global-layout checkpoints,
    interchangeable with the single-device path) and dt-cut recovery."""
    if shard is not None:
        shard_devices(shard, device)      # refuse before building
    prog = build(cfg, device=device)
    if record_stride is None:
        record_stride = base.auto_record_stride(
            n_steps if n_steps is not None else prog.num_steps)
    if checkpoint_dir is not None:
        # the checkpointed transient records every step inside its chunks;
        # keep the time-axis bookkeeping consistent with the recorded rows
        record_stride = 1
    if shard is not None:
        u0, u_hist, stats, u_final = _run_sharded(
            prog, cfg, shard, n_steps=n_steps,
            record_stride=record_stride,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every)
    else:
        u0, u_hist, stats, u_final = prog.run(
            n_steps=n_steps, record_stride=record_stride,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every)
    if verbose and stats is not None:
        from gmpnp_tpu_torch.utils import StepLogger
        StepLogger(every=max(1, u_hist.shape[0] // 50)).log_run(
            stats, dt_phys=cfg.time_step)
    n = u_hist.shape[0]
    ns = len(cfg.species)
    idx = prog.idx

    hist = np.concatenate([u0.cpu().numpy()[None], u_hist.cpu().numpy()],
                          axis=0)
    gmpnp = cfg.physics == "GMPNP"
    names = ["H", "OH", "HCO3", "CO32", "CO2", "CO", "H2"]
    if gmpnp:
        names.append("cat")
    sp_of = {nm: (cfg.cation if nm == "cat" else nm) for nm in names}
    unscaled = {nm: hist[:, :, idx[sp_of[nm]]] for nm in names}

    n_req = n_steps if n_steps is not None else prog.num_steps
    if cfg.dt_first_scale != 1.0:
        # staged start: the time axis is the cumulative sum of actual
        # scheduled dts at the recorded steps
        step_dt = np.full(n_req, prog.dt_scaled)
        step_dt[:min(cfg.dt_first_steps, n_req)] *= cfg.dt_first_scale
        cum = np.cumsum(step_dt)
        offset = n_req - n * record_stride
        tau_array = cum[offset + record_stride * np.arange(1, n + 1) - 1]
    elif record_stride == 1 and n == n_req:
        T = prog.dt_scaled * n
        tau_array = np.linspace(0, T, n)     # reference convention
    else:
        # strided history: exact absolute step times
        offset = n_req - n * record_stride
        tau_array = prog.dt_scaled * (
            offset + record_stride * np.arange(1, n + 1))
    coor = np.asarray(prog.mesh.points)

    # final-state gradient projections (ref :884-909) — all fields in one
    # batched mass solve
    space = prog.space
    u_last = torch.as_tensor(hist[-1], dtype=torch.float64,
                             device=prog.device)
    cols = [idx[sp_of[nm]] for nm in names]
    grads_cell = torch.einsum("caf,cad->cfd",
                              u_last[:, cols][space.dev["cells"]],
                              space.dev["gradN"])            # (C, k, dim)
    C = grads_cell.shape[0]
    proj = project_cellwise(space, grads_cell.reshape(C, -1))
    proj = proj.cpu().numpy().reshape(space.num_vertices, len(names), 3)
    grads = {nm: proj[:, i, :] for i, nm in enumerate(names)}

    scaled, grads_scaled, times = {}, {}, {}
    for nm in names:
        sp = sp_of[nm]
        c, t, gsc = scale_conc_time(
            unscaled[nm], grads[nm], prog.bulk_conc[sp], tau_array,
            prog.diff_coeff_eff[sp], cfg.L)
        scaled[f"c_{nm}"] = c
        times[f"t_{nm}"] = t
        grads_scaled[nm] = gsc

    CO2_min = float(hist[-1, :, idx["CO2"]].min())
    # stats is None when a checkpointed run resumed at completion: no step
    # ran in this call
    dt_scale = (np.asarray(stats.dt_scale) if stats is not None
                else np.ones(0))
    metadata = {
        "concentration_elec": cfg.concentration_elec,
        "cation": cfg.cation,
        "H2_FE": cfg.H2_FE,
        "L": cfg.L,
        "R": cfg.R,
        "time_step": cfg.time_step,
        "total_sim_time": cfg.total_sim_time,
        "porosity": cfg.porosity_eff,
        "tortuosity": cfg.tortuosity_eff,
        "constrictivity": cfg.constrictivity_eff,
        "y_CO2": cfg.y_CO2,
        "press_gas": cfg.press_gas,
        "pore_geom_multiplier": cfg.pore_geom_multiplier,
        "electrolyte_flow_geom_multiplier":
            cfg.electrolyte_flow_geom_multiplier,
        "eq_conc_CO": prog.eq_conc["CO"],
        "eq_conc_H2": prog.eq_conc["H2"],
        "current_planar": prog.current_planar,
        "CO2_min": CO2_min,
        # framework extras
        "newton_iters_total": (int(np.asarray(stats.newton_iters).sum())
                               if stats is not None else 0),
        "linear_iters_total": (int(np.asarray(stats.linear_iters).sum())
                               if stats is not None else 0),
        "all_steps_converged": (bool(np.asarray(stats.converged).all())
                                if stats is not None else True),
        "resumed_complete": stats is None,
        "dt_cut_steps": int((dt_scale < 1.0).sum()),
        "dt_first_scale": cfg.dt_first_scale,
        "dt_first_steps": cfg.dt_first_steps,
        # divergence-triggered dt cuts advance less than the scheduled dt;
        # the recorded time axis stays nominal when any engaged
        "times_nominal_dt_cuts": bool((dt_scale < 1.0).any()),
    }
    if gmpnp:
        metadata["voltage_multiplier"] = cfg.voltage_multiplier
    if getattr(prog, "refresh_calibration", None):
        # refresh='auto': the mode the timed calibration chose
        metadata["refresh_calibration"] = prog.refresh_calibration

    result = {
        "unscaled": unscaled,
        "scaled": scaled,
        "times": times,
        "grads": grads,
        "grads_scaled": grads_scaled,
        "tau_array": tau_array,
        "coor_array": coor,
        "metadata": metadata,
        "stats": stats,
    }

    if gmpnp:
        P = ns
        unscaled["p"] = hist[:, :, P]
        psi = unscaled["p"] * prog.thermal_voltage
        field_values = project_gradient(
            space, torch.as_tensor(hist[-1, :, P], dtype=torch.float64,
                                   device=prog.device),
            sign=-1.0).cpu().numpy()
        result["psi"] = psi
        result["field_values"] = field_values

    if write:
        paths = make_run_dir(cfg.identifier, out_root=out_root,
                             subdir="pore" if gmpnp else "pore_rxn_diff")

        unscaled_npz = {nm: unscaled[nm] for nm in names}
        unscaled_npz.update({f"{nm}_grad": grads[nm] for nm in names})
        unscaled_npz.update({"coor": coor, "tau": tau_array})
        if gmpnp:
            unscaled_npz.update({"p": unscaled["p"],
                                 "field_values": field_values})
        save_npz(paths.file("arrays_unscaled.npz"), **unscaled_npz)

        scaled_npz = {"coor_scaled": coor * cfg.L}
        for nm in names:
            scaled_npz[f"t_{nm}"] = times[f"t_{nm}"]
            scaled_npz[f"c_{nm}"] = scaled[f"c_{nm}"]
        scaled_npz.update({f"{nm}_grad": grads_scaled[nm] for nm in names})
        if gmpnp:
            c_H, c_cat = scaled["c_H"], scaled["c_cat"]
            w_cat = prog.params.w(cfg.cation)
            w_H = prog.params.w("H")
            eps_rel = prog.params.nat_const.eps_rel
            eps_ss = (eps_rel * (55 - (w_cat * c_cat + w_H * c_H) * 1e-3) / 55
                      + 6 * ((w_cat * c_cat + w_H * c_H) * 1e-3) / 55)
            charge_density = (scaled["c_cat"][-1] - scaled["c_HCO3"][-1]
                              - 2 * scaled["c_CO32"][-1]
                              - scaled["c_OH"][-1] + scaled["c_H"][-1])
            scaled_npz.update({
                "psi": psi,
                "eps_rel": eps_ss,
                "field_values": field_values * prog.thermal_voltage / cfg.L,
                "charge_density": charge_density,
            })
        else:
            scaled_npz["c_cat"] = (scaled["c_HCO3"] + 2 * scaled["c_CO32"]
                                   + scaled["c_OH"] - scaled["c_H"])
        save_npz(paths.file("arrays_scaled.npz"), **scaled_npz)
        save_metadata(paths.file("metadata.json"), metadata)

        if write_vtk:
            # final-state VTK per species (ref :862-880)
            vtk_fields = {nm: hist[-1, :, idx[sp_of[nm]]] for nm in names}
            if gmpnp:
                vtk_fields["p"] = hist[-1, :, ns]
            for nm, arr in vtk_fields.items():
                vtu = f"solution_{nm if nm != 'cat' else cfg.cation}.vtu"
                write_vtu(paths.file(vtu), prog.mesh.points,
                          prog.mesh.cells, {nm: arr})
                write_pvd(paths.file(vtu.replace(".vtu", ".pvd")), vtu)
        result["run_dir"] = paths.run_dir

    return result
