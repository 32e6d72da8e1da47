"""The pore's element-residual kernel on the CPU: the spec that
``models/pore_3d.py`` builds is the form's integrand and holds the
constants the kernel reads, the plain version is ``FemSpace``'s element
loop, the dispatch takes the kernel only where it applies, the wrapper
refuses what the kernel does not take, and the custom op's vmap rule makes
one lane-axis call.  The kernel itself runs only on a card
(``tests/test_torch_cuda.py``).

The plain version's comparisons are bitwise: it runs ``FemSpace``'s
element loop over the same integrand.  All on the (2, 10) pore mesh (720
tets).
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.func import vmap  # noqa: E402

from gmpnp_tpu_torch.fem import WeakForm  # noqa: E402
from gmpnp_tpu_torch.models import edl_1d, pore_3d, rxn_diff_1d  # noqa: E402
from gmpnp_tpu_torch.testing import pore_states  # noqa: E402

# the module (``ops.pore_residual`` is also the wrapper's name)
pr = importlib.import_module("gmpnp_tpu_torch.ops.pore_residual")

CUDA = torch.device("cuda")


@pytest.fixture(scope="module", params=["GMPNP", "rxn_diff"])
def pore(request):
    cfg = pore_3d.Pore3DConfig(physics=request.param,
                               mesh_resolution=(2, 10))
    return pore_3d.build(cfg, device="cpu")


@pytest.mark.parametrize("scale", [1.0, 60.0])
def test_spec_volume_is_the_pore_integrand(pore, scale):
    """The form's integrand is the spec's, and per quadrature point, at 64
    random states, it is the pore's weak form written out in numpy from
    the spec's constants: the time and reaction terms and diffusion, and
    with GMPNP migration, the steric flux with its denominator under its
    clip (scale 60) and over it, the Poisson charge and eps(c)."""
    form, spec = pore.form, pore.form.spec
    assert form.volume == spec.volume
    u, up = pore_states(pore, 3, scale)
    rng = np.random.default_rng(4)
    gu = torch.as_tensor(rng.normal(size=(64, form.n_fields, 3)))
    theta = pore._theta_of_carry((u, 0.0), 0)
    fval, fgrad = vmap(lambda a, g, b: form.volume(a, g, b, None, theta))(
        u[:64], gu, up[:64])
    ns = len(pore.config.species)
    uc, upc, g = u[:64, :ns].numpy(), up[:64, :ns].numpy(), gu.numpy()
    R = vmap(spec.kinetics)(u[:64, :ns]).numpy()
    want_val = (uc - upc) / float(theta["dt"]) - R
    want_grad = g[:, :ns].copy()
    if spec.gmpnp:
        z, s_vol = np.array(spec.z), np.array(spec.scale_vol)
        c0 = np.array(spec.kinetics.c0)
        gphi = g[:, ns]
        denom = 1.0 - uc @ s_vol
        assert bool((denom < spec.steric_clip).all() if scale > 1.0
                    else (denom > spec.steric_clip).all())
        denom = np.maximum(denom, spec.steric_clip)
        common = np.einsum("j,vjd->vd", s_vol, g[:, :ns])
        want_grad += (z[None, :, None] * uc[:, :, None] * gphi[:, None]
                      + (uc / denom[:, None])[:, :, None]
                      * common[:, None])
        hyd = 1e-3 * (spec.w_cat * spec.C0_cat * uc[:, spec.cat_index]
                      + spec.w_H * spec.C0_H * uc[:, spec.proton_index])
        eps = spec.eps_rel * (55.0 - hyd) / 55.0 + 6.0 * hyd / 55.0
        want_val = np.concatenate(
            [want_val, spec.q * (uc @ (z * c0))[:, None]], axis=1)
        want_grad = np.concatenate(
            [want_grad, -eps[:, None, None] * gphi[:, None]], axis=1)
    for got, want in ((fval.numpy(), want_val), (fgrad.numpy(), want_grad)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def test_spec_holds_the_models_constants(pore):
    spec, cfg = pore.form.spec, pore.config
    packed = spec.pack()
    assert len(packed) == pr.N_CONSTS == 104
    ns = len(cfg.species)
    idx = pore.idx
    header = packed[:len(pr._HEADER)]
    assert header == (cfg.n_fields, ns, float(cfg.physics == "GMPNP"), 1.0,
                      idx["H"], idx["OH"], idx["HCO3"], idx["CO32"],
                      idx["CO2"], idx.get(cfg.cation, -1), 0)
    assert spec.kinetics.c0 == tuple(pore.bulk_conc[s] for s in cfg.species)
    tables = packed[len(pr._HEADER) + len(pr._SCALARS):]
    zc0 = tables[4 * pr.MAX_FIELDS:5 * pr.MAX_FIELDS]
    assert zc0[:ns] == tuple(a * b for a, b in zip(spec.z,
                                                   spec.kinetics.c0))
    assert set(zc0[ns:]) == {0.0}


def test_plain_version_is_the_element_loop(pore):
    """``pore_residual`` on CPU tensors (the plain version) against
    ``FemSpace``'s vmapped element loop over the form's integrand, and the
    assembled residual of a form without the spec."""
    sp, form = pore.space, pore.form
    d = sp.dev
    u, up = pore_states(pore, 5)
    theta = pore._theta_of_carry((u, 0.0), 0)
    loop = vmap(lambda ue, upe, g, v, x: sp._local_volume_residual(
        form, ue, upe, g, v, x, theta))(
            u[d["cells"]], up[d["cells"]], d["gradN"], d["vols"], d["xq"])
    plain = pr.pore_residual(u, up, theta["dt"], d["cells"], d["gradN"],
                             d["vols"], d["Nq"], d["wq"], form.spec)
    assert plain.shape == (sp.cells.shape[0], 4, sp.n_fields)
    assert torch.equal(plain, loop)
    bare = WeakForm(form.n_fields, form.volume, boundary=form.boundary)
    assert torch.equal(sp.residual(form, u, up, theta),
                       sp.residual(bare, u, up, theta))


def test_dispatch_takes_the_kernel_only_where_it_applies(pore):
    sp, form = pore.space, pore.form
    assert sp.uses_residual_kernel(form, CUDA)
    assert sp.uses_residual_kernel(form, "cuda:0")
    assert not sp.uses_residual_kernel(form, torch.device("cpu"))
    with_aux = WeakForm(form.n_fields, form.volume, n_aux=2, spec=form.spec)
    assert not sp.uses_residual_kernel(with_aux, CUDA)
    no_spec = WeakForm(form.n_fields, form.volume)
    assert not sp.uses_residual_kernel(no_spec, CUDA)
    other_f = dataclasses.replace(sp, n_fields=sp.n_fields + 1)
    assert not other_f.uses_residual_kernel(form, CUDA)


@pytest.mark.parametrize("build", [
    lambda: edl_1d.build(edl_1d.EDL1DConfig(L_n=1e-6), device="cpu"),
    lambda: rxn_diff_1d.build(rxn_diff_1d.RxnDiff1DConfig(L_n=1e-6),
                              device="cpu")], ids=["edl_1d", "rxn_diff_1d"])
def test_dispatch_keeps_the_1d_forms(build):
    prog = build()
    assert prog.form.spec is None
    assert not prog.space.uses_residual_kernel(prog.form, CUDA)
    # a pore spec on a 1D (interval) space is still not taken
    spec = pore_3d.build(pore_3d.Pore3DConfig(physics="rxn_diff",
                                              mesh_resolution=(2, 10)),
                         device="cpu").form.spec
    form = WeakForm(prog.form.n_fields, prog.form.volume, spec=spec)
    assert not prog.space.uses_residual_kernel(form, CUDA)


def test_spec_refuses_inconsistent_constants(pore):
    spec = pore.form.spec
    with pytest.raises(ValueError, match="fields"):
        dataclasses.replace(spec, n_fields=spec.n_fields + 1)
    with pytest.raises(ValueError, match="per species"):
        dataclasses.replace(spec, z=spec.z[:-1])
    if spec.gmpnp:
        with pytest.raises(ValueError, match="cation"):
            dataclasses.replace(spec, cat_index=len(spec.z))


def _launch_args(prog, lanes=None):
    sp = prog.space
    d = sp.dev
    u, up = pore_states(prog, 7)
    if lanes:
        u = torch.stack([u * (1.0 + 0.01 * v) for v in range(lanes)])
        up = torch.stack([up] * lanes)
    return [u, up, None, 0.25, d["cells"], d["gradN"], d["vols"], d["Nq"],
            d["wq"], prog.form.spec.constants("cpu")]


def test_launch_refuses_what_the_kernel_does_not_take(pore):
    args = _launch_args(pore)
    with pytest.raises(ValueError, match="runs on cuda"):
        pr._launch(*args)
    bad = list(args)
    bad[1] = args[1][:-1]
    with pytest.raises(ValueError, match="one shape"):
        pr._launch(*bad)
    bad = list(args)
    bad[5] = args[5][:, :, :2].contiguous()
    with pytest.raises(ValueError, match="gradN"):
        pr._launch(*bad)
    bad = list(args)
    bad[0] = args[0].to(torch.float32)
    bad[1] = args[1].to(torch.float32)
    with pytest.raises(TypeError, match="float64"):
        pr._launch(*bad)
    bad = list(args)
    bad[2] = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="dt"):
        pr._launch(*bad)
    bad = list(args)
    bad[0] = args[0].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        pr._launch(*bad)


def test_vmap_rule_makes_one_lane_axis_call(pore, monkeypatch):
    """The op's vmap rule, with the launch replaced by a stand-in that
    computes per lane from u, u_prev and dt: one call over all lanes, each
    lane what a one-lane call gives, per-lane and shared dt, nested vmaps
    folded into leading axes."""
    calls = []

    def stand_in(u, u_prev, dt_lanes, dt_value, cells, *rest):
        calls.append((tuple(u.shape), None if dt_lanes is None
                      else tuple(dt_lanes.shape)))
        dt = (dt_value if dt_lanes is None
              else dt_lanes[(...,) + (None,) * 3])
        return (u[..., cells, :] - u_prev[..., cells, :]) / dt

    monkeypatch.setattr(pr, "_launch", stand_in)
    u, up, _, _, *tables = _launch_args(pore, lanes=3)
    dts = torch.tensor([0.5, 0.25, 0.125], dtype=torch.float64)
    N, f = u.shape[1:]
    one = torch.stack([pr.pore_residual_op(u[v], up[v], dts[v], 0.0, *tables)
                       for v in range(3)])
    calls.clear()
    lanes = vmap(lambda a, b, t: pr.pore_residual_op(a, b, t, 0.0, *tables))(
        u, up, dts)
    assert calls == [((3, N, f), (3,))]
    assert torch.equal(lanes, one)
    calls.clear()
    shared = vmap(lambda a: pr.pore_residual_op(a, up[0], None, 0.5,
                                                *tables))(u)
    assert calls == [((3, N, f), None)]
    assert torch.equal(shared[1], pr.pore_residual_op(u[1], up[0], None, 0.5,
                                                      *tables))
    calls.clear()
    nested = vmap(vmap(lambda a, b: pr.pore_residual_op(a, b, None, 0.5,
                                                        *tables)))(
        torch.stack([u, u]), torch.stack([up, up]))
    assert calls == [((2, 3, N, f), None)]
    assert torch.equal(nested[1, 2], pr.pore_residual_op(u[2], up[2], None,
                                                         0.5, *tables))
