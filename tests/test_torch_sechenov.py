"""The pore's Sechenov update on the CPU: the plain version
(``ops.sechenov.sechenov_co2_reference``) is bit for bit the update as the
port computed it before the kernel (four ``median``s, then
``chem.henry.co2_saturation_conc``), the constants ``build`` packs follow
the program's own tables, the dispatch takes the plain version on the CPU
and refuses other devices, and the C entry point's layout matches the
source.  The kernel itself runs only on a card (``tests/test_torch_cuda.py``).

All on the (2, 10) pore mesh (N=209), for both physics.
"""

import importlib
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu_torch.chem.henry import (  # noqa: E402
    co2_saturation_conc, henry_K_CO2)
from gmpnp_tpu_torch.models import pore_3d  # noqa: E402
from gmpnp_tpu_torch.ops import (  # noqa: E402
    COUNTERS, SechenovConstants, sechenov_co2, sechenov_co2_reference)
from gmpnp_tpu_torch.testing import pore_states  # noqa: E402

# the module (``ops.sechenov_co2`` is the wrapper)
sc = importlib.import_module("gmpnp_tpu_torch.ops.sechenov")
_build = importlib.import_module("gmpnp_tpu_torch.ops._build")


@pytest.fixture(scope="module", params=["GMPNP", "rxn_diff"])
def pore(request):
    cfg = pore_3d.Pore3DConfig(physics=request.param,
                               mesh_resolution=(2, 10))
    return pore_3d.build(cfg, device="cpu")


def _former_value(prog, u):
    """The update as ``_theta_of_carry`` computed it before the kernel,
    written out: four medians times their bulk values, the cation by
    electroneutrality in rxn-diff, then ``co2_saturation_conc`` with the
    program's Sechenov table, over the CO2 bulk value."""
    cfg = prog.config
    idx, bc0 = prog.idx, prog.bulk_conc
    med = lambda s: pore_3d.median(u[:, idx[s]]) * bc0[s]  # noqa: E731
    conc_ions = {"OH": med("OH"), "HCO3": med("HCO3"), "CO32": med("CO32")}
    if cfg.physics == "GMPNP":
        conc_ions[cfg.cation] = med(cfg.cation)
    else:
        conc_ions[cfg.cation] = (conc_ions["HCO3"] + 2 * conc_ions["CO32"]
                                 + conc_ions["OH"] - med("H"))
    eq_CO2 = co2_saturation_conc(
        prog.params.sys_params.T, prog.fugacity_CO2, conc_ions, prog.params,
        h_sechenov=dict(prog.h_sechenov))
    return eq_CO2 / bc0["CO2"]


def _states(prog):
    """Seeded states, a state with heavy ties (values rounded to 0.05) and
    the bulk state (every column all-equal), each at the mesh's N and at
    N - 1 (the other parity)."""
    out = []
    for seed, scale in ((1, 1.0), (2, 1.0), (3, 60.0)):
        out.append(pore_states(prog, seed, scale)[0])
    u, _ = pore_states(prog, 4)
    out.append(torch.round(u * 20.0) / 20.0)
    out.append(prog.initial_state())
    return [v for u in out for v in (u, u[:-1])]


def _bits(t):
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float64).tobytes()


def test_plain_version_is_the_former_update_bitwise(pore):
    N = pore.space.num_vertices
    seen = set()
    for u in _states(pore):
        seen.add(u.shape[0] % 2)
        want = _former_value(pore, u)
        got = sechenov_co2_reference(u, pore.sechenov)
        assert got.shape == () and got.dtype == torch.float64
        assert _bits(got) == _bits(want), (u.shape, float(got), float(want))
        theta = pore._theta_of_carry((u, 0.0), 0)
        assert _bits(theta["co2_s1"]) == _bits(want)
    assert seen == {0, 1} and N > 100


def test_constants_follow_the_program(pore):
    cfg, c = pore.config, pore.sechenov
    gmpnp = cfg.physics == "GMPNP"
    fourth = cfg.cation if gmpnp else "H"
    names = ("OH", "HCO3", "CO32", fourth)
    assert c.fields == tuple(pore.idx[s] for s in names)
    assert c.bc0 == tuple(pore.bulk_conc[s] for s in names)
    assert c.gmpnp is gmpnp
    T, p = pore.params.sys_params.T, pore.params
    h_CO2 = p.sechenov_CO2_0 + p.sechenov_CO2_T * (T - 298.15)
    assert c.h == tuple(pore.h_sechenov[s] + h_CO2
                        for s in ("OH", "HCO3", "CO32", cfg.cation))
    assert c.A == pore.fugacity_CO2 * float(henry_K_CO2(T)) * 1000.0
    assert c.bc0_CO2 == pore.bulk_conc["CO2"]
    packed = c.pack()
    assert len(packed) == sc.N_CONSTS == 15
    assert packed == (*map(float, c.fields), *c.bc0, *c.h, float(gmpnp),
                      c.A, c.bc0_CO2)
    assert tuple(c.packed) == packed


def test_constants_refuse_wrong_lengths():
    with pytest.raises(ValueError, match="4 fields"):
        SechenovConstants(fields=(0, 1, 2), bc0=(1.0,) * 3, h=(0.1,) * 3,
                          gmpnp=True, A=1.0, bc0_CO2=1.0)


def test_cpu_takes_the_plain_version(pore):
    launches = COUNTERS["sechenov"][0]
    n0 = dict(launches)
    u, _ = pore_states(pore, 7)
    got = sechenov_co2(u, pore.sechenov)
    assert _bits(got) == _bits(sechenov_co2_reference(u, pore.sechenov))
    assert launches == n0   # no kernel on the CPU
    with pytest.raises(ValueError, match="cuda or cpu"):
        sechenov_co2(u.to("meta"), pore.sechenov)
    with pytest.raises(ValueError, match="only the kernel"):
        sechenov_co2(u, pore.sechenov, medians=torch.empty(4))


def test_launch_layout_matches_the_source():
    src_path = os.path.join(os.path.dirname(_build.__file__), os.pardir,
                            "csrc", "sechenov.cu")
    assert os.path.abspath(src_path) in map(os.path.abspath, _build.SOURCES)
    src = open(src_path).read()
    consts = re.search(r"kConsts = 3 \* kColumns \+ 3;", src)
    cols = re.search(r"constexpr int kColumns = (\d+);", src)
    assert consts and int(cols.group(1)) == sc.N_COLUMNS
    sig = re.search(r'extern "C" int sechenov_co2_f64\(([^)]*)\)', src)
    argtypes = dict((n, a) for n, _, a in _build._SIGNATURES)[
        "sechenov_co2_f64"]
    assert len(sig.group(1).split(",")) == len(argtypes) == 7
    # the kernel's symbol stays clear of the roofline readers' names
    kernels = re.findall(r"(\w+)<<<", src)
    assert kernels == ["sechenov_co2_kernel"]
    assert not any(n in kernels[0] for n in ("ell_spmv", "segment_sum",
                                              "block_inv"))
