"""Port vs reference, host side: meshes, FemSpace tables and slab plans are
bit-identical; the copied host modules equal their originals up to the
package name; the port's import graph holds no JAX; the shared native
library serves the port.

Tolerance: none — host numpy code is copied, so equality is exact.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gmpnp_tpu_torch.fem.assembly as tfa  # noqa: E402
import gmpnp_tpu_torch.mesh as tmesh  # noqa: E402
from gmpnp_tpu.fem.assembly import FemSpace as JFemSpace  # noqa: E402
from gmpnp_tpu.mesh import cylinder_mesh, pore_boundary_markers  # noqa: E402
from gmpnp_tpu.solve.slab import SlabPlan as JSlabPlan  # noqa: E402
from gmpnp_tpu_torch import native as tnative  # noqa: E402
from gmpnp_tpu_torch.solve.slab import SlabPlan as TSlabPlan  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (L, R, mesh kwargs): the test mesh and the main path's default L50R5 mesh
MESHES = [(100e-9, 5e-9, {"n_rings": 2, "n_layers": 10}),
          (50e-9, 5e-9, {})]


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("L,R,kw", MESHES)
def test_mesh_space_and_slab_plan_bit_identical(L, R, kw):
    jm = pore_boundary_markers(cylinder_mesh(L, R, **kw), L, R)
    tm = tmesh.pore_boundary_markers(tmesh.cylinder_mesh(L, R, **kw), L, R)
    for name in ("points", "cells", "facets", "facet_markers"):
        _assert_same(getattr(tm, name), getattr(jm, name), name)

    js = JFemSpace.build(jm, 9, quad_degree=2)
    ts = tfa.FemSpace.build(tm, 9, quad_degree=2, device="cpu")
    for name in ("cells", "vols", "gradN", "Nq", "wq", "xq", "adj",
                 "diag_slot", "slot", "points"):
        _assert_same(getattr(ts, name), getattr(js, name), name)
    for name in ("res_tables", "jac_tables"):
        for a, b in zip(getattr(ts, name), getattr(js, name)):
            _assert_same(a, b, name)
    assert [m for m, _ in ts.facet_tabs] == [m for m, _ in js.facet_tabs]
    from gmpnp_tpu.fem.assembly import _sorted_segment_tables
    for (m, tt), (_, jt) in zip(ts.facet_tabs, js.facet_tabs):
        # the port's one extra table: the facet residual rows' sorted
        # segments (the reference scatter-adds them), made by the
        # reference's own table builder from the same nodes
        assert tt.keys() - {"res_tables"} == jt.keys()
        want = _sorted_segment_tables(np.asarray(jt["nodes"]).reshape(-1),
                                      jm.num_vertices)
        for a, b in zip(tt["res_tables"], want):
            _assert_same(a, b, f"facet {m} res_tables")
        for k in jt:
            if k == "jac_tables":
                for a, b in zip(tt[k], jt[k]):
                    _assert_same(a, b, f"facet {m} {k}")
            else:
                _assert_same(tt[k], jt[k], f"facet {m} {k}")

    args = (np.asarray(js.adj), np.asarray(js.points)[:, -1], 9,
            np.asarray(js.diag_slot))
    jp, tp = JSlabPlan.build(*args), TSlabPlan.build(*args)
    assert (tp.S, tp.m_v, tp.f, tp.N, tp.bandwidth) == (
        jp.S, jp.m_v, jp.f, jp.N, jp.bandwidth)
    for name in ("perm", "iperm", "bidx"):
        _assert_same(getattr(tp, name), getattr(jp, name), name)
    for a, b in zip(tp.pad_eye, jp.pad_eye):
        _assert_same(a, b, "pad_eye")


# host modules the port carries as copies, changed only in import paths
COPIED = ["constants.py", "config.py", "native.py", "chem/bulk.py",
          "mesh/__init__.py", "mesh/core.py", "mesh/generators.py",
          "mesh/marking.py", "mesh/dolfin_xml.py", "io/__init__.py",
          "io/vtk.py", "io/writers.py", "fem/elements.py", "models/base.py",
          "models/stern.py", "cli/stern.py", "cli/bulk_soln.py",
          "cli/mesh_tests.py", "utils/logging.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_original_source(rel):
    """Each copy equals its original once the package name is renamed, so
    the copies cannot drift apart unnoticed."""
    def read(pkg):
        with open(os.path.join(REPO, pkg, rel)) as fh:
            return fh.read()

    original = re.sub(r"\bgmpnp_tpu\b", "gmpnp_tpu_torch", read("gmpnp_tpu"))
    assert read("gmpnp_tpu_torch") == original


CLIS = ["pore_3d", "rxn_diff_3d", "edl_1d", "rxn_diff_1d", "stern",
        "bulk_soln", "mesh_tests"]


# modules no CLI imports
MODULES = ["io.checkpoint", "parallel", "parallel.shard", "parallel.sweep",
           "solve.amg", "utils", "utils.logging", "utils.profiling"]


def test_cli_import_loads_no_jax():
    imports = "; ".join([f"import gmpnp_tpu_torch.cli.{c}" for c in CLIS]
                        + [f"import gmpnp_tpu_torch.{m}" for m in MODULES])
    code = (f"import sys; {imports}; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'gmpnp_tpu' "
            "or m.startswith('gmpnp_tpu.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_stern_sweep_matches_golden():
    """The copied Stern post-solve against the reference-written golden at
    its own rtol 1e-12 (tests/test_goldens.py)."""
    from gmpnp_tpu_torch.models import stern
    from gmpnp_tpu_torch.testing import GoldenFile

    data = {str(v): {"voltage_electrode": r["voltage_electrode"],
                     "field_surf": r["field_surf"]}
            for v, r in stern.run(write=False).items()}
    msg = GoldenFile(os.path.join(REPO, "tests", "goldens",
                                  "stern_sweep.json"), rtol=1e-12).check(data)
    assert msg is None, msg


@pytest.mark.parametrize("name,argv", [
    ("stern", ["--out_root", "{tmp}"]),
    ("bulk_soln", ["--conc", "0.1", "--out_dir", "{tmp}"]),
    ("mesh_tests", ["--L", "50e-9", "--R", "5e-9"]),
])
def test_host_clis_match_reference(name, argv, tmp_path):
    """The copied host-only CLIs return what the reference's return."""
    import importlib

    out = {}
    for pkg in ("gmpnp_tpu", "gmpnp_tpu_torch"):
        cli = importlib.import_module(f"{pkg}.cli.{name}")
        tmp = tmp_path / pkg
        tmp.mkdir()
        out[pkg] = cli.main([a.format(tmp=tmp) for a in argv])
    ref, got = out["gmpnp_tpu"], out["gmpnp_tpu_torch"]
    if name == "stern":
        assert set(got) == set(ref)
        for v in ref:
            assert got[v]["field_surf"] == ref[v]["field_surf"]
    elif name == "bulk_soln":
        assert got.post_pH == ref.post_pH
        assert sorted(os.listdir(tmp_path / "gmpnp_tpu_torch")) == \
            sorted(os.listdir(tmp_path / "gmpnp_tpu"))
    else:
        assert got == ref


def test_native_boundary_facets_match_numpy(monkeypatch):
    """The port's native.py builds/loads the shared native/ library and
    gives the same boundary facets as the numpy path; without a C++
    compiler the library is absent and the numpy path is the port's own
    fallback, as in the reference."""
    if not tnative.available():
        pytest.skip("native library unavailable (no C++ compiler)")
    from gmpnp_tpu_torch.mesh import core as tcore

    m = tmesh.cylinder_mesh(50e-9, 5e-9, n_rings=2, n_layers=5)
    nat_f, nat_o = tnative.boundary_facets(m.cells)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    py_f, py_o = tcore.boundary_facets(m.points, m.cells)

    def canon(f, o):
        return sorted(tuple(sorted(r)) + (c,) for r, c in zip(f, o))

    assert canon(nat_f, nat_o) == canon(py_f, py_o)
