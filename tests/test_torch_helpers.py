"""Port vs reference: the small host helpers no model path calls —
``chem.reactions.kinetics_0d`` and ``kinetics_0d_const_co2`` (the 0D
batch-reactor right-hand sides of utilities/bulk_soln.py),
``chem.henry.equilibrium_gas_conc`` and ``fem.DirichletBC.with_values`` —
on numpy-seeded inputs.

Tolerance: equal to the reference (the same f64 arithmetic in the same
order), or within 1e-15 relative where noted.  ``DirichletBC.
set_value_masked`` has no counterpart: it is the reference's workaround
for a vmapped scatter that faulted its TPU worker; ``set_value`` and
``ArithDirichletBC.set_value_arith`` give the same values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gmpnp_tpu.chem import henry as jhenry  # noqa: E402
from gmpnp_tpu.chem import reactions as jreactions  # noqa: E402
from gmpnp_tpu.constants import DEFAULT_PARAMS as JPARAMS  # noqa: E402
from gmpnp_tpu.fem.dirichlet import DirichletBC as JDirichletBC  # noqa: E402
from gmpnp_tpu_torch.chem import henry, reactions  # noqa: E402
from gmpnp_tpu_torch.constants import DEFAULT_PARAMS  # noqa: E402
from gmpnp_tpu_torch.fem.dirichlet import DirichletBC  # noqa: E402


def test_kinetics_0d_match_reference():
    rng = np.random.default_rng(21)
    k_t = DEFAULT_PARAMS.rate_constants
    k_j = JPARAMS.rate_constants
    for _ in range(5):
        y = rng.uniform(1e-3, 100.0, size=(4, 7))
        got = reactions.kinetics_0d(torch.as_tensor(y), k_t).numpy()
        want = np.asarray(jreactions.kinetics_0d(y, k_j))
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
        co2 = float(rng.uniform(1.0, 40.0))
        got = reactions.kinetics_0d_const_co2(torch.as_tensor(y[:3]), k_t,
                                              co2).numpy()
        want = np.asarray(jreactions.kinetics_0d_const_co2(y[:3], k_j, co2))
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("gas", ["CO2", "CO", "H2"])
def test_equilibrium_gas_conc_matches_reference(gas):
    rng = np.random.default_rng(5)
    for press, y_gas in rng.uniform(0.1, 3.0, size=(4, 2)):
        want = float(jhenry.equilibrium_gas_conc(gas, press, y_gas))
        assert float(henry.equilibrium_gas_conc(gas, press, y_gas)) == want
        t = henry.equilibrium_gas_conc(gas, torch.tensor(press), y_gas)
        assert isinstance(t, torch.Tensor) and float(t) == want


def test_dirichlet_with_values_matches_reference():
    rng = np.random.default_rng(8)
    mask = rng.random((30, 4)) < 0.3
    vals, new = rng.normal(size=(2, 30, 4))
    r, u = rng.normal(size=(2, 30, 4))
    jbc = JDirichletBC(mask, vals).with_values(new)
    bc = DirichletBC(torch.as_tensor(mask),
                     torch.as_tensor(vals)).with_values(torch.as_tensor(new))
    assert torch.equal(bc.mask, torch.as_tensor(mask))
    np.testing.assert_array_equal(
        bc.apply_to_residual(torch.as_tensor(r), torch.as_tensor(u)).numpy(),
        np.asarray(jbc.apply_to_residual(r, u)))
    np.testing.assert_array_equal(bc.project(torch.as_tensor(u)).numpy(),
                                  np.asarray(jbc.project(u)))
