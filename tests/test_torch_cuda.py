"""The port on a CUDA card: each kernel against its plain version, and a
short transient on the card against the same transient on the CPU.

These tests need a card and skip without one.  They import neither jax nor
gmpnp_tpu, so they run on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: the kernel in f32 1e-5 and in f64 1e-12 relative L2 (another
summation order); card vs CPU states 1e-6 relative L2 (the f32-chord band:
the chord directions are f32 GMRES solves).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu_torch.ops import LAUNCHES, ell_spmv, ell_spmv_reference  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("N,K,f", [(2501, 15, 9), (1000, 7, 3)])
def test_kernel_matches_plain_version(cuda_device, N, K, f, dtype, tol):
    rng = np.random.default_rng(5)
    flat = rng.normal(size=(N, f, K * f)).astype(dtype)
    adj = rng.integers(0, N, size=(N, K)).astype(np.int32)
    x = rng.normal(size=(N, f)).astype(dtype)
    args = [torch.as_tensor(v, device=cuda_device) for v in (flat, adj, x)]
    n0 = LAUNCHES[args[0].dtype]
    y = ell_spmv(*args)
    torch.cuda.synchronize()
    assert LAUNCHES[args[0].dtype] == n0 + 1
    ref = ell_spmv_reference(*args)
    assert float((y - ref).norm() / ref.norm()) <= tol


def test_carried_transient_card_matches_cpu(cuda_device):
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.testing import rel_l2

    cfg = pore_3d.Pore3DConfig(mesh_resolution=(2, 10))
    cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, refresh="carried"))
    runs = {}
    for dev in (cuda_device, "cpu"):
        n0 = LAUNCHES[torch.float32]
        _, _, stats, u = pore_3d.build(cfg, device=dev).run(n_steps=3)
        assert np.asarray(stats.converged).all()
        runs[str(dev)] = (np.asarray(stats.newton_iters), u.cpu().numpy(),
                          LAUNCHES[torch.float32] - n0)
    (it_d, u_d, launched), (it_c, u_c, none) = runs["cuda"], runs["cpu"]
    np.testing.assert_array_equal(it_d, it_c)
    assert launched > 0 and none == 0
    assert rel_l2(u_d, u_c) <= 1e-6
