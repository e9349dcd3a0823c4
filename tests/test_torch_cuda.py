"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip here, without a card or ``nvcc`` (a CUDA kernel
has no host mode; ``tests/test_torch_kernels.py`` holds the plain versions
against the JAX reference on the CPU). On a machine with a card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no JAX, so it runs where only PyTorch is installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import greedy as G  # noqa: E402
from repro_torch.kernels.pg import pg as PK  # noqa: E402
from repro_torch.kernels.resize import resize as PR  # noqa: E402


def _random_round(rng, b, t, a, m, occupied_frac=0.5):
    grid = rng.uniform(1, 10, (a, m)).astype(np.float32)
    price = rng.uniform(0.1, 1, (b, m)).astype(np.float32)
    cap = rng.uniform(20, 40, (b, m)).astype(np.float32)
    occ = (rng.uniform(0, 5, (b, m))
           * (rng.random((b, m)) < occupied_frac)).astype(np.float32)
    lat = rng.random((b, t, a)) < 0.3
    alive = rng.random((b, t)) < 0.7
    return lat, alive, grid, price, cap, occ


@pytest.fixture
def cuda_device():
    if not kernels.available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernels have no "
                    "host mode (tests/test_torch_kernels.py tests their plain "
                    "versions)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,a,m", [(1, 1, 1, 2), (5, 37, 97, 2),
                                     (4, 26, 129, 4), (64, 32, 300, 2)])
def test_round_kernel_matches_plain_on_card(b, t, a, m, cuda_device, rng):
    ins = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
           for x in _random_round(rng, b, t, a, m)]
    ref = PK.batch_round_ref(*ins)
    before = PK.ROUND_KERNEL.launches
    out = PK.batch_round(G._pack_bits(ins[0]), *ins[1:])
    torch.cuda.synchronize()
    assert PK.ROUND_KERNEL.launches == before + 1
    assert torch.equal(out[0].view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resize_kernel_matches_plain_on_card(dtype, cuda_device, rng):
    img = torch.from_numpy(rng.standard_normal((3, 17, 31, 4)).astype(
        np.float32)).to(cuda_device, dtype)
    for z in (1.0, 0.5, 0.04):
        ho, wo = PR.out_size_for_z(17, 31, z)
        taps = (PR.device_taps(ho, 17, cuda_device),
                PR.device_taps(wo, 31, cuda_device))
        out = PR.resize_bilinear(img, *taps)
        ref = PR.resize_bilinear_ref(img, *taps)
        tol = 1e-5 if dtype == torch.float32 else 3e-2
        assert torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
