"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode: without a GPU these tests skip. Run them
on a machine with one: `python -m pytest tests/test_torch_kernels.py -m cuda
--noconftest` (tests/conftest.py configures jax, which these tests do not use).
"""

import pytest
import torch

from mapmerge_torch.kernels import nn as knn
from mapmerge_torch.kernels import spfh as kspfh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_nn_kernel_matches_plain_version(cuda):
    """Both round every operation alike: indices and d2 bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.rand((3001, 3), generator=g, device=cuda) * 8
    p = torch.rand((5003, 3), generator=g, device=cuda) * 8
    mask = torch.rand((5003,), generator=g, device=cuda) > 0.3
    before = knn.KERNEL.launches
    got = knn.nearest_neighbor(q, p, mask)
    assert knn.KERNEL.launches == before + 1
    ref = knn.nearest_neighbor_ref(q, p, mask)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    idx, d2 = knn.nearest_neighbor(q[:7], torch.zeros((2500, 3), device=cuda))
    assert bool((idx == 0).all()) and bool((d2 > 0).all())  # first on ties
    _, d2 = knn.nearest_neighbor(q[:9], p, torch.zeros_like(mask))
    assert bool((d2 >= 1e11).all())


def test_nn_kernel_rejects_bad_operands(cuda):
    q = torch.rand((10, 3), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        knn.nearest_neighbor(q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        knn.nearest_neighbor(q, torch.rand((3, 10), device=cuda).T)
    with pytest.raises(ValueError, match="on cpu"):
        knn.nearest_neighbor(q, q.cpu())


@pytest.mark.parametrize("shared", [True, False])
def test_spfh_kernel_matches_plain_version(cuda, shared):
    g = torch.Generator(device=cuda).manual_seed(1)
    b, cq, m = 6, 40, 700
    bc = 1 if shared else b
    cand = torch.rand((bc, m, 3), generator=g, device=cuda) * 2
    nrm = torch.nn.functional.normalize(
        torch.randn((bc, m, 3), generator=g, device=cuda), dim=-1
    )
    ok = torch.rand((bc, m), generator=g, device=cuda) > 0.2
    pick = torch.randint(0, m, (b, cq), generator=g, device=cuda)
    src = 0 if shared else torch.arange(b, device=cuda)[:, None]
    args = (cand[src, pick], nrm[src, pick], cand, nrm, ok)
    before = kspfh.KERNEL.launches
    h, tot = kspfh.spfh_tile(*args, r2=0.36)
    assert kspfh.KERNEL.launches == before + 1
    rh, rtot = kspfh.spfh_ref(*args, r2=0.36)
    assert torch.equal(tot, rtot)
    assert float((h - rh).abs().max()) <= 1e-4
