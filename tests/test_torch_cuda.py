"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a host without a CUDA device. On the card
they run without the JAX test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from opticalflowfromdepth_torch.models.raft import RAFT
from opticalflowfromdepth_torch.ops import fused_corr as fc
from opticalflowfromdepth_torch.ops import instance_norm as inorm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("levels,radius,h,w", [(4, 4, 12, 16), (2, 3, 7, 9)])
def test_fused_corr_kernel_matches_plain(card, dtype, atol, levels, radius,
                                         h, w):
    g = torch.Generator().manual_seed(0)
    b, c = 2, 64
    f1 = torch.randn(b, h * w, c, generator=g).to(card, dtype)
    f2 = torch.randn(b, h, w, c, generator=g).to(card)
    coords = (torch.rand(b, h * w, 2, generator=g) * 30 - 8).to(card)
    f2cat = fc.corr_levels_cat(f2, levels, dtype)
    before = fc.fused_corr_lookup_cat.launches
    got = fc.fused_corr_lookup_cat(f1, f2cat, coords, h, w, levels, radius)
    torch.cuda.synchronize()
    assert fc.fused_corr_lookup_cat.launches == before + 1
    ref = fc.fused_corr_lookup_cat_plain(f1, f2cat, coords, h, w, levels,
                                         radius)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol,
                               rtol=atol)


def test_fused_corr_kernel_refuses_gradients(card):
    f1 = torch.randn(1, 48, 32, device=card, requires_grad=True)
    f2cat = fc.corr_levels_cat(torch.randn(1, 6, 8, 32, device=card), 4,
                               torch.float32)
    coords = torch.zeros(1, 48, 2, device=card)
    with pytest.raises(RuntimeError, match="backward"):
        fc.fused_corr_lookup_cat(f1, f2cat, coords, 6, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_kernel_matches_plain(card, dtype, relu):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(2, 24, 37, 53, generator=g) * 3 + 1).to(card, dtype)
    y, m, r = inorm.instance_norm(x, 1e-5, relu)
    yr, mr, rr = inorm.instance_norm_plain(x, 1e-5, relu)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yr.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(m.cpu().numpy(), mr.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(r.cpu().numpy(), rr.cpu().numpy(), rtol=1e-5)


def test_raft_small_on_card_matches_cpu(card):
    model = RAFT(small=True, corr_impl="fused",
                 generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    i1, i2 = (torch.rand(1, 3, 64, 96, generator=g) * 255 for _ in range(2))
    with torch.inference_mode():
        lr, up = model(i1, i2, iters=4, test_mode=True)
        model.to(card)
        lr_c, up_c = model(i1.to(card), i2.to(card), iters=4, test_mode=True)
    np.testing.assert_allclose(up_c.cpu().numpy(), up.numpy(), atol=1e-3)
