"""The port's Hopper kernels against their plain versions, on the card,
forward and backward, and one training step card against CPU.

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


def _valid_rows(h, w, levels):
    rows = []
    for (hl, wl, hp, off) in fc.cat_meta(h, w, levels):
        for x in range(wl):
            rows.extend(off + x * hp + y for y in range(hl))
    return rows


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("levels,radius,h,w", [(4, 4, 12, 16), (2, 3, 7, 9)])
def test_fused_corr_bwd_kernel_matches_plain(card, dtype, atol, levels,
                                             radius, h, w):
    """Through autograd: the backward kernel against the plain backward.
    f32: the kernel sums df2cat with atomics in a varying order, 1e-4;
    bf16: both round the f32 sums to bf16 once."""
    g = torch.Generator().manual_seed(4)
    b, c = 2, 64
    f1 = torch.randn(b, h * w, c, generator=g).to(card, dtype)
    f2 = torch.randn(b, h, w, c, generator=g).to(card)
    coords = (torch.rand(b, h * w, 2, generator=g) * 30 - 8).to(card)
    f2cat = fc.corr_levels_cat(f2, levels, dtype)
    k2 = (2 * radius + 1) ** 2
    gout = torch.randn(b, h * w, levels * k2, generator=g).to(card, dtype)
    f1.requires_grad_()
    f2cat.requires_grad_()
    before = fc.fused_corr_lookup_cat.bwd_launches
    out = fc.fused_corr_lookup_cat(f1, f2cat, coords, h, w, levels, radius)
    out.backward(gout)
    torch.cuda.synchronize()
    assert fc.fused_corr_lookup_cat.bwd_launches == before + 1
    ref1, ref2 = fc.fused_corr_lookup_cat_bwd_plain(
        gout, f1.detach(), f2cat.detach(), coords, h, w, levels, radius)
    assert f1.grad.dtype == f2cat.grad.dtype == dtype
    np.testing.assert_allclose(f1.grad.float().cpu().numpy(),
                               ref1.float().cpu().numpy(), atol=atol,
                               rtol=atol)
    np.testing.assert_allclose(f2cat.grad.float().cpu().numpy(),
                               ref2.float().cpu().numpy(), atol=atol,
                               rtol=atol)
    pad = sorted(set(range(f2cat.shape[1])) - set(_valid_rows(h, w, levels)))
    assert torch.count_nonzero(f2cat.grad[:, pad]) == 0


def test_fused_corr_bwd_kernel_far_out_of_range_is_zero(card):
    f1 = torch.randn(1, 48, 32, device=card, requires_grad=True)
    f2cat = fc.corr_levels_cat(torch.randn(1, 6, 8, 32, device=card), 4,
                               torch.float32).requires_grad_()
    coords = torch.full((1, 48, 2), 1e4, device=card)
    fc.fused_corr_lookup_cat(f1, f2cat, coords, 6, 8).sum().backward()
    assert torch.count_nonzero(f1.grad) == 0
    assert torch.count_nonzero(f2cat.grad) == 0


@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_grad_on_card_matches_cpu(card, relu):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 24, 37, 53, generator=g) * 3 + 1
    gy = torch.randn(x.shape, generator=g)
    grads = []
    for dev in ("cpu", card):
        xd = x.detach().to(dev).requires_grad_()
        inorm.instance_norm(xd, 1e-5, relu)[0].backward(gy.to(dev))
        grads.append(xd.grad.cpu().numpy())
    np.testing.assert_allclose(grads[1], grads[0], atol=1e-5, rtol=1e-4)


def test_train_step_on_card_matches_cpu(card):
    """RAFT-basic, one f32 step of the training recipe (classifier on), on
    the card (kernels) and on the CPU (plain versions), same weights: the
    metrics, the raw gradients (captured before the optimizer's clip) and
    the parameters after the update."""
    import copy

    from opticalflowfromdepth_torch.data.loader import to_device
    from opticalflowfromdepth_torch.models.classifier import Classifier
    from opticalflowfromdepth_torch.models.layers import init_weights_
    from opticalflowfromdepth_torch.train import raft_train as rt

    cfg = rt.RAFTTrainConfig(iters=2, batch_size=2, image_size=(64, 96),
                             mixed_precision=False, add_classifier=True,
                             num_steps=100)
    gen = torch.Generator().manual_seed(6)
    cls = Classifier()
    init_weights_(cls, gen)
    rng = np.random.default_rng(7)
    batch = dict(
        image1=rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32),
        image2=rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32),
        flow=rng.normal(0, 3, (2, 64, 96, 2)).astype(np.float32),
        valid=np.ones((2, 64, 96), np.float32),
        label=np.eye(4, dtype=np.float32)[[0, 2]])
    out = {}
    for dev in ("cpu", "cuda"):
        state = rt.init_state(cfg, seed=8, device=dev)
        grads = {}
        adam_step = state.optimizer.step

        def step_keeping_grads(state=state, grads=grads, adam_step=adam_step):
            grads.update({n: p.grad.to("cpu", copy=True) for n, p
                          in state.model.named_parameters()})
            return adam_step()
        state.optimizer.step = step_keeping_grads
        step = rt.make_train_step(cfg, copy.deepcopy(cls), device=dev)
        state, m = step(state, to_device(batch, dev),
                        torch.Generator(device=dev).manual_seed(0))
        out[dev] = ({k: float(v) for k, v in m.items()}, grads,
                    {k: v.cpu() for k, v in state.model.state_dict().items()})
    for k, v in out["cpu"][0].items():
        np.testing.assert_allclose(out["cuda"][0][k], v, rtol=1e-4,
                                   err_msg=k)
    # the step amplifies f32 rounding (the context encoder's BatchNorm over
    # 2 samples): two CPU runs differ by 4.4e-5 of the global norm and by
    # 4.8e-4 of fnet's. Every raw gradient within 2e-4 of the global norm;
    # fnet's reach it only through the lookup's backward kernel and
    # instance norm's backward: within 1e-2 of their (non-zero) norm
    g_cpu, g_card = out["cpu"][1], out["cuda"][1]
    norm = torch.sqrt(sum((g ** 2).sum() for g in g_cpu.values()))
    for k, g in g_cpu.items():
        assert (g_card[k] - g).abs().max() < 2e-4 * norm, k
    fnet = [k for k in g_cpu if k.startswith("fnet.")]
    f_norm = torch.sqrt(sum((g_cpu[k] ** 2).sum() for k in fnet))
    err = torch.sqrt(sum(((g_card[k] - g_cpu[k]) ** 2).sum() for k in fnet))
    assert f_norm > 0 and err < 1e-2 * f_norm
    # one Adam step moves each parameter by about the learning rate
    for k, v in out["cpu"][2].items():
        np.testing.assert_allclose(out["cuda"][2][k].float().numpy(),
                                   v.float().numpy(), atol=2e-4, err_msg=k)


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
