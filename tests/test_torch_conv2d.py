"""The port's 3x3 stride-1 conv on the CPU against the JAX package's.

The plain version (what the CPU path runs, and what the CUDA kernel is
held to on the card) against JAX's Pallas kernel in interpret mode and
its XLA path, at ``tests/test_conv2d.py``'s shapes; the autograd
Function's gradients against JAX's custom VJP; the shared tolerance,
which must admit another summation order and refuse two planted faults;
the wrapper's refusals; and ``plan``, the host arithmetic that picks the
kernel's route and parameters.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.ops.conv2d import (_conv3x3_s1_pallas,
                                                 _conv3x3_s1_xla)
from opticalflowfromdepth_tpu.ops.conv2d import conv3x3_s1 as j_conv
from opticalflowfromdepth_torch.ops import conv2d as cv

torch.set_num_threads(2)

F32_SHAPES = [((2, 32, 24, 16), 32), ((1, 33, 17, 8), 8),
              ((1, 16, 128, 64), 64)]


def _inputs(seed, shape, co, w_std=0.2):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.normal(0, w_std, (3, 3, shape[-1], co)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape,co", F32_SHAPES)
@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
def test_plain_matches_jax_f32(shape, co, oracle):
    """f32 within 1e-4 (the JAX test's tolerance between its two paths)."""
    x, w = _inputs(0, shape, co)
    if oracle == "xla":
        want = np.asarray(_conv3x3_s1_xla(jnp.asarray(x), jnp.asarray(w)))
    else:
        want = np.asarray(_conv3x3_s1_pallas(jnp.asarray(x), jnp.asarray(w),
                                             tile_h=16, interpret=True))
    got = cv.conv3x3_s1(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == shape[:3] + (co,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
def test_plain_matches_jax_bf16(oracle):
    """bf16 (the JAX test's case): each side sums exact products in f32
    and rounds once, so within ``cv.tolerance`` (one bf16 step of the
    output plus 2^-16 of sum |x.w|)."""
    x, w = _inputs(1, (2, 16, 32, 32), 32)
    xj, wj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w))
    if oracle == "xla":
        want = _conv3x3_s1_xla(xj, wj)
    else:
        want = _conv3x3_s1_pallas(xj, wj, interpret=True)
    want = np.array(want.astype(jnp.float32))
    xt, wt = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (xj, wj))
    got = cv.conv3x3_s1(xt, wt)
    assert got.dtype == torch.bfloat16
    excess = (got.float() - torch.from_numpy(want)).abs() / cv.tolerance(
        xt, wt)
    assert float(excess.max()) <= 1.0


def test_cpu_path_is_the_plain_version():
    x, w = (torch.from_numpy(a) for a in _inputs(2, (2, 9, 11, 5), 3))
    before = cv.conv3x3_s1.launches
    assert torch.equal(cv.conv3x3_s1(x, w), cv.conv3x3_s1_plain(x, w))
    assert cv.conv3x3_s1.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tolerance_refuses_the_planted_faults(dtype):
    """Another summation order (the taps summed last to first, channels in
    halves) passes; the (2, 2) tap left out, and the last halo row of each
    16-row band read as zero, fail: what chip_smoke.py [3g] checks of the
    kernel on the card."""
    x, w = (torch.from_numpy(a).to(dtype)
            for a in _inputs(3, (1, 40, 24, 64), 32, 0.05))
    tol = cv.tolerance(x, w)
    ref = cv.conv3x3_s1_plain(x, w).float()
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(ref.shape)
    for tap in reversed(range(9)):
        dy, dx = divmod(tap, 3)
        xs = xp[:, dy:dy + 40, dx:dx + 24]
        for half in (slice(32, 64), slice(0, 32)):
            acc = acc + xs[..., half] @ w.float()[dy, dx, half]
    reordered = acc.to(dtype).float()
    assert float(((reordered - ref).abs() / tol).max()) <= 1.0
    w_cut = w.clone()
    w_cut[2, 2] = 0
    x_cut = x.clone()
    th = cv.KERNEL_TILE_H
    x_cut[:, th::th] = 0
    halo = ref.clone()
    halo[:, th - 1::th] = cv.conv3x3_s1_plain(x_cut, w).float()[:, th - 1::th]
    for fault in (cv.conv3x3_s1_plain(x, w_cut).float(), halo):
        assert float(((fault - ref).abs() / tol).max()) > 1.0


def _jax_grads(x, w):
    def loss(x, w):
        return jnp.sum(jnp.tanh(j_conv(x, w)))
    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))


@pytest.mark.parametrize("shape,co", [((2, 12, 10, 8), 16),
                                      ((1, 17, 9, 5), 3)])
def test_function_grads_match_jax_custom_vjp(shape, co):
    """The Function's dx and dw against the gradients of JAX's
    ``conv3x3_s1`` (its ``_bwd``) through the same loss, f32, 1e-4."""
    x, w = _inputs(4, shape, co, 0.3)
    gx_ref, gw_ref = _jax_grads(x, w)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    torch.tanh(cv.conv3x3_s1(xt, wt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_ref),
                               rtol=1e-4, atol=1e-4)


def test_function_grads_bf16_dtypes_and_needs_input_grad():
    x, w = _inputs(5, (1, 8, 8, 8), 4)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).to(torch.bfloat16)
    cv.conv3x3_s1(xt, wt).float().sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and wt.grad is None
    # dx of sum(y) is the conv of ones with the flipped, transposed kernel
    want = cv.conv3x3_s1_plain(torch.ones(1, 8, 8, 4, dtype=torch.bfloat16),
                               wt.flip(0, 1).transpose(2, 3))
    assert torch.equal(xt.grad, want)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    x, w = (torch.from_numpy(a) for a in _inputs(6, (1, 4, 4, 8), 8))
    with pytest.raises(ValueError, match="CUDA device"):
        cv._conv_cuda(x, w)
    with pytest.raises(ValueError, match=r"\[3, 3, C, CO\]"):
        cv.conv3x3_s1(x, w[:, :, :4])
    with pytest.raises(ValueError, match=r"\[3, 3, C, CO\]"):
        cv.conv3x3_s1(x[0], w)


def test_kernel_wrapper_refuses_dtypes_and_strides():
    """The kernel's wrapper checks dtype and layout before it looks for a
    card, so its refusals show on the CPU too."""
    x, w = (torch.from_numpy(a) for a in _inputs(7, (1, 4, 4, 8), 8))
    with pytest.raises(ValueError, match="both bf16 or both f32"):
        cv._conv_cuda(x.double(), w.double())
    with pytest.raises(ValueError, match="both bf16 or both f32"):
        cv._conv_cuda(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        cv._conv_cuda(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="contiguous"):
        cv._conv_cuda(x, w.transpose(2, 3))


def _conv_shapes():
    """``chip_smoke.py``'s ``CONV_SHAPES`` (the script imports only the
    standard library at its top)."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CONV_SHAPES


CONV_SHAPES = _conv_shapes()


@pytest.mark.parametrize("name,shape", CONV_SHAPES,
                         ids=[s[0] for s in CONV_SHAPES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_route_of_every_conv_shape(name, shape, dtype):
    """Every shape the card's smoke test runs takes the wgmma route in
    bf16 (C % 8 == 0, aligned pointers) and the f32 route in f32, within
    227 KB of shared memory, its CO tiles covering CO with none empty."""
    b, h, w, c, co = shape
    p = cv.plan(b, h, w, c, co, dtype)
    assert p.route == ("wgmma" if dtype == torch.bfloat16 else "f32")
    assert p.smem <= cv.SMEM_CAP and p.tile == (16, 16)
    assert p.n % 8 == 0 and p.n * p.n_cot >= co > p.n * (p.n_cot - 1)
    tiles = -(-h // 16) * -(-w // 16)
    if p.route == "wgmma":
        assert p.n == cv.WGMMA_M and p.stages == 2
        assert p.resident == (c <= 64)
        assert p.grid == (min(p.n_cot * b * tiles, cv.H100_SMS), 1)
    else:
        assert p.grid == (tiles * p.n_cot, b)


@pytest.mark.parametrize("c,x_aligned,w_aligned", [
    (3, True, True),      # C % 8 != 0 (tests/test_torch_cuda.py's C = 3)
    (16, False, True),    # x past a 16-byte boundary
    (16, True, False)])   # w past it
def test_plan_takes_mma_sync_where_wgmma_does_not(c, x_aligned, w_aligned):
    p = cv.plan(2, 18, 20, c, 24, torch.bfloat16, x_aligned, w_aligned)
    assert p.route == "mma_sync" and not p.resident
    assert (p.n, p.n_cot, p.grid) == (64, 1, (4, 2))
    assert p.smem <= cv.SMEM_CAP


@pytest.mark.parametrize("c", [8, 16, 64, 72, 96, 128, 200, 256, 512, 1024])
def test_plan_resident_weights_exactly_where_they_fit(c):
    """For every CO the wgmma route's weights stay resident exactly where
    nine taps x C rounded up to 64 x 64 output channels x 2 bytes fit in
    227 KB beside the ring of two bands and the two output tiles (C <=
    64); else one 64-channel chunk's are staged at a time. Either way the
    block fits; CO tiles of 64 cover CO, none empty."""
    for co in (1, 2, 7, 8, 24, 40, 64, 65, 96, 126, 128, 200, 256, 300):
        p = cv.plan(1, 40, 40, c, co, torch.bfloat16, sms=8)
        assert p.route == "wgmma", (c, co)
        chunks = -(-c // 64)
        fits = 1024 + 2 * cv.BAND_STAGE_BYTES + 9 * chunks * 64 * 64 * 2 \
            + 2 * 144 * 64 * 2 + 32 <= cv.SMEM_CAP
        assert p.resident == fits == (c <= 64), (c, co)
        assert p.smem == cv.wgmma_smem(c, p.resident) <= cv.SMEM_CAP
        assert p.n == 64 and p.n * p.n_cot >= co > p.n * (p.n_cot - 1)
        assert p.grid == (min(p.n_cot * 9, 8), 1)
