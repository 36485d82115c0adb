"""The port's flash backward (``ops/flash_bwd.py`` and the autograd Function
of ``ops/flash.py``) on the CPU against the JAX one.

The plain backward is held against the TPU kernels run in interpret mode
(`flash_bwd.py:flash_backward`) on the same bf16 operands and the same
forward residuals, so ``p`` and ``ds`` are rounded to bf16 at the same
places; the f32 path against the JAX dense oracle's VJP; the bf16 path
against the dense ``_flash_vjp_bwd`` (which rounds less); the Function's
gradients against autograd through a dense ``torch.softmax``. Inputs come
from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.ops.flash import (
    _flash_forward, _flash_vjp_bwd, _swin_mask_dense,
    flash_softmax_matmul_ref)
from opticalflowfromdepth_tpu.ops.flash_bwd import flash_backward as jbwd
from opticalflowfromdepth_torch.ops import flash as tf
from opticalflowfromdepth_torch.ops import flash_bwd as tb

torch.set_num_threads(2)

# (b, lq, lk, c, d, score multiplier, v scale, swin). The Swin case is the
# FeatureTransformer's concatenated [2B] batch: B=2 pairs of 2x2 windows of
# 4x6 tokens, ordered [b, wy, wx].
CASES = {
    "plain_d32": (2, 128, 192, 32, 32, 1.0, 1.0, None),
    "plain_d2": (1, 256, 256, 64, 2, 1.0, 30.0, None),
    "ragged_lq_lk_d2": (1, 200, 300, 64, 2, 1.0, 30.0, None),
    "ragged_d16": (2, 100, 63, 32, 16, 1.0, 1.0, None),
    "swin_b2": (2 * 2 * 4, 24, 24, 32, 128, 1.0, 1.0, (2, 4, 6, 2, 3)),
    "extreme_logits": (1, 128, 256, 32, 2, 30.0, 1.0, None),
}


def _inputs(seed, b, lq, lk, c, d, mult=1.0, vscale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, lq, c)) * mult).astype(np.float32)
    k = (rng.normal(size=(b, lk, c)) * mult).astype(np.float32)
    v = (rng.normal(size=(b, lk, d)) * vscale).astype(np.float32)
    g = rng.normal(size=(b, lq, d)).astype(np.float32)
    return q, k, v, g


def _bf16(x):
    """numpy f32 -> the bf16 value as f32 (both frameworks round the same
    way, to nearest even)."""
    return torch.from_numpy(x).bfloat16()


def _jax_residuals(q, k, v, swin):
    """The JAX kernel's forward (bf16 operands, blocks of 128): out, lse."""
    out, lse = _flash_forward(jnp.asarray(q, jnp.bfloat16),
                              jnp.asarray(k, jnp.bfloat16), jnp.asarray(v),
                              block_q=128, block_k=128, interpret=True,
                              swin=swin, with_lse=True)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("jax_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_interpret_bf16(case, jax_dtype):
    """The same forward residuals on both sides: the plain backward on bf16
    q/k against the TPU kernels in interpret mode within
    ``bwd_bf16_tolerance`` row by row (dq) and key by key (dk, dv). The
    TPU kernels have no f32 path: handed f32 q/k they round them to bf16
    as they load them, so with f32 inputs they meet the port's bf16
    backward too."""
    b, lq, lk, c, d, mult, vscale, swin = CASES[case]
    q, k, v, g = _inputs(1, b, lq, lk, c, d, mult, vscale)
    out, lse = _jax_residuals(q, k, v, swin)
    scale = c ** -0.5
    jdt = jnp.bfloat16 if jax_dtype == "bf16" else jnp.float32
    want = jbwd(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                jnp.asarray(v), jnp.asarray(out), jnp.asarray(lse),
                jnp.asarray(g), scale=scale, block_q=128, block_k=128,
                interpret=True, swin=swin)
    args = (_bf16(q), _bf16(k), torch.from_numpy(v), torch.from_numpy(out),
            torch.from_numpy(lse), torch.from_numpy(g), scale, swin)
    got = tb.flash_backward_plain(*args)
    tols = tb.bwd_bf16_tolerance(*args)
    for name, x, w, tol in zip(("dq", "dk", "dv"), got, want, tols):
        w = np.asarray(w, np.float32)
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        ratio = (np.abs(x.numpy() - w) / tol.numpy()).max()
        assert ratio <= 1.0, (name, ratio)


@pytest.mark.parametrize("case", ["plain_d32", "ragged_lq_lk_d2",
                                  "ragged_d16", "swin_b2"])
def test_plain_f32_matches_jax_dense_vjp(case):
    """f32 operands round nothing: the plain backward against the VJP of
    JAX's dense f32 oracle (the Swin mask as its bias), residuals from the
    port's own f32 forward: 1e-5 of the largest gradient."""
    b, lq, lk, c, d, mult, vscale, swin = CASES[case]
    q, k, v, g = _inputs(2, b, lq, lk, c, d, mult, vscale)
    bias = None if swin is None else _swin_mask_dense(lk, swin, b)
    _, vjp = jax.vjp(lambda a, b_, c_: flash_softmax_matmul_ref(
        a, b_, c_, bias=bias), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = tf.flash_softmax_matmul(tq, tk, tv, swin=swin, with_lse=True)
    got = tb.flash_backward(tq, tk, tv, out, lse, tg, swin=swin)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(x.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("case", ["plain_d32", "swin_b2", "plain_d2"])
def test_plain_bf16_near_jax_dense_flash_vjp_bwd(case):
    """The dense ``_flash_vjp_bwd`` (reached with a dense bias, here zeros)
    rounds q, k and ds to bf16 but not p, g or v: against it the plain
    bf16 backward differs by those roundings, at most 2^-7 (one bf16 step)
    of each term of a sum, summed over the terms: of ``sum (|ds| + p |g|
    |v|) |k|`` for dq (ds and the rounding of g and v inside dp), the same
    with |q| for dk, and of ``sum p |g|`` for dv."""
    b, lq, lk, c, d, mult, vscale, swin = CASES[case]
    q, k, v, g = _inputs(3, b, lq, lk, c, d, mult, vscale)
    out, lse = _jax_residuals(q, k, v, swin)
    scale = c ** -0.5
    bias = jnp.zeros((b, lq, lk), jnp.float32)
    res = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
           jnp.asarray(v), bias, jnp.asarray(out), jnp.asarray(lse))
    want = _flash_vjp_bwd(scale, None, None, True, swin, res,
                          jnp.asarray(g))[:3]
    tq, tk = _bf16(q), _bf16(k)
    tv, tg = torch.from_numpy(v), torch.from_numpy(g)
    got = tb.flash_backward_plain(tq, tk, tv, torch.from_numpy(out),
                                  torch.from_numpy(lse), tg, scale, swin)
    # sizes of the terms, from the f32 dense softmax
    s = torch.matmul(tq.float(), tk.float().transpose(1, 2)) * scale
    if swin is not None:
        s = s + tf.swin_mask_dense(lk, swin, b)
    p = torch.softmax(s, -1)
    dp = torch.matmul(tg, tv.transpose(1, 2))
    ads = (p * (dp - (p * dp).sum(-1, keepdim=True))).abs() \
        + p * torch.matmul(tg.abs(), tv.abs().transpose(1, 2))
    lims = (scale * torch.matmul(ads, tk.float().abs()),
            scale * torch.matmul(ads.transpose(1, 2), tq.float().abs()),
            torch.matmul(p.transpose(1, 2), tg.abs()))
    for name, x, w, lim in zip(("dq", "dk", "dv"), got, want, lims):
        d_ = np.abs(x.numpy() - np.asarray(w, np.float32))
        assert (d_ <= 2 ** -7 * lim.numpy() + 1e-6).all(), name


@pytest.mark.parametrize("swin,b,l,c,d", [(None, 2, 70, 32, 16),
                                          ((2, 4, 6, 2, 3), 8, 24, 32, 32),
                                          (None, 1, 90, 16, 2)])
def test_function_grads_match_dense_autograd(swin, b, l, c, d):
    """f32: the gradients of ``flash_softmax_matmul`` (the Function, its
    plain backward) against autograd through ``torch.softmax`` on the
    dense scores: 1e-5 of the largest."""
    rng = np.random.default_rng(4)
    x = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in ((b, l, c), (b, l, c), (b, l, d), (b, l, d))]
    ours = [t.clone().requires_grad_() for t in x[:3]]
    dense = [t.clone().requires_grad_() for t in x[:3]]
    tf.flash_softmax_matmul(*ours, swin=swin).backward(x[3])
    s = torch.matmul(dense[0], dense[1].transpose(1, 2)) * c ** -0.5
    if swin is not None:
        s = s + tf.swin_mask_dense(l, swin, b)
    (torch.softmax(s, -1) @ dense[2]).backward(x[3])
    for a, r in zip(ours, dense):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), rtol=0,
                                   atol=1e-5 * float(r.grad.abs().max()))


def test_needs_input_grad_and_dtypes():
    """Only the inputs that require grad get one; bf16 q/k with an f32 v
    (the matching grid, the propagated flow) give bf16 dq/dk and an f32
    dv; no input requiring grad takes no Function (no LSE saved)."""
    rng = np.random.default_rng(5)
    q, k = (_bf16(rng.normal(size=(1, 40, 32)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(1, 40, 2)).astype(np.float32))
    for needs in ((True, True, False), (False, False, True),
                  (True, False, True)):
        ins = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), needs)]
        out = tf.flash_softmax_matmul(*ins)
        assert out.dtype == torch.float32 and out.requires_grad
        out.sum().backward()
        for t, n in zip(ins, needs):
            assert (t.grad is not None) == n
            if n:
                assert t.grad.dtype == t.dtype and t.grad.abs().sum() > 0
    out = tf.flash_softmax_matmul(q, k, v)
    assert out.grad_fn is None
    with torch.no_grad():
        assert tf.flash_softmax_matmul(q.requires_grad_(), k, v).grad_fn \
            is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_tolerance_holds_another_order_and_fails_planted_faults(case):
    """``bwd_bf16_tolerance`` (what the card's kernels are held to) admits
    the plain backward with its scores and ``dp`` summed in another order
    (channels permuted), and refuses dq scaled by 0.98 and dk, dv with the
    first 64-query tile left out of the sweep (its LSE set to 1e30, so its
    ``p`` is 0)."""
    b, lq, lk, c, d, mult, vscale, swin = CASES[case]
    q, k, v, g = (torch.from_numpy(x) for x in
                  _inputs(6, b, lq, lk, c, d, mult, vscale))
    q, k = q.bfloat16(), k.bfloat16()
    out, lse = tf.flash_softmax_matmul(q, k, v, swin=swin, with_lse=True)
    scale = c ** -0.5
    ref = tb.flash_backward_plain(q, k, v, out, lse, g, scale, swin)
    pc = torch.from_numpy(np.random.default_rng(7).permutation(c))
    pd = torch.from_numpy(np.random.default_rng(8).permutation(d))
    other = tb.flash_backward_plain(q[..., pc], k[..., pc], v[..., pd],
                                    out[..., pd], lse, g[..., pd], scale,
                                    swin)
    other = (other[0][..., torch.argsort(pc)], other[1][..., torch.argsort(pc)],
             other[2][..., torch.argsort(pd)])
    tols = tb.bwd_bf16_tolerance(q, k, v, out, lse, g, scale, swin)
    for x, r, tol in zip(other, ref, tols):
        assert float(((x - r).abs() / tol).max()) <= 1.0
    assert float(((ref[0] * 0.98 - ref[0]).abs() / tols[0]).max()) > 1.0
    lse_cut = lse.clone()
    lse_cut[:, :64] = 1e30
    cut = tb.flash_backward_plain(q, k, v, out, lse_cut, g, scale, swin)
    for i in (1, 2):
        assert float(((cut[i] - ref[i]).abs() / tols[i]).max()) > 1.0


def test_cpu_backward_launches_nothing():
    q = torch.randn(2, 24, 32, requires_grad=True)
    before = (tb.flash_backward.launches_dq, tb.flash_backward.launches_dkv)
    tf.flash_softmax_matmul(q, q, torch.randn(2, 24, 2)).sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert (tb.flash_backward.launches_dq,
            tb.flash_backward.launches_dkv) == before
