"""The port's flash softmax-matmul with a dense additive bias (``ops/flash.py``
``bias=``, the backward ``ops/flash_bwd.py:flash_backward_with_bias``) on
the CPU against the JAX one.

The forward (the plain version, what CPU tensors take) is held against the
TPU kernel run in interpret mode with the same key blocks in bf16, within
``bf16_tolerance`` computed with the bias, and against JAX's dense oracle
``flash_softmax_matmul_ref`` in f32. Rows the bias masks whole (-1e30 on
every key) give the oracle's mean of v at Lk = 128 and Lk = 100; the TPU
kernel's own answer at Lk = 100 (its padded keys in the denominator) is
recorded beside it. The gradients are held to ``jax.vjp`` through JAX's
function with a bias (its dense ``_flash_vjp_bwd``) in bf16, and to the
VJP of the dense f32 oracle in f32. Inputs come from numpy seeds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.ops.flash import (
    _flash_forward, _flash_vjp_bwd, flash_softmax_matmul,
    flash_softmax_matmul_ref)
from opticalflowfromdepth_torch.ops import flash as tf
from opticalflowfromdepth_torch.ops import flash_bwd as tb

torch.set_num_threads(2)


def _inputs(seed, b, lq, lk, c, d, kind="normal"):
    """q, k, v and a bias [b, lq, lk] (f32 numpy): "normal" N(0, 1);
    "block" JAX's test_flash_with_additive_bias mask (-100 on 30% of the
    scores)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, c)).astype(np.float32)
    k = rng.normal(size=(b, lk, c)).astype(np.float32)
    v = rng.normal(size=(b, lk, d)).astype(np.float32)
    if kind == "block":
        bias = np.where(rng.uniform(size=(b, lq, lk)) < 0.3, -100.0, 0.0)
    else:
        bias = rng.normal(size=(b, lq, lk))
    return q, k, v, bias.astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# (b, lq, lk, c, d, bias kind, swin): JAX's test_flash_with_additive_bias
# case, a normal bias, ragged lengths, and a bias with the Swin mask (the
# FeatureTransformer's [2B] batch of 2x2 windows of 4x6 tokens)
CASES = {
    "jax_additive_bias": (2, 160, 288, 32, 64, "block", None),
    "normal": (2, 128, 256, 32, 16, "normal", None),
    "ragged_d2": (1, 200, 300, 64, 2, "normal", None),
    "with_swin": (2 * 2 * 4, 24, 24, 32, 32, "normal", (2, 4, 6, 2, 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax_interpret_bf16(case):
    """bf16 operands, key blocks of 128 on both sides: within
    ``bf16_tolerance`` (with the bias) row by row, and the LSE to 1e-5
    against ``_flash_forward(with_lse=True)``."""
    b, lq, lk, c, d, kind, swin = CASES[case]
    q, k, v, bias = _inputs(1, b, lq, lk, c, d, kind)
    want, want_lse = _flash_forward(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v), bias=jnp.asarray(bias), block_q=128, block_k=128,
        interpret=True, swin=swin, with_lse=True)
    got, lse = tf.flash_softmax_matmul_plain(
        _bf16(q), _bf16(k), _t(v), swin=swin, with_lse=True, block_k=128,
        bias=_t(bias))
    assert got.dtype == torch.float32 and got.shape == (b, lq, d)
    tol = tf.bf16_tolerance(_bf16(q), _bf16(k), _t(v), swin=swin,
                            bias=_t(bias)).numpy()
    assert (np.abs(got.numpy() - np.asarray(want)) / tol).max() <= 1.0
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_f32_matches_jax_dense_oracle(case):
    """f32 operands: against ``flash_softmax_matmul_ref(bias=)`` (the Swin
    mask added to the oracle's bias) within 1e-5 of max|v|, through the
    public call."""
    b, lq, lk, c, d, kind, swin = CASES[case]
    q, k, v, bias = _inputs(2, b, lq, lk, c, d, kind)
    dense = bias
    if swin is not None:
        dense = bias + tf.swin_mask_dense(lk, swin, b).numpy()
    want = np.asarray(flash_softmax_matmul_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=jnp.asarray(dense)))
    got = tf.flash_softmax_matmul(_t(q), _t(k), _t(v), bias=_t(bias),
                                  swin=swin)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(v).max())


@pytest.mark.parametrize("lk", [128, 100])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_rows_masked_whole_give_the_oracles_mean(lk, dtype):
    """Rows whose every key the bias masks (-1e30): the port gives the mean
    of v over the real keys and the LSE -1e30 + log(Lk), as JAX's dense
    oracle does, at Lk = 128 (a multiple of the TPU kernel's key block) and
    Lk = 100; so does the base-2 form of the wgmma and tf32x3 routes,
    whose folded bias (-1.44e30) lies below the TPU kernel's running-max
    start. The TPU kernel itself agrees at 128 and gives sum(v) / 128 at
    100: its 28 padded keys enter the denominator."""
    q, k, v, bias = _inputs(3, 2, 64, lk, 32, 2)
    rows = [0, 17, 63]
    bias[1, rows] = -1e30
    cast = _bf16 if dtype == "bf16" else _t
    oracle = np.asarray(flash_softmax_matmul_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=jnp.asarray(bias)))
    vv = cast(v).float().numpy()
    np.testing.assert_allclose(oracle[1, rows],
                               np.broadcast_to(v[1].mean(0), (3, 2)),
                               rtol=1e-5, atol=1e-6)
    for exp2 in (False, True):
        got, lse = tf.flash_softmax_matmul_plain(
            cast(q), cast(k), _t(v), with_lse=True, exp2=exp2, bias=_t(bias))
        np.testing.assert_allclose(got[1, rows].numpy(),
                                   np.broadcast_to(vv[1].mean(0), (3, 2)),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(lse[1, rows].numpy(),
                                   -1e30 + math.log(lk), rtol=1e-6)
        if dtype == "f32":      # the other rows as the oracle's
            keep = [i for i in range(64) if i not in rows]
            assert (np.abs(got[1, keep].numpy() - oracle[1, keep])
                    <= 1e-5 * np.abs(v).max()).all()
    jax_kernel = np.asarray(flash_softmax_matmul(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=jnp.asarray(bias), block_q=64, block_k=128, interpret=True))
    vb = np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(jax_kernel[1, rows],
                               np.broadcast_to(vb[1].sum(0) / 128, (3, 2)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_base2_fold_matches_base_e(case):
    """The plain version's base-2 form with a bias (the scores times
    f32(scale log2 e) plus the bias times f32(log2 e), p = 2^(x - m)), as
    the wgmma and tf32x3 routes fold it, against the base-e form: f32
    within 1e-5 of max|v| and the LSE to 1e-5; bf16 within
    ``bf16_tolerance`` (the two round P from other f32 values)."""
    b, lq, lk, c, d, kind, swin = CASES[case]
    q, k, v, bias = _inputs(4, b, lq, lk, c, d, kind)
    for cast in (_t, _bf16):
        args = (cast(q), cast(k), _t(v))
        e, e_lse = tf.flash_softmax_matmul_plain(*args, swin=swin,
                                                 with_lse=True,
                                                 bias=_t(bias))
        two, two_lse = tf.flash_softmax_matmul_plain(*args, swin=swin,
                                                     with_lse=True, exp2=True,
                                                     bias=_t(bias))
        np.testing.assert_allclose(two_lse.numpy(), e_lse.numpy(), rtol=1e-6,
                                   atol=1e-5)
        if cast is _t:
            np.testing.assert_allclose(two.numpy(), e.numpy(), rtol=0,
                                       atol=1e-5 * np.abs(v).max())
        else:
            tol = tf.bf16_tolerance(*args, swin=swin, bias=_t(bias))
            assert float(((two - e).abs() / tol).max()) <= 1.0


def test_bf16_tolerance_weighs_the_bias():
    """With a mask-like bias the tolerance follows the masked softmax: the
    plain version with the bias passes it, and the same call without the
    bias (or with the bias's last key column dropped, that column weighed
    +8) fails it."""
    q, k, v, bias = _inputs(5, 2, 128, 192, 32, 16)
    bias[..., -1] += 8.0
    args = (_bf16(q), _bf16(k), _t(v))
    ref = tf.flash_softmax_matmul_plain(*args, bias=_t(bias))
    tol = tf.bf16_tolerance(*args, bias=_t(bias))
    cut = bias.copy()
    cut[..., -1] = 0.0
    for fault in (tf.flash_softmax_matmul_plain(*args),
                  tf.flash_softmax_matmul_plain(*args, bias=_t(cut))):
        assert float(((fault - ref).abs() / tol).max()) > 1.0
    again = tf.flash_softmax_matmul_plain(*args, bias=_t(bias), block_k=None)
    assert float(((again - ref).abs() / tol).max()) <= 1.0


GRAD_CASES = {
    "normal": (2, 48, 80, 32, 16, "normal", None),
    "block_d2": (1, 64, 100, 16, 2, "block", None),
    "with_swin": (2 * 2 * 4, 24, 24, 32, 32, "normal", (2, 4, 6, 2, 3)),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_bf16_grads_match_jax_vjp(case):
    """bf16 q, k (f32 v and g): the Function's gradients against ``jax.vjp``
    through JAX's ``flash_softmax_matmul(bias=)`` (forward in interpret
    mode, backward the dense ``_flash_vjp_bwd``), cast for cast: q, k and
    ds rounded to bf16, p, g and v f32, dq and dk returned in bf16, dv in
    f32. The two differ by f32 summation order, and by that a ds may round
    to the neighbouring bf16 value (2^-8 of its term) and a gradient to
    the neighbouring bf16 value (2^-8 of it): allowed, 2^-8 |ref| + 2^-8
    of the summed term sizes + 1e-6 (dq, dk) and 1e-5 of max |ref| (dv).
    The bias's gradient is zeros on both sides."""
    b, lq, lk, c, d, kind, swin = GRAD_CASES[case]
    q, k, v, bias = _inputs(6, b, lq, lk, c, d, kind)
    g = np.random.default_rng(7).normal(size=(b, lq, d)).astype(np.float32)

    def jfn(q_, k_, v_, bias_):
        return flash_softmax_matmul(q_, k_, v_, bias=bias_, block_q=128,
                                    block_k=128, interpret=True, swin=swin)
    _, vjp = jax.vjp(jfn, jnp.asarray(q, jnp.bfloat16),
                     jnp.asarray(k, jnp.bfloat16), jnp.asarray(v),
                     jnp.asarray(bias))
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g))]
    tq, tk = (_bf16(x).requires_grad_() for x in (q, k))
    tv, tbias = (_t(x).requires_grad_() for x in (v, bias))
    out = tf.flash_softmax_matmul(tq, tk, tv, bias=tbias, swin=swin)
    got = torch.autograd.grad(out, (tq, tk, tv, tbias), _t(g))
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert got[2].dtype == torch.float32
    assert not bool(got[3].any()) and not want[3].any()
    # the sizes of dq's and dk's terms, from the dense softmax
    scale = c ** -0.5
    s = tq.detach().float() @ tk.detach().float().transpose(1, 2) * scale \
        + _t(bias)
    if swin is not None:
        s = s + tf.swin_mask_dense(lk, swin, b)
    p = torch.softmax(s, -1)
    dp = _t(g) @ _t(v).transpose(1, 2)
    ads = (p * (dp - (dp * p).sum(-1, keepdim=True))).abs()
    lims = (scale * ads @ tk.detach().float().abs(),
            scale * ads.transpose(1, 2) @ tq.detach().float().abs())
    for x, w, lim in zip(got[:2], want[:2], lims):
        d_ = np.abs(x.float().numpy() - w)
        assert (d_ <= 2 ** -8 * (np.abs(w) + lim.numpy()) + 1e-6).all()
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0,
                               atol=1e-5 * np.abs(want[2]).max())


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_f32_grads_match_jax_dense_oracle(case):
    """f32 operands keep f32 in the port's dense backward (JAX's
    ``_flash_vjp_bwd`` rounds q, k and ds to bf16 even then: a known
    difference): against the VJP of JAX's dense f32 oracle within 1e-5 of
    each gradient's largest value; the bias's gradient zeros."""
    b, lq, lk, c, d, kind, swin = GRAD_CASES[case]
    q, k, v, bias = _inputs(8, b, lq, lk, c, d, kind)
    g = np.random.default_rng(9).normal(size=(b, lq, d)).astype(np.float32)
    dense = bias if swin is None else \
        bias + tf.swin_mask_dense(lk, swin, b).numpy()
    _, vjp = jax.vjp(lambda q_, k_, v_: flash_softmax_matmul_ref(
        q_, k_, v_, bias=jnp.asarray(dense)), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tbias = (_t(x).requires_grad_() for x in (q, k, v, bias))
    got = torch.autograd.grad(
        tf.flash_softmax_matmul(tq, tk, tv, bias=tbias, swin=swin),
        (tq, tk, tv, tbias), _t(g))
    for x, w in zip(got[:3], want):
        w = np.asarray(w)
        np.testing.assert_allclose(x.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert got[3].shape == bias.shape and not bool(got[3].any())


def test_dense_backward_is_jax_flash_vjp_bwd_itself():
    """``flash_backward_with_bias`` on bf16 operands against JAX's
    ``_flash_vjp_bwd`` called with the same residuals and q, k given as
    their bf16 values in f32 (so JAX returns dq and dk before its final
    cast): within 2^-8 of the summed term sizes (a ds rounding to the
    neighbouring bf16 value) and 1e-5 of max |ref|."""
    b, lq, lk, c, d = 2, 64, 96, 32, 16
    q, k, v, bias = _inputs(10, b, lq, lk, c, d)
    g = np.random.default_rng(11).normal(size=(b, lq, d)).astype(np.float32)
    qb, kb = (_bf16(x).float().numpy() for x in (q, k))
    scale = c ** -0.5
    res = (jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(v),
           jnp.asarray(bias), None, None)
    want = _flash_vjp_bwd(scale, None, None, True, None, res,
                          jnp.asarray(g))
    assert not np.asarray(want[3]).any()
    got = tb.flash_backward_with_bias(_bf16(q), _bf16(k), _t(v), _t(bias),
                                      _t(g), scale)
    s = _t(qb) @ _t(kb).transpose(1, 2) * scale + _t(bias)
    p = torch.softmax(s, -1)
    dp = _t(g) @ _t(v).transpose(1, 2)
    ads = (p * (dp - (dp * p).sum(-1, keepdim=True))).abs()
    lims = (scale * ads @ _t(kb).abs(),
            scale * ads.transpose(1, 2) @ _t(qb).abs(),
            torch.zeros(1))
    for x, w, lim in zip(got, want[:3], lims):
        w = np.asarray(w)
        d_ = np.abs(x.numpy() - w)
        assert (d_ <= 2 ** -8 * lim.numpy() + 1e-5 * np.abs(w).max()).all()


def test_bias_shape_and_dtype_are_checked():
    """The bias is exactly [B, Lq, Lk] (JAX's BlockSpec indexes it (ib, iq,
    ik) and never broadcasts) and a float; any float dtype is read as f32."""
    q, k, v, bias = _inputs(12, 2, 16, 24, 8, 4)
    for bad in (_t(bias[:1]), _t(bias[:, :, :5]), _t(bias[0]),
                _t(bias).to(torch.int32)):
        with pytest.raises(ValueError, match="bias"):
            tf.flash_softmax_matmul(_t(q), _t(k), _t(v), bias=bad)
    f16 = tf.flash_softmax_matmul(_t(q), _t(k), _t(v),
                                  bias=_t(bias).half())
    f32 = tf.flash_softmax_matmul(_t(q), _t(k), _t(v),
                                  bias=_t(bias).half().float())
    assert torch.equal(f16, f32)
