"""The port's flash softmax-matmul (``ops/flash.py``) on the CPU against the
JAX one.

The plain version (what CPU tensors take) is held against the TPU kernel
run in interpret mode on bf16 operands, with the same key blocks, so the
unnormalized P is rounded to bf16 at the same places on both sides; the
LSE against ``_flash_forward(with_lse=True)``; the f32 path against the
dense oracle; and the dense Swin mask against ``shift_window_attn_mask``.
Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.models.gmflow import (
    shift_window_attn_mask, split_feature)
from opticalflowfromdepth_tpu.ops.flash import (
    _flash_forward, flash_softmax_matmul, flash_softmax_matmul_ref)
from opticalflowfromdepth_torch.models import gmflow as tg
from opticalflowfromdepth_torch.ops import flash as tf

torch.set_num_threads(2)


def _inputs(seed, b, lq, lk, c, d, mult=1.0, vscale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, lq, c)) * mult).astype(np.float32)
    k = (rng.normal(size=(b, lk, c)) * mult).astype(np.float32)
    v = (rng.normal(size=(b, lk, d)) * vscale).astype(np.float32)
    return q, k, v


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


# (b, lq, lk, c, d, score multiplier, v scale, swin). The Swin case is the
# FeatureTransformer's concatenated [2B] batch: B=2 pairs of 2x2 windows of
# 4x6 tokens, ordered [b, wy, wx].
CASES = {
    "plain_d128": (2, 128, 384, 32, 128, 1.0, 1.0, None),
    "plain_d2": (1, 256, 256, 64, 2, 1.0, 30.0, None),
    "ragged_lq_lk": (1, 200, 300, 64, 2, 1.0, 30.0, None),
    "ragged_d16": (2, 100, 63, 32, 16, 1.0, 1.0, None),
    "swin_b2": (2 * 2 * 4, 24, 24, 32, 128, 1.0, 1.0, (2, 4, 6, 2, 3)),
    "extreme_logits": (1, 128, 256, 32, 2, 30.0, 1.0, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_interpret_bf16(case):
    """bf16 operands, key blocks of 128 on both sides: the two round the
    same P to bf16, so they agree to f32 summation order and the rare
    bf16 rounding flip of one P value: ``bf16_tolerance`` row by row."""
    b, lq, lk, c, d, mult, vscale, swin = CASES[case]
    q, k, v = _inputs(1, b, lq, lk, c, d, mult, vscale)
    want = np.asarray(flash_softmax_matmul(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v), block_q=128, block_k=128, interpret=True,
        swin=swin))
    got = tf.flash_softmax_matmul_plain(_bf16(q), _bf16(k),
                                        torch.from_numpy(v), swin=swin,
                                        block_k=128)
    assert got.dtype == torch.float32 and got.shape == (b, lq, d)
    tol = tf.bf16_tolerance(_bf16(q), _bf16(k), torch.from_numpy(v),
                            swin=swin).numpy()
    assert (np.abs(got.numpy() - want) / tol).max() <= 1.0
    if case != "extreme_logits":
        # the agreement is far inside that bound
        assert np.abs(got.numpy() - want).mean() < 1e-5 * np.abs(v).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_base2_form_matches_jax_interpret_bf16(case):
    """The wgmma route's base-2 softmax (``exp2=True``: log2(e) folded into
    the scale and the Swin mask, p = 2^(x - m)) with its 64-key blocks,
    against the TPU kernel with the same blocks: within ``bf16_tolerance``
    row by row, and the LSE to 1e-5."""
    b, lq, lk, c, d, mult, vscale, swin = CASES[case]
    q, k, v = _inputs(2, b, lq, lk, c, d, mult, vscale)
    want, want_lse = _flash_forward(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v), block_q=64, block_k=tf.KERNEL_BLOCK_K,
        interpret=True, swin=swin, with_lse=True)
    got, lse = tf.flash_softmax_matmul_plain(
        _bf16(q), _bf16(k), torch.from_numpy(v), swin=swin, with_lse=True,
        exp2=True)
    tol = tf.bf16_tolerance(_bf16(q), _bf16(k), torch.from_numpy(v),
                            swin=swin).numpy()
    assert (np.abs(got.numpy() - np.asarray(want)) / tol).max() <= 1.0
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5,
                               rtol=1e-6)


def test_sharp_softmax_flow_payload_mirrors_jax_rounding():
    """Global propagation passes the f32 flow as v; the TPU kernel rounds it
    (and P) to bf16. With a sharp softmax over L=1024 the JAX kernel's
    result leaves the f32 oracle by ~0.1 px; the port's bf16 path follows
    the JAX kernel to 1e-3 px, so it mirrors that rounding (the JAX-side
    finding in ROADMAP.md section 3)."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(1, 1024, 128)).astype(np.float32) * 3.0
    k = q + rng.normal(size=q.shape).astype(np.float32) * 0.3
    v = rng.uniform(-60, 60, (1, 1024, 2)).astype(np.float32)
    jq, jk = jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    jax_kernel = np.asarray(flash_softmax_matmul(jq, jk, jnp.asarray(v),
                                                 interpret=True))
    oracle = np.asarray(flash_softmax_matmul_ref(
        jq.astype(jnp.float32), jk.astype(jnp.float32), jnp.asarray(v)))
    got = tf.flash_softmax_matmul(_bf16(q), _bf16(k), torch.from_numpy(v))
    rounding = np.abs(jax_kernel - oracle).max()
    assert rounding > 0.02
    np.testing.assert_allclose(got.numpy(), jax_kernel, atol=1e-3, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_tolerance_holds_another_order_and_fails_planted_faults(case):
    """``bf16_tolerance`` (what the card's kernel is held to) admits the
    plain version with its scores summed in another order (the channels
    permuted), and refuses the output scaled by 0.98 and the last key
    tile left out of P . V."""
    b, lq, lk, c, d, mult, vscale, swin = CASES[case]
    q, k, v = (torch.from_numpy(x) for x in
               _inputs(5, b, lq, lk, c, d, mult, vscale))
    q, k = q.bfloat16(), k.bfloat16()
    ref = tf.flash_softmax_matmul_plain(q, k, v, swin=swin)
    perm = torch.from_numpy(np.random.default_rng(6).permutation(c))
    other = tf.flash_softmax_matmul_plain(q[..., perm], k[..., perm], v,
                                          scale=c ** -0.5, swin=swin)
    tol = tf.bf16_tolerance(q, k, v, swin=swin)
    assert float(((other - ref).abs() / tol).max()) <= 1.0
    v_cut = v.clone()
    v_cut[:, -tf.KERNEL_BLOCK_K:] = 0
    for fault in (ref * 0.98,
                  tf.flash_softmax_matmul_plain(q, k, v_cut, swin=swin)):
        assert float(((fault - ref).abs() / tol).max()) > 1.0


@pytest.mark.parametrize("swin", [None, (2, 4, 6, 2, 3)])
def test_lse_matches_jax(swin):
    """The LSE, f32 per row: to 1e-5 of the JAX kernel's (both add the Swin
    mask and take the running max the same way)."""
    b, l, c, d = (8, 24, 32, 16) if swin else (2, 160, 64, 2)
    q, k, v = _inputs(3, b, l, l, c, d)
    jout, jlse = _flash_forward(jnp.asarray(q, jnp.bfloat16),
                                jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(v), block_q=128, block_k=128,
                                interpret=True, swin=swin, with_lse=True)
    out, lse = tf.flash_softmax_matmul(_bf16(q), _bf16(k),
                                       torch.from_numpy(v), swin=swin,
                                       with_lse=True)
    assert lse.shape == (b, l) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-3)


@pytest.mark.parametrize("b,lq,lk,c,d", [(1, 256, 256, 64, 2),
                                         (2, 128, 384, 32, 128),
                                         (1, 200, 300, 64, 2)])
def test_f32_matches_dense_oracle(b, lq, lk, c, d):
    """f32 operands keep f32 (no bf16 rounding): the dense oracle to 1e-5."""
    q, k, v = _inputs(4, b, lq, lk, c, d)
    want = np.asarray(flash_softmax_matmul_ref(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v)))
    got = tf.flash_softmax_matmul(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h,w,k", [(8, 12, 2), (16, 24, 4), (16, 24, 8)])
def test_swin_mask_dense_matches_shift_window_attn_mask(h, w, k):
    """The dense mask of the kernel's analytic Swin rule equals the JAX
    ``shift_window_attn_mask`` tiled over the batch (`gmflow.py:298`), and
    the port's own ``shift_window_attn_mask`` equals the JAX one."""
    wh, ww = h // k, w // k
    jmask = np.asarray(shift_window_attn_mask(h, w, wh, ww, wh // 2,
                                              ww // 2))
    batch = 2 * k * k
    got = tf.swin_mask_dense(wh * ww, (k, wh, ww, wh // 2, ww // 2), batch)
    np.testing.assert_array_equal(got.numpy(), np.tile(jmask, (2, 1, 1)))
    np.testing.assert_array_equal(
        tg.shift_window_attn_mask(h, w, wh, ww, wh // 2, ww // 2).numpy(),
        jmask)


def test_swin_call_matches_dense_bias_jax():
    """The port's in-call Swin mask (plain version, f32) against the JAX
    oracle with the dense mask as a bias, on split windows."""
    rng = np.random.default_rng(5)
    h, w, k, c = 8, 12, 2, 32
    wh, ww = h // k, w // k
    x = rng.normal(size=(3, 2, h, w, c)).astype(np.float32)
    qs, ks, vs = (np.array(split_feature(jnp.asarray(t), k)).reshape(
        -1, wh * ww, c) for t in x)
    bias = np.tile(np.asarray(shift_window_attn_mask(h, w, wh, ww, wh // 2,
                                                     ww // 2)), (2, 1, 1))
    want = np.asarray(flash_softmax_matmul_ref(
        jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs),
        bias=jnp.asarray(bias)))
    got = tf.flash_softmax_matmul(torch.from_numpy(qs), torch.from_numpy(ks),
                                  torch.from_numpy(vs),
                                  swin=(k, wh, ww, wh // 2, ww // 2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_cpu_call_launches_nothing_and_checks_shapes():
    q = torch.randn(2, 24, 32)
    before = tf.flash_softmax_matmul.launches
    out = tf.flash_softmax_matmul(q, q, torch.randn(2, 24, 2))
    assert out.shape == (2, 24, 2)
    assert tf.flash_softmax_matmul.launches == before
    with pytest.raises(ValueError, match="q \\[B, Lq, C\\]"):
        tf.flash_softmax_matmul(q, q, torch.randn(2, 23, 2))
    with pytest.raises(ValueError, match="swin"):
        tf.flash_softmax_matmul(q, q, q, swin=(2, 4, 5, 2, 2))
