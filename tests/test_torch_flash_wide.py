"""The flash kernels past 256 channels on the CPU (``ops/flash.py``,
``ops/flash_bwd.py``), and GMFlow at 512 channels against the JAX model.

Past C or D = 256 the card takes the mma.sync route (bf16) and the
CUDA-core route (f32), whose blocks stage C in panels of 128 columns and
take D (dq: C; dk/dv: C and D) in chunks of 128 on a grid axis; the CPU
runs the same plain versions as at every other width. Here: the plain
forward against JAX's kernel in interpret mode at C in {272, 512} x D in
{2, 300, 512} (bf16 within ``bf16_tolerance`` row by row; f32 within
1e-5 of max|v| of JAX's dense oracle) and the plain backward against
JAX's backward kernels in interpret mode on the same residuals (within
``bwd_bf16_tolerance``), the Swin mask once each;
``GMFlow(feature_channels=512)`` against the JAX model with the same
weights (2 transformer blocks, 64x96), serving and one f32 training step
(``slow``), and its weights loaded strictly. The blocks those routes
launch at these widths (each within 227 KB of shared memory, the C
side's own plan) are checked on the card: ``test_torch_cuda.py``. Inputs
come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.ops.flash import (
    _flash_forward, flash_softmax_matmul, flash_softmax_matmul_ref)
from opticalflowfromdepth_tpu.ops.flash_bwd import flash_backward as jbwd
from opticalflowfromdepth_torch.models import gmflow as T
from opticalflowfromdepth_torch.ops import flash as tf
from opticalflowfromdepth_torch.ops import flash_bwd as tb
from opticalflowfromdepth_torch.weights import gmflow_state_dict_from_flax
# the 2-block JAX GMFlow and its images, and the training step's check, of
# the 256-channel tests
from test_torch_flash_widths import (
    H, RECIPE, W, _images, _jax_gmflow, _t, train_step_against_jax)

torch.set_num_threads(2)
SWIN = (2, 4, 6, 2, 3)       # [2B] windows of 4x6 tokens, shifted 2 and 3


def _inputs(seed, b, lq, lk, c, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, lq, c), (b, lk, c), (b, lk, d), (b, lq, d)))


def _case(c, d, swin):
    """(b, lq, lk) of a case: 40 queries over 150 keys, or with the Swin
    mask 8 windows of 24 tokens."""
    return (8, 24, 24) if swin else (1, 40, 150)


WIDE = [(c, d, None) for c in (272, 512) for d in (2, 300, 512)] + [
    (512, 512, SWIN)]


@pytest.mark.parametrize("c,d,swin", WIDE)
def test_forward_matches_jax_interpret_past_256(c, d, swin):
    """bf16 operands, key blocks of 128 on both sides: the port's CPU path
    against the TPU kernel in interpret mode within ``bf16_tolerance`` row
    by row; f32 against JAX's dense oracle (the Swin mask as its bias)
    within 1e-5 of max|v|."""
    b, lq, lk = _case(c, d, swin)
    q, k, v, _ = _inputs(c * 1000 + d, b, lq, lk, c, d)
    want = np.asarray(flash_softmax_matmul(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v), block_q=128, block_k=128, interpret=True,
        swin=swin))
    tq, tk = (_t(x).to(torch.bfloat16) for x in (q, k))
    got = tf.flash_softmax_matmul_plain(tq, tk, _t(v), swin=swin,
                                        block_k=128)
    assert got.shape == (b, lq, d)
    tol = tf.bf16_tolerance(tq, tk, _t(v), swin=swin).numpy()
    assert (np.abs(got.numpy() - want) / tol).max() <= 1.0
    bias = None if swin is None else \
        tf.swin_mask_dense(lk, swin, b).numpy()
    ref = np.asarray(flash_softmax_matmul_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias is None else jnp.asarray(bias)))
    f32 = tf.flash_softmax_matmul(_t(q), _t(k), _t(v), swin=swin)
    np.testing.assert_allclose(f32.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(v).max())


@pytest.mark.parametrize("c,d,swin", WIDE)
def test_backward_matches_jax_interpret_past_256(c, d, swin):
    """The same residuals on both sides (the TPU forward kernel's out and
    LSE on bf16 operands): the plain backward on bf16 q/k against the TPU
    backward kernels in interpret mode (blocks of 128), within
    ``bwd_bf16_tolerance`` row by row (dq) and key by key (dk, dv)."""
    b, lq, lk = _case(c, d, swin)
    q, k, v, g = _inputs(c * 1000 + d + 1, b, lq, lk, c, d)
    out, lse = (np.array(x) for x in _flash_forward(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v), block_q=128, block_k=128, interpret=True, swin=swin,
        with_lse=True))
    scale = c ** -0.5
    want = jbwd(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                jnp.asarray(v), jnp.asarray(out), jnp.asarray(lse),
                jnp.asarray(g), scale=scale, block_q=128, block_k=128,
                interpret=True, swin=swin)
    args = (_t(q).bfloat16(), _t(k).bfloat16(), _t(v), _t(out), _t(lse),
            _t(g), scale, swin)
    got = tb.flash_backward_plain(*args)
    tols = tb.bwd_bf16_tolerance(*args)
    for name, x, w, tol in zip(("dq", "dk", "dv"), got, want, tols):
        w = np.asarray(w, np.float32)
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        assert (np.abs(x.numpy() - w) / tol.numpy()).max() <= 1.0, name


# ---------------------------------------------------------------------------
# GMFlow at 512 channels
# ---------------------------------------------------------------------------

def test_weights_of_a_512_channel_tree_load_strictly():
    """``gmflow_state_dict_from_flax`` takes every width from the tree: a
    2-block, 512-channel flax tree loads into the port's model with
    ``strict=True``, every tensor at its shape."""
    _, v = _jax_gmflow(512)
    sd = gmflow_state_dict_from_flax(v["params"])
    model = T.GMFlow(feature_channels=512, num_transformer_layers=2)
    model.load_state_dict(sd, strict=True)
    assert sd["backbone.conv2.weight"].shape == (512, 128, 1, 1)
    assert sd["transformer.layers.1.cross_attn_ffn.mlp.0.weight"].shape == \
        (4096, 1024)
    assert sd["feature_flow_attn.q_proj.weight"].shape == (512, 512)


@pytest.mark.parametrize("training", [False, True])
def test_gmflow_512_matches_jax(training):
    """f32, 1 scale, the same weights: every prediction within the 2e-2 px
    of the 128- and 256-channel tests. The flash calls are C = 512 wide
    (the windows' values D = 512 too): on the card the mma.sync (bf16) and
    CUDA-core (f32) routes (``chip_smoke.py`` [23] holds card against
    CPU)."""
    model, v = _jax_gmflow(512)
    i1, i2 = _images(2)
    want = model.apply(v, jnp.asarray(i1), jnp.asarray(i2),
                       attn_splits_list=RECIPE[0],
                       corr_radius_list=RECIPE[1],
                       prop_radius_list=RECIPE[2],
                       training=training)["flow_preds"]
    port = T.GMFlow(feature_channels=512, num_transformer_layers=2)
    port.load_state_dict(gmflow_state_dict_from_flax(v["params"]),
                         strict=True)
    with torch.no_grad():
        got = port.eval()(_t(i1).permute(0, 3, 1, 2),
                          _t(i2).permute(0, 3, 1, 2), *RECIPE,
                          training=training)["flow_preds"]
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        g_ = g_.permute(0, 2, 3, 1).numpy()
        assert g_.shape == (1, H, W, 2)
        assert np.abs(g_ - np.asarray(w_)).max() <= 2e-2


@pytest.mark.slow
def test_gmflow_512_train_step_matches_jax():
    """One f32 training step of the 512-channel, 2-block model (64x96,
    batch 2, classifier on) against JAX's ``make_train_step`` from the
    same weights, with the 256-channel test's checks (metrics 1e-4
    relative, raw gradients 2e-4 of the global norm, 1e-3 for the first
    conv, Adam's moments, the parameters)."""
    train_step_against_jax(512)
