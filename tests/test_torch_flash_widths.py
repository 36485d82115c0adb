"""The flash kernels' widths (``ops/flash.py``, ``ops/flash_bwd.py``) on the
CPU, and GMFlow at 256 channels against the JAX model.

The kernels take C and D from 1 to ``MAX_WIDTH``: ``pad_widths`` appends
zero columns to the widths their tiles need (C to a multiple of 16, D to
2 or a multiple of 16) and the results are sliced back. Here: the port's
CPU path against JAX's kernel in interpret mode at C in {1, 24, 200, 256}
x D in {1, 3, 130, 256}; the padding against the unpadded call (forward
and gradients); the forward's and the backward's ``plan`` for every C, D
in 1..256 and in steps to 1024 (route, padded widths, the tf32x3 and
wgmma blocks' shared memory; the blocks the C side launches at each
width are checked on the card, ``test_torch_cuda.py``); the zero widths
and those past
``MAX_WIDTH`` raising; ``GMFlow(feature_channels=256)`` against the JAX
model with the same weights through ``gmflow_state_dict_from_flax`` (2
transformer blocks, 64x96), and one training step of it (``slow``). The
widths past 256 and GMFlow at 512 channels: ``test_torch_flash_wide.py``.
Inputs come from numpy seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflowfromdepth_tpu.models.gmflow as J
from opticalflowfromdepth_tpu.ops.flash import (
    flash_softmax_matmul, flash_softmax_matmul_ref)
from opticalflowfromdepth_torch.models import gmflow as T
from opticalflowfromdepth_torch.ops import flash as tf
from opticalflowfromdepth_torch.ops import flash_bwd as tb
from opticalflowfromdepth_torch.weights import gmflow_state_dict_from_flax

torch.set_num_threads(2)
SMEM_BLOCK = 232448          # shared memory a block may take, 227 KB


def _inputs(seed, b, lq, lk, c, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, lq, c), (b, lk, c), (b, lk, d), (b, lq, d)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("d", [1, 3, 130, 256])
@pytest.mark.parametrize("c", [1, 24, 200, 256])
def test_cpu_path_matches_jax_interpret_at_width(c, d):
    """bf16 operands, key blocks of 128 on both sides: the port's CPU path
    against the TPU kernel in interpret mode (which pads D to 128 lanes)
    within ``bf16_tolerance`` row by row; f32 against JAX's dense oracle
    within 1e-5 of max|v|."""
    q, k, v, _ = _inputs(c * 1000 + d, 1, 40, 150, c, d)
    want = np.asarray(flash_softmax_matmul(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v), block_q=128, block_k=128, interpret=True))
    tq, tk = (_t(x).to(torch.bfloat16) for x in (q, k))
    got = tf.flash_softmax_matmul_plain(tq, tk, _t(v), block_k=128)
    assert got.shape == (1, 40, d)
    tol = tf.bf16_tolerance(tq, tk, _t(v)).numpy()
    assert (np.abs(got.numpy() - want) / tol).max() <= 1.0
    ref = np.asarray(flash_softmax_matmul_ref(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v)))
    f32 = tf.flash_softmax_matmul(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(f32.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(v).max())


@pytest.mark.parametrize("c,d,want", [
    (1, 1, (16, 2)), (2, 2, (16, 2)), (16, 3, (16, 16)), (17, 16, (32, 16)),
    (100, 130, (112, 144)), (128, 128, (128, 128)), (200, 256, (208, 256)),
    (256, 255, (256, 256))])
def test_padded_widths(c, d, want):
    assert tf.padded_widths(c, d) == want


@pytest.mark.parametrize("c,d", [(0, 4), (4, 0), (257, 4), (4, 257)])
def test_widths_past_the_limit_raise(c, d):
    """Below 1 the widths raise, naming the limit, and so do both plans;
    past 256 they plan (bf16 on the mma.sync route, f32 on the CUDA-core
    route, forward and backward; those blocks' shared memory is the C
    side's, held within 227 KB on the card by ``test_torch_cuda.py``'s
    ``test_flash_kernel_plans_at_every_width``); padded past
    ``MAX_WIDTH`` (65,535 chunks of 128 columns on the grid's z axis)
    they raise again, naming it."""
    fns = (tf.padded_widths, lambda c_, d_: tf.plan(1, 8, 8, c_, d_),
           lambda c_, d_: tb.plan(1, 8, 8, c_, d_))
    if min(c, d) < 1:
        for fn in fns:
            with pytest.raises(ValueError, match="from 1 to 8388480"):
                fn(c, d)
        return
    for dtype, route in ((torch.bfloat16, "mma_sync"),
                         (torch.float32, "f32")):
        f = tf.plan(1, 8, 8, c, d, dtype)
        b = tb.plan(1, 8, 8, c, d, dtype)
        assert f.route == b.route == route
        assert (f.c_pad, f.d_pad) == (b.c_pad, b.d_pad) == \
            tf.padded_widths(c, d)
    past = (tf.MAX_WIDTH + 1, d) if c > d else (c, tf.MAX_WIDTH + 1)
    assert tf.MAX_WIDTH == 65535 * 128
    for fn in fns:
        with pytest.raises(ValueError, match="65535 chunks"):
            fn(*past)


@pytest.mark.parametrize("c,d", [(1, 1), (24, 3), (100, 130), (200, 256)])
def test_padding_keeps_the_function_and_its_gradients(c, d):
    """The plain forward on zero-padded q, k, v with the unpadded C's scale
    equals the unpadded call (out and LSE within 1e-6, f32), its real
    columns sliced back; the plain backward on padded operands, sliced
    back, equals the unpadded one within 1e-6; gradients through
    ``pad_widths`` come back at the unpadded shapes, the same values."""
    q, k, v, g = _inputs(7, 2, 50, 70, c, d)
    tq, tk, tv, tg = (_t(x) for x in (q, k, v, g))
    qp, kp, vp = tf.pad_widths(tq, tk, tv)
    cp, dp = tf.padded_widths(c, d)
    assert qp.shape[2] == kp.shape[2] == cp and vp.shape[2] == dp
    assert not qp[..., c:].any() and not vp[..., d:].any()
    scale = c ** -0.5
    out, lse = tf.flash_softmax_matmul_plain(tq, tk, tv, with_lse=True)
    pout, plse = tf.flash_softmax_matmul_plain(qp, kp, vp, scale,
                                               with_lse=True)
    np.testing.assert_allclose(pout[..., :d].numpy(), out.numpy(), rtol=0,
                               atol=1e-6)
    assert not pout[..., d:].any()
    np.testing.assert_allclose(plse.numpy(), lse.numpy(), rtol=0, atol=1e-6)
    gp = tf._pad_last(tg, dp)
    full = tb.flash_backward_plain(qp, kp, vp, pout, plse, gp, scale)
    want = tb.flash_backward_plain(tq, tk, tv, out, lse, tg)
    for x, w, n in zip(full, want, (c, c, d)):
        np.testing.assert_allclose(x[..., :n].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6)
    rq, rk, rv = (x.clone().requires_grad_() for x in (tq, tk, tv))
    pq, pk, pv = tf.pad_widths(rq, rk, rv)
    grads = torch.autograd.grad(
        tf.flash_softmax_matmul(pq, pk, pv, scale)[..., :d], (rq, rk, rv), tg)
    for x, w, shape in zip(grads, want, (q.shape, k.shape, v.shape)):
        assert tuple(x.shape) == shape
        np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0, atol=1e-6)


# every width to 256; past it to 1024 in steps, with the padded edges
WIDTHS = sorted(set(range(1, 257)) | set(range(257, 1025, 29))
                | {272, 384, 511, 512, 513, 600, 1000, 1008, 1009, 1024})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plans_at_every_width(dtype):
    """Every C, D in 1..256, and past it to 1024 in steps: the forward's
    route and the backward's (bf16 at widths that pad to C = 128 and D = 2
    or 128, or to C = 256 and D = 2 or 256, the wgmma route, else
    mma.sync; f32 at C = 128 and D = 2 or 128 tf32x3, else the CUDA
    cores) and the padded widths; the tf32x3 blocks (whose shared memory
    sets the split) and the forward's wgmma blocks within 227 KB (the
    mma.sync and CUDA-core blocks are the C side's, checked on the
    card)."""
    bf16 = dtype == torch.bfloat16
    for c in WIDTHS:
        for d in (WIDTHS if c <= 256 else WIDTHS[::7] + [1024]):
            cp, dp = tf.padded_widths(c, d)
            fast = cp == 128 and dp in (2, 128)
            wide = cp == 256 and dp in (2, 256)
            f = tf.plan(4, 300, 300, c, d, dtype)
            b = tb.plan(4, 300, 300, c, d, dtype)
            want = (("wgmma" if fast or wide else "mma_sync") if bf16
                    else ("tf32x3" if fast else "f32"))
            assert f.route == want, (c, d)
            assert b.route == want, (c, d)
            assert (f.c_pad, f.d_pad, b.c_pad, b.d_pad) == (cp, dp, cp, dp)
            if want == "wgmma":
                assert 0 < f.smem <= SMEM_BLOCK, (c, d)
            if want == "tf32x3":
                assert 0 < f.smem <= SMEM_BLOCK, (c, d)
                assert 0 < max(b.smem) <= SMEM_BLOCK, (c, d)


# ---------------------------------------------------------------------------
# GMFlow at 256 channels
# ---------------------------------------------------------------------------

H, W = 64, 96
RECIPE = ((2,), (-1,), (-1,))


def _images(seed=0, b=1):
    """Smooth images (bilinear upsampled 8x12 noise) in [0, 255]."""
    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.uniform(0, 255, (2 * b, 3, 8, 12)).astype(
        np.float32))
    img = torch.nn.functional.interpolate(
        low, size=(H, W), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    return np.ascontiguousarray(img[:b]), np.ascontiguousarray(img[b:])


@functools.lru_cache(maxsize=None)
def _jax_gmflow(channels: int):
    """The JAX GMFlow at ``feature_channels=channels``, 2 transformer
    blocks, and its seeded variables (numpy)."""
    model = J.GMFlow(feature_channels=channels, num_transformer_layers=2)
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    v = jax.jit(functools.partial(
        model.init, attn_splits_list=RECIPE[0], corr_radius_list=RECIPE[1],
        prop_radius_list=RECIPE[2]))(jax.random.PRNGKey(5), dummy, dummy)
    return model, jax.tree_util.tree_map(np.asarray, v)


def test_weights_of_a_256_channel_tree_load_strictly():
    """``gmflow_state_dict_from_flax`` takes the block count and every
    width from the tree: a 2-block, 256-channel flax tree loads into the
    port's model with ``strict=True``, every tensor at its shape."""
    _, v = _jax_gmflow(256)
    sd = gmflow_state_dict_from_flax(v["params"])
    model = T.GMFlow(feature_channels=256, num_transformer_layers=2)
    model.load_state_dict(sd, strict=True)
    assert sd["backbone.conv2.weight"].shape == (256, 128, 1, 1)
    assert sd["transformer.layers.1.cross_attn_ffn.mlp.0.weight"].shape == \
        (2048, 512)
    assert sd["feature_flow_attn.q_proj.weight"].shape == (256, 256)


@pytest.mark.parametrize("training", [False, True])
def test_gmflow_256_matches_jax(training):
    """f32, 1 scale, the same weights: every prediction within the 2e-2 px
    of the 128-channel test (``test_torch_gmflow.py``). The flash calls
    are C = 256 wide (the windows' values D = 256 too); on the CPU both
    sides run them densely, on the card the port takes the CUDA-core
    route (``chip_smoke.py`` [20] holds card against CPU)."""
    model, v = _jax_gmflow(256)
    i1, i2 = _images(1)
    want = model.apply(v, jnp.asarray(i1), jnp.asarray(i2),
                       attn_splits_list=RECIPE[0],
                       corr_radius_list=RECIPE[1],
                       prop_radius_list=RECIPE[2],
                       training=training)["flow_preds"]
    port = T.GMFlow(feature_channels=256, num_transformer_layers=2)
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
def test_gmflow_256_train_step_matches_jax():
    """One f32 training step of the 256-channel, 2-block model (64x96,
    batch 2, classifier on) against JAX's ``make_train_step`` from the
    same weights: the checks of ``test_torch_gmflow_train.py``'s step
    (metrics 1e-4 relative, raw gradients 2e-4 of the global norm, 1e-3
    for the first conv, Adam's moments, the parameters)."""
    train_step_against_jax(256)


def train_step_against_jax(channels: int) -> None:
    """One f32 training step of the 2-block GMFlow at ``feature_channels
    = channels`` (64x96, batch 2, classifier on) on the CPU against JAX's
    ``make_train_step`` from the same weights, held by
    ``test_torch_gmflow_train.py``'s ``_check_step``."""
    import optax
    from test_torch_gmflow_train import (
        CFG, _batch, _check_step, _classifier)
    from test_torch_train import _adam, _np_tree, _recorder

    from opticalflowfromdepth_torch.data.loader import to_device
    from opticalflowfromdepth_torch.train import gmflow_train as tgt
    from opticalflowfromdepth_tpu.models.classifier import \
        Classifier as JCls
    from opticalflowfromdepth_tpu.tools.port_torch_weights import (
        port_classifier, to_variables)
    from opticalflowfromdepth_tpu.train import gmflow_train as jgt
    from opticalflowfromdepth_tpu.train import optim as joptim
    from opticalflowfromdepth_tpu.train.state import create_train_state

    extra = dict(feature_channels=channels, num_transformer_layers=2)
    jcfg = jgt.GMFlowTrainConfig(**CFG, **extra)
    tcfg = tgt.GMFlowTrainConfig(**CFG, **extra)
    jmodel = jgt.build_model(jcfg)
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = _np_tree(jax.jit(functools.partial(
        jmodel.init, attn_splits_list=jcfg.attn_splits_list,
        corr_radius_list=jcfg.corr_radius_list,
        prop_radius_list=jcfg.prop_radius_list))(
            jax.random.PRNGKey(6), dummy, dummy))
    cls = _classifier()
    cparams, cstats = port_classifier(cls.state_dict())
    tx = optax.chain(_recorder(), joptim.make_optimizer(
        jcfg.lr, jcfg.num_steps, jcfg.wdecay, clip=jcfg.grad_clip,
        anneal_strategy="cos"))
    jstate = create_train_state(jmodel, {"params": variables["params"]}, tx)
    jstep = jax.jit(jgt.make_train_step(jcfg, to_variables(cparams, cstats),
                                        JCls()))
    tstate = tgt.init_state(tcfg, seed=0, device="cpu")
    tstate.model.load_state_dict(
        gmflow_state_dict_from_flax(variables["params"]), strict=True)
    tstep = tgt.make_train_step(tcfg, cls, device="cpu")
    raw = {}
    adam_step = tstate.optimizer.step

    def step_keeping_grads():
        raw.update({k: p.grad.clone()
                    for k, p in tstate.model.named_parameters()})
        return adam_step()
    tstate.optimizer.step = step_keeping_grads

    def to_port(tree):
        return gmflow_state_dict_from_flax(_np_tree(tree))

    batch = _batch(np.random.default_rng(0))
    jstate, jm = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()},
                       jax.random.PRNGKey(0))
    adam = _adam(jstate.opt_state)
    ref = {"metrics": {k: float(x) for k, x in jm.items()},
           "grads": to_port(jstate.opt_state[0]), "mu": to_port(adam.mu),
           "nu": to_port(adam.nu), "state": to_port(jstate.params),
           "step": int(jstate.step),
           "pixels": int((batch["valid"] >= 0.5).sum())}
    tstate, tm = tstep(tstate, to_device(batch, "cpu"))
    adamw = tstate.optimizer.adamw.state
    named = dict(tstate.model.named_parameters())
    got = {"metrics": {k: float(x) for k, x in tm.items()},
           "grads": dict(raw),
           "mu": {k: adamw[p]["exp_avg"].clone() for k, p in named.items()},
           "nu": {k: adamw[p]["exp_avg_sq"].clone()
                  for k, p in named.items()},
           "state": {k: x.clone()
                     for k, x in tstate.model.state_dict().items()},
           "step": tstate.step}
    _check_step(ref, got)
