"""The port's RAFT and classifier on the CPU against the JAX ones, same
weights, in evaluation and in training mode.

JAX variables are made by ``RAFT.init`` (batch statistics perturbed away
from 0/1), carried into the port by ``raft_state_dict_from_flax`` and
loaded with ``strict=True``. Both sides run in f32 on the same seeded
inputs; the tolerance is the RAFT one of ``tests/test_torch_parity.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from opticalflowfromdepth_tpu.models.classifier import Classifier as JCls
from opticalflowfromdepth_tpu.models.raft import RAFT as JRAFT
from opticalflowfromdepth_tpu.tools.port_torch_weights import (
    port_classifier, port_raft)
from opticalflowfromdepth_torch.models.classifier import Classifier as TCls
from opticalflowfromdepth_torch.models.layers import BasicEncoder
from opticalflowfromdepth_torch.models.raft import RAFT as TRAFT
from opticalflowfromdepth_torch.weights import (
    classifier_state_dict_from_flax, raft_state_dict_from_flax)

torch.set_num_threads(2)
H, W, ITERS = 64, 96, 3
ATOL = 2e-4                     # px, `tests/test_torch_parity.py:230`


@functools.lru_cache(maxsize=None)
def _variables(small: bool):
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    v = jax.jit(functools.partial(JRAFT(small=small).init, iters=1,
                                  train=False))(jax.random.PRNGKey(7),
                                                dummy, dummy)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(11)
    # The reference initializes only its encoders He-normal; the update
    # block keeps torch's default U(+-1/sqrt(fan_in)). Flax's He-normal
    # update block makes every GRU step move the flow by tens of pixels,
    # which amplifies f32 rounding far past any parity tolerance.
    flat = traverse_util.flatten_dict(v["params"])
    for k, a in flat.items():
        if k[0] == "update_block":
            shape = flat[k[:-1] + ("kernel",)].shape
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            flat[k] = rng.uniform(-bound, bound, a.shape).astype(np.float32)
    v = dict(v, params=traverse_util.unflatten_dict(flat))
    if "batch_stats" in v:
        flat = traverse_util.flatten_dict(v["batch_stats"])
        for k, a in flat.items():
            flat[k] = (rng.normal(0, 0.1, a.shape) if k[-1] == "mean"
                       else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        v = dict(v, batch_stats=traverse_util.unflatten_dict(flat))
    return v


def _images(seed=0, b=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32)
            for _ in range(2)]


def _port(small: bool, corr_impl: str) -> TRAFT:
    v = _variables(small)
    model = TRAFT(small=small, corr_impl=corr_impl)
    model.load_state_dict(raft_state_dict_from_flax(
        v["params"], v.get("batch_stats"), small), strict=True)
    return model.eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, ref, what):
    diff = float(np.max(np.abs(got - np.asarray(ref))))
    assert diff < ATOL, f"{what}: max abs diff {diff:.2e} >= {ATOL:g}"


@pytest.mark.parametrize("small", [False, True])
def test_state_dict_round_trip_is_a_bijection(small):
    v = _variables(small)
    sd = raft_state_dict_from_flax(v["params"], v.get("batch_stats"), small)
    TRAFT(small=small).load_state_dict(sd, strict=True)
    params, stats = port_raft(sd, small=small)
    want_p = traverse_util.flatten_dict(v["params"])
    want_s = traverse_util.flatten_dict(v.get("batch_stats", {}))
    assert set(params) == set(want_p) and set(stats) == set(want_s)
    for got, want in ((params, want_p), (stats, want_s)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    if not small:   # the perturbed running stats really were carried
        assert not np.allclose(sd["cnet.norm1.running_var"].numpy(), 1.0)


@pytest.mark.parametrize("corr_impl", ["fused", "pyramid"])
@pytest.mark.parametrize("small", [False, True])
def test_raft_test_mode_matches_jax(small, corr_impl):
    i1, i2 = _images()
    v = _variables(small)
    jmodel = JRAFT(small=small, corr_impl=corr_impl)
    ref_lr, ref_up = jax.jit(functools.partial(
        jmodel.apply, iters=ITERS, test_mode=True, train=False))(
            v, jnp.asarray(i1), jnp.asarray(i2))
    with torch.inference_mode():
        lr, up = _port(small, corr_impl)(_nchw(i1), _nchw(i2), iters=ITERS,
                                         test_mode=True)
    assert lr.dtype == up.dtype == torch.float32
    _close(_nhwc(lr), ref_lr, "flow_lr")
    _close(_nhwc(up), ref_up, "flow_up")


def test_raft_alternate_corr_matches_jax():
    i1, i2 = _images(seed=2)
    v = _variables(False)
    ref_lr, _ = jax.jit(functools.partial(
        JRAFT(alternate_corr=True).apply, iters=2, test_mode=True,
        train=False))(v, jnp.asarray(i1), jnp.asarray(i2))
    with torch.inference_mode():
        lr, _ = _port(False, "alternate")(_nchw(i1), _nchw(i2), iters=2,
                                          test_mode=True)
    _close(_nhwc(lr), ref_lr, "alternate flow_lr")


def test_raft_flow_init_warm_start_matches_jax():
    i1, i2 = _images(seed=3)
    rng = np.random.default_rng(5)
    init = rng.normal(0, 2, (1, H // 8, W // 8, 2)).astype(np.float32)
    v = _variables(False)
    ref_lr, ref_up = jax.jit(functools.partial(
        JRAFT(corr_impl="fused").apply, iters=2, test_mode=True,
        train=False))(v, jnp.asarray(i1), jnp.asarray(i2),
                      flow_init=jnp.asarray(init))
    with torch.inference_mode():
        lr, up = _port(False, "fused")(_nchw(i1), _nchw(i2), iters=2,
                                       flow_init=_nchw(init),
                                       test_mode=True)
    _close(_nhwc(lr), ref_lr, "warm flow_lr")
    _close(_nhwc(up), ref_up, "warm flow_up")


@pytest.mark.parametrize("small", [False, True])
def test_raft_per_iteration_flows_match_jax(small):
    i1, i2 = _images(seed=4)
    v = _variables(small)
    refs = jax.jit(functools.partial(
        JRAFT(small=small, corr_impl="fused").apply, iters=ITERS,
        test_mode=False, train=False))(v, jnp.asarray(i1), jnp.asarray(i2))
    with torch.inference_mode():
        got = _port(small, "fused")(_nchw(i1), _nchw(i2), iters=ITERS)
    assert len(got) == len(refs) == ITERS
    for i, (g, r) in enumerate(zip(got, refs)):
        _close(_nhwc(g), r, f"pred[{i}]")


# --------------------------------------------------------------------------
# training mode and the classifier
# --------------------------------------------------------------------------

def test_raft_train_mode_and_batch_stats_match_jax():
    """train=True: batch statistics in the context encoder (and their
    running update with flax's momentum and biased variance)."""
    i1, i2 = _images(seed=6, b=2)
    v = _variables(False)
    refs, new_state = jax.jit(functools.partial(
        JRAFT(corr_impl="fused").apply, iters=ITERS, train=True,
        mutable=["batch_stats"]))(v, jnp.asarray(i1), jnp.asarray(i2))
    model = _port(False, "fused")
    got = model(_nchw(i1), _nchw(i2), iters=ITERS, train=True)
    assert len(got) == len(refs) == ITERS
    for i, (g, r) in enumerate(zip(got, refs)):
        _close(_nhwc(g), r, f"train pred[{i}]")
    want = raft_state_dict_from_flax(v["params"], new_state["batch_stats"])
    sd = model.state_dict()
    stats = [k for k in sd if "running" in k]
    assert stats
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert not np.allclose(sd["cnet.norm1.running_var"].numpy(),
                           _port(False, "fused").state_dict()[
                               "cnet.norm1.running_var"].numpy())


def test_encoder_dropout_draws_from_the_generator():
    enc = BasicEncoder(32, "instance", dropout=0.5)
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain = enc(x)
        a, b = (enc(x, True, torch.Generator().manual_seed(1))
                for _ in range(2))
    assert torch.equal(a, b)                   # same seed, same mask
    zero = a == 0
    assert 0.3 < zero.float().mean() < 0.7
    torch.testing.assert_close(a[~zero], 2 * plain[~zero])
    with pytest.raises(ValueError, match="Generator"):
        enc(x, True)


@functools.lru_cache(maxsize=None)
def _cls_variables(dropout_in_head: bool):
    model = JCls(dropout=0.0, use_dropout_in_classify=dropout_in_head)
    v = jax.jit(functools.partial(model.init, train=False))(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 48, 2), jnp.float32))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(12)
    flat = traverse_util.flatten_dict(v["batch_stats"])
    for k, a in flat.items():
        flat[k] = (rng.normal(0, 0.1, a.shape) if k[-1] == "mean"
                   else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    return dict(v, batch_stats=traverse_util.unflatten_dict(flat))


@pytest.mark.parametrize("dropout_in_head", [False, True])
def test_classifier_state_dict_round_trip_is_a_bijection(dropout_in_head):
    v = _cls_variables(dropout_in_head)
    sd = classifier_state_dict_from_flax(
        v["params"], v["batch_stats"],
        use_dropout_in_classify=dropout_in_head)
    TCls(use_dropout_in_classify=dropout_in_head).load_state_dict(
        sd, strict=True)
    assert f"classify.{4 if dropout_in_head else 3}.weight" in sd
    params, stats = port_classifier(
        sd, use_dropout_in_classify=dropout_in_head)
    for got, want in ((params, v["params"]), (stats, v["batch_stats"])):
        want = traverse_util.flatten_dict(want)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("train", [False, True])
def test_classifier_matches_jax(train):
    """Logits (and, in training, the BatchNorm running statistics) on a
    flow map; dropout 0 so both sides draw nothing."""
    v = _cls_variables(False)
    flow = np.random.default_rng(13).normal(0, 4, (2, 32, 48, 2)).astype(
        np.float32)
    jm = JCls(dropout=0.0)
    model = TCls(dropout=0.0)
    model.load_state_dict(classifier_state_dict_from_flax(
        v["params"], v["batch_stats"]), strict=True)
    got = model(_nchw(flow), train=train)
    if train:
        ref, new = jm.apply(v, jnp.asarray(flow), train=True,
                            mutable=["batch_stats"])
        want = classifier_state_dict_from_flax(v["params"],
                                               new["batch_stats"])
        for k, t in model.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(t.numpy(), want[k].numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=k)
    else:
        ref = jm.apply(v, jnp.asarray(flow), train=False)
    assert got.shape == (2, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)


def test_remat_full_gives_the_same_flows_and_gradients():
    """remat="full" recomputes each GRU iteration in the backward: the
    flows and every gradient equal those without it. "dots" and
    blocked supervision are not ported and raise."""
    i1, i2 = (_nchw(x) for x in _images(seed=7, b=2))
    sd = _port(False, "fused").state_dict()
    out = []
    for remat in ("none", "full"):
        model = TRAFT(corr_impl="fused", remat=remat)
        model.load_state_dict(sd)
        flows = model(i1, i2, iters=2, train=True)
        sum(f.abs().mean() for f in flows).backward()
        out.append(([f.detach() for f in flows],
                    {n: p.grad for n, p in model.named_parameters()}))
    for a, b in zip(out[0][0], out[1][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for n, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][n], g, rtol=1e-5, atol=1e-7,
                                   msg=n)
    with pytest.raises(ValueError, match="dots"):
        TRAFT(remat="dots")
    from opticalflowfromdepth_torch.train.raft_train import (RAFTTrainConfig,
                                                             build_model)
    with pytest.raises(ValueError, match="blocked_supervision"):
        build_model(RAFTTrainConfig(blocked_supervision=True))
