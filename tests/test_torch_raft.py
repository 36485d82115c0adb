"""The port's RAFT on the CPU against the JAX RAFT, same weights.

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

from opticalflowfromdepth_tpu.models.raft import RAFT as JRAFT
from opticalflowfromdepth_tpu.tools.port_torch_weights import port_raft
from opticalflowfromdepth_torch.models.raft import RAFT as TRAFT
from opticalflowfromdepth_torch.weights import raft_state_dict_from_flax

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
