"""RAFT's scheduling options in the port on the CPU: ``remat``, ``unroll``
and ``blocked_supervision`` (``models/raft.py``, ``train/raft_train.py``).

In the JAX package they change the schedule or the layout, not the
numbers, and so in the port: each option's train step against JAX's step
with the same option, after one and two steps, at
``tests/test_torch_train.py``'s tolerances; "dots" and every ``unroll``
bit for bit equal to the defaults in the port, with the lookup run once
forward and once backward an iteration under "dots" (twice forward under
"full"); ``block_pixels`` / ``unblock_pixels`` and the blocked loss
against JAX's. Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.models import raft as jraft
from opticalflowfromdepth_tpu.train import loss as jloss
from opticalflowfromdepth_torch.data.loader import to_device
from opticalflowfromdepth_torch.models import raft as traft
from opticalflowfromdepth_torch.ops import fused_corr as fc
from opticalflowfromdepth_torch.train import loss as tloss
from opticalflowfromdepth_torch.train import raft_train as trt
from test_torch_train import CFG, _batch, check_step_against_jax

torch.set_num_threads(2)
ITERS = 3


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("option", [(("remat", "dots"),), (("unroll", 0),),
                                    (("blocked_supervision", True),)],
                         ids=["remat_dots", "unroll_0", "blocked"])
def test_option_step_matches_jax(option, n):
    """The port's step with the option against JAX's with the same one:
    the metrics 1e-4 relative, the raw gradients, Adam's moments, the
    parameters and the BatchNorm statistics (``test_torch_train.py``)."""
    check_step_against_jax(n, option)


def _images(seed, b=2, h=64, w=96):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(0, 255, (b, 3, h, w)).astype(
        np.float32)) for _ in range(2)]


def _flows_and_grads(option, state_dict, counts=None):
    """Per-iteration flows and every gradient of one training forward and
    backward with ``option``; ``counts`` records the plain lookup's calls
    (forward) and its backward's."""
    model = traft.RAFT(corr_impl="fused", **option)
    model.load_state_dict(state_dict)
    i1, i2 = _images(5)
    flows = model(i1, i2, iters=ITERS, train=True)
    if counts is not None:
        counts["forward_at_loss"] = counts["forward"]
    sum(f.float().abs().mean() for f in flows).backward()
    return ([f.detach() for f in flows],
            {n: p.grad.clone() for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def defaults():
    sd = traft.RAFT(corr_impl="fused",
                    generator=torch.Generator().manual_seed(2)).state_dict()
    return sd, _flows_and_grads({}, sd)


@pytest.mark.parametrize("option", [dict(remat="dots"), dict(unroll=0),
                                    dict(unroll=2), dict(unroll=12)],
                         ids=["remat_dots", "unroll_0", "unroll_2",
                              "unroll_12"])
def test_option_equals_the_default_bit_for_bit(defaults, option):
    sd, (flows0, grads0) = defaults
    flows, grads = _flows_and_grads(option, sd)
    assert all(torch.equal(a, b) for a, b in zip(flows, flows0))
    assert grads.keys() == grads0.keys()
    for k, g in grads0.items():
        assert torch.equal(grads[k], g), k


@pytest.mark.parametrize("remat,forward", [("none", ITERS),
                                           ("dots", ITERS),
                                           ("full", 2 * ITERS)])
def test_lookup_runs_once_an_iteration_under_dots(monkeypatch, defaults,
                                                   remat, forward):
    """The selective policy keeps the lookup's output: under "dots" it runs
    ``iters`` times forward and ``iters`` backward, none again in the
    backward; "full" recomputes it."""
    counts = {"forward": 0, "backward": 0}
    plain, plain_bwd = (fc.fused_corr_lookup_cat_plain,
                        fc.fused_corr_lookup_cat_bwd_plain)

    def fwd(*a, **k):
        counts["forward"] += 1
        return plain(*a, **k)

    def bwd(*a, **k):
        counts["backward"] += 1
        return plain_bwd(*a, **k)
    monkeypatch.setattr(fc, "fused_corr_lookup_cat_plain", fwd)
    monkeypatch.setattr(fc, "fused_corr_lookup_cat_bwd_plain", bwd)
    _flows_and_grads(dict(remat=remat), defaults[0], counts)
    assert counts["forward_at_loss"] == ITERS
    assert counts == {"forward": forward, "backward": ITERS,
                      "forward_at_loss": ITERS}


def test_options_are_checked():
    for bad in (dict(remat="some"), dict(unroll=-1), dict(unroll=1.5)):
        with pytest.raises(ValueError):
            traft.RAFT(**bad)
    with pytest.raises(ValueError, match="unroll"):
        trt.build_model(trt.RAFTTrainConfig(**dict(CFG, unroll=-2)))
    model = trt.build_model(trt.RAFTTrainConfig(**dict(
        CFG, unroll=0, remat="dots", blocked_supervision=True)))
    assert (model.unroll, model.remat, model.blocked_supervision) == (
        CFG["iters"], "dots", True)
    small = trt.build_model(trt.RAFTTrainConfig(**dict(
        CFG, small=True, blocked_supervision=True)))
    assert not small.blocked_supervision       # the basic model only


@pytest.mark.parametrize("shape,factor", [((2, 16, 24, 2), 8),
                                          ((2, 16, 24), 8),
                                          ((1, 12, 20, 3), 4)])
def test_block_pixels_matches_jax(shape, factor):
    """The port's blocked layout is JAX's with its axes in the order (0,
    ndim - 2, ndim - 1, 1, 2): flows [B, f*f, C, h, w], maps [B, f*f, h,
    w]; unblocking gives the image back."""
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    ref = np.asarray(jraft.block_pixels(jnp.asarray(x), factor))
    if x.ndim == 4:                      # NHWC -> NCHW
        got = traft.block_pixels(torch.from_numpy(
            x.transpose(0, 3, 1, 2).copy()), factor)
        np.testing.assert_array_equal(got.numpy(),
                                      ref.transpose(0, 3, 4, 1, 2))
        np.testing.assert_array_equal(
            traft.unblock_pixels(got, factor).numpy(), x.transpose(0, 3, 1, 2))
    else:
        got = traft.block_pixels(torch.from_numpy(x), factor)
        np.testing.assert_array_equal(got.numpy(), ref.transpose(0, 3, 1, 2))


def test_blocked_flows_unblock_to_the_default_flows(defaults):
    """The basic model's blocked flows are its full-resolution flows,
    bit for bit, in the blocked layout; the small model ignores the
    option."""
    sd, (flows0, _) = defaults
    flows, _ = _flows_and_grads(dict(blocked_supervision=True), sd)
    assert flows[0].shape == (2, 64, 2, 8, 12)
    for a, b in zip(flows, flows0):
        assert torch.equal(traft.unblock_pixels(a), b)


def test_blocked_sequence_loss_matches_jax():
    """The loss and metrics on blocked flows, ground truth and valid map
    against JAX's blocked ones, and against the full-resolution ones."""
    batch = _batch(np.random.default_rng(9))
    rng = np.random.default_rng(10)
    preds = [rng.normal(0, 3, batch["flow"].shape).astype(np.float32)
             for _ in range(ITERS)]
    batch["flow"][0, 0, 0] = 450.0                # masked by max_flow
    ref, ref_m = jloss.sequence_loss(
        [jraft.block_pixels(jnp.asarray(p)) for p in preds],
        jraft.block_pixels(jnp.asarray(batch["flow"])),
        jraft.block_pixels(jnp.asarray(batch["valid"])))
    t = to_device(batch, "cpu")
    nchw = [torch.from_numpy(p.transpose(0, 3, 1, 2).copy()) for p in preds]
    got, got_m = tloss.sequence_loss(
        [traft.block_pixels(p) for p in nchw],
        traft.block_pixels(t["flow"]), traft.block_pixels(t["valid"]))
    full, full_m = tloss.sequence_loss(nchw, t["flow"], t["valid"])
    assert set(got_m) == set(ref_m)
    for a, b in ((got, ref), (got, full)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    for k in ref_m:
        np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]),
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(got_m[k]), float(full_m[k]),
                                   rtol=1e-6, err_msg=k)
