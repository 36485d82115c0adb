"""The port's GMFlow training step on the CPU against the JAX package's.

Same weights (the JAX model's ``init`` carried into the port by
``gmflow_state_dict_from_flax``; the port's seeded classifier carried
into flax by ``port_classifier``), same seeded numpy batches of smooth
64x96 images, f32 on both sides (the JAX dense softmax path; the port's
flash Function with its plain f32 backward), classifier on. After one and
two steps: the loss and the metrics, the raw gradients (captured before
the clip, as ``test_torch_train.py`` does), the Adam moments and the
parameters; one refine step; the NaN skip; one bf16 ``TransformerLayer``'s
input gradients against the JAX Pallas path in interpret mode; and the
runner from shards to a served checkpoint.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import opticalflowfromdepth_tpu.models.gmflow as J
from opticalflowfromdepth_tpu.models.classifier import Classifier as JCls
from opticalflowfromdepth_tpu.tools.port_torch_weights import (
    port_classifier, to_variables)
from opticalflowfromdepth_tpu.train import gmflow_train as jgt
from opticalflowfromdepth_tpu.train import optim as joptim
from opticalflowfromdepth_tpu.train.state import create_train_state
from opticalflowfromdepth_torch.data.datasets import AugmentedShards
from opticalflowfromdepth_torch.data.loader import Loader, to_device
from opticalflowfromdepth_torch.eval.cli import load_state_dict
from opticalflowfromdepth_torch.models import gmflow as T
from opticalflowfromdepth_torch.models.classifier import Classifier as TCls
from opticalflowfromdepth_torch.models.layers import init_weights_
from opticalflowfromdepth_torch.train import gmflow_train as tgt
from opticalflowfromdepth_torch.train.runner import RunnerConfig, TrainRunner
from opticalflowfromdepth_torch.weights import gmflow_state_dict_from_flax
# the raw-gradient recorder, the Adam-state and numpy-tree helpers and the
# shard writer of the RAFT step's test
from test_torch_train import _adam, _np_tree, _recorder, _write_shards

torch.set_num_threads(2)
H, W, B = 64, 96, 2
CFG = dict(batch_size=B, image_size=(H, W), mixed_precision=False,
           add_classifier=True, num_steps=100)
REFINE = dict(num_scales=2, upsample_factor=4, attn_splits_list=(2, 8),
              corr_radius_list=(-1, 4), prop_radius_list=(-1, 1))


def _batch(rng):
    """Smooth images (bilinear upsampled 8x12 noise; random-noise images
    make matching ambiguous and amplify f32 rounding), a noisy target."""
    low = torch.from_numpy(rng.uniform(0, 255, (2 * B, 3, 8, 12)).astype(
        np.float32))
    img = F.interpolate(low, size=(H, W), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    return dict(
        image1=np.ascontiguousarray(img[:B]),
        image2=np.ascontiguousarray(img[B:]),
        flow=rng.normal(0, 3, (B, H, W, 2)).astype(np.float32),
        valid=(rng.uniform(0, 1, (B, H, W)) > 0.1).astype(np.float32),
        label=np.eye(4, dtype=np.float32)[[0, 2]])


def _classifier(seed=3):
    """The port's classifier, the reference's init from ``seed`` (head
    included), BatchNorm running statistics moved away from 0/1."""
    gen = torch.Generator().manual_seed(seed)
    cls = TCls()
    init_weights_(cls, gen)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in cls.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, m.num_features).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, m.num_features).astype(np.float32)))
    return cls


@functools.lru_cache(maxsize=None)
def _jax_variables(refine: bool):
    cfg = jgt.GMFlowTrainConfig(**CFG, **(REFINE if refine else {}))
    model = jgt.build_model(cfg)
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    v = jax.jit(functools.partial(
        model.init, attn_splits_list=cfg.attn_splits_list,
        corr_radius_list=cfg.corr_radius_list,
        prop_radius_list=cfg.prop_radius_list))(
            jax.random.PRNGKey(2 if refine else 1), dummy, dummy)
    return _np_tree(v)


@functools.lru_cache(maxsize=None)
def _steps(refine: bool, n: int):
    """Both frameworks, ``n`` steps from the same state on the same
    batches; per step the JAX trees mapped to the port's names, and the
    port's."""
    extra = REFINE if refine else {}
    jcfg = jgt.GMFlowTrainConfig(**CFG, **extra)
    tcfg = tgt.GMFlowTrainConfig(**CFG, **extra)
    ns = jcfg.num_scales
    variables = _jax_variables(refine)
    cls = _classifier()
    cparams, cstats = port_classifier(cls.state_dict())
    tx = optax.chain(_recorder(), joptim.make_optimizer(
        jcfg.lr, jcfg.num_steps, jcfg.wdecay, clip=jcfg.grad_clip,
        anneal_strategy="cos"))
    jstate = create_train_state(jgt.build_model(jcfg),
                                {"params": variables["params"]}, tx)
    jstep = jax.jit(jgt.make_train_step(jcfg, to_variables(cparams, cstats),
                                        JCls()))

    tstate = tgt.init_state(tcfg, seed=0, device="cpu")
    tstate.model.load_state_dict(
        gmflow_state_dict_from_flax(variables["params"], ns), strict=True)
    tstep = tgt.make_train_step(tcfg, cls, device="cpu")
    raw = {}
    adam_step = tstate.optimizer.step

    def step_keeping_grads():
        raw.update({k: p.grad.clone()
                    for k, p in tstate.model.named_parameters()})
        return adam_step()
    tstate.optimizer.step = step_keeping_grads

    def to_port(tree):
        return gmflow_state_dict_from_flax(_np_tree(tree), ns)

    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        batch = _batch(rng)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jax.random.PRNGKey(i))
        adam = _adam(jstate.opt_state)
        ref = {"metrics": {k: float(v) for k, v in jm.items()},
               "grads": to_port(jstate.opt_state[0]),
               "mu": to_port(adam.mu), "nu": to_port(adam.nu),
               "state": to_port(jstate.params), "step": int(jstate.step),
               "pixels": int((batch["valid"] >= 0.5).sum())}
        if i > 0:
            # the next step from JAX's state: the parameters and the Adam
            # moments carried over (see test_train_step_matches_jax)
            tstate.model.load_state_dict(out[-1][0]["state"], strict=True)
            for k, p in tstate.model.named_parameters():
                adam_p = tstate.optimizer.adamw.state[p]
                adam_p["exp_avg"].copy_(out[-1][0]["mu"][k])
                adam_p["exp_avg_sq"].copy_(out[-1][0]["nu"][k])
        tstate, tm = tstep(tstate, to_device(batch, "cpu"))
        adamw = tstate.optimizer.adamw.state
        named = dict(tstate.model.named_parameters())
        got = {"metrics": {k: float(v) for k, v in tm.items()},
               "grads": dict(raw),
               "mu": {k: adamw[p]["exp_avg"].clone()
                      for k, p in named.items()},
               "nu": {k: adamw[p]["exp_avg_sq"].clone()
                      for k, p in named.items()},
               "state": {k: v.clone()
                         for k, v in tstate.model.state_dict().items()},
               "step": tstate.step}
        out.append((ref, got))
    return out


def _max_diff(got, ref, keys):
    return max(float((got[k] - ref[k]).abs().max()) for k in keys)


# The step amplifies f32 rounding most in the backbone's first conv (the
# largest gradients, through 15 instance norms' backward): two CPU runs of
# the port alone, at 1 and 4 threads, differ there by 9.5e-5 (1 scale)
# and 4.95e-4 (refine) of the global gradient norm, every other gradient
# by at most 8.1e-5. So that gradient is held to 1e-3 of the norm, every
# other one to 2e-4.
GRAD_REL = 2e-4
GRAD_REL_CONV1 = 1e-3


def _check_step(ref, got, metric_rel=1e-4):
    """Metrics within ``metric_rel`` relative, but for the accuracy and
    outlier rates, which count pixels: a pixel whose EPE lies within rounding of
    the threshold may count on the other side, so two pixels of the
    supervised ones are allowed. Raw gradients within ``GRAD_REL`` of the
    global gradient norm (``GRAD_REL_CONV1`` for the first conv); Adam's
    first moment within 0.1 of that relative limit (it is 0.1 times the
    gradient clipped to norm 1) and the second within 1e-6 (0.001 times
    its square); parameters within 2e-4 (an update moves each by about the
    learning rate, 1.6e-5 at step 0)."""
    assert got["step"] == ref["step"]
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        atol = 2.0 / ref["pixels"] if "px_" in k else 1e-7
        np.testing.assert_allclose(got["metrics"][k], v, rtol=metric_rel,
                                   atol=atol, err_msg=k)
    names = list(got["grads"])
    assert set(names) == set(ref["grads"]) and len(names) > 50
    norm = float(torch.sqrt(sum((ref["grads"][k] ** 2).sum() for k in names)))
    assert norm > 1.0            # so the clip scaled the gradients by 1/norm
    for k in names:
        rel = GRAD_REL_CONV1 if k == "backbone.conv1.weight" else GRAD_REL
        assert float((got["grads"][k] - ref["grads"][k]).abs().max()) \
            < rel * norm, k
        assert float((got["mu"][k] - ref["mu"][k]).abs().max()) \
            < 0.1 * rel, k
    assert _max_diff(got["nu"], ref["nu"], names) < 1e-6
    assert _max_diff(got["state"], ref["state"], names) < 2e-4


@pytest.mark.parametrize("n", [1, 2])
def test_train_step_matches_jax(n):
    """One scale, one and two steps. Step 2 starts from JAX's state after
    step 1 (parameters and Adam moments carried over): Adam's first update
    is ~lr sign(g), so where a tiny gradient's sign differs within
    rounding the weights part by 2 lr, and the step amplifies that
    (measured: from its own step-1 state the port's step-2 loss differs by
    1.2e-3 relative); carried over, step 2 checks the step itself."""
    ref, got = _steps(False, 2)[n - 1]
    _check_step(ref, got)
    assert got["metrics"]["skipped_nan"] == 0.0 and "classify_loss" in \
        got["metrics"]
    # the gradient reached every part of the model through the flash
    # backward: the transformer (window attention), the backbone (through
    # matching) and the propagation's projections
    for part in ("transformer.", "backbone.", "feature_flow_attn.q_proj"):
        assert any(float(g.abs().max()) > 0 for k, g in got["grads"].items()
                   if k.startswith(part)), part


def test_refine_train_step_matches_jax():
    """Two scales (splits 2 and 8, local matching r=4, local propagation
    r=1), one step: as the 1-scale step, but the metrics within 5e-4
    relative. The refinement's local matching amplifies f32 rounding: its
    forward alone leaves the JAX model's by up to 0.12 px
    (``test_torch_gmflow.py:test_gmflow_refine_matches_jax``), and the
    mean EPE here by 1.4e-4 relative."""
    ref, got = _steps(True, 1)[0]
    _check_step(ref, got, metric_rel=5e-4)


def test_nan_loss_skips_the_step():
    """A non-finite loss leaves the parameters, the Adam moments, the
    schedule's count and the step exactly as they were; the next finite
    batch trains."""
    cfg = tgt.GMFlowTrainConfig(**dict(CFG, add_classifier=False,
                                       num_transformer_layers=1))
    state = tgt.init_state(cfg, seed=4, device="cpu")
    step = tgt.make_train_step(cfg, device="cpu")
    rng = np.random.default_rng(1)
    state, _ = step(state, to_device(_batch(rng), "cpu"))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = {k: v["exp_avg"].clone()
               for k, v in state.optimizer.adamw.state.items()}
    bad = _batch(rng)
    bad["flow"][0, 3, 5, 0] = np.nan
    state, m = step(state, to_device(bad, "cpu"))
    assert float(m["skipped_nan"]) == 1.0
    assert not np.isfinite(float(m["total_loss"]))
    assert state.step == 1 and state.optimizer.count == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, v in state.optimizer.adamw.state.items():
        assert torch.equal(v["exp_avg"], moments[p])
    state, m = step(state, to_device(_batch(rng), "cpu"))
    assert float(m["skipped_nan"]) == 0.0 and state.step == 2


def test_classify_weight_matches_jax():
    for cfg in ({}, dict(classify_loss_weight_increase=-0.3,
                         min_classify_loss_weight=0.2)):
        jc, tc = jgt.GMFlowTrainConfig(**cfg), tgt.GMFlowTrainConfig(**cfg)
        for step in (0, 1, 3, 10, 100000):
            np.testing.assert_allclose(
                tgt.classify_weight_at(tc, step),
                float(jgt.classify_weight_at(jc, jnp.asarray(step))),
                rtol=1e-6)


def test_unported_model_parallel_raises():
    with pytest.raises(ValueError, match="not ported"):
        tgt.build_model(tgt.GMFlowTrainConfig(model_parallel=2))


def test_classifier_init_is_seeded():
    """Two seeded inits give the same weights, the linear head included,
    whatever torch's global generator drew in between."""
    sds = []
    for global_seed in (0, 123):
        torch.manual_seed(global_seed)
        cls = TCls()
        init_weights_(cls, torch.Generator().manual_seed(5))
        sds.append(cls.state_dict())
    assert set(sds[0]) == set(sds[1])
    for k, v in sds[0].items():
        assert torch.equal(v, sds[1][k]), k
    bound = 1.0 / np.sqrt(64)
    head = sds[0]["classify.3.weight"]
    assert float(head.abs().max()) <= bound and float(head.std()) > 0.3 * bound


@pytest.mark.parametrize("name", ["self_attn", "cross_attn_ffn"])
def test_transformer_layer_bf16_input_grads_match_jax_kernel_path(
        monkeypatch, name):
    """bf16, the TPU path: the input gradients of one shifted-window
    ``TransformerLayer`` (the [2B] batch of the transformer) through the
    JAX Pallas forward and backward kernels (interpret mode) against the
    port's bf16 layer through its flash Function (plain backward). Both
    round to bf16 at the flash kernels' places, but autodiff rounds the
    linears' and layer norms' gradients at other places than autograd
    (JAX's dense path agrees with the port about as well), so: at least
    20% of the gradients the same bf16 number (measured 26-51%; the port's
    f32 layer: under 1%, measured 0.004%), the mean difference within 0.9x
    the f32 layer's
    (measured 0.67-0.81x) and the largest within two bf16 steps of the
    largest gradient (measured one)."""
    monkeypatch.setenv("OFD_FLASH", "interpret")
    variables = _jax_variables(False)["params"]
    params = variables["transformer"]["block_1"][name]
    h, w = 8, 12
    rng = np.random.default_rng(11)
    src, tgt_, ct = (np.asarray(jnp.asarray(rng.normal(size=(2, h * w, 128)),
                                            jnp.bfloat16).astype(jnp.float32))
                     for _ in range(3))
    no_ffn = name == "self_attn"
    layer = J.TransformerLayer(128, no_ffn=no_ffn, with_shift=True,
                               dtype=jnp.bfloat16)
    _, vjp = jax.vjp(lambda s, t: layer.apply(
        {"params": params}, s, t, h, w,
        J.shift_window_attn_mask(h, w, 4, 6, 2, 3), 2),
        jnp.asarray(src, jnp.bfloat16), jnp.asarray(tgt_, jnp.bfloat16))
    want = [np.asarray(x, np.float32)
            for x in vjp(jnp.asarray(ct, jnp.bfloat16))]
    model = T.GMFlow()
    model.load_state_dict(gmflow_state_dict_from_flax(variables, 1),
                          strict=True)
    prefix = f"transformer.layers.1.{name}."
    sd = {k[len(prefix):]: t for k, t in model.state_dict().items()
          if k.startswith(prefix)}
    same, mean = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        port = T.TransformerLayer(128, no_ffn, 4, True, dtype=dt)
        port.load_state_dict(sd, strict=True)
        s = torch.tensor(src).to(dt).requires_grad_()
        t = torch.tensor(tgt_).to(dt).requires_grad_()
        port(s, t, h, w, 2).backward(torch.tensor(ct).to(dt))
        diffs = [np.abs(x.float().numpy() - wnt)
                 for x, wnt in zip((s.grad, t.grad), want)]
        assert s.grad.dtype == t.grad.dtype == dt
        same[dt] = [float((d == 0).mean()) for d in diffs]
        mean[dt] = [float(d.mean()) for d in diffs]
        if dt == torch.bfloat16:
            for d, wnt in zip(diffs, want):
                assert d.max() <= 2 ** -6 * np.abs(wnt).max()
    assert min(same[torch.bfloat16]) >= 0.2, same
    assert max(same[torch.float32]) < 0.01, same
    for m16, m32 in zip(mean[torch.bfloat16], mean[torch.float32]):
        assert m16 <= 0.9 * m32, mean


def test_train_runner_from_shards_to_served_weights(tmp_path):
    """Shards -> AugmentedShards (crop) -> Loader -> TrainRunner over the
    GMFlow step (2 transformer blocks to keep it quick) -> the `latest` and
    `step_<n>_weights` checkpoints -> resume -> the weights served by
    ``gmflow_infer_fn`` through the runner's ``infer_fn_factory``."""
    shards = tmp_path / "shards"
    shards.mkdir()
    _write_shards(shards)
    cfg = tgt.GMFlowTrainConfig(**dict(CFG, add_classifier=False, lr=1e-3,
                                       num_transformer_layers=2))
    loader = Loader(AugmentedShards(str(shards), crop_size=(H, W), seed=0),
                    batch_size=B, num_workers=1, seed=0)
    served = []

    def validator(infer):
        flow = infer(*(np.full((1, H, W, 3), 100.0, np.float32)
                       for _ in range(2)))
        served.append(flow.shape)
        return {"served_finite": float(np.isfinite(flow).all())}

    rcfg = RunnerConfig(log_dir=str(tmp_path / "run"), num_steps=3,
                        val_freq=3, save_ckpt_freq=3, save_latest_freq=2)
    runner = TrainRunner(rcfg, tgt.init_state(cfg, device="cpu"),
                         tgt.make_train_step(cfg, device="cpu"), loader,
                         validators={"serve": validator},
                         infer_fn_factory=tgt.infer_fn_factory(cfg, "cpu"),
                         device="cpu")
    state = runner.run()
    assert state.step == 3 and served == [(1, H, W, 2)]
    ckpt = tmp_path / "run" / "checkpoints"
    assert (ckpt / "latest.pth").exists()
    serve = T.GMFlow(num_transformer_layers=2)
    serve.load_state_dict(load_state_dict(str(ckpt / "step_3_weights.pth")),
                          strict=True)
    for k, v in state.model.state_dict().items():
        assert torch.equal(serve.state_dict()[k], v), k
    rng = np.random.default_rng(2)
    pair = [rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
            for _ in range(2)]
    from opticalflowfromdepth_torch.eval.infer import gmflow_infer_fn
    flow = gmflow_infer_fn(serve, device="cpu")(*pair)
    np.testing.assert_array_equal(
        flow, tgt.infer_fn_factory(cfg, "cpu")(state)(*pair))
    rcfg.resume = str(ckpt / "latest.pth")
    again = TrainRunner(rcfg, tgt.init_state(cfg, seed=5, device="cpu"),
                        tgt.make_train_step(cfg, device="cpu"), loader,
                        device="cpu")
    assert again.state.step == 2 and again.state.optimizer.count == 2
    assert again.run().step == 3


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is taken")
    cfg = tgt.GMFlowTrainConfig(num_transformer_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgt.init_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgt.make_train_step(cfg)
