"""The port's training step on the CPU against the JAX package's.

Same weights (the port's random init carried into flax variables by
``port_raft`` / ``port_classifier``), same seeded numpy batches, f32 on
both sides, classifier on, noise off, dropout 0. After one and after two
steps: the loss and the metrics within 1e-4 relative, the raw gradients
within RAFT's 2e-4, the Adam moments, the parameters and the BatchNorm
running statistics. The optimizer pieces are held against optax on
their own, and the runner is driven from shards end to end.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from opticalflowfromdepth_tpu.models.classifier import Classifier as JCls
from opticalflowfromdepth_tpu.synth.writer import write_augmented
from opticalflowfromdepth_tpu.tools.port_torch_weights import (
    port_classifier, port_raft, to_variables)
from opticalflowfromdepth_tpu.train import loss as jloss
from opticalflowfromdepth_tpu.train import optim as joptim
from opticalflowfromdepth_tpu.train import raft_train as jrt
from opticalflowfromdepth_tpu.train.state import create_train_state
from opticalflowfromdepth_torch.data.datasets import AugmentedShards
from opticalflowfromdepth_torch.data.loader import Loader, to_device
from opticalflowfromdepth_torch.eval.cli import load_state_dict
from opticalflowfromdepth_torch.models.classifier import Classifier as TCls
from opticalflowfromdepth_torch.models.layers import init_weights_
from opticalflowfromdepth_torch.models.raft import RAFT as TRAFT
from opticalflowfromdepth_torch.train import loss as tloss
from opticalflowfromdepth_torch.train import optim as toptim
from opticalflowfromdepth_torch.train import raft_train as trt
from opticalflowfromdepth_torch.train.runner import RunnerConfig, TrainRunner
from opticalflowfromdepth_torch.train.state import (load_checkpoint,
                                                    save_checkpoint)
from opticalflowfromdepth_torch.weights import raft_state_dict_from_flax

torch.set_num_threads(2)
H, W, B = 64, 96, 2
CFG = dict(iters=2, batch_size=B, image_size=(H, W), mixed_precision=False,
           add_classifier=True, num_steps=100)
GRAD_ATOL = 2e-4                # RAFT's tolerance, `tests/test_torch_parity.py`


def _batch(rng):
    return dict(
        image1=rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
        image2=rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
        flow=rng.normal(0, 3, (B, H, W, 2)).astype(np.float32),
        valid=(rng.uniform(0, 1, (B, H, W)) > 0.1).astype(np.float32),
        label=np.eye(4, dtype=np.float32)[[0, 2]])


def _models(seed=3):
    """Port RAFT and classifier with the reference's init (BatchNorm
    running statistics moved away from 0/1)."""
    gen = torch.Generator().manual_seed(seed)
    model = TRAFT(corr_impl="fused", generator=gen)
    cls = TCls()
    init_weights_(cls.encoder, gen)           # the head is drawn below
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        cls.classify["3"].weight.uniform_(-0.1, 0.1, generator=gen)
        cls.classify["3"].bias.zero_()
        for m in list(model.modules()) + list(cls.modules()):
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, m.num_features).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, m.num_features).astype(np.float32)))
    return model, cls


def _recorder():
    """An optax transformation that keeps the raw gradients in its state
    and passes them on unchanged."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def _adam(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@functools.lru_cache(maxsize=None)
def _two_steps(option=()):
    """Both frameworks, two steps from the same state on the same batches,
    each with the config's ``option`` (``(name, value)`` pairs); per step
    the JAX trees mapped to the port's names, and the port's."""
    model, cls = _models()
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    jcfg = jrt.RAFTTrainConfig(**dict(CFG, **dict(option)))
    tcfg = trt.RAFTTrainConfig(**dict(CFG, **dict(option)))

    params, stats = port_raft(sd0)
    cparams, cstats = port_classifier(cls.state_dict())
    tx = optax.chain(_recorder(), joptim.make_optimizer(
        jcfg.lr, jcfg.num_steps, jcfg.wdecay, jcfg.epsilon, jcfg.clip,
        anneal_strategy="linear"))
    jstate = create_train_state(jrt.build_model(jcfg),
                                to_variables(params, stats), tx)
    jstep = jax.jit(jrt.make_train_step(jcfg, to_variables(cparams, cstats),
                                        JCls()))

    tstate = trt.init_state(tcfg, seed=0, device="cpu")
    tstate.model.load_state_dict(sd0, strict=True)
    tstep = trt.make_train_step(tcfg, cls, device="cpu")
    raw = {}
    adam_step = tstate.optimizer.step

    def step_keeping_grads():
        raw.update({n: p.grad.clone()
                    for n, p in tstate.model.named_parameters()})
        return adam_step()
    tstate.optimizer.step = step_keeping_grads

    rng = np.random.default_rng(0)
    out = []
    for i in range(2):
        batch = _batch(rng)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jax.random.PRNGKey(i))
        jbs = _np_tree(jstate.batch_stats)
        adam = _adam(jstate.opt_state)
        ref = {"metrics": {k: float(v) for k, v in jm.items()},
               "grads": raft_state_dict_from_flax(
                   _np_tree(jstate.opt_state[0]), jbs),
               "mu": raft_state_dict_from_flax(_np_tree(adam.mu), jbs),
               "nu": raft_state_dict_from_flax(_np_tree(adam.nu), jbs),
               "state": raft_state_dict_from_flax(_np_tree(jstate.params),
                                                  jbs)}
        tstate, tm = tstep(tstate, to_device(batch, "cpu"),
                           torch.Generator().manual_seed(i))
        adamw = tstate.optimizer.adamw.state
        named = dict(tstate.model.named_parameters())
        got = {"metrics": {k: float(v) for k, v in tm.items()},
               "grads": dict(raw),
               "mu": {n: adamw[p]["exp_avg"].clone()
                      for n, p in named.items()},
               "nu": {n: adamw[p]["exp_avg_sq"].clone()
                      for n, p in named.items()},
               "state": {k: v.clone()
                         for k, v in tstate.model.state_dict().items()}}
        out.append((ref, got))
    return out


def _max_diff(got, ref, keys):
    return max(float((got[k] - ref[k]).abs().max()) for k in keys)


@pytest.mark.parametrize("n", [1, 2])
def test_train_step_matches_jax(n):
    check_step_against_jax(n)


def check_step_against_jax(n, option=()):
    """Step ``n`` of :func:`_two_steps` with ``option``: the port's against
    JAX's at RAFT's tolerances."""
    ref, got = _two_steps(option)[n - 1]
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    names = list(got["grads"])
    assert len(names) > 100
    # Raw gradients, before the clip. From the same weights (step 1):
    # RAFT's 2e-4. Adam's first update is ~lr*sign(g), so where the two
    # sides' rounding gives a small gradient opposite signs the weights
    # part by up to 2*lr, and the 2-sample training-mode BatchNorm of the
    # context encoder amplifies that: the step-2 gradients are held to
    # 1e-3 of the global gradient norm (observed: 2.2e-4 of it).
    norm = float(torch.sqrt(sum((ref["grads"][k] ** 2).sum() for k in names)))
    grad_tol = GRAD_ATOL if n == 1 else 1e-3 * norm
    assert _max_diff(got["grads"], ref["grads"], names) < grad_tol
    # Adam's moments: 0.1 times the clipped gradient (norm <= 1), and
    # 0.001 times its square
    assert _max_diff(got["mu"], ref["mu"], names) < (
        0.1 * GRAD_ATOL if n == 1 else 1e-4)
    assert _max_diff(got["nu"], ref["nu"], names) < 1e-6
    assert _max_diff(got["state"], ref["state"], names) < GRAD_ATOL
    stats = [k for k in got["state"] if "running" in k]
    assert len(stats) > 10
    for k in stats:
        np.testing.assert_allclose(got["state"][k].numpy(),
                                   ref["state"][k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    if n == 2:      # the running statistics really moved, twice
        moved = got["state"]["cnet.norm1.running_var"]
        first = _two_steps(option)[0][1]["state"]["cnet.norm1.running_var"]
        assert not torch.allclose(moved, first)


# --------------------------------------------------------------------------
# losses, schedule, clip, AdamW against the JAX package and optax
# --------------------------------------------------------------------------

def test_sequence_and_classifier_loss_match_jax():
    rng = np.random.default_rng(1)
    preds = [rng.normal(0, 4, (2, 16, 24, 2)).astype(np.float32)
             for _ in range(3)]
    gt = rng.normal(0, 4, (2, 16, 24, 2)).astype(np.float32)
    gt[0, 0, 0] = 500.0                       # masked by max_flow
    valid = (rng.uniform(0, 1, (2, 16, 24)) > 0.3).astype(np.float32)
    ref, ref_m = jloss.sequence_loss([jnp.asarray(p) for p in preds],
                                     jnp.asarray(gt), jnp.asarray(valid))
    nchw = [torch.from_numpy(p.transpose(0, 3, 1, 2)) for p in preds]
    got, got_m = tloss.sequence_loss(
        nchw, torch.from_numpy(gt.transpose(0, 3, 1, 2)),
        torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    assert set(got_m) == set(ref_m)
    for k in ref_m:
        np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]),
                                   rtol=1e-6, err_msg=k)
    logits = rng.normal(0, 3, (5, 4)).astype(np.float32)
    label = np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 1]]
    np.testing.assert_allclose(
        float(tloss.classifier_loss(torch.from_numpy(logits),
                                    torch.from_numpy(label))),
        float(jloss.classifier_loss(jnp.asarray(logits), jnp.asarray(label))),
        rtol=1e-6)


@pytest.mark.parametrize("anneal", ["linear", "cos"])
def test_one_cycle_schedule_matches_optax(anneal):
    total = 1100
    warm = int(0.05 * total)
    ref = joptim.one_cycle_schedule(2.5e-4, total, anneal_strategy=anneal)
    got = toptim.one_cycle_schedule(2.5e-4, total, anneal_strategy=anneal)
    for step in (0, warm - 1, warm, warm + 1, 600, total - 1, total):
        # optax evaluates in f32, the port in Python floats: a few f32
        # steps of the peak rate
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-5,
                                   atol=1e-5 * 2.5e-4, err_msg=str(step))
    assert got(warm) == 2.5e-4 and got(warm - 1) < got(warm)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """Global norm below 1 (left alone) and above 1 (scaled to 1)."""
    rng = np.random.default_rng(2)
    grads = [(rng.normal(0, 1, s) * scale / 10).astype(np.float32)
             for s in ((3, 4), (7,), (2, 2, 5))]
    ref, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = toptim.clip_by_global_norm_(got, 1.0)
    want = float(optax.global_norm([jnp.asarray(g) for g in grads]))
    np.testing.assert_allclose(float(norm), want, rtol=1e-6)
    assert (want < 1.0) == (scale < 1.0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-8)


def test_optimizer_matches_optax_over_steps():
    """clip + AdamW + schedule, five steps at a learning rate large enough
    to move every parameter, with decay on every leaf."""
    rng = np.random.default_rng(3)
    shapes = ((4, 3), (5,), (2, 3, 2))
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, g, s).astype(np.float32) for s in shapes]
             for g in (0.1, 2.0, 0.05, 1.0, 0.3)]
    tx = joptim.make_optimizer(1e-2, 20, 0.1, anneal_strategy="linear")
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = toptim.make_optimizer(tp, 1e-2, 20, 0.1)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    assert opt.count == len(grads)
    for p, r in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-6)


def test_classify_weight_matches_jax():
    for cfg in ({}, dict(classify_loss_weight_increase=-0.3,
                         min_classify_loss_weight=0.2)):
        jc, tc = jrt.RAFTTrainConfig(**cfg), trt.RAFTTrainConfig(**cfg)
        for step in (0, 1, 3, 10, 100000):
            np.testing.assert_allclose(
                trt.classify_weight_at(tc, step),
                float(jrt.classify_weight_at(jc, jnp.asarray(step))),
                rtol=1e-6)


# --------------------------------------------------------------------------
# checkpoints, resume, the runner from shards, the default device
# --------------------------------------------------------------------------

def _small_cfg(**kw):
    return trt.RAFTTrainConfig(**dict(CFG, add_classifier=False, lr=1e-3,
                                      **kw))


def test_latest_checkpoint_round_trip_and_resume(tmp_path):
    cfg = _small_cfg()
    batch = to_device(_batch(np.random.default_rng(4)), "cpu")
    step = trt.make_train_step(cfg, device="cpu")
    a = trt.init_state(cfg, seed=1, device="cpu")
    a, _ = step(a, batch, torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), a, "latest")
    b = load_checkpoint(path, trt.init_state(cfg, seed=2, device="cpu"))
    assert b.step == a.step == 1 and b.optimizer.count == 1
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    for s in (a, b):
        step(s, batch, torch.Generator().manual_seed(1))
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(va, vb), k


def _write_shards(root, n=3, h=72, w=104, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        pair = rng.uniform(0, 255, (12, h, w)).astype(np.float32)
        pair[8:12] = rng.normal(0, 3, (4, h, w))       # flows
        pair[[3, 7]] = rng.uniform(20, 90, (2, h, w))  # depths
        sets = [rng.uniform(0, 255, (8, h, w)).astype(np.float32)
                for _ in range(2)]
        write_augmented(str(root), f"img{i}", i % 5, i, pair, *sets,
                        aug_type=i + 3)


def test_train_runner_from_shards(tmp_path):
    shards = tmp_path / "shards"
    shards.mkdir()
    _write_shards(shards)
    cfg = _small_cfg()
    loader = Loader(AugmentedShards(str(shards), crop_size=(H, W), seed=0),
                    batch_size=B, num_workers=1, seed=0)
    rcfg = RunnerConfig(log_dir=str(tmp_path / "run"), num_steps=3,
                        val_freq=100, save_ckpt_freq=3, save_latest_freq=2)
    runner = TrainRunner(rcfg, trt.init_state(cfg, device="cpu"),
                         trt.make_train_step(cfg, device="cpu"), loader,
                         device="cpu")
    state = runner.run()
    assert state.step == 3
    ckpt = tmp_path / "run" / "checkpoints"
    assert (ckpt / "latest.pth").exists()
    # the weights checkpoint loads into the serving model unchanged
    serve = TRAFT(corr_impl="fused")
    serve.load_state_dict(load_state_dict(str(ckpt / "step_3_weights.pth")),
                          strict=True)
    for k, v in state.model.state_dict().items():
        assert torch.equal(serve.state_dict()[k], v), k
    # resume from `latest` (step 2) and run to step 3 again
    rcfg.resume = str(ckpt / "latest.pth")
    again = TrainRunner(rcfg, trt.init_state(cfg, seed=5, device="cpu"),
                        trt.make_train_step(cfg, device="cpu"), loader,
                        device="cpu")
    assert again.state.step == 2
    assert again.run().step == 3


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is taken")
    cfg = _small_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.init_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.make_train_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainRunner(RunnerConfig(), None, None, [])
