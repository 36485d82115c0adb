"""The port's classifier training on the CPU against the JAX package's.

The JAX ``init_state``'s variables are carried into the port by
``weights.classifier_state_dict_from_flax``; both take one and two f32
steps (dropout 0, so neither side draws) on the same flow batch, then the
eval step on another: the metrics, the parameters and the BatchNorm
running statistics within 1e-4. The first updates are ``lr/25`` (OneCycle
starts there), so a gradient whose sign differs within rounding moves a
weight by at most ``2 lr/25 = 8e-6``. Then a learning check like
``tests/test_classifier_train.py``: accuracy on held-out synthetic flow
classes above 0.6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.train import classifier_train as jct
from opticalflowfromdepth_torch.train import classifier_train as tct
from opticalflowfromdepth_torch.train.state import save_weights
from opticalflowfromdepth_torch.models.classifier import Classifier
from opticalflowfromdepth_torch.weights import classifier_state_dict_from_flax

torch.set_num_threads(2)


def make_batch(rng, n, h, w):
    """Synthetic flow fields, one structure per class: 0 none (constant),
    1 flip (sign-split), 2 rotate (curl), 3 shear (as the JAX test's)."""
    flows, labels = [], []
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy = w / 2, h / 2
    for _ in range(n):
        c = int(rng.integers(0, 4))
        if c == 0:
            f = np.stack([np.full((h, w), rng.uniform(-3, 3)),
                          np.full((h, w), rng.uniform(-3, 3))], -1)
        elif c == 1:
            f = np.stack([(xs - cx) * 2.0 / w * 10, np.zeros((h, w))], -1)
        elif c == 2:
            f = np.stack([-(ys - cy) / h * 10, (xs - cx) / w * 10], -1)
        else:
            f = np.stack([(ys - cy) / h * 8, np.zeros((h, w))], -1)
        f = f + rng.normal(0, 0.1, (h, w, 2))
        flows.append(f.astype(np.float32))
        onehot = np.zeros(4, np.float32)
        onehot[c] = 1
        labels.append(onehot)
    return {"flow": np.stack(flows), "label": np.stack(labels)}


def _torch(batch):
    return {"flow": torch.from_numpy(batch["flow"]).permute(0, 3, 1, 2),
            "label": torch.from_numpy(batch["label"])}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("use_small", [True, False])
def test_classifier_steps_match_jax(use_small):
    h, w = 32, 48
    cfg = dict(image_size=(h, w), num_steps=50, lr=1e-4, use_small=use_small,
               mixed_precision=False, dropout=0.0)
    jcfg, tcfg = jct.ClassifierTrainConfig(**cfg), \
        tct.ClassifierTrainConfig(**cfg)
    jstate = jct.init_state(jcfg, jax.random.PRNGKey(0))
    state = tct.init_state(tcfg, seed=0, device="cpu")
    state.model.load_state_dict(classifier_state_dict_from_flax(
        jstate.params, jstate.batch_stats, use_small=use_small), strict=True)
    jstep = jax.jit(jct.make_train_step(jcfg))
    step = tct.make_train_step(tcfg)
    rng = np.random.default_rng(1)
    for i in range(2):
        batch = make_batch(rng, 4, h, w)
        jstate, jm = jstep(jstate, _jax(batch), jax.random.PRNGKey(i))
        state, m = step(state, _torch(batch), torch.Generator())
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i} {k}")
        want = classifier_state_dict_from_flax(
            jstate.params, jstate.batch_stats, use_small=use_small)
        for k, t in state.model.state_dict().items():
            if "num_batches_tracked" in k:
                continue
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"step {i} {k}")
    assert state.step == 2 and state.optimizer.count == 2
    held = make_batch(np.random.default_rng(9), 6, h, w)
    jres = jct.make_eval_step(jcfg)(jstate.params, jstate.batch_stats,
                                    _jax(held))
    res = tct.make_eval_step(tcfg)(state, _torch(held))
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(res[k]), float(jres[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=f"eval {k}")


def test_classifier_config_and_checkpoint(tmp_path):
    """The JAX config's defaults (dropout 0.1, not the model's 0.9); the
    weights checkpoint is a plain state_dict under the reference's names,
    which a default ``Classifier`` loads as the training CLI does."""
    assert tct.ClassifierTrainConfig() == tct.ClassifierTrainConfig(
        **{f: getattr(jct.ClassifierTrainConfig(), f)
           for f in jct.ClassifierTrainConfig.__dataclass_fields__})
    assert tct.ClassifierTrainConfig().dropout == 0.1
    cfg = tct.ClassifierTrainConfig(image_size=(16, 24), mixed_precision=False)
    state = tct.init_state(cfg, seed=3, device="cpu")
    assert state.model.dropout == 0.1
    path = save_weights(str(tmp_path), state.model, "classifier")
    sd = torch.load(path, weights_only=True)
    assert "classify.3.weight" in sd and any(
        k.startswith("encoder.") for k in sd)
    frozen = Classifier()
    frozen.load_state_dict(sd, strict=True)
    flow = torch.randn(2, 2, 16, 24, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(frozen(flow, train=False),
                               state.model(flow, train=False))
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tct.init_state(cfg)


def test_classifier_learns_flow_classes():
    h, w = 32, 48
    cfg = tct.ClassifierTrainConfig(image_size=(h, w), num_steps=60,
                                    lr=2e-3, use_small=True,
                                    mixed_precision=False, dropout=0.0)
    state = tct.init_state(cfg, seed=0, device="cpu")
    step = tct.make_train_step(cfg)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(40):
        state, m = step(state, _torch(make_batch(rng, 16, h, w)), gen)
    res = tct.make_eval_step(cfg)(
        state, _torch(make_batch(np.random.default_rng(123), 32, h, w)))
    acc = float(res["accuracy"])
    assert np.isfinite(float(res["loss"])) and acc > 0.6, acc


def test_dropout_draws_from_the_step_generator():
    cfg = tct.ClassifierTrainConfig(image_size=(16, 24), use_small=True,
                                    mixed_precision=False, dropout=0.5)
    batch = _torch(make_batch(np.random.default_rng(2), 4, 16, 24))
    losses = []
    for seed in (5, 5, 6):
        state = tct.init_state(cfg, seed=0, device="cpu")
        _, m = tct.make_train_step(cfg)(state, batch,
                                        torch.Generator().manual_seed(seed))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] != losses[2]
