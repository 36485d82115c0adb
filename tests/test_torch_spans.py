"""The program's spans (``utils/profiling.annotate``) on the CPU: the shared
no-op when nothing records, a ``record_function`` range under the
profiler, and the ``ofd.*`` ranges that a GMFlow and a RAFT training step
and a RAFT inference call open, in order and nested as the benchmark's
trace reduction (``benchmark/harness/spans.py``) reads them."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from opticalflowfromdepth_torch.data.loader import to_device
from opticalflowfromdepth_torch.eval.infer import raft_infer_fn
from opticalflowfromdepth_torch.models.classifier import Classifier
from opticalflowfromdepth_torch.models.layers import init_weights_
from opticalflowfromdepth_torch.models.raft import RAFT
from opticalflowfromdepth_torch.train import gmflow_train, raft_train
from opticalflowfromdepth_torch.utils import profiling as P

torch.set_num_threads(2)
H, W, B = 64, 96, 2
STAGES = ["ofd.train.forward", "ofd.train.loss", "ofd.train.backward",
          "ofd.sync.nan_check", "ofd.train.optimizer"]


def _spans(prof):
    """The ``ofd.*`` ranges of the trace as (start, end, name), by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("ofd.")
                  and str(e.device_type()).endswith("CPU"))


def _named(spans, name):
    return [s for s in spans if s[2] == name]


def _inside(spans, outer):
    """Every span of ``spans`` lies within one of ``outer``."""
    return all(any(o[0] <= s[0] and s[1] <= o[1] for o in outer)
               for s in spans)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (2 * B, H, W, 3)).astype(np.float32)
    return to_device(dict(
        image1=img[:B], image2=img[B:],
        flow=rng.normal(0, 3, (B, H, W, 2)).astype(np.float32),
        valid=(rng.uniform(0, 1, (B, H, W)) > 0.1).astype(np.float32),
        label=np.eye(4, dtype=np.float32)[[0, 2]]), "cpu")


def _classifier():
    cls = Classifier()
    init_weights_(cls, torch.Generator().manual_seed(3))
    return cls


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_annotate_is_the_shared_noop_when_nothing_records():
    assert P.annotate("ofd.a") is P.annotate("ofd.b") is P._OFF
    with P.annotate("ofd.a") as inner:
        assert inner is None

    @P.spanned("ofd.c")
    def double(x):
        """Twice x."""
        return 2 * x
    assert double(3) == 6 and double.__doc__ == "Twice x."


def test_annotate_records_a_range_under_the_profiler():
    def body():
        span = P.annotate("ofd.test.outer")
        assert span is not P._OFF
        with span:
            with P.annotate("ofd.test.inner"):
                torch.ones(4).sum()
    _, spans = _traced(body)
    assert [s[2] for s in spans] == ["ofd.test.outer", "ofd.test.inner"]
    assert _inside(spans[1:], spans[:1])
    assert P.annotate("ofd.test.after") is P._OFF


def test_nothing_constructs_a_range_unrecorded(monkeypatch):
    """With no profiler a RAFT call and a GMFlow step never build a
    ``record_function``: each span is one check."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    model = RAFT(corr_impl="fused", generator=torch.Generator().manual_seed(0))
    img = np.random.default_rng(0).uniform(0, 255, (1, H, W, 3)).astype(
        np.float32)
    assert raft_infer_fn(model, iters=2, device="cpu")(img, img).shape \
        == (1, H, W, 2)
    cfg = gmflow_train.GMFlowTrainConfig(
        batch_size=B, image_size=(H, W), mixed_precision=False,
        num_transformer_layers=1, add_classifier=True)
    state = gmflow_train.init_state(cfg, seed=1, device="cpu")
    gmflow_train.make_train_step(cfg, _classifier(), device="cpu")(
        state, _batch())


def test_gmflow_train_step_spans():
    """One step opens the five stages once each, in order, inside its
    ``ofd.train.step``; every flash forward lies in the forward, one flash
    backward each in the backward, the classifier in the loss, the model's
    stages in the forward."""
    cfg = gmflow_train.GMFlowTrainConfig(
        batch_size=B, image_size=(H, W), mixed_precision=False,
        num_transformer_layers=1, add_classifier=True)
    state = gmflow_train.init_state(cfg, seed=1, device="cpu")
    step = gmflow_train.make_train_step(cfg, _classifier(), device="cpu")
    (_, metrics), spans = _traced(lambda: step(state, _batch()))
    assert float(metrics["skipped_nan"]) == 0.0
    stages = [s for s in spans if s[2] in STAGES]
    assert [s[2] for s in stages] == STAGES
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))
    assert len(_named(spans, "ofd.train.step")) == 1
    assert _inside(stages, _named(spans, "ofd.train.step"))
    fwd, bwd = _named(spans, "ofd.op.flash_fwd"), _named(spans,
                                                         "ofd.op.flash_bwd")
    # two attentions of the one block, matching, propagation
    assert len(fwd) == len(bwd) == 4
    assert _inside(fwd, _named(spans, "ofd.train.forward"))
    assert _inside(bwd, _named(spans, "ofd.train.backward"))
    assert len(_named(spans, "ofd.classifier")) == 1
    assert _inside(_named(spans, "ofd.classifier"),
                   _named(spans, "ofd.train.loss"))
    for name in ("backbone", "transformer", "matching", "propagation",
                 "upsample"):
        model = _named(spans, f"ofd.gmflow.{name}")
        assert model and _inside(model, _named(spans, "ofd.train.forward"))
    norms = _named(spans, "ofd.op.instance_norm")
    assert _inside(norms, _named(spans, "ofd.train.forward")
                   + _named(spans, "ofd.train.backward"))
    assert any(_inside([n], _named(spans, "ofd.train.backward"))
               for n in norms)


@pytest.mark.parametrize("remat,lookups", [("none", 1), ("dots", 2),
                                           ("full", 2)])
def test_raft_train_step_spans(remat, lookups):
    """RAFT's step: forward, loss, backward and optimizer in order (no NaN
    check); an update span and a lookup an iteration in the forward, the
    lookup's backward in the backward; under ``remat`` "dots" and "full"
    the lookup's span again in the backward's recompute ("dots" takes the
    saved output there, so its span holds no kernel)."""
    iters = 2
    cfg = raft_train.RAFTTrainConfig(
        batch_size=B, image_size=(H, W), iters=iters, mixed_precision=False,
        remat=remat, add_classifier=True)
    state = raft_train.init_state(cfg, seed=2, device="cpu")
    step = raft_train.make_train_step(cfg, _classifier(), device="cpu")
    _, spans = _traced(lambda: step(state, _batch(), torch.Generator()))
    stages = [s for s in spans if s[2] in STAGES]
    assert [s[2] for s in stages] == [s for s in STAGES
                                      if s != "ofd.sync.nan_check"]
    assert _inside(stages, _named(spans, "ofd.train.step"))
    forward = _named(spans, "ofd.train.forward")
    backward = _named(spans, "ofd.train.backward")
    assert len(_named(spans, "ofd.raft.update")) == iters
    assert _inside(_named(spans, "ofd.raft.update"), forward)
    looked = _named(spans, "ofd.op.corr_lookup")
    assert len(looked) == lookups * iters
    assert sum(_inside([s], backward) for s in looked) \
        == (lookups - 1) * iters
    assert len(_named(spans, "ofd.op.corr_lookup_bwd")) == iters
    assert _inside(_named(spans, "ofd.op.corr_lookup_bwd"), backward)


@pytest.mark.parametrize("iters", [1, 3])
def test_raft_infer_spans(iters):
    """A call uploads once, runs the encoders and the pyramid once, one
    update span and one lookup an iteration, the upsample once, and
    downloads once; the flow is the flow of the same call untraced."""
    model = RAFT(corr_impl="fused", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(iters)
    i1, i2 = (rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
              for _ in range(2))
    infer = raft_infer_fn(model, iters=iters, device="cpu")
    flow, spans = _traced(lambda: infer(i1, i2))
    np.testing.assert_array_equal(flow, infer(i1, i2))
    counts = {}
    for s in spans:
        counts[s[2]] = counts.get(s[2], 0) + 1
    assert counts.pop("ofd.op.instance_norm") > 0
    assert counts == {"ofd.infer.call": 1, "ofd.infer.upload": 1,
                      "ofd.infer.model": 1,
                      "ofd.sync.download": 1, "ofd.raft.fnet": 1,
                      "ofd.raft.cnet": 1, "ofd.raft.corr_pyramid": 1,
                      "ofd.raft.update": iters, "ofd.op.corr_lookup": iters,
                      "ofd.raft.upsample": 1}
    model_span = _named(spans, "ofd.infer.model")
    assert _inside(_named(spans, "ofd.op.corr_lookup"),
                   _named(spans, "ofd.raft.update"))
    assert _inside([s for s in spans if s[2].startswith("ofd.raft.")],
                   model_span)
    order = [s[2] for s in spans if s[2].startswith(("ofd.infer.",
                                                     "ofd.sync."))]
    assert order == ["ofd.infer.call", "ofd.infer.upload", "ofd.infer.model",
                     "ofd.sync.download"]
    assert _inside(spans, _named(spans, "ofd.infer.call"))
