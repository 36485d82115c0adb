"""The instance-norm kernels' plan and arithmetic on the CPU
(``ops/instance_norm.py``).

The card's kernels (``csrc/instance_norm.cu``) cut the rows by
:func:`plan`: whole short rows a block, or long rows split across a thread
block cluster whose blocks add their partial f32 sums in rank order. Here
the plan must cover every value of every row exactly once within the
shared-memory cap, for the forward's one operand and the backward's two
or three; :func:`split_sum_plain`, which repeats the plan's partition of
the sums, is held against the JAX package's Pallas kernel in interpret
mode (f32 within 1e-4, bf16 within one bf16 step), and
:func:`bwd_split_sum_plain`, the backward's, against the closed form
:func:`instance_norm_bwd`, which CPU tensors keep taking. The kernels
themselves run on the card (``chip_smoke.py`` [3b], [3d],
``tests/test_torch_cuda.py``, which holds the backward kernel against
:func:`bwd_split_sum_plain` under its own plan).
"""

import importlib
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowfromdepth_tpu.ops import instance_norm as jin
from opticalflowfromdepth_torch.ops import instance_norm as tin

torch.set_num_threads(2)

# RAFT-basic's fnet and GMFlow's backbone at serving (Sintel) and training
# shapes, then the edge classes: short odd rows, a ragged last slice, rows
# too long for a cluster's shared memory, a single value
SHAPES = [(2, 64, 220, 512), (2, 96, 110, 256), (2, 128, 55, 128),
          (16, 64, 184, 248), (16, 96, 92, 124), (16, 128, 46, 62),
          (2, 64, 224, 512), (32, 64, 184, 280), (32, 96, 92, 140),
          (32, 128, 46, 70), (3, 5, 1, 37), (1, 2, 211, 307),
          (1, 3, 1024, 1024), (1, 1, 1, 1)]

# the 15 norms of GMFlow's training step (32 images of 368x560) in the
# backbone's order, with whether a ReLU is fused: the stem's (its ReLU a
# separate op), then per stage a block's two (fused) and, in stages 2 and
# 3, the downsampling skip's
GMFLOW_TRAIN_NORMS = (
    [((32, 64, 184, 280), False)] + [((32, 64, 184, 280), True)] * 4
    + [((32, 96, 92, 140), True)] * 2 + [((32, 96, 92, 140), False)]
    + [((32, 96, 92, 140), True)] * 2
    + [((32, 128, 46, 70), True)] * 2 + [((32, 128, 46, 70), False)]
    + [((32, 128, 46, 70), True)] * 2)
# RAFT training's fnet (16 images of 368x496)
RAFT_TRAIN_FNET = [(16, 64, 184, 248), (16, 96, 92, 124), (16, 128, 46, 62)]


def block_ranges(rows, n, p):
    """Each block's values ``[s, e)`` of the flat ``[rows, n]`` tensor, as
    the kernel derives them from its block index."""
    if p["cluster"] == 1:
        k = p["rows_per_block"]
        return [(r0 * n, min(r0 + k, rows) * n) for r0 in range(0, rows, k)]
    return [(r * n + rank * p["slice"],
             min(r * n + (rank + 1) * p["slice"], (r + 1) * n))
            for r in range(rows) for rank in range(p["cluster"])]


def check_plan_covers_every_value_once(shape, itemsize, operands=1):
    b, c, h, w = shape
    rows, n = b * c, h * w
    p = tin.plan(rows, n, itemsize, operands)
    assert p["cluster"] in tin.CLUSTERS
    assert 1 <= p["rows_per_block"] <= tin.MAX_ROWS
    assert p["cluster"] == 1 or p["rows_per_block"] == 1
    assert p["piece"] * itemsize * operands <= tin.SMEM_CAP
    ranges = block_ranges(rows, n, p)
    assert len(ranges) == p["blocks"]
    # the blocks tile the tensor in order, none empty, none across a
    # cluster's row
    assert ranges[0][0] == 0 and ranges[-1][1] == rows * n
    assert all(s < e for s, e in ranges)
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
    if p["cluster"] > 1:
        assert all(s // n == (e - 1) // n for s, e in ranges)
    # resident: every block's part fits its shared memory at once
    assert p["resident"] == (max(e - s for s, e in ranges) <= p["piece"])
    return p


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_value_once(shape, itemsize):
    check_plan_covers_every_value_once(shape, itemsize)


def test_gmflow_train_norms_are_the_benchmarks(monkeypatch):
    """The 15 norms below are those ``benchmark/harness/counts.py`` counts
    for GMFlow's training cell. The benchmark's folder is on the path and
    its ``harness`` package imported for this test alone."""
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).resolve().parent
                                    .parent / "benchmark"))
    for name in [m for m in sys.modules
                 if m == "harness" or m.startswith("harness.")]:
        monkeypatch.delitem(sys.modules, name)
    before = set(sys.modules)
    try:
        counts = importlib.import_module("harness.counts")
        norms = counts.encoder_norms(32, 368, 560)
    finally:
        for name in set(sys.modules) - before:
            if name == "harness" or name.startswith("harness."):
                del sys.modules[name]
    assert [int(np.prod(s)) for s, _ in GMFLOW_TRAIN_NORMS] == norms
    assert sum(relu for _, relu in GMFLOW_TRAIN_NORMS) == 12


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("operands", [2, 3])
@pytest.mark.parametrize("shape", [s for s, _ in GMFLOW_TRAIN_NORMS]
                         + RAFT_TRAIN_FNET)
def test_bwd_plan_covers_every_value_once(shape, operands, itemsize):
    """The backward's plan (g, x and, after a ReLU, y) at every norm of
    GMFlow's training step and RAFT training's fnet."""
    check_plan_covers_every_value_once(shape, itemsize, operands)


@pytest.mark.parametrize("rows,n,itemsize,operands,cluster,k,resident", [
    (4096, 46 * 70, 2, 3, 1, 3, True),        # short rows, 3 a block
    (3072, 92 * 140, 2, 2, 1, 1, True),       # a row a block
    (3072, 92 * 140, 2, 3, 2, 1, True),       # clusters of 2
    (2048, 184 * 280, 2, 2, 4, 1, True),      # of 4
    (2048, 184 * 280, 2, 3, 8, 1, True),      # of 8
    (2048, 184 * 280, 4, 3, 8, 1, False),     # streamed twice
])
def test_bwd_plan_classes(rows, n, itemsize, operands, cluster, k, resident):
    """The backward's classes at GMFlow's training shapes: the operands'
    bytes together choose the cut."""
    p = tin.plan(rows, n, itemsize, operands)
    assert (p["cluster"], p["rows_per_block"], p["resident"]) \
        == (cluster, k, resident)


def test_plan_classes():
    """The classes the card's cases rely on ([3b])."""
    p = tin.plan(128, 220 * 512, 4)                  # RAFT serving, f32
    assert p["cluster"] == 8 and p["resident"]
    p = tin.plan(128, 220 * 512, 2)                  # the same in bf16
    assert p["cluster"] > 1 and p["resident"]
    p = tin.plan(2048, 46 * 62, 2)                   # RAFT training, 1/8
    assert p["cluster"] == 1 and p["rows_per_block"] > 1
    p = tin.plan(2, 211 * 307, 2)                    # a ragged last slice
    assert p["cluster"] > 1 and 211 * 307 % p["slice"]
    assert not tin.plan(3, 1024 * 1024, 2)["resident"]


def _jax(x, relu):
    """JAX's Pallas kernel in interpret mode on NCHW ``x`` (a torch tensor,
    handed over in its dtype); y as f32."""
    xj = jnp.asarray(x.float().numpy().transpose(0, 2, 3, 1),
                     jnp.bfloat16 if x.dtype == torch.bfloat16
                     else jnp.float32)
    y, m, r = jin._instance_norm_fwd_pallas(xj, 1e-5, relu, block=64,
                                            interpret=True)
    return (np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2),
            np.asarray(m).reshape(-1), np.asarray(r).reshape(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,forced", [
    ((2, 8, 12, 10), None),                          # whole rows
    ((1, 4, 33, 31), dict(cluster=4, slice=256)),    # ragged last slice
    ((1, 2, 40, 40), dict(cluster=8, slice=200, piece=64)),  # streamed
])
def test_split_sum_plain_matches_jax(shape, forced, dtype):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0.5, 3, shape).astype(np.float32)).to(
        getattr(torch, dtype))
    b, c, h, w = shape
    p = tin.plan(b * c, h * w, x.element_size())
    if forced:
        p.update(piece=forced["slice"], rows_per_block=1)
        p.update(forced)
    for relu in (False, True):
        y, m, r = tin.split_sum_plain(x, p, 1e-5, relu)
        yj, mj, rj = _jax(x, relu)
        np.testing.assert_allclose(m.reshape(-1).numpy(), mj, atol=1e-5)
        np.testing.assert_allclose(r.reshape(-1).numpy(), rj, rtol=1e-5)
        if dtype == "float32":
            np.testing.assert_allclose(y.numpy(), yj, atol=1e-4, rtol=0)
        else:
            # both round the f32 value to bf16 once: one bf16 step apart
            # at most (the step of |ref|, 2^(floor(log2 |ref|) - 7))
            ref = torch.from_numpy(yj)
            step = torch.exp2(torch.floor(torch.log2(
                ref.abs().clamp(min=2 ** -100))) - 7)
            assert bool(((y.float() - ref).abs() <= step).all())


def test_split_sum_plain_matches_plain():
    """The kernel's partition of the sums changes only their f32
    rounding."""
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0.5, 3, (2, 3, 50, 41)).astype(np.float32))
    p = dict(cluster=4, slice=520, rows_per_block=1, piece=100)
    for got, ref in zip(tin.split_sum_plain(x, p, 1e-5, True),
                        tin.instance_norm_plain(x, 1e-5, True)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-5)


def _bwd_operands(shape, relu, seed=5):
    """x, a g that correlates with the normalised x (so that the
    ``yhat * mean(g' yhat)`` term matters), and the forward's y (when
    ``relu``), mean and rstd."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0.5, 3, shape).astype(np.float32))
    y, m, r = tin.instance_norm_plain(x, 1e-5, relu)
    g = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)) \
        + 0.5 * (x - m) * r
    return g, x, m, r, (y if relu else None)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,forced", [
    ((2, 8, 12, 10), None),                          # whole rows
    ((4, 16, 23, 35), None),                         # several rows a block
    ((1, 4, 33, 31), dict(cluster=4, slice=256)),    # ragged last slice
    ((1, 2, 40, 40), dict(cluster=8, slice=200, piece=64)),  # streamed
])
def test_bwd_split_sum_plain_matches_closed_form(shape, forced, relu):
    """The kernel's partition of the backward's two sums changes only
    their f32 rounding."""
    g, x, m, r, y = _bwd_operands(shape, relu)
    b, c, h, w = shape
    p = tin.plan(b * c, h * w, 4, 3 if relu else 2)
    if forced:
        p.update(piece=forced["slice"], rows_per_block=1)
        p.update(forced)
    got = tin.bwd_split_sum_plain(g, x, m, r, y, p)
    ref = tin.instance_norm_bwd(g, x, m, r, y)
    assert got.dtype == ref.dtype == torch.float32
    scale = float(r.max() * g.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_cpu_autograd_takes_the_closed_form(monkeypatch, relu, dtype):
    """On CPU tensors the backward is :func:`instance_norm_bwd`, bit for
    bit, and no kernel is launched."""
    calls = []
    closed_form = tin.instance_norm_bwd

    def counted(*args):
        calls.append(args)
        return closed_form(*args)
    monkeypatch.setattr(tin, "instance_norm_bwd", counted)
    g, x, m, r, y = _bwd_operands((2, 6, 9, 13), relu)
    g, x = g.to(dtype), x.to(dtype)
    launches = tin.instance_norm.bwd_launches
    xg = x.clone().requires_grad_()
    out, mean, rstd = tin.instance_norm(xg, 1e-5, relu)
    out.backward(g)
    assert len(calls) == 1 and tin.instance_norm.bwd_launches == launches
    want = closed_form(g, x, mean, rstd, out.detach() if relu else None)
    assert xg.grad.dtype == dtype and torch.equal(xg.grad, want)


def test_cpu_backbone_backward_takes_the_closed_form_at_every_norm(
        monkeypatch):
    """GMFlow's backbone: its 15 norms' backward all run the closed form
    on the CPU, 12 of them gated by a fused ReLU."""
    from opticalflowfromdepth_torch.models.gmflow import CNNEncoder
    calls = []
    closed_form = tin.instance_norm_bwd

    def counted(g, x, mean, rstd, y_relu=None):
        calls.append(y_relu is not None)
        return closed_form(g, x, mean, rstd, y_relu)
    monkeypatch.setattr(tin, "instance_norm_bwd", counted)
    torch.manual_seed(0)
    enc = CNNEncoder()
    img = torch.randn(2, 3, 32, 48, requires_grad=True)
    launches = tin.instance_norm.bwd_launches
    enc(img)[0].square().mean().backward()
    assert len(calls) == 15 and sum(calls) == 12
    assert tin.instance_norm.bwd_launches == launches


@pytest.mark.parametrize("relu", [False, True])
def test_double_backward_raises(relu):
    """The backward is once differentiable (the card's kernel returns a dx
    with no graph), so a second derivative raises on every device rather
    than treating dx as a constant."""
    g, x, _, _, _ = _bwd_operands((2, 3, 5, 7), relu)
    xg = x.clone().requires_grad_()
    out = tin.instance_norm(xg, 1e-5, relu)[0]
    (dx,) = torch.autograd.grad(out, xg, g, create_graph=True)
    with pytest.raises(RuntimeError):
        dx.sum().backward()
