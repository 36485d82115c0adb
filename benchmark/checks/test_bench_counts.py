"""The work counts against hand counts: the kernels' bounds (the
arithmetic of ``chip_smoke.py``), the model FLOPs taken by the FLOP counter
on the meta device, and the shapes the cells' kernels see."""

from __future__ import annotations

import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent)]

from harness import bounds, cell as cell_mod, counts  # noqa: E402

ROOT = HERE.parent.parent


def test_bench_flash_window_flops():
    """One [128, 805, 128] window's forward is 42.5 GFLOP: 2 B L^2 (C + D),
    at the bf16 peak 42.96 us, which bounds it."""
    b, l, c = 128, 805, 128
    assert 2.0 * b * l * l * (c + c) == pytest.approx(42.47e9, rel=1e-3)
    assert bounds.flash_fwd(b, l, l, c, c) == pytest.approx(
        2.0 * b * l * l * 2 * c / 989e12)


def test_bench_flash_bwd_counts():
    """dq: 2 B L^2 (2C + D); dk/dv: 2 B L^2 (2C + 2D); each bound alone."""
    b, l, c, d = 128, 805, 128, 128
    pairs = b * l * l
    want = (2 * pairs * (2 * c + d) + 2 * pairs * (2 * c + 2 * d)) / 989e12
    assert bounds.flash_bwd(b, l, l, c, d) == pytest.approx(want)


def test_bench_matching_bound():
    """At D = 2 the products still bound a call, the exponentials close
    behind (39.7 against 43.6 us at the training matching)."""
    b, l = 16, 3220
    pairs = b * l * l
    assert pairs / bounds.SFU_PER_S < 2 * pairs * 130 / 989e12
    assert bounds.flash_fwd(b, l, l, 128, 2) == pytest.approx(
        2 * pairs * 130 / 989e12)


def test_bench_instance_norm_and_lookup_bytes():
    assert bounds.instance_norm(1000) == pytest.approx(4000 / 3.35e12)
    # the serving lookup: bytes bound it, even with every tap in range
    b, n, c, rows = 8, 55 * 128, 256, 7040 + 1728 + 416 + 96
    taps = b * n * 4 * 81
    nbytes = (b * n * c + b * rows * c + taps) * 2 + b * n * 8
    assert bounds.corr_lookup(b, n, c, rows, 4, 4) == pytest.approx(
        nbytes / 3.35e12)
    assert (2 * c * taps + 10 * taps) / 989e12 < nbytes / 3.35e12


def test_bench_encoder_norms():
    assert counts.stride_out(436, 8) == 55
    assert counts.stride_out(440, 8) == 55
    assert counts.stride_out(1024, 8) == 128
    sizes = counts.encoder_norms(32, 368, 560)
    assert len(sizes) == 15
    assert sizes[0] == 32 * 64 * 184 * 280
    assert sizes[5] == 32 * 96 * 92 * 140
    assert sizes[-1] == 32 * 128 * 46 * 70


def test_bench_meta_flops_by_hand():
    """The FLOP counter on the meta device counts a convolution's forward
    as 2 MACs, and its backward as the weight and input gradients."""
    spec = [("c.weight", (8, 4, 3, 3), "he_normal"), ("c.bias", (8,), "zeros")]

    def make_loss(P, _aux):
        def loss_fn(W, batch, step):
            y = P.conv2d(batch["x"], W["c.weight"], W["c.bias"], 1, 1)
            return y.sum(), {}
        return loss_fn

    fwd = 2 * 2 * 8 * 10 * 10 * 4 * 9
    got = counts.train_flops(spec, [], {"x": (2, 4, 10, 10)}, make_loss)
    assert got == fwd * 2       # forward + weight gradient (x needs none)
    got = counts.infer_flops(
        spec, lambda P, W, x: P.conv2d(x, W["c.weight"], None, 1, 1),
        (2, 4, 10, 10))
    assert got == fwd


@pytest.mark.parametrize("workload", ["gmflow.train-b16",
                                      "raft-basic.infer-b8"])
def test_bench_cell_work(workload):
    """Each cell's work at its own size: model FLOPs in the expected range
    (a GMFlow step about 7.5 TFLOP, a RAFT call of 8 pairs about 10) and
    every kernel op's bound above zero."""
    cell = cell_mod.Cell(ROOT, workload)
    work = cell.glue.work(cell.config, cell.traffic)
    lo, hi = {"gmflow.train-b16": (3e12, 15e12),
              "raft-basic.infer-b8": (5e12, 20e12)}[workload]
    assert lo < work["flops"] < hi, work["flops"]
    assert all(v > 0 for v in work["bounds"].values())
