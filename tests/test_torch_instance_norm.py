"""The instance-norm kernel's plan and arithmetic on the CPU
(``ops/instance_norm.py``).

The card's kernel (``csrc/instance_norm.cu``) cuts the rows by
:func:`plan`: whole short rows a block, or long rows split across a thread
block cluster whose blocks add their partial f32 sums in rank order. Here
the plan must cover every value of every row exactly once within the
shared-memory cap, and :func:`split_sum_plain`, which repeats the plan's
partition of the sums, is held against the JAX package's Pallas kernel in
interpret mode: f32 within 1e-4, bf16 within one bf16 step. The kernel
itself runs on the card (``chip_smoke.py`` [3b], ``tests/test_torch_cuda.py``).
"""

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


def block_ranges(rows, n, p):
    """Each block's values ``[s, e)`` of the flat ``[rows, n]`` tensor, as
    the kernel derives them from its block index."""
    if p["cluster"] == 1:
        k = p["rows_per_block"]
        return [(r0 * n, min(r0 + k, rows) * n) for r0 in range(0, rows, k)]
    return [(r * n + rank * p["slice"],
             min(r * n + (rank + 1) * p["slice"], (r + 1) * n))
            for r in range(rows) for rank in range(p["cluster"])]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_value_once(shape, itemsize):
    b, c, h, w = shape
    rows, n = b * c, h * w
    p = tin.plan(rows, n, itemsize)
    assert p["cluster"] in tin.CLUSTERS
    assert 1 <= p["rows_per_block"] <= tin.MAX_ROWS
    assert p["cluster"] == 1 or p["rows_per_block"] == 1
    assert p["piece"] * itemsize <= tin.SMEM_CAP
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
