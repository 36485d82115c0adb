"""The transformer's epilogues (``ops/token_epilogue.py``) on the CPU: the
op's CPU path is the op-by-op form bit for bit, the op refuses a graph
that autograd records, the transformer layer takes the op where autograd
records nothing and the op-by-op form where it records, the counters
count each call, and GMFlow's forward and training step are what they
were. The kernels themselves run on the card
(``tests/test_torch_cuda.py``)."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from opticalflowfromdepth_torch.data.loader import to_device
from opticalflowfromdepth_torch.models import gmflow as T
from opticalflowfromdepth_torch.ops import token_epilogue as te
from opticalflowfromdepth_torch.train import gmflow_train as gt
from test_torch_window_order import _plain_layer

torch.set_num_threads(2)
DTYPES = [torch.float32, torch.bfloat16]


def _counts():
    return (te.token_norm.launches, te.token_norm.plain, te.gelu.launches,
            te.gelu.plain)


def _delta(before):
    return tuple(a - b for a, b in zip(_counts(), before))


def _norm_module(c, seed=0):
    torch.manual_seed(seed)
    norm = torch.nn.LayerNorm(c, eps=1e-5)
    with torch.no_grad():                # away from 1 and 0
        norm.weight.add_(0.1 * torch.randn(c))
        norm.bias.add_(0.1 * torch.randn(c))
    return norm


def _op_by_op_norm(x, weight, bias, eps, residual=None):
    y = F.layer_norm(x.float(), (x.shape[-1],), weight, bias,
                     eps).to(x.dtype)
    return y if residual is None else residual + y


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_norm_plan_covers_every_vector_of_a_row(itemsize):
    """Every C the kernel takes (a multiple of 8 up to 512): a power of two
    of lanes up to a warp, 1, 2 or 4 vectors a lane (more than one only
    on a whole warp), every 16-byte vector of the row covered with less
    than a lane's share to spare, a resident grid; the rest refused."""
    for c in range(8, te.MAX_C + 1, 8):
        vecs = c * itemsize // 16
        log2_lanes, vpl, blocks = te.plan(1 << 20, c, itemsize, 132)
        lanes = 1 << log2_lanes
        assert lanes <= 32 and vpl in (1, 2, 4)
        assert vpl == 1 or lanes == 32
        assert vecs <= vpl * lanes < 2 * vecs + 32, c
        per_sm = te._norm_blocks_per_sm(vpl * 16 // itemsize)
        assert blocks == 132 * per_sm
        assert te.plan(3, c, itemsize, 132)[2] == 1
    for c in (0, 4, 100, 513, 520, 1024):
        assert te.plan(64, c, itemsize, 132) is None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("c", [8, 128, 200])
def test_cpu_token_norm_is_the_models_layer_norm_bit_for_bit(dtype,
                                                             with_residual,
                                                             c):
    norm = _norm_module(c)
    g = torch.Generator().manual_seed(c)
    x = (3 * torch.randn(5, 7, c, generator=g) + 1).to(dtype)
    res = torch.randn(5, 7, c, generator=g).to(dtype) if with_residual \
        else None
    want = _op_by_op_norm(x, norm.weight, norm.bias, norm.eps, res)
    if not with_residual:
        assert torch.equal(_bits(T._layer_norm(norm, x)), _bits(want))
    with torch.inference_mode():
        before = _counts()
        got = te.token_norm(x, norm.weight, norm.bias, norm.eps, res)
        assert _delta(before) == (0, 1, 0, 0)
    assert got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(te.token_norm_plain(
        x, norm.weight, norm.bias, norm.eps, res)), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_gelu_is_the_models_gelu_bit_for_bit(dtype):
    if dtype == torch.bfloat16:          # every bf16 pattern, NaN and inf
        x = torch.arange(-32768, 32768, dtype=torch.int32).to(
            torch.int16).view(torch.bfloat16)
    else:
        g = torch.Generator().manual_seed(1)
        x = torch.cat([4 * torch.randn(50000, generator=g),
                       torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                                     float("nan"), 1e-40, -30.0, 30.0])])
    half_sqrt = float(torch.tensor(0.5 ** 0.5, dtype=dtype))
    want = 0.5 * x * torch.erfc(x * -half_sqrt)
    assert torch.equal(_bits(T._gelu(x)), _bits(want))
    with torch.no_grad():
        before = _counts()
        got = te.gelu(x)
        assert _delta(before) == (0, 0, 0, 1)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(te.gelu_plain(x)), _bits(want))


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad",
                                  "nothing_requires_grad", "input_grad",
                                  "parameter_grad"])
def test_dispatch_follows_what_autograd_records(mode):
    """Where autograd records nothing the layer takes the op, one pass
    each; where it records, the op refuses the operands (its kernels have
    no backward) and the layer runs the op-by-op forms, with a graph that
    carries the gradient."""
    torch.manual_seed(0)
    layer = T.TransformerLayer(16, False, 2, with_shift=False,
                               dtype=torch.bfloat16)
    norm = layer.norm1
    x = torch.randn(2, 12, 16).to(torch.bfloat16)
    res = torch.randn(2, 12, 16).to(torch.bfloat16)
    records = mode in ("input_grad", "parameter_grad")
    if mode == "input_grad":
        x.requires_grad_()
        layer.requires_grad_(False)
    elif mode == "nothing_requires_grad":
        layer.requires_grad_(False)
    ctx = {"inference_mode": torch.inference_mode(),
           "no_grad": torch.no_grad()}.get(mode, torch.enable_grad())
    before = _counts()
    with ctx:
        assert te.records_graph(x, norm.weight) == records
        if records:
            with pytest.raises(ValueError, match="records a graph"):
                te.token_norm(x, norm.weight, norm.bias, norm.eps, res)
            if mode == "input_grad":
                with pytest.raises(ValueError, match="records a graph"):
                    te.gelu(x * 2)
        y = layer(x, x, 3, 4, 1)
    assert _delta(before) == ((0, 0, 0, 0) if records else (0, 2, 0, 1))
    assert y.requires_grad == records
    if records:
        y.float().sum().backward()
        leaf = x if mode == "input_grad" else norm.weight
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("no_ffn", [True, False])
@pytest.mark.parametrize("splits", [1, 2])
def test_windowed_under_no_grad_is_the_op_by_op_layer(dtype, no_ffn, splits):
    torch.manual_seed(0)
    layer = T.TransformerLayer(32, no_ffn, 2, with_shift=True, dtype=dtype)
    for p in layer.parameters():
        p.data.add_(0.1 * torch.randn_like(p))
    h, w = 10, 14
    g = torch.Generator().manual_seed(2)
    src, tgt = (torch.randn(2, h * w, 32, generator=g).to(dtype)
                for _ in range(2))
    with torch.no_grad():
        want = _plain_layer(layer, src, tgt, h, w, splits)
        before = _counts()
        got = layer(src, tgt, h, w, splits)      # windowed, in its order
        assert _delta(before) == ((0, 1, 0, 0) if no_ffn else (0, 2, 0, 1))
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("num_scales,norms,gelus", [(1, 18, 6), (2, 36, 12)])
def test_gmflow_forward_counts_every_epilogue_fused(num_scales, norms,
                                                    gelus):
    """A bf16 GMFlow forward at 64x96 under inference mode: 3 norms and a
    GELU a block, 6 blocks a scale, every one through the op (on the CPU
    its plain path; on the card its launches)."""
    recipe = {1: ((2,), (-1,), (-1,)), 2: ((2, 8), (-1, 4), (-1, 1))}
    model = T.GMFlow(num_scales=num_scales,
                     upsample_factor=8 if num_scales == 1 else 4,
                     dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    i1, i2 = (torch.rand(1, 3, 64, 96, generator=g) * 255 for _ in range(2))
    with torch.inference_mode():
        before = _counts()
        model(i1, i2, *recipe[num_scales], training=False)
    assert _delta(before) == (0, norms, 0, gelus)


def test_training_step_is_unchanged():
    """A bf16 GMFlow training step records a graph through every epilogue:
    none calls the op (which would refuse it), and the step's metrics and
    updated parameters are those of the op-by-op forms, bit for bit."""
    cfg = gt.GMFlowTrainConfig(batch_size=2, image_size=(64, 96),
                               num_transformer_layers=1, num_steps=10)
    rng = np.random.default_rng(5)
    low = torch.from_numpy(rng.uniform(0, 255, (4, 3, 8, 12)).astype(
        np.float32))
    img = F.interpolate(low, size=(64, 96), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    batch = dict(image1=np.ascontiguousarray(img[:2]),
                 image2=np.ascontiguousarray(img[2:]),
                 flow=rng.normal(0, 3, (2, 64, 96, 2)).astype(np.float32),
                 valid=np.ones((2, 64, 96), np.float32),
                 label=np.eye(4, dtype=np.float32)[[0, 2]])
    step = gt.make_train_step(cfg, device="cpu")
    runs = []
    for patched in (False, True):
        state = gt.init_state(cfg, seed=4, device="cpu")
        mp = pytest.MonkeyPatch()
        if patched:
            mp.setattr(T, "token_norm", _op_by_op_norm)
            mp.setattr(T, "gelu", T._gelu)
        before = _counts()
        try:
            state, metrics = step(state, to_device(copy.deepcopy(batch),
                                                   "cpu"))
        finally:
            mp.undo()
        runs.append((_delta(before), metrics,
                     {k: v.clone() for k, v in
                      state.model.state_dict().items()}))
    (counts, m0, p0), (_, m1, p1) = runs
    assert counts == (0, 0, 0, 0)
    for k in m0:
        assert torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k])), k
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
