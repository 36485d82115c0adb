"""GMFlow's transformer in window order against its raster-order form, on
the CPU.

``FeatureTransformer`` keeps the pair's tokens in the order of each
block's windows and gathers them only where the shift changes
(``models/gmflow.py``). The plain version below is the raster-order
transformer it replaced: every layer rolls q, k and v for a shifted
block, splits them into windows, merges the output and rolls it back.
Both run the same modules' parameters through the same flash plain
version, so every per-token op sees the same rows: in f32 the outputs and
the inputs' gradients agree within 1e-6 of max|x| (measured: equal bits,
in bf16 too), and each parameter's gradient, a sum over the tokens that
the two forms take in different orders, within that sum's rounding,
eps sqrt(n) of max|x| (measured: none equal, at most 1.3e-6 of max|x|);
in bf16 everything within one bf16 step of max|x|. The permutations
themselves: each cached index undone by its inverse at the benchmark
cells' shapes, ``gradcheck`` in f64, deterministic backward passes, one
cached tensor per key.
"""

import pytest
import torch

from opticalflowfromdepth_torch.models import gmflow as T
from opticalflowfromdepth_torch.ops.flash import flash_softmax_matmul

torch.set_num_threads(2)

# (h, w, splits): 5x7 windows shifted by (2, 3); 2x3 windows shifted by
# (1, 1)
SHAPES = [(10, 14, 2), (16, 24, 8)]
# the benchmark cells' token grids: GMFlow training at 1/8 (368x560),
# inference at 1/8 (448x1024) and the refinement's 1/4
CELLS = [(46, 70, 2), (56, 128, 2), (112, 256, 8)]
D_MODEL = 32
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the raster-order transformer (the plain version)
# ---------------------------------------------------------------------------

def _plain_window_attention(q, k, v, num_splits, with_shift, h, w):
    b, _, c = q.shape
    wh, ww = h // num_splits, w // num_splits
    q, k, v = (t.reshape(b, h, w, c) for t in (q, k, v))
    if with_shift:
        q, k, v = (torch.roll(t, (-(wh // 2), -(ww // 2)), (1, 2))
                   for t in (q, k, v))
    qs, ks, vs = (T.split_feature(t, num_splits).reshape(-1, wh * ww, c)
                  for t in (q, k, v))
    swin = (num_splits, wh, ww, wh // 2, ww // 2) if with_shift else None
    out = flash_softmax_matmul(qs, ks, vs, swin=swin).to(vs.dtype)
    out = T.merge_splits(out.reshape(-1, wh, ww, c), num_splits)
    if with_shift:
        out = torch.roll(out, (wh // 2, ww // 2), (1, 2))
    return out.reshape(b, h * w, c)


def _plain_layer(layer, source, target, h, w, splits):
    dt = layer.dtype
    q = T._linear(layer.q_proj, source, dt)
    k = T._linear(layer.k_proj, target, dt)
    v = T._linear(layer.v_proj, target, dt)
    if splits > 1:
        message = _plain_window_attention(q, k, v, splits, layer.with_shift,
                                          h, w)
    else:
        message = flash_softmax_matmul(q, k, v).to(v.dtype)
    message = T._layer_norm(layer.norm1, T._linear(layer.merge, message, dt))
    if layer.mlp is not None:
        y = torch.cat([source.to(dt), message], dim=-1)
        y = T._gelu(T._linear(layer.mlp[0], y, dt))
        message = T._layer_norm(layer.norm2, T._linear(layer.mlp[2], y, dt))
    return source + message


def _plain_transformer(model, feature0, feature1, splits):
    b, h, w, c = feature0.shape
    f0 = feature0.reshape(b, h * w, c)
    f1 = feature1.reshape(b, h * w, c)
    concat0 = torch.cat([f0, f1], dim=0)
    concat1 = torch.cat([f1, f0], dim=0)
    for block in model.layers:
        concat0 = _plain_layer(block.self_attn, concat0, concat0, h, w,
                               splits)
        concat0 = _plain_layer(block.cross_attn_ffn, concat0, concat1, h, w,
                               splits)
        half0, half1 = concat0.chunk(2, dim=0)
        concat1 = torch.cat([half1, half0], dim=0)
    f0, f1 = concat0.chunk(2, dim=0)
    return f0.reshape(b, h, w, c), f1.reshape(b, h, w, c)


def _plain_add_position(feature0, feature1, splits, channels):
    f0s = T.split_feature(feature0, splits)
    f1s = T.split_feature(feature1, splits)
    pos = T.position_embedding_sine(f0s.shape[1], f0s.shape[2],
                                    channels // 2)
    return (T.merge_splits(f0s + pos, splits),
            T.merge_splits(f1s + pos, splits))


def _no_roll(*args, **kwargs):
    raise AssertionError("torch.roll called")


def _model(dtype, seed=0):
    torch.manual_seed(seed)
    model = T.FeatureTransformer(6, D_MODEL, 2, dtype=dtype)
    for p in model.parameters():       # LayerNorms away from 1 and 0 too
        p.data.add_(0.1 * torch.randn_like(p))
    return model


def _run(fn, model, f0, f1, probe):
    """fn's outputs and the gradients of a probe loss for the inputs and
    every parameter."""
    model.zero_grad(set_to_none=True)
    x0, x1 = (f.detach().clone().requires_grad_() for f in (f0, f1))
    out = fn(model, x0, x1)
    loss = sum((o.float() * p).sum() for o, p in zip(out, probe))
    loss.backward()
    grads = [x0.grad, x1.grad] + [p.grad for p in model.parameters()]
    return [o.detach() for o in out], grads


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,splits", SHAPES)
def test_window_major_transformer_matches_raster_order(monkeypatch, dtype,
                                                       h, w, splits):
    model = _model(dtype)
    g = torch.Generator().manual_seed(splits)
    f0, f1 = (torch.randn(2, h, w, D_MODEL, generator=g).to(dtype)
              for _ in range(2))
    probe = [torch.randn(2, h, w, D_MODEL, generator=g) for _ in range(2)]
    want, want_g = _run(
        lambda m, a, b: _plain_transformer(m, a, b, splits), model, f0, f1,
        probe)
    monkeypatch.setattr(torch, "roll", _no_roll)
    got, got_g = _run(lambda m, a, b: m(a, b, splits), model, f0, f1, probe)
    names = ["out0", "out1", "feature0", "feature1"] + [
        n for n, _ in model.named_parameters()]
    # f32: 1e-6 of max|x|, and for a parameter's gradient, a sum over the
    # pair's n tokens that the two forms take in different orders, the
    # rounding of such a sum, eps sqrt(n); bf16: one bf16 step of max|x|
    summed = torch.finfo(torch.float32).eps * (4 * h * w) ** 0.5
    for i, (name, a, r) in enumerate(zip(names, got + got_g,
                                         want + want_g)):
        assert a is not None and r is not None, name
        assert a.dtype == r.dtype, name
        if dtype == torch.bfloat16:
            rel = 2.0 ** -7
        else:
            rel = 1e-6 if i < 4 else max(1e-6, summed)
        scale = r.float().abs().max().item()
        err = (a.float() - r.float()).abs().max().item()
        assert err <= rel * scale, (name, err, scale)
    equal = [torch.equal(a, r) for a, r in zip(got + got_g, want + want_g)]
    print(f"{dtype} {h}x{w} splits={splits}: equal bits: outputs and "
          f"input gradients {all(equal[:4])}, parameter gradients "
          f"{sum(equal[4:])} of {len(equal) - 4}")


@pytest.mark.parametrize("splits,calls", [(1, 0), (2, 7), (8, 7)])
def test_reorder_counts_seven_gathers_a_forward(monkeypatch, splits, calls):
    """Entry, the five boundaries where the shift changes, exit; none at
    one split (raster order)."""
    monkeypatch.setattr(torch, "roll", _no_roll)
    model = _model(torch.float32)
    f0, f1 = (torch.randn(1, 16, 24, D_MODEL) for _ in range(2))
    before = T.reorder_tokens.calls
    with torch.no_grad():
        model(f0, f1, splits)
    assert T.reorder_tokens.calls - before == calls


@pytest.mark.parametrize("h,w,splits", SHAPES + [(16, 24, 1)])
def test_position_tile_is_the_window_split_sum(h, w, splits):
    """The cached raster tile gives the split features' f32 sums bit for
    bit (and the whole image's embedding at one split)."""
    g = torch.Generator().manual_seed(5)
    f0, f1 = (torch.randn(2, h, w, D_MODEL, generator=g) for _ in range(2))
    got = T.feature_add_position(f0, f1, splits, D_MODEL)
    if splits > 1:
        want = _plain_add_position(f0, f1, splits, D_MODEL)
    else:
        pos = T.position_embedding_sine(h, w, D_MODEL // 2)
        want = (f0 + pos, f1 + pos)
    for a, r in zip(got, want):
        assert torch.equal(a, r)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("h,w,splits", SHAPES)
def test_layer_keeps_its_raster_contract(monkeypatch, shift, h, w, splits):
    """``TransformerLayer.forward`` and ``_split_window_attention`` on
    raster-order tokens: the plain version's results, and no roll."""
    torch.manual_seed(2)
    layer = T.TransformerLayer(D_MODEL, False, 2, shift)
    src, tgt = (torch.randn(2, h * w, D_MODEL) for _ in range(2))
    want = _plain_layer(layer, src, tgt, h, w, splits)
    q, k, v = (torch.randn(2, h * w, D_MODEL) for _ in range(3))
    want_attn = _plain_window_attention(q, k, v, splits, shift, h, w)
    monkeypatch.setattr(torch, "roll", _no_roll)
    with torch.no_grad():
        got = layer(src, tgt, h, w, splits)
    got_attn = T._split_window_attention(q, k, v, splits, shift, h, w)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    assert (got_attn - want_attn).abs().max() <= \
        1e-6 * want_attn.abs().max()


# ---------------------------------------------------------------------------
# the permutations
# ---------------------------------------------------------------------------

ORDERS = [None, False, True]


@pytest.mark.parametrize("h,w,splits", CELLS)
def test_cached_index_and_its_inverse_compose_to_the_identity(h, w, splits):
    ident = torch.arange(h * w)
    for src in ORDERS:
        for dst in ORDERS:
            index, inverse = T.token_reorder(h, w, splits, src, dst, CPU)
            assert torch.equal(index[inverse], ident)
            assert torch.equal(inverse[index], ident)
            if src == dst:
                assert torch.equal(index, ident)
    # the orders are split_feature's, of the image rolled in the shifted
    # blocks: raster -> window order moves a raster index map that way
    wh, ww = h // splits, w // splits
    img = ident.reshape(1, h, w, 1)
    for shift in (False, True):
        rolled = torch.roll(img, (-(wh // 2), -(ww // 2)), (1, 2)) \
            if shift else img
        want = T.split_feature(rolled, splits).reshape(-1)
        index, _ = T.token_reorder(h, w, splits, None, shift, CPU)
        assert torch.equal(ident[index], want)


@pytest.mark.parametrize("src,dst", [(None, False), (False, True),
                                     (True, False), (True, None)])
def test_reorder_gradcheck_in_f64(src, dst):
    h, w, splits = 10, 14, 2
    x = torch.randn(2, h * w, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda t: T.reorder_tokens(t, h, w, splits, src, dst), (x,))


def test_reorder_backward_is_deterministic():
    h, w, splits = 16, 24, 8
    x = torch.randn(4, h * w, D_MODEL, dtype=torch.bfloat16,
                    requires_grad=True)
    g = torch.randn(4, h * w, D_MODEL, dtype=torch.bfloat16)
    grads = []
    for _ in range(2):
        x.grad = None
        T.reorder_tokens(x, h, w, splits, False, True).backward(g)
        grads.append(x.grad.clone())
    assert torch.equal(grads[0], grads[1])
    # the inverse gather puts each cotangent back where its token came from
    index, _ = T.token_reorder(h, w, splits, False, True, CPU)
    assert torch.equal(grads[0][:, index], g)


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 3), (torch.float32, 5),
                                     (torch.float32, 2)])
def test_gather_by_words_or_elements_is_the_index(dtype, c):
    """Rows of whole 8-byte words (bf16 at C = 128, f32 at C = 2) and rows
    that are not (the element gather) move the same bits as x[:, index];
    so does a transposed input."""
    h, w, splits = 10, 14, 2
    x = torch.randn(4, h * w, c).to(dtype)
    index, _ = T.token_reorder(h, w, splits, None, True, CPU)
    assert torch.equal(T._gather(x, index), x[:, index])
    xt = x.transpose(0, 1).contiguous().transpose(0, 1)
    assert torch.equal(T._gather(xt, index), x[:, index])


def test_cache_returns_the_same_tensors():
    first = T.token_reorder(46, 70, 2, True, None, CPU)
    assert all(a is b for a, b in zip(
        first, T.token_reorder(46, 70, 2, True, None, CPU)))
    tile = T._position_tile(46, 70, 2, D_MODEL, CPU)
    assert T._position_tile(46, 70, 2, D_MODEL, CPU) is tile


def test_tensors_cached_in_inference_mode_serve_training():
    """Inference (``gmflow_infer_fn`` runs in inference mode) may fill the
    caches first; a training step at the same shape then saves and uses
    them."""
    h, w, splits = 12, 18, 2
    model = _model(torch.float32)
    f0, f1 = (torch.randn(1, h, w, D_MODEL) for _ in range(2))
    with torch.inference_mode():
        p0, p1 = T.feature_add_position(f0, f1, splits, D_MODEL)
        model(p0, p1, splits)
    for t in (T._position_tile(h, w, splits, D_MODEL, CPU),
              *T.token_reorder(h, w, splits, None, False, CPU)):
        assert not t.is_inference()
    x0 = f0.clone().requires_grad_()
    p0, p1 = T.feature_add_position(x0, f1, splits, D_MODEL)
    out = model(p0, p1, splits)
    (out[0].sum() + out[1].sum()).backward()
    assert torch.isfinite(x0.grad).all()
