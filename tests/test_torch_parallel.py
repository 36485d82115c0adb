"""The port's sequence-parallel ring and mesh on the CPU, in one process.

``parallel.sequence.ring_softmax_matmul`` over a ``LocalRing`` of n ranks
(run in turn) against the JAX package's ring on its virtual 8-device CPU
mesh (`tests/test_parallel_sequence.py`), within its 2e-5; the ring's
backward against dense autograd; a planted fault in the merge; the Swin
window split against the unsplit windows; sequence-parallel GMFlow against
the unsharded port and against JAX's forward on its (4, 2) mesh; and the
raises. Every step here runs the kernels' plain versions (CPU tensors).
Rings over processes (gloo) are in ``test_torch_distributed.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import opticalflowfromdepth_tpu.models.gmflow as J
from opticalflowfromdepth_tpu.parallel import sequence as jseq
from opticalflowfromdepth_torch.models import gmflow as T
from opticalflowfromdepth_torch.ops.flash import flash_softmax_matmul
from opticalflowfromdepth_torch.parallel import sequence as seq
from opticalflowfromdepth_torch.parallel.mesh import ProcessMesh, make_mesh
from opticalflowfromdepth_torch.train import gmflow_train as gt
from opticalflowfromdepth_torch.weights import gmflow_state_dict_from_flax

torch.set_num_threads(2)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("model",))


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# the ring against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 8])
def test_ring_matches_jax_ring(n):
    """JAX's case (B 2, L 40 = 8 x 5 with 8 ranks, C 16, D 3), and L 43,
    which the port splits 6/6/6/5/... where JAX pads: 2e-5 (JAX's)."""
    rng = np.random.default_rng(0)
    for b, l, c, d in ((2, 40, 16, 3), (2, 43, 16, 3)):
        q, k, v = (_normal(rng, b, l, c), _normal(rng, b, l, c),
                   _normal(rng, b, l, d))
        want = jseq.ring_softmax_matmul(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), _mesh(n))
        got = seq.ring_softmax_matmul(_t(q), _t(k), _t(v), seq.LocalRing(n))
        assert got.dtype == torch.float32 and got.shape == (b, l, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n", [2, 8])
def test_ring_key_mask_matches_jax(n):
    """Masked keys taken out of each batch entry (two entries, different
    masks) against JAX's ring, which masks them in its scores: 2e-5."""
    rng = np.random.default_rng(1)
    b, l, c = 2, 24, 8
    q, k, v = _normal(rng, b, l, c), _normal(rng, b, l, c), _normal(
        rng, b, l, 2)
    mask = (rng.uniform(size=(b, l)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    want = jseq.ring_softmax_matmul(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), _mesh(n),
                                    kmask=jnp.asarray(mask))
    got = seq.ring_softmax_matmul(_t(q), _t(k), _t(v), seq.LocalRing(n),
                                  kmask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_sharded_global_matching_matches_both_packages():
    """Against JAX's ring (2e-5) and against both packages' unsharded f32
    ``global_correlation_softmax`` (2e-4, the JAX test's f32 oracle
    tolerance)."""
    rng = np.random.default_rng(2)
    f0, f1 = _normal(rng, 2, 6, 10, 32), _normal(rng, 2, 6, 10, 32)
    got, none = seq.sharded_global_matching(_t(f0), _t(f1), seq.LocalRing(8))
    assert none is None and got.shape == (2, 6, 10, 2)
    want, _ = jseq.sharded_global_matching(jnp.asarray(f0), jnp.asarray(f1),
                                           _mesh(8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    for ref in (np.asarray(J.global_correlation_softmax(
            jnp.asarray(f0), jnp.asarray(f1))[0]),
            T.global_correlation_softmax(_t(f0), _t(f1))[0].numpy()):
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    # the model's function takes the ring with a group, bidirectional too
    both, _ = T.global_correlation_softmax(_t(f0), _t(f1), True,
                                           group=seq.LocalRing(3))
    back, _ = seq.sharded_global_matching(_t(f1), _t(f0), seq.LocalRing(3))
    assert both.shape == (4, 6, 10, 2)
    torch.testing.assert_close(both[2:], back, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the ring's backward
# ---------------------------------------------------------------------------

def _dense(q, k, v):
    s = torch.matmul(q, k.transpose(1, 2)) / q.shape[2] ** 0.5
    return torch.matmul(torch.softmax(s, -1), v)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("shape", [(2, 40, 40, 16, 3), (1, 37, 29, 32, 2)],
                         ids=["even", "ragged"])
def test_ring_gradients_match_dense_autograd(n, shape):
    """dq, dk and dv of the ring's own backward (the accumulators going
    round) against autograd through a dense softmax: 2e-6 of each
    gradient's largest entry (they reach 5e-7), and the output 1e-6."""
    b, lq, lk, c, d = shape
    rng = np.random.default_rng(3)
    x = [_normal(rng, b, lq, c), _normal(rng, b, lk, c),
         _normal(rng, b, lk, d)]
    g = _t(_normal(rng, b, lq, d))
    ours = [_t(a, True) for a in x]
    dense = [_t(a, True) for a in x]
    out = seq.ring_softmax_matmul(*ours, seq.LocalRing(n))
    ref = _dense(*dense)
    out.backward(g)
    ref.backward(g)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    for name, a, r in zip("qkv", ours, dense):
        err = float((a.grad - r.grad).abs().max() / r.grad.abs().max())
        assert err <= 2e-6, (name, err)


def test_ring_backward_is_needed():
    """Autograd through the ring's steps merged by their LSEs, with the
    flash Function's LSE not differentiable, gets dq and dk wrong: the
    reason for the ring's own backward."""
    rng = np.random.default_rng(4)
    q, k, v = (_t(_normal(rng, 1, 16, 16), True) for _ in range(3))
    halves = [flash_softmax_matmul(q, k[:, s], v[:, s], with_lse=True)
              for s in (slice(0, 8), slice(8, 16))]
    out, _ = seq.merge_step(*halves[0], *halves[1])
    out.sum().backward()
    naive = q.grad.clone()
    q.grad = None
    _dense(q, k, v).sum().backward()
    assert float((naive - q.grad).abs().max()) > 1e-3


def test_merge_fault_is_caught(monkeypatch):
    """A merge that drops one step's LSE correction (the planted fault of
    the card's check) moves the output far past the 2e-5 tolerance."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(_normal(rng, 2, 40, 16)) for _ in range(3))
    ref = seq.ring_softmax_matmul(q, k, v, seq.LocalRing(4))
    merge = seq.merge_step

    def faulty(out, lse, out_s, lse_s):
        new_out, new = merge(out, lse, out_s, lse_s)
        return new_out + out_s * (1 - torch.exp(lse_s - new))[..., None], new
    monkeypatch.setattr(seq, "merge_step", faulty)
    bad = seq.ring_softmax_matmul(q, k, v, seq.LocalRing(4))
    assert float((bad - ref).abs().max()) > 1e-2


def test_ring_raises_where_tokens_are_fewer_than_ranks():
    q = torch.zeros(1, 3, 16)
    with pytest.raises(ValueError, match="at least 4 tokens"):
        seq.ring_softmax_matmul(q, q, torch.zeros(1, 3, 2), seq.LocalRing(4))
    mask = torch.tensor([[1.0, 0.0, 0.0, 1.0, 0.0]])
    q = torch.zeros(1, 5, 16)
    with pytest.raises(ValueError, match="at least 3 tokens"):
        seq.ring_softmax_matmul(q, q, torch.zeros(1, 5, 2), seq.LocalRing(3),
                                kmask=mask)


def test_token_shards_and_matching_rows():
    assert seq.token_shards(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert seq.token_shards(8, 8) == [(i, i + 1) for i in range(8)]
    got = [tuple(t.shape[1] for t in torch.tensor_split(
        torch.zeros(1, 43), 8, dim=1))]
    assert got == [tuple(b - a for a, b in seq.token_shards(43, 8))]
    # 6x10 tokens over 4 ranks: 15 each, rows 0-1, 1-2, 3-4, 4-5
    assert seq.matching_rows(6, 10, 4) == [slice(0, 2), slice(1, 3),
                                           slice(3, 5), slice(4, 6)]
    assert seq.matching_rows(8, 10, 2) == [slice(0, 4), slice(4, 8)]


# ---------------------------------------------------------------------------
# Swin windows split over the group
# ---------------------------------------------------------------------------

def test_window_shards_follows_jax():
    """``window_shards`` takes what JAX's ``_window_shard_axes`` takes on a
    mesh of as many devices as the group has ranks."""
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                ("data", "model"))
    for batch, windows, shift in ((8, 32, True), (4, 16, True),
                                  (4, 16, False), (1, 4, False),
                                  (16, 64, True), (2, 8, False)):
        want = J._window_shard_axes(mesh, batch, windows, shift) is not None
        assert seq.window_shards(seq.LocalRing(8), batch, windows,
                                 shift) == want
    assert not seq.window_shards(None, 8, 32, True)
    assert not seq.window_shards(seq.LocalRing(1), 8, 32, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [False, True])
def test_split_windows_match_unsplit(dtype, shift):
    """Windows split over 2 ranks (with a shift, whole images' windows a
    rank) give the unsplit flash call's outputs and gradients bit for
    bit: the windows are independent batch entries."""
    rng = np.random.default_rng(6)
    b, h, w, c = 4, 8, 12, 16
    x = [_normal(rng, b, h * w, c) for _ in range(4)]
    grads = []
    for group in (None, seq.LocalRing(2)):
        q, k, v = (_t(a).to(dtype).requires_grad_() for a in x[:3])
        out = T._split_window_attention(q, k, v, 2, shift, h, w, group)
        out.float().backward(_t(x[3]))
        grads.append([out.detach()] + [t.grad for t in (q, k, v)])
    for a, r in zip(*grads):
        assert torch.equal(a, r)


# ---------------------------------------------------------------------------
# sequence-parallel GMFlow
# ---------------------------------------------------------------------------

def _images(b=2, h=32, w=48):
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_gmflow():
    img0, img1 = (jnp.asarray(a) for a in _images())
    model = J.GMFlow(num_scales=1)
    v = jax.jit(lambda r: model.init(r, img0, img1, attn_splits_list=(2,),
                                     corr_radius_list=(-1,),
                                     prop_radius_list=(-1,)))(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, v)


def _port_gmflow(group):
    model = T.GMFlow(group=group)
    model.load_state_dict(gmflow_state_dict_from_flax(
        _jax_gmflow()["params"], 1), strict=True)
    return model.eval()


@pytest.mark.parametrize("splits", [1, 2])
def test_gmflow_sequence_parallel_matches_unsharded_and_jax(splits):
    """The port's GMFlow split over ``LocalRing(2)`` (the ring for
    matching, propagation and, at splits 1, full attention; the windows
    split at 2) against the unsharded port within JAX's own tolerance for
    its sharded model (atol 5e-3 px, rtol 1e-3), and against JAX's forward
    on its (4, 2) mesh within the port's whole-model tolerance against
    JAX (2e-2 px, ``test_torch_gmflow.py``)."""
    img0, img1 = _images()
    recipe = dict(attn_splits_list=(splits,), corr_radius_list=(-1,),
                  prop_radius_list=(-1,), training=False)
    with torch.no_grad():
        t0, t1 = (_t(a).permute(0, 3, 1, 2) for a in (img0, img1))
        ref = _port_gmflow(None)(t0, t1, **recipe)["flow_preds"][-1]
        got = _port_gmflow(seq.LocalRing(2))(t0, t1, **recipe)[
            "flow_preds"][-1]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-3,
                               rtol=1e-3)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                ("data", "model"))
    sp = J.GMFlow(num_scales=1, mesh=mesh)
    with mesh:
        want = jax.jit(lambda v, a, b: sp.apply(v, a, b, **recipe)[
            "flow_preds"][-1])(_jax_gmflow(), jnp.asarray(img0),
                               jnp.asarray(img1))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# the mesh and the raise
# ---------------------------------------------------------------------------

SMALL = dict(batch_size=2, image_size=(32, 48), mixed_precision=False,
             num_transformer_layers=2, num_steps=10)


def test_model_parallel_without_a_group_raises():
    cfg = gt.GMFlowTrainConfig(model_parallel=2, **SMALL)
    with pytest.raises(ValueError, match="model_parallel=2"):
        gt.build_model(cfg)
    with pytest.raises(ValueError, match="model_parallel=2"):
        gt.init_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="model_parallel=2"):
        gt.init_state(cfg, device="cpu", mesh=ProcessMesh.local(4))
    with pytest.raises(ValueError, match="model_parallel=2"):
        make_mesh(2)
    mesh = make_mesh()
    assert (mesh.world, mesh.data_world, mesh.model_parallel,
            mesh.distributed) == (1, 1, 1, False)
    with pytest.raises(ValueError, match="model_parallel=2"):
        gt.init_state(cfg, device="cpu", mesh=mesh)


def test_model_parallel_step_with_a_local_ring():
    """``GMFlowTrainConfig(model_parallel=2)`` builds over
    ``ProcessMesh.local(2)`` and steps: every ring layer holds the group;
    against the unsharded step, the loss within 1e-5 relative and the raw
    gradients within 1e-5 of their global norm (they reach ~1e-6); the
    parameters within two first Adam updates (2 lr/25: a gradient within
    rounding of 0 may take the other sign)."""
    cfg = gt.GMFlowTrainConfig(model_parallel=2, **SMALL)
    state = gt.init_state(cfg, seed=3, device="cpu",
                          mesh=ProcessMesh.local(2))
    rings = [m for m in state.model.modules() if getattr(m, "group", None)]
    assert rings and all(isinstance(m.group, seq.LocalRing) for m in rings)
    ref = gt.init_state(gt.GMFlowTrainConfig(**SMALL), seed=3, device="cpu")
    img0, img1 = _images()
    rng = np.random.default_rng(7)
    batch = dict(image1=_t(img0).permute(0, 3, 1, 2),
                 image2=_t(img1).permute(0, 3, 1, 2),
                 flow=_t(_normal(rng, 2, 2, 32, 48)),
                 valid=torch.ones(2, 32, 48), label=torch.eye(4)[:2])
    losses, grads = [], []
    for st, c in ((state, cfg), (ref, gt.GMFlowTrainConfig(**SMALL))):
        grads.append(None)
        adam_step = st.optimizer.step

        def keep(st=st, adam_step=adam_step):
            grads[-1] = [g.clone() for g in st.optimizer.grads()]
            return adam_step()
        st.optimizer.step = keep
        st, m = gt.make_train_step(c, device="cpu")(st, batch)
        losses.append(float(m["total_loss"]))
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in grads[1])))
    err = max(float((a - b).abs().max()) for a, b in zip(*grads)) / norm
    assert norm > 0 and err <= 1e-5, err
    with torch.no_grad():
        diff = max(float((a - b).abs().max()) for a, b in zip(
            state.model.parameters(), ref.model.parameters()))
    assert diff <= 2 * cfg.lr / 25, diff
