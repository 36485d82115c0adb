"""Sequence-parallel global matching: a ring of streaming-softmax steps
over a model group (port of ``opticalflowfromdepth_tpu/parallel/
sequence.py``).

``ring_softmax_matmul(q, k, v, group)`` computes ``softmax(q k^T /
sqrt(C)) v`` with the token axis split over the ``n`` ranks of ``group``:
rank r takes its slice of the queries and of the keys, and in n steps
meets every key slice, which moves one rank along the ring after each
step. A step is one ``ops.flash.flash_softmax_matmul(q_r, k_s, v_s,
with_lse=True)`` (the CUDA kernel on the card); the steps are merged by
their log-sum-exps in f32 (:func:`merge_step`). The rank's output slice
is then all-gathered, so every rank returns the whole ``[B, L, D]`` f32,
as the JAX function returns a global array.

The backward is its own ``autograd.Function`` (the flash Function's LSE
is not differentiable, so autograd through the merged steps would be
wrong): each rank keeps its queries, its merged output and LSE and its
slice of the output gradient; the key slices go round the ring again,
each with its dk / dv accumulator beside it; a step is one
``ops.flash_bwd.flash_backward`` from the merged output and LSE (the dq
and the dk/dv kernels on the card). After n steps every accumulator is
back with its slice's owner, and dq, dk and dv are all-gathered, so every
rank returns the whole gradients.

L is split into ``torch.tensor_split`` slices (lengths differ by at most
one) instead of being padded: the flash kernel has no key mask, and
unequal slices need none. A key mask ``kmask`` takes the masked keys out
of each batch entry before its ring. ``L < n`` raises.

Two transports run the same ring body: a process group (one rank per
process; a slice is sent to rank + 1 and received from rank - 1 by
``batch_isend_irecv``, posted before the step's launch and waited after
it), and :class:`LocalRing` (the n ranks run in turn in one process, on
one device). Nothing chooses a ``LocalRing`` for the caller.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.geometry import pixel_grid
from ..ops import flash, flash_bwd


class LocalRing:
    """A model group of ``size`` ranks that run in turn in this process:
    the counterpart of the JAX tests' virtual devices, and on one card the
    only way to run a ring of more than one rank."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"LocalRing size must be >= 1, got {size}")
        self.size = size

    def __repr__(self) -> str:
        return f"LocalRing({self.size})"


def group_size(group) -> int:
    """Ranks in ``group``: None is this process alone."""
    if group is None:
        return 1
    if isinstance(group, LocalRing):
        return group.size
    return dist.get_world_size(group)


def token_shards(length: int, n: int) -> List[Tuple[int, int]]:
    """``[start, stop)`` of each rank's tokens: ``torch.tensor_split``'s
    slices of ``length`` into ``n`` (the first ``length % n`` one longer).
    Raises where ``length < n``."""
    if length < n:
        raise ValueError(f"a ring of {n} ranks needs at least {n} tokens, "
                         f"got {length}")
    base, extra = divmod(length, n)
    bounds, start = [], 0
    for r in range(n):
        stop = start + base + (r < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def matching_rows(h: int, w: int, n: int) -> List[slice]:
    """The image rows of an ``h x w`` feature map that each rank's query
    tokens fall in (rows are split where a slice ends inside one): how a
    caller lays out inputs so that each rank reads only its rows (the JAX
    ``matching_shardings``, which puts the H axis on the model axis)."""
    return [slice(start // w, -(-stop // w))
            for start, stop in token_shards(h * w, n)]


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class _Pending:
    """A posted exchange; ``wait()`` returns what each of this process's
    ranks received."""

    def __init__(self, works, received):
        self.works, self.received = works, received

    def wait(self):
        for w in self.works:
            w.wait()
        return self.received


class _Local:
    """All ``n`` ranks in this process: slot i is rank i."""

    def __init__(self, n: int):
        self.size = n
        self.ranks = list(range(n))

    def shift(self, payloads, lengths):
        # rank r receives what rank r - 1 sent
        return _Pending((), payloads[-1:] + payloads[:-1])

    def gather(self, parts, dim, lengths):
        return torch.cat(parts, dim)


class _Group:
    """One rank of a process group in this process (slot 0)."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = [self.rank]
        self.next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self.prev = dist.get_global_rank(group, (self.rank - 1) % self.size)

    def shift(self, payloads, lengths):
        """Sends slot 0's tensors ``[B, L, X]`` to rank + 1 and receives
        rank - 1's, of ``lengths[0]`` tokens, without waiting."""
        send = payloads[0]
        recv = tuple(t.new_empty((t.shape[0], lengths[0]) + t.shape[2:])
                     for t in send)
        ops = [dist.P2POp(dist.isend, t, self.next, self.group)
               for t in send] + [dist.P2POp(dist.irecv, t, self.prev,
                                            self.group) for t in recv]
        return _Pending(dist.batch_isend_irecv(ops), [recv])

    def gather(self, parts, dim, lengths):
        """Every rank's slice along ``dim``, of ``lengths[r]`` for rank r
        (each padded to the longest for the all-gather, then cut)."""
        part = parts[0]
        pad = list(part.shape)
        pad[dim] = max(lengths) - part.shape[dim]
        padded = torch.cat([part, part.new_zeros(pad)], dim) \
            if pad[dim] else part.contiguous()
        bufs = [torch.empty_like(padded) for _ in range(self.size)]
        dist.all_gather(bufs, padded, group=self.group)
        return torch.cat([b.narrow(dim, 0, n) for b, n in
                          zip(bufs, lengths)], dim)


def _transport(group):
    if isinstance(group, LocalRing):
        return _Local(group.size)
    if group is None:
        return _Local(1)
    return _Group(group)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

class Steps(NamedTuple):
    """A step's forward ``(q, k, v, scale, swin) -> (out, lse)`` and
    backward ``(q, k, v, out, lse, g, scale, swin) -> (dq, dk, dv)``."""
    forward: Callable
    backward: Callable


# the flash wrappers (the kernels on the card), and their plain versions;
# looked up at the call, as the flash modules hold them
KERNELS = Steps(
    lambda q, k, v, scale, swin: flash.flash_softmax_matmul(
        q, k, v, scale, swin, with_lse=True),
    lambda *args: flash_bwd.flash_backward(*args))
PLAIN = Steps(
    lambda q, k, v, scale, swin: flash.flash_softmax_matmul_plain(
        q, k, v, scale, swin, with_lse=True),
    lambda *args: flash_bwd.flash_backward_plain(*args))


def merge_step(out: torch.Tensor, lse: torch.Tensor, out_s: torch.Tensor,
               lse_s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two streaming-softmax partials over disjoint keys, merged in f32:
    ``lse' = log(e^lse + e^lse_s)``, ``out' = out e^(lse - lse') + out_s
    e^(lse_s - lse')``. out ``[B, L, D]``, lse ``[B, L]``."""
    new = torch.logaddexp(lse, lse_s)
    return (out * torch.exp(lse - new)[..., None]
            + out_s * torch.exp(lse_s - new)[..., None]), new


def _lengths(bounds):
    return [stop - start for start, stop in bounds]


def _ring_forward(tr, q, k, v, qb, kb, scale, steps):
    """Every step of this process's ranks; returns their query slices and
    merged outputs and LSEs."""
    n, klen = tr.size, _lengths(kb)
    qs = [q[:, slice(*qb[r])] for r in tr.ranks]
    kv = [(k[:, slice(*kb[r])].contiguous(), v[:, slice(*kb[r])].contiguous())
          for r in tr.ranks]
    outs, lses = [None] * len(qs), [None] * len(qs)
    for s in range(n):
        pending = tr.shift(kv, [klen[(r - s - 1) % n] for r in tr.ranks]) \
            if s + 1 < n else None
        for i, q_r in enumerate(qs):
            o, l = steps.forward(q_r, kv[i][0], kv[i][1], scale, None)
            outs[i], lses[i] = (o, l) if s == 0 else merge_step(
                outs[i], lses[i], o, l)
        if pending is not None:
            kv = pending.wait()
    return qs, outs, lses



def _ring_backward(tr, qs, k, v, kb, outs, lses, gs, scale, steps):
    """The backward ring: this process's ranks' dq slices, and the dk / dv
    accumulators of their own key slices after they went round."""
    n, klen = tr.size, _lengths(kb)
    kv = [(k[:, slice(*kb[r])].contiguous(), v[:, slice(*kb[r])].contiguous())
          for r in tr.ranks]
    dq, acc, moved = [None] * len(qs), [None] * len(qs), None
    for s in range(n):
        incoming = [klen[(r - s - 1) % n] for r in tr.ranks]
        pending = tr.shift(kv, incoming) if s + 1 < n else None
        grads = [steps.backward(q_r, kv[i][0], kv[i][1], outs[i], lses[i],
                                gs[i], scale, None)
                 for i, q_r in enumerate(qs)]
        if moved is not None:         # the accumulators of this step's slices
            acc = moved.wait()
        for i, (g_q, g_k, g_v) in enumerate(grads):
            dq[i] = g_q if s == 0 else dq[i] + g_q
            acc[i] = (g_k, g_v) if s == 0 else (acc[i][0] + g_k,
                                                acc[i][1] + g_v)
        # each accumulator follows its slice; after step n - 1 this takes
        # it home
        moved = tr.shift(acc, incoming)
        if pending is not None:
            kv = pending.wait()
    return dq, moved.wait()


class _RingFunction(torch.autograd.Function):
    """The ring's forward and its backward ring (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group, steps):
        tr = _transport(group)
        qb, kb = token_shards(q.shape[1], tr.size), token_shards(
            k.shape[1], tr.size)
        scale = 1.0 / math.sqrt(q.shape[2])
        qs, outs, lses = _ring_forward(tr, q, k, v, qb, kb, scale, steps)
        ctx.save_for_backward(k, v, *qs, *outs, *lses)
        ctx.ring = (tr, qb, kb, scale, steps, len(qs))
        return tr.gather(outs, 1, _lengths(qb))

    @staticmethod
    def backward(ctx, g):
        tr, qb, kb, scale, steps, m = ctx.ring
        k, v, *rest = ctx.saved_tensors
        qs, outs, lses = rest[:m], rest[m:2 * m], rest[2 * m:]
        gs = [g[:, slice(*qb[r])] for r in tr.ranks]
        dq, acc = _ring_backward(tr, qs, k, v, kb, outs, lses, gs, scale,
                                 steps)
        qlen, klen = _lengths(qb), _lengths(kb)
        dq = tr.gather(dq, 1, qlen).to(qs[0].dtype)
        dk = tr.gather([a[0] for a in acc], 1, klen).to(k.dtype)
        dv = tr.gather([a[1] for a in acc], 1, klen).to(v.dtype)
        return dq, dk, dv, None, None


def _check(q, k, v, kmask):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 \
            or k.shape[0] != q.shape[0] or v.shape[:2] != k.shape[:2] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"ring_softmax_matmul: q [B, Lq, C], k [B, Lk, C], "
                         f"v [B, Lk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if kmask is not None and kmask.shape != k.shape[:2]:
        raise ValueError(f"ring_softmax_matmul: kmask [B, Lk], got "
                         f"{tuple(kmask.shape)}")


def _ring(q, k, v, group, kmask, steps):
    _check(q, k, v, kmask)
    if kmask is None:
        return _RingFunction.apply(q, k, v, group, steps)
    # each batch entry's ring over its unmasked keys only
    outs = []
    for b in range(q.shape[0]):
        keep = torch.nonzero(kmask[b] > 0)[:, 0]
        outs.append(_RingFunction.apply(q[b:b + 1], k[b:b + 1, keep],
                                        v[b:b + 1, keep], group, steps))
    return torch.cat(outs, 0)


def ring_softmax_matmul(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        group, kmask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``softmax(q k^T / sqrt(C)) v`` with the token axis split over the
    ranks of ``group`` (a process group, a ``LocalRing``, or None for one
    rank). q ``[B, Lq, C]``, k ``[B, Lk, C]``, v ``[B, Lk, D]``, the same on
    every rank; ``kmask`` ``[B, Lk]`` (> 0: a real key). Returns ``[B, Lq,
    D]`` f32, the same on every rank; differentiable in q, k and v, whose
    gradients are the same on every rank too. Operands as the flash kernel
    takes them (f32 or bf16, C % 16 == 0 up to 128, D == 2 or a multiple of
    16); ``Lq`` or a batch entry's unmasked ``Lk`` under the group's size
    raises."""
    return _ring(q, k, v, group, kmask, KERNELS)


def ring_softmax_matmul_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, group,
                              kmask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The same ring, forward and backward, with the kernels' plain
    versions as its steps, on any device."""
    return _ring(q, k, v, group, kmask, PLAIN)


def sharded_global_matching(feature0: torch.Tensor, feature1: torch.Tensor,
                            group) -> Tuple[torch.Tensor, None]:
    """Sequence-parallel ``models.gmflow.global_correlation_softmax``:
    features ``[B, H, W, C]``, cast to f32, matched by the ring with the
    pixel grid as the payload. Returns (flow ``[B, H, W, 2]`` f32, None)."""
    b, h, w, c = feature0.shape
    grid = pixel_grid(h, w, device=feature0.device).permute(1, 2, 0)
    gv = grid.reshape(1, h * w, 2).expand(b, h * w, 2)
    corr = ring_softmax_matmul(feature0.reshape(b, h * w, c).float(),
                               feature1.reshape(b, h * w, c).float(), gv,
                               group)
    return corr.reshape(b, h, w, 2) - grid[None], None


# ---------------------------------------------------------------------------
# Swin windows split over the group
# ---------------------------------------------------------------------------

def window_shards(group, batch: int, num_windows: int,
                  with_shift: bool) -> bool:
    """Whether a window attention's batch of windows splits over the
    group's ranks (the JAX ``_window_shard_axes``): evenly, and with a
    shift in whole images' windows, since the kernel's Swin mask takes a
    window's place from its batch index (``batch % n``); without one,
    ``num_windows % n``. Otherwise every rank computes them all."""
    n = group_size(group)
    return n > 1 and (batch if with_shift else num_windows) % n == 0


class _BatchFunction(torch.autograd.Function):
    """Flash attention with the batch axis split evenly over the group:
    each rank its chunk, all-gathered; the backward likewise."""

    @staticmethod
    def forward(ctx, q, k, v, group, swin, steps):
        tr = _transport(group)
        chunk = q.shape[0] // tr.size
        parts = [tuple(t[r * chunk:(r + 1) * chunk] for t in (q, k, v))
                 for r in tr.ranks]
        scale = 1.0 / math.sqrt(q.shape[2])
        res = [steps.forward(*p, scale, swin) for p in parts]
        ctx.save_for_backward(*(t for p in parts for t in p),
                              *(t for r in res for t in r))
        ctx.batch = (tr, chunk, scale, swin, steps, len(parts),
                     (q.dtype, k.dtype, v.dtype))
        return tr.gather([o for o, _ in res], 0, [chunk] * tr.size)

    @staticmethod
    def backward(ctx, g):
        tr, chunk, scale, swin, steps, m, dtypes = ctx.batch
        saved = ctx.saved_tensors
        grads = []
        for i, r in enumerate(tr.ranks):
            q, k, v = saved[3 * i:3 * i + 3]
            out, lse = saved[3 * m + 2 * i:3 * m + 2 * i + 2]
            grads.append(steps.backward(q, k, v, out, lse,
                                        g[r * chunk:(r + 1) * chunk], scale,
                                        swin))
        return tuple(tr.gather([gr[j] for gr in grads], 0,
                               [chunk] * tr.size).to(dtypes[j])
                     for j in range(3)) + (None, None, None)


def sharded_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, group,
                             swin=None) -> torch.Tensor:
    """``flash_softmax_matmul(q, k, v, swin=swin)`` over a batch of
    windows split evenly over the group's ranks (:func:`window_shards`
    says where it may be): ``[B, L, D]`` f32, the same on every rank."""
    if q.shape[0] % group_size(group):
        raise ValueError(f"{q.shape[0]} windows do not split over "
                         f"{group_size(group)} ranks")
    return _BatchFunction.apply(q, k, v, group, swin, KERNELS)
