"""Peaks of the card and the least time each kernel's work allows.

The arithmetic of the repository's ``chip_smoke.py`` (its ``bound_ms``
and the per-kernel counts beside its timings), kept here so the
yardstick stays fixed: the larger of the operations at the bf16 peak or
the exponentials at the special-function units' rate, against every
input read once and every output written once at the memory's rate. The
counts follow from the op's shapes at its call, so they hold whatever
kernel computes the op.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16, data sheet
# exponentials: 16 special-function results per clock per SM (Hopper
# white paper), 132 SMs, 1.98 GHz boost clock (H100 SXM data sheet)
SFU_PER_S = 16 * 132 * 1.98e9


def bound_s(ops: float, exps: float, nbytes: float,
            flop_per_s: float = BF16_FLOP_PER_S) -> float:
    """The least seconds the card needs for this work."""
    return max(ops / flop_per_s, exps / SFU_PER_S, nbytes / HBM_BYTES_PER_S)


def flash_fwd(b: int, lq: int, lk: int, c: int, d: int,
              esize: int = 2) -> float:
    """``softmax(q k^T) v`` over ``[b, lq, c] x [b, lk, c] -> [b, lq, d]``:
    S and P.V, an exponential a score; q, k, v read in the operand type, the
    f32 output written once."""
    pairs = float(b * lq * lk)
    nbytes = (b * lq * c + b * lk * c + b * lk * d) * esize + b * lq * d * 4
    return bound_s(2.0 * pairs * (c + d), pairs, nbytes)


def flash_bwd(b: int, lq: int, lk: int, c: int, d: int,
              esize: int = 2) -> float:
    """The backward's two kernels, each bound alone: dq recomputes S and dP
    and takes dS.K; dk/dv recomputes S and dP and takes P^T.G and dS^T.Q.
    Each reads q, k, v, g (operand type), the LSE and delta (f32) once and
    writes its gradients once (f32)."""
    pairs = float(b * lq * lk)
    reads = (b * lq * c + b * lk * c + b * lk * d + b * lq * d) * esize \
        + 2 * b * lq * 4
    dq = bound_s(2.0 * pairs * (2 * c + d), pairs, reads + b * lq * c * 4)
    dkv = bound_s(2.0 * pairs * (2 * c + 2 * d), pairs,
                  reads + (b * lk * c + b * lk * d) * 4)
    return dq + dkv


def instance_norm(numel: int, esize: int = 2) -> float:
    """One forward: the input read once and the output written once."""
    return bound_s(0.0, 0.0, 2.0 * numel * esize)


def corr_lookup(b: int, n: int, c: int, rows: int, levels: int,
                radius: int, esize: int = 2) -> float:
    """One correlation lookup of ``n`` queries a batch entry against a
    pyramid of ``rows`` feature rows: f1 and the pyramid read once, the
    ``levels * (2r+1)^2`` values a query written once, the f32 coordinates
    read once. The operations are counted as if every tap were in range
    (a dot product of ``c`` and the bilinear weights); at the cells' shapes
    the bytes bound it either way."""
    taps = float(b * n * levels * (2 * radius + 1) ** 2)
    nbytes = (b * n * c + b * rows * c + taps) * esize + b * n * 2 * 4
    return bound_s(2.0 * c * taps + 10.0 * taps, 0.0, nbytes)
