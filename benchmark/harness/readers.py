"""What the per-layer metrics read from a traced window
(``runner.Reading``). Each returns None where the trace holds nothing to
read, and the metric is then left out of the run's line."""

from __future__ import annotations

from typing import Optional, Tuple

from . import bounds

# the port's kernels, by the stems of their names in csrc/
FLASH_FWD = ("flash_fwd_", "merge_splits")
FLASH_BWD = ("flash_bwd_", "reduce_splits")
CORR_LOOKUP = ("corr_fwd_tiles", "fused_corr_fwd_kernel", "zero_levels")
INSTANCE_NORM = ("instance_norm_fwd",)


def idle_pct(r) -> Optional[float]:
    """Share of an untraced call's time in which no kernel, copy or memset
    ran: the traced window's busy time a call against the untraced pace
    (the profiler's host cost left out)."""
    s = r.summary
    if s.units == 0 or s.busy_s <= 0 or r.paced_unit_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.units / r.paced_unit_s)


def mfu(r) -> Optional[float]:
    """The model's FLOPs a call over the untraced pace, against the bf16
    peak."""
    if not r.work.get("flops") or r.paced_unit_s <= 0:
        return None
    return 100.0 * r.work["flops"] / r.paced_unit_s / bounds.BF16_FLOP_PER_S


def launches_per_pair(r) -> Optional[float]:
    if r.pairs == 0 or r.summary.launches == 0:
        return None
    return r.summary.launches / r.pairs


def copy_ms_per_pair(r) -> Optional[float]:
    """Device time of host-to-device and device-to-host copies a pair."""
    t = r.summary.copy_s()
    if r.pairs == 0 or t <= 0:
        return None
    return t * 1e3 / r.pairs


def roofline(r, op: str, stems: Tuple[str, ...]) -> Optional[float]:
    """The least time the op's calls of the window allow over the device
    time of its kernels."""
    bound = r.work.get("bounds", {}).get(op)
    t, _ = r.summary.kernel_s(stems)
    if not bound or t <= 0 or r.summary.units == 0:
        return None
    return 100.0 * bound * r.summary.units / t
