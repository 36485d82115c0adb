"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference computed from the same inputs and
weights. Each gap is 0 where the two agree; a missing or non-finite
answer reads ``inf``. A cell's limits are in ``limits/<cell>.json``."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

import torch


def rel_gap(got: Iterable[float], ref: Iterable[float]) -> float:
    """The widest ``|got - ref| / |ref|`` over paired scalars."""
    got, ref = list(got), list(ref)
    if len(got) != len(ref):
        return math.inf
    out = 0.0
    for g, r in zip(got, ref):
        gap = abs(g - r) / max(abs(r), 1e-30)
        out = max(out, gap if math.isfinite(gap) else math.inf)
    return out


def entry_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest ``||got_i - ref_i|| / ||ref_i||`` over the batch entries
    ``i`` (f32 norms over each entry: a pair's flow, an image's features);
    a missing entry, or one that is not finite, reads ``inf``."""
    ref = ref.float()
    got = got.float().to(ref.device)
    if got.shape != ref.shape:
        return math.inf
    worst = 0.0
    for i in range(ref.shape[0]):
        d = float(torch.linalg.vector_norm(got[i] - ref[i]))
        r = float(torch.linalg.vector_norm(ref[i]))
        gap = d / max(r, 1e-30)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def gap_ratio(got: torch.Tensor, yardstick: torch.Tensor,
              ref: torch.Tensor) -> float:
    """``||got - ref|| / ||yardstick - ref||`` over a whole batch: how far
    the answer lies from the reference in units of another answer's
    distance; ``inf`` where it is missing or not finite."""
    ref = ref.float()
    got = got.float().to(ref.device)
    if got.shape != ref.shape:
        return math.inf
    r = float(torch.linalg.vector_norm(got - ref)
              / torch.linalg.vector_norm(yardstick.float() - ref)
              .clamp(min=1e-30))
    return r if math.isfinite(r) else math.inf


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's ``|got - ref|`` over the larger of the reference's norm
    of that leaf and the median leaf's (norms per leaf; ``keep``: the
    leaves compared, all by default); every leaf ``inf`` where the two do
    not hold the same leaves."""
    names = list(ref) if keep is None else list(keep)
    if set(got) != set(ref):
        return {n: math.inf for n in names}
    median = statistics.median(ref.values())
    out = {}
    for n in names:
        gap = abs(got[n] - ref[n]) / max(ref[n], median, 1e-30)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in tensors.items()}


def far_share(got: torch.Tensor, ref: torch.Tensor, far: float) -> float:
    """Over flows ``[B, ..., 2]`` (the two components last), the worst
    image's share of positions whose flow lies more than ``far`` from the
    reference's; ``inf`` where the answer is missing, of another shape or
    not finite."""
    ref = ref.float()
    got = got.float().to(ref.device)
    if got.shape != ref.shape:
        return math.inf
    dist = torch.linalg.vector_norm(got - ref, dim=-1).flatten(1)
    share = float((~(dist <= far)).float().mean(dim=1).max())
    return share


def row_gaps(got, ref) -> list:
    """Over two lists of tensors whose first axis is the batch's rows, each
    row's ``||got_r - ref_r|| / ||ref_r||`` over all the tensors together
    (0 where both are nought); ``[inf]`` where the answer is missing, of
    another shape or not finite."""
    if not got or len(got) != len(ref) \
            or any(g is None or g.shape != r.shape for g, r in zip(got, ref)):
        return [math.inf]
    d = sum(torch.linalg.vector_norm((g.float().to(r.device) - r.float())
                                     .flatten(1), dim=1) ** 2
            for g, r in zip(got, ref))
    n = sum(torch.linalg.vector_norm(r.float().flatten(1), dim=1) ** 2
            for r in ref)
    gaps = torch.where(d == 0, torch.zeros_like(d),
                       torch.sqrt(d / n.clamp(min=1e-60)))
    return [g if math.isfinite(g) else math.inf for g in gaps.tolist()]


def moving_leaves(ref_grads: Dict[str, float],
                  share: float = 1e-3) -> list:
    """The leaves whose first gradient in the reference is at least
    ``share`` of the median leaf's: the others (a bias that a norm or a
    softmax cancels) move under Adam by round-off alone."""
    median = statistics.median(ref_grads.values())
    return [n for n, g in ref_grads.items() if g >= share * median]


def train_checks(got: dict, ref: dict) -> Dict[str, float]:
    """The training cells' numbers from two readings of the checked steps
    (each a dict of ``losses``, ``cls_losses``, ``flow`` (the first step's
    last prediction), ``features`` (its transformer's output), ``grads``
    and ``changes`` (norms per leaf)): the worst step's loss, the first
    step's, the worst step's classifier loss, the flow, the features, and
    of the first gradients and of the changes (of the leaves
    that move, ``moving_leaves``) the worst leaf's and the median leaf's
    gap."""
    grads = leaf_gaps(got["grads"], ref["grads"])
    changes = leaf_gaps(got["changes"], ref["changes"],
                        moving_leaves(ref["grads"]))
    out = {"loss_gap": rel_gap(got["losses"], ref["losses"]),
           "loss1_gap": rel_gap(got["losses"][:1], ref["losses"][:1]),
           "flow_gap": entry_gap(got["flow"], ref["flow"]),
           "feature_gap": entry_gap(got["features"], ref["features"]),
           "grad_gap": max(grads.values()),
           "grad_gap_median": statistics.median(grads.values()),
           "update_gap": max(changes.values()),
           "update_gap_median": statistics.median(changes.values())}
    if ref.get("cls_losses"):
        out["cls_loss_gap"] = rel_gap(got.get("cls_losses", []),
                                      ref["cls_losses"])
    return out


def worst_leaves(got: dict, ref: dict, n: int = 3) -> dict:
    """The leaves with the widest gradient and change gaps (for a look at
    what a worst-leaf number reads)."""
    grads = leaf_gaps(got["grads"], ref["grads"])
    changes = leaf_gaps(got["changes"], ref["changes"],
                        moving_leaves(ref["grads"]))
    top = {k: sorted(v.items(), key=lambda x: -x[1])[:n]
           for k, v in (("grads", grads), ("changes", changes))}
    top["step_loss_gaps"] = [rel_gap([g], [r]) for g, r in
                             zip(got["losses"], ref["losses"])]
    top["losses"] = [got["losses"], ref["losses"]]
    return top
