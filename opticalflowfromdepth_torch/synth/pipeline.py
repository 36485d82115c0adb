"""The synthesis engine: depth -> supervised optical-flow pairs (port of
``opticalflowfromdepth_tpu/synth/pipeline.py``; the reference's
``PreprocessPlusAugment``, `preprocess.py:329-506`, and ``augment_flow``,
`preprocess.py:107-182`).

Per source image:
  * a 5-pair group (0->1 virtual stereo, 1->2 and 0->3 virtual motion,
    0->2 and 1->3 composed), each pair (imgA, depthA, imgB, depthB,
    flowAB, back_flowAB), 12 channels (`preprocess.py:427-432`);
  * 12 augmentations of each pair (``AUGMENT_SCHEDULE``,
    `preprocess.py:454`), each with two supervised sides.

Every random value is an explicit draw (``core/rng.py``; ``draw_sample``
draws one image's in a fixed order). The augmentations of one type run
batched over the 15 (pair, position) entries, as the JAX package's
``vmap`` runs them, so an image takes 20 forward-warp launches: 7 in
the group at B = 1 (5 pack warps, 2 ``concat_flow``), 3 for the flips (1
``concat_flow``, 2 ``back_flow``; the pack warps are mirrors) and 5 each
for rotate and shear, at B = 15.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ..core import camera, convert, special_flow
from ..core.depth_utils import fix_warped_depth, normalize_depth
from ..core.rng import AugmentDraws, GroupDraws, draw_augment, draw_group
from ..ops.forward_warp import (back_flow, concat_flow, forward_warp,
                                forward_warp_flip)
from ..ops.inpaint import inpaint

AUGMENT_SCHEDULE = (0, 5, 6, 7, 1, 5, 6, 7, 2, 5, 6, 7)  # `preprocess.py:454`
GEO_POSITIONS = tuple(i for i, t in enumerate(AUGMENT_SCHEDULE) if t >= 5)
PHO_POSITIONS = tuple(i for i, t in enumerate(AUGMENT_SCHEDULE) if t < 5)
N_PAIRS = 5


class Pair(NamedTuple):
    """One supervised pair, 12 channels in the reference's layout; each
    field [C, H, W], or [B, C, H, W] batched."""
    img_a: torch.Tensor        # 3
    depth_a: torch.Tensor      # 1
    img_b: torch.Tensor        # 3
    depth_b: torch.Tensor      # 1
    flow_ab: torch.Tensor      # 2
    back_flow_ab: torch.Tensor  # 2

    def stacked(self) -> torch.Tensor:
        return torch.cat(self, dim=-3)


class AugmentedSets(NamedTuple):
    """Both supervised sets of one augmentation (`preprocess.py:142-147`,
    `:177-182`, saved as `:462-463`):
      set1 = [aug_img0(3), aug_depth0(1), flow(2), back_flow(2)]
      set2 = [flow(2), back_flow(2), aug_img1(3), aug_depth1(1)]"""
    set1: torch.Tensor
    set2: torch.Tensor


class SampleDraws(NamedTuple):
    """One image's draws: the group's, and ``augment[g][a]`` for pair g
    and schedule position a."""
    group: GroupDraws
    augment: Tuple[Tuple[AugmentDraws, ...], ...]


def draw_sample(gen: torch.Generator, h: int, w: int) -> SampleDraws:
    """One image's draws from ``gen`` (a CPU generator): the group's,
    then for each pair g and position a those of ``AUGMENT_SCHEDULE[a]``."""
    group = draw_group(gen)
    aug = tuple(tuple(draw_augment(gen, t, h, w) for t in AUGMENT_SCHEDULE)
                for _ in range(N_PAIRS))
    return SampleDraws(group, aug)


def _draws_to(draws: SampleDraws, device
              ) -> Tuple[GroupDraws, torch.Tensor]:
    """The draws on ``device`` in one copy: the group's, and the
    augmentations' as a table [5, 12, 7] (``AugmentDraws`` fields last)."""
    table = torch.stack([torch.stack([torch.stack(list(d)) for d in row])
                         for row in draws.augment])
    g = draws.group
    flat = torch.cat([g.s.reshape(1), g.axisangle, g.translation,
                      table.reshape(-1)]).float()
    device = torch.device(device)
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    group = GroupDraws(flat[0], flat[1:4], flat[4:7])
    return group, flat[7:].reshape(table.shape)


def _warp_masked(pack, flow, depth, extra_valid: bool):
    """One pack warp of the group: (img, depth, back flow, valid, coll),
    everything masked by the hit mask (times the pack's own valid channel
    when it carries one)."""
    out, valid, coll = forward_warp(pack, flow, depth)
    if extra_valid:
        valid = valid * out[6:7]
    return out[0:3] * valid, out[3:4] * valid, out[4:6] * valid, valid, coll


def synthesize_group(img0: torch.Tensor, depth0: torch.Tensor,
                     draws: GroupDraws, is_stereo: bool = False
                     ) -> Tuple[Pair, ...]:
    """The 5-pair group of one image [3, H, W] (in [0, 255]) and its depth
    [1, H, W] (disparity when ``is_stereo``, DIML), with the group's
    draws; `preprocess.py:341-432` step by step."""
    img0_depth = convert.disparity_to_depth(depth0) if is_stereo else depth0
    img0_depth = normalize_depth(img0_depth)

    # 0 -> 1: virtual stereo (horizontal flow)
    disp0 = convert.depth_to_disparity(img0_depth, draws.s)
    flow01 = convert.disparity_to_flow(disp0)
    pack = torch.cat([img0, img0_depth, flow01 * -1.0], 0)
    out, img1_valid, coll = forward_warp(pack, flow01, img0_depth)
    img1 = out[0:3] * img1_valid
    img1_depth = fix_warped_depth(out[3:4] * img1_valid)
    back_flow01 = out[4:6] * img1_valid
    img1 = inpaint(img1, img1_valid, coll)

    # 1 -> 2: the virtual camera motion
    T1, _, _ = camera.random_motion(draws.axisangle, draws.translation)
    flow12, _ = convert.depth_to_random_flow(img1_depth, T1)
    pack = torch.cat([img1, img1_depth, flow12 * -1.0, img1_valid], 0)
    img2, img2_depth, back_flow12, img2_valid, coll = _warp_masked(
        pack, flow12, img1_depth, True)
    img2 = inpaint(img2, img2_valid, coll)
    img2_depth = fix_warped_depth(img2_depth)

    # 0 -> 3: the same motion from frame 0 (`preprocess.py:385`)
    flow03, _ = convert.depth_to_random_flow(img0_depth, T1)
    pack = torch.cat([img0, img0_depth, flow03 * -1.0], 0)
    img3, img3_depth, back_flow03, img3_valid, coll = _warp_masked(
        pack, flow03, img0_depth, False)
    img3 = inpaint(img3, img3_valid, coll)
    img3_depth = fix_warped_depth(img3_depth)

    # 0 -> 2: composed flow (`preprocess.py:400-412`)
    flow02, flow02_valid = concat_flow(flow01, back_flow01, flow12,
                                       img1_depth)
    pack = torch.cat([img0, img0_depth, flow02 * -1.0, flow02_valid], 0)
    img2p, img2p_depth, back_flow02p, img2p_valid, coll = _warp_masked(
        pack, flow02, img0_depth, True)
    img2p = inpaint(img2p, img2p_valid, coll)
    img2p_depth = fix_warped_depth(img2p_depth)

    # 1 -> 3: composed flow (`preprocess.py:414-425`)
    flow13, flow13_valid = concat_flow(back_flow01, flow01, flow03,
                                       img1_depth)
    flow13_valid = flow13_valid * img1_valid
    pack = torch.cat([img1, img1_depth, flow13 * -1.0, flow13_valid], 0)
    img3p, img3p_depth, back_flow13p, img3p_valid, coll = _warp_masked(
        pack, flow13, img1_depth, True)
    img3p = inpaint(img3p, img3p_valid, coll)
    img3p_depth = fix_warped_depth(img3p_depth)

    return (Pair(img0, img0_depth, img1, img1_depth, flow01, back_flow01),
            Pair(img1, img1_depth, img2, img2_depth, flow12, back_flow12),
            Pair(img0, img0_depth, img2p, img2p_depth, flow02, back_flow02p),
            Pair(img0, img0_depth, img3, img3_depth, flow03, back_flow03),
            Pair(img1, img1_depth, img3p, img3p_depth, flow13, back_flow13p))


_GRAY = (0.2989, 0.5870, 0.1140)


def _photometric(img: torch.Tensor, t: int, draws: AugmentDraws
                 ) -> torch.Tensor:
    """Augment type 0 (brightness), 1 (channel shift) or 2 (grayscale) of
    images [B, 3, H, W] (`preprocess.py:150-182`)."""
    if t == 2:
        gray = img[:, 0:1] * _GRAY[0] + img[:, 1:2] * _GRAY[1] \
            + img[:, 2:3] * _GRAY[2]
        return gray.expand_as(img)
    if t == 1:
        chan = torch.arange(3, dtype=torch.float32, device=img.device)
        shift = (chan[None] == draws.channel[:, None]).float() \
            * draws.value[:, None]
        return img + shift[:, :, None, None]
    if t == 0:
        return img * draws.scale[:, None, None, None]
    raise ValueError(f"not a photometric augment type: {t}")


def _special_flow(t: int, draws: AugmentDraws, b: int, h: int, w: int):
    if t == 7:
        return special_flow.shear_flow(draws.s, h, w)
    if t == 6:
        return special_flow.rotate_flow(draws.cx, draws.cy, draws.theta_deg,
                                        h, w)
    sf, bsf = special_flow.flip_flow(h, w, device=draws.s.device)
    return sf.expand(b, 2, h, w), bsf.expand(b, 2, h, w)


def augment_pair(pair: Pair, t: int, draws: AugmentDraws) -> AugmentedSets:
    """Augmentation ``t`` of a batch of pairs (each field [B, C, H, W])
    with draws of shape [B] (`preprocess.py:107-182`).

    Geometric types (5 flip, 6 rotate, 7 shear) compose the special flow
    with the pair's flow both ways, warp image and depth, inpaint, and
    recompute the backward flows; photometric types (0-2) change only
    the images. Types 3 and 4 raise, as in the JAX package."""
    img0, img0_depth, img1, img1_depth, flow01, back_flow01 = pair
    b, _, h, w = img0.shape
    if t >= 5:
        sf, bsf = _special_flow(t, draws, b, h, w)
        # the ConcatFlow of flow01 and the img0 pack go along the same
        # flow over the same depth: one warp carries both (JAX :171-178)
        pack0 = torch.cat([flow01, img0, img0_depth], 1)
        pack1 = torch.cat([img1, img1_depth], 1)
        if t == 5:
            h_flip = special_flow.FLIP_HORIZONTAL
            out0, v0, c0 = forward_warp_flip(pack0, img0_depth, h_flip)
            out1, v1, c1 = forward_warp_flip(pack1, img1_depth, h_flip)
        else:
            out0, v0, c0 = forward_warp(pack0, sf, img0_depth)
            out1, v1, c1 = forward_warp(pack1, sf, img1_depth)
        aug0_flow = (out0[:, 0:2] + bsf) * v0   # == concat_flow(bsf, sf, ..)
        aug_img0 = inpaint(out0[:, 2:5], v0, c0)
        aug_img0_depth = fix_warped_depth(out0[:, 5:6])
        aug_img1 = inpaint(out1[:, 0:3], v1, c1)
        aug_img1_depth = fix_warped_depth(out1[:, 3:4])
        aug1_flow, _ = concat_flow(flow01, back_flow01, sf.contiguous(),
                                   img1_depth)
        back_aug0_flow, _ = back_flow(aug0_flow, aug_img0_depth)
        back_aug1_flow, _ = back_flow(aug1_flow, img0_depth)
        return AugmentedSets(
            torch.cat([aug_img0, aug_img0_depth, aug0_flow, back_aug0_flow],
                      1),
            torch.cat([aug1_flow, back_aug1_flow, aug_img1, aug_img1_depth],
                      1))
    if t >= 3:
        raise ValueError("augment types 3-4 are dead branches in the "
                         "reference (`preprocess.py:148-149`) and are not "
                         "supported")
    return AugmentedSets(
        torch.cat([_photometric(img0, t, draws), img0_depth, flow01,
                   back_flow01], 1),
        torch.cat([flow01, back_flow01, _photometric(img1, t, draws),
                   img1_depth], 1))


def group_tensor(pairs: Sequence[Pair]) -> torch.Tensor:
    """The 44-channel group tensor of `preprocess.py:437-440`."""
    p0, p1, p2, p3, p4 = pairs
    return torch.cat([p0.img_a, p0.depth_a, p0.img_b, p0.depth_b,
                      p1.img_b, p1.depth_b, p3.img_b, p3.depth_b,
                      p2.img_b, p2.depth_b, p4.img_b, p4.depth_b,
                      p0.flow_ab, p0.back_flow_ab, p1.flow_ab,
                      p1.back_flow_ab, p2.flow_ab, p2.back_flow_ab,
                      p3.flow_ab, p3.back_flow_ab, p4.flow_ab,
                      p4.back_flow_ab], 0)


def _index(idx: Sequence[int]):
    """``idx`` as a slice where it is evenly spaced (it is for every
    type of ``AUGMENT_SCHEDULE``): indexing a CUDA tensor with a list
    copies the list to the card, which waits for the card."""
    step = idx[1] - idx[0] if len(idx) > 1 else 1
    if step > 0 and list(idx) == list(range(idx[0], idx[-1] + 1, step)):
        return slice(idx[0], idx[-1] + 1, step)
    return list(idx)


def _batches(pairs: Sequence[Pair], table: torch.Tensor):
    """Per augment type: (t, its positions, the 15 entries' pairs in
    g-major order, their draws)."""
    stacked = Pair(*(torch.stack([getattr(p, f) for p in pairs])
                     for f in Pair._fields))
    for t in sorted(set(AUGMENT_SCHEDULE)):
        pos = [i for i, tt in enumerate(AUGMENT_SCHEDULE) if tt == t]
        rep = Pair(*(x[:, None].expand(x.shape[0], len(pos), *x.shape[1:])
                     .reshape(-1, *x.shape[1:]) for x in stacked))
        d = AugmentDraws(*table[:, _index(pos)].reshape(-1, table.shape[-1])
                         .unbind(1))
        yield t, pos, rep, d


def synthesize_sample(img0: torch.Tensor, depth0: torch.Tensor,
                      draws: SampleDraws, is_stereo: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """The group and all 5 x 12 x 2 augmented sets of one image:
    'group' [44, H, W], 'pairs' [5, 12, H, W], 'aug_set1' and 'aug_set2'
    [5, 12, 8, H, W], 'aug_types' [12] int32 (on the CPU)."""
    group, table = _draws_to(draws, img0.device)
    pairs = synthesize_group(img0, depth0, group, is_stereo)
    h, w = img0.shape[-2:]
    n_aug = len(AUGMENT_SCHEDULE)
    set1 = img0.new_empty(N_PAIRS, n_aug, 8, h, w)
    set2 = torch.empty_like(set1)
    for t, pos, rep, d in _batches(pairs, table):
        out = augment_pair(rep, t, d)
        set1[:, _index(pos)] = out.set1.reshape(N_PAIRS, len(pos), 8, h, w)
        set2[:, _index(pos)] = out.set2.reshape(N_PAIRS, len(pos), 8, h, w)
    return {"group": group_tensor(pairs),
            "pairs": torch.stack([p.stacked() for p in pairs]),
            "aug_set1": set1, "aug_set2": set2,
            "aug_types": torch.tensor(AUGMENT_SCHEDULE, dtype=torch.int32)}


def _u8(img: torch.Tensor) -> torch.Tensor:
    # clip and truncate, as the writer's np.clip(...).astype(np.uint8)
    return torch.clamp(img, 0, 255).to(torch.uint8)


def synthesize_sample_packed(img0: torch.Tensor, depth0: torch.Tensor,
                             draws: SampleDraws, is_stereo: bool = False
                             ) -> Dict[str, torch.Tensor]:
    """:func:`synthesize_sample` in the storage dtypes, cast on the
    device (u8 images, f16 floats). Photometric augmentations change only
    the images, so only their images are kept; the writer reuses the
    pair's depth and flow for them.

    Returns (on img0's device; 'aug_types' on the CPU):
      'group_f16'     [44, H, W]
      'pairs_img_u8'  [5, 2, 3, H, W]      (img_a, img_b)
      'pairs_flt_f16' [5, 6, H, W]         (depth_a, depth_b, flow, back)
      'geo_img_u8'    [5, 9, 2, 3, H, W]   (set1 aug_img0, set2 aug_img1)
      'geo_flt_f16'   [5, 9, 2, 5, H, W]   (aug depth, flow, back flow)
      'pho_img_u8'    [5, 3, 2, 3, H, W]
      'aug_types'     [12] int32
    """
    group, table = _draws_to(draws, img0.device)
    pairs = synthesize_group(img0, depth0, group, is_stereo)
    h, w = img0.shape[-2:]
    geo1 = img0.new_empty(N_PAIRS, len(GEO_POSITIONS), 8, h, w)
    geo2 = torch.empty_like(geo1)
    pho = img0.new_empty(N_PAIRS, len(PHO_POSITIONS), 2, 3, h, w)
    for t, pos, rep, d in _batches(pairs, table):
        if t >= 5:
            slots = _index([GEO_POSITIONS.index(a) for a in pos])
            out = augment_pair(rep, t, d)
            geo1[:, slots] = out.set1.reshape(N_PAIRS, len(pos), 8, h, w)
            geo2[:, slots] = out.set2.reshape(N_PAIRS, len(pos), 8, h, w)
        else:
            slots = _index([PHO_POSITIONS.index(a) for a in pos])
            for side, img in enumerate((rep.img_a, rep.img_b)):
                pho[:, slots, side] = _photometric(img, t, d).reshape(
                    N_PAIRS, len(pos), 3, h, w)
    pairs_12 = torch.stack([p.stacked() for p in pairs])
    geo_flt = torch.stack([
        torch.cat([geo1[:, :, 3:4], geo1[:, :, 4:8]], 2),    # d0, f, b
        torch.cat([geo2[:, :, 7:8], geo2[:, :, 0:4]], 2)],   # d1, f, b
        2)
    return {
        "group_f16": group_tensor(pairs).half(),
        "pairs_img_u8": _u8(torch.stack([pairs_12[:, 0:3],
                                         pairs_12[:, 4:7]], 1)),
        "pairs_flt_f16": torch.cat([pairs_12[:, 3:4], pairs_12[:, 7:8],
                                    pairs_12[:, 8:12]], 1).half(),
        "geo_img_u8": _u8(torch.stack([geo1[:, :, 0:3], geo2[:, :, 4:7]],
                                      2)),
        "geo_flt_f16": geo_flt.half(),
        "pho_img_u8": _u8(pho),
        "aug_types": torch.tensor(AUGMENT_SCHEDULE, dtype=torch.int32),
    }


def warps_per_image() -> int:
    """Forward-warp launches one image takes on the card (7 in the group,
    3 for flips, 5 each for rotate and shear)."""
    per_type = {5: 3, 6: 5, 7: 5}
    return 7 + sum(per_type[t] for t in set(AUGMENT_SCHEDULE) if t >= 5)

