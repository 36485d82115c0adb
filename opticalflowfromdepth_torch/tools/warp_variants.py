"""Time the forward warp's kernel against its variants on the card.

Builds ``csrc/forward_warp.cu`` as it stands and as variants of it: other
``kVec`` (adjacent targets a thread in the reset and the gather),
``kBlocksPerSm`` (blocks a SM, which caps the registers) and ``kPlanes``
(channels a thread gathers before it stores them), and each of them cut
after phase 0 (the z-buffer's reset) or phase 1 (reset and z-test), to
split its time by phase. Every whole variant is first held bit for bit against
``forward_warp_plain`` on every input it is timed on. Then each is timed
(device time, one CUDA graph, ``chip_smoke.py:graph_ms``) on

* ``chip_smoke.py`` [3h]'s flows at [15, 6, 384, 512] and [1, 6, 384, 512];
* the warps of one synthesized image, depth and stereo, recorded from
  ``synth.pipeline.synthesize_sample_packed`` at 384x512 (20 each) and
  replayed one by one, summed: the synthesis path's own traffic.

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``::

    python -m opticalflowfromdepth_torch.tools.warp_variants

It prints the card, each build's registers and spills, and the times,
each variant in turn and then in reverse order (``a/b`` us).
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
# the kernel as it stands first; then a pixel a thread in every phase,
# and the kernel at other constants
VARIANTS = ("vec2_bps6_pl4", "vec1_bps6_pl8", "vec2_bps4_pl8",
            "vec2_bps6_pl2", "vec4_bps6_pl2", "vec4_bps4_pl4")
CUTS = {"p0": 1, "p01": 2}   # stop after the first or second grid sync


def variant_source(src: str, name: str) -> str:
    """``csrc/forward_warp.cu`` with ``name``'s constants, e.g.
    ``vec2_bps4``, ``vec2_bps6_pl4`` (kPlanes 4) or ``vec2_bps4_p01`` (cut
    after phase 1)."""
    m = re.fullmatch(r"vec(\d)_bps(\d)(?:_pl(\d))?(?:_(p0|p01))?", name)
    if not m:
        raise ValueError(f"variant {name!r}")
    vec, bps, planes, cut = m.groups()
    for const, value in (("kVec", vec), ("kBlocksPerSm", bps),
                         ("kPlanes", planes)):
        if value is None:
            continue
        src, n = re.subn(rf"constexpr int {const} = \d+;",
                         f"constexpr int {const} = {value};", src)
        assert n == 1, const
    if cut:
        parts = src.split("    grid.sync();\n")
        assert len(parts) == 3, "the kernel has two grid syncs"
        k = CUTS[cut]
        src = "    grid.sync();\n".join(parts[:k]) \
            + "    grid.sync();\n    return;\n" \
            + "    grid.sync();\n".join(parts[k:])
    return src


def build(names, out_dir: pathlib.Path):
    """Every variant compiled at once, one nvcc each: {name: (entry
    point, kVec, kBlocksPerSm, ptxas lines)}."""
    from .. import _build
    from ..ops import forward_warp as fw
    src = (_build.CSRC / "forward_warp.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, name))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        vec, bps = (int(x) for x in re.findall(r"\d", name)[:2])
        built[name] = (fw.bind(ctypes.CDLL(str(out_dir / f"{name}.so"))),
                       vec, bps, ptxas)
    return built


def launcher(entry, vec: int, bps: int, sms: int):
    """A call of one build, as ``ops/forward_warp.py`` makes it."""
    import torch
    from ..ops import forward_warp as fw

    def run(obj, flow, depth):
        b, c, h, w = obj.shape
        out = torch.empty_like(obj)
        valid = torch.empty_like(depth)
        collision = torch.empty_like(depth)
        zbuf = torch.empty(b * h * w, dtype=torch.int64, device=obj.device)
        err = entry(*(t.data_ptr() for t in (obj, flow, depth, zbuf, out,
                                             valid, collision)),
                    b, c, h, w, fw.plan(b, h, w, sms, vec, bps), 0,
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out, valid, collision
    return run


def recorded_warps(stereo: bool):
    """The warps of one image of the synthesis path at 384x512 (inputs
    cloned), in the order the pipeline calls them."""
    import torch
    import chip_smoke as cs
    from ..ops import forward_warp as fw
    from ..synth import pipeline as sp
    h, w = cs.SYNTH
    img, dep = (torch.from_numpy(a).cuda()
                for a in cs.synth_source(3, h, w, stereo))
    draws = sp.draw_sample(torch.Generator().manual_seed(12345), h, w)
    recorded = []
    launch = fw._forward_warp_cuda

    def recording(obj, flow, depth, **kw):
        recorded.append(tuple(t.contiguous().clone()
                              for t in (obj, flow, depth)))
        return launch(obj, flow, depth, **kw)
    fw._forward_warp_cuda = recording
    try:
        sp.synthesize_sample_packed(img, dep, draws, stereo)
    finally:
        fw._forward_warp_cuda = launch
    torch.cuda.synchronize()
    if len(recorded) != sp.warps_per_image():
        raise RuntimeError(f"{len(recorded)} warps recorded, want "
                           f"{sp.warps_per_image()}")
    return recorded


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", nargs="+", default=list(VARIANTS))
    p.add_argument("--out", default=str(REPO / "build" / "warp_variants"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch
    import chip_smoke as cs
    from ..ops import forward_warp as fw
    from ..utils.device import sm_count
    if not torch.cuda.is_available():
        raise SystemExit("warp_variants: no CUDA device")
    print(cs.card_line(), torch.__version__, flush=True)
    names = [f"{v}{cut}" for v in args.variants
             for cut in ("", "_p0", "_p01")]
    built = build(names, pathlib.Path(args.out))
    for name in names:
        print(f"{name}: {' | '.join(built[name][3])}", flush=True)
    sms = sm_count(0)
    runs = {name: launcher(e, vec, bps, sms)
            for name, (e, vec, bps, _) in built.items()}

    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = {(b, case): cs.warp_inputs(gen, b, 6, *cs.SYNTH, case)
             for b in (15, 1)
             for case in ("i.i.d. +-20 px", "rotation off the image",
                          "four targets", "translation", "zero")}
    images = {"depth": recorded_warps(False),
              "stereo": recorded_warps(True)}
    every = list(cases.values()) + [a for r in images.values() for a in r]
    for name in args.variants:      # whole variants: exact on every input
        for inputs in every:
            ref = fw.forward_warp_plain(*inputs)
            if not all(cs.same_bits(x, y)
                       for x, y in zip(runs[name](*inputs), ref)):
                raise SystemExit(f"warp_variants: {name} differs from the "
                                 f"plain version at "
                                 f"{tuple(inputs[0].shape)}")
    print(f"every variant bit-equal to the plain version on "
          f"{len(every)} inputs", flush=True)

    def times(inputs_list):
        """{name: (us per input in order, us per input in reverse
        order)}."""
        got = {name: ([], []) for name in names}
        for k, order in enumerate((names, names[::-1])):
            for name in order:
                got[name][k].extend(cs.graph_ms(lambda: runs[name](*inputs))
                                    * 1e3 for inputs in inputs_list)
        return got

    def show(label, got, pick, bound_us):
        print(f"{label} (bound {bound_us:.2f} us): " + ", ".join(
            f"{n} {sum(a[i] for i in pick):.1f}/"
            f"{sum(b[i] for i in pick):.1f}" for n, (a, b) in got.items()),
            flush=True)

    for (b, case), inputs in cases.items():
        show(f"[{b},6,{cs.SYNTH[0]},{cs.SYNTH[1]}] {case}", times([inputs]),
             [0], cs.warp_bound_ms(b, 6, *cs.SYNTH) * 1e3)
    for label, recorded in images.items():
        shapes = {}
        for a in recorded:
            shapes[tuple(a[0].shape)] = shapes.get(tuple(a[0].shape), 0) + 1
        print(f"{label} image: {len(recorded)} warps {shapes}", flush=True)
        got = times(recorded)
        for b in (1, 15, None):
            pick = [i for i, a in enumerate(recorded)
                    if b is None or len(a[0]) == b]
            show(f"  {label} image's "
                 + (f"B = {b} warps" if b else f"{len(pick)} warps")
                 + " summed", got, pick,
                 sum(cs.warp_bound_ms(*recorded[i][0].shape)
                     for i in pick) * 1e3)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
