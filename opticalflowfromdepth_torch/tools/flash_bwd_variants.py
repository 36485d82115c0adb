"""Time the flash backward's wgmma route at C = 256 or 512 against variants.

At C = 256 (``--width 256``, the default): the dk/dv kernel at C = D =
256 lets both warpgroups share a block's 64 keys, each holding 128
columns of dK and of dV, so each computes S^T = K Q^T and dP^T = V G^T
over all of C and D: 1.5x the products the gradients need. The variant
``half_s`` takes those two products over half of C and D
(``product_c<W / 2, ...>``): the volume of products a design without the
recompute would launch, at the same tiles, turns and loads. Its
gradients are wrong by design; the time it saves bounds what a design
without the recompute could gain. The kernel as it stands is first held
against ``flash_backward_plain`` (``bwd_bf16_tolerance``) at each class;
then both builds are timed (CUDA events, ``chip_smoke.py:cuda_ms``) at
``chip_smoke.py:FLASH256_TRAIN_SHAPES``, GMFlow-256's training classes,
in turns: as it stands, the variant, the variant, as it stands.

At C = 512 (``--width 512``): the dq kernel without a share of its work,
each variant's time saved the cost of that share, at
``chip_smoke.py:FLASH512_TRAIN_SHAPES`` (GMFlow-512's training classes):
``dq_half_s`` takes S = Q K^T (and at D = 512 dP = G V^T) over half of C
(and D); ``dq_no_dq`` leaves out the dQ += dS K products (dS is still
formed and kept); ``dq_no_exp`` takes p = s - lse for exp(s - lse) (the
special-function units' share). Their gradients are wrong by design.

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``::

    python -m opticalflowfromdepth_torch.tools.flash_bwd_variants \\
        [--width 512]

It prints the card, each build's registers and spills, and per class the
dq and dk/dv times of each build (``a/b`` us, the turns: every build in
order, then in reverse).
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
# the two products of the dk/dv kernel that recompute S^T and dP^T
PRODUCTS = ("        product_c<W, TILE>(st, kres, sm.sc[s][0]);\n",
            "        if constexpr (!P2) product_c<W, TILE>(dpt, vres, "
            "sm.sd[s][0]);\n")
# the dq kernel's lines each C = 512 variant changes: (line, replacement,
# times it occurs): its ring sweep's S or dP over a batch of units (D =
# 512), its S over C (D = 2), its dQ products (both), its exponential
# (each sweep's, C = 128 and 256's too)
DQ_VARIANTS = {
    "dq_half_s": (
        ("      for (int h = h0; h < h1; ++h)\n"
         "        unit_product(acc, res + 2 * h * PANEL,\n",
         "      for (int h = h0; h < h0 + 1; ++h)\n"
         "        unit_product(acc, res + 2 * h * PANEL,\n", 1),
        ("      for (int kk = 0; kk < W / 16; ++kk) {\n"
         "        const int in = (kk & 3) * 16;\n"
         "        wgmma_m64n32_ss(\n",
         "      for (int kk = 0; kk < W / 32; ++kk) {\n"
         "        const int in = (kk & 3) * 16;\n"
         "        wgmma_m64n32_ss(\n", 1)),
    # (dS folded into dQ's accumulators element by element, so that ptxas
    # keeps the products and the exponentials that form it)
    "dq_no_dq": (
        ("        product_rs<RT>(dqa[h], da, sm.ring[(u0 + own + h) % NR]);\n",
         "        for (int i = 0; i < RT / 4; ++i) "
         "dqa[h][i] += __uint_as_float(da[i]);\n", 1),
        ("        product_rs<KT>(dqa[h], da, sm.sc[s][c0 / 64 + 2 * h]);\n",
         "        for (int i = 0; i < KT / 4; ++i) "
         "dqa[h][i] += __uint_as_float(da[i]);\n", 1)),
    "dq_no_exp": (
        ("const float p = qok[r] ? __expf(x - lse_r[r]) : 0.f;",
         "const float p = qok[r] ? (x - lse_r[r]) : 0.f;", 3),),
}
VARIANTS = {256: ("as_is", "half_s"), 512: ("as_is",) + tuple(DQ_VARIANTS)}


def variant_source(src: str, name: str) -> str:
    """``csrc/flash_bwd.cu`` as it stands (``as_is``), with the dk/dv
    kernel's S^T and dP^T over half of C and D (``half_s``), or changed
    as a key of :data:`DQ_VARIANTS` says."""
    if name == "as_is":
        return src
    if name in DQ_VARIANTS:
        for line, new, count in DQ_VARIANTS[name]:
            assert src.count(line) == count, line
            src = src.replace(line, new)
        return src
    if name != "half_s":
        raise ValueError(f"variant {name!r}")
    for line in PRODUCTS:
        assert src.count(line) == 1, line
        src = src.replace(line, line.replace("product_c<W, ",
                                             "product_c<W / 2, "))
    return src


def build(names, out_dir: pathlib.Path):
    """Every variant compiled at once, one nvcc each: {name: (entry
    points, ptxas lines of the wgmma kernels)}."""
    from .. import _build
    from ..ops import flash_bwd as fb
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, name))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas, entry = [], ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "wgmma" in entry and ("registers" in line
                                       or "spill" in line):
                ptxas.append(f"{entry[:40]}: {line.strip()}")
        built[name] = (fb.bind(ctypes.CDLL(str(out_dir / f"{name}.so"))),
                       ptxas)
    return built


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out",
                   default=str(REPO / "build" / "flash_bwd_variants"))
    p.add_argument("--width", type=int, default=256, choices=(256, 512))
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch
    import chip_smoke as cs
    from ..ops import flash as fl
    from ..ops import flash_bwd as fb
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants: no CUDA device")
    print(cs.card_line(), torch.__version__, flush=True)
    names = VARIANTS[args.width]
    shapes = (cs.FLASH256_TRAIN_SHAPES if args.width == 256
              else cs.FLASH512_TRAIN_SHAPES)
    built = build(names, pathlib.Path(args.out))
    for name in names:
        print(f"{name}: " + " | ".join(built[name][1]), flush=True)
    real = fb._kernel_fns
    gen = torch.Generator().manual_seed(75)
    try:
        for label, (b, l, c, d, payload, swin), n in shapes:
            q, k, v = cs.flash_inputs(gen, b, l, l, c, d, torch.bfloat16,
                                      payload, grid_w=cs.GW8)
            g = torch.randn(b, l, d, generator=gen).cuda()
            out, lse = fl.flash_softmax_matmul(q, k, v, swin=swin,
                                               with_lse=True)
            runs = {}
            for name in names:
                fb._kernel_fns = (lambda fns=built[name][0]: fns)
                runs[name] = fb.launchers(q, k, v, out, lse, g, swin=swin)
            grads, launch_dq, launch_dkv, _ = runs["as_is"]
            launch_dq()
            launch_dkv()
            torch.cuda.synchronize()
            ref = fb.flash_backward_plain(q, k, v, out, lse, g, swin=swin)
            tols = fb.bwd_bf16_tolerance(q, k, v, out, lse, g, swin=swin)
            ratio = max(float(((x - r).abs() / t).max())
                        for x, r, t in zip(grads, ref, tols))
            if not ratio <= 1.0:
                raise SystemExit(f"flash_bwd_variants: as_is at {label}: "
                                 f"|d| / tolerance {ratio:.3f}")
            got = {name: ([], []) for name in names}
            for name in names + names[::-1]:
                _, launch_dq, launch_dkv, _ = runs[name]
                for i, launch in enumerate((launch_dq, launch_dkv)):
                    got[name][i].append(cs.cuda_ms(launch) * 1e3)
            print(f"{label} [{b},{l},{c}]x[{b},{l},{d}] x{n} (as_is |d| / "
                  f"tolerance {ratio:.3f}): " + "; ".join(
                      f"{name} dq {'/'.join(f'{t:.1f}' for t in dq)} us, "
                      f"dk/dv {'/'.join(f'{t:.1f}' for t in dkv)} us"
                      for name, (dq, dkv) in got.items()), flush=True)
            del q, k, v, g, out, lse, runs, grads, ref, tols
            torch.cuda.empty_cache()
    finally:
        fb._kernel_fns = real
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
