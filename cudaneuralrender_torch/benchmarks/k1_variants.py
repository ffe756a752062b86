"""K1's FP32 chain at widths 32 and 64 against variants of its design.

The march kernel runs the FP32 chain a ray per thread at widths 32 and 64 on
the tensor cores with the activations in registers (csrc/chain.cuh
``chain_tf32_regs``). Each variant here is the same source with one choice
undone, built from an edited copy of ``csrc/`` into the package's build
directory and measured beside the tree's own build in one process:

  * ``rte_chunks``: each k-chunk's truncated sum rounded to even (the wide
    chain's scheme, ``mma_3xtf32_rows``, three products a weight) in place
    of the residual MMA that recovers what the truncation dropped;
  * ``three_products_at_32``: no a_small * b_small product at width 32;
  * ``groups_of_4``: four n-tiles a group of MMA passes, not two;
  * ``block_512_at_64``: 512 threads a block at width 64, not 256.

Per build: ptxas registers / stack / spills of the 32- and 64-wide FP32
march units (csg_demo's neural_raw instantiation); the SDF read off the
kernel on 2^16 seeded points in the bounding sphere against float64,
beside the plain chain's; the float64 witness of
``chip_smoke.undecided_lanes`` on the first two refine rungs of a warm
1080p csg_demo frame (csg_demo widened to 64 at width 64) a ray per thread
(the kernel's mean |SDF - float64| over the plain chain's on the lanes where
the two marches part; chip_smoke.py's bar is ``WITNESS_MEAN``); and the
coarse call and the first rung a ray per thread, by CUDA events (the median
of 5), each variant timed beside the tree in the order tree, variant,
variant, tree. Run on the card from the repository root::

    python -m cudaneuralrender_torch.benchmarks.k1_variants
"""
from __future__ import annotations

import os
import shutil
import statistics

import torch

from ..kernels import build, fused_mlp, megakernel
from ..utils.timing import card_line, time_cuda
from . import require_cuda

#: name -> (file under csrc/, text, its replacement)
VARIANTS = {
    "rte_chunks": ("chain.cuh", "mma_tf32_tiles<kPasses>(acc[q], abig, nbig, asmall, bv);",
                   "mma_3xtf32_rows(acc[q][0], abig[0], asmall[0], bv);\n"
                   "        mma_3xtf32_rows(acc[q][1], abig[1], asmall[1], bv);"),
    "three_products_at_32": ("chain.cuh", "return h == 32 ? 4 : 3;", "return 3;"),
    "groups_of_4": ("chain.cuh", "constexpr int kRegTiles = 2;", "constexpr int kRegTiles = 4;"),
    "block_512_at_64": ("chain.cuh", "(h == 64 ? 256 :", "(h == 64 ? 512 :"),
}


def _load(name: str, edit=None):
    """The library built from csrc/ with ``edit`` applied, loaded."""
    build._lib = None
    if edit is None:
        return build.load_library()
    src = os.path.join(build.BUILD_DIR, "variants", name, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, src)
    path = os.path.join(src, edit[0])
    with open(path) as f:
        text = f.read()
    if edit[1] not in text:
        raise RuntimeError(f"variant {name}: {edit[1]!r} is not in csrc/{edit[0]}")
    with open(path, "w") as f:
        f.write(text.replace(edit[1], edit[2]))
    csrc, out = build.CSRC_DIR, build.BUILD_DIR
    build.CSRC_DIR, build.BUILD_DIR = src, os.path.dirname(src)
    try:
        return build.load_library()
    finally:
        build.CSRC_DIR, build.BUILD_DIR = csrc, out


def _registers(name: str) -> None:
    import chip_smoke

    for label, regs, stack, st, ld in chip_smoke.ptxas_table(build.BUILD_LOG):
        if label in ("march_kernel<H=32, scene=0, window=0, three_pass=0>",
                     "march_kernel<H=64, scene=0, window=0, three_pass=0>"):
            print(f"{name}: {label}: {regs} registers, {stack} B stack, {st} / {ld} B spill "
                  "stores / loads", flush=True)


def _accuracy(name: str, params, hidden: int, calls, card: str) -> None:
    import chip_smoke

    pts = chip_smoke.ball_points(7, 1 << 16, params.device)
    exact = chip_smoke.sdf_float64(params, pts)
    weights, biases, _, _ = fused_mlp.packed_params(params)
    err_k = (chip_smoke.kernel_sdf(params, pts, "highest").double() - exact).abs()
    err_p = (fused_mlp.mlp_forward_plain(weights, biases, pts).double() - exact).abs()
    witness = []
    for a in chip_smoke.compare_recorded_calls(params, calls[1:3]).values():
        if "undecided" in a:
            (km, pm) = a["undecided"]["err_mean"]
            witness.append(round(km / pm, 3))
    print(f"{name}: width {hidden}: |SDF - float64| on 2^16 points kernel mean "
          f"{err_k.mean():.4g} max {err_k.max():.4g}, plain mean {err_p.mean():.4g} max "
          f"{err_p.max():.4g} ({err_k.mean() / err_p.mean():.3f}x the plain mean); witness on "
          f"rungs (4, 16), (8, 24): kernel / plain mean {witness} [{card}]", flush=True)


def _times(libs, params, hidden: int, calls, card: str) -> None:
    ms = {tag: {0: [], 1: []} for tag, _ in libs}
    for tag, lib in libs + libs[::-1]:
        build._lib = lib
        for i in (0, 1):
            origin, dirs, state, cfg, frame, kw = calls[i]
            ms[tag][i].append(time_cuda(lambda: megakernel.march_state(
                params, origin, dirs, state, cfg, frame, _ray_lanes=1, **kw), 5, 1))
    for tag, _ in libs:
        print(f"{tag}: width {hidden}: coarse call {statistics.median(ms[tag][0]):.3f} ms, "
              f"rung (4, 16) {statistics.median(ms[tag][1]):.3f} ms a ray per thread "
              f"{[round(x, 3) for x in ms[tag][0] + ms[tag][1]]} [{card}]", flush=True)


def main(variants=None) -> None:
    require_cuda()
    import chip_smoke

    import cudaneuralrender_torch as cnr

    os.environ.setdefault("CNR_SCHEDULE_MEMO", "")
    card = card_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    tree = _load("tree")
    _registers("tree")
    nets = {32: cnr.load(chip_smoke.ASSET, device=dev), 64: chip_smoke.wide_params(cnr, 2, dev)}
    calls = {}
    for hidden, params in nets.items():
        renderer = cnr.Renderer(params, cnr.RenderConfig(width=1920, height=1080,
                                                         march_impl="staged"))
        cam = cnr.Camera(**chip_smoke.CAMERA)
        renderer.render(cam)
        renderer.render(cam)
        calls[hidden] = chip_smoke.record_march_calls(renderer, cam)
        _accuracy("tree", params, hidden, calls[hidden], card)
    for name in variants or VARIANTS:
        lib = _load(name, VARIANTS[name])
        _registers(name)
        for hidden, params in nets.items():
            build._lib = lib
            _accuracy(name, params, hidden, calls[hidden], card)
            _times([("tree", tree), (name, lib)], params, hidden, calls[hidden], card)
    build._lib = tree


if __name__ == "__main__":
    main()
