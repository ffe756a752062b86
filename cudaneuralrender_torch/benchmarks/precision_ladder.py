"""The mixed march's precision ladder on the card: each chain's error and a
sweep of the coarse phase's precision and epsilon.

The staged frame marches every ray to ``coarse_eps`` at
``coarse_precision`` (the coarse call), then re-marches the near-surface
set at FP32 down to ``march_eps`` (the HIGHEST rungs). Two chains can run
the coarse call: "default", the FP32 chain (tf32 / 3xTF32 on the tensor
cores, as the HIGHEST rungs run it), and "high", the three-pass bfloat16
chain K2h. An epsilon must dominate its chain's SDF error, or the coarse
phase stops rays where the error, not the surface, decides. This module

  1. measures each chain's max |SDF - float64|, read off the march kernel
     (``chip_smoke.kernel_sdf``), on seeded points in the bounding sphere:
     csg_demo widened to every kernel width 32-1024 (``chip_smoke.widen``;
     2^20 points, 2^18 at 1024), and the 4-input anim_demo at frames 0 and
     37 (printed: at 37 its SDF is 13 or more in the whole bounding sphere,
     where no ray stops on it);
  2. renders every cell of ``CELLS`` through ``Renderer.render`` at each
     row: ``coarse_precision`` in ``PRECISIONS`` x ``coarse_eps`` in
     ``EPSILONS``, a row marched only where its eps is at least
     ``ERR_FACTOR`` times its chain's error at the cell's width. Per row:
     the median of the cell's warm frames and their min-max, the coarse
     call's and the HIGHEST rungs' ms by CUDA events (the calls of one
     more frame replayed), the deepest step, unresolved lanes and hits,
     the mixed bar against the cell at ``march_precision="full"``
     (``chip_smoke.mixed_bar``'s: hit masks agree on >= 99%, >= 97% of the
     common hits within 1e-3), the 256x256 golden's IoU per csg_demo net,
     and on csg_demo the first HIGHEST rung with its relaxation off (as it
     runs) and on (``RUNG0_OMEGA``), to re-check that choice at the row's
     entry distance;
  3. picks the pair (``choose``) that (a) dominates its chain's error by
     ERR_FACTOR at every width, (b) meets the mixed bar on every cell and
     keeps the golden IoU of ``BASELINE``, (c) gives the
     lowest median csg_demo frame, and reports (d): the cells where it is
     slower than ``BASELINE`` by more than the cell's min-max spread.

Each row prints one line ``ladder row {json}``; ``--out PATH`` also writes
them as JSON lines. Run on the card from the repository root (it imports
``chip_smoke`` for the shared checks; ~6 minutes on an H100)::

    python -m cudaneuralrender_torch.benchmarks.precision_ladder --out ladder.jsonl
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import time

import torch

from ..utils.timing import card_line, time_cuda
from . import ASSET, require_cuda

ANIM_ASSET = os.path.join(os.path.dirname(ASSET), "anim_demo.npz")
CAMERA = dict(rotation_y=30.0, rotation_x=-20.0)
PRECISIONS = ("default", "high")
EPSILONS = (0.05, 1e-2, 3e-3, 1e-3, 3e-4, 1e-4)
ERR_FACTOR = 10.0
BASELINE = ("default", 0.05)  # the JAX package's ladder (the TPU's)
RUNG0_OMEGA = 1.6

#: (name, asset, scene, frame, widening factor, (width, height), timed frames)
Cell = collections.namedtuple("Cell", "name asset scene frame k side frames")
CELLS = (
    Cell("csg_demo", ASSET, "neural_raw", 0.0, 1, (1920, 1080), 5),
    Cell("many_sphere_f90", ASSET, "many_sphere", 90.0, 1, (1920, 1080), 5),
    Cell("anim_demo_many_sphere_f37", ANIM_ASSET, "many_sphere", 37.0, 1, (1920, 1080), 5),
    Cell("width64", ASSET, "neural_raw", 0.0, 2, (1920, 1080), 5),
    Cell("width128", ASSET, "neural_raw", 0.0, 4, (1920, 1080), 1),
    Cell("width256", ASSET, "neural_raw", 0.0, 8, (512, 512), 1),
    Cell("width512", ASSET, "neural_raw", 0.0, 16, (256, 256), 1),
)
#: The widths whose chain errors bound an epsilon (rule a), and their points.
ERROR_WIDTHS = {32: 1 << 20, 64: 1 << 20, 128: 1 << 20, 256: 1 << 20, 512: 1 << 20,
                1024: 1 << 18}
ANIM_FRAMES = (0.0, 37.0)


def chain_errors(cs, dev, card, widths=ERROR_WIDTHS) -> dict:
    """{precision: {width: max |SDF - float64|}} of the kernel's FP32
    ("default") and three-pass ("high") chains, read off the march kernel
    on seeded points in the bounding sphere (the seed the width, as
    ``chip_smoke.sdf_errors``); anim_demo's at ANIM_FRAMES printed beside
    them (keys "anim_demo_f0", ...) with the least |SDF| over the points."""
    import cudaneuralrender_torch as cnr

    errors = {p: {} for p in PRECISIONS}
    nets = [(h, cs.wide_params(cnr, h // 32, dev), n, 0.0) for h, n in widths.items()]
    anim = cs.wide_params(cnr, 1, dev, ANIM_ASSET)
    nets += [(f"anim_demo_f{f:g}", anim, 1 << 20, f) for f in ANIM_FRAMES]
    for key, params, n, frame in nets:
        pts = cs.ball_points(key if isinstance(key, int) else 32, n, dev)
        want = cs.sdf_float64(params, pts, frame)
        for prec in PRECISIONS:
            got = cs.kernel_sdf(params, pts, prec, frame)
            errors[prec][key] = (got.double() - want).abs().max().item()
        print(f"ladder chain error {key}: max |SDF - float64| over {n} points (least |SDF| "
              f"{want.abs().min().item():.3g}), FP32 chain {errors['default'][key]:.3g}, "
              f"three-pass chain {errors['high'][key]:.3g} [{card}]", flush=True)
    return errors


def width_error(errors, precision: str) -> float:
    """A chain's largest error over the kernel widths (rule a)."""
    return max(v for k, v in errors[precision].items() if isinstance(k, int))


def _bar(img, ref) -> dict:
    """``chip_smoke.mixed_bar``'s shares, without raising."""
    hit, hit_ref = img[..., 3] > 0, ref[..., 3] > 0
    both = hit & hit_ref
    close = (img - ref).abs().amax(dim=-1)[both].lt(1e-3).float().mean().item()
    agree = (hit == hit_ref).float().mean().item()
    return dict(agree=agree, close=close, common=int(both.sum()),
                ok=agree >= 0.99 and close >= 0.97 and int(both.sum()) > 0)


def _golden_iou(cs, cnr, params, cam, fields) -> float:
    """IoU of the 256x256 golden render under ``fields`` (csg_demo nets)."""
    from ..utils import image_io

    gold = cnr.RenderConfig(width=256, height=256, scene="neural_raw", max_steps=500,
                            march_impl="staged", **fields)
    ours = cnr.Renderer(params, gold).render_frame(cam)
    return cs.golden_check(ours, image_io.load_png(cs.GOLDEN))[0]


def _call_ms(params, call, reps: int) -> float:
    from ..kernels import megakernel

    origin, dirs, state, config, frame, kw = call
    return time_cuda(lambda: megakernel.march_state(params, origin, dirs, state, config, frame,
                                                    **kw), reps)


def _rung0_relax(params, call, reps: int) -> dict:
    """The first HIGHEST rung as it runs (relaxation off) and relaxed at
    RUNG0_OMEGA: ms, and the lanes still active after it."""
    from ..kernels import megakernel

    origin, dirs, state, config, frame, kw = call
    out = {}
    for name, omega in (("off", 0.0), ("on", RUNG0_OMEGA)):
        kwo = dict(kw, relax_omega=omega)
        res = megakernel.march_state(params, origin, dirs, state, config, frame, **kwo)
        out[name] = dict(ms=time_cuda(lambda: megakernel.march_state(
            params, origin, dirs, state, config, frame, **kwo), reps),
            active_out=int(res.active.sum()), converged=int(res.converged.sum()))
    out["active_in"] = int(state.active.sum())
    return out


def measure_row(cs, cnr, params, cell, precision, eps, ref, card, golden=None) -> dict:
    """One row of the sweep on one cell (see the module docstring)."""
    cam = cnr.Camera(**CAMERA)
    w, h = cell.side
    fields = dict(coarse_precision=precision, coarse_eps=eps)
    cfg = cnr.RenderConfig(width=w, height=h, march_impl="staged", scene=cell.scene,
                           num_inputs=params[0].w.shape[0], **fields)
    renderer = cnr.Renderer(params, cfg)
    renderer.render(cam, cell.frame)  # cold: may overflow and teach the memo
    img = renderer.render(cam, cell.frame)
    ms = cs.time_frames(lambda: renderer.render(cam, cell.frame), cell.frames)
    stats = dict(renderer.last_stats)
    calls = cs.record_calls(lambda: renderer.render(cam, cell.frame))
    if not calls[0][5].get("coarse"):
        raise RuntimeError(f"{cell.name}: the frame's first march call is not the coarse call")
    reps = 5 if cell.frames > 1 else 1
    coarse_ms = _call_ms(params, calls[0], reps)
    rung_ms = [_call_ms(params, c, reps) for c in calls[1:]]
    row = dict(cell=cell.name, precision=precision, eps=eps, frame_ms=statistics.median(ms),
               frame_min=min(ms), frame_max=max(ms), frames=[round(x, 3) for x in ms],
               coarse_ms=coarse_ms, rungs_ms=sum(rung_ms), rung_ms=rung_ms,
               steps=stats.get("steps"), unresolved=stats.get("unresolved"),
               hits=stats.get("hits"), fast_path=stats.get("fast_path"),
               bar=_bar(img, ref), golden_iou=golden)
    if cell.name == "csg_demo" and len(calls) > 1:
        row["rung0"] = _rung0_relax(params, calls[1], reps)
    print(f"ladder row {json.dumps(row)} [{card}]", flush=True)
    return row


def sweep(cs, dev, card, errors, cells=CELLS, out=None) -> list:
    """Every row of every cell (``measure_row``), the rows of a cell
    skipped where eps < ERR_FACTOR x its chain's error at the cell's width."""
    import cudaneuralrender_torch as cnr

    cam = cnr.Camera(**CAMERA)
    rows, goldens = [], {}
    for cell in cells:
        params = cs.wide_params(cnr, cell.k, dev, cell.asset)
        hidden = 32 * cell.k
        w, h = cell.side
        cfg = cnr.RenderConfig(width=w, height=h, march_impl="staged", scene=cell.scene,
                               num_inputs=params[0].w.shape[0])
        t0 = time.perf_counter()
        ref = cnr.render_staged(params, cam, cfg.replace(march_precision="full"),
                                frame=cell.frame)
        print(f"ladder {cell.name}: march_precision=\"full\" reference in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for precision in PRECISIONS:
            for eps in EPSILONS:
                if eps < ERR_FACTOR * errors[precision][hidden]:
                    continue
                golden = None
                if cell.asset == ASSET:
                    key = (hidden, precision, eps)
                    if key not in goldens:
                        goldens[key] = _golden_iou(cs, cnr, params, cam, dict(
                            coarse_precision=precision, coarse_eps=eps))
                    golden = goldens[key]
                row = measure_row(cs, cnr, params, cell, precision, eps, ref, card, golden)
                rows.append(row)
                if out is not None:
                    out.write(json.dumps(row) + "\n")
                    out.flush()
        del params, ref
        torch.cuda.empty_cache()
    return rows


def choose(rows, errors, baseline=BASELINE) -> dict:
    """The pair the four rules pick (module docstring), and per candidate
    pair the rules it fails: "a", "b", and for (d) the cells slower than
    ``baseline`` by more than the larger min-max spread of the two rows."""
    cells = list(dict.fromkeys(r["cell"] for r in rows))
    by = {(r["cell"], r["precision"], r["eps"]): r for r in rows}
    first = cells[0]
    verdicts = {}
    for (cell, precision, eps), r in by.items():
        if cell != first:
            continue
        mine = [by.get((c, precision, eps)) for c in cells]
        base = [by[(c, *baseline)] for c in cells]
        a = eps >= ERR_FACTOR * width_error(errors, precision)
        b = all(m is not None and m["bar"]["ok"]
                and (m["golden_iou"] is None or m["golden_iou"] >= o["golden_iou"])
                for m, o in zip(mine, base))
        slower = [c for c, m, o in zip(cells, mine, base) if c != first and m is not None
                  and m["frame_ms"] > o["frame_ms"] + max(m["frame_max"] - m["frame_min"],
                                                          o["frame_max"] - o["frame_min"])]
        verdicts[f"{precision}/{eps:g}"] = dict(
            precision=precision, eps=eps, a=a, b=b, frame_ms=r["frame_ms"], d_slower=slower)
    ok = [v for v in verdicts.values() if v["a"] and v["b"]]
    chosen = min(ok, key=lambda v: v["frame_ms"]) if ok else None
    return dict(chosen=chosen, verdicts=verdicts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the rows as JSON lines here")
    args = ap.parse_args(argv)
    dev = require_cuda()
    os.environ.setdefault("CNR_SCHEDULE_MEMO", "")
    import chip_smoke as cs  # the repository root's checks: run from the root

    from ..kernels import build

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.load_library()
    print(f"ladder build: {time.perf_counter() - t0:.1f} s", flush=True)
    errors = chain_errors(cs, dev, card)
    out = open(args.out, "w") if args.out else None
    try:
        if out is not None:
            out.write(json.dumps(dict(errors={p: {str(k): v for k, v in e.items()}
                                              for p, e in errors.items()})) + "\n")
        rows = sweep(cs, dev, card, errors, out=out)
    finally:
        if out is not None:
            out.close()
    pick = choose(rows, errors)
    for name, v in pick["verdicts"].items():
        print(f"ladder verdict {name}: {json.dumps(v)}")
    print(f"ladder chosen: {json.dumps(pick['chosen'])} (total "
          f"{time.perf_counter() - t0:.1f} s) [{card}]", flush=True)


if __name__ == "__main__":
    main()
