"""Command-line interface: render a frame or a turntable of a neural SDF.

The reference binary's flag surface (src/main.cpp:536-631), as the JAX
package's CLI has it:
  -i input geometry (.h5/.npz)  REQUIRED
  -o output path / prefix        (default: {input basename}.png; the
                                  turntable's prefix defaults to {input})
  -H/-W height/width             (default 512)
  -M matcap path                 (enables matcap shading)
  -rx/-ry rotation degrees, -z zoom (default 2 -> eye at distance 2)
  --single   render one frame and exit (prints the MTexels/s line)
  --spin     360-frame turntable, {prefix}_{i:03d}.png (main.cpp:445-478);
             --warm-start chains each frame's surface into the next
             frame's march init (render_sequence(warm_start=True))
  --serve    interactive browser viewer on --port (the GLUT window's
             replacement, render/viewer.py)
  --animation  4-input (x,y,z,frame) mode
plus --scene, --steps, --march, --normal-mode, --stats, --parity-flip,
--pallas (config.use_pallas: the fused forward kernel for every SDF
evaluation outside the march kernel), --fault-inject N (a frame renders band
by band through parallel/fault.py's ``render_tiled``, N band failures
injected and retried), --save-ckpt PATH (re-save the loaded weights as
.npz), --profile DIR (a torch.profiler Chrome trace of the render with the
renderer's ``cnr.*`` phase spans, and their trace snapshot, written into
DIR) and -d/--device (default cuda). With ``cuda`` and no card the CLI
fails; the CPU is used only when asked for with ``-d cpu``.

Run: python -m cudaneuralrender_torch.cli -i examples/assets/csg_demo.npz --single
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cnr-render-torch",
        description="neural-SDF sphere-trace renderer (PyTorch/CUDA)",
    )
    p.add_argument("-i", dest="input", required=True, help="neural geometry (.h5/.npz)")
    p.add_argument("-o", dest="output", default=None, help="output path prefix")
    p.add_argument("-H", dest="height", type=int, default=512)
    p.add_argument("-W", dest="width", type=int, default=512)
    p.add_argument("-M", dest="matcap", default=None, help="matcap PNG (enables matcap shading)")
    p.add_argument("-rx", dest="rx", type=float, default=0.0)
    p.add_argument("-ry", dest="ry", type=float, default=0.0)
    p.add_argument("-rz", dest="rz", type=float, default=0.0,
                   help="accepted for reference parity; orbit camera ignores it")
    p.add_argument("-z", dest="zoom", type=float, default=2.0)
    p.add_argument("-d", "--device", default="cuda",
                   help="torch device to render on (default cuda; cpu only when asked)")
    p.add_argument("--single", action="store_true", help="render one frame and exit")
    p.add_argument("--animation", action="store_true", help="4-input (x,y,z,frame) mode")
    p.add_argument("--scene", default=None, help="scene composition (default: neural_raw)")
    p.add_argument("--steps", type=int, default=6000, help="max march steps")
    p.add_argument("--march", choices=("while", "fori", "staged", "megakernel"),
                   default="staged")
    p.add_argument("--normal-mode", choices=("autodiff", "tetrahedron"), default="autodiff")
    p.add_argument("--parity-flip", action="store_true",
                   help="reproduce the reference's 180° savePNG orientation")
    p.add_argument("--stats", action="store_true",
                   help="print a JSON line of per-frame render stats")
    p.add_argument("--spin", action="store_true", help="360-frame turntable")
    p.add_argument("--warm-start", action="store_true",
                   help="turntable: chain each frame's surface depths into the next frame's "
                        "march init (an approximation near silhouettes; "
                        "RenderConfig.warm_margin)")
    p.add_argument("--serve", action="store_true",
                   help="interactive browser viewer (the GLUT window's replacement)")
    p.add_argument("--port", type=int, default=8000, help="--serve's port (0: any free port)")
    p.add_argument("--save-ckpt", default=None, help="re-save the loaded weights as .npz")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render, with the "
                        "staged frame's cnr.* phase spans (cnr.trace), into DIR (open it "
                        "in Perfetto or chrome://tracing), and the trace's snapshot")
    p.add_argument("--fault-inject", type=int, default=0, metavar="N",
                   help="render band by band with N injected band failures, each "
                        "retried (the fault drill; parallel/fault.py)")
    p.add_argument("--pallas", action="store_true",
                   help="evaluate the SDF through the fused forward kernel (use_pallas)")
    return p


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiled(run, device, out_dir: str):
    """``run()`` under torch.profiler (the card's kernels too on a card)
    with ``cnr.trace`` on, so the Chrome trace written into ``out_dir``
    shows the staged frame's phases as ``cnr.*`` ranges; the trace's
    snapshot (each span's host and device ms, each march call's lanes,
    active lanes and lane-steps) goes beside it. Returns what ``run`` did."""
    from torch.profiler import ProfilerActivity, profile

    from cudaneuralrender_torch import trace

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    trace.enable()
    trace.reset()
    try:
        with profile(activities=activities) as prof:
            out = run()
            _sync(device)
        snapshot = trace.snapshot()
    finally:
        trace.disable()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"render_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"profile trace: {path}")
    path = os.path.join(out_dir, f"trace_{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump(snapshot, f, indent=1)
    print(f"trace snapshot: {path}")
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.utils import image_io

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(pass -d cpu to render on the CPU)", file=sys.stderr)
        return 1

    params = cnr.load(args.input, device=device)
    print(f"Model initialized... ({cnr.mlp.num_params(params)} params, "
          f"layers {cnr.mlp.layer_sizes(params)})")
    if args.save_ckpt:
        cnr.save_pytree(args.save_ckpt, params)
        print(f"saved checkpoint: {args.save_ckpt}")

    num_inputs = 4 if args.animation else 3
    model_in = cnr.mlp.layer_sizes(params)[0]
    if model_in not in (3, 4):
        print(f"error: model {args.input!r} expects {model_in} inputs; the renderer "
              "takes 3-input (x,y,z) or 4-input (x,y,z,frame) models", file=sys.stderr)
        return 2
    if model_in != num_inputs:
        detail = ("--animation needs a 4-input (x,y,z,frame) model" if num_inputs == 4
                  else "this model is 4-input — pass --animation")
        print(f"error: model {args.input!r} expects {model_in} inputs; {detail}",
              file=sys.stderr)
        return 2

    matcap = None
    shading = "facing"
    if args.matcap:
        matcap = image_io.load_matcap(args.matcap)
        shading = "matcap"

    cfg = cnr.RenderConfig(
        width=args.width, height=args.height, max_steps=args.steps,
        scene=args.scene or "neural_raw", shading=shading,
        normal_mode=args.normal_mode, num_inputs=num_inputs, march_impl=args.march,
        use_pallas=args.pallas,
    ).validate()
    renderer = cnr.Renderer(params, cfg, matcap)
    camera = cnr.Camera.from_cli(rx=args.rx, ry=args.ry, zoom=args.zoom)

    if args.serve:
        from cudaneuralrender_torch.render.viewer import serve

        serve(renderer, camera, port=args.port)
        return 0

    def save(rgba, path):
        img = image_io.to_uint8_image(rgba.detach().cpu().numpy(), parity_flip=args.parity_flip)
        if path.lower().endswith(".ppm"):
            image_io.save_ppm(path, img)
        else:
            image_io.save_png(path, img)

    def render_one(cam, frame, path):
        t0 = time.perf_counter()
        if args.fault_inject:
            from cudaneuralrender_torch.parallel import fault

            injector = fault.FaultInjector(fail_times=args.fault_inject)
            rgba = torch.from_numpy(fault.render_tiled(params, cam, cfg, renderer.matcap, frame,
                                                       injector=injector))
            print(f"fault drill: {injector.injected} injected failures recovered")
        elif args.profile:
            rgba = _profiled(lambda: renderer.render(cam, frame), device, args.profile)
        else:
            rgba = renderer.render(cam, frame)
        _sync(device)
        dt = time.perf_counter() - t0
        if args.stats:
            print(json.dumps({"frame": frame, "ms": round(dt * 1e3, 2), "device": str(device),
                              **renderer.last_stats}), flush=True)
        save(rgba, path)
        print(f"saving frame: {path}")
        return dt

    if args.spin:
        # Turntable (doABarrelRoll, main.cpp:470-478): 360 frames stepping
        # the camera yaw and the animation frame number together. The
        # staged config renders through render_sequence in chunks of 24
        # (one host sync per chunk) and resumes: frames already on disk are
        # skipped, so an interrupted turntable continues where it stopped.
        prefix = args.output or args.input
        times = []
        if cfg.march_impl == "staged" and not args.fault_inject:
            todo = [i for i in range(360) if not os.path.exists(f"{prefix}_{i:03d}.png")]
            if len(todo) < 360:
                print(f"turntable resume: {360 - len(todo)} frames already on disk")
            chunk = 24
            for start in range(0, len(todo), chunk):
                idxs = todo[start:start + chunk]
                cams = [cnr.Camera.from_cli(rx=args.rx, ry=float(i), zoom=args.zoom)
                        for i in idxs]
                t0 = time.perf_counter()
                rgbas = cnr.render_sequence(params, cams, cfg, renderer.matcap,
                                            frames=[float(i) for i in idxs],
                                            warm_start=args.warm_start)
                _sync(device)
                times.append((time.perf_counter() - t0) / len(idxs))
                for i, rgba in zip(idxs, rgbas):
                    save(rgba, f"{prefix}_{i:03d}.png")
            # the first chunk carries the first-use set-up and the memo's lesson
            mean_s = sum(times[1:]) / (len(times) - 1) if len(times) > 1 else sum(times)
            print(f"turntable done: 360 frames, mean {mean_s:.3f} s/frame (pipelined)")
            return 0
        for i in range(360):
            cam = cnr.Camera.from_cli(rx=args.rx, ry=float(i), zoom=args.zoom)
            times.append(render_one(cam, float(i), f"{prefix}_{i:03d}.png"))
        print(f"turntable done: 360 frames, mean {sum(times[1:]) / 359:.3f} s/frame")
        return 0

    base = os.path.basename(args.input)
    path = args.output or f"{base}.png"
    dt = render_one(camera, 0.0, path)
    n_tex = args.width * args.height
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(
        "volumeRender, Throughput = %.4f MTexels/s, Time = %.5f s, Size = %u Texels, "
        "NumDevsUsed = %u, Workgroup = %u"
        % (1.0e-6 * n_tex / dt, dt, n_tex, n_dev, 0)
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
