"""The plain reference: a neural-SDF sphere tracer in plain PyTorch.

It follows the reference renderer's semantics (the CUDA program the port
was built from; the frozen NumPy oracle beside this file is the same
semantics in NumPy) and what a cell's configuration states on top of them:

  * camera, rays and bounding-sphere entry as ``main.cpp:207-222`` and
    ``volumeRender_kernel.cu:305-342``;
  * plain sphere tracing in ``singleMarch`` order (``:459-476``), no
    over-relaxation, down to ``march_eps`` with at most ``max_steps`` steps;
  * the scene compose (``neural_raw``, ``many_sphere``, ``:176-230``);
  * facing shading (``:381-384``) of the configuration's normals: the exact
    gradient of the scene SDF (``normal_mode: autodiff``; a pre-activation of
    exactly 0 takes the gradient 1/2), packed to bytes as ``rgbaFloatToInt``
    (``:266-274``) packs them.

Everything runs in float32 with TF32 off, unless a caller asks for the
lower-precision control (``precision="tf32"``). It takes the net's distance
function (``Net`` for a dense chain; a model kind's ``reference_net``) and
the poses, and imports nothing of the program under test.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import numpy as np
import torch

#: Pixels per block of rays the tracer marches at once.
BLOCK_RAYS = 1 << 21
#: On the card, the rays left when at most this many are live march to the
#: end in replays of one CUDA graph of ``TAIL_STEPS`` steps.
TAIL_RAYS = 16384
TAIL_STEPS = 32


@contextlib.contextmanager
def matmul_precision(precision: str, device: torch.device, net):
    """FP32 matmuls (``"float32"``, TF32 off) or TF32 ones (``"tf32"``).

    On the card TF32 is the tensor cores' own; on the CPU, which has none,
    ``net.emulate_tf32`` is switched on: each matmul operand is rounded to
    TF32's 10-bit mantissa (round to nearest) and the product accumulates in
    float32, as the card does."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             net.emulate_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    net.emulate_tf32 = on and device.type != "cuda"
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         net.emulate_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """``x @ w`` with both operands rounded to TF32, forward and backward
    (the gradient flows to ``x`` only: the weights are constants)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        return round_tf32(x) @ round_tf32(w)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return round_tf32(g) @ round_tf32(w).T, None


class _ReluTie(torch.autograd.Function):
    """ReLU whose gradient at a pre-activation of exactly 0 is 1/2."""

    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        return torch.clamp(h, min=0.0)

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        return g * ((h > 0).to(g.dtype) + 0.5 * (h == 0).to(g.dtype))


class Net:
    """Dense layers ``h = x @ w + b``: ReLU after every layer but the last."""

    def __init__(self, layers: Sequence[Tuple[np.ndarray, np.ndarray]], device):
        self.layers = [(torch.as_tensor(np.asarray(w, np.float32), device=device),
                        torch.as_tensor(np.asarray(b, np.float32), device=device))
                       for w, b in layers]
        self.emulate_tf32 = False

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        last = len(self.layers) - 1
        for i, (w, b) in enumerate(self.layers):
            if self.emulate_tf32:
                h = _Tf32Matmul.apply(h, w) + b
            else:
                h = h @ w + b
            if i < last:
                h = _ReluTie.apply(h)
        return h[:, 0]


def _smooth_union(d1, d2, k: float):
    h = torch.clamp(0.5 + 0.5 * (d2 - d1) / k, 0.0, 1.0)
    return d2 * (1.0 - h) + d1 * h - k * h * (1.0 - h)


def _sphere_offsets(z) -> np.ndarray:
    """manySphere's 9 offsets added to p (``:176-196``), accumulated in
    float32 as the loop does: y starts at -0.6 and gains 0.4 every third
    sphere, where x restarts at 0.5; x loses 0.4 a sphere; z is the frame's."""
    f = np.float32
    out, y, x = [], f(-0.6), f(0.0)
    for i in range(9):
        if i % 3 == 0:
            y, x = f(y + f(0.4)), f(0.5)
        out.append((x, y, z))
        x = f(x - f(0.4))
    return np.asarray(out, np.float32)


def scene_sdf(net, scene: str, frame: float, device):
    """The scene's distance function over [N, 3] points on ``device``."""
    if scene == "neural_raw":
        return net
    if scene == "many_sphere":
        z = np.float32(-0.7) + np.float32(frame) * np.float32(2.0 * 0.7 / 360.0)
        offsets = torch.as_tensor(_sphere_offsets(z), device=device)

        def many_sphere(p):
            s = net(p)
            q = p[:, None, :] + offsets
            d = torch.sqrt(torch.sum(q * q, dim=-1)) - 0.1
            for i in range(9):
                s = _smooth_union(s, d[:, i], 0.01)
            return s

        return many_sphere
    raise ValueError(f"the reference composes no scene {scene!r}")


def view_matrices(rx: float, ry: float, translation=(0.0, 0.0, -2.0), device="cpu"):
    """cam_to_world [3, 4]: Rx(-rx) @ Ry(-ry), then translate by -T, in
    float32 on ``device``."""
    ax, ay = torch.deg2rad(torch.tensor([-rx, -ry], dtype=torch.float32, device=device))
    cx, sx, cy, sy = torch.cos(ax), torch.sin(ax), torch.cos(ay), torch.sin(ay)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    rot_x = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, cx, -sx]),
                         torch.stack([zero, sx, cx])])
    rot_y = torch.stack([torch.stack([cy, zero, sy]), torch.stack([zero, one, zero]),
                         torch.stack([-sy, zero, cy])])
    r = rot_x @ rot_y
    t = torch.tensor(translation, dtype=torch.float32, device=device)
    return torch.cat([r, (r @ -t)[:, None]], dim=1)


def ray_dirs(cam_to_world, idx: torch.Tensor, height: int, width: int, focal: float):
    """World directions of flat pixel indices ``y * W + x`` (row 0 = bottom)."""
    x = (idx % width).to(torch.float32)
    y = torch.div(idx, width, rounding_mode="floor").to(torch.float32)
    d = torch.stack([x / width * 2.0 - 1.0, y / height * 2.0 - 1.0,
                     torch.full_like(x, -focal)], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d @ cam_to_world[:, :3].T


class _Rays:
    """The march state of a set of rays, updated in place."""

    def __init__(self, dirs, t, budget, live):
        self.dirs, self.t, self.budget, self.live = dirs, t, budget, live
        self.conv = torch.zeros_like(live)
        self.evals = torch.zeros(live.shape[0], dtype=torch.int32, device=live.device)


def _march(sdf, origin, r: _Rays, steps: int, eps: float) -> None:
    """``steps`` masked sphere-trace steps in ``singleMarch`` order: the
    distance, the budget (a ray whose budget runs out misses and does not
    move), the move, and convergence on a distance under ``eps``."""
    for _ in range(steps):
        d = sdf(origin + r.dirs * r.t[:, None])
        r.evals += r.live.to(torch.int32)
        r.budget -= torch.where(r.live, d, 0.0)
        moved = r.live & (r.budget > 0.0)
        r.t.copy_(torch.where(moved, r.t + d, r.t))
        now = moved & (d < eps)
        r.conv |= now
        r.live.copy_(moved & ~now)


def _gather(idx, dirs, t, budget) -> _Rays:
    return _Rays(dirs[idx], t[idx], budget[idx],
                 torch.ones(idx.numel(), dtype=torch.bool, device=idx.device))


def _tail(sdf, origin, r: _Rays, done: int, max_steps: int, eps: float) -> None:
    """The last few rays, ``TAIL_STEPS`` steps to a replay of one CUDA graph
    (the same operations, without a launch from the host for each)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # one real step warms the libraries up
        _march(sdf, origin, r, 1, eps)
    torch.cuda.current_stream().wait_stream(stream)
    done += 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _march(sdf, origin, r, TAIL_STEPS, eps)
    while done < max_steps and bool(r.live.any()):
        if done + TAIL_STEPS <= max_steps:
            graph.replay()
            done += TAIL_STEPS
        else:
            _march(sdf, origin, r, max_steps - done, eps)
            done = max_steps


def trace(sdf, origin, dirs, *, max_steps: int, eps: float, radius: float):
    """Plain sphere trace from the bounding sphere's near intersection.

    Returns (t [N], hit [N] bool, evaluations [N] int32): the distance along
    each ray, whether it converged, and how many SDF evaluations it took."""
    n = dirs.shape[0]
    dev = dirs.device
    b = 2.0 * (dirs @ origin)
    a = torch.sum(dirs * dirs, dim=-1)
    c = torch.dot(origin, origin) - radius * radius
    disc = b * b - 4.0 * a * c
    inside = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    tnear = torch.clamp((-b - sq) / (2.0 * a), min=0.0)
    tfar = (-b + sq) / (2.0 * a)
    t = torch.where(inside, tnear, 0.0)
    budget = torch.where(inside, tfar, 0.0)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    evals = torch.zeros(n, dtype=torch.int32, device=dev)
    idx = torch.nonzero(inside).flatten()
    done = 0
    while idx.numel() and done < max_steps:
        if dev.type == "cuda" and idx.numel() <= TAIL_RAYS:
            # Pad the last rays to a fixed size, so one graph serves them.
            m = idx.numel()
            pad = torch.zeros(TAIL_RAYS - m, dtype=idx.dtype, device=dev)
            r = _gather(torch.cat([idx, pad]), dirs, t, budget)
            r.live[m:] = False
            _tail(sdf, origin, r, done, max_steps, eps)
        else:
            r = _gather(idx, dirs, t, budget)
            steps = min(8 if idx.numel() > 65536 else 64, max_steps - done)
            _march(sdf, origin, r, steps, eps)
            done += steps
            m = idx.numel()
        t[idx], budget[idx] = r.t[:m], r.budget[:m]
        hit[idx] |= r.conv[:m]
        evals[idx] += r.evals[:m]
        if dev.type == "cuda" and m <= TAIL_RAYS:
            break
        idx = idx[r.live]
    return t, hit, evals


def facing_bytes(sdf, origin, dirs, t, hit, tilt: float = 0.0) -> torch.Tensor:
    """Grey level of each hit ray's facing ratio, as rgbaFloatToInt packs it.
    ``tilt`` > 0 plants a fault: each normal pushed by ``tilt`` along
    (1, 1, 1) / sqrt(3) before it is normalised."""
    grey = torch.zeros(dirs.shape[0], dtype=torch.uint8, device=dirs.device)
    idx = torch.nonzero(hit).flatten()
    if not idx.numel():
        return grey
    d = dirs[idx]
    with torch.enable_grad():
        p = (origin + d * t[idx][:, None]).detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sdf(p).sum(), p)
    n = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    if tilt:
        n = n + tilt / 3.0 ** 0.5
        n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    ratio = torch.clamp(torch.sum(n * -d, dim=-1), min=0.0)
    grey[idx] = (torch.clamp(ratio, 0.0, 1.0) * 255.0).to(torch.uint8)
    return grey


def render(net, pose: dict, *, scene: str, width: int, height: int, device,
           max_steps: int, march_eps: float, bound_radius: float, focal: float,
           precision: str = "float32", pixels: torch.Tensor | None = None,
           tilt: float = 0.0) -> dict:
    """One frame of the distance function ``net`` (a model kind's
    ``reference_net``) at ``pose`` (rotation_x, rotation_y, frame), in
    blocks of rays.

    ``pixels`` limits it to those flat indices (row 0 = bottom). Returns
    ``grey`` and ``alpha`` (uint8 [N], the bytes of each pixel's r/g/b and
    a) and ``evals`` (int32 [N], SDF evaluations of the march). ``tilt``
    plants a fault in the normals (``facing_bytes``)."""
    dev = torch.device(device)
    with matmul_precision(precision, dev, net):
        sdf = scene_sdf(net, scene, float(pose.get("frame", 0.0)), dev)
        cam = view_matrices(pose["rotation_x"], pose["rotation_y"], device=dev)
        origin = cam[:, 3].contiguous()
        if pixels is None:
            pixels = torch.arange(width * height, device=dev)
        pixels = pixels.to(dev)
        parts = {"grey": [], "alpha": [], "evals": []}
        with torch.no_grad():
            for lo in range(0, pixels.numel(), BLOCK_RAYS):
                dirs = ray_dirs(cam, pixels[lo:lo + BLOCK_RAYS], height, width, focal)
                t, hit, evals = trace(sdf, origin, dirs, max_steps=max_steps,
                                      eps=march_eps, radius=bound_radius)
                parts["grey"].append(facing_bytes(sdf, origin, dirs, t, hit, tilt))
                parts["alpha"].append(hit.to(torch.uint8) * 255)
                parts["evals"].append(evals)
    return {k: torch.cat(v) for k, v in parts.items()}
