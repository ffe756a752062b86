"""X2: where does a march step's time go?

The counterpart of the JAX package's ``benchmarks/exp_stepcost.py``: a march
of a fixed number of steps with no early exit (every lane active, so time
over lanes x steps is the cost of one lane-step), in three variants:

  * ``chain_only``: t += sdf(t), the chain and one add;
  * ``march_state``: the state update, t += d where the lane is neither
    converged (d < 1e-6) nor invalid (d <= -1e30);
  * ``march_relax``: the coarse kernel's bookkeeping: over-relaxation with
    backtrack (omega 1.6), the budget (3), the miss and converged flags;
    the output is t + converged * 1e-9.

sdf(t) is the chain's head at o + d*t: FP32, or the three-pass chain K2h
(``three_pass``); ``act_dtype=torch.bfloat16`` rounds the point to
bfloat16 first, as the JAX script's ``act_dtype`` rounds its padded input.

``step_cost`` launches ``x2_stepcost_kernel`` (csrc/experiments.cu), the
counterpart of the kernel ``make_kernel`` builds and ``run_variant``
launches (``pallas_call`` at exp_stepcost.py:134), on CUDA tensors and
counts it in ``LAUNCHES``; on CPU tensors it runs ``step_cost_plain``.
Inputs keep the JAX layout: dirs [3, n], t0 [1, n], origin [3, 1]; the
weights are the padded FP32 stack, laid out for the tensor cores on each
call (``fused_mlp.pack_mma``: "tf32" for the FP32 chain, "bf16", the
bfloat16 halves ``run_variant`` splits, for the three-pass one).

The kernel times the two chains the march kernel ships at width 32, for a
warp's 32 lanes together on the tensor cores, with the march around them:
K1's tf32 chain (csrc/chain.cuh ``chain_tf32_regs``; FP32 grade, bounded by
3 tf32 products a weight at 495 TFLOP/s) and K2h's bf16 chain
(``chain_3pass_regs``; 3 bf16 products a weight at 989 TFLOP/s). They sum
in the tensor cores' order, no longer the plain version's bit for bit:
``step_cost_model`` repeats the plain version's steps with each chain as
the kernel sums it (``fused_mlp.mlp_chain_3xtf32_mma``,
``fused_mlp.mlp_chain_3pass_mma``).

``main()`` runs the JAX script's rows on the card: n = 2^21 rays of a
2048x1024 Camera(rotation_y=25) image, t0 0.8, 64 steps, csg_demo's
weights. DEFAULT and HIGHEST run the same FP32 kernel here, and the JAX
script's tiles (8192 / 16384 lanes) have no counterpart. Its last two rows
(march_state and march_relax on the three-pass chain) are not the JAX
script's: they run the two kernels its rows leave out.

    python -m cudaneuralrender_torch.benchmarks.exp_stepcost
"""
from __future__ import annotations

import torch

from ..kernels import build, fused_mlp
from ..utils.timing import card_line, time_cuda
from . import TIMED_RUNS, demo_stack, launch, output_counts, padded, point_rows, require_cuda

STEPS = 64
VARIANTS = ("chain_only", "march_state", "march_relax")
WIDTH = 32  # the kernel's width: the nets the JAX script runs

#: Launches of the CUDA kernel in this process, by instantiation.
LAUNCHES = {v + s: 0 for v in VARIANTS for s in ("", "_3pass")}

#: main()'s rows: (the JAX script's label, variant, three_pass).
ROWS = (
    ("chain_only HIGHEST", "chain_only", False),
    ("chain_only DEFAULT", "chain_only", False),
    ("chain_only 3PASS(HIGH emu)", "chain_only", True),
    ("march_state DEFAULT", "march_state", False),
    ("march_relax DEFAULT", "march_relax", False),
    ("march_relax HIGHEST", "march_relax", False),
    ("march_state 3PASS(HIGH emu)", "march_state", True),
    ("march_relax 3PASS(HIGH emu)", "march_relax", True),
)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_variant(variant: str, act_dtype) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    if act_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"act_dtype must be float32 or bfloat16, not {act_dtype}")


def march_steps(variant: str, sdf, dirs: torch.Tensor, t0: torch.Tensor,
                origin: torch.Tensor, *, steps: int = STEPS, act_dtype=torch.float32,
                trace=None) -> torch.Tensor:
    """``steps`` steps of ``variant`` for every lane at once from t0 [1, n]:
    ``sdf`` (points [n, 3] -> distances [n]) is the chain at o + d*t
    (``point_rows``; a float64 t0 marches in float64, its points unrounded),
    the points rounded to bfloat16 first where ``act_dtype`` says so.
    ``trace``, if given, is called once a step with a dict of the lanes
    whose state the step can change (``idx``), their points, distances,
    state before the step (budget, prev_r, step_len; an infinite budget
    where the variant keeps none) and decisions (sor_fail, near, moved), in
    the keys of ``megakernel.march_state_plain``'s trace: where two marches
    part (``chip_smoke.x2_beyond``). Returns t [1, n]."""
    _check_variant(variant, act_dtype)
    n = dirs.shape[1]

    def at(t):
        if t.dtype == torch.float64:
            pts = origin.reshape(1, 3) + dirs.t() * t[:, None]
        else:
            pts = point_rows(origin, dirs, t)
        if act_dtype == torch.bfloat16:
            pts = pts.to(torch.bfloat16).float()
        return pts, sdf(pts)

    t = t0.reshape(n).clone()
    if variant == "march_relax":
        budget = torch.full_like(t, 3.0)
        active = torch.ones_like(t, dtype=torch.bool)
        conv = torch.zeros_like(active)
        prev_r = torch.zeros_like(t)
        step_len = torch.zeros_like(t)
        for step in range(steps):
            pts, d = at(t)
            sor_fail = active & (step_len > prev_r) & (d + prev_r < step_len)
            near = active & ~sor_fail & (d < 1e-6)
            om = torch.where(step_len < 0.0, 1.0, 1.6)
            stepv = torch.where(sor_fail, prev_r - step_len, torch.where(near, d, om * d))
            moved = active & ~(~sor_fail & (budget - stepv <= 0.0))
            if trace is not None:
                idx = active.nonzero().squeeze(1)
                trace(dict(step=step, idx=idx, pts=pts[idx], d=d[idx], budget=budget[idx],
                           prev_r=prev_r[idx], step_len=step_len[idx],
                           sor_fail=sor_fail[idx], near=near[idx], moved=moved[idx]))
            budget = torch.where(active, budget - stepv, budget)
            t = torch.where(moved, t + stepv, t)
            conv_now = moved & near
            active = moved & ~conv_now
            conv = conv | conv_now
            prev_r = torch.where(moved & ~sor_fail, d, prev_r)
            step_len = torch.where(moved, stepv, step_len)
        t = torch.where(conv, t + 1e-9, t)
    else:
        for step in range(steps):
            pts, d = at(t)
            act = d > -1e30
            near = d < 1e-6
            if trace is not None:
                no = torch.zeros_like(act)
                trace(dict(step=step, idx=torch.arange(n, device=t.device), pts=pts, d=d,
                           budget=torch.full_like(t, float("inf")),
                           prev_r=torch.zeros_like(t), step_len=torch.zeros_like(t),
                           sor_fail=no, near=near if variant == "march_state" else no,
                           moved=act if variant == "march_state" else ~no))
            if variant == "chain_only":
                t = t + d
            else:
                t = torch.where(act & ~near, t + d, t)
    return t.reshape(1, n)


def plain_sdf(weights: torch.Tensor, biases: torch.Tensor, three_pass: bool = False):
    """The plain version's chain as ``march_steps`` takes it (points [n, 3]
    -> the head [n]): the FP32 chain, or the three-pass one on the
    bfloat16 halves of the weights, on the padded rows
    (``fused_mlp.plain_rows``)."""
    n_layers, hidden = weights.shape[0], weights.shape[1]
    if three_pass:
        w_hi, w_lo = fused_mlp.split_hi_lo(weights)

        def chain(x):
            return fused_mlp.mlp_chain_3pass_plain(w_hi, w_lo, biases, x, n_layers)
    else:
        def chain(x):
            return fused_mlp.mlp_chain_plain(weights, biases, x, n_layers)

    def sdf(pts):
        return fused_mlp.chain_in_blocks(chain, padded(pts, hidden))[:pts.shape[0], 0]

    return sdf


def step_cost_plain(variant: str, weights: torch.Tensor, biases: torch.Tensor,
                    dirs: torch.Tensor, t0: torch.Tensor, origin: torch.Tensor, *,
                    steps: int = STEPS, three_pass: bool = False,
                    act_dtype=torch.float32) -> torch.Tensor:
    """Plain version on any device: every lane at once, one step at a time
    (``march_steps``), the chain on the padded rows (``plain_sdf``).
    Returns t [1, n]."""
    return march_steps(variant, plain_sdf(weights, biases, three_pass), dirs, t0, origin,
                       steps=steps, act_dtype=act_dtype)


def model_sdf(weights: torch.Tensor, biases: torch.Tensor, three_pass: bool = False):
    """The kernel's chain as it sums on the tensor cores, as ``march_steps``
    takes it (points [n, 3] -> the head [n]): K1's tf32 chain
    (``fused_mlp.mlp_chain_3xtf32_mma``) or K2h's bf16 chain
    (``three_pass``, ``fused_mlp.mlp_chain_3pass_mma``), on exactly the n
    points."""
    model = fused_mlp.mlp_chain_3pass_mma if three_pass else fused_mlp.mlp_chain_3xtf32_mma
    hidden = weights.shape[1]

    def sdf(pts):
        return model(weights, biases, torch.nn.functional.pad(pts, (0, hidden - 3)))

    return sdf


def step_cost_model(variant: str, weights: torch.Tensor, biases: torch.Tensor,
                    dirs: torch.Tensor, t0: torch.Tensor, origin: torch.Tensor, *,
                    steps: int = STEPS, three_pass: bool = False,
                    act_dtype=torch.float32) -> torch.Tensor:
    """The kernel's summation order on any device, a model for checks: the
    plain version's steps with the chain as the kernel sums it
    (``model_sdf``). Returns t [1, n]."""
    return march_steps(variant, model_sdf(weights, biases, three_pass), dirs, t0, origin,
                       steps=steps, act_dtype=act_dtype)


def _step_cost_cuda(variant, weights, biases, dirs, t0, origin, steps, three_pass, act_dtype):
    n_layers, hidden = weights.shape[0], weights.shape[1]
    if hidden != WIDTH:
        raise ValueError(f"the X2 kernel is built for width {WIDTH}, not {hidden}")
    n = dirs.shape[1]
    dev = dirs.device
    fused_mlp.check_tensor("weights", weights, torch.float32, (n_layers, hidden, hidden), dev)
    fused_mlp.check_tensor("biases", biases, torch.float32, (n_layers, hidden), dev)
    fused_mlp.check_tensor("dirs", dirs, torch.float32, (3, n), dev)
    fused_mlp.check_tensor("t0", t0, torch.float32, (1, n), dev)
    fused_mlp.check_tensor("origin", origin, torch.float32, (3, 1), dev)
    # the stack in the kernel's fragment order, alive until the launch is enqueued
    packed = fused_mlp.pack_mma(weights, "bf16" if three_pass else "tf32")
    out = torch.empty((1, n), dtype=torch.float32, device=dev)
    launch(build.load_library(), "cnr_x2_stepcost", dev, dirs.data_ptr(), t0.data_ptr(),
           origin.data_ptr(), packed.data_ptr(), biases.data_ptr(), n_layers, hidden,
           VARIANTS.index(variant), int(three_pass), int(act_dtype == torch.bfloat16), n,
           int(steps), out.data_ptr())
    LAUNCHES[variant + ("_3pass" if three_pass else "")] += 1
    return out


def step_cost(variant: str, weights: torch.Tensor, biases: torch.Tensor, dirs: torch.Tensor,
              t0: torch.Tensor, origin: torch.Tensor, *, steps: int = STEPS,
              three_pass: bool = False, act_dtype=torch.float32) -> torch.Tensor:
    """``steps`` fixed march steps of every lane in ``variant``; returns t
    [1, n]. The kernel on CUDA tensors (or raise), the plain version on CPU
    tensors."""
    _check_variant(variant, act_dtype)
    if dirs.device.type == "cpu":
        return step_cost_plain(variant, weights, biases, dirs, t0, origin, steps=steps,
                               three_pass=three_pass, act_dtype=act_dtype)
    if dirs.device.type != "cuda":
        raise ValueError(f"step_cost runs on cpu or cuda tensors, not {dirs.device}")
    return _step_cost_cuda(variant, weights, biases, dirs, t0, origin, steps, three_pass,
                           act_dtype)


def setup(device):
    """The JAX script's inputs on ``device``: csg_demo's stack and biases,
    the rays of a 2048x1024 Camera(rotation_y=25) image as dirs [3, n],
    t0 [1, n] = 0.8, origin [3, 1]."""
    from ..ops import camera as camera_lib
    from ..utils.config import RenderConfig

    weights, biases = demo_stack(device)
    cfg = RenderConfig(width=2048, height=1024)
    c2w, _ = camera_lib.view_matrices(camera_lib.Camera(rotation_y=25.0), device)
    origin, dirs = camera_lib.generate_rays(c2w, cfg.height, cfg.width, cfg.focal)
    n = dirs.shape[0]
    return (weights, biases, dirs.t().contiguous(),
            torch.full((1, n), 0.8, dtype=torch.float32, device=device),
            origin.reshape(3, 1).contiguous())


def main() -> list:
    """Time the JAX script's rows on the card; returns one row each."""
    dev = require_cuda()
    card = card_line()
    weights, biases, dirs, t0, origin = setup(dev)
    n = dirs.shape[1]
    print(f"{n} lanes x {STEPS} steps, csg_demo (DEFAULT and HIGHEST run the same FP32 "
          f"kernel on this card) [{card}]", flush=True)
    rows = []
    for label, variant, three_pass in ROWS:
        out = {}

        def run():
            out["t"] = step_cost(variant, weights, biases, dirs, t0, origin,
                                 three_pass=three_pass)

        ms = time_cuda(run, TIMED_RUNS, warmup=1)
        ns = ms * 1e6 / (n * STEPS)
        counts = output_counts(out["t"])
        print(f"{label:48s}: {ms:8.3f} ms -> {ns:7.4f} ns/lane-step; outputs finite "
              f"{counts['finite']} of {counts['n']}", flush=True)
        rows.append(dict(label=label, variant=variant, three_pass=three_pass, ms=ms,
                         ns_per_lane_step=ns, **counts))
    return rows


if __name__ == "__main__":
    main()
