"""X1: does a wider contraction cost what a narrow one does?

The counterpart of the JAX package's ``benchmarks/exp_blockdiag.py``. On a
TPU the march step's [32, 32] x [32, T] product fills 32 of the MXU's 128
rows; the JAX script asks whether a [128, 128] product costs the same, which
would let a block-diagonal schedule march four ray groups at once. On this
card every product runs at FP32 grade on the tensor cores, as K1's chain
does (tf32 MMA over a warp's 32 lanes): the question becomes whether a
wider contraction gets more out of the tensor cores per ray-step than K1's
latency-bound 32-wide one, for the width's 16x more multiply-adds.

``chain(x, w, b, reps=)`` runs ``reps`` times x <- relu(W^T x + b) on every
lane of x [H, lanes] with one weight W [H, H] and bias b [H] (H = 32 or
128). On CUDA tensors it launches ``x1_loop_kernel`` (csrc/experiments.cu),
the counterpart of ``_loop_kernel`` launched by the JAX script's ``chain``
(``pallas_call`` at exp_blockdiag.py:49), with W in tf32 fragment order
(``fused_mlp.pack_mma``; at 32 in its three tf32 parts, ``pack_tf32_parts``),
and counts it in ``LAUNCHES[H]``; on CPU tensors it runs ``chain_plain``.
The kernel sums each rep as K1's FP32 chain does at that width (3xTF32 with
the chunk sums rounded to even at 128; at 32 K1's four tf32 products with
the chunk residual recovered and a fifth, the weight's third part), no
longer the plain version's order: ``chain_model`` repeats it.

``main()`` runs the JAX script's cases on the card: R = 2^21 rays, 288 reps
(32 march steps x 9 layers), H = 32 over R lanes and H = 128 over R/4
lanes, x seeded normal, W seeded normal x 0.1, b zero. The JAX script's
tiles (8k / 16k lanes at 32, 4k / 2k at 128) have no counterpart (32
lanes a warp), and DEFAULT and HIGHEST run the same FP32-grade kernel here.

    python -m cudaneuralrender_torch.benchmarks.exp_blockdiag
"""
from __future__ import annotations

import torch

from ..kernels import build, fused_mlp
from ..utils.timing import card_line, time_cuda
from . import TIMED_RUNS, launch, output_counts, require_cuda, tf32_parts, tf32_product_model

#: The widths the kernel is built for.
WIDTHS = (32, 128)

#: Launches of the CUDA kernel in this process, by width.
LAUNCHES = {h: 0 for h in WIDTHS}

RAYS = 2 * 1024 * 1024
REPS = 288  # 32 march steps x 9 layers
CASES = ((32, "H=32  [32, R]"), (128, "H=128 [128, R/4]"))


def reset_launch_counts() -> None:
    for h in LAUNCHES:
        LAUNCHES[h] = 0


def chain_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain version on any device: x [H, lanes] -> [H, lanes]. Each rep is
    one FP32 product of the lanes' rows [lanes, H] by W, then the bias and
    the ReLU; the rows are padded and multiplied in blocks as
    ``fused_mlp.plain_rows`` says, so that cuBLAS sums in the kernel's
    order."""
    h, lanes = x.shape
    rows = torch.zeros((fused_mlp.plain_rows(lanes, h, x.device), h), dtype=torch.float32,
                       device=x.device)
    rows[:lanes] = x.t()

    def run(y):
        for _ in range(reps):
            y = torch.relu(y @ w + b)
        return y

    return fused_mlp.chain_in_blocks(run, rows)[:lanes].t().contiguous()


def pack_tf32_parts(w: torch.Tensor) -> torch.Tensor:
    """W [H, H] in tf32 fragment order (``fused_mlp.pack_mma``), split into
    its three tf32 parts (``tf32_parts``: big, small, third, which sum to W
    exactly): [3, H/8, H/8, 32, 2], what the kernel stages at H = 32."""
    return torch.stack(tf32_parts(fused_mlp.pack_mma(w[None], "tf32")[0], 3)).contiguous()


def chain_model(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """The kernel's summation order on any device, a model for checks: x
    [H, lanes] -> [H, lanes], each rep's product as the kernel sums it (at
    32 ``tf32_product_model`` with the weight in three parts, at 128 K1's
    3xTF32 layer, ``fused_mlp._layer_tf32``), then the bias and the ReLU."""
    h = x.shape[0]
    y = x.t()
    for _ in range(reps):
        p = tf32_product_model(y, w, "b") if h == 32 else fused_mlp._layer_tf32(y, w, h, h, h)
        y = torch.relu(p + b)
    return y.t().contiguous()


def _chain_cuda(x, w, b, reps):
    h, lanes = x.shape
    if h not in WIDTHS:
        raise ValueError(f"the X1 kernel is built for widths {WIDTHS}, not {h}")
    dev = x.device
    fused_mlp.check_tensor("x", x, torch.float32, (h, lanes), dev)
    fused_mlp.check_tensor("w", w, torch.float32, (h, h), dev)
    fused_mlp.check_tensor("b", b, torch.float32, (h,), dev)
    out = torch.empty_like(x)
    # alive until the launch is enqueued
    packed = pack_tf32_parts(w) if h == 32 else fused_mlp.pack_mma(w[None], "tf32")
    launch(build.load_library(), "cnr_x1_loop", dev, x.data_ptr(), packed.data_ptr(),
           b.data_ptr(), h, lanes, int(reps), out.data_ptr())
    LAUNCHES[h] += 1
    return out


def chain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, reps: int) -> torch.Tensor:
    """``reps`` times x <- relu(W^T x + b) on x [H, lanes]: the kernel on
    CUDA tensors (or raise), the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return chain_plain(x, w, b, reps)
    if x.device.type != "cuda":
        raise ValueError(f"chain runs on cpu or cuda tensors, not {x.device}")
    return _chain_cuda(x, w, b, reps)


def setup(hidden: int, device, seed: int = 0):
    """The JAX script's inputs for a width, made on ``device`` from ``seed``:
    x [H, lanes] normal, W [H, H] normal x 0.1, b zero."""
    lanes = RAYS if hidden == 32 else RAYS // 4
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn((hidden, lanes), generator=gen, device=device)
    w = torch.randn((hidden, hidden), generator=gen, device=device) * 0.1
    return x, w, torch.zeros(hidden, device=device)


def main() -> list:
    """Time every case on the card; returns one row per case."""
    dev = require_cuda()
    card = card_line()
    rows = []
    for prec in ("DEFAULT", "HIGHEST"):
        print(f"[{prec}] rays={RAYS} reps={REPS} (DEFAULT and HIGHEST run the same FP32 kernel "
              f"on this card) [{card}]", flush=True)
        for hidden, tag in CASES:
            x, w, b = setup(hidden, dev)
            out = {}

            def run():
                out["x"] = chain(x, w, b, reps=REPS)

            ms = time_cuda(run, TIMED_RUNS, warmup=1)
            ns = ms * 1e6 / (RAYS * (REPS // 9))
            counts = output_counts(out["x"])
            print(f"  {tag:34s}: {ms:9.3f} ms -> {ns:8.4f} ns per ray-step; outputs finite "
                  f"{counts['finite']}, zero {counts['zero']} of {counts['n']}", flush=True)
            rows.append(dict(label=f"{prec} {tag}", hidden=hidden, ms=ms, ns_per_ray_step=ns,
                             **counts))
    return rows


if __name__ == "__main__":
    main()
