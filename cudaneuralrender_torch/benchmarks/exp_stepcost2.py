"""X3: the step-cost ablation, from a bare loop of products to the march chain.

The counterpart of the JAX package's ``benchmarks/exp_stepcost2.py``. Every
variant runs the same lane-steps (n lanes x 64 steps, each step 9 layers):

  * ``v0``: the padded input x carried through steps x 9 products by ONE
    weight (the first layer's), no bias, no ReLU;
  * ``v1``: each step the 9 layers' weights, no bias, no ReLU, then
    x * 1e-8 (which keeps x bounded); ``v1h`` (the weights hoisted out of
    the loop in the JAX kernel) is the same kernel here;
  * ``v2``: v1 with the bias and the ReLU;
  * ``v3``: t += sdf(t) * 1e-8, the point o + d*t rebuilt each step and the
    FP32 chain; ``v4`` (a while loop instead of a fori loop in the JAX
    kernel) is the same kernel here;
  * ``v5`` / ``v5p``: v3 on the six- / five-pass bfloat16 emulation of FP32:
    the weights split into three bfloat16 terms (``split3``), each
    activation split in the kernel, the products hi*hi, mid*hi, hi*mid,
    lo*hi, hi*lo (and mid*mid for v5) summed in that order.

The JAX script's docstring also names ``v3d`` (the input rebuilt by a
dynamic update of a carried buffer), but its ``make_kernel`` has no branch
for it and runs v3's body, and its ``main()`` does not run it: there is no
v3d here.

``ablation`` launches ``x3_ablation_kernel`` (csrc/experiments.cu), the
counterpart of the kernel ``make_kernel`` builds and ``run_variant``
launches (``pallas_call`` at exp_stepcost2.py:174), on CUDA tensors and
counts it in ``LAUNCHES`` by kernel; on CPU tensors it runs
``ablation_plain``. Inputs keep the JAX layout: dirs [3, n], t0 [1, n],
origin [3, 1]; the weights are the padded FP32 stack, laid out for the
tensor cores on each call (``fused_mlp.pack_mma(weights, "tf32")`` for
v0-v3; for v5 / v5p split as ``run_variant`` splits them, ``pack_split3``).
``SCALE`` is the script's 1e-8.

The kernel runs v0-v3 on K1's tf32 chain at width 32 (v0 with a third
tf32 part of each activation, ``tf32_product_model``) and v5 / v5p on bf16
MMA (csrc/experiments.cu), each summed in the tensor cores' order, no
longer the plain version's bit for bit: ``ablation_model`` repeats every
variant in the kernel's order (``fused_mlp._layer_tf32``,
``tf32_product_model``, ``fused_mlp.mlp_chain_3xtf32_mma``,
``mlp_chain_split3_mma``).

``main()`` runs the JAX script's rows on the card: n = 2^21 lanes, dirs
seeded normal x 0.1 (torch's generator: not the JAX script's numbers), t0
0.8, origin (0, 0, -2), csg_demo's weights; then the emulations' SDF error
against the FP32 chain on 65536 seeded points in [-1.2, 1.2]^3. DEFAULT and
HIGHEST run the same FP32 kernel here.

    python -m cudaneuralrender_torch.benchmarks.exp_stepcost2
"""
from __future__ import annotations

import torch

from ..kernels import build, fused_mlp
from ..utils.timing import card_line, time_cuda
from . import (TIMED_RUNS, demo_stack, launch, output_counts, padded, point_rows, require_cuda,
               tf32_product_model)

STEPS = 64
SCALE = 1e-8
WIDTH = 32  # the kernel's width: the nets the JAX script runs
VARIANTS = ("v0", "v1", "v1h", "v2", "v3", "v4", "v5", "v5p")

#: Each variant's kernel: (name, the C entry's variant id).
KERNEL_OF = {"v0": ("v0", 0), "v1": ("v1", 1), "v1h": ("v1", 1), "v2": ("v2", 2),
             "v3": ("v3", 3), "v4": ("v3", 3), "v5": ("v5", 5), "v5p": ("v5p", 6)}

#: Launches of the CUDA kernel in this process, by kernel.
LAUNCHES = {name: 0 for name, _ in sorted(set(KERNEL_OF.values()))}

#: main()'s rows: (section, variant, label).
ROWS = (
    ("[HIGHEST]", "v3", "  v3"),
    ("[HIGHEST]", "v4", "  v4"),
    ("[DEFAULT]", "v0", "  v0"),
    ("[DEFAULT]", "v3", "  v3"),
    ("[DEFAULT]", "v4", "  v4"),
    ("[f32-emulation schemes, pre-split weights]", "v5", "  v5  6-pass"),
    ("[f32-emulation schemes, pre-split weights]", "v5p", "  v5p 5-pass"),
)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def split3(w: torch.Tensor):
    """Three-term bfloat16 decomposition, w ~ hi + mid + lo (~24 mantissa
    bits): hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid)."""
    hi = w.to(torch.bfloat16)
    r = w - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def pack_split3(weights: torch.Tensor):
    """The three bfloat16 parts of the stack [L, H, H] (``split3``), each in
    m16n8k16 B-fragment order [L, H/16, H/8, 32, 4] (``fused_mlp.bf16_fragments``):
    what the five- / six-pass kernel stages."""
    return tuple(fused_mlp.bf16_fragments(part).contiguous() for part in split3(weights.float()))


def mlp_chain_split3_mma(weights: torch.Tensor, biases: torch.Tensor, x: torch.Tensor,
                         six: bool = True) -> torch.Tensor:
    """The six- (``six``) or five-pass chain summed as ``x3_ablation_kernel``
    sums it on the tensor cores (csrc/experiments.cu ``mma_split3``), a model
    for checks on any device: weights [L, H, H] and biases [L, H] FP32, x
    [T, H] zero-padded inputs. Returns the head [T].

    Per layer the activations are split like the weights (``split3``); per
    k-chunk of 16 rows the MMAs run from zero, each as
    ``fused_mlp._mma_model`` takes it (the tensor cores align and truncate):
    x_lo w_hi, x_hi w_lo, (x_mid w_mid), x_mid w_hi, x_hi w_mid, then
    x_hi w_hi; the six-pass chain first takes u = -(x_hi w_hi) from zero and
    d = x_hi w_hi + u, what u's truncation dropped, then the five smaller
    products into d, and adds d - u where the five-pass chain adds d. Each
    chunk's sum goes to a float32 accumulator with a rounded add, then the
    bias, then ReLU on every layer but the last. The inputs are one k-chunk;
    the head is n-tile 0 (8 columns, the SDF column 0)."""
    parts = [p.double() for p in split3(weights.float())]  # hi, mid, lo: exact in float64
    n_layers, h = weights.shape[0], weights.shape[2]
    small = [(2, 0), (0, 2)] + ([(1, 1)] if six else []) + [(1, 0), (0, 1)]
    for l in range(n_layers):
        last = l + 1 == n_layers
        n = 8 if last else h
        xs = [p.double() for p in split3(x)]
        acc = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
        for k0 in range(0, 16 if l == 0 else h, 16):
            rows = slice(k0, k0 + 16)

            def mma(c, pa, pb, sign=1.0):
                return fused_mlp._mma_model(c, sign * xs[pa][:, rows], parts[pb][l, rows, :n])

            d = torch.zeros_like(acc)
            if six:
                u = mma(d, 0, 0, -1.0)
                d = mma(u, 0, 0)
            for pa, pb in small + ([] if six else [(0, 0)]):
                d = mma(d, pa, pb)
            acc = acc + (d - u if six else d)
        y = acc + biases[l, :n]
        x = y if last else torch.relu(y)
    return x[:, 0]


def mlp_chain_split3_plain(w_hi, w_mid, w_lo, biases, x: torch.Tensor, n_layers: int,
                           six: bool = True) -> torch.Tensor:
    """The six- (``six``) or five-pass chain on x [T, H]: per layer x is
    split like the weights, and the products of its bfloat16 terms (exact in
    float32) are summed in the JAX script's order, the bias last; ReLU on
    every layer but the last. Returns [T, H]; the head is column 0."""
    wh, wm, wl = w_hi.float(), w_mid.float(), w_lo.float()
    for l in range(n_layers):
        xh = x.to(torch.bfloat16).float()
        r = x - xh
        xm = r.to(torch.bfloat16).float()
        xl = (r - xm).to(torch.bfloat16).float()
        y = xh @ wh[l]
        y = y + xm @ wh[l]
        y = y + xh @ wm[l]
        y = y + xl @ wh[l]
        y = y + xh @ wl[l]
        if six:
            y = y + xm @ wm[l]
        y = y + biases[l]
        if l + 1 < n_layers:
            y = torch.relu(y)
        x = y
    return x


def ablation_plain(variant: str, weights: torch.Tensor, biases: torch.Tensor,
                   dirs: torch.Tensor, t0: torch.Tensor, origin: torch.Tensor, *,
                   steps: int = STEPS) -> torch.Tensor:
    """Plain version on any device, every lane at once on the padded rows
    (``fused_mlp.plain_rows``). Returns [1, n]."""
    if variant not in KERNEL_OF:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    kernel = KERNEL_OF[variant][0]
    n_layers, hidden = weights.shape[0], weights.shape[1]
    n = dirs.shape[1]
    t = t0.reshape(n)
    if kernel in ("v0", "v1", "v2"):
        def run(x):
            if kernel == "v0":
                for _ in range(steps * n_layers):
                    x = x @ weights[0]
                return x
            for _ in range(steps):
                for l in range(n_layers):
                    y = x @ weights[l]
                    if kernel == "v2":
                        y = y + biases[l]
                        if l + 1 < n_layers:
                            y = torch.relu(y)
                    x = y
                x = x * SCALE
            return x

        x = padded(point_rows(origin, dirs, t), hidden)
        return fused_mlp.chain_in_blocks(run, x)[:n, 0].reshape(1, n)

    if kernel == "v3":
        def chain(x):
            return fused_mlp.mlp_chain_plain(weights, biases, x, n_layers)
    else:
        parts = split3(weights)

        def chain(x):
            return mlp_chain_split3_plain(*parts, biases, x, n_layers, six=kernel == "v5")
    for _ in range(steps):
        x = padded(point_rows(origin, dirs, t), hidden)
        t = t + fused_mlp.chain_in_blocks(chain, x)[:n, 0] * SCALE
    return t.reshape(1, n)


def ablation_model(variant: str, weights: torch.Tensor, biases: torch.Tensor,
                   dirs: torch.Tensor, t0: torch.Tensor, origin: torch.Tensor, *,
                   steps: int = STEPS) -> torch.Tensor:
    """The kernel's summation order on any device, a model for checks: the
    plain version's steps with each product x @ W as K1's tf32 layer at
    width H sums it (``fused_mlp._layer_tf32``; v1, v2) or as v0's
    (``tf32_product_model``, a third part of each activation), each chain as K1's
    (``fused_mlp.mlp_chain_3xtf32_mma``; v3) or as the bf16 MMA kernel's
    (``mlp_chain_split3_mma``; v5, v5p), on exactly the n lanes. Returns
    [1, n]."""
    if variant not in KERNEL_OF:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    kernel = KERNEL_OF[variant][0]
    n_layers, hidden = weights.shape[0], weights.shape[1]
    n = dirs.shape[1]
    t = t0.reshape(n)

    def rows(t):
        return torch.nn.functional.pad(point_rows(origin, dirs, t), (0, hidden - 3))

    if kernel in ("v0", "v1", "v2"):
        x = rows(t)
        for _ in range(steps):
            for k in range(n_layers):
                if kernel == "v0":
                    x = tf32_product_model(x, weights[0], "a")
                else:
                    x = fused_mlp._layer_tf32(x, weights[k], hidden, hidden, hidden)
                if kernel == "v2":
                    x = x + biases[k]
                    if k + 1 < n_layers:
                        x = torch.relu(x)
            if kernel != "v0":
                x = x * SCALE
        return x[:, 0].reshape(1, n)
    for _ in range(steps):
        if kernel == "v3":
            sdf = fused_mlp.mlp_chain_3xtf32_mma(weights, biases, rows(t))
        else:
            sdf = mlp_chain_split3_mma(weights, biases, rows(t), six=kernel == "v5")
        t = t + sdf * SCALE
    return t.reshape(1, n)


def _ablation_cuda(variant, weights, biases, dirs, t0, origin, steps):
    n_layers, hidden = weights.shape[0], weights.shape[1]
    if hidden != WIDTH:
        raise ValueError(f"the X3 kernel is built for width {WIDTH}, not {hidden}")
    n = dirs.shape[1]
    dev = dirs.device
    fused_mlp.check_tensor("weights", weights, torch.float32, (n_layers, hidden, hidden), dev)
    fused_mlp.check_tensor("biases", biases, torch.float32, (n_layers, hidden), dev)
    fused_mlp.check_tensor("dirs", dirs, torch.float32, (3, n), dev)
    fused_mlp.check_tensor("t0", t0, torch.float32, (1, n), dev)
    fused_mlp.check_tensor("origin", origin, torch.float32, (3, 1), dev)
    kernel, vid = KERNEL_OF[variant]
    split = kernel in ("v5", "v5p")
    # the stack in the kernel's fragment order, alive until the launch is enqueued
    packed = pack_split3(weights) if split else fused_mlp.pack_mma(weights, "tf32")
    ptrs = [p.data_ptr() for p in packed] if split else [None] * 3
    out = torch.empty((1, n), dtype=torch.float32, device=dev)
    launch(build.load_library(), "cnr_x3_ablation", dev, dirs.data_ptr(), t0.data_ptr(),
           origin.data_ptr(), None if split else packed.data_ptr(), *ptrs, biases.data_ptr(),
           n_layers, hidden, vid, n, int(steps), out.data_ptr())
    LAUNCHES[kernel] += 1
    return out


def ablation(variant: str, weights: torch.Tensor, biases: torch.Tensor, dirs: torch.Tensor,
             t0: torch.Tensor, origin: torch.Tensor, *, steps: int = STEPS) -> torch.Tensor:
    """One ablation variant over every lane; returns [1, n] (v0-v2: the
    carried x's row 0; v3-v5p: t). The kernel on CUDA tensors (or raise),
    the plain version on CPU tensors."""
    if variant not in KERNEL_OF:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    if dirs.device.type == "cpu":
        return ablation_plain(variant, weights, biases, dirs, t0, origin, steps=steps)
    if dirs.device.type != "cuda":
        raise ValueError(f"ablation runs on cpu or cuda tensors, not {dirs.device}")
    return _ablation_cuda(variant, weights, biases, dirs, t0, origin, steps)


def setup(device, n: int = 2 ** 21, seed: int = 0):
    """The JAX script's inputs on ``device``: csg_demo's stack and biases,
    dirs [3, n] seeded normal x 0.1, t0 [1, n] = 0.8, origin (0, 0, -2)."""
    weights, biases = demo_stack(device)
    gen = torch.Generator(device).manual_seed(seed)
    dirs = torch.randn((3, n), generator=gen, device=device) * 0.1
    t0 = torch.full((1, n), 0.8, dtype=torch.float32, device=device)
    origin = torch.tensor([[0.0], [0.0], [-2.0]], dtype=torch.float32, device=device)
    return weights, biases, dirs, t0, origin


def emulation_errors(weights, biases, n_points: int = 65536, seed: int = 1) -> dict:
    """Max |six- and five-pass chain - FP32 chain| over seeded points in
    [-1.2, 1.2]^3 (the JAX script compares with its native HIGHEST)."""
    dev = weights.device
    gen = torch.Generator(dev).manual_seed(seed)
    pts = torch.rand((n_points, 3), generator=gen, device=dev) * 2.4 - 1.2
    x = padded(pts, weights.shape[1])
    n_layers = weights.shape[0]
    ref = fused_mlp.chain_in_blocks(
        lambda b: fused_mlp.mlp_chain_plain(weights, biases, b, n_layers), x)[:n_points, 0]
    parts = split3(weights)
    return {passes: (fused_mlp.chain_in_blocks(
        lambda b: mlp_chain_split3_plain(*parts, biases, b, n_layers, six=passes == 6),
        x)[:n_points, 0] - ref).abs().max().item() for passes in (6, 5)}


def main() -> list:
    """Time the JAX script's rows on the card; returns one row each."""
    dev = require_cuda()
    card = card_line()
    weights, biases, dirs, t0, origin = setup(dev)
    n = dirs.shape[1]
    print(f"{n} lanes x {STEPS} steps x 9 layers, csg_demo (DEFAULT and HIGHEST run the same "
          f"FP32 kernel on this card; v4 runs v3's kernel) [{card}]", flush=True)
    rows, section = [], None
    for sec, variant, label in ROWS:
        if sec != section:
            print(sec, flush=True)
            section = sec
        out = {}

        def run():
            out["y"] = ablation(variant, weights, biases, dirs, t0, origin)

        ms = time_cuda(run, TIMED_RUNS, warmup=1)
        ns = ms * 1e6 / (n * STEPS)
        counts = output_counts(out["y"])
        print(f"{label:52s}: {ms:8.3f} ms -> {ns:7.4f} ns/lane-step; outputs finite "
              f"{counts['finite']}, zero {counts['zero']} of {counts['n']}", flush=True)
        rows.append(dict(label=f"{sec} {label.strip()}", variant=variant, ms=ms,
                         ns_per_lane_step=ns, **counts))
    for passes, err in emulation_errors(weights, biases).items():
        print(f"  emu {passes}-pass max|err| vs the FP32 chain: {err:.3e}", flush=True)
    return rows


if __name__ == "__main__":
    main()
