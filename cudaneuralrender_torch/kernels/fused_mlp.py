"""The padded layer chain and the fused forward kernel (K3).

The PyTorch counterpart of the JAX package's ``pallas/fused_mlp.py``:

  * ``pack_params`` builds the zero-padded [L, H, H] weight stack and [L, H]
    biases the CUDA kernels read, H the smallest of ``KERNEL_WIDTHS`` that
    holds the widest layer;
  * ``mlp_chain_plain`` is the plain PyTorch version of ``_mlp_chain``
    (``fused_mlp.py:162``) on [T, H] activations (rays on rows, features on
    columns — PyTorch's habit; the TPU kernel keeps them transposed);
  * ``split_hi_lo`` and ``mlp_chain_3pass_plain`` are the plain versions of
    ``split_hi_lo`` (``fused_mlp.py:59``) and of the emulated
    ``Precision.HIGH`` chain ``_mlp_chain_3pass`` (``fused_mlp.py:130``),
    K2h, which the march kernel runs at ``precision="high"``;
    ``mlp_chain_3pass_mma`` models the same chain summed in the tensor-core
    kernel's order, for checks; ``mlp_chain_3xtf32_mma`` models the FP32
    chain as the march kernel sums it on the tensor cores a ray per thread
    (3xTF32; 4xTF32 at width 32, ``tf32_passes``);
  * ``mlp_forward`` is the counterpart of ``mlp_forward_pallas``
    (``fused_mlp.py:194``): on CUDA tensors it launches the hand-written
    kernel in ``csrc/chain.cuh``, on CPU tensors it runs
    ``mlp_forward_plain``; ``neural_sdf_fn_kernel`` wraps it as an SDF, the
    counterpart of ``neural_sdf_fn_pallas`` (``config.use_pallas``);
  * ``pack_mma`` / ``packed_mma`` lay the stack out in the tensor cores'
    fragment order, the form the tensor-core kernels read: "tf32" for the
    3xTF32 products of the forward kernel and of the march kernel's FP32
    chain, "bf16" (the two bfloat16 halves) for the
    three-pass chain inside the march kernel.

Zero padding is exact: padded input features are zero, so weight rows
beyond a layer's true input width contribute nothing, and the head reads
only output column 0.

``MLP_LAUNCHES`` counts launches of the forward kernel (plain-version calls
do not count).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.mlp import MLP
from ..ops.sdf import frame_tensor
from . import build

#: The hidden widths the CUDA kernels are instantiated for. 1024 is the
#: widest: the JAX package's kernels hold the whole [L, H, H] stack in VMEM,
#: 37.7 MB at 9 layers and 1024 wide, and here the stack lives in the
#: card's 50 MB L2 (csrc/chain.cuh).
KERNEL_WIDTHS = (32, 64, 128, 256, 512, 1024)

#: Launches of the CUDA forward kernel in this process.
MLP_LAUNCHES = 0


#: The largest batch the plain chains hand cuBLAS in one product.
ROW_BLOCK = 1 << 16

#: The fewest rows the plain chains hand cuBLAS on the card, by padded
#: width where it is not 1024: at width 512 cuBLAS sums in another order at
#: 1024 rows (and at 1000-1528 and 2120-2808), in the kernels' order at
#: every power of two from 2048 to 65536 (chip_smoke.py phase 10's sweep).
CARD_MIN_ROWS = {512: 2048}


def card_min_rows(hidden: int) -> int:
    """The fewest rows the plain chains use on the card at a padded width."""
    return CARD_MIN_ROWS.get(hidden, 1024)


def plain_rows(n: int, hidden: int, device: torch.device) -> int:
    """Rows the plain versions hand a layer chain ``hidden`` wide for a
    batch of n points on ``device`` (the points first, zero rows after).

    BLAS libraries switch to other kernels, which sum in another order, for
    some row counts (the CPU's matrix-vector path at one row, cuBLAS's
    small-M kernels), and a point's SDF would then depend on how many
    points are evaluated beside it. On the H100, cuBLAS sums in the
    kernels' order at every power of two from 1024 (2048 at width 512) to
    65536 rows at every width, but not below, nor at some row counts
    between (at widths 256 and 512), nor at some rows of a 2^20-row product
    (at widths 64 and 128); chip_smoke.py phases 9 and 10 print the sweeps.
    So on the card a batch is padded to the next power of two of at least
    ``card_min_rows`` rows, and beyond ``ROW_BLOCK`` rows to whole blocks,
    which ``chain_in_blocks`` multiplies one by one; on the CPU to 256
    rows."""
    if device.type != "cuda":
        return max(n, 256)
    if n > ROW_BLOCK:
        return -(-n // ROW_BLOCK) * ROW_BLOCK
    return max(card_min_rows(hidden), 1 << (n - 1).bit_length())


def chain_in_blocks(chain, x: torch.Tensor) -> torch.Tensor:
    """``chain(x)`` on x [T, H] padded by ``plain_rows``: on the card, one
    ``ROW_BLOCK`` of rows at a time when T is larger."""
    if x.device.type != "cuda" or x.shape[0] <= ROW_BLOCK:
        return chain(x)
    return torch.cat([chain(x[i:i + ROW_BLOCK]) for i in range(0, x.shape[0], ROW_BLOCK)])


def reset_launch_counts() -> None:
    """Set ``MLP_LAUNCHES`` to 0."""
    global MLP_LAUNCHES
    MLP_LAUNCHES = 0


def padded_width(widest: int) -> int:
    """The smallest kernel width that holds a layer ``widest`` wide."""
    for h in KERNEL_WIDTHS:
        if widest <= h:
            return h
    raise ValueError(
        f"a {widest}-wide layer is wider than the kernels' {KERNEL_WIDTHS[-1]} "
        "(ROADMAP section 2: the widest stack the kernels hold)")


def pack_params(params: MLP) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Pad an MLP to a uniform [L, H, H] weight stack + [L, H] biases on the
    parameters' device, H = ``padded_width`` of the widest layer. Returns
    (weights, biases, n_in, hidden)."""
    sizes = [int(params[0].w.shape[0])] + [int(l.w.shape[1]) for l in params]
    h = padded_width(max(sizes))
    n_layers = len(params)
    dev = params[0].w.device
    weights = torch.zeros((n_layers, h, h), dtype=torch.float32, device=dev)
    biases = torch.zeros((n_layers, h), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for i, layer in enumerate(params):
            n_in_l, n_out_l = layer.w.shape
            weights[i, :n_in_l, :n_out_l] = layer.w
            biases[i, :n_out_l] = layer.b
    return weights, biases, sizes[0], h


def split_hi_lo(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-term bfloat16 decomposition of a float32 tensor, w ~ hi + lo:
    hi = bf16(w), lo = bf16(w - hi), each rounded to nearest even, the same
    bits as the JAX package's ``split_hi_lo``."""
    hi = w.to(torch.bfloat16)
    lo = (w - hi.float()).to(torch.bfloat16)
    return hi, lo


def _cached(params: MLP, attr: str, make):
    """``make(params)`` once per parameter state, kept on the module as
    ``attr`` and rebuilt only when a parameter is replaced, moved or written
    in place (its storage or version counter changes)."""
    key = tuple((p.data_ptr(), p._version) for p in params.parameters())
    cached = getattr(params, attr, None)
    if cached is None or cached[0] != key:
        cached = (key, make(params))
        setattr(params, attr, cached)
    return cached[1]


def packed_params(params: MLP) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """``pack_params`` once per parameter state, so a frame's kernel calls
    share one stack instead of packing at every launch."""
    return _cached(params, "_packed_stack", pack_params)


def packed_hi_lo(params: MLP) -> Tuple[torch.Tensor, torch.Tensor]:
    """``split_hi_lo`` of the packed weight stack, once per parameter state:
    the bfloat16 halves (w_hi, w_lo) [L, H, H] the three-pass chain reads."""
    return _cached(params, "_packed_hi_lo", lambda p: split_hi_lo(packed_params(p)[0]))


#: The kinds of ``pack_mma``.
MMA_KINDS = ("tf32", "bf16")


def pack_mma(weights: torch.Tensor, kind: str) -> torch.Tensor:
    """The padded stack [L, H, H] (rows the input k, columns the output n)
    in the tensor cores' B-fragment order, lane = 4 * g + t (csrc/mma.cuh):

      * "tf32", for m16n8k8: float32 [L, H/8, H/8, 32, 2]; entry
        [l, kk, j, 4g + t, e] is W[l, 8kk + 2t + e, 8j + g]: the MMA's k = t
        and k = t + 4 of k-chunk kk are rows 8kk + 2t and 8kk + 2t + 1, the
        permutation that lets a lane read its A pair in one load. The values
        are the FP32 weights, split into tf32 big / small in registers.
      * "bf16", for m16n8k16: bfloat16 [L, H/16, H/8, 32, 8]; entry
        [l, kk, j, 4g + t] holds b0 = W[16kk + 2t + (0, 1), 8j + g] and
        b1 = W[16kk + 2t + 8 + (0, 1), 8j + g] of the hi half, then the same
        of the lo half (``split_hi_lo``): one 16-byte load a lane.

    A lane's fragments of one n-tile and k-chunk are contiguous, and a
    warp's 32 lanes read 256 or 512 consecutive bytes."""
    n_layers, h, _ = weights.shape
    if kind == "tf32":
        w = weights.float().reshape(n_layers, h // 8, 4, 2, h // 8, 8)  # l kk t e j g
        return w.permute(0, 1, 4, 5, 2, 3).reshape(n_layers, h // 8, h // 8, 32, 2).contiguous()
    if kind == "bf16":
        return torch.cat([bf16_fragments(half) for half in split_hi_lo(weights.float())],
                         dim=-1).contiguous()
    raise ValueError(f"kind must be one of {MMA_KINDS}, not {kind!r}")


def bf16_fragments(part: torch.Tensor) -> torch.Tensor:
    """One bfloat16 part [L, H, H] of a stack in m16n8k16 B-fragment order,
    [L, H/16, H/8, 32, 4]: entry [l, kk, j, 4g + t] is b0 =
    W[16kk + 2t + (0, 1), 8j + g] then b1 = W[16kk + 2t + 8 + (0, 1), 8j + g]
    (``pack_mma``'s "bf16" kind holds the hi and lo parts so, side by side)."""
    n_layers, h, _ = part.shape
    w = part.reshape(n_layers, h // 16, 2, 4, 2, h // 8, 8)  # l kk p t e j g
    return w.permute(0, 1, 5, 6, 3, 2, 4).reshape(n_layers, h // 16, h // 8, 32, 4)


def packed_mma(params: MLP, kind: str) -> torch.Tensor:
    """``pack_mma`` of the packed stack, once per parameter state and kind."""
    return _cached(params, f"_packed_mma_{kind}", lambda p: pack_mma(packed_params(p)[0], kind))


def mlp_chain_plain(weights: torch.Tensor, biases: torch.Tensor,
                    x: torch.Tensor, n_layers: int) -> torch.Tensor:
    """Run the padded layer chain on activations x [T, H]; ReLU on every
    layer but the last. Returns [T, H]; the SDF head is column 0."""
    for l in range(n_layers):
        y = x @ weights[l] + biases[l]
        if l + 1 < n_layers:
            y = torch.relu(y)
        x = y
    return x


def mlp_chain_3pass_plain(w_hi: torch.Tensor, w_lo: torch.Tensor, biases: torch.Tensor,
                          x: torch.Tensor, n_layers: int) -> torch.Tensor:
    """Plain version of the three-pass chain K2h on activations x [T, H];
    ReLU on every layer but the last. Returns [T, H]; the head is column 0.

    Per layer the activations are split like the weights (x_hi = bf16(x),
    x_lo = bf16(x - x_hi)), and y = ((x_hi @ w_hi + x_lo @ w_hi) + x_hi @ w_lo)
    + b: three float32 products of bfloat16-valued operands (each product of
    two bfloat16 values is exact in float32), added in that order, the bias
    last. The lo @ lo term is dropped, as XLA's Precision.HIGH drops it."""
    wh, wl = w_hi.float(), w_lo.float()
    for l in range(n_layers):
        xh = x.to(torch.bfloat16)
        xl = (x - xh.float()).to(torch.bfloat16).float()
        xh = xh.float()
        y = xh @ wh[l]
        y = y + xl @ wh[l]
        y = y + xh @ wl[l]
        y = y + biases[l]
        if l + 1 < n_layers:
            y = torch.relu(y)
        x = y
    return x


#: Bits past float32's 24 that ``mlp_chain_3pass_mma``'s model of an MMA
#: keeps when it aligns the products to the largest exponent.
MMA_ALIGN_BITS = 3


def _round_to_zero_f32(v: torch.Tensor) -> torch.Tensor:
    """float64 values rounded toward zero to float32."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _mma_model(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One MMA with FP32 accumulation as the models of the tensor-core
    chains take it: c [..., N] float32 + a [..., K] @ b [..., K, N], the
    leading dimensions broadcast (bfloat16 or tf32 values, whose products
    are exact in float32). The K products and c are aligned to the largest
    exponent among them, each truncated below MMA_ALIGN_BITS bits past
    float32's, summed exactly, and the sum truncated to float32."""
    prods = a.float()[..., :, None] * b.float()
    top = torch.maximum(prods.abs().amax(dim=-2), c.abs())
    _, exp = torch.frexp(top)
    # a quantum of at least 2^-126 stays a normal float32 (tops below 2^-99
    # do not occur in these nets)
    quantum = torch.ldexp(torch.ones_like(top), torch.clamp(exp - 24 - MMA_ALIGN_BITS, min=-126))
    quantum = torch.where(top > 0, quantum, torch.ones_like(quantum))
    # dividing by a power of two and truncating are exact in float32; the
    # sum of the aligned terms is not, so it is taken in float64
    units = torch.trunc(prods.div_(quantum[..., None, :])).sum(dim=-2, dtype=torch.float64)
    units += torch.trunc(c / quantum).double()
    return _round_to_zero_f32(units * quantum.double())


def mlp_chain_3pass_mma(weights: torch.Tensor, biases: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """The three-pass chain summed in the tensor-core kernel's order (K2h,
    csrc/mma.cuh ``mma_3pass``), a model for checks on any device: weights
    [L, H, H] and biases [L, H] from ``pack_params``, x [T, H] zero-padded
    inputs. Returns the head [T].

    Per layer the activations are split as ``mlp_chain_3pass_plain`` splits
    them. Per k-chunk of 16 rows, three MMAs run from zero: x_lo @ w_hi,
    then x_hi @ w_lo, then x_hi @ w_hi (each as ``_mma_model``: the tensor
    cores align and truncate); the chunk's sum is added to one float32
    accumulator with a rounded add, then the bias, then ReLU on every layer
    but the last. The inputs are one k-chunk. Memory: T x 17 x H float64
    values a step."""
    w_hi, w_lo = (half.double() for half in split_hi_lo(weights))
    n_layers, h = weights.shape[0], weights.shape[2]
    for l in range(n_layers):
        x_hi = x.to(torch.bfloat16).float()
        x_lo = (x - x_hi).to(torch.bfloat16).double()
        x_hi = x_hi.double()
        acc = torch.zeros((x.shape[0], h), dtype=torch.float32, device=x.device)
        for k0 in range(0, 16 if l == 0 else h, 16):
            rows = slice(k0, k0 + 16)
            d = torch.zeros_like(acc)
            for a, b in ((x_lo, w_hi), (x_hi, w_lo), (x_hi, w_hi)):
                d = _mma_model(d, a[:, rows], b[l, rows])
            acc = acc + d
        x = acc + biases[l]
        if l + 1 < n_layers:
            x = torch.relu(x)
    return x[:, 0]


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to tf32 (10 mantissa bits) to nearest, ties
    away from zero, as cvt.rna.tf32.f32 rounds them: the low 13 bits of the
    float32 zero."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


#: Products the 3xTF32 model holds at once (2^26 float32 values, 256 MB).
MODEL_ELEMENTS = 1 << 26


def round_truncated_to_even(d: torch.Tensor) -> torch.Tensor:
    """A tensor core's float32 result, truncated toward zero, rounded to
    even: each odd value moves one ulp away from zero (csrc/mma.cuh
    ``round_to_even``). The truncated t of an exact sum s has |s| in
    [|t|, |t| + ulp), so t alone is low by half an ulp on average, always
    toward zero; t rounded to even is low by nothing on average."""
    bits = d.float().contiguous().view(torch.int32)
    return (bits + (bits & 1)).view(torch.float32)


def tf32_passes(hidden: int) -> int:
    """The tf32 products per weight of the march kernel's FP32 chain at a
    padded width (csrc/chain.cuh ``tf32_passes``): 4 at 32, where the
    a_small * b_small term is kept (without it the shipped 32-wide net's
    SDF lies 1.14x as far from float64 as the FFMA chain's here,
    tests/test_torch_k1mma.py, and up to 1.25x on the card), 3 elsewhere."""
    return 4 if hidden == 32 else 3


def _layer_fma(x: torch.Tensor, w: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """x[:, :k] @ w[:k, :n] with each output summed from zero in input order,
    one rounding per fused multiply-add (the product and sum exact in
    float64, then rounded to float32), as FFMA sums it. No bias."""
    acc = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    for i in range(k):
        acc = (acc.double() + x[:, i:i + 1].double() * w[i, :n].double()).float()
    return acc


def _layer_tf32(x: torch.Tensor, w: torch.Tensor, k: int, n: int, hidden: int) -> torch.Tensor:
    """x[:, :k] @ w[:k, :n] (float32) as the kernel sums it at a padded
    width, per k-chunk of 8 MMAs (``_mma_model``), each chunk's sum added to
    a float32 accumulator with a rounded add, chunk by chunk. No bias.

      * widths 32 and 64 (csrc/mma.cuh ``mma_tf32_tiles``): u = -a_big *
        b_big from zero, d = a_big * b_big + u (what u's truncation
        dropped), then a_small * b_big, a_big * b_small and, with
        ``tf32_passes`` 4, a_small * b_small into d; the chunk's sum is
        d - u, rounded;
      * from 128 (``mma_3xtf32_rows``): a_small * b_big, a_big * b_small,
        a_big * b_big from zero, the truncated sum rounded to even
        (``round_truncated_to_even``)."""
    t, kt = x.shape[0], k // 8
    a = x[:, :k].float()
    a_big = tf32_rna(a)
    a_small = tf32_rna(a - a_big)
    b = w[:k, :n].float()
    b_big = tf32_rna(b)
    b_small = tf32_rna(b - b_big)
    regs = hidden <= 64
    terms = ((a_big, b_big), (a_small, b_big), (a_big, b_small))
    if regs and tf32_passes(hidden) == 4:
        terms += ((a_small, b_small),)
    elif not regs:
        terms = terms[1:] + terms[:1]
    passes = [(p.reshape(t, kt, 8), q.reshape(kt, 8, n)) for p, q in terms]
    acc = torch.zeros((t, n), dtype=torch.float32, device=x.device)
    group = max(1, MODEL_ELEMENTS // (t * 9 * n))
    for g0 in range(0, kt, group):
        g = slice(g0, g0 + group)
        d = torch.zeros((t, len(range(kt)[g]), n), dtype=torch.float32, device=x.device)
        if regs:
            u = _mma_model(d, -passes[0][0][:, g], passes[0][1][g])
            d = u
        for p, q in passes:
            d = _mma_model(d, p[:, g], q[g])
        d = d - u if regs else round_truncated_to_even(d)
        for j in range(d.shape[1]):
            acc = acc + d[:, j]
    return acc


def mlp_chain_3xtf32_mma(weights: torch.Tensor, biases: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """The FP32 chain summed as the march kernel's tensor-core chain sums it
    (K1 a ray per thread, csrc/chain.cuh ``chain_tf32_regs`` at 32 and 64,
    ``chain_tf32_smem`` from 128), a model for checks on any device:
    weights [L, H, H] and biases [L, H] from ``pack_params``, x [T, H]
    zero-padded inputs. Returns the head [T].

    Every layer is 3xTF32 (4xTF32 at width 32, ``tf32_passes``;
    ``_layer_tf32``): each operand split into big = tf32(v) and
    small = tf32(v - big) (``tf32_rna``), per k-chunk of 8 rows the MMAs of
    the width's scheme, each aligning and truncating its products as
    ``_mma_model`` does, the chunk's sum added to a float32 accumulator
    with a rounded add; then the bias, then ReLU on every layer but the
    last. The first layer is one k-chunk (the true inputs, zero-padded to
    8); at widths 32 and 64 it is summed on FFMA in input order instead
    (``_layer_fma``). The head is n-tile 0 (8 columns, the SDF column 0)."""
    n_layers, h = weights.shape[0], weights.shape[2]
    rows = max(1, MODEL_ELEMENTS // (9 * h))
    if x.shape[0] > rows:
        return torch.cat([mlp_chain_3xtf32_mma(weights, biases, x[i:i + rows])
                          for i in range(0, x.shape[0], rows)])
    for l in range(n_layers):
        last = l + 1 == n_layers
        n = 8 if last else h
        if l == 0 and h <= 64:
            y = _layer_fma(x, weights[0], 8, n)
        else:
            y = _layer_tf32(x, weights[l], 8 if l == 0 else h, n, h)
        y = y + biases[l, :n]
        x = y if last else torch.relu(y)
    return x[:, 0]


def check_tensor(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's wrapper hands the kernel."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mlp_forward_plain(weights: torch.Tensor, biases: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, on any device: x
    [B, n_in] points through the padded chain. Returns the head [B]."""
    n, n_in = x.shape
    h = weights.shape[1]
    xp = torch.zeros((plain_rows(n, h, x.device), h), dtype=torch.float32, device=x.device)
    xp[:n, :n_in] = x
    return chain_in_blocks(lambda b: mlp_chain_plain(weights, biases, b, weights.shape[0]),
                           xp)[:n, 0]


def _mlp_forward_cuda(weights: torch.Tensor, biases: torch.Tensor,
                      x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    global MLP_LAUNCHES
    n_layers, hidden = weights.shape[0], weights.shape[1]
    if hidden not in KERNEL_WIDTHS:
        raise ValueError(f"the forward kernel is built for widths {KERNEL_WIDTHS}, "
                         f"not {hidden}")
    n, n_in = x.shape
    if not 1 <= n_in <= 4:
        raise ValueError(f"the forward kernel takes 1 to 4 inputs per point, not {n_in}")
    dev = x.device
    check_tensor("x", x, torch.float32, (n, n_in), dev)
    check_tensor("weights", weights, torch.float32, (n_layers, hidden, hidden), dev)
    check_tensor("biases", biases, torch.float32, (n_layers, hidden), dev)
    check_tensor("packed", packed, torch.float32,
                 (n_layers, hidden // 8, hidden // 8, 32, 2), dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.cnr_mlp_forward(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        x.data_ptr(), weights.data_ptr(), packed.data_ptr(), biases.data_ptr(), n_layers,
        hidden, n_in, n, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"forward kernel launch failed: {lib.cnr_error_string(err).decode()} ({err})")
    MLP_LAUNCHES += 1
    return out


def mlp_forward(weights: torch.Tensor, biases: torch.Tensor, x: torch.Tensor,
                packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused forward pass: weights [L, H, H] and biases [L, H] from
    ``pack_params``, x [B, n_in] points. Returns [B] raw logits (the
    single-output head). ``packed`` is ``pack_mma(weights, "tf32")`` (or
    ``packed_mma(params, "tf32")``), which the kernel reads: CUDA tensors
    need it, CPU tensors ignore it.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise). The kernel has no gradient: differentiable callers use the
    plain chain (``render.renderer.scene_fn(for_grad=True)``)."""
    if x.device.type == "cpu":
        return mlp_forward_plain(weights, biases, x)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_forward runs on cpu or cuda tensors, not {x.device}")
    if packed is None:
        raise ValueError("the forward kernel reads packed = packed_mma(params, 'tf32')")
    return _mlp_forward_cuda(weights, biases, x, packed)


def neural_sdf_fn_kernel(params: MLP, frame=0.0, num_inputs: int = 3):
    """An SdfFn over (..., 3) points backed by the forward kernel — the
    counterpart of ``neural_sdf_fn_pallas`` and a drop-in for
    ``render.renderer.neural_sdf_fn`` where no gradient is taken.
    ``num_inputs=4`` appends the frame number as a 4th input."""
    weights, biases, _, _ = packed_params(params)
    packed = packed_mma(params, "tf32") if weights.device.type == "cuda" else None

    def fn(p: torch.Tensor) -> torch.Tensor:
        flat = p.reshape(-1, p.shape[-1])
        if num_inputs == 4:
            f = frame_tensor(frame, flat.device).to(flat.dtype).expand(flat.shape[0], 1)
            flat = torch.cat([flat, f], dim=-1)
        return mlp_forward(weights, biases, flat.contiguous(), packed).reshape(p.shape[:-1])

    return fn
