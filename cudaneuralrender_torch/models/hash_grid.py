"""The multiresolution hash-grid SDF (Müller et al., Instant NGP,
arXiv:2201.05989, section 3): a table of F = 2 features at the corners of L
grids, interpolated trilinearly at a point and fed to an MLP.

For a point p in the render's bound (``span`` = 2 x its radius):

  * x = clamp(p * (1 / span) + 0.5, 0, 1): the render marches beyond the
    bound (a ray's budget reaches |p| = |origin|), where the 1:1 levels'
    wrapped indices would read the inside of the shape;
  * level l has scale s_l = base * b^l - 1 (rounded once to float32),
    resolution R_l = ceil(s_l) + 1 and T_l = min(2^log2_T, R_l^3 rounded up
    to a multiple of 8) table entries, from entry ``first_l`` of the table;
  * u = s_l * x + 0.5, corner g = floor(u), fraction f = u - g;
  * a corner's index: (g_x + g_y R_l + g_z R_l^2) mod 2^32 mod T_l where
    R_l^3 <= 2^log2_T, else (g_x xor g_y 2654435761 xor g_z 805459861)
    mod 2^32 mod T_l, in uint32 arithmetic;
  * corner c (bit 0 of c on x, 1 on y, 2 on z) weighs (w_x * w_y) * w_z,
    w = f upper and 1 - f lower; the level's features sum corner by corner
    from corner 0; levels concatenate (L * F features) into the ``MLP``.

``encode_plain`` is the encoding in plain PyTorch: float32, one rounding per
operation in that order (no fused multiply-add), which the CUDA kernels
(``csrc/hash_grid.cuh``) copy, so the ray-per-warp march rung, whose chain
sums in the plain order too, gives the plain march's results bit for bit.
It is differentiable in p through the weights (floor has gradient 0).

The model marches through the same kernels as the dense chain
(``csrc/march.cuh``: the encoding is the chain's input stage, at MLP width
64) and shades through ``encode_kernel``'s forward and input gradient
(``csrc/hash_grid.cu``) with the MLP under autograd. It renders the
``neural_raw`` scene only; ``check_render`` names what else it lacks.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..utils import trace
from .mlp import MLP, apply_scalar, from_numpy_params, layer_sizes, resolve_device

#: The hash's primes, one an axis (tiny-cuda-nn's coherent prime hash).
PRIMES = (1, 2654435761, 805459861)
#: Levels the kernels hold (a lane of the march kernel encodes four).
MAX_LEVELS = 16
#: Features a level.
N_FEATURES = 2
#: The MLP's padded width the hash-grid kernels are instantiated at.
KERNEL_WIDTH = 64
#: Rows of ``level_words`` (MAX_LEVELS words each): scale (float32 bits),
#: resolution, first entry, table size, hashed (0 / 1); then the level
#: count and 1 / span (float32 bits). ``csrc/hash_grid.cuh`` reads them.
LEVEL_ROWS = 5
U32 = 0xFFFFFFFF


def level_table(n_levels: int, base_resolution: int, per_level_scale: float,
                log2_hashmap_size: int) -> list:
    """Per level: ``scale`` (np.float32), ``res``, ``size``, ``first``,
    ``hashed``."""
    out, first = [], 0
    for l in range(n_levels):
        s = np.float32(base_resolution * per_level_scale ** l - 1.0)
        res = int(math.ceil(float(s))) + 1
        size = min(1 << log2_hashmap_size, -(-res ** 3 // 8) * 8)
        out.append(dict(scale=s, res=res, size=size, first=first,
                        hashed=res ** 3 > (1 << log2_hashmap_size)))
        first += size
    return out


class HashGridSDF(nn.Module):
    """The table [sum T_l, 2] float32 and the ``MLP`` (L * 2 inputs, hidden
    layers padding to width 64, one output) on one device, with the
    encoding's constants. Parameters need no gradient (rendering only)."""

    def __init__(self, table: torch.Tensor, mlp: MLP, *, n_levels: int, base_resolution: int,
                 per_level_scale: float, log2_hashmap_size: int, span: float):
        super().__init__()
        from ..kernels.fused_mlp import padded_width

        self.levels = level_table(n_levels, base_resolution, per_level_scale,
                                  log2_hashmap_size)
        total = self.levels[-1]["first"] + self.levels[-1]["size"]
        if not 1 <= n_levels <= MAX_LEVELS:
            raise ValueError(f"the hash grid's kernels hold 1 to {MAX_LEVELS} levels, "
                             f"not {n_levels}")
        if tuple(table.shape) != (total, N_FEATURES) or table.dtype != torch.float32:
            raise ValueError(f"the table must be float32 [{total}, {N_FEATURES}] for these "
                             f"levels, not {table.dtype} {tuple(table.shape)}")
        sizes = layer_sizes(mlp)
        if sizes[0] != n_levels * N_FEATURES or sizes[-1] != 1:
            raise ValueError(f"the MLP must take {n_levels * N_FEATURES} features to 1 "
                             f"output, not {sizes[0]} to {sizes[-1]}")
        if padded_width(max(sizes)) != KERNEL_WIDTH:
            raise ValueError(f"the hash-grid march kernels are instantiated at MLP width "
                             f"{KERNEL_WIDTH} only; this MLP pads to "
                             f"{padded_width(max(sizes))}")
        self.table = nn.Parameter(table, requires_grad=False)
        self.mlp = mlp
        self.n_levels, self.span = int(n_levels), float(span)
        self.inv_span = np.float32(1.0 / float(span))
        words = np.zeros(LEVEL_ROWS * MAX_LEVELS + 2, np.uint32)
        for l, lv in enumerate(self.levels):
            words[l] = np.float32(lv["scale"]).view(np.uint32)
            words[MAX_LEVELS + l] = lv["res"]
            words[2 * MAX_LEVELS + l] = lv["first"]
            words[3 * MAX_LEVELS + l] = lv["size"]
            words[4 * MAX_LEVELS + l] = int(lv["hashed"])
        words[-2] = n_levels
        words[-1] = self.inv_span.view(np.uint32)
        self.register_buffer("level_words",
                             torch.from_numpy(words.view(np.int32)).to(table.device))

    @property
    def device(self) -> torch.device:
        return self.table.device

    def features(self, p: torch.Tensor) -> torch.Tensor:
        """The plain encoding of points p [..., 3]: [..., L * 2]."""
        return encode_plain(p, self.table, self.levels, self.inv_span)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        """The SDF at points p [..., 3]: [...] (plain encoding, plain MLP)."""
        return apply_scalar(self.mlp, self.features(p))

    # The model interface (``mlp.MLP`` has the dense chain's): the encoding
    # is the chain's input stage.

    @property
    def chain(self) -> MLP:
        """The MLP the kernels' chain runs on the encoding's features."""
        return self.mlp

    @property
    def gathers_per_eval(self) -> int:
        """Table entries one SDF evaluation gathers: 8 corners a level."""
        return 8 * self.n_levels

    #: The model's inputs: the point.
    num_inputs = 3

    def grid(self):
        """The table and level words the kernels' encoding reads."""
        return self.table, self.level_words

    def plain_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """The chain's inputs for points x [..., 3]: the plain encoding."""
        return self.features(x)

    def check_render(self, config) -> None:
        """Raise a ValueError naming what this model lacks for a render of
        ``config``: it renders the ``neural_raw`` scene from 3 inputs, with
        no fused forward kernel (``use_pallas``)."""
        if config.scene != "neural_raw":
            raise ValueError(f"a HashGridSDF renders the neural_raw scene only: its march "
                             f"kernels compose no scene {config.scene!r}")
        if config.num_inputs != 3:
            raise ValueError(f"a HashGridSDF takes 3 inputs (the point), not "
                             f"config.num_inputs={config.num_inputs}")
        if config.use_pallas:
            raise ValueError("a HashGridSDF has no fused forward kernel (K3): render it with "
                             "use_pallas=False")

    def require_dense(self, what: str) -> None:
        """Raise a ValueError: ``what`` differentiates or packs a dense chain
        only."""
        raise ValueError(f"{what} takes a dense ReLU chain (an MLP); a HashGridSDF has no "
                         f"path there")

    def shade_sdf_fn(self, config, frame):
        """The SDF of a render's shading normals over (..., 3) points: on the
        card, where the points require a gradient, the encoding kernel
        (``_Encode``) and the MLP's plain chain under autograd; elsewhere the
        plain encoding and chain under autograd."""

        def fn(p: torch.Tensor) -> torch.Tensor:
            if p.device.type == "cuda" and p.requires_grad and torch.is_grad_enabled():
                flat = p.reshape(-1, 3).contiguous()
                return apply_scalar(self.mlp, _Encode.apply(flat, self)).reshape(p.shape[:-1])
            return self(p)

        return fn


def _mul_low(a: torch.Tensor, c: int, bits: int) -> torch.Tensor:
    """The low ``bits`` bits of a * c (a >= 0): those of the low bits' product."""
    m = (1 << bits) - 1
    return ((a & m) * (c & m)) & m


def corner_index(g: torch.Tensor, lv: dict) -> torch.Tensor:
    """Index within the level of uint32 corners g [..., 3] (in int64)."""
    gx, gy, gz = g.unbind(-1)
    size = lv["size"]
    if lv["hashed"]:  # a hashed level's table is 2^log2_T entries
        bits = size.bit_length() - 1
        return (gx & (size - 1)) ^ _mul_low(gy, PRIMES[1], bits) ^ _mul_low(gz, PRIMES[2], bits)
    r = lv["res"]
    return ((gx + gy * r + gz * (r * r)) & U32) % size


#: The 8 corners' offsets, corner c's bit a on axis a.
_CORNERS = [[(c >> a) & 1 for a in range(3)] for c in range(8)]


def encode_plain(p: torch.Tensor, table: torch.Tensor, levels: list,
                 inv_span: np.float32) -> torch.Tensor:
    """Features [..., L * 2] of points p [..., 3] in float32: the module
    docstring's equations, one rounding per operation in their order, each
    level's 8 corners summed in corner order from corner 0."""
    shape = p.shape[:-1]
    x = torch.clamp(p.reshape(-1, 3) * float(inv_span) + 0.5, 0.0, 1.0)
    out = []
    for lv in levels:
        u = x * float(lv["scale"]) + 0.5
        g = torch.floor(u)
        f = u - g
        gi = g.detach().to(torch.int64) & U32
        w = (1.0 - f, f)
        acc = None
        for bit in _CORNERS:
            corner = torch.stack([(gi[:, a] + bit[a]) & U32 for a in range(3)], dim=-1)
            v = table[lv["first"] + corner_index(corner, lv)]
            weight = (w[bit[0]][:, 0] * w[bit[1]][:, 1]) * w[bit[2]][:, 2]
            term = weight[:, None] * v
            acc = term if acc is None else acc + term
        out.append(acc)
    return torch.cat(out, dim=1).reshape(shape + (len(levels) * N_FEATURES,))


def from_numpy_hash_grid(arrays: dict, device="cuda") -> HashGridSDF:
    """A ``HashGridSDF`` from plain arrays on ``device`` (default the card):
    ``table`` [sum T_l, 2], ``layers`` [(w [in, out], b [out]), ...] and the
    encoding's ``n_levels``, ``base_resolution``, ``per_level_scale``,
    ``log2_hashmap_size`` and ``span``."""
    device = resolve_device(device)
    return HashGridSDF(
        torch.tensor(np.asarray(arrays["table"]), dtype=torch.float32, device=device),
        from_numpy_params(arrays["layers"], device=device),
        n_levels=int(arrays["n_levels"]), base_resolution=int(arrays["base_resolution"]),
        per_level_scale=float(arrays["per_level_scale"]),
        log2_hashmap_size=int(arrays["log2_hashmap_size"]), span=float(arrays["span"]))


# ---------------------------------------------------------------------------
# The encoding kernel (csrc/hash_grid.cu): the shading normals' features and
# their gradient back to the points.

#: Launches of the encoding kernel (forward and backward) in this process.
ENCODE_LAUNCHES = 0


def _encode_cuda(model: HashGridSDF, p: torch.Tensor,
                 grad_features: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's features [n, L * 2] of points p [n, 3], or, given
    ``grad_features`` [n, L * 2], the gradient [n, 3] with respect to p."""
    global ENCODE_LAUNCHES
    from ..kernels import build
    from ..kernels.fused_mlp import check_tensor

    n = p.shape[0]
    dev = p.device
    k = model.n_levels * N_FEATURES
    check_tensor("points", p, torch.float32, (n, 3), dev)
    backward = grad_features is not None
    if backward:
        check_tensor("grad_features", grad_features, torch.float32, (n, k), dev)
    out = torch.empty((n, 3 if backward else k), dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.cnr_hash_encode(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        p.data_ptr(), model.table.data_ptr(), model.level_words.data_ptr(),
        grad_features.data_ptr() if backward else None, n,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash-grid encoding kernel launch failed: "
                           f"{lib.cnr_error_string(err).decode()} ({err})")
    ENCODE_LAUNCHES += 1
    return out


class _Encode(torch.autograd.Function):
    """The encoding kernel as an autograd op: the forward's features, and a
    backward that runs the kernel's input gradient. Both are the span
    ``encode`` under the span the forward ran in (the backward may run on
    autograd's device thread). The forward counts ``encode.gathers`` in it:
    its points' table entries, which a point's value and gradient need once
    (the two kernels gather them twice)."""

    @staticmethod
    def forward(ctx, p, model):
        ctx.model = model
        ctx.parent = trace.current()
        ctx.save_for_backward(p)
        with trace.span("encode"):
            trace.count("encode", gathers=p.shape[0] * model.gathers_per_eval)
            return _encode_cuda(model, p)

    @staticmethod
    def backward(ctx, grad_features):
        (p,) = ctx.saved_tensors
        with trace.within(ctx.parent), trace.span("encode"):
            return _encode_cuda(ctx.model, p, grad_features.contiguous()), None
