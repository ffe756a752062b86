"""The plain reference of the multiresolution hash-grid SDF, in plain PyTorch.

Written from the equations of Müller et al., *Instant Neural Graphics
Primitives with a Multiresolution Hash Encoding* (SIGGRAPH 2022,
arXiv:2201.05989, section 3), at the settings of ``NVlabs/instant-ngp``
``configs/sdf/base.json``. For a point p in the render's bound:

  * x = p * (1 / span) + 0.5, span = 2 * bound radius (2.4): the cube around
    the bounding sphere to [0, 1]^3, then clamped to [0, 1];
  * level l of L has scale s_l = base * b^l - 1 (b the per-level scale,
    exp(ln(N_max / base) / (L - 1))), rounded once to float32, resolution
    R_l = ceil(s_l) + 1 and a table of T_l = min(2^log2_T, R_l^3 rounded up
    to a multiple of 8) entries of F = 2 features;
  * u = s_l * x + 0.5, corner g = floor(u), fraction f = u - g;
  * the index of a corner: (g_x + g_y R_l + g_z R_l^2) mod 2^32 mod T_l
    where R_l^3 <= 2^log2_T (1:1), else the hash
    (g_x * 1 xor g_y * 2654435761 xor g_z * 805459861) mod 2^32 mod T_l;
    the corners' integer arithmetic is uint32's (a corner below 0 wraps);
  * trilinear interpolation over the 8 corners: corner c takes bit 0 of c
    on x, bit 1 on y, bit 2 on z, the weight (w_x * w_y) * w_z with
    w = f for the upper corner and 1 - f for the lower, and the features sum
    in corner order from corner 0;
  * the L levels' F features concatenate level by level (L * F inputs) into
    an MLP: ReLU after every hidden layer, no output activation.

Everything is float32, one rounding per operation, TF32 off (the control
switches ``emulate_tf32`` on where the device has no TF32, as
``render.Net`` does). Departures from tiny-cuda-nn
(``include/tiny-cuda-nn/encodings/grid.h``), each deliberate:

  * u = s * x + 0.5 is a product and a sum, each rounded; tiny-cuda-nn
    contracts it into one fused multiply-add, and its scale is
    ``exp2f(l * log2(b)) * base - 1`` in float32, where this one rounds the
    float64 value once;
  * each corner's contribution w * v is rounded before it is added, where
    tiny-cuda-nn's compiler may contract the sum into multiply-adds;
  * the table and the MLP are float32, where instant-ngp stores and runs
    them in float16;
  * x is clamped to the unit cube: the render's march reaches beyond it
    (a ray's budget is its far distance to the bounding sphere, so the
    march ends as far from the center as the camera, |p| = 2), where
    tiny-cuda-nn's 1:1 levels wrap their indices into the shape's inside
    and would put surfaces there; instant-ngp queries its SDF inside its
    bounding box only;
  * a pre-activation of exactly 0 takes the ReLU gradient 1/2 (the
    reference renderer's convention, ``render._ReluTie``), where
    tiny-cuda-nn takes 0.

It imports nothing of the program under test, nor JAX.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .render import _ReluTie, _Tf32Matmul

#: The hash's primes, one an axis (tiny-cuda-nn's coherent prime hash).
PRIMES = (1, 2654435761, 805459861)
#: Points a block of the encoding handles at once.
BLOCK_POINTS = 1 << 18
U32 = 0xFFFFFFFF


def per_level_scale(base: int, max_resolution: int, n_levels: int) -> float:
    """b = exp(ln(N_max / base) / (L - 1))."""
    return math.exp(math.log(max_resolution / base) / (n_levels - 1))


def levels(n_levels: int, base: int, b: float, log2_size: int):
    """Per level: the scale (float32), the resolution, the table size, the
    first entry and whether the level is hashed."""
    out, first = [], 0
    for l in range(n_levels):
        s = np.float32(base * b ** l - 1.0)
        res = int(math.ceil(float(s))) + 1
        dense = -(-res ** 3 // 8) * 8
        size = min(1 << log2_size, dense)
        out.append(dict(scale=s, res=res, size=size, first=first,
                        hashed=res ** 3 > (1 << log2_size)))
        first += size
    return out


def _mul_low(a: torch.Tensor, c: int, bits: int) -> torch.Tensor:
    """The low ``bits`` bits of a * c (a >= 0): those of the low bits' product."""
    m = (1 << bits) - 1
    return ((a & m) * (c & m)) & m


def level_tensors(lvs, device) -> dict:
    """The levels' constants as tensors on ``device``, made once (a CUDA
    graph of the tracer's tail may not copy them in)."""
    ints = lambda key: torch.tensor([int(lv[key]) for lv in lvs], device=device)  # noqa: E731
    hashed_size = max([lv["size"] for lv in lvs if lv["hashed"]], default=1)
    assert hashed_size & (hashed_size - 1) == 0, "a hashed level's table is a power of two"
    return dict(scale=torch.tensor([float(lv["scale"]) for lv in lvs], dtype=torch.float32,
                                   device=device),
                res=ints("res"), size=ints("size"), first=ints("first"),
                hashed=ints("hashed") > 0, hashed_size=hashed_size)


def encode(p: torch.Tensor, table: torch.Tensor, lv: dict, inv_span: np.float32) -> torch.Tensor:
    """Features [N, L * F] of points p [N, 3] float32, ``lv`` the levels'
    ``level_tensors``: every level at once (each level's arithmetic is the
    module docstring's, element by element), so
    that a block of points costs a few hundred operations rather than a few
    thousand."""
    x = torch.clamp(p * float(inv_span) + 0.5, 0.0, 1.0)
    res, size, first, hashed = lv["res"], lv["size"], lv["first"], lv["hashed"]
    hashed_size = lv["hashed_size"]
    bits = hashed_size.bit_length() - 1
    u = x[:, None, :] * lv["scale"][None, :, None] + 0.5  # [N, L, 3]
    g = torch.floor(u)
    f = u - g
    gi = g.to(torch.int64) & U32
    w = (1.0 - f, f)  # lower, upper corner weights per axis
    acc = None
    for c in range(8):
        bit = [(c >> a) & 1 for a in range(3)]
        gx, gy, gz = ((gi[..., a] + bit[a]) & U32 for a in range(3))
        dense = ((gx + gy * res + gz * (res * res)) & U32) % size
        hashed_idx = ((gx & (hashed_size - 1)) ^ _mul_low(gy, PRIMES[1], bits)
                      ^ _mul_low(gz, PRIMES[2], bits))
        v = table[first + torch.where(hashed, hashed_idx, dense)]  # [N, L, F]
        weight = (w[bit[0]][..., 0] * w[bit[1]][..., 1]) * w[bit[2]][..., 2]
        term = weight[..., None] * v
        acc = term if acc is None else acc + term
    return acc.reshape(p.shape[0], -1)


class HashGridNet:
    """The hash-grid SDF's distance: points [N, 3] -> [N] float32.

    ``weights`` is the model kind's dict (``portbench.models.hash_grid``):
    ``table`` [sum T_l, F], ``layers`` [(w [in, out], b [out]), ...] and the
    encoding's constants."""

    def __init__(self, weights: dict, device):
        self.table = torch.as_tensor(np.asarray(weights["table"], np.float32), device=device)
        self.layers = [(torch.as_tensor(np.asarray(w, np.float32), device=device),
                        torch.as_tensor(np.asarray(b, np.float32), device=device))
                       for w, b in weights["layers"]]
        self.levels = levels(int(weights["n_levels"]), int(weights["base_resolution"]),
                             float(weights["per_level_scale"]),
                             int(weights["log2_hashmap_size"]))
        self.inv_span = np.float32(1.0 / float(weights["span"]))
        self.level_tensors = level_tensors(self.levels, device)
        self.emulate_tf32 = False

    def features(self, p: torch.Tensor) -> torch.Tensor:
        return torch.cat([encode(p[i:i + BLOCK_POINTS], self.table, self.level_tensors,
                                 self.inv_span)
                          for i in range(0, p.shape[0], BLOCK_POINTS)])

    def mlp(self, h: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, (w, b) in enumerate(self.layers):
            h = (_Tf32Matmul.apply(h, w) if self.emulate_tf32 else h @ w) + b
            if i < last:
                h = _ReluTie.apply(h)
        return h[:, 0]

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.features(p))
