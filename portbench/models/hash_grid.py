"""The multiresolution hash-grid SDF (Müller et al., Instant NGP,
arXiv:2201.05989; ``NVlabs/instant-ngp`` ``configs/sdf/base.json``): 16
levels of 2 features, 2^19 entries a level, interpolated at 8 corners into a
32 -> 64 -> 64 -> 1 ReLU MLP (``reference/hash_grid.py`` has the
equations).

Its parameters are built from the seed around a real shape, the repository's
``csg_demo`` surface, so that the turntable frames the same object as the
other cells and every ray has a surface to find (random features would give
none: each ray would miss, or spend its 6000 steps):

  * feature 0 of each 1:1 (dense) level is csg_demo's SDF at the level's
    vertices, evaluated by ``reference.render.Net`` on the configuration's
    ``sdf_weights`` file, held to its sha256, as a distance (the trained
    net's own gradient norm spreads 0.5-1.7 near its surface): each vertex
    moved ``PROJECTION_STEPS`` (4) Newton steps p <- p - d grad d / |grad d|^2
    onto the net's zero set, the length of the move signed by d; beyond two
    of the finest dense cells (where such a move may end on a farther sheet
    and read long) at most the distance to the nearest of the surface
    samples that the finest level's near vertices give (``_surface``);
  * every other entry is seeded noise, uniform in [-A_l, A_l], A_l chosen so
    that the level adds at most ``DETAIL_GRADIENT`` (0.02) to the gradient's
    norm near the surface: the MLP's gain from each of the level's features
    (twice the largest |d out / d feature| of its seeded units over a
    seeded sample of the finest dense level's vertices within 0.02 of the
    surface; the sum over all paths of |weight| products reads some 20
    times higher, and left the finest levels' detail invisible) times the
    interpolant's largest slope, 2 sqrt(3) A_l s_l / span;
  * the MLP is seeded He initialisation scaled by ``MLP_SCALE`` (0.1), plus
    in each hidden layer a ReLU pair (units 0 and 1) that carries m, the
    mean of the dense levels' feature 0 weighted by each level's scale s_l
    (the coarsest level's interpolation smooths csg_demo's creases over
    2.4 / 15, so a plain mean leaves more of the surface's gradient norms
    under 0.8), to the output: relu(m + B) and
    relu(-m + B) with B = ``PAIR_BIAS`` (0.25), halved and differenced by the
    next layer and the head, so the output is m wherever |m| < B, and
    B + (|m| - B) / 4 beyond: away from the surface a Newton path's end is a
    surface point but not the nearest, so the distance there can read long,
    and a sphere tracer on it would step through the surface; a quarter of
    it does not. The pair and the seeded units do not feed each other.

The result is csg_demo's surface, smoothed by the dense levels'
interpolation, with fine detail from every level; |grad SDF| lies in
[0.8, 1.2] near the surface (``tests/test_torch_hash_grid.py``), so sphere
tracing stays valid. The pair's activations sit near B, as a trained MLP's
hidden units sit at a scale of their own, so TF32's 10-bit rounding (the
check's control) moves the surface by up to B 2^-11, about 1.2e-4.
"""
from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch

from .. import work
from ..metrics.gather_roofline import L2_BYTES_PER_S
from ..reference import hash_grid as ref
from ..reference.render import Net
from ..weights import load_npz

#: The weights' construction (the module docstring).
PROJECTION_STEPS = 4
MLP_SCALE = 0.1
PAIR_BIAS = 0.25
DETAIL_GRADIENT = 0.02


def per_level_scale(config: dict) -> float:
    return ref.per_level_scale(int(config["base_resolution"]), int(config["max_resolution"]),
                               int(config["n_levels"]))


def _levels(config: dict):
    return ref.levels(int(config["n_levels"]), int(config["base_resolution"]),
                      per_level_scale(config), int(config["log2_hashmap_size"]))


def _sdf_net(config: dict, root: str) -> Net:
    path = os.path.join(root, config["sdf_weights"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != config["sdf_weights_sha256"]:
        raise ValueError(f"{config['name']}: {config['sdf_weights']} has sha256 {digest}, "
                         f"not the {config['sdf_weights_sha256']} the cell was proven on")
    return Net(load_npz(path), "cpu")


def _distance_step(net: Net, p: torch.Tensor, steps: int) -> torch.Tensor:
    """The move [N, 3] of ``steps`` Newton steps p <- p - d grad d / |grad d|^2
    from points p [N, 3] onto the net's zero set."""
    x = p.clone()
    for _ in range(steps):
        q = x.clone().requires_grad_(True)
        with torch.enable_grad():
            d = net(q)
            (g,) = torch.autograd.grad(d.sum(), q)
        x = x - (d.detach() / torch.clamp((g * g).sum(1), min=1e-2))[:, None] * g
    return x - p


def _distance(net: Net, p: torch.Tensor, steps: int) -> torch.Tensor:
    """The net's SDF at points p [N, 3] as a distance: the length of the
    move of ``steps`` Newton steps onto its zero set, signed by the SDF."""
    with torch.no_grad():
        sign = torch.sign(net(p))
    return sign * _distance_step(net, p, steps).norm(dim=1)


#: Surface samples a near vertex of the finest dense level seeds.
SURFACE_JITTERS = 8


def _surface(net: Net, near: torch.Tensor, cell: float, steps: int):
    """A k-d tree of points on the net's zero set: each of ``near`` (the
    finest dense level's vertices within two cells of the surface) and
    ``SURFACE_JITTERS`` copies moved within its cell (a fixed draw: the
    surface is every seed's), each taken ``steps`` Newton steps onto it."""
    from scipy.spatial import cKDTree

    jitter = np.random.default_rng(0).uniform(-0.5, 0.5, (SURFACE_JITTERS, *near.shape))
    starts = torch.cat([near] + [near + torch.from_numpy(j * cell).float() for j in jitter])
    on = []
    for i in range(0, starts.shape[0], 65536):
        p = starts[i:i + 65536]
        on.append(p + _distance_step(net, p, steps))
    return cKDTree(torch.cat(on).numpy())


def _vertices(lv: dict, span: float) -> np.ndarray:
    """World positions [R^3, 3] of a dense level's vertices in index order
    g_x + g_y R + g_z R^2: u = g, so x = (g - 0.5) / s and p = (x - 0.5) span."""
    r = lv["res"]
    g = np.arange(r, dtype=np.float64)
    gz, gy, gx = np.meshgrid(g, g, g, indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    return (((grid - 0.5) / float(lv["scale"]) - 0.5) * span).astype(np.float32)


def _mlp(config: dict, rng):
    """The MLP's layers and its seeded part's gain bound a feature."""
    sizes = [int(config["n_levels"]) * int(config["n_features_per_level"])]
    sizes += [int(config["n_neurons"])] * int(config["n_hidden_layers"]) + [1]
    alpha = MLP_SCALE
    bias = np.float32(PAIR_BIAS)
    layers = []
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        std = math.sqrt((1.0 if last else 2.0) / n_in) * alpha
        w = np.zeros((n_in, n_out), np.float32)
        b = np.zeros(n_out, np.float32)
        rows = slice(0, n_in) if i == 0 else slice(2, n_in)
        cols = slice(0, 1) if last else slice(2, n_out)
        w[rows, cols] = rng.normal(0.0, std, (w[rows, cols].shape)).astype(np.float32)
        layers.append([w, b])
    return layers, bias


#: Near-surface vertices that sample the seeded units' gain.
GAIN_POINTS = 4096


def _gain(layers, table, lvs, near, span: float, rng) -> np.ndarray:
    """Twice the largest |d out / d feature| of the MLP's seeded units (all
    but the pair) over ``GAIN_POINTS`` of the points ``near``, their
    features encoded from ``table`` (the dense levels' distances only)."""
    pick = torch.as_tensor(rng.choice(near.shape[0], min(GAIN_POINTS, near.shape[0]),
                                      replace=False))
    feats = ref.encode(near[pick], torch.from_numpy(table), ref.level_tensors(lvs, "cpu"),
                       np.float32(1.0 / span))
    feats.requires_grad_(True)
    h = feats
    for i, (w, _) in enumerate(layers):
        w = torch.from_numpy(w).clone()
        if i + 1 < len(layers):
            w[:, :2] = 0.0  # the pair's units
            h = torch.relu(h @ w)
        else:
            w[:2] = 0.0
            h = h @ w
    (g,) = torch.autograd.grad(h.sum(), feats)
    return 2.0 * g.abs().amax(0).double().numpy()


def _dense_distances(config: dict, root: str) -> tuple:
    """Feature 0 of each dense level (csg_demo's distance at its vertices,
    the same for every seed, computed once a process), and the finest
    level's vertices within 0.02 of the surface."""
    lvs = _levels(config)
    dense = [l for l, lv in enumerate(lvs) if not lv["hashed"]]
    span = float(config["span"])
    steps = PROJECTION_STEPS
    key = (os.path.abspath(os.path.join(root, config["sdf_weights"])),
           config["sdf_weights_sha256"], span, steps,
           tuple((float(lvs[l]["scale"]), lvs[l]["res"]) for l in dense))
    if key in _DISTANCES:
        return _DISTANCES[key]
    net = _sdf_net(config, root)
    out, surface = {}, None
    for l in reversed(dense):  # the finest first: its vertices sample the surface
        lv = lvs[l]
        pts = torch.from_numpy(_vertices(lv, span))
        sdf = torch.cat([_distance(net, pts[i:i + 65536], steps)
                         for i in range(0, pts.shape[0], 65536)])
        if surface is None:
            band = 2.0 * span / float(lv["scale"])
            near_pts = pts[sdf.abs() < 0.02]
            surface = _surface(net, pts[sdf.abs() < band], span / float(lv["scale"]), steps)
        # Within two of the finest cells the Newton path's length is the
        # distance; beyond, it may end on a farther sheet, and the nearest
        # surface sample bounds it.
        nearest, _ = surface.query(pts.numpy())
        bound = torch.minimum(sdf.abs(), torch.from_numpy(nearest).float())
        out[l] = torch.where(sdf.abs() <= band, sdf, torch.sign(sdf) * bound).numpy()
    _DISTANCES[key] = (out, near_pts)
    return _DISTANCES[key]


_DISTANCES: dict = {}


def make(config: dict, root: str, seed: int) -> dict:
    """The table, the MLP and the encoding's constants, as plain arrays;
    deterministic for a seed."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x4861736847726964])
    span = float(config["span"])
    lvs = _levels(config)
    f = int(config["n_features_per_level"])
    table = np.zeros((lvs[-1]["first"] + lvs[-1]["size"], f), np.float32)
    layers, pair_bias = _mlp(config, rng)

    dense = [l for l, lv in enumerate(lvs) if not lv["hashed"]]
    total = sum(float(lvs[l]["scale"]) for l in dense)
    (w0, b0) = layers[0]
    half = np.float32(0.5)
    for l in dense:
        share = np.float32(float(lvs[l]["scale"]) / total)
        w0[f * l, 0], w0[f * l, 1] = share, -share
    b0[0] = b0[1] = pair_bias
    for w, b in layers[1:-1]:
        w[0, 0], w[1, 0], w[0, 1], w[1, 1] = half, -half, -half, half
        b[0] = b[1] = pair_bias
    layers[-1][0][0, 0], layers[-1][0][1, 0] = half, -half

    distances, near = _dense_distances(config, root)
    for l in dense:
        lv = lvs[l]
        table[lv["first"]:lv["first"] + lv["res"] ** 3, 0] = distances[l]
    gain = _gain(layers, table, lvs, near, span, rng)

    detail = DETAIL_GRADIENT
    for l, lv in enumerate(lvs):
        cols = list(range(f)) if lv["hashed"] else list(range(1, f))
        slope = 2.0 * math.sqrt(3.0) * float(lv["scale"]) / span
        amp = detail / (sum(gain[f * l + c] for c in cols) * slope)
        noise = rng.uniform(-amp, amp, (lv["size"], len(cols))).astype(np.float32)
        table[lv["first"]:lv["first"] + lv["size"], cols[0]:] = noise
    return dict(table=table, layers=[(w, b) for w, b in layers],
                n_levels=int(config["n_levels"]),
                base_resolution=int(config["base_resolution"]),
                per_level_scale=per_level_scale(config),
                log2_hashmap_size=int(config["log2_hashmap_size"]), span=span)


def program(cnr, weights: dict, device):
    return cnr.from_numpy_hash_grid(weights, device=device)


def reference_net(weights: dict, device) -> ref.HashGridNet:
    return ref.HashGridNet(weights, device)


def flops_per_eval(config: dict) -> int:
    """The MLP's 2 * sum(fan_in * fan_out) and the interpolation's 512: 8
    corners of 16 levels, a weight (2 products) and 2 multiply-adds of its
    2 features each."""
    n = int(config["n_neurons"])
    k = int(config["n_levels"]) * int(config["n_features_per_level"])
    mlp = 2 * (k * n + (int(config["n_hidden_layers"]) - 1) * n * n + n)
    return mlp + int(config["n_levels"]) * 8 * 4


def bytes_per_eval(config: dict) -> float:
    """The table entries an evaluation gathers (8 corners a level, F float32
    features each: 1024 B) as the bytes HBM would move in the time L2 serves
    them: ``march_roofline`` divides by HBM's peak, and the table is served
    from L2 (``metrics/gather_roofline.py``)."""
    gathered = int(config["n_levels"]) * 8 * int(config["n_features_per_level"]) * 4
    return gathered * work.PEAK_BYTES_PER_S / L2_BYTES_PER_S
