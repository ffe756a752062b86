"""Ground-truth NumPy oracle of the CUDA reference renderer's semantics.

An independent float32 NumPy implementation of the reference's full
algorithm, used as the executable correctness anchor for per-pixel parity
tests (BASELINE configs 1-2). Ported *semantics* (not code) from:

  * camera math               src/main.cpp:207-222 (Eigen modelView)
  * per-pixel ray setup       src/volumeRender_kernel.cu:305-322
  * bounding-sphere cull      src/volumeRender_kernel.cu:200-215,325-342
  * march-step ordering       src/volumeRender_kernel.cu:459-476 (singleMarch)
  * render loop               src/volumeRender_kernel.cu:652-689
  * SDF/CSG library           src/volumeRender_kernel.cu:63-196
  * tetrahedron normals       src/volumeRender_kernel.cu:362-377 (verts :38-43)
  * facing / matcap shading   src/volumeRender_kernel.cu:381-413
  * rgbaFloatToInt            src/volumeRender_kernel.cu:266-274
  * MLP forward               src/neuralNetwork.cpp:54-63 + denseLayer.cu
                              (ReLU hidden, LINEAR final — the tanh-never-
                              executes quirk, SURVEY.md §3.6.1)

Documented deviations (deliberate fixes this framework made, SURVEY.md §3.6):
  * the exclusive-scan off-by-one (:553-563) is corrected — the bottom-right
    pixel marches like any other instead of reading a stale SDF slot;
  * rays that converge on the very last loop iteration are still shaded
    (the reference's loop exits before their coloring pass runs);
  * output rows follow this framework's convention (row 0 = image bottom,
    flipped at save) instead of the savePNG byte-reverse (§3.6.9).

Everything is vectorized over pixels but keeps the exact per-ray operation
order, in float32 throughout.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32

MARCHING_EPSILON = F32(1e-6)
NORMAL_EPSILON = F32(1e-5)

# tetrahedronVerts (volumeRender_kernel.cu:38-43)
TET_VERTS = np.array(
    [[1, -1, -1], [-1, -1, 1], [-1, 1, -1], [1, 1, 1]], dtype=F32
)


# ---------------------------------------------------------------- MLP ----

def mlp_forward(params, x: np.ndarray) -> np.ndarray:
    """Dense chain on [N, 3or4] float32 points -> [N] raw pre-tanh logit.

    ReLU on every layer except the last, which is LINEAR (the reference's
    "Tanh" epilogue compiles to LinearCombination — denseLayer.cu:93-113;
    tanh is applied downstream only by some sceneSDF variants)."""
    h = np.asarray(x, F32)
    n = len(params)
    for i, layer in enumerate(params):
        w = np.asarray(layer.w, F32)
        b = np.asarray(layer.b, F32)
        h = h @ w + b
        if i < n - 1:
            h = np.maximum(h, F32(0.0))
    return h[..., 0]


# ------------------------------------------------------ SDF / CSG ops ----

def _sdf_sphere(p, r):
    return np.sqrt(np.sum(p * p, axis=-1, dtype=F32)).astype(F32) - F32(r)


def _sdf_cylinder(p, c):
    # Reference quirk kept verbatim (volumeRender_kernel.cu:96-101): the
    # 2D distance uses (p.x - c.x, p.y - c.z) and the radius is c.y.
    dx = p[..., 0] - F32(c[0])
    dy = p[..., 1] - F32(c[2])
    return np.sqrt(dx * dx + dy * dy).astype(F32) - F32(c[1])


def _smooth_union(d1, d2, k):
    k = F32(k)
    h = np.clip(F32(0.5) + F32(0.5) * (d2 - d1) / k, F32(0), F32(1))
    return d2 * (F32(1) - h) + d1 * h - k * h * (F32(1) - h)


def _smooth_subtract(d1, d2, k):
    k = F32(k)
    h = np.clip(F32(0.5) - F32(0.5) * (d1 + d2) / k, F32(0), F32(1))
    return d1 * (F32(1) - h) - d2 * h + k * h * (F32(1) - h)


def _many_sphere(p, nsdf, frame, do_union):
    """volumeRender_kernel.cu:176-196. cP starts at p with cP.y -= 0.6 and
    cP.z += -0.7 + frame*2*0.7/360; every 3rd iteration bumps y by 0.4 and
    resets x to p.x + 0.5; each iteration subtracts 0.4 from x."""
    s = np.asarray(nsdf, F32)
    pz = p[..., 2] + (F32(-0.7) + F32(frame) * F32(2.0 * 0.7 / 360.0))
    py_base = p[..., 1] - F32(0.6)
    py = py_base
    for i in range(9):
        if i % 3 == 0:
            py = py + F32(0.4)
            px = p[..., 0] + F32(0.5)
        d = np.sqrt(px * px + py * py + pz * pz).astype(F32) - F32(0.1)
        if do_union:
            s = _smooth_union(s, d, 0.01)
        else:
            s = _smooth_subtract(s, d, 0.01)
        px = px - F32(0.4)
    return s


def _many_cylinder_cut(p, nsdf):
    """volumeRender_kernel.cu:156-174: 20x15 cylinder drill grid."""
    s = np.asarray(nsdf, F32)
    c = (F32(0.02), F32(0.02), F32(0.02))
    py = p[..., 1] - F32(0.5)
    for i in range(300):
        if i % 20 == 0:
            py = py + F32(0.1)
            px = p[..., 0] + F32(0.9)
        cp = np.stack([px, py, np.broadcast_to(p[..., 2], px.shape)], axis=-1)
        s = _smooth_subtract(s, _sdf_cylinder(cp, c), 0.01)
        px = px - F32(0.1)
    return s


def _displacement(p, nsdf):
    # sdfOpDisplace(p, tanh(nSDF)) — volumeRender_kernel.cu:103-110,151-154.
    s = np.tanh(nsdf).astype(F32)
    return s + (
        np.sin(F32(5) * p[..., 0]) * np.sin(F32(5) * p[..., 1])
        * np.sin(F32(5) * p[..., 2]) * F32(0.05)
    ).astype(F32)


def scene_sdf(scene: str, p: np.ndarray, nsdf: np.ndarray, frame: float) -> np.ndarray:
    """sceneSDF(p, nSDF) for each configurable composition
    (volumeRender_kernel.cu:217-230; the framework made the hardcoded pick a
    config — utils/config.py SCENE_NAMES)."""
    if scene == "neural_raw":
        return np.asarray(nsdf, F32)
    if scene == "neural_tanh":
        return np.tanh(nsdf).astype(F32)
    if scene == "many_sphere":
        return _many_sphere(p, nsdf, frame, True)
    if scene == "many_sphere_cut":
        return _many_sphere(p, nsdf, frame, False)
    if scene == "many_cylinder_cut":
        return _many_cylinder_cut(p, nsdf)
    if scene == "displacement":
        return _displacement(p, nsdf)
    if scene == "sphere":
        return _sdf_sphere(p, 0.9)
    raise ValueError(f"unknown scene {scene!r}")


def make_scene_eval(scene, params, frame, num_inputs=3):
    """Batched scene evaluator: [N,3] points -> [N] distances."""

    def f(p):
        p = np.asarray(p, F32)
        if params is not None:
            x = p
            if num_inputs == 4:
                x = np.concatenate(
                    [p, np.full(p.shape[:-1] + (1,), F32(frame))], axis=-1
                )
            nsdf = mlp_forward(params, x)
        else:
            nsdf = np.zeros(p.shape[:-1], F32)
        return scene_sdf(scene, p, nsdf, frame)

    return f


# ----------------------------------------------------------- camera ----

def view_matrices(rx: float, ry: float, translation=(0.0, 0.0, -2.0)):
    """main.cpp:207-222: modelView = Rx(-rx)·Ry(-ry) then translate(-T).
    Returns (cam_to_world [3,4] — transposedModelView, world_to_cam [4,4]
    — normalMatrix = inverse)."""
    ax = np.deg2rad(F32(-rx)).astype(F32)
    ay = np.deg2rad(F32(-ry)).astype(F32)
    cx, sx = np.cos(ax, dtype=F32), np.sin(ax, dtype=F32)
    cy, sy = np.cos(ay, dtype=F32), np.sin(ay, dtype=F32)
    rx_m = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=F32)
    ry_m = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=F32)
    r = (rx_m @ ry_m).astype(F32)
    t = np.asarray(translation, F32)
    cam_to_world = np.concatenate([r, (r @ (-t))[:, None]], axis=1).astype(F32)
    world_to_cam = np.eye(4, dtype=F32)
    world_to_cam[:3, :3] = r.T
    world_to_cam[:3, 3] = t
    return cam_to_world, world_to_cam


def generate_rays(cam_to_world, height, width, focal=2.0):
    """initMarcher ray setup (volumeRender_kernel.cu:313-322): u=(x/W)*2-1,
    v=(y/H)*2-1, dir = R @ normalize([u, v, -focal]); origin = translation
    column. Flat index = y*W + x (row 0 = image bottom)."""
    x = np.arange(width, dtype=F32)
    y = np.arange(height, dtype=F32)
    u = (x / F32(width)) * F32(2) - F32(1)
    v = (y / F32(height)) * F32(2) - F32(1)
    uu, vv = np.meshgrid(u, v)  # [H, W]
    d = np.stack(
        [uu, vv, np.full_like(uu, F32(-focal))], axis=-1
    ).reshape(-1, 3).astype(F32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True).astype(F32)
    dirs = (d @ cam_to_world[:, :3].T).astype(F32)
    origin = cam_to_world[:, 3].copy()
    return origin, dirs


def intersect_sphere(origin, dirs, center=(0, 0, 0), radius=1.2):
    """volumeRender_kernel.cu:200-215 — hit requires discrim > 0 strictly."""
    q = (origin - np.asarray(center, F32)).astype(F32)
    a = np.sum(dirs * dirs, axis=-1, dtype=F32)
    b = F32(2) * (dirs @ q).astype(F32)
    c = F32(np.dot(q, q)) - F32(radius) * F32(radius)
    disc = b * b - F32(4) * a * c
    hit = disc > F32(0)
    sq = np.sqrt(np.maximum(disc, F32(0)))
    tnear = (-b - sq) / (F32(2) * a)
    tfar = (-b + sq) / (F32(2) * a)
    return tnear.astype(F32), tfar.astype(F32), hit


# ------------------------------------------------------------ shading ----

def tetrahedron_normals(scene_eval, points):
    """surfaceNormal (volumeRender_kernel.cu:362-377): n = normalize(
    sum_k v_k * sceneSDF(p + v_k * NORMAL_EPSILON))."""
    offs = (
        points[:, None, :] + TET_VERTS[None, :, :] * NORMAL_EPSILON
    ).reshape(-1, 3).astype(F32)
    d = scene_eval(offs).reshape(-1, 4)
    n = (d[:, :, None] * TET_VERTS[None, :, :]).sum(axis=1, dtype=F32)
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(F32)


def facing_color(n, dirs):
    """facingColor (:381-384): grayscale max(0, dot(n, -ray)), alpha 1."""
    ratio = np.maximum(F32(0), np.sum(n * -dirs, axis=-1, dtype=F32))
    return np.stack(
        [ratio, ratio, ratio, np.ones_like(ratio)], axis=-1
    ).astype(F32)


def matcap_color(n, world_to_cam, matcap):
    """matCapColor (:388-413): rotate n into eye space by the normal matrix
    (w=0), renormalize, sample texel (int truncation) at
    (n.xy*0.5+0.5)*[W-1, H-1]. matcap is [Hm, Wm, 3|4] float in [0,1] in
    decoded-PNG row order (the packed-u32 texel / 255)."""
    ne = (n @ world_to_cam[:3, :3].T).astype(F32)
    ne = ne / np.linalg.norm(ne, axis=-1, keepdims=True).astype(F32)
    hm, wm = matcap.shape[:2]
    ix = ((ne[:, 0] * F32(0.5) + F32(0.5)) * F32(wm - 1)).astype(np.int32)
    iy = ((ne[:, 1] * F32(0.5) + F32(0.5)) * F32(hm - 1)).astype(np.int32)
    ix = np.clip(ix, 0, wm - 1)
    iy = np.clip(iy, 0, hm - 1)
    tex = np.asarray(matcap, F32)[iy, ix]
    if tex.shape[-1] == 3:
        tex = np.concatenate([tex, np.ones_like(tex[..., :1])], axis=-1)
    return tex.astype(F32)


def rgba_float_to_int(rgba):
    """rgbaFloatToInt (:266-274): saturate, scale 255, TRUNCATE, pack
    a<<24 | b<<16 | g<<8 | r."""
    c = (np.clip(rgba, 0.0, 1.0) * F32(255)).astype(np.uint32)
    return (c[..., 3] << 24) | (c[..., 2] << 16) | (c[..., 1] << 8) | c[..., 0]


# ------------------------------------------------------------- render ----

def render(
    params,
    width: int,
    height: int,
    *,
    rotation_x: float = 0.0,
    rotation_y: float = 0.0,
    translation=(0.0, 0.0, -2.0),
    scene: str = "neural_raw",
    shading: str = "facing",
    matcap=None,
    frame: float = 0.0,
    num_inputs: int = 3,
    max_steps: int = 6000,
    march_eps: float = float(MARCHING_EPSILON),
    focal: float = 2.0,
    bound_radius: float = 1.2,
    stride: int = 1,
    stride_offset: int = 0,
) -> np.ndarray:
    """Full-frame oracle render -> float32 rgba [H, W, 4], row 0 = bottom,
    non-hit pixels = 0 (BACKGROUND_COLOR, volumeRender_kernel.cu:57).

    Exact singleMarch per-step ordering (:459-476):
      1. d = sceneSDF(point)           (MLP on all still-active points)
      2. tfar -= d; tfar <= 0 -> miss  (the ray does NOT move)
      3. point += ray * d
      4. d < MARCHING_EPSILON -> converged (colored with the moved point)

    ``stride`` marches only every stride-th pixel of the FULL width x height
    grid (rows/cols 0, stride, 2*stride, ...) and returns the
    [ceil(H/stride), ceil(W/stride), 4] sub-image — the exact per-pixel
    counterpart of ``full_frame[::stride, ::stride]``. Used to anchor the
    oracle against the reference binary's committed 1024^2 golden renders
    at CI-affordable cost (benchmarks/golden_anchor.py).
    """
    scene_eval = make_scene_eval(scene, params, frame, num_inputs)
    cam_to_world, world_to_cam = view_matrices(rotation_x, rotation_y, translation)
    origin, dirs = generate_rays(cam_to_world, height, width, focal)
    if stride > 1:
        o = stride_offset
        dirs = dirs.reshape(height, width, 3)[o::stride, o::stride]
        height, width = dirs.shape[:2]
        dirs = dirs.reshape(-1, 3)

    tnear, tfar, bhit = intersect_sphere(origin, dirs, radius=bound_radius)
    tnear = np.maximum(tnear, F32(0))
    n = dirs.shape[0]
    points = (origin[None, :] + dirs * tnear[:, None]).astype(F32)
    budget = np.where(bhit, tfar, F32(0)).astype(F32)
    active = bhit.copy()
    converged = np.zeros(n, bool)
    eps = F32(march_eps)

    for _ in range(max_steps):
        idx = np.nonzero(active)[0]
        if idx.size == 0:
            break
        d = scene_eval(points[idx])
        b = budget[idx] - d
        budget[idx] = b
        miss = b <= F32(0)
        moved = ~miss
        mi = idx[moved]
        points[mi] = points[mi] + dirs[mi] * d[moved][:, None]
        conv_now = moved & (d < eps)
        converged[idx[conv_now]] = True
        active[idx] = moved & ~conv_now

    rgba = np.zeros((n, 4), F32)
    hit = np.nonzero(converged)[0]
    if hit.size:
        normals = tetrahedron_normals(scene_eval, points[hit])
        if shading == "facing":
            rgba[hit] = facing_color(normals, dirs[hit])
        elif shading == "matcap":
            if matcap is None:
                raise ValueError("matcap shading requires a texture")
            rgba[hit] = matcap_color(normals, world_to_cam, matcap)
        else:
            raise ValueError(f"unknown shading {shading!r}")
    return rgba.reshape(height, width, 4)
