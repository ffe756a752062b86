"""Staged-render parity for matcap shading and tetrahedron normals.

``render_staged`` of csg_demo at 64x64 from Camera(rotation_y=30,
rotation_x=-20), where every refine rung's bucket (2048 lanes) is smaller
than the image, against the JAX package's, at the mixed-path bar of
tests/test_render.py:85-101 (hit masks agree on >= 99%, >= 97% of common
hits within 1e-3 in rgba), with matching fast-path stats:
  * ``shading="matcap"`` with the in-repo texture
    benchmarks/recovered_matcaps/plane_1.png (128x128 RGB);
  * ``normal_mode="tetrahedron"`` (the reference's 4-tap normals) under
    facing shading, and under matcap shading, at ``normal_eps`` 1e-3.

At the reference's ``normal_eps`` 1e-5 the 4-tap difference cancels all but
a few bits of four float32 SDF values near 1e-5: both packages' normals lie
2.2-2.7e-3 (mean) from the same formula in float64 on this render's surface
points, 9% of them within 1e-3 of each other, so no shared bar in rgba
holds there (tests/test_torch_ops.py holds the op at 1e-2 for the same
reason). The error scales as 1/normal_eps, and at 1e-3 the two packages
meet the mixed-path bar. At 1e-5 this package's normals are held
against the float64 witness instead: mean and largest error within
TET_WITNESS_MEAN and TET_WITNESS_MAX times the JAX package's (the test
prints both packages' errors: ``-s``).
"""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.kernels import megakernel as mk_t  # noqa: E402
from cudaneuralrender_torch.utils import image_io as io_t  # noqa: E402
from cudaneuralrender_tpu.utils import image_io as io_j  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H5 = os.path.join(REPO, "examples", "assets", "csg_demo.h5")
MATCAP = os.path.join(REPO, "benchmarks", "recovered_matcaps", "plane_1.png")
# The port's coarse phase (utils/config.py, set from the H100's chain
# errors), given to both packages: the JAX package's default is the TPU's.
LADDER = dict(coarse_precision=ct.RenderConfig.coarse_precision,
              coarse_eps=ct.RenderConfig.coarse_eps)
CAM = dict(rotation_y=30.0, rotation_x=-20.0)
TET_EPS = 1e-3
TET_WITNESS_MEAN = 1.5
TET_WITNESS_MAX = 2.0


@pytest.fixture(scope="module")
def params():
    return cj.load(H5), ct.load(H5, device="cpu")


CASES = {
    "matcap": dict(shading="matcap"),
    "tetrahedron": dict(normal_mode="tetrahedron", normal_eps=TET_EPS),
    "matcap_tetrahedron": dict(shading="matcap", normal_mode="tetrahedron",
                               normal_eps=TET_EPS),
}


@pytest.mark.parametrize("case", list(CASES))
def test_staged_shading_matches_jax(params, case):
    import jax.numpy as jnp

    pj, pt = params
    kw = dict(width=64, height=64, march_impl="staged", rgba_packed=False, **LADDER,
              **CASES[case])
    matcap_j = matcap_t = None
    if kw.get("shading") == "matcap":
        m_j, m_t = io_j.load_matcap(MATCAP), io_t.load_matcap(MATCAP)
        np.testing.assert_array_equal(m_t, np.asarray(m_j))
        matcap_j, matcap_t = jnp.asarray(m_j), torch.as_tensor(m_t)
    cj.reset_schedule_memo()
    ct.reset_schedule_memo()
    stats_j, stats_t = {}, {}
    a = np.asarray(cj.render_staged(pj, cj.Camera(**CAM), cj.RenderConfig(**kw), matcap_j,
                                    stats_out=stats_j))
    launches = mk_t.KERNEL_LAUNCHES
    b = ct.render_staged(pt, ct.Camera(**CAM), ct.RenderConfig(**kw), matcap_t,
                         stats_out=stats_t).numpy()
    assert mk_t.KERNEL_LAUNCHES == launches  # CPU tensors never reach the kernel
    assert b.shape == (64, 64, 4) and np.isfinite(b).all()
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.99
    both = hit_a & hit_b
    assert both.sum() > 50
    close = np.all(np.abs(b[both] - a[both]) < 1e-3, axis=-1).mean()
    assert close >= 0.97, close
    assert stats_t["fast_path"] == stats_j["fast_path"]
    assert abs(stats_t["hits"] - stats_j["hits"]) <= 0.01 * stats_j["hits"]
    if kw.get("shading") == "matcap":
        # the texture reaches the image: colours other than facing grey
        rgb = b[hit_b][:, :3]
        assert (np.ptp(rgb, axis=-1) > 1e-3).mean() > 0.5


def test_tetrahedron_normals_float64_witness(params):
    """At the reference's normal_eps (1e-5), on the surface points of the
    64x64 render: this package's 4-tap normals are as close to the same
    formula in float64 as the JAX package's (the module docstring says
    why no shared bar holds there)."""
    import jax.numpy as jnp

    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera, shading
    from cudaneuralrender_torch.render import renderer
    from cudaneuralrender_tpu.ops import shading as shading_j
    from cudaneuralrender_tpu.render import renderer as renderer_j

    pj, pt = params
    eps = ct.RenderConfig().normal_eps
    cfg = ct.RenderConfig(width=64, height=64)
    c2w, _ = camera.view_matrices(ct.Camera(**CAM))
    origin, dirs = camera.generate_rays(c2w, 64, 64)
    t, hit = megakernel.march(pt, origin, dirs, cfg)
    pts = (origin + dirs * t[:, None])[hit]
    assert pts.shape[0] > 500
    n_t = shading.tetrahedron_normals(renderer.shade_fn(pt, cfg, 0.0), pts, eps).numpy()
    n_j = np.asarray(shading_j.tetrahedron_normals(
        renderer_j.shade_fn(pj, cj.RenderConfig(), 0.0), jnp.asarray(pts.numpy()), eps))
    p64 = ct.from_numpy_params(ct.mlp.to_numpy_params(pt), device="cpu", dtype=torch.float64)
    verts = torch.from_numpy(shading.TETRAHEDRON_VERTS).double()
    taps = pts.double()[:, None, :] + verts[None] * eps
    d = ct.mlp.apply_scalar(p64, taps.reshape(-1, 3)).reshape(-1, 4) @ verts
    n64 = (d / d.norm(dim=-1, keepdim=True)).numpy()
    err_t, err_j = np.abs(n_t - n64).max(-1), np.abs(n_j - n64).max(-1)
    share = (np.abs(n_t - n_j).max(-1) < 1e-3).mean()
    print(f"tetrahedron normals at normal_eps {eps}, {pts.shape[0]} points: |n - float64| "
          f"mean / max {err_t.mean():.3g} / {err_t.max():.3g} (JAX {err_j.mean():.3g} / "
          f"{err_j.max():.3g}); within 1e-3 of JAX's on {share:.4f}")
    assert err_t.mean() <= TET_WITNESS_MEAN * err_j.mean(), (err_t.mean(), err_j.mean())
    assert err_t.max() <= TET_WITNESS_MAX * err_j.max(), (err_t.max(), err_j.max())
