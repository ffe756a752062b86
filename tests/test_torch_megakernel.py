"""The march kernel's plain version against the JAX package's megakernel.

On the CPU ``megakernel.march_state`` runs its plain PyTorch version; the
JAX side runs ``march_pallas_state`` in Pallas interpret mode, as the JAX
package's own tests do. Both get the same numpy inputs: csg_demo rays at
32x32 from Camera(rotation_y=30, rotation_x=-20), for the three calls the
staged renderer makes (the bar of tests/test_pallas.py:49-72):
  * coarse: eps 0.05, over-relaxation 1.6, resolve steps, run to dry;
  * refine rung 0: eps 1e-6, 16 steps, no relaxation, from the coarse
    output with the near set (converged or active) marked active;
  * terminal rung: eps 1e-6, over-relaxation 1.6, run to dry.
Tolerances: converged flags agree on >99% of rays and t within 1e-4 where
both converged (float32 chains in another summation order can flip a ray
sitting at the epsilon), resolve steps equal on >=99%, new step counters
identical.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.kernels import megakernel as mk_t  # noqa: E402
from cudaneuralrender_torch.ops import march as march_t  # noqa: E402
from cudaneuralrender_tpu.ops import camera as cam_j  # noqa: E402
from cudaneuralrender_tpu.ops import march as march_j  # noqa: E402
from cudaneuralrender_tpu.pallas import megakernel as mk_j  # noqa: E402

H5 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples", "assets",
                  "csg_demo.h5")
RES = 32
CFG_J = cj.RenderConfig(width=RES, height=RES)
CFG_T = ct.RenderConfig(width=RES, height=RES)

# name -> (march_eps, num_steps, relax_omega, return_resolve)
VARIANTS = {
    "coarse": (0.05, None, 1.6, True),
    "rung0": (1e-6, 16, 0.0, False),
    "terminal": (1e-6, None, 1.6, False),
}


def _state_np(s):
    return {k: np.array(getattr(s, k)) for k in ("t", "budget", "active", "converged", "steps")}


def _refine_entry(s, origin, dirs):
    """The refine phase's entry state: the near set re-marked active,
    converged cleared, the budget rebuilt from budget == tfar - (t - tnear)."""
    near = s["converged"] | s["active"]
    tnear, tfar, bhit = (np.asarray(a) for a in march_j.intersect_sphere(
        jnp.asarray(origin), jnp.asarray(dirs), CFG_J.bound_center, CFG_J.bound_radius))
    budget = np.where(bhit, tfar - (s["t"] - np.maximum(tnear, 0.0)), 0.0).astype(np.float32)
    return dict(t=s["t"], budget=budget, active=near, converged=np.zeros_like(near),
                steps=s["steps"])


def _run_jax(params, origin, dirs, s, variant):
    eps, num_steps, omega, resolve = VARIANTS[variant]
    state = march_j.MarchState(
        t=jnp.asarray(s["t"]), budget=jnp.asarray(s["budget"]),
        active=jnp.asarray(s["active"]), converged=jnp.asarray(s["converged"]),
        steps=jnp.asarray(s["steps"], jnp.int32))
    prec = jax.lax.Precision.DEFAULT if variant == "coarse" else jax.lax.Precision.HIGHEST
    out = mk_j.march_pallas_state(
        params, jnp.asarray(origin), jnp.asarray(dirs), state, CFG_J,
        tile=dirs.shape[0], interpret=True, march_eps=eps, precision=prec,
        num_steps=num_steps, relax_omega=omega, return_resolve=True)
    return _state_np(out[0]), np.asarray(out[1]).astype(np.int64)


def _run_torch(params, origin, dirs, s, variant):
    eps, num_steps, omega, _resolve = VARIANTS[variant]
    state = march_t.MarchState(
        t=torch.tensor(s["t"]), budget=torch.tensor(s["budget"]),
        active=torch.tensor(s["active"]), converged=torch.tensor(s["converged"]),
        steps=torch.tensor(int(s["steps"]), dtype=torch.int32))
    out, lane_steps = mk_t.march_state(
        params, torch.tensor(origin), torch.tensor(dirs), state, CFG_T,
        march_eps=eps, num_steps=num_steps, relax_omega=omega, return_resolve=True)
    return _state_np(out), lane_steps.numpy().astype(np.int64)


@pytest.fixture(scope="module")
def chain():
    """Inputs and both packages' outputs for the three variants, each
    variant starting from the JAX package's output of the one before."""
    pj, pt = cj.load(H5), ct.load(H5, device="cpu")
    c2w, _ = cam_j.view_matrices(cj.Camera(rotation_y=30.0, rotation_x=-20.0))
    origin, dirs = (np.array(a) for a in cam_j.generate_rays(c2w, RES, RES, CFG_J.focal))
    s = _state_np(march_j.init_state(jnp.asarray(origin), jnp.asarray(dirs),
                                     CFG_J.bound_center, CFG_J.bound_radius))
    launches0 = mk_t.KERNEL_LAUNCHES
    out = {}
    for variant in VARIANTS:
        if variant == "rung0":
            s = _refine_entry(s, origin, dirs)
        jx = _run_jax(pj, origin, dirs, s, variant)
        th = _run_torch(pt, origin, dirs, s, variant)
        out[variant] = (s, jx, th)
        s = jx[0]
    return out, mk_t.KERNEL_LAUNCHES - launches0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_march_state_plain_matches_jax_megakernel(chain, variant):
    out, _ = chain
    entry, (sj, rj), (st, rt) = out[variant]
    assert entry["active"].sum() > 50  # the variant has work to do
    conv_agree = (sj["converged"] == st["converged"]).mean()
    assert conv_agree > 0.99, conv_agree
    both = sj["converged"] & st["converged"]
    assert both.sum() > 0
    np.testing.assert_allclose(st["t"][both], sj["t"][both], rtol=0, atol=1e-4)
    assert int(st["steps"]) == int(sj["steps"])
    assert (st["active"] == sj["active"]).mean() > 0.99
    assert (rt == rj).mean() >= 0.99, (rt != rj).sum()


def test_no_kernel_launch_on_cpu(chain):
    _, launches = chain
    assert launches == 0


def test_march_state_rejects_wrong_device_type():
    pt = ct.load(H5, device="cpu")
    dirs = torch.zeros((4, 3), device="meta")
    state = march_t.MarchState(*(torch.zeros(4, device="meta") for _ in range(4)),
                               steps=torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="cpu or cuda"):
        mk_t.march_state(pt, torch.zeros(3, device="meta"), dirs, state, CFG_T)


def test_kernel_scene_support():
    """Every scene but the analytic test sphere marches in the kernel."""
    from cudaneuralrender_torch.kernels import scenes
    from cudaneuralrender_torch.utils.config import SCENE_NAMES

    assert {s for s in SCENE_NAMES if scenes.kernel_supported(s)} == SCENE_NAMES - {"sphere"}
    with pytest.raises(ValueError, match="does not support"):
        mk_t.march_state_plain(ct.load(H5, device="cpu"), torch.zeros(3), torch.zeros((1, 3)),
                               march_t.init_state(torch.zeros(3), torch.ones((1, 3)),
                                                  (0, 0, 0), 1.2),
                               CFG_T.replace(scene="sphere"))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc means no kernel, and an error: nothing falls back to the
    plain version. The library's name is keyed by the sources' hash."""
    from cudaneuralrender_torch.kernels import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
    assert build.library_path() == build.library_path()
    assert build.library_path().startswith(build.BUILD_DIR)
