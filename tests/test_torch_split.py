"""The march kernel's ray-split mode (a ray per warp) on the CPU.

``megakernel.ray_lanes`` picks, per launch, whether the kernel marches a
ray per thread or a ray per warp (the FP32 chain at widths 32 and 64 split
over the warp's lanes, csrc/march.cuh ``march_split_kernel``), from the
launch's lane count and the card's SM count alone. Both modes compute
``march_state_plain``'s function; on the card they equal each other bit for
bit (tests/test_torch_cuda.py). Here, without a card:
  * ``ray_lanes``: the split mode at a terminal rung's lane count, a ray
    per thread at the coarse call's and wherever the chain sums on the
    tensor cores, and the same answer for the same inputs;
  * the case the split mode is for, against the JAX package: a sorted
    2048-lane refine bucket in which only a few lanes are active, built
    from JAX's refine entry (csg_demo at 64x64 rays, coarse to eps 0.05,
    then 104 steps at 1e-6: the staged renderer's rungs (4, 16), (8, 24)
    and (32, 64)), marched to dry at eps 1e-6 and over-relaxation 1.6 by
    ``march_state_plain`` and by ``march_pallas_state`` in Pallas interpret
    mode, for csg_demo at 32, csg_demo widened to 64 and the 4-input
    anim_demo under many_sphere at frame 37. The bar is
    tests/test_torch_megakernel.py's (test_pallas.py:49-72): converged
    flags and active flags agree on >99% of lanes, t within 1e-4 where both
    converged, resolve steps equal on >=99%, equal step counters;
  * the ``_ray_lanes`` override raises on a value other than 1 or 32 and
    on 32 for a chain on the tensor cores, without loading the library,
    and the CPU march ignores the mode.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import chip_smoke  # noqa: E402
import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.kernels import build  # noqa: E402
from cudaneuralrender_torch.kernels import megakernel as mk_t  # noqa: E402
from cudaneuralrender_torch.ops import march as march_t  # noqa: E402
from cudaneuralrender_tpu.ops import camera as cam_j  # noqa: E402
from cudaneuralrender_tpu.ops import march as march_j  # noqa: E402
from cudaneuralrender_tpu.pallas import megakernel as mk_j  # noqa: E402

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples", "assets")
RES = 64
BUCKET = 2048
PRE_STEPS = 16 + 24 + 64  # the bounded refine rungs before the terminal one
SM_COUNT = 132  # an H100 SXM
# The staged renderer's launches at 1080p with csg_demo (a CPU run of the
# warm frame): the coarse call over every ray, the terminal rung's tuned
# bucket, and the smallest bucket a rung has (compact_min).
COARSE_N = 1920 * 1080
TERMINAL_N = 442368
COMPACT_MIN = ct.RenderConfig().compact_min


@pytest.mark.parametrize("hidden", [32, 64])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_ray_lanes_splits_small_launches(hidden, precision):
    for n in (1, COMPACT_MIN, TERMINAL_N):
        assert mk_t.ray_lanes(n, hidden, precision, SM_COUNT) == mk_t.SPLIT_LANES == 32, n


@pytest.mark.parametrize("hidden", [32, 64])
def test_ray_lanes_keeps_a_ray_per_thread_on_the_coarse_call(hidden):
    for precision in ("default", "highest"):
        assert mk_t.ray_lanes(COARSE_N, hidden, precision, SM_COUNT) == 1


@pytest.mark.parametrize("hidden,precision", [(128, "highest"), (256, "default"),
                                              (512, "highest"), (1024, "highest"),
                                              (32, "high"), (64, "high")])
def test_ray_lanes_keeps_a_ray_per_thread_on_tensor_core_chains(hidden, precision):
    assert mk_t.tensor_core_chain(hidden, precision)
    for n in (1, COMPACT_MIN, TERMINAL_N, COARSE_N):
        assert mk_t.ray_lanes(n, hidden, precision, SM_COUNT) == 1


def test_ray_lanes_depends_on_n_and_sm_count_alone():
    """The same (n, sm_count) gives the same mode, whatever came before;
    more SMs never take the split mode away from a launch."""
    ns = [1, 2048, 8192, TERMINAL_N, 491520, 598016, 1146880, COARSE_N, 1 << 24]
    for sm in (66, 114, 132):
        first = [mk_t.ray_lanes(n, 32, "highest", sm) for n in ns]
        assert [mk_t.ray_lanes(n, 32, "highest", sm) for n in reversed(ns)][::-1] == first
        for n, lanes in zip(ns, first):
            assert lanes in (1, 32)
            if lanes == 32:
                assert mk_t.ray_lanes(n, 32, "highest", 2 * sm) == 32
        # a smaller launch never marches a ray per thread where a larger splits
        assert first == sorted(first, reverse=True)


def _layers(asset, k):
    with np.load(os.path.join(ASSETS, asset + ".npz")) as data:
        layers = [(data[f"w{i}"], data[f"b{i}"]) for i in range(len(data.files) // 2)]
    return chip_smoke.widen(layers, k, seed=k) if k > 1 else layers


def _state_np(s):
    return {k: np.array(getattr(s, k)) for k in ("t", "budget", "active", "converged", "steps")}


# name -> (asset, widening factor, scene, frame)
BUCKETS = {
    "csg_demo_h32": ("csg_demo", 1, "neural_raw", 0.0),
    "csg_demo_x2_h64": ("csg_demo", 2, "neural_raw", 0.0),
    "anim_demo_many_sphere_f37": ("anim_demo", 1, "many_sphere", 37.0),
}


@pytest.mark.parametrize("case", list(BUCKETS))
def test_straggler_bucket_matches_jax(case):
    asset, k, scene, frame = BUCKETS[case]
    layers = _layers(asset, k)
    n_in = layers[0][0].shape[0]
    pj = tuple(cj.mlp.DenseParams(jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    pt = ct.from_numpy_params(layers, device="cpu")
    cfg_j = cj.RenderConfig(width=RES, height=RES, scene=scene, num_inputs=n_in)
    cfg_t = ct.RenderConfig(width=RES, height=RES, scene=scene, num_inputs=n_in)
    c2w, _ = cam_j.view_matrices(cj.Camera(rotation_y=30.0, rotation_x=-20.0))
    origin, dirs = (np.array(a) for a in cam_j.generate_rays(c2w, RES, RES, cfg_j.focal))

    def run_jax(s, d, eps, num_steps, omega, precision):
        state = march_j.MarchState(
            t=jnp.asarray(s["t"]), budget=jnp.asarray(s["budget"]),
            active=jnp.asarray(s["active"]), converged=jnp.asarray(s["converged"]),
            steps=jnp.asarray(s["steps"], jnp.int32))
        out, res = mk_j.march_pallas_state(
            pj, jnp.asarray(origin), jnp.asarray(d), state, cfg_j, frame, tile=d.shape[0],
            interpret=True, march_eps=eps, precision=precision, num_steps=num_steps,
            relax_omega=omega, return_resolve=True)
        return _state_np(out), np.asarray(res).astype(np.int64)

    # JAX's refine entry (test_torch_megakernel._refine_entry), marched
    # through the bounded rungs, then the actives sorted to the front.
    s = _state_np(march_j.init_state(jnp.asarray(origin), jnp.asarray(dirs),
                                     cfg_j.bound_center, cfg_j.bound_radius))
    s, _ = run_jax(s, dirs, 0.05, None, 1.6, jax.lax.Precision.DEFAULT)
    near = s["converged"] | s["active"]
    tnear, tfar, bhit = (np.asarray(a) for a in march_j.intersect_sphere(
        jnp.asarray(origin), jnp.asarray(dirs), cfg_j.bound_center, cfg_j.bound_radius))
    budget = np.where(bhit, tfar - (s["t"] - np.maximum(tnear, 0.0)), 0.0).astype(np.float32)
    s = dict(t=s["t"], budget=budget, active=near, converged=np.zeros_like(near),
             steps=s["steps"])
    s, _ = run_jax(s, dirs, 1e-6, PRE_STEPS, 0.0, jax.lax.Precision.HIGHEST)
    order = np.argsort(~s["active"], kind="stable")[:BUCKET]
    bucket = {key: (v if key == "steps" else v[order]) for key, v in s.items()}
    d = dirs[order]
    n_active = int(bucket["active"].sum())
    assert 0 < n_active <= BUCKET // 64, n_active  # a few stragglers
    assert bucket["active"][:n_active].all()  # sorted to the front

    sj, rj = run_jax(bucket, d, 1e-6, None, 1.6, jax.lax.Precision.HIGHEST)
    state = march_t.MarchState(
        t=torch.tensor(bucket["t"]), budget=torch.tensor(bucket["budget"]),
        active=torch.tensor(bucket["active"]), converged=torch.tensor(bucket["converged"]),
        steps=torch.tensor(int(bucket["steps"]), dtype=torch.int32))
    out, rt = mk_t.march_state_plain(pt, torch.tensor(origin), torch.tensor(d), state, cfg_t,
                                     frame, march_eps=1e-6, relax_omega=1.6,
                                     return_resolve=True)
    st, rt = _state_np(out), rt.numpy().astype(np.int64)

    assert int(sj["steps"]) > int(bucket["steps"])  # the stragglers marched
    assert (sj["converged"] == st["converged"]).mean() > 0.99
    both = sj["converged"] & st["converged"]
    assert both.sum() > 0
    np.testing.assert_allclose(st["t"][both], sj["t"][both], rtol=0, atol=1e-4)
    assert int(st["steps"]) == int(sj["steps"])
    assert (st["active"] == sj["active"]).mean() > 0.99
    assert (rt == rj).mean() >= 0.99, (rt != rj).sum()


def _cpu_call(layers, precision="highest"):
    pt = ct.from_numpy_params(layers, device="cpu")
    n_in = layers[0][0].shape[0]
    cfg = ct.RenderConfig(width=8, height=8, num_inputs=n_in)
    c2w, _ = cam_j.view_matrices(cj.Camera(rotation_y=30.0, rotation_x=-20.0))
    origin, dirs = (torch.from_numpy(np.array(a))
                    for a in cam_j.generate_rays(c2w, 8, 8, cfg.focal))
    state = march_t.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
    return pt, origin, dirs, state, cfg


@pytest.fixture
def no_library(monkeypatch):
    """Loading the kernels' library, or asking ``ray_lanes``, fails the test."""
    def fail(*_args, **_kw):
        raise AssertionError("the CPU path reached the kernel")

    monkeypatch.setattr(build, "load_library", fail)
    monkeypatch.setattr(mk_t, "ray_lanes", fail)


@pytest.mark.parametrize("value", [0, 2, 16, 31, 64, -1])
def test_ray_lanes_override_rejects_bad_values(no_library, value):
    pt, origin, dirs, state, cfg = _cpu_call(_layers("csg_demo", 1))
    with pytest.raises(ValueError, match="_ray_lanes must be 1 or 32"):
        mk_t.march_state(pt, origin, dirs, state, cfg, _ray_lanes=value)


@pytest.mark.parametrize("k,precision", [(4, "highest"), (1, "high"), (2, "high")],
                         ids=["h128_fp32", "h32_high", "h64_high"])
def test_ray_lanes_override_rejects_tensor_core_chains(no_library, k, precision):
    pt, origin, dirs, state, cfg = _cpu_call(_layers("csg_demo", k))
    with pytest.raises(ValueError, match="widths 32 and 64 only"):
        mk_t.march_state(pt, origin, dirs, state, cfg, precision=precision, _ray_lanes=32)
    # a ray per thread is every chain's mode
    mk_t.march_state(pt, origin, dirs, state, cfg, precision=precision, _ray_lanes=1)


def test_cpu_march_ignores_the_mode(no_library):
    """On CPU tensors the plain version runs in either mode, launches nothing
    and never asks ``ray_lanes``: the results are the plain version's."""
    pt, origin, dirs, state, cfg = _cpu_call(_layers("csg_demo", 1))
    launches = (mk_t.KERNEL_LAUNCHES, dict(mk_t.SPLIT_LAUNCHES))
    want = mk_t.march_state_plain(pt, origin, dirs, state, cfg, return_resolve=True)
    for lanes in (None, 1, 32):
        got = mk_t.march_state(pt, origin, dirs, state, cfg, return_resolve=True,
                               _ray_lanes=lanes)
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)
        assert torch.equal(got[1], want[1])
    assert (mk_t.KERNEL_LAUNCHES, mk_t.SPLIT_LAUNCHES) == launches
