"""The march kernel's ray-split mode (a ray per warp) on the CPU.

``megakernel.ray_lanes`` picks, per launch, whether the kernel marches a
ray per thread (the FP32 chain on the tensor cores over a warp's rays) or
a ray per warp (at widths 32 and 64 the FFMA chain split over the warp's
lanes, csrc/march.cuh ``march_split_kernel``), from the call's steps and
whether it is a frame's coarse call. Both
modes compute ``march_state_plain``'s function; on the card a ray per warp
equals it bit for bit, a ray per thread within the tensor-core bar
(tests/test_torch_cuda.py). Here, without a card:
  * ``ray_lanes``: the split mode on the ladder's later rungs (at least
    SPLIT_MIN_STEPS steps, or run to dry), a ray per thread on its first
    rungs and on every call marked ``coarse`` (the
    staged renderer marks its coarse call so, whatever the image's size)
    and wherever the chain has no split mode (``split_chain``: the
    three-pass chain, widths from 128), and the same answer for the same
    inputs; the stack each mode's launch reads (``_kernel_weights``): tf32
    fragment order a ray per thread, the FP32 stack a ray per warp;
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
    on 32 for a chain without a split mode, without loading the library,
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
# The staged renderer's refine rungs (ct.RenderConfig().refine_schedule):
# the steps of each call, None for the terminal rung run to dry.
RUNG_STEPS = tuple(steps or None for _, steps in ct.RenderConfig().refine_schedule)


@pytest.mark.parametrize("hidden", [32, 64])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_ray_lanes_splits_small_launches(hidden, precision):
    """The ladder's later rungs, whose buckets are the small launches with
    a few stragglers active: the (32, 64) rung and the terminal rung run to
    dry march a ray per warp; so does any bounded call of SPLIT_MIN_STEPS
    steps or more."""
    assert RUNG_STEPS == (16, 24, 64, None)
    for num_steps in (64, None, mk_t.SPLIT_MIN_STEPS, 10 * mk_t.SPLIT_MIN_STEPS):
        assert mk_t.ray_lanes(hidden, precision, num_steps) == mk_t.SPLIT_LANES == 32, num_steps


@pytest.mark.parametrize("hidden", [32, 64])
def test_ray_lanes_keeps_a_ray_per_thread_on_the_coarse_call(hidden):
    """The coarse call and the ladder's first rungs (16 and 24 steps, a
    third to three quarters of their lanes active) march a ray per thread."""
    for precision in ("default", "highest"):
        assert mk_t.ray_lanes(hidden, precision, None, coarse=True) == 1
        for num_steps in (1, 16, 24, mk_t.SPLIT_MIN_STEPS - 1):
            assert mk_t.ray_lanes(hidden, precision, num_steps) == 1


@pytest.mark.parametrize("hidden", [32, 64])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_ray_lanes_never_splits_a_coarse_call(hidden, precision):
    """A call marked ``coarse`` marches a ray per thread whatever it is run
    for, the small images' coarse calls included (a bound on the lane count
    sent 256x256's a ray per warp, 1.5x slower)."""
    for num_steps in (None, 1, 16, 64, 1000):
        assert mk_t.ray_lanes(hidden, precision, num_steps, coarse=True) == 1


@pytest.mark.parametrize("hidden", [32, 64])
def test_ray_lanes_splits_refine_calls_run_to_dry(hidden):
    """A refine call run to dry (the terminal rung: a few stragglers for
    hundreds of steps) marches a ray per warp, whatever its lane count
    (a bound on the lane count kept many_sphere f90's 720896-lane bucket a
    ray per thread, 7.7x slower); not the three-pass chain, nor a coarse
    call."""
    assert mk_t.ray_lanes(hidden, "highest", None) == mk_t.SPLIT_LANES
    assert mk_t.ray_lanes(hidden, "high", None) == 1
    assert mk_t.ray_lanes(hidden, "highest", None, coarse=True) == 1


@pytest.mark.parametrize("hidden,precision", [(128, "highest"), (256, "default"),
                                              (512, "highest"), (1024, "highest"),
                                              (32, "high"), (64, "high")])
def test_ray_lanes_keeps_a_ray_per_thread_on_tensor_core_chains(hidden, precision):
    """Chains without a split mode march a ray per thread at every lane
    count; they sum on the tensor cores in either mode's accounting."""
    assert not mk_t.split_chain(hidden, precision)
    assert mk_t.tensor_core_chain(hidden, precision)
    assert mk_t.tensor_core_chain(hidden, precision, mk_t.SPLIT_LANES)
    for num_steps in RUNG_STEPS:
        assert mk_t.ray_lanes(hidden, precision, num_steps) == 1


@pytest.mark.parametrize("hidden", [32, 64])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_fp32_chain_at_32_and_64_sums_on_the_tensor_cores_a_ray_per_thread(hidden, precision):
    """The FP32 chain at 32 and 64: 3xTF32 a ray per thread, the FFMA chain
    in the plain version's order a ray per warp."""
    assert mk_t.split_chain(hidden, precision)
    assert mk_t.tensor_core_chain(hidden, precision)
    assert not mk_t.tensor_core_chain(hidden, precision, mk_t.SPLIT_LANES)


def test_staged_coarse_call_never_splits():
    """The staged renderer marks its coarse call ``coarse`` and no other:
    at 64x64 (4096 lanes, a small launch) ``ray_lanes`` picks a ray
    per thread for it, and for the refine rungs by their steps (RUNG_STEPS):
    the first two a ray per thread, the later ones a ray per warp. With the
    FP32 coarse call (``coarse_precision="default"``) the mark is what keeps
    it a ray per thread; the default coarse call runs the three-pass chain,
    which has no ray-split mode."""
    pt = ct.from_numpy_params(_layers("csg_demo", 1), device="cpu")
    for ladder in (dict(coarse_precision="default", coarse_eps=0.05), {}):
        cfg = ct.RenderConfig(width=64, height=64, march_impl="staged", **ladder)
        calls = []
        real = mk_t.march_state

        def recording(params, origin, dirs, state, config, frame=0.0, **kw):
            calls.append((dirs.shape[0], kw))
            return real(params, origin, dirs, state, config, frame, **kw)

        mk_t.march_state = recording
        try:
            ct.render_staged(pt, ct.Camera(rotation_y=30.0, rotation_x=-20.0), cfg)
        finally:
            mk_t.march_state = real
        assert len(calls) > 1
        (n0, kw0), rest = calls[0], calls[1:]
        assert kw0.get("coarse") is True and n0 == cfg.num_rays
        assert kw0["precision"] == cfg.coarse_precision
        assert not any(kw.get("coarse", False) for _, kw in rest)
        assert [kw.get("num_steps") for _, kw in rest] == list(RUNG_STEPS)
        pick = [mk_t.ray_lanes(32, kw.get("precision", "highest"), kw.get("num_steps"),
                               kw.get("coarse", False)) for _, kw in calls]
        unmarked = mk_t.ray_lanes(32, kw0["precision"], kw0.get("num_steps"))
        assert pick[0] == 1 and unmarked == (1 if cfg.coarse_precision == "high" else 32)
        assert pick[1:] == [1, 1, mk_t.SPLIT_LANES, mk_t.SPLIT_LANES]


@pytest.mark.parametrize("k", [1, 2], ids=["h32", "h64"])
@pytest.mark.parametrize("lanes", [1, 32], ids=["thread", "warp"])
def test_kernel_weights_by_mode(k, lanes):
    """The stack ``_kernel_weights`` hands a launch: a ray per thread the
    FP32 values in tf32 fragment order (``pack_mma(..., "tf32")``), a ray per
    warp the FP32 stack [L, H, H]; at "high" the bfloat16 halves in either
    accounting; the biases [L, H] in every case."""
    from cudaneuralrender_torch.kernels import fused_mlp

    pt = ct.from_numpy_params(_layers("csg_demo", k), device="cpu")
    cfg = ct.RenderConfig()
    weights, biases, _, h = fused_mlp.packed_params(pt)
    assert h == 32 * k
    dev = torch.device("cpu")
    for precision in ("default", "highest"):
        w, b, n_layers, hidden = mk_t._kernel_weights(pt, cfg, precision, dev, lanes)
        assert (n_layers, hidden) == (len(pt), h) and torch.equal(b, biases)
        if lanes == 1:
            assert w.shape == (n_layers, h // 8, h // 8, 32, 2)
            assert torch.equal(w, fused_mlp.pack_mma(weights, "tf32"))
        else:
            assert torch.equal(w, weights)
    w, _, _, _ = mk_t._kernel_weights(pt, cfg, "high", dev, lanes)
    assert w.dtype == torch.bfloat16 and w.shape == (len(pt), h // 16, h // 8, 32, 8)


def test_ray_lanes_depends_on_n_and_sm_count_alone():
    """The same call gives the same mode, whatever came before. Neither the
    lane count nor the SM count enters any more (``ray_lanes`` takes
    neither): the call's steps and coarse flag stand in for its active
    share, and a longer bounded call never marches a ray per thread where a
    shorter one splits."""
    steps = [1, 8, 16, 24, 32, 63, 64, 65, 128, 1000]
    first = [mk_t.ray_lanes(32, "highest", k) for k in steps]
    assert [mk_t.ray_lanes(32, "highest", k) for k in reversed(steps)][::-1] == first
    assert set(first) == {1, 32} and first == sorted(first)
    assert mk_t.ray_lanes(32, "highest", None) == 32


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
    """32 lanes a ray only where the chain has a split mode: not the FP32
    chain from 128 nor the three-pass chain, which march a ray per thread
    on the tensor cores."""
    assert not mk_t.split_chain(32 * k, precision)
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
