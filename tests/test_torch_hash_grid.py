"""The hash-grid SDF (``models/hash_grid.py``) on the CPU, and its kernels on
the card.

On the CPU: the corners' indices against the equations in Python integers;
the plain encoding against the benchmark's plain reference
(``portbench/reference/hash_grid.py``) bit for bit; ``render_staged`` and
``render_sequence`` against the reference's frames under the cell's own
readings and limits (``portbench/check.py``), and a program whose finest
level is zeroed failing them; the benchmark kind's weights (deterministic,
the gradient's norm near the surface); the dense chain's frames and
counters; the paths a ``HashGridSDF`` does not take, each a ValueError that
names what is missing.

On the card (marked ``cuda``, skipped without one): the march kernel's three
modes against the plain march (the ray-per-warp rung bit for bit), and the
encoding kernel's features and gradient against the plain encoding and
autograd of the reference. Run them there with

    python -m pytest tests/test_torch_hash_grid.py -m cuda
"""
import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import cudaneuralrender_torch as cnr  # noqa: E402
from cudaneuralrender_torch.kernels import megakernel  # noqa: E402
from cudaneuralrender_torch.models import hash_grid  # noqa: E402
from cudaneuralrender_torch.ops import camera as camera_lib  # noqa: E402
from cudaneuralrender_torch.ops import march as march_lib  # noqa: E402
from cudaneuralrender_torch.utils import trace  # noqa: E402
from portbench import check, spec  # noqa: E402
from portbench.metrics.gather_roofline import L2_BYTES_PER_S  # noqa: E402
from portbench.mixes.pipelined import Driver  # noqa: E402
from portbench.models import dense_relu  # noqa: E402
from portbench.models import hash_grid as kind  # noqa: E402
from portbench.reference import hash_grid as ref  # noqa: E402
from portbench.reference import render as ref_render  # noqa: E402

CELL = "hashgrid_sdf.turntable_1080p"
SEED = 2**31 + 77
#: Poses of the small frames (rotation_x, rotation_y).
POSES = [(-15.0, 30.0), (30.0, 200.0)]
W, H = 32, 18


def _config(name="hashgrid_sdf"):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def weights():
    return kind.make(_config(), spec.ROOT, SEED)


@pytest.fixture(scope="module")
def net(weights):
    return kind.reference_net(weights, "cpu")


def _render_config(cfg, **kw):
    tr = dict(scene="neural_raw", width=W, height=H)
    return cnr.RenderConfig(**check.render_fields(cfg, tr), width=W, height=H,
                            scene="neural_raw", **kw).validate()


# --- (a) the corners' indices -------------------------------------------------

def _face_positions(scale: np.float32) -> np.ndarray:
    """Unit positions whose u = s * x + 0.5 (float32) is a whole number:
    corners on cell faces."""
    out = []
    for k in (1, 2, 5):
        x = np.float32((k - 0.5) / float(scale))
        for _ in range(64):
            u = np.float32(np.float32(x * scale) + np.float32(0.5))
            if u == np.floor(u):
                out.append(x)
                break
            x = np.nextafter(x, np.float32(1.0))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("level", [0, 4, 5, 15])
def test_corner_indices_follow_the_equations(level):
    """Each corner's index in Python integers from the equations: 1:1
    (g_x + g_y R + g_z R^2) mod 2^32 mod T where R^3 <= 2^19, else the prime
    hash mod 2^32 mod T; at seeded points, on cell faces, at x = 0 and 1."""
    cfg = _config()
    lv = hash_grid.level_table(cfg["n_levels"], cfg["base_resolution"],
                               kind.per_level_scale(cfg), cfg["log2_hashmap_size"])[level]
    assert lv["hashed"] == (level >= 5)
    edge = np.array([0.0, 1.0], np.float32)
    coords = np.concatenate([edge, _face_positions(lv["scale"]),
                             np.random.default_rng(level).uniform(0, 1, 8).astype(np.float32)])
    grid = np.stack(np.meshgrid(coords, coords[::-1], coords[1:], indexing="ij"), -1).reshape(-1, 3)
    u = (grid * lv["scale"]).astype(np.float32) + np.float32(0.5)
    g = np.floor(u).astype(np.int64)
    assert (u[:, 0] == g[:, 0]).any()  # some corners lie on a cell face
    r, size = lv["res"], lv["size"]
    for c in range(8):
        corner = g + np.array([(c >> a) & 1 for a in range(3)])
        want = []
        for gx, gy, gz in corner.tolist():
            if lv["hashed"]:
                want.append(((gx * 1) ^ (gy * 2654435761) ^ (gz * 805459861)) % 2**32 % size)
            else:
                want.append((gx + gy * r + gz * r * r) % 2**32 % size)
        got = hash_grid.corner_index(torch.from_numpy(corner), lv)
        assert got.tolist() == want


def test_level_table_is_the_published_one():
    """16 levels: scales 16 b^l - 1 (b = 1.3819...), levels 0-4 1:1, the
    table 6,098,120 entries (48.8 MB of float32 pairs)."""
    cfg = _config()
    lvs = hash_grid.level_table(cfg["n_levels"], cfg["base_resolution"],
                                kind.per_level_scale(cfg), cfg["log2_hashmap_size"])
    assert [lv["res"] for lv in lvs[:5]] == [16, 23, 31, 43, 59]
    assert [lv["hashed"] for lv in lvs] == [False] * 5 + [True] * 11
    assert lvs[-1]["scale"] == np.float32(2047.0)
    assert lvs[-1]["first"] + lvs[-1]["size"] == 6098120
    assert abs(kind.per_level_scale(cfg) - 1.3819) < 1e-4  # the published b (N_max 2048)


# --- (b) the plain encoding against the reference ------------------------------

SMALL = dict(n_levels=4, base_resolution=4, per_level_scale=2.0, log2_hashmap_size=10, span=2.4)


def _small_arrays(seed=3):
    rng = np.random.default_rng(seed)
    lvs = ref.levels(4, 4, 2.0, 10)
    n = lvs[-1]["first"] + lvs[-1]["size"]
    sizes = [8, 64, 64, 1]
    layers = [(rng.normal(0, 0.3, (a, b)).astype(np.float32), rng.normal(0, 0.1, b).astype(np.float32))
              for a, b in zip(sizes[:-1], sizes[1:])]
    return dict(SMALL, table=rng.normal(0, 1, (n, 2)).astype(np.float32), layers=layers)


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_encoding_is_the_references_bit_for_bit(seed):
    """4 levels, T = 2^10, base 4: 2 levels 1:1 and 2 hashed. The features
    and the SDF equal the reference's bit for bit, inside the bound and out
    of it (corners below 0 wrap as uint32)."""
    arrays = _small_arrays(seed)
    model = cnr.from_numpy_hash_grid(arrays, device="cpu")
    net = ref.HashGridNet(arrays, "cpu")
    assert [lv["hashed"] for lv in model.levels] == [False, False, True, True]
    p = np.random.default_rng(seed).uniform(-1.3, 1.3, (4096, 3)).astype(np.float32)
    p = torch.from_numpy(p)
    assert torch.equal(model.features(p), net.features(p))
    assert torch.equal(model(p), net(p))


# --- (c), (e) frames against the reference --------------------------------------

def _readings(params, net, cfg, pose, sequence=False):
    rcfg = _render_config(cfg)
    cam = cnr.Camera(rotation_x=pose[0], rotation_y=pose[1])
    if sequence:
        img = cnr.render_sequence(params, [cam], rcfg, chunk=8)[0]
    else:
        img = cnr.render_staged(params, cam, rcfg)
    tr = dict(scene="neural_raw", width=W, height=H)
    out = check.reference_frame(net, dict(rotation_x=pose[0], rotation_y=pose[1], frame=0.0),
                                cfg, tr, "cpu")
    return check.frame_readings(Driver.to_bytes(img), out["grey"], out["alpha"])


def _limits():
    return spec.cell(CELL)["workload"]["limits"]


@pytest.mark.parametrize("sequence", [False, True])
@pytest.mark.parametrize("pose", POSES)
def test_frames_agree_with_the_reference(weights, net, pose, sequence):
    """``render_staged`` and ``render_sequence`` (the staged ladder, its
    marches the kernels' plain versions here) at 32 x 18, on the kind's
    weights, within the cell's limits of the check's readings."""
    got = _readings(kind.program(cnr, weights, "cpu"), net, _config(), pose, sequence)
    assert all(got[k] <= v for k, v in _limits().items()), got


def test_a_program_without_its_finest_level_fails(weights, net):
    """The program's table with level 15 zeroed: the check's readings go over
    the cell's limits, so the finest level's gathers are seen."""
    broken = copy.deepcopy(weights)
    lv = kind._levels(_config())[15]
    broken["table"][lv["first"]:lv["first"] + lv["size"]] = 0.0
    params = kind.program(cnr, broken, "cpu")
    got = [_readings(params, net, _config(), pose) for pose in POSES]
    assert any(r[k] > v for r in got for k, v in _limits().items()), got


# --- (d) the kind's weights ------------------------------------------------------

def _turntable_hits(net, seed, rays=1024):
    """Surface points the cell's frames shade: seeded pixels of the
    turntable's five elevations at seeded yaws, plainly sphere-traced."""
    rng = np.random.default_rng(seed)
    origins, dirs = [], []
    for pitch in (-30.0, -15.0, 0.0, 15.0, 30.0):
        cam = ref_render.view_matrices(pitch, float(rng.uniform(0.0, 360.0)))
        pix = torch.as_tensor(rng.choice(1920 * 1080, rays, replace=False))
        dirs.append(ref_render.ray_dirs(cam, pix, 1080, 1920, 2.0))
        origins.append(cam[:, 3].expand(rays, 3))
    o, d = torch.cat(origins), torch.cat(dirs)
    b = 2.0 * (d * o).sum(1)
    c = (o * o).sum(1) - 1.44
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.clamp((-b - sq) / 2.0, min=0.0)
    far = (-b + sq) / 2.0
    live, hit = disc > 0.0, torch.zeros_like(disc, dtype=torch.bool)
    with torch.no_grad():
        for _ in range(400):
            idx = live.nonzero().squeeze(1)
            if not idx.numel():
                break
            s = net(o[idx] + d[idx] * t[idx, None])
            t[idx] += s
            now = s < 1e-6
            hit[idx[now]] = True
            live[idx[now | (t[idx] > far[idx])]] = False
    return (o + d * t[:, None])[hit]


def test_the_kind_is_deterministic_and_its_surface_traceable(weights):
    """The same seed gives the same arrays; near the surface the cell's
    frames shade, |grad SDF| is at most 1.2 on 99% of points (sphere
    tracing stays valid) and in [0.8, 1.2] on 96% (the dense levels'
    interpolation smooths csg_demo's creases below 0.8: 97.0-99.2% over
    five samples, PERF.md section 4)."""
    again = kind.make(_config(), spec.ROOT, SEED)
    assert again["table"].tobytes() == weights["table"].tobytes()
    for (w0, b0), (w1, b1) in zip(again["layers"], weights["layers"]):
        assert w0.tobytes() == w1.tobytes() and b0.tobytes() == b1.tobytes()
    other = kind.make(_config(), spec.ROOT, SEED + 1)
    assert other["table"].tobytes() != weights["table"].tobytes()
    net = kind.reference_net(weights, "cpu")
    pts = _turntable_hits(net, 1).requires_grad_(True)
    (g,) = torch.autograd.grad(net(pts).sum(), pts)
    norm = g.norm(dim=1)
    assert pts.shape[0] > 1500
    assert float((norm <= 1.2).float().mean()) >= 0.99
    assert float(((norm >= 0.8) & (norm <= 1.2)).float().mean()) >= 0.96


def test_the_kind_counts_its_work():
    cfg = _config()
    assert kind.flops_per_eval(cfg) == 12928  # 1024 B gathered at L2's rate, in HBM bytes:
    assert kind.bytes_per_eval(cfg) == pytest.approx(1024 * 3.35e12 / L2_BYTES_PER_S)


# --- (f) the dense chain ----------------------------------------------------------

@pytest.mark.parametrize("precision", ["mixed", "full"])
def test_the_dense_chain_is_unchanged(precision):
    """csg_demo's frames at 32 x 18 within its cell's limits of the
    reference's, and its march calls count no table gathers."""
    cfg = _config("csg_demo")
    layers = dense_relu.make(cfg, spec.ROOT, 1)
    params, net = dense_relu.program(cnr, layers, "cpu"), dense_relu.reference_net(layers, "cpu")
    limits = spec.cell("csg_demo.turntable_1080p")["workload"]["limits"]
    rcfg = _render_config(cfg, march_precision=precision)
    tr = dict(scene="neural_raw", width=W, height=H)
    for pose in POSES:
        img = cnr.render_staged(params, cnr.Camera(rotation_x=pose[0], rotation_y=pose[1]), rcfg)
        out = check.reference_frame(net, dict(rotation_x=pose[0], rotation_y=pose[1], frame=0.0),
                                    cfg, tr, "cpu")
        got = check.frame_readings(Driver.to_bytes(img), out["grey"], out["alpha"])
        assert all(got[k] <= v for k, v in limits.items()), got
    assert params.gathers_per_eval == 0 and params.grid() is None
    assert cnr.kernels.fused_mlp.value_grad_served(params, 3) is False  # a CPU net


def test_march_counters(weights):
    """A march call counts ``gathers`` = useful x 128 for the hash grid and
    none for the dense chain."""
    cfg = _config()
    rcfg = _render_config(cfg)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(rotation_x=10.0, rotation_y=40.0), "cpu")
    o, d = camera_lib.generate_rays(c2w, H, W, 2.0)
    st = march_lib.init_state(o, d, rcfg.bound_center, rcfg.bound_radius)
    dense = dense_relu.program(cnr, dense_relu.make(_config("csg_demo"), spec.ROOT, 1), "cpu")
    trace.enable()
    try:
        got = {}
        for name, params in (("hash", kind.program(cnr, weights, "cpu")), ("dense", dense)):
            trace.reset()
            megakernel.march_state(params, o, d, st, rcfg, march_eps=3e-3, precision="high",
                                   coarse=True)
            got[name] = trace.snapshot()["counters"]
    finally:
        trace.disable()
    assert got["hash"]["march.gathers"] == 128 * got["hash"]["march.useful"] > 0
    assert "march.gathers" not in got["dense"] and got["dense"]["march.useful"] > 0


# --- the paths a HashGridSDF does not take ------------------------------------------

def _small_model():
    return cnr.from_numpy_hash_grid(_small_arrays(), device="cpu")


@pytest.mark.parametrize("case, match", [
    ("many_sphere", "neural_raw scene only"),
    ("use_pallas", "no fused forward kernel"),
    ("width32", "width 64 only"),
    ("training", "training takes a dense ReLU chain"),
    ("solve", "surface solve takes a dense ReLU chain"),
    ("diff_render", "differentiable rendering takes a dense ReLU chain"),
])
def test_paths_it_does_not_take_raise(case, match):
    cam = cnr.Camera(rotation_x=0.0, rotation_y=0.0)
    cfg = cnr.RenderConfig(width=8, height=8).validate()
    with pytest.raises(ValueError, match=match):
        if case == "many_sphere":
            cnr.render_staged(_small_model(), cam, cfg.replace(scene="many_sphere"))
        elif case == "use_pallas":
            cnr.render_staged(_small_model(), cam, cfg.replace(use_pallas=True))
        elif case == "width32":
            arrays = _small_arrays()
            rng = np.random.default_rng(0)
            arrays["layers"] = [(rng.normal(0, 0.3, (8, 32)).astype(np.float32),
                                 np.zeros(32, np.float32)),
                                (rng.normal(0, 0.3, (32, 1)).astype(np.float32),
                                 np.zeros(1, np.float32))]
            cnr.from_numpy_hash_grid(arrays, device="cpu")
        elif case == "training":
            cnr.diff.init_train_state(_small_model())
        elif case == "solve":
            cnr.diff.solve_surface(_small_model(), cam, cfg)
        else:
            cnr.diff.render_image_diff(_small_model(), cam, cfg)


def test_the_value_grad_kernel_does_not_serve_it():
    assert cnr.kernels.fused_mlp.value_grad_served(_small_model(), 3) is False


# --- (g) on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def card_rays():
    """A 64 x 64 frame of the cell's configuration on the card, its rays
    and the march's start."""
    dev = _card()
    arrays = kind.make(_config(), spec.ROOT, SEED)
    model = kind.program(cnr, arrays, dev)
    rcfg = cnr.RenderConfig(**check.render_fields(_config(), {}), width=64, height=64,
                            scene="neural_raw").validate()
    c2w, _ = camera_lib.view_matrices(cnr.Camera(rotation_x=-15.0, rotation_y=30.0), dev)
    o, d = camera_lib.generate_rays(c2w, 64, 64, 2.0)
    st = march_lib.init_state(o, d, rcfg.bound_center, rcfg.bound_radius)
    return dict(dev=dev, arrays=arrays, model=model, rcfg=rcfg, o=o, d=d, st=st)


def _march(r, precision, eps, lanes, plain, num_steps=None, start=None):
    fn = megakernel.march_state_plain if plain else megakernel.march_state
    kw = {} if plain else dict(_ray_lanes=lanes)
    st = r["st"] if start is None else start
    return fn(r["model"], r["o"], r["d"], st, r["rcfg"], march_eps=eps, precision=precision,
              num_steps=num_steps, return_resolve=True, **kw)


@pytest.mark.cuda
def test_card_split_rung_is_the_plain_march_bit_for_bit(card_rays):
    """A ray per warp (the terminal rung's mode): t, budget, flags and steps
    equal the plain march's, from the coarse call's state."""
    r = card_rays
    coarse, _ = _march(r, "high", 3e-3, 1, plain=True)
    start = coarse._replace(active=coarse.active | coarse.converged,
                            converged=torch.zeros_like(coarse.converged))
    got, gs = _march(r, "highest", 1e-6, 32, plain=False, start=start)
    want, ws = _march(r, "highest", 1e-6, 32, plain=True, start=start)
    for a, b in ((got.t, want.t), (got.budget, want.budget), (gs, ws),
                 (got.active, want.active), (got.converged, want.converged)):
        assert torch.equal(a, b)
    assert megakernel.SPLIT_LAUNCHES[64] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("precision, eps", [("high", 3e-3), ("highest", 1e-6)])
def test_card_tensor_core_modes_match_the_plain_march(card_rays, precision, eps):
    """A ray per thread (the coarse call at "high", K2h; the FP32 rungs at
    "highest", 3xTF32): the chain sums in the tensor cores' order, so the
    hit flags agree on 99.5% of rays and t within 1e-4 (coarse: 1e-2) on
    99% of the rays both hit."""
    r = card_rays
    got, _ = _march(r, precision, eps, 1, plain=False)
    want, _ = _march(r, precision, eps, 1, plain=True)
    assert float((got.converged == want.converged).float().mean()) >= 0.995
    both = got.converged & want.converged
    close = (got.t - want.t).abs()[both] <= (1e-2 if precision == "high" else 1e-4)
    assert both.sum() > 500 and float(close.float().mean()) >= 0.99


@pytest.mark.cuda
def test_card_encoding_kernel_value_and_gradient(card_rays):
    """The encoding kernel's features equal the plain encoding's bit for bit;
    its gradient back to the points is autograd's of the reference within
    1e-5 of the gradient's norm (its own order of sums)."""
    r = card_rays
    model, dev = r["model"], r["dev"]
    p = torch.from_numpy(np.random.default_rng(5).uniform(-0.9, 0.9, (65536, 3)).astype(np.float32))
    p = p.to(dev)
    feats = hash_grid._encode_cuda(model, p)
    assert torch.equal(feats, model.features(p))
    g = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (65536, 32)).astype(np.float32)).to(dev)
    got = hash_grid._encode_cuda(model, p, g)
    net = kind.reference_net(r["arrays"], dev)
    q = p.clone().requires_grad_(True)
    (want,) = torch.autograd.grad((net.features(q) * g).sum(), q)
    scale = want.norm(dim=1, keepdim=True)
    assert float(((got - want).abs() / (scale + 1e-6)).max()) <= 1e-5


def test_spans_on_another_thread_nest_under_the_forward():
    """``trace.within(parent)``: a span and a counter opened on another
    thread (autograd's, for the encoding's backward) take the names they
    would have had inside ``parent``."""
    import threading

    trace.enable()
    trace.reset()
    try:
        with trace.span("frame"), trace.span("shade"):
            parent = trace.current()

        def backward():
            with trace.within(parent):
                trace.count("encode", points=6)
                with trace.span("encode"):
                    pass

        worker = threading.Thread(target=backward)
        worker.start()
        worker.join()
        snap = trace.snapshot()
    finally:
        trace.disable()
    assert snap["counters"]["frame/shade/encode.points"] == 6
    assert snap["spans"]["frame/shade/encode"]["calls"] == 1
    assert trace.current() is None


def test_gather_and_encode_rooflines_read_the_programs_counters():
    """``gather_roofline.<span>``: the gathers counted under ``frame/<span>``
    (the march phases', the shading encoding's) x 8 B at L2's measured rate
    over the span's device time; None where the program counts no gathers
    or has no such span (a dense chain, the parent)."""
    from portbench.metrics import gather_roofline

    roof = gather_roofline.L2_BYTES_PER_S
    assert roof > 3.35e12  # L2 serves faster than HBM
    span = lambda ms: dict(calls=1, host_ms=0.1, device_ms=ms, device_calls=8)  # noqa: E731
    prog = dict(frames=8, spans={"sequence/enqueue/frame/coarse": span(40.0),
                                 "sequence/enqueue/frame/refine": span(80.0),
                                 "sequence/enqueue/frame/shade": span(30.0),
                                 "sequence/enqueue/frame/shade/encode": span(10.0)},
                counters={"sequence/enqueue/frame/coarse/march.gathers": 10**11,
                          "sequence/enqueue/frame/coarse/march.useful": 10**11 // 128,
                          "sequence/enqueue/frame/refine/highest/rung1/march.gathers": 2 * 10**10,
                          "sequence/enqueue/frame/shade/encode/encode.gathers": 128 * 10**7})
    run = dict(slice=dict(frames=8, program=prog))
    want = dict(coarse=100.0 * (10**11 * 8 / roof) / 0.040,
                refine=100.0 * (2 * 10**10 * 8 / roof) / 0.080,
                shade_encode=100.0 * (128 * 10**7 * 8 / roof) / 0.010)
    for name, value in want.items():
        got = gather_roofline.read(run, "gather_roofline." + name.replace("_", "."))
        assert got == pytest.approx(value)
    for key in [k for k in prog["counters"] if k.endswith(".gathers")]:
        del prog["counters"][key]
    for name in want:
        assert gather_roofline.read(run, "gather_roofline." + name.replace("_", ".")) is None
    assert gather_roofline.read(dict(slice=None), "gather_roofline.refine") is None


@pytest.mark.cuda
def test_card_reference_frame_is_the_cpus(card_rays):
    """The plain reference renders a small frame on the card (its last rays
    through a CUDA graph, which no constant may be copied into) with the
    CPU's hit flags and bytes but for rounding (cuBLAS sums otherwise)."""
    r = card_rays
    tr = dict(scene="neural_raw", width=64, height=36)
    pose = dict(rotation_x=-15.0, rotation_y=30.0, frame=0.0)
    card = check.reference_frame(kind.reference_net(r["arrays"], r["dev"]), pose, _config(), tr,
                                 r["dev"])
    cpu = check.reference_frame(kind.reference_net(r["arrays"], "cpu"), pose, _config(), tr, "cpu")
    got = check.frame_readings(torch.stack([card["grey"]] * 3 + [card["alpha"]], -1).cpu(),
                               cpu["grey"], cpu["alpha"])
    assert got["mask_mismatch_pct"] <= 0.1 and got["shade_gap_pct"] <= 1.0, got


@pytest.mark.cuda
def test_card_sequence_runs_the_hash_grid_kernels(card_rays):
    """``render_sequence`` of the hash grid on the card launches the
    encoding's instantiations of the march kernel (the three-pass coarse
    call, the FP32 rungs, the ray-per-warp rung) and the encoding kernel for
    the normals."""
    r = card_rays
    megakernel.reset_launch_counts()
    hash_grid.ENCODE_LAUNCHES = 0
    rcfg = cnr.RenderConfig(**check.render_fields(_config(), {}), width=256, height=144,
                            scene="neural_raw").validate()
    cams = [cnr.Camera(rotation_x=-15.0, rotation_y=30.0 + 10.0 * i) for i in range(2)]
    images = cnr.render_sequence(r["model"], cams, rcfg, chunk=2)
    assert len(images) == 2 and all(bool((im[..., 3] > 0).any()) for im in images)
    assert megakernel.THREE_PASS_LAUNCHES[64] > 0 and megakernel.SPLIT_LAUNCHES[64] > 0
    assert megakernel.PRECISION_LAUNCHES["highest"] > megakernel.SPLIT_LAUNCHES[64]
    assert hash_grid.ENCODE_LAUNCHES > 0
