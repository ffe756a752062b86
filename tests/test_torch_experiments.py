"""The step-cost experiment kernels X1-X3: the port against the JAX package's
experiment kernels on the CPU.

The JAX kernels come from the unmodified scripts benchmarks/exp_blockdiag.py
(``_loop_kernel``), benchmarks/exp_stepcost.py and
benchmarks/exp_stepcost2.py (``make_kernel``), loaded by path (that
directory is no package) and run through ``pl.pallas_call(...,
interpret=True)`` with whole-array blocks; this package runs the kernels'
plain versions (CPU tensors). Inputs are seeded numpy arrays, 256-512
lanes, 4-8 steps or 9-18 reps, csg_demo's weights for X2 and X3.

Tolerances. X1 and X2 (outputs of order 1-100): atol 1e-5 (1e-4 on X2's
t, which grows to ~50), because XLA:CPU and torch sum in different orders
and XLA contracts some multiply-adds into fused ones. X3's outputs are
scaled by 1e-8 each step (v1, v2, and v3-v5p's t += sdf * 1e-8, which start
from t0 = 0 here so that t carries the SDF at full precision) or grow by
~2x per product (v0): they are held within 1e-5 of their own scale,
max |port - JAX| <= 1e-5 * max |JAX|, the bf16 emulations too, whose
products are exact but whose sums are not. Every case agreed bit for bit
when these tests were written (plain sums in input order on both sides);
each test reports the share of bit-equal outputs in its failure message.

The card runs X1-X3 on the tensor cores, which sum in their own order;
the models of that order (``exp_blockdiag.chain_model``,
``exp_stepcost.step_cost_model``, ``exp_stepcost2.ablation_model``) are
held here to the plain versions and to the JAX kernels at the same
tolerances (X2's three-pass chain on all but the lanes chip_smoke.py's
``x2_beyond`` accounts for), and to float64 at chip_smoke.py's witness
bars: the model's |error| within WITNESS_MEAN (1.25x) of the plain
version's on the mean and WITNESS_MAX (2x) on the max, over X1's 9-rep
outputs and over one step of X2 and X3 at 4096 seeded points. X2's check
(``chip_smoke.x2_check``) runs here on the model as the kernel, and on a
chain off the plain one, which it must fail.
"""
import functools
import importlib.util
import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

torch.set_num_threads(2)

import chip_smoke  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch import benchmarks  # noqa: E402
from cudaneuralrender_torch.benchmarks import exp_blockdiag as x1  # noqa: E402
from cudaneuralrender_torch.benchmarks import exp_stepcost as x2  # noqa: E402
from cudaneuralrender_torch.benchmarks import exp_stepcost2 as x3  # noqa: E402
from cudaneuralrender_torch.kernels import build  # noqa: E402
from cudaneuralrender_torch.kernels import fused_mlp as fused_t  # noqa: E402
from cudaneuralrender_torch.models import checkpoint  # noqa: E402
from cudaneuralrender_tpu.ops import camera as cam_j  # noqa: E402
from cudaneuralrender_tpu.pallas import fused_mlp as fused_j  # noqa: E402
from test_torch_mma import unpack  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CSG = os.path.join(ROOT, "examples", "assets", "csg_demo.npz")
PRECISIONS = {"DEFAULT": jax.lax.Precision.DEFAULT, "HIGHEST": jax.lax.Precision.HIGHEST}


def _script(name):
    """A script of benchmarks/ as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BLOCKDIAG = _script("exp_blockdiag")
STEPCOST = _script("exp_stepcost")
STEPCOST2 = _script("exp_stepcost2")


def _interpret(kern, n_out_rows, n, *args):
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((n_out_rows, n), jnp.float32),
        interpret=True)(*(jnp.asarray(a) for a in args)))


def _stack():
    """csg_demo's padded stack: (JAX weights, biases), (torch weights, biases)."""
    with np.load(CSG) as data:
        layers = [(data[f"w{i}"], data[f"b{i}"]) for i in range(len(data.files) // 2)]
    pj = tuple(cj.mlp.DenseParams(jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    wj, bj, _, _ = fused_j.pack_params(pj)
    return (wj, bj), (torch.from_numpy(np.array(wj)), torch.from_numpy(np.array(bj)))


@functools.lru_cache(maxsize=None)
def _params():
    """csg_demo's layers in the port, on the CPU."""
    return checkpoint.load(CSG, device="cpu")


def _sdf64():
    """csg_demo's SDF in float64 (points [n, 3] -> [n]), X2's padded stack's."""
    return lambda pts: chip_smoke.sdf_float64(_params(), pts)


def _report(got, want):
    return f"bit-equal on {np.mean(got == want):.4f} of {got.size} outputs"


def _close(got, want, atol):
    assert got.shape == want.shape
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=_report(got, want))


# --- X1 ---------------------------------------------------------------------

# width -> weight scale: the gain of a layer stays near 1, so the outputs
# neither vanish nor blow up over 18 reps (the JAX script's W x 0.1 decays).
X1_SCALE = {32: 0.2, 128: 0.11}


@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("reps", [9, 18])
@pytest.mark.parametrize("hidden", [32, 128])
def test_x1_chain_plain_matches_jax(hidden, reps, prec):
    rng = np.random.default_rng(hidden + reps)
    x = rng.normal(size=(hidden, 256)).astype(np.float32)
    w = (rng.normal(size=(hidden, hidden)) * X1_SCALE[hidden]).astype(np.float32)
    b = (rng.normal(size=hidden) * 0.1).astype(np.float32)
    kern = functools.partial(BLOCKDIAG._loop_kernel, reps=reps, precision=PRECISIONS[prec])
    want = _interpret(kern, hidden, 256, x, w, b)
    launches = dict(x1.LAUNCHES)
    got = x1.chain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                   reps=reps).numpy()
    assert x1.LAUNCHES == launches  # CPU tensors never reach the kernel
    assert 0.1 < np.abs(want).max() < 1e4 and (want == 0).mean() < 0.9  # not decayed
    _close(got, want, 1e-5 * max(1.0, float(np.abs(want).max())))


def _x1_inputs(hidden, n=256):
    rng = np.random.default_rng(hidden + 9)
    x = rng.normal(size=(hidden, n)).astype(np.float32)
    w = (rng.normal(size=(hidden, hidden)) * X1_SCALE[hidden]).astype(np.float32)
    b = (rng.normal(size=hidden) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("hidden", [32, 128])
def test_x1_chain_model_matches_jax_and_float64(hidden):
    """The kernel's order (K1's tf32 layer at the width) against the plain
    version and the JAX kernel at X1's atol, and at the witness bars."""
    x, w, b = _x1_inputs(hidden)
    reps = 9
    kern = functools.partial(BLOCKDIAG._loop_kernel, reps=reps, precision=PRECISIONS["HIGHEST"])
    want = _interpret(kern, hidden, x.shape[1], x, w, b)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    model = x1.chain_model(xt, wt, bt, reps)
    plain = x1.chain(xt, wt, bt, reps=reps)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    _close(model.numpy(), plain.numpy(), atol)
    _close(model.numpy(), want, atol)
    witness = chip_smoke.x_witness(model, plain, chip_smoke.x1_float64(xt, wt, bt, reps))
    assert not chip_smoke.witness_bar(witness), witness


def test_x1_pack_tf32_parts_is_exact():
    """At 32 the kernel stages W as three tf32 parts in fragment order: each
    a tf32 value (low 13 bits zero), summing to pack_mma's FP32 weight."""
    _, w, _ = _x1_inputs(32)
    parts = x1.pack_tf32_parts(torch.from_numpy(w))
    assert parts.shape == (3, 4, 4, 32, 2)
    assert not (parts.view(torch.int32) & 0x1FFF).any()
    whole = fused_t.pack_mma(torch.from_numpy(w)[None], "tf32")[0]
    assert torch.equal(parts.double().sum(0), whole.double())


@pytest.mark.parametrize("third", [False, True])
def test_x1_weight_third_part_at_32(third):
    """A weight used at every rep: K1's two-part split perturbs it the same
    way each time, and over 18 reps at a gain above one K1's product misses
    the mean witness bar; the kernel's third weight part meets it (the
    design reason in csrc/experiments.cu ``mma_tf32_exact``)."""
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.normal(size=(32, 4096)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(32, 32)) * (1.2 / 32 ** 0.5)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=32) * 0.1).astype(np.float32))
    if third:
        got = x1.chain_model(x, w, b, 18)
    else:
        y = x.t()
        for _ in range(18):
            y = torch.relu(fused_t._layer_tf32(y, w, 32, 32, 32) + b)
        got = y.t()
    witness = chip_smoke.x_witness(got, x1.chain(x, w, b, reps=18),
                                   chip_smoke.x1_float64(x, w, b, 18))
    assert (not chip_smoke.witness_bar(witness)) == third, witness


# --- X2 ---------------------------------------------------------------------

def _x2_inputs(n=512):
    """The rays of a 32x16 Camera(rotation_y=25) image (the JAX script's
    camera), t0 0.8, in the JAX layout."""
    cfg = cj.RenderConfig(width=32, height=16)
    c2w, _ = cam_j.view_matrices(cj.Camera(rotation_y=25.0))
    origin, dirs = cam_j.generate_rays(c2w, cfg.height, cfg.width, cfg.focal)
    dirs_t = np.ascontiguousarray(np.asarray(dirs).T)
    return dirs_t, np.full((1, n), 0.8, np.float32), np.array(origin).reshape(3, 1)


# name -> (JAX precision, three_pass, act_dtype)
X2_CHAINS = {"highest": ("HIGHEST", False, "float32"), "default": ("DEFAULT", False, "float32"),
             "three_pass": ("HIGHEST", True, "float32"), "bf16_input": ("HIGHEST", False,
                                                                       "bfloat16")}


def _round_f32(q: Fraction) -> float:
    """The rational q rounded once to float32 (to nearest, ties to even)."""
    a = np.float32(float(q))
    near = sorted((abs(Fraction(float(c)) - q), int(c.view(np.uint32)) & 1, float(c))
                  for c in (np.nextafter(a, np.float32(-np.inf)), a,
                            np.nextafter(a, np.float32(np.inf))))
    return near[0][2]


def test_point_rows_rounds_once():
    """benchmarks.point_rows (the points of X2 and X3's plain versions)
    rounds each coordinate of o + d*t once, as the kernels' fused
    multiply-add does: where the float64 sum lands on a float32 tie that
    the exact sum is off (o below half an ulp of d*t in float64: d*t = 1 +
    k*2^-11 + k^2*2^-24), it rounds to the exact sum's side of the tie in
    both directions and at both parities; and on seeded o, d, t with t up
    to 1e18 it equals the exact sum rounded once."""
    cases = []
    for k in range(1, 9):
        h = 1.0 + k * 2.0 ** -12
        for o in (2.0 ** -80, -2.0 ** -80):
            cases += [(o, h, h), (-o, -h, h)]
    rng = np.random.default_rng(9)
    cases += list(zip(rng.uniform(-2, 2, 200), rng.uniform(-1, 1, 200),
                      10.0 ** rng.uniform(-1, 18, 200)))
    naive_wrong = 0
    for o, d, t in cases:
        o, d, t = (float(np.float32(v)) for v in (o, d, t))
        got = benchmarks.point_rows(torch.full((3, 1), o), torch.full((3, 1), d),
                                    torch.tensor([t]))
        want = _round_f32(Fraction(o) + Fraction(d) * Fraction(t))
        assert got.shape == (1, 3) and got[0].tolist() == [want] * 3, (o, d, t)
        naive_wrong += float(np.float32(o + d * t)) != want
    assert naive_wrong >= 8  # the float64 sum rounded to float32 misses the ties


@pytest.mark.parametrize("chain", list(X2_CHAINS))
@pytest.mark.parametrize("variant", list(x2.VARIANTS))
def test_x2_step_cost_plain_matches_jax(variant, chain):
    prec, three_pass, act = X2_CHAINS[chain]
    (wj, bj), (wt, bt) = _stack()
    dirs, t0, origin = _x2_inputs()
    steps = 8
    kern = STEPCOST.make_kernel(variant, wj.shape[0], wj.shape[1], steps, PRECISIONS[prec],
                                getattr(jnp, act), three_pass=three_pass)
    ops = (*fused_j.split_hi_lo(wj), bj) if three_pass else (wj, bj)
    want = _interpret(kern, 1, dirs.shape[1], dirs, t0, origin, *ops)
    got = x2.step_cost(variant, wt, bt, *(torch.from_numpy(a) for a in (dirs, t0, origin)),
                       steps=steps, three_pass=three_pass, act_dtype=getattr(torch, act)).numpy()
    assert np.ptp(want) > 0.5  # the lanes moved apart
    _close(got, want, 1e-4)


def test_x2_variants_differ():
    """chain_only, march_state and march_relax are three functions, and the
    three-pass and bfloat16-input chains move t."""
    _, (wt, bt) = _stack()
    args = [torch.from_numpy(a) for a in _x2_inputs()]
    out = {v: x2.step_cost(v, wt, bt, *args, steps=8) for v in x2.VARIANTS}
    assert not torch.equal(out["chain_only"], out["march_relax"])
    assert not torch.equal(out["march_state"], out["march_relax"])
    for kw in (dict(three_pass=True), dict(act_dtype=torch.bfloat16)):
        assert not torch.equal(x2.step_cost("chain_only", wt, bt, *args, steps=8, **kw),
                               out["chain_only"])


@pytest.mark.parametrize("chain", list(X2_CHAINS))
@pytest.mark.parametrize("variant", list(x2.VARIANTS))
def test_x2_model_matches_jax_and_float64(variant, chain):
    """The kernel's order (K1's tf32 chain, or K2h's bf16 chain for the
    three-pass kind) against the JAX kernel at the plain version's bar, and
    one chain_only step at 4096 seeded points at the witness bars. The
    FP32 chain holds the bar on every lane. The three-pass chain splits
    each activation into bfloat16 halves, and a 1-ulp change of the
    activation can move that split by 2^-17 of it: over 8 steps some lanes
    end up to ~4e-4 from JAX's (t ~ 18). Those lanes are accounted for as
    chip_smoke.py accounts for X2's lanes beyond X_RTOL (``x2_beyond`` to
    ``undecided_bar``): marched again, with every other lane, on the
    model's chain and on the plain one, each landing on its own t bit for
    bit, the model's chain on their paths at the witness bars, the two
    chains within K2H_SDF_ATOL."""
    prec, three_pass, act = X2_CHAINS[chain]
    (wj, bj), (wt, bt) = _stack()
    dirs, t0, origin = _x2_inputs()
    steps = 8
    kern = STEPCOST.make_kernel(variant, wj.shape[0], wj.shape[1], steps, PRECISIONS[prec],
                                getattr(jnp, act), three_pass=three_pass)
    ops = (*fused_j.split_hi_lo(wj), bj) if three_pass else (wj, bj)
    want = _interpret(kern, 1, dirs.shape[1], dirs, t0, origin, *ops)
    args = [torch.from_numpy(a) for a in (dirs, t0, origin)]
    kw = dict(steps=steps, three_pass=three_pass, act_dtype=getattr(torch, act))
    model = x2.step_cost_model(variant, wt, bt, *args, **kw)
    beyond = np.abs(model.numpy() - want) > 1e-4
    if three_pass:
        chains = (x2.model_sdf(wt, bt, True), x2.plain_sdf(wt, bt, True))
        u = chip_smoke.x2_beyond(variant, chains, _sdf64(), args, model,
                                 x2.step_cost(variant, wt, bt, *args, **kw),
                                 torch.from_numpy(beyond.reshape(-1)).nonzero().squeeze(1),
                                 torch.arange(dirs.shape[1]), steps, kw["act_dtype"])
        assert u["replay_equal"] and not chip_smoke.undecided_bar(u, unparted_ok=True), u
        assert u["chain_max_diff"] <= chip_smoke.K2H_SDF_ATOL, u
    _close(model.numpy()[~beyond], want[~beyond], 1e-4)
    assert three_pass or not beyond.any()
    pts = torch.from_numpy(np.random.default_rng(5).uniform(-1.2, 1.2, (4096, 3))
                           .astype(np.float32))
    rays = chip_smoke.x3_witness_rays(pts)
    kw = dict(steps=1, three_pass=three_pass)
    witness = chip_smoke.x_witness(x2.step_cost_model("chain_only", wt, bt, *rays, **kw),
                                   x2.step_cost_plain("chain_only", wt, bt, *rays, **kw),
                                   chip_smoke.x2_float64(_params(), pts))
    assert not chip_smoke.witness_bar(witness), witness


def _x2_check(variant, three_pass, chains, steps=16):
    """chip_smoke.x2_check of the march on ``chains``' first chain against
    the plain version, on the rays of a 64x32 image."""
    _, (wt, bt) = _stack()
    cfg = cj.RenderConfig(width=64, height=32)
    c2w, _ = cam_j.view_matrices(cj.Camera(rotation_y=25.0))
    origin, dirs = cam_j.generate_rays(c2w, cfg.height, cfg.width, cfg.focal)
    n = cfg.height * cfg.width
    rays = (torch.from_numpy(np.ascontiguousarray(np.asarray(dirs).T)),
            torch.full((1, n), 0.8), torch.from_numpy(np.array(origin).reshape(3, 1)))
    got = x2.march_steps(variant, chains[0], *rays, steps=steps)
    want = x2.step_cost_plain(variant, wt, bt, *rays, steps=steps, three_pass=three_pass)
    atol = chip_smoke.K2H_SDF_ATOL if three_pass else chip_smoke.K1_MMA_SDF_ATOL
    return chip_smoke.x2_check(variant, chains, _sdf64(), rays, got, want, steps=steps,
                               sdf_atol=atol)


def _beyond_bar(check) -> list:
    """What breaks phase 11's bar on X2's lanes beyond X_RTOL
    (``chip_smoke.check_outputs`` but the witness of one step)."""
    u = check["beyond"]
    bad = chip_smoke.undecided_bar(u, unparted_ok=True)
    if not u["chain_max_diff"] <= check["sdf_atol"]:
        bad.append(f"chains {u['chain_max_diff']} apart")
    return bad


@pytest.mark.parametrize("three_pass", [False, True])
@pytest.mark.parametrize("variant", list(x2.VARIANTS))
def test_x2_check_accounts_for_the_lanes_beyond(variant, three_pass):
    """chip_smoke's X2 check on the model as the kernel: the march on the
    kernel's chain lands on it on every lane, and the lanes beyond X_RTOL
    (grazing rays, whose step's SDF difference grows) replay on both sides
    bit for bit and meet phase 11's bar: the partings as undecided_bar
    holds them, each chain on its paths at the float64 witness bars, the
    two chains within the chain's bar; every lane's t is also marched in
    float64 (``t_witness``)."""
    _, (wt, bt) = _stack()
    chains = (x2.model_sdf(wt, bt, three_pass), x2.plain_sdf(wt, bt, three_pass))
    check = _x2_check(variant, three_pass, chains)
    u = check["beyond"]
    assert u["replay_equal"], u
    assert u["lanes"] == check["n_beyond"]
    assert u["lanes"] == u["n_undecided"] + u["n_decided"] + u["n_unparted"]
    assert not _beyond_bar(check), u
    assert u["replayed"] == 2048 and u["t_witness"]["n"] == 2048
    assert check["n_finite"] > 0
    if three_pass:  # the bfloat16 split of the activations parts some lanes at 16 steps
        assert u["lanes"] > 0


def test_x2_check_fails_a_chain_off_the_plain_one():
    """A "kernel" chain whose weights are off by 1e-4 of themselves lands
    lanes beyond X_RTOL, and its distances on the replayed paths miss the
    float64 witness bars and the FP32 chain's bar."""
    _, (wt, bt) = _stack()
    off = x2.plain_sdf(wt * (1 + 1e-4), bt)
    check = _x2_check("chain_only", False, (off, x2.plain_sdf(wt, bt)))
    u = check["beyond"]
    assert u["replay_equal"] and u["lanes"] > 0 and u["n_unparted"] > 0
    bad = _beyond_bar(check)
    assert any("|SDF - float64|" in b for b in bad) and any("chains" in b for b in bad), bad


# --- X3 ---------------------------------------------------------------------

def _x3_inputs(variant, n=256):
    """dirs [3, n] seeded normal x 0.1 and origin (0, 0, -2), as the JAX
    script's; t0 0.8 where the variant carries x, 0 where it carries t."""
    rng = np.random.default_rng(3)
    dirs = (rng.normal(size=(3, n)) * 0.1).astype(np.float32)
    t0 = np.full((1, n), 0.8 if x3.KERNEL_OF[variant][0] in ("v0", "v1", "v2") else 0.0,
                 np.float32)
    return dirs, t0, np.array([[0.0], [0.0], [-2.0]], np.float32)


# (variant, precision): the emulations take no precision (their products are
# bfloat16 ones), the others run at both.
X3_CASES = [(v, p) for v in x3.VARIANTS for p in PRECISIONS
            if p == "HIGHEST" or v not in ("v5", "v5p")]


@pytest.mark.parametrize("variant,prec", X3_CASES)
def test_x3_ablation_plain_matches_jax(variant, prec):
    (wj, bj), (wt, bt) = _stack()
    dirs, t0, origin = _x3_inputs(variant)
    steps = 4
    kern = STEPCOST2.make_kernel(variant, wj.shape[0], wj.shape[1], steps, PRECISIONS[prec])
    extra = STEPCOST2.split3(wj) if variant in ("v5", "v5p") else ()
    want = _interpret(kern, 1, dirs.shape[1], dirs, t0, origin, wj, bj, *extra)
    got = x3.ablation(variant, wt, bt, *(torch.from_numpy(a) for a in (dirs, t0, origin)),
                      steps=steps).numpy()
    scale = float(np.abs(want).max())
    assert scale > 0
    _close(got, want, 1e-5 * scale)


X3_KERNELS = ["v0", "v1", "v2", "v3", "v5", "v5p"]


@pytest.mark.parametrize("variant", X3_KERNELS)
def test_x3_model_matches_jax_and_float64(variant):
    """The kernel's order (K1's tf32 chain for v0-v3, the bf16 MMA chain for
    v5 / v5p) against the plain version and the JAX kernel within 1e-5 of
    the outputs' scale, and at the witness bars."""
    (wj, bj), (wt, bt) = _stack()
    dirs, t0, origin = _x3_inputs(variant)
    steps = 4
    kern = STEPCOST2.make_kernel(variant, wj.shape[0], wj.shape[1], steps, PRECISIONS["HIGHEST"])
    extra = STEPCOST2.split3(wj) if variant in ("v5", "v5p") else ()
    want = _interpret(kern, 1, dirs.shape[1], dirs, t0, origin, wj, bj, *extra)
    args = [torch.from_numpy(a) for a in (dirs, t0, origin)]
    model = x3.ablation_model(variant, wt, bt, *args, steps=steps).numpy()
    plain = x3.ablation(variant, wt, bt, *args, steps=steps).numpy()
    scale = float(np.abs(want).max())
    assert scale > 0
    _close(model, plain, 1e-5 * scale)
    _close(model, want, 1e-5 * scale)
    pts = torch.from_numpy(np.random.default_rng(5).uniform(-1.2, 1.2, (4096, 3))
                           .astype(np.float32))
    rays = chip_smoke.x3_witness_rays(pts)
    witness = chip_smoke.x_witness(x3.ablation_model(variant, wt, bt, *rays, steps=1),
                                   x3.ablation_plain(variant, wt, bt, *rays, steps=1),
                                   chip_smoke.x3_float64(variant, wt, bt, pts))
    assert not chip_smoke.witness_bar(witness), witness


def test_x3_v0_needs_the_third_part():
    """v0 on K1's own product (two tf32 parts an activation) misses the mean
    witness bar; the third part brings it within (the design reason in
    csrc/experiments.cu ``mma_tf32_third``)."""
    _, (wt, bt) = _stack()
    pts = torch.from_numpy(np.random.default_rng(5).uniform(-1.2, 1.2, (4096, 3))
                           .astype(np.float32))
    rays = chip_smoke.x3_witness_rays(pts)
    x = torch.nn.functional.pad(pts, (0, 29))
    for _ in range(9):
        x = fused_t._layer_tf32(x, wt[0], 32, 32, 32)
    witness = chip_smoke.x_witness(x[:, 0], x3.ablation_plain("v0", wt, bt, *rays, steps=1)[0],
                                   chip_smoke.x3_float64("v0", wt, bt, pts))
    assert witness["kernel_mean"] > chip_smoke.WITNESS_MEAN * witness["plain_mean"]


def test_x3_witness_rays_rebuild_the_points():
    """The witness rays put each point exactly where o + d*t lands, and a
    t-carried step holds sdf * 1e-8 in full."""
    _, (wt, bt) = _stack()
    pts = torch.from_numpy(np.random.default_rng(6).uniform(-1.2, 1.2, (512, 3))
                           .astype(np.float32))
    dirs, t0, origin = chip_smoke.x3_witness_rays(pts)
    assert torch.equal(x3.point_rows(origin, dirs, t0.reshape(-1)), pts)
    out = x3.ablation_plain("v3", wt, bt, dirs, t0, origin, steps=1)[0]
    sdf = fused_t.mlp_chain_plain(wt, bt, torch.nn.functional.pad(pts, (0, 29)), 9)[:, 0]
    big = sdf.abs() > 2e-3
    assert big.float().mean() > 0.9
    assert torch.equal(out[big], (sdf * x3.SCALE)[big])


@pytest.mark.parametrize("part", [0, 1, 2])
def test_x3_pack_split3_unpacks_to_parts(part):
    """pack_split3's planes hold the bfloat16 parts (split3) in m16n8k16
    B-fragment order, and its hi plane is pack_mma's bf16 hi half."""
    _, (wt, _) = _stack()
    plane = x3.pack_split3(wt)[part]
    assert plane.dtype == torch.bfloat16 and plane.shape == (9, 2, 4, 32, 4)
    got = unpack(torch.cat([plane, plane], dim=-1).float().numpy(), "bf16", 32)[0]
    np.testing.assert_array_equal(got, x3.split3(wt)[part].float().numpy())
    if part == 0:
        assert torch.equal(plane, fused_t.pack_mma(wt, "bf16")[..., :4])


def test_x3_split3_matches_jax():
    (wj, _), (wt, _) = _stack()
    for a, b in zip(x3.split3(wt), STEPCOST2.split3(wj)):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b).astype(np.float32))


def test_x3_emulations_are_close_to_fp32():
    """The six-pass chain sits within float32 rounding of the FP32 chain,
    the five-pass one (no mid*mid term) further off (the JAX script's
    accuracy check)."""
    _, (wt, bt) = _stack()
    err = x3.emulation_errors(wt, bt, n_points=4096)
    assert 0 < err[6] < 1e-5 and 0 < err[5] < 1e-4 and err[6] < err[5]


def test_experiment_wrappers_check_before_loading(monkeypatch):
    """Unknown variants raise on any device; on a CUDA tensor the width is
    checked before the library is loaded."""
    def no_load():
        raise AssertionError("the library must not be loaded")

    monkeypatch.setattr(build, "load_library", no_load)
    _, (wt, bt) = _stack()
    args = [torch.from_numpy(a) for a in _x2_inputs()]
    with pytest.raises(ValueError, match="variant"):
        x2.step_cost("march", wt, bt, *args)
    with pytest.raises(ValueError, match="variant"):
        x3.ablation("v3d", wt, bt, *args)
    wide = torch.zeros((9, 64, 64))
    with pytest.raises(ValueError, match="width 32"):
        x2._step_cost_cuda("chain_only", wide, bt, *args, 8, False, torch.float32)
    for three_pass in (False, True):  # the stack is laid out after the checks
        with pytest.raises(ValueError, match="dtype"):
            x2._step_cost_cuda("chain_only", wt.double(), bt, *args, 8, three_pass,
                               torch.float32)
        with pytest.raises(ValueError, match="contiguous"):
            x2._step_cost_cuda("march_relax", wt.transpose(1, 2), bt, *args, 8, three_pass,
                               torch.float32)
        with pytest.raises(ValueError, match="shape"):
            x2._step_cost_cuda("march_state", wt, bt[:8], *args, 8, three_pass, torch.float32)
    with pytest.raises(ValueError, match="width 32"):
        x3._ablation_cuda("v3", wide, bt, *args, 8)
    with pytest.raises(ValueError, match="widths"):
        x1._chain_cuda(torch.zeros((64, 8)), torch.zeros((64, 64)), torch.zeros(64), 9)
    assert fused_t.KERNEL_WIDTHS[-1] == 1024
