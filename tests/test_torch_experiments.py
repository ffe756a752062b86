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
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

torch.set_num_threads(2)

import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.benchmarks import exp_blockdiag as x1  # noqa: E402
from cudaneuralrender_torch.benchmarks import exp_stepcost as x2  # noqa: E402
from cudaneuralrender_torch.benchmarks import exp_stepcost2 as x3  # noqa: E402
from cudaneuralrender_torch.kernels import build  # noqa: E402
from cudaneuralrender_torch.kernels import fused_mlp as fused_t  # noqa: E402
from cudaneuralrender_tpu.ops import camera as cam_j  # noqa: E402
from cudaneuralrender_tpu.pallas import fused_mlp as fused_j  # noqa: E402

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
    with pytest.raises(ValueError, match="width 32"):
        x3._ablation_cuda("v3", wide, bt, *args, 8)
    with pytest.raises(ValueError, match="widths"):
        x1._chain_cuda(torch.zeros((64, 8)), torch.zeros((64, 64)), torch.zeros(64), 9)
    assert fused_t.KERNEL_WIDTHS[-1] == 1024
