"""A whole run of a cell on the CPU with the timed path broken underneath:
``correct`` has to come out false for each fault the cells can have. (The
exchange between chips is not among them: every cell runs on one chip.)

The run skips only the look for a card (``harness.run_cell(device="cpu")``)
and shrinks the frame; the program runs its plain versions of the kernels.
Run from the repository root: ``python -m pytest portbench/tests -q``.
"""
import pytest
import torch

import cudaneuralrender_torch as cnr
from cudaneuralrender_torch.kernels import megakernel
from cudaneuralrender_torch.ops import march, shading
from cudaneuralrender_torch.render import renderer
from portbench import check, harness, spec

SMALL = dict(width=64, height=36, batch=2, warm_batches=1)
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def run(cell, seed=2**31 + 99):
    return harness.run_cell(cell, seed, 0.5, False, device="cpu", overrides=SMALL)


def frozen_march(monkeypatch):
    """A march step that returns its state unchanged (only its count moves)."""
    def march_state(params, origin, dirs, state, config, frame=0.0, *, return_resolve=False,
                    **kw):
        state = state._replace(steps=torch.full_like(state.steps, config.max_steps))
        if return_resolve:
            return state, torch.zeros(dirs.shape[0], dtype=torch.int32, device=dirs.device)
        return state

    monkeypatch.setattr(megakernel, "march_state", march_state)
    monkeypatch.setattr(march, "march_step",
                        lambda sdf_fn, origin, dirs, s, eps: s._replace(steps=s.steps + 1))


def half_left_out(monkeypatch):
    """Half of each frame's rays left out: their pixels come back empty."""
    real = renderer._render_scheduled

    def render_scheduled(*args, **kw):
        out = real(*args, **kw)
        rgba = out[0].clone()
        rgba[rgba.shape[0] // 2:] = 0
        return (rgba,) + tuple(out[1:])

    monkeypatch.setattr(renderer, "_render_scheduled", render_scheduled)


def shade_moved(levels):
    def fault(monkeypatch):
        real = shading.facing_color
        monkeypatch.setattr(shading, "facing_color", lambda n, d: torch.clamp(
            real(n, d) + levels / 255.0, max=1.0))
    fault.__name__ = f"shade_plus{levels}"
    fault.__doc__ = f"Every shade altered where it is produced, by {levels} level(s)."
    return fault


def normal_tilted(monkeypatch):
    """Every normal tilted where it is produced, by about 3 degrees (the
    stand-in ``normal_tilt`` of ``check.STAND_INS``, planted in the program)."""
    real = shading.facing_color

    def facing_color(n, d):
        n = n + check.TILT / 3.0 ** 0.5
        return real(n / torch.linalg.vector_norm(n, dim=-1, keepdim=True), d)

    monkeypatch.setattr(shading, "facing_color", facing_color)


FAULTS = [frozen_march, half_left_out, shade_moved(1), shade_moved(2), shade_moved(16),
          normal_tilted]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run(cell)
    assert result["attempted"] > 0
    assert result["correct"] is False, result["checks"]


def test_the_unbroken_run_reads_below_every_fault():
    cell = CELLS[0]
    sound = run(cell)["checks"]
    for fault in FAULTS:
        with pytest.MonkeyPatch.context() as mp:
            fault(mp)
            broken = run(cell)["checks"]
        assert any(broken[k]["value"] > v["value"] for k, v in sound.items()), fault.__name__
    assert cnr.RenderConfig().max_steps == 6000
