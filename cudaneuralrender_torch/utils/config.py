"""Render configuration.

The same frozen dataclass as the JAX package's ``RenderConfig``: identical
field names, and the same defaults but the coarse phase's
(``coarse_precision``, ``coarse_eps``: set from the H100's chain errors, see
below; tests/test_torch_config.py holds the two together), so one config
describes a render in either package. PyTorch runs
eagerly, so the config is a plain value the render functions branch on; it
stays frozen and hashable because the adaptive-schedule memo keys on it.

``prepass_factor`` (a cone-traced prepass at 1/f resolution, ops/prepass.py)
and ``grid_res`` (a baked distance grid walked ahead of the march,
ops/grid.py) select the mixed march's optional empty-space phases, as in the
JAX package (render/renderer.py ``_scheduled_march``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings.

    Defaults mirror the reference renderer's operating point:
      * 512x512 default resolution      (src/main.cpp:576-586)
      * MAX_STEPS=6000                  (src/volumeRender_kernel.cu:61)
      * MARCHING_EPSILON=1e-6           (src/volumeRender_kernel.cu:60)
      * NORMAL_EPSILON=1e-5             (src/volumeRender_kernel.cu:59)
      * bounding sphere r=1.2 at origin (src/volumeRender_kernel.cu:325-328)
      * focal length -2 ray z           (src/volumeRender_kernel.cu:321)
    """

    width: int = 512
    height: int = 512

    # Sphere-trace budget / tolerances.
    max_steps: int = 6000
    march_eps: float = 1e-6
    normal_eps: float = 1e-5

    # Scene bounding sphere (empty-space culling before marching).
    bound_center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    bound_radius: float = 1.2

    # Camera projection: rays leave the eye through (u, v, -focal).
    focal: float = 2.0

    # Scene composition applied around the raw neural SDF logit.
    # "neural_raw" uses the network's pre-tanh output directly as a distance
    # (the reference's checked-in behaviour).
    scene: str = "neural_raw"

    # "facing" or "matcap" (src/volumeRender_kernel.cu:446-453).
    shading: str = "facing"

    # Surface-normal estimator: "autodiff" (exact gradient of the SDF) or
    # "tetrahedron" (4-tap finite difference, src/volumeRender_kernel.cu:362-377).
    normal_mode: str = "autodiff"

    # 3 = (x, y, z); 4 = (x, y, z, frame) animation mode.
    num_inputs: int = 3

    # March loop implementation:
    #   "while"      - dense masked march until every ray resolves
    #   "fori"       - fixed-length dense march
    #   "staged"     - coarse kernel pass + compacted refine ladder (main path)
    #   "megakernel" - whole march inside the march kernel, dense shading
    march_impl: str = "while"

    # Staged-compaction schedules (march_impl="staged"): per (div, steps)
    # rung the surviving active rays pack into an N/div prefix bucket and
    # march `steps` more (0 = until the bucket runs dry). Leftovers fall to
    # a host-driven continuation, so schedules are performance hints, never
    # correctness hazards.
    stage_steps: int = 8
    coarse_schedule: Tuple[Tuple[int, int], ...] = ((4, 0),)
    refine_schedule: Tuple[Tuple[int, int], ...] = ((4, 16), (8, 24), (32, 64), (256, 0))
    # Explicit per-rung lane caps for the refine ladder (() = divisors),
    # learned by schedule.tune_caps from per-rung stats.
    refine_caps: Tuple[int, ...] = ()
    adaptive_rungs: bool = True
    # march_precision="full" phase-A schedule.
    fine_schedule: Tuple[Tuple[int, int], ...] = ((4, 48), (32, 192), (256, 0))
    compact_min: int = 2048

    # Shading bucket divisor for the full-precision path.
    shade_div: int = 8

    # Carry the shaded colours through the image-order restore sort as one
    # u32 (a<<24|b<<16|g<<8|r, the reference's display format).
    rgba_packed: bool = True

    # Matmul precision names kept for config parity with the JAX package;
    # shading runs its MLP in float32 (TF32 off) at every setting.
    shade_precision: str = "highest"
    grad_shade_precision: str = "high"

    # Mixed-precision march: "mixed" runs a coarse phase down to coarse_eps,
    # then re-marches the near-surface set at full precision down to
    # march_eps. "full" marches at full precision throughout. In the march
    # kernel "default" and "highest" run the chain in FP32 and "high" runs
    # the three-pass bfloat16 chain (K2h): coarse_precision="high" for the
    # coarse pass, and mid_eps > march_eps for a HIGH phase down to mid_eps
    # before the HIGHEST one (on mid_schedule, or refine_schedule if empty).
    #
    # The coarse phase is the H100's, not the JAX package's (the TPU's
    # DEFAULT: one bf16 pass, max SDF error 4.7e-2, hence eps 0.05). On an
    # NVIDIA H100 80GB HBM3 at 700 W (benchmarks/precision_ladder.py, the
    # table in PERF.md section 5) the max |SDF - float64| over seeded points
    # in the bounding sphere is 1.09e-5 to 3.73e-5 for the three-pass chain
    # and 5.0e-7 to 5.9e-7 for the FP32 chain at widths 32-1024, and a
    # three-pass lane-step costs 0.15 ns against FP32's 0.44. This pair gives
    # the fastest csg_demo 1080p frame of those whose eps is at least 10x its
    # chain's worst error and that meet the mixed bar against "full" on every
    # cell of the sweep: 21.459 ms against 29.044 for ("default", 0.05), no
    # cell slower ("high" at 1e-3: 21.464 ms, a tie).
    # mid_eps stays 0.0: a HIGH middle phase runs the chain the coarse phase
    # just ran, so it adds rungs and saves the FP32 ones nothing. A 1080p
    # frame at mid_eps 1e-3 takes 32.067 ms against 20.323 at 0.0 on the
    # same card (chip_smoke.py phases 5 and 10); behind the FP32 coarse
    # phase to 0.05 its dense rungs left the kernel: 9709.722 ms a frame.
    march_precision: str = "mixed"
    coarse_precision: str = "high"
    coarse_eps: float = 3e-3
    mid_eps: float = 0.0
    mid_schedule: Tuple[Tuple[int, int], ...] = ()

    # Constant over-relaxed sphere tracing (Keinert et al. 2014) with
    # backtrack on safety-sphere non-overlap (ops/march.py).
    relax_omega: float = 1.6
    relax_omega_refine: float = 1.6
    # Secant-adaptive relaxation, clip(1/g, 1, relax_omega_max) with g the
    # SDF's slope along the ray; the relaxed rungs then march outside the
    # kernel.
    relax_newton: bool = False
    relax_omega_max: float = 8.0

    # Terminal rungs of at most tail_pallas_max lanes that would march
    # outside the kernel (refine_pallas off, relax_newton) run in it.
    tail_pallas: bool = False
    tail_pallas_max: int = 16384

    # Key the refine phase's entry sort by each ray's coarse resolve step.
    ordered_packing: bool = True

    # Run the refine rungs inside the march kernel.
    refine_pallas: bool = True

    # Lane order for the coarse kernel pass: (rows, cols) image blocks.
    # () keeps image order. Per-ray results do not depend on lane order.
    coarse_block: Tuple[int, int] = (128, 128)

    # Run the whole coarse phase as one run-to-dry kernel pass.
    coarse_pallas: bool = True

    cyl_window: int = 3
    cyl_window_coarse: int = 1
    grid_res: int = 0
    prepass_factor: int = 0
    warm_margin: float = 0.08
    mlp_dtype: str = "float32"
    use_pallas: bool = False

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def num_rays(self) -> int:
        return self.height * self.width

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "RenderConfig":
        if self.scene not in SCENE_NAMES:
            raise ValueError(f"unknown scene {self.scene!r}; choose from {sorted(SCENE_NAMES)}")
        if self.shading not in ("facing", "matcap"):
            raise ValueError(f"unknown shading {self.shading!r}")
        if self.normal_mode not in ("autodiff", "tetrahedron"):
            raise ValueError(f"unknown normal_mode {self.normal_mode!r}")
        if self.march_impl not in ("while", "fori", "staged", "megakernel"):
            raise ValueError(f"unknown march_impl {self.march_impl!r}")
        if self.num_inputs not in (3, 4):
            raise ValueError("num_inputs must be 3 or 4")
        if self.refine_caps and len(self.refine_caps) != len(self.refine_schedule):
            raise ValueError(
                "refine_caps must be empty or match refine_schedule length")
        if any(c <= 0 for c in self.refine_caps):
            raise ValueError("refine_caps entries must be positive")
        if self.coarse_precision not in ("default", "high"):
            raise ValueError(f"unknown coarse_precision {self.coarse_precision!r}")
        if self.cyl_window not in (3, 5):
            raise ValueError("cyl_window must be 3 or 5")
        if self.cyl_window_coarse not in (1, 3, 5):
            raise ValueError("cyl_window_coarse must be 1, 3 or 5")
        if self.shade_precision not in ("highest", "high", "default"):
            raise ValueError(f"unknown shade_precision {self.shade_precision!r}")
        if self.grad_shade_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"unknown grad_shade_precision {self.grad_shade_precision!r}")
        return self


# Scene registry names (implementations live in ops/sdf.py).
SCENE_NAMES = frozenset(
    {
        "neural_raw",        # raw network logit as distance (reference checked-in behavior)
        "neural_tanh",       # tanh(logit) as distance
        "many_sphere",       # smooth-union of 9 animated spheres with the neural SDF
        "many_sphere_cut",   # smooth-subtraction variant
        "many_cylinder_cut", # 300-cylinder drill pattern
        "displacement",      # sine displacement of tanh(logit)
        "sphere",            # analytic sphere only (no network) — for tests
    }
)
