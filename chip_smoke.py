"""Smoke run of the PyTorch port (cudaneuralrender_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero and nothing is caught:
  1. require a CUDA device; print the card's name and power limit;
  2. build the kernels (csrc/*.cu, one nvcc per hidden width and chain and
     one for the elementwise kernels, in parallel, for sm_90a) and print the build time, ptxas's report and one
     line per kernel instantiation (registers, stack, spills, the dynamic
     shared memory its launch asks for at 9 layers, and its HMMA count in
     ``cuobjdump -sass``: every K3 and K2h instantiation and every FP32
     march instantiation a ray per thread (3xTF32 at every width) must
     have some, the ray-per-warp ones at 32 and 64 (march_split_kernel,
     FFMA) none; so must every X1 and X3 instantiation, and no X2 one);
  3. hold the kernel against its plain PyTorch version on the same CUDA
     tensors: csg_demo rays at 256x256 from Camera(rotation_y=30,
     rotation_x=-20), for the FP32 kernel's three kinds of call in the
     staged renderer (the coarse call of COARSE_FP32, refine rung 0, the
     terminal rung) and for the default coarse call (the three-pass chain
     at the config's coarse_eps, ``main_coarse_call``);
  4. drive the main path — ``Renderer(...).render`` with the staged
     mixed-precision config — at 1920x1080 with the csg_demo weights,
     counting kernel launches (the three-pass coarse call's, those a ray
     per warp and those of the normals' ``relu_tie_backward`` must not be
     0, the FP32 coarse call's must be), then the 256x256 golden render
     against examples/assets/csg_demo.png;
  5. time 10 warm 1080p frames beside 10 with the FP32 coarse call to 0.05
     (COARSE_FP32; in the order default, FP32, FP32, default); record the
     inputs of every march call of one more frame and hold the kernel
     against its plain version on each (the three-pass coarse pass over 2M
     rays and the retuned FP32 refine rungs); time the coarse pass (K2h)
     and the first refine rung (K1) both ways; the kernel's FP32 SDF
     against the model of its
     summation order, the plain chain and float64 (``tc_sdf_errors``);
     each call through the kernel a ray per thread and a ray per warp, each
     timed, the ray per warp equal to the plain version bit for bit, with
     the mode ``megakernel.ray_lanes`` picks (``compare_modes``), the
     terminal rung against its plain version, its bound and critical-path
     floor (``split_entry``); profile one more frame (device time per
     kernel, each march launch, the device's idle share);
  6. the CSG scenes at 1080p, each composed inside the kernel: csg_demo
     under neural_tanh, many_sphere (frame 90), many_sphere_cut (frame 90),
     many_cylinder_cut and displacement, and the 4-input anim_demo under
     many_sphere (frame 37). Per scene: a cold and a warm staged frame with
     the scene's kernel launches counted, the foreground checked, the
     median of 3 warm frames, kernel = plain version on every march call
     of one more frame, both modes on each (``compare_modes``), and the
     coarse pass timed both ways;
  7. the turntable: ``render_sequence`` over 24 frames of many_sphere
     (yaw and frame number i), twice; the second call must stay on the
     fast path and is timed; frames 0 and 23 against ``render_staged``;
     frame DEEP_FRAME's stats, each march call of it and its deepest lanes
     (``deep_lanes``: one lane grazes a surface and runs to max_steps);
  8. wide nets, each width at its SIZES: csg_demo widened to 64, 128, 256
     and 512 (``widen``), each driven through the staged path (1080p;
     512x512 at 256, 256x256 at 512) with its width's launches counted, the
     256x256 golden, the median of 3 warm frames (1 from 128 up), kernel =
     plain version on every march call of one more frame (a ray per
     thread the FP32 chain runs on the tensor cores, held to the TC_ bar;
     at 64 both modes on each call and the terminal rung's entry, as in
     phase 5, and launches a ray per warp on the main path), the coarse
     pass timed both ways beside its FP32 and 3xTF32 bounds, a profiled
     frame; the kernel's FP32 SDF against the model of its summation order
     (fused_mlp.mlp_chain_3xtf32_mma), the plain chain and float64
     (``tc_sdf_errors``); csg_demo widened to 1024 on bounded calls
     only (the coarse call and refine rung 0 at 128x128, launches counted,
     kernel = plain, the coarse call timed both ways): a staged frame's
     straggler tail would take tens of seconds at that width; many_sphere
     at 128 wide through phase 6's steps at 512x512;
  9. the fused forward (K3, 3xTF32 on the tensor cores) at widths
     32-1024: kernel vs plain version on 2^20 seeded points (2^18 at 1024;
     max |d| within K3_ATOL, both against float64, times beside the FP32
     and 3xTF32 bounds, L2 bytes per point), the plain chain on batch
     paddings of 256-65536 rows (PADDINGS) against the kernel bit for bit
     (information), then a dense ``render_image`` with ``use_pallas=True``
     (256x256; 64x64 at 512, 32x32 at 1024), its K3 launches counted,
     against ``use_pallas=False`` (K3_RENDER_ATOL, K3_RENDER_CLOSE);
 10. the precision ladder and the cold start: the three-pass chain (K2h)
     kernel vs plain version at widths 32-512 on 256x256 rays for the HIGH
     phase's three kinds of call, at 1024 on the cold coarse call at 64x64
     (its launches counted; bf16 MMA over a warp's rays, held to the
     kernel bar as TC_MIN_T_CLOSE and TC_STRAGGLERS relax it); its SDF,
     read off the kernel, against the plain chain at batch paddings and
     against float64 on 2^20 points (2^18 at 1024), beside the FP32
     chain's; both plain chains against the kernel at the row counts
     ROW_SWEEP and at powers of two (FP32 bit for bit, three-pass within
     K2H_SDF_ATOL); the default coarse_eps against ERR_FACTOR times the
     largest three-pass error over widths 32-1024 (raises below it); the
     ladder's other configs (``mid_eps=1e-3``, and COARSE_FP32) through the
     staged path at 1080p with the launches of their chain counted, against
     the default image, the golden, timed warm frames (1 for ``mid_eps``,
     3), kernel = plain on every march call of one more frame, and the
     main path's coarse call timed FP32 vs three-pass; ``mid_eps`` at
     256x256 at widths 64-512 with each width's
     three-pass launches counted; the cold-start kernel (K5,
     ``march_raygen``) on the 1080p coarse call at "default" and "high",
     its launches counted, against its plain version and against the ray
     build + init + ``march_state``, timed both ways; ``relax_newton`` and
     ``tail_pallas`` (with ``refine_pallas`` off) at 512x512 against the
     default image, the tail kernel's launches counted;
 11. the step-cost experiments X1-X3: each module's ``main()`` at the JAX
     scripts' sizes (cudaneuralrender_torch/benchmarks/exp_blockdiag.py,
     exp_stepcost.py, exp_stepcost2.py: ms and ns per lane-step), their
     kernels' launches counted; then each kernel held against its plain
     version where the outputs are finite and carry the SDF (X1 at 9 reps,
     X2 at the JAX sizes, X3's v0 at 1 step and the others at 8, v3-v5p
     from t0 = 0), each output within X_RTOL of its own magnitude (X2's
     lanes beyond it accounted for one by one and held against float64,
     ``x2_check``), each kernel
     (on the tensor cores) beside the model of its summation order
     (printed) and within the float64 witness bars of its plain version
     (``x_witness``); each plain version timed once at the JAX sizes, and
     X1's cuBLAS reps loop (``x1_library``);
 12. training on the card (cudaneuralrender_torch/diff) at 1920x1080 with
     csg_demo, the staged mixed config: the target the port's
     ``render_image_diff`` at Camera(rotation_y=24), the start csg_demo plus
     0.01 N(0,1) noise (a torch.Generator seeded 7); 2 warm and 5 timed
     steps of ``pixel_train_step_fast`` at Camera(rotation_y=20+2i), one
     stats dict shared: every timed step on the fast path through the
     packed grad step, the march kernel launched by the solve (launches a
     step), the loss along the gradient at a fixed solve (printed);
     the same 8 steps on the architecture distilled to a sphere, whose
     loss must fall (SPHERE_*); ``train_loop_fast`` over 8 steps from the
     same start equal to the 8 sequential steps (TRAIN_LOOP_RTOL); every
     march call of a solve of the trained weights against its plain
     version, its coarse call timed both ways, and the solve equal to one
     of the same weights loaded fresh; one ``pixel_loss`` gradient on the
     card against the CPU's (TRAIN_GRAD_RTOL); the step's solve and grad +
     update by CUDA events, the loop's amortized step, a profiled step's
     idle share and its host syncs; 20 ``sdf_train_step``s at batch 8192
     with the eikonal term; 3 dense ``pixel_train_step``s at 256x256;
 13. the render package (csg_demo, the 1080p staged config, Camera(rotation_x
     =-20, rotation_y=30+i), frame number i): the warm turntable, 24 frames
     cold and warm (``render_sequence(warm_start=True)``), frame 0 bit-equal,
     later frames at WARM_MIN_HIT_AGREE / WARM_MIN_EQUAL, ms/frame both ways,
     kernel = plain on every march call of a warm frame (the kernels line's
     ``march_kernel_warm``) and its coarse call timed beside the cold one's;
     fused chunks, the same 24 frames under neural_raw and many_sphere at
     ``chunk`` in CHUNKS (CUDA graphs), every image and stats vector equal to
     ``chunk=1`` bit for bit, one capture per key and the replays counted,
     ms/frame with the capture apart, a profiled chunk beside the per-frame
     path; matcap shading (benchmarks/recovered_matcaps/plane_1.png) and
     tetrahedron normals at 1080p beside the main path's frame, and the card
     against the port's CPU render at 256x256 at the mixed-path bar;
     ``render_frame_interactive``'s bytes equal to ``render_frame``'s at 1080p,
     both timed with the u32 and float32 fetches, the viewer on a free port
     answering VIEWER_REQUESTS frames; ``render_batch_staged`` over csg_demo
     and 4 noisy copies at 1080p, each frame equal to its ``render_staged``,
     pipelined against sequential, and ``render_batch`` at 128x128;
 14. parallel/ (csg_demo, the 1080p staged config, CAMERA): the sharded
     staged frame at SHARDS = 1, 2, 4, 8 logical shards of the card, each
     equal to ``render_staged``'s bit for bit (a ray per thread throughout
     too), its fast path, load stats and ms per frame
     (median of 3) beside the single-device frame; the 8-shard frame's
     kernel launches and, a ray per thread throughout, its agreement; the
     1- and 8-shard frames profiled (device busy, ops, idle share); shard
     0's march calls against the plain version and its coarse call timed
     (the kernels line's ``march_kernel_sharded``); ``solve_surface_sharded``
     + ``pixel_train_step_sharded`` on 4 shards against the unsharded step
     on the same solve (loss, the gradient within TRAIN_GRAD_RTOL of its
     norm), both timed; the fault drill, ``render_tiled`` in 4 bands with 2
     injected faults, equal to the fault-free bands bit for bit, each band
     execution's kernel launches counted; a 2-process gloo world on the
     card (``examples/multihost_drill.py`` at WORLD_SIDE: band and failover
     tiles equal to the single-process bands bit for bit, and with the
     global tiles against the single-process frames; the memo broadcast, the
     losses on both ranks); a world of one on NCCL (the global frame and the
     train step equal to the single-process ones); ``dryrun.run(4)``;
 15. the empty-space phases and the ReLU tie backward (csg_demo, the 1080p
     staged config, CAMERA): frames with ``prepass_factor=4`` and with
     ``grid_res=64`` (EMPTY_SPACE), each with its K1 launches counted, at
     the mixed bar against the default frame, kernel = plain version on
     every march call of a warm frame (the coarse call starts from the cone
     trace's or the grid walk's state; the kernels line's
     ``march_kernel_prepass`` / ``march_kernel_grid``), the median of 3
     beside the default's, the option's init alone by CUDA events (the
     renderer's ``_march_init``: the cone trace; the bake and the grid
     walk) and a profiled frame's idle share; a 24-frame warm
     turntable with ``grid_res=64`` against the cold one at the mixed bar;
     an EMPTY_SHARDS-shard ``grid_res=64`` frame equal to the unsharded
     one bit for bit; ``relu_tie_backward`` (csrc/elementwise.cu, the
     normals' backward since this phase's slice; phase 4 counts its
     main-path launches) against its plain version bit for bit on every
     call of a 1080p frame's normals, the frame's calls timed kernel /
     plain / ``threshold_backward`` beside the bytes bound, and
     ``benchmarks/relu_ties.py``'s frame variants (the tree, ``torch.relu``,
     the plain backward). The script's total wall time follows.
The line before the last is a JSON object of the kernels' launches, errors,
times and bounds; the last line is {"ok": true, "device": {...}}.
"""
import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cudaneuralrender_torch.utils.timing import card_line, time_cuda

# The FP32 march kernel's three kinds of call in the staged path: the coarse
# call of COARSE_FP32, refine rung 0 and the terminal rung: (name,
# march_eps, num_steps, relax_omega). The default coarse call (three-pass,
# the config's coarse_eps) is ``main_coarse_call``.
VARIANTS = (
    ("coarse", 0.05, None, 1.6),
    ("refine_rung0", 1e-6, 16, 0.0),
    ("terminal_rung", 1e-6, None, 1.6),
)
# Kernel vs plain where both sum the FP32 chain in input order (the
# ray-split mode's FFMA chain, cuBLAS in the plain version at its padded
# row counts): the bar of the JAX package's kernel against its reference
# (tests/test_pallas.py:49-72), where a ray sitting at the epsilon may
# converge one step apart.
MIN_CONV_AGREE = 0.999
MAX_T_ERR = 1e-4
MIN_RESOLVE_EQUAL = 0.99
CAMERA = dict(rotation_y=30.0, rotation_x=-20.0)
ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(ROOT, "examples", "assets", "csg_demo.npz")
ANIM_ASSET = os.path.join(ROOT, "examples", "assets", "anim_demo.npz")
GOLDEN = os.path.join(ROOT, "examples", "assets", "csg_demo.png")
# Phase 6: (kernel entry, scene, frame, asset, num_inputs, the TPU compose
# it replaces in cudaneuralrender_tpu/pallas/scenes.py).
SCENES = (
    ("compose_neural_tanh", "neural_tanh", 0.0, ASSET, 3, 133),
    ("compose_many_sphere", "many_sphere", 90.0, ASSET, 3, 57),
    ("compose_many_sphere_cut", "many_sphere_cut", 90.0, ASSET, 3, 57),
    ("compose_many_cylinder_cut", "many_cylinder_cut", 0.0, ASSET, 3, 71),
    ("compose_displacement", "displacement", 0.0, ASSET, 3, 120),
    ("compose_many_sphere_anim_demo", "many_sphere", 37.0, ANIM_ASSET, 4, 57),
)
TURNTABLE_FRAMES = 24
# Each padded hidden width's sizes. Width 32 is csg_demo itself (phases 3-5,
# 9, 10); the others are csg_demo widened H/32 times (``widen``, phases 8-10).
#   side: the K1 calls' image (phase 8's staged frame);
#   frames: its timed warm frames; reps: the timed runs of its coarse call
#     and of its K2h coarse call (the plain versions min(3, reps));
#   points: K3's points and the SDF checks' (phases 9, 10); render: the side
#     of the use_pallas render (phase 9); high_side: the K2h calls' side;
#   bounded: no staged frame, K1 on BOUNDED_VARIANTS and K2h on its cold
#     coarse call only.
# 512x512 at 256 and 256x256 at 512, whose staged frames take seconds; one
# timed frame from 128 up (frames vary by under 1%). At 1024 a staged
# frame's straggler tail would take tens of seconds and the chain is 7.3M
# fused multiply-adds a point: bounded calls, fewer points, smaller sides.
Sizes = collections.namedtuple("Sizes", "side frames reps points render high_side bounded")
SIZES = {
    32: Sizes((1920, 1080), 5, 5, 1 << 20, 256, 256, False),
    64: Sizes((1920, 1080), 3, 5, 1 << 20, 256, 256, False),
    128: Sizes((1920, 1080), 1, 5, 1 << 20, 256, 256, False),
    256: Sizes((512, 512), 1, 5, 1 << 20, 256, 256, False),
    512: Sizes((256, 256), 1, 2, 1 << 20, 64, 256, False),
    1024: Sizes((128, 128), 0, 1, 1 << 18, 32, 64, True),
}
WIDE = tuple(h for h in SIZES if h > 32)  # the widened nets
# Phase 5's smaller frames, timed in both modes (``mode_sweep``), each one's
# march calls timed mode against mode.
MODE_SIDES = ((1280, 720), (512, 512), (256, 256))
BOUNDED_VARIANTS = ("coarse", "refine_rung0")
# Phase 9's bar: FP32-grade sums in two orders (3xTF32 MMA in the kernel,
# cuBLAS FP32 in the plain version), the JAX package's own bar for its fused
# forward (tests/test_pallas.py:308).
K3_ATOL = 1e-5
# Phase 9's use_pallas render against the same render with use_pallas off:
# hit masks agree on >= 99.9% of pixels, and common hits within
# K3_RENDER_ATOL in rgba on >= K3_RENDER_CLOSE of them. The dense march
# converges at eps 1e-6, about what a float32 chain decides, so an SDF
# 1e-6 apart moves a ray sitting at the threshold to converge steps apart:
# a grazing ray then shades another point of the surface. On the H100 (700 W)
# the 256-wide render had 2 of 22234 common hits beyond the tolerance
# (0.99991 within, the largest difference 0.29), its masks equal; the share
# sits just outside that reading (11 pixels of 22234), the count beyond the
# tolerance and the largest difference are printed. The JAX bar, every
# common hit within 1e-4, is not met (PERF.md, PR 6).
K3_RENDER_ATOL = 1e-4
K3_RENDER_CLOSE = 0.9995
# Row counts of the plain chains' padding sweeps: cuBLAS sums a 256-wide
# layer in another order below 1024 rows and at 2625 rows and some above.
PADDINGS = (256, 512, 1024, 2048, 2640, 4096, 65536)
# Phase 10: the HIGH phase's three kinds of call, at eps HIGH_EPS:
# (name, num_steps, relax_omega). The coarse call (coarse_precision="high")
# starts cold; rung 0 and the terminal rung start from the refine entry of a
# three-pass coarse pass to 0.05.
HIGH_EPS = 1e-3
HIGH_VARIANTS = (("coarse", None, 1.6), ("rung0", 16, 0.0), ("terminal", None, 1.6))
# The FP32 coarse call to 0.05: the JAX package's ladder, the port's default
# before the H100's chain errors set it (utils/config.py).
COARSE_FP32 = dict(coarse_precision="default", coarse_eps=0.05)
# The ladder's other configs, rendered at 1080p with csg_demo: (name, fields,
# timed warm frames, the precision whose launches the config adds) (mid_eps
# leaves the fast path: ~10 s frames).
HIGH_CONFIGS = (("mid_eps", dict(mid_eps=1e-3), 1, "high"),
                ("coarse_fp32", COARSE_FP32, 3, "default"))
# The default coarse_eps over each width's three-pass SDF error (phase 10).
ERR_FACTOR = 10.0
# K5 against the ray build + init + kernel: the two builds of a ray differ
# by float32 ulps, which may move its convergence a step. The JAX package's
# bar (tests/test_pallas.py:324-361, a 32x32 image): converged flags agree
# on >= 99.5%, t within 1e-3 where both converged. Over the 2M rays of a
# 1080p frame a ray converging one relaxed step apart lands up to
# relax_omega * coarse_eps away, so there: t within 1e-3 on >= 99.9% of
# the common hits, and within relax_omega * coarse_eps on all (FP32). The
# three-pass chain's SDF moves by ~1e-5 with an ulp of its input (the bfloat16
# split), so more rays converge steps apart, and a grazing one stops
# eps / cos(angle) further along (0.156 at "high" on the H100): at "high"
# relax_omega * coarse_eps holds the rays that resolve at the same step in
# both, and the largest |dt| over all is printed.
RAYGEN_MIN_CONV_AGREE = 0.995
RAYGEN_MAX_T_ERR = 1e-3
RAYGEN_MIN_T_CLOSE = 0.999
ROW_SWEEP = range(1000, 4201, 16)  # the plain chains' row counts, against the kernel
OPTION_SIDE = 512  # relax_newton and tail_pallas frames
# The card's peaks for a kernel's bound (H100 SXM datasheet, 700 W):
# FP32 outside the tensor cores, bfloat16 in them (dense), and HBM.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# An FP32-accurate chain on the tensor cores takes three tf32 products per
# fused multiply-add (3xTF32, the redesigned K3): ``tc_bound_ms`` of a K3 or
# FP32-chain entry is its work at that rate, 0.406x its FFMA bound.
TF32_PASSES = 3
# The chains on the tensor cores sum in their own order: the three-pass
# chain (K2h) in one accumulator, where its plain version sums three float32
# products, and a ray per thread the FP32 chain (3xTF32, per k-chunk of 8,
# at every width) where its plain version (cuBLAS) sums in input order.
# Neither equals its plain version bit for bit. The three-pass kernel's SDF agrees with a model
# of its own summation order (fused_mlp.mlp_chain_3pass_mma; phase 10 prints
# the difference), and that model alone moves csg_demo's 9-layer SDF
# 2.6e-5 off the plain chain's over 65536 points on the CPU
# (tests/test_torch_mma.py); on the H100 the kernel's SDF is 3.5e-5 off over
# 2^20 points at width 32, less on the widened nets. So the kernel's SDF is
# held within K2H_SDF_ATOL of the plain chain's (phase 10's row sweep), and
# below 1e-3 against float64. The FP32 chain on the tensor cores is held
# within K1_MMA_SDF_ATOL of its plain chain at every point a replay visits,
# the fused forward's bar (K3, the same 3xTF32 products: 1.79e-6 off cuBLAS
# on the H100), and its march calls to the bar below.
#
# The march calls of a chain summed in the tensor cores' order (``tc_order``).
# At the HIGH phase's eps (1e-3), an SDF 3e-5 apart moves a
# ray sitting at the threshold to converge a step apart, or flips a relaxed
# step's fail test, far more often than FP32's 1e-7 did; a grazing ray then
# stops eps / cos(angle) further along, and the differences of each step add
# up along a ray that grazes for many steps. check_agreement's FP32 bar
# (every common hit within MAX_T_ERR in t, equal step counters) does not
# hold, so a three-pass call is held to it with:
#   * |dt| <= MAX_T_ERR on >= TC_MIN_T_CLOSE of the common hits (the
#     lowest readings on the H100, 700 W: 0.99592 over coarse_high's 1080p
#     call, 0.99428 over the ~1400 common hits of the card tests' 64x64
#     terminal call at width 64);
#   * |dt| <= the call's eps on every common hit that resolves at the same
#     step in both (largest reading 6.2e-4 at eps 1e-3; 0.0245 at the
#     cold-start call's eps 0.05);
#   * the lanes of either run that resolve past the other run's step counter
#     <= TC_STRAGGLERS of the lanes: on a run-to-dry call the counter is
#     the deepest lane's resolve step, one grazing straggler, which such a
#     difference moves by up to 9 steps (width 64, 70 against 79 on a
#     256x256 coarse call; the largest share read is 1 lane in 65536). Both
#     counters are printed;
#   * every lane outside these bars (flags or resolve steps unequal, or a
#     common hit more than MAX_T_ERR apart) replayed by the plain march with
#     the kernel's own SDF, read off the card at each point it visits
#     (``replay_beyond``): the replay must land on the kernel's results bit
#     for bit, and the two chains agree within the chain's SDF bar
#     (K2H_SDF_ATOL, K1_MMA_SDF_ATOL) at every point visited. A fault of the
#     march loop on any lane (the partial last warp, K5's pad lanes, a lane
#     class) fails there even where the shares pass.
# The shares sit just outside the three-pass readings of PR 6; the FP32
# chain on the tensor cores is held to the same bars, set before its first
# run on the card. One exception: on a call whose eps is at most
# UNDECIDED_EPS (the refine rungs' 1e-6) the two FP32 chains, ~1e-6 apart,
# cannot decide every convergence test, as XLA and torch on the CPU cannot
# (ROADMAP section 3). There, if resolve steps are equal on fewer than
# MIN_RESOLVE_EQUAL of the lanes or converged flags on fewer than
# MIN_CONV_AGREE, every lane whose resolve step or flag differs must part
# where float32 cannot decide a test (``undecided_lanes``; at most
# TC_STRAGGLERS of the call's lanes may part where the two states had
# drifted apart instead), each replay landing on its side's results, and
# the kernel's SDF on those lanes' paths as close to float64 as the plain
# chain's: mean |error| within WITNESS_MEAN times, max within WITNESS_MAX
# times (tests/test_torch_wide.py's float64 witness bar); and every common
# hit lies within MAX_T_ERR in t, the FP32 kernel bar, in place of eps on
# the rays resolving at the same step.
# Changed after the first card run of the FP32 chain on the tensor cores
# (NVIDIA H100, 700 W; PERF.md, PR 7), on the refine calls only:
#   * rays resolving at the same step ended up to 2.03e-6 apart in t
#     (width 128, 1080p, the first refine rung), past eps 1e-6: each step
#     moves t by the SDF, whose two sums differ by up to delta (~3e-7), and
#     along a grazing ray those differences add up. Hence MAX_T_ERR on
#     every common hit (the most read: 2.03e-5);
#   * converged flags agreed on 0.99810 (width 256, 512x512, the second
#     refine rung): on a bounded rung a ray that converges a step later
#     than in the other march is still active at the rung's end. Such lanes
#     are undecided ones, so the flags' share falls to undecided_lanes as
#     the resolve steps' does;
#   * 3 of 491520 lanes (width 128, 1080p, the third refine rung) and 1 of
#     65536 (width 256, 512x512, the same rung) parted where float32
#     decides the test on both sides: their points had drifted 2.3e-3 to
#     3.8e-5 apart over the 86-101 steps before, along rays leaving the
#     surface, where each step's difference grows (each side's test agrees
#     with float64 at its own point). Hence the TC_STRAGGLERS share.
K2H_SDF_ATOL = 5e-5
K1_MMA_SDF_ATOL = 1e-5
TC_MIN_T_CLOSE = 0.993
TC_STRAGGLERS = 1e-4
UNDECIDED_EPS = 1e-6
WITNESS_MEAN = 1.25
WITNESS_MAX = 2.0
K1_SOURCE = "cudaneuralrender_torch/csrc/march.cuh"
K3_SOURCE = "cudaneuralrender_torch/csrc/chain.cuh"
X_SOURCE = "cudaneuralrender_torch/csrc/experiments.cu"
# Phase 11: an experiment kernel against its plain version. Each output is
# held to its own magnitude: |kernel - plain| <= X_RTOL * (|plain| + scale),
# the scale being what an output of unit size becomes in that experiment
# (``x_scale``). X1-X3 run on the tensor cores, which sum in their own order
# (as K1, K2h and K3 do since their redesigns): the bit-equal share that
# held them while they summed in the plain version's order (at most 1e-5 of
# the outputs unequal) is replaced by the largest
# |kernel - the model of its order| (printed, on the first X_MODEL_LANES
# lanes; X2's at X2_MODEL_STEPS steps) and the float64 witness bars
# (``x_witness``): the kernel's |error| against float64 within WITNESS_MEAN
# times the plain version's on the mean and WITNESS_MAX times on the max,
# over X1's 9-rep outputs, over one step of X3 at X3_WITNESS_POINTS seeded
# points in [-1.2, 1.2]^3 (``x3_witness_rays``) and over one chain_only step
# of X2 at the same points, for each of its chains (``x2_float64``).
# X2 marches 64 steps at the JAX sizes, and there two float32 chains that
# differ by an ulp part on many lanes: rays that graze the surface and
# escape, whose t then grows to 1e18 (the step's SDF difference is
# amplified geometrically: no branch test parts them), tests near their
# thresholds (march_state, march_relax), and, for the three-pass chain,
# the bfloat16 split of each activation, which a 1-ulp change of it can
# move by 2^-17 of it. So X2's lanes beyond X_RTOL are accounted for one by
# one (``x2_beyond``), in the terms and to the bar of ``undecided_lanes``
# (``undecided_bar``), beside every X2_SAMPLE_STRIDE-th lane (the card tests
# take every lane): all of them marched again on both sides with a trace,
# each replay landing on its side's t bit for bit (the kernel's side on its
# own chain, read off the march kernel, whose chain X2 calls:
# ``kernel_sdf``); each chain on its side's replayed paths within
# WITNESS_MEAN / WITNESS_MAX of the plain chain's |error| against float64;
# the two chains within the chain's own SDF bar (K1_MMA_SDF_ATOL,
# K2H_SDF_ATOL) of (|plain| + 1) on every X2_SAMPLE_STRIDE-th point of the
# kernel's paths; and where a lane beyond first takes another branch, at
# most TC_STRAGGLERS of the lanes at a test float32 decides. A lane beyond
# that never takes another branch stands on the replay and the per-point
# bars: its kernel t is the plain steps' on a chain held at every point it
# visits. The replayed lanes' final t is also held against a float64 march
# (``t_witness``), printed and not held: a 64-step march amplifies each
# step's error on grazing rays, so that the ratio of two float32 marches'
# largest |t - t64| swings (1.1 to 2.5 on the CPU models), and K1's tf32
# chain, whose MMAs truncate their aligned products, drifts low along
# escaping rays: 1.54 times the plain version's mean on the H100 (PERF.md).
X_RTOL = 1e-5
X_MODEL_LANES = 1 << 16
X2_MODEL_STEPS = 8
X2_SAMPLE_STRIDE = 8
X3_WITNESS_POINTS = 1 << 16
X1_CHECK_REPS = 9  # one march step's layers: at 288 reps the outputs decay to 0
# X3's steps against the plain version: v0 overflows within 64 steps; the
# others' plain versions take seconds at 64 (the emulations 7-9 s).
X3_CHECK_STEPS = {"v0": 1}
X3_CHECK_STEPS_DEFAULT = 8


def widen(layers, k: int, seed: int) -> list:
    """A net k times as wide that computes the same function: (w [in, out],
    b [out]) float32 arrays in, the same out.

    Each hidden unit j becomes k copies. Copy c takes the incoming column
    a*W[:, j] and bias a*b[j] (a in [0.5, 2], seeded), so it outputs
    a*ReLU(z_j) = ReLU(a*z_j); its outgoing row is (s_c/a)*W_next[j, :], with
    seeded shares s_c > 0 summing to 1 over the copies. A seeded permutation
    then reorders each hidden layer's units. The result equals the original
    net up to float32 rounding, while no two copies share a weight or a
    position, so a kernel that mixes up rows, columns or chunks shows."""
    rng = np.random.default_rng(seed)
    ws = [np.asarray(w, np.float64) for w, _ in layers]
    bs = [np.asarray(b, np.float64) for _, b in layers]
    out_scale = None  # per input row of the current layer: s / a of the layer before
    perm_in = None
    result = []
    for i, (w, b) in enumerate(zip(ws, bs)):
        if out_scale is not None:  # expand and scale the rows, then permute them
            w = np.repeat(w, k, axis=0) * out_scale[:, None]
            w = w[perm_in]
        if i + 1 < len(ws):  # a hidden layer: expand, scale and permute its units
            n = w.shape[1]
            a = rng.uniform(0.5, 2.0, (n, k))
            s = rng.uniform(0.5, 1.5, (n, k))
            s /= s.sum(axis=1, keepdims=True)
            w = np.repeat(w, k, axis=1) * a.reshape(-1)[None, :]
            b = np.repeat(b, k) * a.reshape(-1)
            perm = rng.permutation(n * k)
            w, b = w[:, perm], b[perm]
            out_scale, perm_in = (s / a).reshape(-1), perm
        result.append((w.astype(np.float32), b.astype(np.float32)))
    return result


def sm_clock_mhz() -> float:
    """The card's SM clock now, in MHz (read right after a timed run)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


# Mangled kernel names and their labels: the march kernel, the forward
# kernel, then the experiment kernels X1-X3.
KERNEL_LABELS = (
    (r"march_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E",
     "march_kernel<H={}, scene={}, window={}, three_pass={}>"),
    (r"march_split_kernelILi(\d+)ELi(\d+)ELi(\d+)EE",
     "march_split_kernel<H={}, scene={}, window={}>"),
    (r"mlp_forward_kernelILi(\d+)E", "mlp_forward_kernel<H={}>"),
    (r"x1_loop_kernelILi(\d+)E", "x1_loop_kernel<H={}>"),
    (r"x2_stepcost_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
     "x2_stepcost_kernel<H={}, chain={}, variant={}>"),
    (r"x3_ablation_kernelILi(\d+)ELi(\d+)E", "x3_ablation_kernel<H={}, variant={}>"),
    (r"relu_tie_backward_kernel", "relu_tie_backward_kernel"),
)


def ptxas_table(log: str) -> list:
    """One (kernel, registers, stack bytes, spill stores, spill loads) row
    per entry function in ptxas's -v report; march_kernel<H, scene,
    window, three_pass>, mlp_forward_kernel<H> and the experiment kernels
    X1-X3 named by their template arguments."""
    import re

    rows, names, cur = {}, [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            cur = m.group(1)
            if cur not in rows:
                rows[cur] = [None, None, None, None]
                names.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur in rows:
            rows[cur][1:] = [int(v) for v in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur in rows:
            rows[cur][0] = int(m.group(1))
    out = []
    for name in names:
        for pattern, fmt in KERNEL_LABELS:
            m = re.search(pattern, name)
            if m:
                out.append((fmt.format(*m.groups()), *rows[name]))
                break
    return out


def sass_counts(library: str, opcode: str) -> dict:
    """How many ``opcode`` instructions each kernel of the built library has
    in its SASS (``cuobjdump -sass``), by the labels of ``ptxas_table``."""
    import re

    from cudaneuralrender_torch.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          timeout=600, check=True)
    counts, cur = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = None
            for pattern, fmt in KERNEL_LABELS:
                k = re.search(pattern, m.group(1))
                if k:
                    cur = fmt.format(*k.groups())
                    counts[cur] = 0
        elif cur is not None and re.search(rf"\b{opcode}\b", line):
            counts[cur] += 1
    return counts


def chain_fmas(hidden: int, n_layers: int, n_in: int) -> int:
    """Fused multiply-adds of one chain evaluation at padded width H: the
    true n_in-input first layer, n_layers - 2 hidden layers, the 1-column
    head (3H + 7H^2 + H for the 9-layer nets)."""
    return n_in * hidden + (n_layers - 2) * hidden * hidden + hidden


def bound(fmas: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS) -> dict:
    """The least time the card could take: the larger of the work at the
    card's peak for its type (FP32 unless ``peak_flops`` says otherwise)
    and the bytes at its memory rate. An FP32 bound also gives
    ``tc_bound_ms``, the same work and bytes at the 3xTF32 rate."""
    ops_ms = 2.0 * fmas / peak_flops * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    out = dict(bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    if peak_flops == PEAK_FP32_FLOPS:
        out["tc_bound_ms"] = max(tc_bound_ms(fmas), bytes_ms)
    return out


def forward_tile_points(hidden: int) -> int:
    """Points a block of the fused forward owns (csrc/chain.cuh
    ForwardTile::kPoints)."""
    return 128 if hidden <= 64 else (64 if hidden <= 512 else 32)


def tc_bound_ms(fmas: float) -> float:
    """The least time of ``fmas`` FP32-accurate fused multiply-adds on the
    tensor cores: TF32_PASSES tf32 products each at PEAK_TF32_FLOPS."""
    return TF32_PASSES * 2.0 * fmas / PEAK_TF32_FLOPS * 1e3


def kernel_entry(name, source, replaces, launches, max_abs_err, ms, plain_ms, bnd) -> dict:
    """One entry of the kernels line; no single PyTorch call computes a
    march or a fused chain, so ``library_ms`` is null. A ``bnd`` with a
    ``tc_bound_ms`` (K3 and the FP32 chain) carries it into the entry."""
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, **bnd, library_ms=None)


def wide_params(cnr, k: int, dev, asset: str = ASSET):
    """``asset``'s net (csg_demo's by default) widened k times (``widen``)
    on ``dev``, tagged for the schedule memo as a geometry of its own."""
    from cudaneuralrender_torch.utils import memo

    layers = cnr.mlp.to_numpy_params(cnr.load(asset, device="cpu"))
    params = cnr.from_numpy_params(widen(layers, k, seed=k) if k > 1 else layers, device=dev)
    memo.tag_geometry(params, f"{asset} widened x{k}")
    return params


def refine_entry(state, origin, dirs, config):
    """The refine phase's entry: near set (converged or active) re-marked
    active, converged cleared, budget rebuilt as tfar - (t - tnear)."""
    from cudaneuralrender_torch.ops import march

    near = state.converged | state.active
    tnear, tfar, bhit = march.intersect_sphere(
        origin, dirs, config.bound_center, config.bound_radius)
    budget = torch.where(bhit, tfar - (state.t - torch.clamp(tnear, min=0.0)), 0.0)
    return march.MarchState(t=state.t, budget=budget, active=near,
                            converged=torch.zeros_like(near), steps=state.steps)


def agreement(kernel_out, plain_out) -> dict:
    """How a march call's kernel and plain results agree."""
    (k, k_steps), (p, p_steps) = kernel_out, plain_out
    both = k.converged & p.converged
    dt = (k.t - p.t).abs()
    err, same = dt[both], dt[both & (k_steps == p_steps)]
    return dict(
        conv_agree=(k.converged == p.converged).float().mean().item(),
        max_abs_err=err.max().item() if err.numel() else 0.0,
        max_abs_err_same_step=same.max().item() if same.numel() else 0.0,
        t_close=(err <= MAX_T_ERR).float().mean().item() if err.numel() else 1.0,
        resolve_equal=(k_steps == p_steps).float().mean().item(),
        new_steps=(int(k.steps), int(p.steps)),
        stragglers=max(int((k_steps > p.steps).sum()), int((p_steps > k.steps).sum()))
        / k_steps.numel(),
        n_converged=int(both.sum()),
        tc_order=False,
    )


def tc_agreement(params, call, kernel_out, plain_out) -> dict:
    """``agreement`` of a call whose chain sums in the tensor cores' order
    (the three-pass chain; the FP32 chain a ray per thread), which
    ``check_agreement`` holds to the TC_ bar: with the call's eps, the
    chain's SDF bar and ``replay_beyond``'s witness; and, on a call at eps
    <= UNDECIDED_EPS whose resolve steps are equal on fewer than
    MIN_RESOLVE_EQUAL of the lanes or converged flags on fewer than
    MIN_CONV_AGREE, ``undecided_lanes`` of the kernel's chain against the
    plain one. ``call`` is (origin, dirs, state, config,
    frame, march_state's keywords)."""
    from cudaneuralrender_torch.kernels import megakernel

    _, _, _, config, frame, kw = call
    precision = kw.get("precision", "highest")
    eps = config.march_eps if kw.get("march_eps") is None else kw["march_eps"]
    a = dict(agreement(kernel_out, plain_out), tc_order=True, eps=eps,
             sdf_atol=K2H_SDF_ATOL if precision == "high" else K1_MMA_SDF_ATOL,
             **replay_beyond(params, call, kernel_out, plain_out))
    if eps <= UNDECIDED_EPS and (a["resolve_equal"] < MIN_RESOLVE_EQUAL
                                 or a["conv_agree"] < MIN_CONV_AGREE):
        compose = megakernel._compose(config, kw.get("cyl_window"))
        a["undecided"] = undecided_lanes(
            params, call, (kernel_chain(params, precision, frame), None),
            (kernel_out, plain_out),
            lambda pts: compose(pts.double(), sdf_float64(params, pts, frame), frame))
    return a


def call_lanes(params, call) -> int:
    """The lanes a ray that ``megakernel.ray_lanes`` picks for a call."""
    from cudaneuralrender_torch.kernels import fused_mlp, megakernel

    kw = call[5]
    return megakernel.ray_lanes(fused_mlp.packed_params(params)[3],
                                kw.get("precision", "highest"), kw.get("num_steps"),
                                kw.get("coarse", False))


def call_agreement(params, call, kernel_out, plain_out) -> dict:
    """How a march call's kernel and plain results agree, by the bar of the
    chain the call ran (its mode, ``call_lanes``): ``tc_agreement`` where
    the kernel sums it on the tensor cores (``megakernel.tensor_core_chain``),
    else ``agreement``."""
    from cudaneuralrender_torch.kernels import fused_mlp, megakernel

    hidden = fused_mlp.packed_params(params)[3]
    if megakernel.tensor_core_chain(hidden, call[5].get("precision", "highest"),
                                    call_lanes(params, call)):
        return tc_agreement(params, call, kernel_out, plain_out)
    return agreement(kernel_out, plain_out)


@contextlib.contextmanager
def uncounted():
    """March-kernel launches inside the block leave the launch counts as
    they were: a check's own calls are not the main path's."""
    from cudaneuralrender_torch.kernels import megakernel

    tables = ("SCENE_LAUNCHES", "WIDTH_LAUNCHES", "PRECISION_LAUNCHES", "THREE_PASS_LAUNCHES",
              "SPLIT_LAUNCHES")
    saved = (megakernel.KERNEL_LAUNCHES, megakernel.RAYGEN_LAUNCHES,
             {name: dict(getattr(megakernel, name)) for name in tables})
    try:
        yield
    finally:
        megakernel.KERNEL_LAUNCHES, megakernel.RAYGEN_LAUNCHES = saved[0], saved[1]
        for name, counts in saved[2].items():
            getattr(megakernel, name).update(counts)


def kernel_chain(params, precision: str, frame: float = 0.0, on_call=None):
    """The kernel's chain at a precision as ``march_state_plain`` takes a
    chain (x [T, H] -> [T, H], the head in column 0): its SDF read off the
    card a ray per thread (``kernel_sdf``) at the rows' points.
    ``on_call(x, d)``, if given, sees each call's inputs and heads."""
    def chain(x):
        d = kernel_sdf(params, x[:, :3], precision, frame)
        if on_call is not None:
            on_call(x, d)
        out = torch.zeros_like(x)
        out[:, 0] = d
        return out

    return chain


def replay_beyond(params, call, kernel_out, plain_out) -> dict:
    """The lanes of a tensor-core call outside ``check_agreement``'s bars
    (converged flags or resolve steps unequal, or a common hit more than
    MAX_T_ERR apart in t), marched again by the plain version with the
    kernel's own chain in place of the plain one (``kernel_chain``, at the
    call's precision), the plain chain's beside it. Returns the lanes
    replayed, whether the replay lands on the kernel's t, flags and resolve
    steps bit for bit, and the largest |difference| of the two chains over
    the points visited."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import march

    origin, dirs, state, config, frame, kw = call
    (k, k_steps), (p, p_steps) = kernel_out, plain_out
    both = k.converged & p.converged
    beyond = ((k.converged != p.converged) | (k_steps != p_steps)
              | (both & ((k.t - p.t).abs() > MAX_T_ERR)))
    idx = beyond.nonzero().squeeze(1)
    if idx.numel() == 0:
        return dict(replayed=0, replay_equal=True, chain_max_diff=0.0)
    precision = kw.get("precision", "highest")
    plain_chain = megakernel._chain_plain(params, precision)
    worst = [0.0]

    def compare(x, d):
        worst[0] = max(worst[0], (plain_chain(x)[:, 0] - d).abs().max().item())

    sub = march.MarchState(t=state.t[idx], budget=state.budget[idx], active=state.active[idx],
                           converged=state.converged[idx], steps=state.steps)
    with uncounted():
        r, r_steps = megakernel.march_state_plain(
            params, origin, dirs[idx], sub, config, frame,
            chain=kernel_chain(params, precision, frame, compare),
            **dict(kw, return_resolve=True))
    equal = (torch.equal(r.t, k.t[idx]) and torch.equal(r.converged, k.converged[idx])
             and torch.equal(r_steps, k_steps[idx]))
    return dict(replayed=int(idx.numel()), replay_equal=equal, chain_max_diff=worst[0])


def march_trace(params, call, chain, lanes) -> tuple:
    """The plain march of ``call``'s ``lanes`` with ``chain`` in place of
    the plain one: ((state, resolve steps), the per-step records of
    ``march_state_plain``'s ``trace``, whose ``idx`` index ``lanes``)."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import march

    origin, dirs, state, config, frame, kw = call
    sub = march.MarchState(t=state.t[lanes], budget=state.budget[lanes],
                           active=state.active[lanes], converged=state.converged[lanes],
                           steps=state.steps)
    steps = []
    with uncounted():
        out = megakernel.march_state_plain(params, origin, dirs[lanes], sub, config, frame,
                                           chain=chain, trace=steps.append,
                                           **dict(kw, return_resolve=True))
    return out, steps


# The tests of a march step, in the order undecided_lanes reads a parting.
STEP_TESTS = ("fail", "miss", "conv")


def _step_margins(s, rows, eps: float, omega: float) -> torch.Tensor:
    """[3, n]: how far the float64 distance ``s["s64"]`` lies from each
    test's threshold at the step record ``s``'s ``rows``, in distance
    units: the relaxed step's fail test d + prev_r < step_len (infinite
    where step_len <= prev_r, which no distance decides), the miss test
    budget - step <= 0 (the step is d or omega * d), and d < eps."""
    d64 = s["s64"][rows]
    prev_r, step_len, budget = (s[k][rows].double() for k in ("prev_r", "step_len", "budget"))
    fail = torch.where(step_len > prev_r, (d64 + prev_r - step_len).abs(),
                       torch.full_like(d64, float("inf")))
    scale = torch.ones_like(d64)
    if omega > 1.0:
        scale = torch.where(s["near"][rows] | (step_len < 0.0), scale, scale * omega)
    return torch.stack([fail, (budget / scale - d64).abs(), (d64 - eps).abs()])


def undecided_lanes(params, call, chains, outs, sdf64) -> dict:
    """Where two marches of one call part, and whether float32 could decide
    it: ``chains`` (a, b), each side's chain as ``march_state_plain`` takes
    it; ``outs`` ((state, resolve steps) of a, then of b), what each side's
    march gave; ``sdf64``, points [n, 3] -> the scene's distance in float64.

    Each lane whose resolve step or converged flag differs is marched again
    on both sides (``march_trace``), and each replay must land on its
    side's results bit for bit. At the first step where the two take
    another branch (STEP_TESTS: the relaxed step's fail test, the miss
    test, convergence), float32 cannot decide the test if on either side
    the float64 distance lies within delta of its threshold; delta is the
    larger of the two chains' max |distance - float64| over the points the
    replays visit (a subset of the call's points, so no larger than the
    whole call's). A lane that parts where float32 decides both sides'
    tests is ``decided``: its two states had drifted apart (each side's
    test agrees with float64 at its own state), and ``decided_detail``
    gives, for up to 20 such lanes, the step, the test, both margins and
    how far apart the two sides' points and budgets were. A lane whose
    replays never part is ``unparted``: a fault. Returns the counts, delta,
    each chain's mean and max error there, and the parting tests."""
    config, kw = call[3], call[5]
    (a, ra), (b, rb) = outs
    lanes = ((ra != rb) | (a.converged != b.converged)).nonzero().squeeze(1)
    result = dict(lanes=int(lanes.numel()), n_call=int(ra.numel()), n_decided=0, decided=[],
                  decided_detail=[], n_unparted=0, delta=0.0, replay_equal=True,
                  err_mean=[0.0, 0.0], err_max=[0.0, 0.0],
                  parted_by=dict.fromkeys(STEP_TESTS, 0))
    if lanes.numel() == 0:
        return result
    eps = config.march_eps if kw.get("march_eps") is None else kw["march_eps"]
    omega = float(kw.get("relax_omega") or 0.0)
    runs = []
    for side, (chain, (o, r)) in enumerate(zip(chains, outs)):
        (ro, rr), steps = march_trace(params, call, chain, lanes)
        result["replay_equal"] &= (torch.equal(ro.t, o.t[lanes])
                                   and torch.equal(ro.converged, o.converged[lanes])
                                   and torch.equal(rr, r[lanes]))
        for s in steps:
            s["s64"] = sdf64(s["pts"])
        err = torch.cat([(s["d"].double() - s["s64"]).abs() for s in steps])
        result["err_mean"][side], result["err_max"][side] = err.mean().item(), err.max().item()
        runs.append({s["step"]: s for s in steps})
    result["delta"] = max(result["err_max"])
    part_lanes(runs, lanes, eps, omega, result)
    return result


def part_lanes(runs, lanes, eps: float, omega: float, result: dict,
               among=None) -> torch.Tensor:
    """Where the two marches ``runs`` (each side's step records by step, as
    ``march_state_plain``'s ``trace`` gives them, with the float64 distance
    ``s64`` at each record's points) of ``lanes`` first take another branch
    (STEP_TESTS), and whether float32 could decide it: undecided where on
    either side the float64 distance lies within delta of the test's
    threshold. delta is ``result["delta"]``, or where that is None the
    larger of the two chains' |distance - float64| (``err``) at the lane's
    two points of that step. Fills ``result``: the partings by test, the
    decided lanes (up to 20, and ``decided_detail``) and their count, and
    the count of lanes that never part; only over the ``lanes`` that the
    mask ``among`` picks, where one is given. Returns which of ``lanes``
    part."""
    n, dev = lanes.numel(), lanes.device
    skip = torch.zeros(n, dtype=torch.bool, device=dev) if among is None else ~among
    parted = torch.zeros(n, dtype=torch.bool, device=dev)
    undecided = torch.zeros(n, dtype=torch.bool, device=dev)
    for step in sorted(set(runs[0]) & set(runs[1])):
        recs, rows = (runs[0][step], runs[1][step]), []
        for s in recs:  # each side's record row of every lane, -1 where it does not march
            row = torch.full((n,), -1, dtype=torch.long, device=dev)
            row[s["idx"]] = torch.arange(s["idx"].numel(), device=dev)
            rows.append(row)
        live = ((rows[0] >= 0) & (rows[1] >= 0) & ~parted & ~skip).nonzero().squeeze(1)
        if live.numel() == 0:
            continue
        ia, ib = rows[0][live], rows[1][live]
        tests = [torch.stack([s["sor_fail"][i], s["moved"][i], s["moved"][i] & s["near"][i]])
                 for s, i in zip(recs, (ia, ib))]
        differ = tests[0] != tests[1]  # [3, live]
        split = differ.any(dim=0)
        if not split.any():
            continue
        which = differ.float().argmax(dim=0)[split]  # the first test that differs
        margins = [_step_margins(s, i[split], eps, omega).gather(0, which[None])[0]
                   for s, i in zip(recs, (ia, ib))]
        margin = torch.minimum(*margins)
        if result["delta"] is None:
            delta = torch.maximum(recs[0]["err"][ia[split]], recs[1]["err"][ib[split]])
        else:
            delta = torch.full_like(margin, result["delta"])
        for k, name in enumerate(STEP_TESTS):
            result["parted_by"][name] += int((which == k).sum())
        parted[live[split]] = True
        undecided[live[split]] = margin <= delta
        for j in (margin > delta).nonzero().squeeze(1).tolist():
            if len(result["decided_detail"]) < 20:
                ja, jb = int(ia[split][j]), int(ib[split][j])
                result["decided_detail"].append(dict(
                    lane=int(lanes[live[split][j]]), step=step,
                    test=STEP_TESTS[int(which[j])],
                    margins=[float(m[j]) for m in margins], delta=float(delta[j]),
                    point_apart=float((recs[0]["pts"][ja] - recs[1]["pts"][jb]).norm()),
                    budget_apart=float((recs[0]["budget"][ja] - recs[1]["budget"][jb]).abs())))
    decided = lanes[parted & ~undecided]
    result["n_decided"], result["decided"] = int(decided.numel()), decided[:20].tolist()
    result["n_undecided"] = int((parted & undecided).sum())
    result["n_unparted"] = int((~parted & ~skip).sum())
    return parted


def variant_calls(params, config, origin, dirs, frame=0.0, variants=None) -> list:
    """The staged path's calls of each variant (of ``variants``, all by
    default) on these rays, each starting from the plain version's output
    of the one before (the coarse call composes with
    ``config.cyl_window_coarse`` and marches a ray per thread, as the
    staged renderer's does):
    [(name, call, the plain output with resolve steps)], a call being
    (origin, dirs, state, config, frame, march_state's keywords)."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import march

    state = march.init_state(origin, dirs, config.bound_center, config.bound_radius)
    out = []
    for name, eps, num_steps, omega in VARIANTS:
        if variants is not None and name not in variants:
            continue
        if name == "refine_rung0":
            state = refine_entry(state, origin, dirs, config)
        kw = dict(march_eps=eps, num_steps=num_steps, relax_omega=omega, return_resolve=True,
                  cyl_window=config.cyl_window_coarse if name == "coarse" else None,
                  coarse=name == "coarse")
        p = megakernel.march_state_plain(params, origin, dirs, state, config, frame, **kw)
        out.append((name, (origin, dirs, state, config, frame, kw), p))
        state = p[0]
    return out


def main_coarse_call(params, config, origin, dirs, frame=0.0) -> dict:
    """The staged path's coarse call at ``config``'s ladder (its
    ``coarse_precision`` and ``coarse_eps``, the three-pass chain by
    default) from the cold start, through the kernel and the plain version:
    {"coarse_main": agreement dict}, by the bar of its chain."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import march

    state = march.init_state(origin, dirs, config.bound_center, config.bound_radius)
    kw = dict(march_eps=config.coarse_eps, precision=config.coarse_precision,
              relax_omega=config.relax_omega, return_resolve=True,
              cyl_window=config.cyl_window_coarse, coarse=True)
    call = (origin, dirs, state, config, frame, kw)
    return {"coarse_main": call_agreement(
        params, call, megakernel.march_state(params, *call[:5], **kw),
        megakernel.march_state_plain(params, *call[:5], **kw))}


def compare_kernel_with_plain(params, config, origin, dirs, frame=0.0, variants=None):
    """Run each variant (``variant_calls``) through the kernel and the plain
    version on the same inputs. Returns {variant: agreement dict}."""
    from cudaneuralrender_torch.kernels import megakernel

    result = {}
    for name, call, p in variant_calls(params, config, origin, dirs, frame, variants):
        result[name] = call_agreement(params, call, megakernel.march_state(params, *call[:5],
                                                                           **call[5]), p)
    return result


def split_equal(params, call, plain_out=None) -> tuple:
    """``call`` through the kernel a ray per warp (``_ray_lanes`` =
    SPLIT_LANES: the FFMA chain, each output summed in input order),
    uncounted, against the plain version's output ``plain_out`` (run here
    if not given): raises unless t, budget, the active and converged flags,
    the lane steps and the step counter are equal bit for bit. Returns both
    outputs, (state, lane steps) each, the kernel's first."""
    from cudaneuralrender_torch.kernels import megakernel

    origin, dirs, state, config, frame, kw = call
    kw = dict(kw, return_resolve=True)
    with uncounted():
        a, sa = megakernel.march_state(params, origin, dirs, state, config, frame,
                                       _ray_lanes=megakernel.SPLIT_LANES, **kw)
    if plain_out is None:
        plain_out = megakernel.march_state_plain(params, origin, dirs, state, config, frame, **kw)
    b, sb = plain_out
    fields = dict(t=(a.t.view(torch.int32), b.t.view(torch.int32)),
                  budget=(a.budget.view(torch.int32), b.budget.view(torch.int32)),
                  active=(a.active, b.active), converged=(a.converged, b.converged),
                  lane_steps=(sa, sb), steps=(a.steps, b.steps))
    unequal = {name: int((x != y).sum()) for name, (x, y) in fields.items()
               if not torch.equal(x, y)}
    if unequal:
        raise RuntimeError(f"a ray per warp differs from the plain version on "
                           f"{dirs.shape[0]} lanes (lanes unequal by field): {unequal}")
    return (a, sa), (b, sb)


def lane_utilisation(state, lane_steps) -> float:
    """A ray-per-thread call's share of busy lanes: its ray-steps over 32
    times the sum of each warp's deepest ray-steps (warps are 32
    consecutive lanes)."""
    act = state.active
    steps = torch.where(act, lane_steps.long() - int(state.steps), 0)
    steps = torch.cat([steps, steps.new_zeros((-steps.numel()) % 32)]).view(-1, 32)
    return float(steps.sum()) / max(1, 32 * int(steps.max(dim=1).values.sum()))


def floor_ms(deepest: int, hidden: int, n_layers: int, n_in: int, sm_mhz: float) -> float:
    """The ray-split chain's critical-path floor for a ray marching
    ``deepest`` steps: each output summed in input order from zero, so a
    step waits on n_in fused multiply-adds, then (H + 1) dependent
    operations a hidden layer and H + 1 for the head (H products, the bias;
    267 at width 32, 523 at 64 for the 9-layer nets), 4 cycles each at the
    SM clock."""
    ops = n_in + (n_layers - 2) * (hidden + 1) + hidden + 1
    return deepest * ops * 4 / (sm_mhz * 1e3)


def compare_modes(params, calls, tag: str, card: str, plains=None) -> list:
    """Every recorded call of an FP32 chain at width 32 or 64 through the
    kernel in both modes, each mode timed by CUDA events (median of 3 after
    a warm-up), one line per call with the mode ``megakernel.ray_lanes``
    picks for it; a ray per warp held to the plain version bit for bit
    (``split_equal``, against ``plains[i]``, the plain output of call i,
    where given); the coarse call's lane utilisation a ray per thread.
    Returns a row per call: n, active, ray-steps, deepest, ms by mode,
    picked."""
    from cudaneuralrender_torch.kernels import fused_mlp, megakernel

    hidden = fused_mlp.packed_params(params)[3]
    rows = []
    for i, call in enumerate(calls):
        origin, dirs, state, config, frame, kw = call
        precision = kw.get("precision", "highest")
        if not megakernel.split_chain(hidden, precision):
            continue
        _, (_, lane_steps) = split_equal(params, call, None if plains is None else plains[i])
        act = state.active
        steps = lane_steps.long() - int(state.steps)
        n = dirs.shape[0]
        with uncounted():
            ms = {lanes: time_cuda(lambda: megakernel.march_state(
                params, origin, dirs, state, config, frame, _ray_lanes=lanes, **kw), 3, 1)
                for lanes in (1, megakernel.SPLIT_LANES)}
        row = dict(call=i, n=n, num_steps=kw.get("num_steps"), eps=kw.get("march_eps"),
                   active=int(act.sum()), ray_steps=int(steps[act].sum()),
                   deepest=int(steps[act].max()) if bool(act.any()) else 0,
                   thread_ms=ms[1], split_ms=ms[megakernel.SPLIT_LANES],
                   picked=call_lanes(params, call))
        if i == 0:
            row["lane_util"] = lane_utilisation(state, lane_steps)
        rows.append(row)
        print(f"modes {tag} width {hidden} call{i} n={n} steps={row['num_steps']} "
              f"eps={row['eps']}: {row['active']} active, {row['ray_steps']} ray-steps, deepest "
              f"{row['deepest']}; a ray per thread {ms[1]:.3f} ms, a ray per warp "
              f"{row['split_ms']:.3f} ms (= plain bit for bit); ray_lanes picks {row['picked']}"
              + (f"; lane utilisation a ray per thread {row['lane_util']:.4f}" if i == 0 else "")
              + f" [{card}]", flush=True)
    return rows


def split_entry(params, calls, rows, launches: int, card: str) -> dict:
    """The kernels line's entry of the ray-split mode at this width: the
    frame's terminal rung (its last call) a ray per warp, its plain
    version's time, its bound (the ray-steps' fused multiply-adds at the
    FP32 peak, or its bytes) and ``floor_ms``, the chain's critical path
    along its deepest ray."""
    from cudaneuralrender_torch.kernels import fused_mlp, megakernel

    origin, dirs, state, config, frame, kw = calls[-1]
    row = rows[-1]
    if kw.get("num_steps") is not None or row["call"] != len(calls) - 1:
        raise RuntimeError(f"the frame's last march call is not the terminal rung: {kw}")
    weights, biases, n_in, hidden = fused_mlp.packed_params(params)
    sm_mhz = sm_clock_mhz()
    kw = dict(kw, return_resolve=True)
    outs = {}

    def plain():
        outs["plain"] = megakernel.march_state_plain(params, origin, dirs, state, config, frame,
                                                     **kw)

    plain_ms = time_cuda(plain, 1)
    with uncounted():
        k = megakernel.march_state(params, origin, dirs, state, config, frame,
                                   _ray_lanes=megakernel.SPLIT_LANES, **kw)
    a = agreement(k, outs["plain"])
    check_agreement({"terminal rung, a ray per warp": a})
    n = dirs.shape[0]
    bnd = bound(row["ray_steps"] * chain_fmas(hidden, weights.shape[0], n_in),
                n * (12 + 4 + 4 + 1) + n * (4 + 4 + 1 + 1 + 4)
                + 4 * (weights.numel() + biases.numel()))
    floor = floor_ms(row["deepest"], hidden, weights.shape[0], n_in, sm_mhz)
    print(f"width {hidden} terminal rung ({n} lanes, {row['active']} active, deepest "
          f"{row['deepest']} steps): a ray per warp {row['split_ms']:.3f} ms, a ray per thread "
          f"{row['thread_ms']:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms "
          f"(FP32), critical-path floor {floor:.3f} ms at {sm_mhz:.0f} MHz [{card}]", flush=True)
    return dict(kernel_entry(f"march_kernel_split_h{hidden}", K1_SOURCE,
                             "cudaneuralrender_tpu/pallas/megakernel.py:45", launches,
                             a["max_abs_err"], row["split_ms"], plain_ms, bnd), floor_ms=floor)


def undecided_bar(u: dict, unparted_ok: bool = False) -> list:
    """What breaks the bar of ``undecided_lanes`` on a kernel (side a)
    against its plain version (side b): an unparted lane (but where
    ``unparted_ok``: X2's lanes beyond X_RTOL, ``x2_beyond``), more lanes
    parting where float32 decides the test (their states drifted apart)
    than TC_STRAGGLERS of the call's lanes, a replay off its side's
    results, or a kernel chain further from float64 than WITNESS_MEAN /
    WITNESS_MAX times the plain chain."""
    bad = []
    if u["n_unparted"] and not unparted_ok:
        bad.append(f"{u['n_unparted']} of the {u['lanes']} differing lanes never part in the "
                   "replays")
    if u["n_decided"] > TC_STRAGGLERS * u["n_call"]:
        delta = "per lane" if u["delta"] is None else f"{u['delta']:.3g}"
        bad.append(f"{u['n_decided']} of the {u['n_call']} lanes part where float32 decides "
                   f"(delta {delta}) > {TC_STRAGGLERS} of them: {u['decided_detail'][:3]}")
    if not u["replay_equal"]:
        bad.append("a replay of the differing lanes does not land on its side's results")
    (km, pm), (kx, px) = u["err_mean"], u["err_max"]
    if km > WITNESS_MEAN * pm or kx > WITNESS_MAX * px:
        bad.append(f"|SDF - float64| on the differing lanes' paths: kernel mean {km:.3g} max "
                   f"{kx:.3g}, plain mean {pm:.3g} max {px:.3g}")
    return bad


def check_agreement(result: dict) -> None:
    """Raise unless every call meets the kernel bar (a call summed in the
    tensor cores' order as the TC_ constants and its SDF bar set it)."""
    for name, a in result.items():
        tc_order = a["tc_order"]
        refine = tc_order and a["eps"] <= UNDECIDED_EPS
        bad = []
        if "undecided" in a:  # the refine rungs' exception (UNDECIDED_EPS)
            bad.extend(undecided_bar(a["undecided"]))
        else:
            if a["conv_agree"] < MIN_CONV_AGREE:
                bad.append(f"converged flags agree on {a['conv_agree']:.5f} < {MIN_CONV_AGREE}")
            if a["resolve_equal"] < MIN_RESOLVE_EQUAL:
                bad.append(f"resolve steps equal on {a['resolve_equal']:.5f} "
                           f"< {MIN_RESOLVE_EQUAL}")
        if (not tc_order or refine) and a["max_abs_err"] > MAX_T_ERR:
            bad.append(f"max |dt| {a['max_abs_err']:.3g} > {MAX_T_ERR}")
        if not tc_order and a["new_steps"][0] != a["new_steps"][1]:
            bad.append(f"new_steps kernel {a['new_steps'][0]} != plain {a['new_steps'][1]}")
        if tc_order:
            if a["t_close"] < TC_MIN_T_CLOSE:
                bad.append(f"|dt| <= {MAX_T_ERR} on {a['t_close']:.5f} of the common hits "
                           f"< {TC_MIN_T_CLOSE}")
            if not refine and a["max_abs_err_same_step"] > a["eps"]:
                bad.append(f"max |dt| {a['max_abs_err_same_step']:.3g} among rays resolving at "
                           f"the same step > eps {a['eps']}")
            if a["stragglers"] > TC_STRAGGLERS:
                bad.append(f"new_steps kernel {a['new_steps'][0]} vs plain {a['new_steps'][1]}: "
                           f"{a['stragglers']:.3g} of the lanes resolve past the other counter "
                           f"> {TC_STRAGGLERS}")
            if not a["replay_equal"]:
                bad.append(f"the plain march with the kernel's chain, on the {a['replayed']} "
                           "lanes beyond the bar, does not land on the kernel's results")
            if a["chain_max_diff"] > a["sdf_atol"]:
                bad.append(f"the chains differ by {a['chain_max_diff']:.3g} > {a['sdf_atol']} "
                           "on the replayed lanes' path")
        if a["n_converged"] == 0:
            bad.append("no ray converged in both")
        if bad:
            raise RuntimeError(f"kernel disagrees with its plain version ({name}): "
                               + "; ".join(bad))


def golden_check(img: np.ndarray, golden: np.ndarray) -> tuple:
    """IoU of the hit masks and the share of common-hit pixels within 2
    u8 levels (the bar of tests/test_artifact.py)."""
    hit_g, hit_o = golden[..., 3] > 0, img[..., 3] > 0
    iou = (hit_g & hit_o).sum() / max((hit_g | hit_o).sum(), 1)
    fg = hit_g & hit_o
    diff = np.abs(img[..., :3].astype(int) - golden[..., :3].astype(int))
    return float(iou), float((diff.max(axis=-1)[fg] <= 2).mean())


def record_calls(run) -> list:
    """Call ``run()``, recording (origin, dirs, state, config, frame,
    kwargs) of every march_state call it makes, inputs cloned."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import march

    calls = []
    real = megakernel.march_state

    def recording(params, origin, dirs, state, config, frame=0.0, **kw):
        calls.append((origin.clone(), dirs.clone(),
                      march.MarchState(*(x.clone() for x in state)), config, frame, kw))
        return real(params, origin, dirs, state, config, frame, **kw)

    megakernel.march_state = recording
    try:
        run()
    finally:
        megakernel.march_state = real
    torch.cuda.synchronize()
    return calls


def record_march_calls(renderer, cam, frame=0.0) -> list:
    """``record_calls`` over one rendered frame."""
    return record_calls(lambda: renderer.render(cam, frame))


def compare_recorded_calls(params, calls, plains=None) -> dict:
    """Kernel vs plain version on the inputs of each recorded call; each
    plain output (state, resolve steps) appended to ``plains`` if given."""
    from cudaneuralrender_torch.kernels import megakernel

    result = {}
    for i, (origin, dirs, state, config, frame, kw) in enumerate(calls):
        kw = dict(kw, return_resolve=True)
        k = megakernel.march_state(params, origin, dirs, state, config, frame, **kw)
        p = megakernel.march_state_plain(params, origin, dirs, state, config, frame, **kw)
        if plains is not None:
            plains.append(p)
        name = f"call{i}_{dirs.shape[0]}lanes_steps{kw.get('num_steps')}"
        if kw.get("cyl_window") is not None:
            name += f"_window{kw['cyl_window']}"
        result[name] = call_agreement(params, (origin, dirs, state, config, frame, kw), k, p)
    return result


def device_breakdown(renderer, cam, frame=0.0) -> dict:
    """``profile_breakdown`` of one warm frame."""
    return profile_breakdown(lambda: renderer.render(cam, frame))


def profile_breakdown(run) -> dict:
    """torch.profiler over one warm ``run()`` (a frame, a training step, a
    chunk's graph replay): device time per kernel name, each march kernel
    launch, and the device's idle share of the same profiled run (the
    profiler's host overhead is inside it, so the idle share is an upper
    bound)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy_us, reach = 0.0, spans[0][0]
    per_name = {}
    for start, end, name in spans:
        busy_us += max(end, reach) - max(start, reach)
        reach = max(reach, end)
        per_name[name[:80]] = per_name.get(name[:80], 0.0) + (end - start) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(
        wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
        idle_share=1.0 - busy_us / 1e3 / wall_ms, n_device_ops=len(spans),
        march_kernel_ms=[(e - s) / 1e3 for s, e, n in spans
                         if "march_kernel" in n or "march_split_kernel" in n],
        top_kernels_ms=top,
    )


def time_frames(run, reps: int) -> list:
    """Wall milliseconds of ``reps`` warm calls of ``run`` (a frame, a
    step), each synchronised."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


@contextlib.contextmanager
def thread_per_ray():
    """Inside the block ``megakernel.ray_lanes`` picks a ray per thread for
    every launch: the march as it ran before the ray-split mode."""
    from cudaneuralrender_torch.kernels import megakernel

    pick = megakernel.ray_lanes
    megakernel.ray_lanes = lambda *args, **kw: 1
    try:
        yield
    finally:
        megakernel.ray_lanes = pick


def mode_sweep(cnr, params, card) -> None:
    """Warm csg_demo frames at MODE_SIDES, each timed with ``ray_lanes``'
    choice and a ray per thread throughout (3 frames each, in the order
    choice, thread, thread, choice), and both modes on every march call of
    each side's frame (``compare_modes``): ``ray_lanes`` decides by the
    call's place in the ladder, which has to hold at every side."""
    cam = cnr.Camera(**CAMERA)
    for width, height in MODE_SIDES:
        cfg = cnr.RenderConfig(width=width, height=height, march_impl="staged")
        renderer = cnr.Renderer(params, cfg)
        renderer.render(cam)
        renderer.render(cam)
        ms = {"choice": [], "thread": []}
        for tag in ("choice", "thread", "thread", "choice"):
            with thread_per_ray() if tag == "thread" else contextlib.nullcontext():
                ms[tag] += time_frames(lambda: renderer.render(cam, 0.0), 3)
        print(f"{width}x{height} staged frame: median {statistics.median(ms['choice']):.3f} ms "
              f"with ray_lanes' choice {[round(x, 3) for x in ms['choice']]}, "
              f"{statistics.median(ms['thread']):.3f} ms a ray per thread "
              f"{[round(x, 3) for x in ms['thread']]} [{card}]", flush=True)
        compare_modes(params, record_march_calls(renderer, cam), f"{width}x{height}", card)


def check_image(img, what: str, height: int = 1080, width: int = 1920) -> float:
    """Shape, finiteness and a foreground fraction in (0.01, 0.9)."""
    if tuple(img.shape) != (height, width, 4) or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"bad {width}x{height} image ({what}): shape {tuple(img.shape)}")
    fg = (img[..., 3] > 0).float().mean().item()
    if not 0.01 < fg < 0.9:
        raise RuntimeError(f"{what}: foreground fraction {fg} outside (0.01, 0.9)")
    return fg


def time_coarse(params, calls, reps: int = 5, plain_reps: int = 3, lanes=None) -> tuple:
    """The frame's first march call (the coarse pass, over ``lanes`` rays:
    the frame's, or a shard's) through ``time_call``: (kernel ms, plain ms,
    bound)."""
    call = calls[0]
    if call[1].shape[0] != (lanes or call[3].num_rays) or not call[5].get("coarse"):
        raise RuntimeError(f"the frame's first march call is not the coarse pass: {call[5]}")
    return time_call(params, call, reps, plain_reps)


def time_call(params, call, reps: int = 5, plain_reps: int = 3) -> tuple:
    """A recorded march call timed through the kernel and through the plain
    version: (kernel ms, plain ms, bound).
    The bound counts this call's ray-steps (each ray's resolve step less
    the call's start) times the chain's fused multiply-adds, the compose's
    few hundred operations per step left out: at the FP32 peak (and
    3xTF32's, ``bound``), or for the three-pass chain three products a
    weight at the bfloat16 peak; and its bytes: per ray the direction, t,
    budget and flag in and five results out, and the weight stack once."""
    from cudaneuralrender_torch.kernels import fused_mlp, megakernel

    origin, dirs, state, ccfg, frame, kw = call
    ms = time_cuda(
        lambda: megakernel.march_state(params, origin, dirs, state, ccfg, frame, **kw), reps)
    sm_mhz = sm_clock_mhz()
    plain_ms = time_cuda(
        lambda: megakernel.march_state_plain(params, origin, dirs, state, ccfg, frame, **kw),
        plain_reps)
    _, lane_steps = megakernel.march_state(params, origin, dirs, state, ccfg, frame,
                                           **dict(kw, return_resolve=True))
    ray_steps = int(torch.where(state.active, lane_steps.long() - int(state.steps), 0).sum())
    weights, biases, n_in, hidden = fused_mlp.packed_params(params)
    fmas = ray_steps * chain_fmas(hidden, weights.shape[0], n_in)
    n = dirs.shape[0]
    three_pass = kw.get("precision") == "high"
    nbytes = (n * (12 + 4 + 4 + 1) + n * (4 + 4 + 1 + 1 + 4)
              + (2 if three_pass else 4) * weights.numel() + 4 * biases.numel())
    if three_pass:
        bnd = bound(3 * fmas, nbytes, PEAK_BF16_FLOPS)
        rate = "3 products a weight at 989 TFLOP/s bf16"
    else:
        bnd = bound(fmas, nbytes)
        rate = "67 TFLOP/s FP32"
    clock_ms = fmas / (132 * 128 * sm_mhz * 1e6) * 1e3
    print(f"call bound: {ray_steps} ray-steps x {chain_fmas(hidden, weights.shape[0], n_in)} "
          f"FMAs at width {hidden} ({kw.get('precision', 'highest')}, eps {kw.get('march_eps')}): "
          f"{bnd['bound_ms']:.3f} ms at {rate}, {clock_ms:.3f} ms at one FMA a lane a cycle at "
          f"the SM clock read after the timing ({sm_mhz:.0f} MHz; 132 SMs x 128 lanes)")
    return ms, plain_ms, bnd


def drive_scene(cnr, params, scene, frame, num_inputs, card, width=1920, height=1080) -> dict:
    """Phase 6 for one scene: the staged main path (1080p unless asked
    otherwise) with the scene's kernel launches counted, then kernel = plain
    version on every march call of a warm frame, and the coarse pass timed
    both ways."""
    from cudaneuralrender_torch.kernels import megakernel

    cfg = cnr.RenderConfig(width=width, height=height, march_impl="staged", scene=scene,
                           num_inputs=num_inputs)
    renderer = cnr.Renderer(params, cfg)
    cam = cnr.Camera(**CAMERA)
    megakernel.reset_launch_counts()
    renderer.render(cam, frame)  # cold: may overflow and teach the memo
    img = renderer.render(cam, frame)
    torch.cuda.synchronize()
    launches = megakernel.SCENE_LAUNCHES[scene]
    tag = f"{scene} frame {frame:g} ({num_inputs}-input)"
    res = "1080p" if (width, height) == (1920, 1080) else f"{width}x{height}"
    print(f"scene {tag}: {launches} kernel launches in a cold and a warm {res} frame, "
          f"stats {json.dumps(renderer.last_stats)}")
    if launches == 0:
        raise RuntimeError(f"{tag}: the staged render never launched the march kernel")
    fg = check_image(img, tag, height, width)
    frame_ms = time_frames(lambda: renderer.render(cam, frame), 3)
    print(f"scene {tag}: foreground {fg:.4f}; {res} staged frame median "
          f"{statistics.median(frame_ms):.3f} ms over 3 warm frames "
          f"{[round(x, 3) for x in frame_ms]} [{card}]")
    calls, plains = record_march_calls(renderer, cam, frame), []
    result = compare_recorded_calls(params, calls, plains)
    for name, a in result.items():
        print(f"compare {scene} {res} {name}: {json.dumps(a)}")
    check_agreement(result)
    compare_modes(params, calls, f"{tag} {res}", card, plains)
    ms, plain_ms, bnd = time_coarse(params, calls)
    print(f"scene {tag}: coarse march {res} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bnd['bound_ms']:.3f} ms [{card}]")
    print(f"scene {tag}: breakdown {json.dumps(device_breakdown(renderer, cam, frame))} "
          f"[{card}]", flush=True)
    return dict(launches=launches, max_abs_err=max(a["max_abs_err"] for a in result.values()),
                ms=ms, plain_ms=plain_ms, bnd=bnd)


def golden_render(cnr, params, cam, **fields):
    """The 256x256 golden render of a csg_demo-shaped net, held to the bar;
    ``fields`` change the staged config."""
    from cudaneuralrender_torch.utils import image_io

    gold_cfg = cnr.RenderConfig(width=256, height=256, scene="neural_raw", max_steps=500,
                                march_impl="staged", **fields)
    ours = cnr.Renderer(params, gold_cfg).render_frame(cam)
    iou, frac2 = golden_check(ours, image_io.load_png(GOLDEN))
    if iou < 0.99 or frac2 < 0.95:
        raise RuntimeError(f"golden render off: IoU {iou}, within-2 {frac2}")
    return iou, frac2


def drive_width(cnr, params, hidden, card, size: Sizes) -> list:
    """Phase 8 for one width at ``size``: the staged main path with this
    width's launches counted (a cold and a warm frame; at 64 its launches a
    ray per warp too, which must not be 0), the golden, the median of
    ``size.frames`` warm frames, kernel = plain version on every march call
    of one more frame (at 64 both modes equal bit for bit and timed,
    ``compare_modes``), the coarse pass (three-pass) and the first refine
    rung (FP32: the width's K1 entry, with the frame's FP32 launches) timed
    both ways, and a profiled frame, and the FP32 SDF (``tc_sdf_errors``).
    A bounded width drives BOUNDED_VARIANTS instead of the frame: the
    calls through the kernel with its launches counted, against the plain
    version on the same inputs, and the FP32 coarse call timed both ways.
    Returns the width's kernels entries (at 64 the ray-split mode's too)."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib
    from cudaneuralrender_torch.ops import march

    width, height = size.side
    cfg = cnr.RenderConfig(width=width, height=height, march_impl="staged")
    cam = cnr.Camera(**CAMERA)
    tag = f"width {hidden} {width}x{height}"
    split = megakernel.split_chain(hidden, "highest")
    entries = []
    megakernel.reset_launch_counts()
    if size.bounded:
        c2w, _ = camera_lib.view_matrices(cam, params.device)
        origin, dirs = camera_lib.generate_rays(c2w, width, height, cfg.focal)
        t0 = time.perf_counter()
        result = compare_kernel_with_plain(params, cfg, origin, dirs, variants=BOUNDED_VARIANTS)
        torch.cuda.synchronize()
        launches = megakernel.WIDTH_LAUNCHES[hidden]
        print(f"{tag}: {launches} kernel launches on the bounded calls {BOUNDED_VARIANTS}, "
              f"kernel and plain {time.perf_counter() - t0:.1f} s wall")
        if launches != len(BOUNDED_VARIANTS):
            raise RuntimeError(f"{tag}: {launches} launches on the bounded calls")
        cold = march.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
        calls = [(origin, dirs, cold, cfg, 0.0, dict(march_eps=COARSE_FP32["coarse_eps"],
                                                     precision=COARSE_FP32["coarse_precision"],
                                                     relax_omega=cfg.relax_omega,
                                                     cyl_window=cfg.cyl_window_coarse,
                                                     coarse=True))]
    else:
        renderer = cnr.Renderer(params, cfg)
        renderer.render(cam)  # cold: may overflow and teach the memo
        img = renderer.render(cam)
        torch.cuda.synchronize()
        launches = megakernel.WIDTH_LAUNCHES[hidden]
        split_launches = megakernel.SPLIT_LAUNCHES[hidden]
        three_pass = megakernel.THREE_PASS_LAUNCHES[hidden]
        print(f"{tag}: {launches} kernel launches in a cold and a warm frame ({three_pass} "
              f"three-pass, {split_launches} a ray per warp), stats "
              f"{json.dumps(renderer.last_stats)}")
        if launches == 0:
            raise RuntimeError(f"{tag}: the staged render never launched the march kernel")
        if split and split_launches == 0:
            raise RuntimeError(f"{tag}: the staged render never marched a ray per warp")
        fg = check_image(img, tag, height, width)
        iou, frac2 = golden_render(cnr, params, cam)
        print(f"{tag}: foreground {fg:.4f}; golden 256x256 IoU {iou:.5f}, {frac2:.5f} of "
              "foreground within 2 levels")
        frame_ms = time_frames(lambda: renderer.render(cam, 0.0), size.frames)
        print(f"{tag}: staged frame median {statistics.median(frame_ms):.3f} ms over "
              f"{size.frames} warm frames {[round(x, 3) for x in frame_ms]} [{card}]")
        calls, plains = record_march_calls(renderer, cam), []
        result = compare_recorded_calls(params, calls, plains)
    for name, a in result.items():
        print(f"compare {tag} {name}: {json.dumps(a)}")
    check_agreement(result)
    if split and not size.bounded:
        rows = compare_modes(params, calls, tag, card, plains)
        entries.append(split_entry(params, calls, rows, split_launches, card))
    if size.bounded:  # the FP32 coarse call (COARSE_FP32)
        ms, plain_ms, bnd = time_coarse(params, calls, size.reps, min(3, size.reps))
    else:  # the frame's three-pass coarse call, then its first FP32 call (refine rung 0)
        c_ms, c_plain, c_bnd = time_coarse(params, calls, size.reps, min(3, size.reps))
        print(f"{tag}: coarse march ({calls[0][5].get('precision')}, eps "
              f"{calls[0][5].get('march_eps')}) kernel {c_ms:.3f} ms, plain {c_plain:.3f} ms, "
              f"bound {c_bnd['bound_ms']:.3f} ms [{card}]", flush=True)
        ms, plain_ms, bnd = time_call(params, calls[1], size.reps, min(3, size.reps))
        launches -= three_pass
    print(f"{tag}: {'coarse march' if size.bounded else 'refine rung 0'} (FP32) kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.3f} ms (FP32), "
          f"{bnd['tc_bound_ms']:.3f} ms (3xTF32) [{card}]", flush=True)
    if not size.bounded:
        print(f"{tag}: breakdown {json.dumps(device_breakdown(renderer, cam))} [{card}]",
              flush=True)
    tc_sdf_errors(params, hidden, card, size.points)
    fp32_err = [a["max_abs_err"] for n, a in result.items()
                if size.bounded or not n.startswith("call0_")]
    return [kernel_entry(f"march_kernel_h{hidden}", K1_SOURCE,
                         "cudaneuralrender_tpu/pallas/megakernel.py:45", launches,
                         max(fp32_err), ms, plain_ms, bnd)] + entries


def drive_forward(cnr, params, hidden, card, size: Sizes) -> dict:
    """Phase 9 for one width: K3 against its plain version on
    ``size.points`` seeded points, timed both ways; then the path that runs
    it, a dense render_image with use_pallas (``size.render`` a side), with
    K3's launches counted, against the same render with use_pallas off (the
    full-precision bar)."""
    from cudaneuralrender_torch.kernels import fused_mlp

    dev = params.device
    weights, biases, n_in, h = fused_mlp.packed_params(params)
    packed = fused_mlp.packed_mma(params, "tf32")
    n_points, side = size.points, size.render
    pts = torch.as_tensor(np.random.default_rng(hidden).uniform(-1.2, 1.2, (n_points, n_in))
                          .astype(np.float32), device=dev)
    got = fused_mlp.mlp_forward(weights, biases, pts, packed)
    want = fused_mlp.mlp_forward_plain(weights, biases, pts)
    err = (got - want).abs().max().item()
    exact = sdf_float64(params, pts) if n_in == 3 else None
    f64 = ("" if exact is None else
           f"; max |SDF - float64|: 3xTF32 kernel {(got.double() - exact).abs().max().item():.3g}, "
           f"FP32 plain chain {(want.double() - exact).abs().max().item():.3g}")
    ms = time_cuda(lambda: fused_mlp.mlp_forward(weights, biases, pts, packed), 10)
    plain_ms = time_cuda(lambda: fused_mlp.mlp_forward_plain(weights, biases, pts), 5)
    fmas = n_points * chain_fmas(h, weights.shape[0], n_in)
    bnd = bound(fmas, n_points * (4 * n_in + 4) + 4 * (weights.numel() + biases.numel()))
    tile = forward_tile_points(h)
    l2_per_point = 4 * (weights.shape[0] - 2) * h * h / tile  # the hidden layers' weights
    print(f"forward width {h}: {n_points} points, max |kernel - plain| {err:.3g}{f64}; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.3f} ms (FP32 FFMA), "
          f"{bnd['tc_bound_ms']:.3f} ms (3xTF32); {tile}-point tiles, "
          f"{l2_per_point / 1024:.1f} KB of hidden-layer weights read from L2 per point, "
          f"{l2_per_point * n_points / ms / 1e9:.3f} TB/s [{card}]")
    if not err <= K3_ATOL:
        raise RuntimeError(f"forward kernel disagrees with its plain version at width {h}: "
                           f"max |d| {err} > {K3_ATOL}")
    # Does the plain chain's summation order depend on the batch? Its first
    # 256 points padded to m rows, against the kernel bit for bit.
    head = got[:256]
    same = {}
    for m in PADDINGS:
        xp = torch.zeros((m, h), dtype=torch.float32, device=dev)
        xp[:256, :n_in] = pts[:256]
        chain = fused_mlp.mlp_chain_plain(weights, biases, xp, weights.shape[0])[:256, 0]
        same[m] = (chain == head).float().mean().item()
    print(f"forward width {h}: plain chain on 256 points padded to m rows, share equal to the "
          f"3xTF32 kernel bit for bit: {json.dumps(same)}")

    cfg = cnr.RenderConfig(width=side, height=side, max_steps=500, use_pallas=True)
    cam = cnr.Camera(**CAMERA)
    fused_mlp.reset_launch_counts()
    img = cnr.render_image(params, cam, cfg)
    torch.cuda.synchronize()
    launches = fused_mlp.MLP_LAUNCHES
    ref = cnr.render_image(params, cam, cfg.replace(use_pallas=False))
    hit, hit_ref = img[..., 3] > 0, ref[..., 3] > 0
    agree = (hit == hit_ref).float().mean().item()
    both = hit & hit_ref
    n_both = int(both.sum())
    diff = (img - ref).abs().amax(dim=-1)[both]
    rgba_err = diff.max().item() if n_both else 0.0
    n_far = int((diff > K3_RENDER_ATOL).sum())
    close = 1.0 - n_far / max(n_both, 1)
    print(f"forward width {h}: use_pallas {side}x{side} render, {launches} K3 "
          "launches; hit masks "
          f"agree on {agree:.6f}, {n_both} common hits, {n_far} of them more than "
          f"{K3_RENDER_ATOL} apart in rgba ({close:.6f} within), max |rgba diff| {rgba_err:.3g}",
          flush=True)
    if launches == 0 or agree < 0.999 or close < K3_RENDER_CLOSE or n_both == 0:
        raise RuntimeError(f"use_pallas render at width {h}: {launches} launches, masks "
                           f"agree {agree}, common hits within {K3_RENDER_ATOL}: {close}")
    return kernel_entry(f"mlp_forward_kernel_h{h}", K3_SOURCE,
                        "cudaneuralrender_tpu/pallas/fused_mlp.py:187", launches, err, ms,
                        plain_ms, bnd)


def drive_turntable(cnr, params, card) -> int:
    """Phase 7: render_sequence over 24 turntable frames of many_sphere
    (yaw i, frame number i), twice, then frame DEEP_FRAME alone through
    ``deep_lanes``. Returns the launches of the second call."""
    from cudaneuralrender_torch.kernels import megakernel

    cfg = cnr.RenderConfig(width=1920, height=1080, march_impl="staged", scene="many_sphere")
    idx = range(TURNTABLE_FRAMES)
    cams = [cnr.Camera(rotation_x=CAMERA["rotation_x"], rotation_y=float(i)) for i in idx]
    frames = [float(i) for i in idx]
    first = []
    cnr.render_sequence(params, cams, cfg, frames=frames, stats_out=first)
    torch.cuda.synchronize()
    print(f"turntable first call: fast path on {sum(s['fast_path'] for s in first)} of "
          f"{len(first)} frames")
    stats = []
    megakernel.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cnr.render_sequence(params, cams, cfg, frames=frames, stats_out=stats)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(cams)
    launches = megakernel.SCENE_LAUNCHES["many_sphere"]
    print(f"turntable 1080p many_sphere, {len(cams)} frames: {ms:.3f} ms/frame (pipelined), "
          f"{launches} kernel launches [{card}]")
    slow = [i for i, s in enumerate(stats) if not s["fast_path"]]
    if slow or launches == 0:
        raise RuntimeError(f"turntable second call: frames {slow} left the fast path, "
                           f"{launches} launches")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for cam, fr in zip(cams, frames):  # the same frames, one host fetch each
        cnr.render_staged(params, cam, cfg, frame=fr)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3 / len(cams)
    print(f"turntable frames one by one through render_staged: {one_ms:.3f} ms/frame; "
          f"steps {[s['steps'] for s in stats]}, hits "
          f"{min(s['hits'] for s in stats)}-{max(s['hits'] for s in stats)} [{card}]")
    for i in (0, len(cams) - 1):
        check_image(out[i], f"turntable frame {i}")
        ref = cnr.render_staged(params, cams[i], cfg, frame=frames[i])
        agree = ((out[i][..., 3] > 0) == (ref[..., 3] > 0)).float().mean().item()
        print(f"turntable frame {i}: hit masks agree with render_staged on {agree:.6f}")
        if agree < 0.999:
            raise RuntimeError(f"turntable frame {i}: hit masks agree on {agree} < 0.999")
    print(f"turntable frame {DEEP_FRAME} in the sequence: stats {json.dumps(stats[DEEP_FRAME])}")
    with uncounted():
        deep_lanes(cnr, params, cams[DEEP_FRAME], cfg, frames[DEEP_FRAME], card)
    return launches


@contextlib.contextmanager
def march_lanes():
    """Inside the block every ``megakernel.march_state`` call is recorded
    with the pixel index of each of its lanes: the staged renderer builds
    each call's directions from the pixel indices it carries
    (``camera.ray_dirs_from_index``), so the indices of a call's ``dirs``
    are those of the build that returned that tensor. Yields a list that
    receives, per call, (pixel indices [n], dirs, the state it started
    from, its keywords, (state, resolve steps) it returned); the calls run
    as the caller asked (one launch each), the resolve steps taken as
    well."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera

    built, calls = {}, []
    real_dirs, real_march = camera.ray_dirs_from_index, megakernel.march_state

    def dirs_of(cam_to_world, idx, *args, **kw):
        out = real_dirs(cam_to_world, idx, *args, **kw)
        built[id(out)] = (out, idx)  # the tensor held: its id stays its own
        return out

    def recording(params, origin, dirs, state, config, frame=0.0, **kw):
        out, lane_steps = real_march(params, origin, dirs, state, config, frame,
                                     **dict(kw, return_resolve=True))
        calls.append((built[id(dirs)][1], dirs, state, dict(kw), (out, lane_steps)))
        return (out, lane_steps) if kw.get("return_resolve") else out

    camera.ray_dirs_from_index, megakernel.march_state = dirs_of, recording
    try:
        yield calls
    finally:
        camera.ray_dirs_from_index, megakernel.march_state = real_dirs, real_march


# Phase 7: the turntable frame whose deepest lane runs to max_steps (6000) on
# the H100 under either ladder, a ray that grazes a surface just above
# march_eps (ROADMAP section 3), and its deepest lanes printed.
DEEP_FRAME = 21
DEEP_LANES = 8


def deep_lanes(cnr, params, cam, cfg, frame, card, top: int = DEEP_LANES) -> None:
    """Phase 7: one ``render_staged`` frame of ``cfg`` at ``cam`` and
    ``frame``, its stats, and each march call that made it (``march_lanes``):
    its lanes, precision, eps, steps and relaxation, the lanes active at its
    start, its deepest resolve step and the lanes still active at
    ``max_steps``; then the ``top`` deepest lanes of the frame's deepest
    call, each with its pixel (x, y), resolve step, flags, its ray (origin,
    direction) and t before and after the call, printed exactly (the float32
    values as Python floats) so that a CPU run can march the same rays."""
    stats = {}
    with march_lanes() as calls:
        cnr.render_staged(params, cam, cfg, frame=frame, stats_out=stats)
    torch.cuda.synchronize()
    tag = f"{cfg.scene} frame {frame:g} {cfg.width}x{cfg.height} ({cam})"
    print(f"deep lanes {tag}: render_staged stats {json.dumps(stats)}, "
          f"coarse_precision {cfg.coarse_precision!r}, coarse_eps {cfg.coarse_eps} [{card}]")
    rows = []
    for i, (pos, dirs, state, kw, (out, lane_steps)) in enumerate(calls):
        act = state.active
        capped = int((out.active & (lane_steps >= cfg.max_steps)).sum())
        deepest = int(lane_steps[act].max()) if bool(act.any()) else int(state.steps)
        rows.append(dict(call=i, lanes=int(pos.numel()), active_in=int(act.sum()),
                         start_step=int(state.steps), deepest=deepest,
                         active_at_cap=capped, active_out=int(out.active.sum()),
                         precision=kw.get("precision", "highest"), eps=kw.get("march_eps"),
                         num_steps=kw.get("num_steps"), relax=kw.get("relax_omega", 0.0)))
        print(f"deep lanes {tag} call {i}: {json.dumps(rows[-1])}")
    if not calls:
        raise RuntimeError(f"{tag}: no march call recorded")
    worst = max(range(len(calls)), key=lambda j: rows[j]["deepest"])
    pos, dirs, state, kw, (out, lane_steps) = calls[worst]
    from cudaneuralrender_torch.ops import camera as camera_lib

    c2w, _ = camera_lib.view_matrices(cam, dirs.device)
    origin = [float(v) for v in c2w[:, 3].cpu()]
    order = torch.argsort(torch.where(state.active, lane_steps, -1).long(), descending=True)
    lanes = []
    for j in order[:top].tolist():
        p = int(pos[j])
        lanes.append(dict(pixel=p, x=p % cfg.width, y=p // cfg.width,
                          resolve=int(lane_steps[j]), converged=bool(out.converged[j]),
                          active=bool(out.active[j]), t_in=float(state.t[j]),
                          budget_in=float(state.budget[j]), t_out=float(out.t[j]),
                          dir=[float(v) for v in dirs[j].cpu()]))
    print(f"deep lanes {tag}: call {worst} of {len(calls)} holds the deepest lanes (origin "
          f"{origin}); its {len(lanes)} deepest: {json.dumps(lanes)} [{card}]", flush=True)


def compare_high_with_plain(params, config, origin, dirs, variants=None) -> dict:
    """The three-pass chain's march (precision "high") through the kernel
    and the plain version on the same inputs, for each of HIGH_VARIANTS
    (of ``variants``, all by default). Returns {variant: agreement dict}."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import march

    names = [v[0] for v in HIGH_VARIANTS if variants is None or v[0] in variants]
    cold = march.init_state(origin, dirs, config.bound_center, config.bound_radius)
    if names != ["coarse"]:  # rung 0 and the terminal rung start from a coarse pass
        coarse = megakernel.march_state_plain(params, origin, dirs, cold, config,
                                              march_eps=0.05, precision="high",
                                              relax_omega=1.6)
        entry = refine_entry(coarse, origin, dirs, config)
    result = {}
    for name, num_steps, omega in HIGH_VARIANTS:
        if name not in names:
            continue
        kw = dict(march_eps=HIGH_EPS, num_steps=num_steps, precision="high", relax_omega=omega,
                  return_resolve=True)
        state = cold if name == "coarse" else entry
        k = megakernel.march_state(params, origin, dirs, state, config, **kw)
        p = megakernel.march_state_plain(params, origin, dirs, state, config, **kw)
        result[name] = tc_agreement(params, (origin, dirs, state, config, 0.0, kw), k, p)
    return result


def kernel_sdf(params, pts, precision: str, frame: float = 0.0):
    """The march kernel's SDF at points [n, 3] (the net's, neural_raw; a
    4-input net reads ``frame``), a ray per thread, read off one step: rays
    from the origin
    along dirs = pts at t = 1 sit exactly on the points (the kernel's
    fma(p, 1, 0)); with budget 0, the step writes budget = 0 - d, exact, and
    eps = -inf converges no ray."""
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import fused_mlp, megakernel
    from cudaneuralrender_torch.ops import march

    n, dev = pts.shape[0], pts.device
    cfg = cnr.RenderConfig(num_inputs=fused_mlp.packed_params(params)[2])
    state = march.MarchState(
        t=torch.ones(n, device=dev), budget=torch.zeros(n, device=dev),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        converged=torch.zeros(n, dtype=torch.bool, device=dev),
        steps=torch.zeros((), dtype=torch.int32, device=dev))
    out = megakernel.march_state(params, torch.zeros(3, device=dev), pts.contiguous(), state, cfg,
                                 frame, march_eps=float("-inf"), num_steps=1, precision=precision,
                                 _ray_lanes=1)
    return -out.budget


def sdf_float64(params, pts, frame: float = 0.0) -> torch.Tensor:
    """The net's SDF at points [n, 3] in float64 (a 4-input net reads
    ``frame`` as its 4th input)."""
    x = pts.double()
    if params[0].w.shape[0] == 4:
        x = torch.cat([x, torch.full_like(x[:, :1], float(frame))], dim=1)
    for i, layer in enumerate(params):
        x = x @ layer.w.double() + layer.b.double()
        if i + 1 < len(params):
            x = torch.relu(x)
    return x[:, 0]


# The per-thread FFMA three-pass chain's SDF error against float64 as
# PERF.md records it (NVIDIA H100 80GB HBM3, 700.00 W), printed beside the
# tensor-core chain's.
FFMA_3PASS_SDF_ERR = "1.7e-5 to 4.1e-5 at widths 32-256, 1.45e-5 at 512, 1.11e-5 at 1024"


def sdf_errors(params, hidden, card, n_points) -> dict:
    """Phase 10: the FP32 chain's and the three-pass chain's SDF, read off
    the kernel, against float64 on ``n_points`` seeded points inside the
    bounding sphere; then the plain three-pass chain on the first 256
    points padded to m rows against the kernel: the largest |difference|
    and the share equal bit for bit, printed."""
    from cudaneuralrender_torch.kernels import fused_mlp

    dev = params.device
    pts = ball_points(hidden, n_points, dev)
    want = sdf_float64(params, pts)
    err = {prec: (kernel_sdf(params, pts, prec).double() - want).abs().max().item()
           for prec in ("highest", "high")}
    weights, biases, n_in, h = fused_mlp.packed_params(params)
    w_hi, w_lo = fused_mlp.packed_hi_lo(params)
    # the kernel, the model of its summation order and the plain chain on
    # the first points (fewer at the wider widths: the model sums in float64)
    n_model = min(n_points, 1 << 16, (1 << 22) // h)
    x = torch.zeros((n_model, h), dtype=torch.float32, device=dev)
    x[:, :n_in] = pts[:n_model]
    model = fused_mlp.mlp_chain_3pass_mma(weights, biases, x)
    plain = fused_mlp.mlp_chain_3pass_plain(w_hi, w_lo, biases, x, weights.shape[0])[:, 0]
    k_sdf = kernel_sdf(params, pts[:n_model], "high")
    vs_model = dict(kernel_model=(k_sdf - model).abs().max().item(),
                    model_plain=(model - plain).abs().max().item(),
                    kernel_plain=(k_sdf - plain).abs().max().item(),
                    model_equal=(k_sdf == model).float().mean().item(),
                    plain_equal=(k_sdf == plain).float().mean().item())
    print(f"sdf width {h}: three-pass chain on {n_model} points, max |d| kernel - model of its "
          f"summation order (fused_mlp.mlp_chain_3pass_mma) {vs_model['kernel_model']:.3g} "
          f"({vs_model['model_equal']:.6f} equal bit for bit), model - plain chain "
          f"{vs_model['model_plain']:.3g}, kernel - plain chain {vs_model['kernel_plain']:.3g} "
          f"({vs_model['plain_equal']:.6f} equal bit for bit)",
          flush=True)
    head = kernel_sdf(params, pts[:256], "high")
    off = {}
    for m in PADDINGS:
        xp = torch.zeros((m, h), dtype=torch.float32, device=dev)
        xp[:256, :n_in] = pts[:256]
        chain = fused_mlp.mlp_chain_3pass_plain(w_hi, w_lo, biases, xp, weights.shape[0])
        off[m] = ((chain[:256, 0] - head).abs().max().item(),
                  (chain[:256, 0] == head).float().mean().item())
    print(f"sdf width {h}: max |SDF - float64| over {n_points} points in the bounding sphere: "
          f"FP32 chain {err['highest']:.3g}, three-pass chain on the tensor cores "
          f"{err['high']:.3g} (the kernel's; the FFMA three-pass chain: "
          f"{FFMA_3PASS_SDF_ERR}); plain three-pass chain on 256 points padded to m rows "
          f"against the kernel, (max |d|, share equal bit for bit): {json.dumps(off)} "
          f"[{card}]", flush=True)
    if not err["high"] < 1e-3:
        raise RuntimeError(f"three-pass SDF error {err['high']} at width {h}")
    return dict(err, **vs_model)


def ball_points(seed: int, n: int, dev) -> torch.Tensor:
    """n seeded points uniform in the ball of radius 1.2 (the bounding
    sphere's reach)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v *= (1.2 * rng.uniform(size=(n, 1)) ** (1 / 3)) / np.linalg.norm(v, axis=1, keepdims=True)
    return torch.as_tensor(v.astype(np.float32), device=dev)


def tc_sdf_errors(params, hidden, card, n_points) -> dict:
    """Phases 5 and 8: the kernel's FP32 SDF (3xTF32 on the tensor cores),
    read off one step, on ``n_points`` seeded points in the
    bounding sphere: against the model of its summation order
    (``fused_mlp.mlp_chain_3xtf32_mma``, on the first points: it sums each
    MMA's products one by one), the plain FP32 chain (cuBLAS) and float64,
    beside the plain chain against float64; the largest |difference| and
    the shares equal bit for bit, printed. Raises if the kernel is more
    than K1_MMA_SDF_ATOL off the plain chain."""
    from cudaneuralrender_torch.kernels import fused_mlp

    pts = ball_points(hidden, n_points, params.device)
    weights, biases, n_in, h = fused_mlp.packed_params(params)
    k_sdf = kernel_sdf(params, pts, "highest")
    plain = fused_mlp.mlp_forward_plain(weights, biases, pts)
    exact = sdf_float64(params, pts)
    n_model = min(n_points, (1 << 32) // (h * h))
    x = torch.zeros((n_model, h), dtype=torch.float32, device=pts.device)
    x[:, :n_in] = pts[:n_model]
    model = fused_mlp.mlp_chain_3xtf32_mma(weights, biases, x)
    err_k, err_p = (k_sdf.double() - exact).abs(), (plain.double() - exact).abs()
    r = dict(kernel_model=(k_sdf[:n_model] - model).abs().max().item(),
             model_equal=(k_sdf[:n_model] == model).float().mean().item(),
             model_plain=(model - plain[:n_model]).abs().max().item(),
             kernel_plain=(k_sdf - plain).abs().max().item(),
             plain_equal=(k_sdf == plain).float().mean().item(),
             kernel_f64=(err_k.mean().item(), err_k.max().item()),
             plain_f64=(err_p.mean().item(), err_p.max().item()))
    print(f"sdf width {h}: FP32 chain on the tensor cores (3xTF32): on {n_model} points max "
          f"|d| kernel - model of its summation order (fused_mlp.mlp_chain_3xtf32_mma) "
          f"{r['kernel_model']:.3g} ({r['model_equal']:.6f} equal bit for bit), model - plain "
          f"chain {r['model_plain']:.3g}; on {n_points} points kernel - plain chain "
          f"{r['kernel_plain']:.3g} ({r['plain_equal']:.6f} equal bit for bit), |SDF - "
          f"float64| kernel mean {r['kernel_f64'][0]:.3g} max {r['kernel_f64'][1]:.3g}, plain "
          f"chain mean {r['plain_f64'][0]:.3g} max {r['plain_f64'][1]:.3g} [{card}]", flush=True)
    if not r["kernel_plain"] <= K1_MMA_SDF_ATOL:
        raise RuntimeError(f"width {h}: the FP32 kernel's SDF is {r['kernel_plain']} off its "
                           f"plain chain's, more than {K1_MMA_SDF_ATOL}")
    return r


def row_sweep(params, card, n_points) -> dict:
    """Phase 10: the plain chains, FP32 and three-pass, with every row a
    seeded point, against the kernel's SDF: in one product at the row
    counts ROW_SWEEP and at the powers of two from 2^10 to ``n_points``, and
    as the plain versions run them (``fused_mlp.plain_rows`` and
    ``chain_in_blocks``) on ``n_points``. The FP32 chain must agree bit for
    bit at the row counts the plain versions use (powers of two to
    ``ROW_BLOCK``, then blocks) with itself as the plain versions run it
    (a replay of a few lanes must sum as the whole call did; at widths 32
    and 64 the ray-split mode sums in that order, ``split_equal``), the
    kernel, which sums it on the tensor cores, within K1_MMA_SDF_ATOL of
    it; the three-pass chain, summed on the
    tensor cores in another order, within K2H_SDF_ATOL at every row count.
    Returns the FP32 row counts at which some row differs, and the
    three-pass chain's largest |difference| per row count."""
    from cudaneuralrender_torch.kernels import fused_mlp

    dev = params.device
    weights, biases, n_in, h = fused_mlp.packed_params(params)
    w_hi, w_lo = fused_mlp.packed_hi_lo(params)
    chains = {"fp32": ("highest", lambda x: fused_mlp.mlp_chain_plain(
        weights, biases, x, weights.shape[0])),
              "three_pass": ("high", lambda x: fused_mlp.mlp_chain_3pass_plain(
                  w_hi, w_lo, biases, x, weights.shape[0]))}
    pows = [1 << e for e in range(10, n_points.bit_length())]
    pts = torch.as_tensor(np.random.default_rng(h).uniform(-1.2, 1.2, (pows[-1], 3))
                          .astype(np.float32), device=dev)
    want = {p: kernel_sdf(params, pts, p) for p in ("highest", "high")}
    xb = torch.zeros((fused_mlp.plain_rows(pows[-1], h, dev), h), dtype=torch.float32,
                     device=dev)
    xb[:, :n_in] = pts
    # the FP32 kernel (3xTF32) against its plain chain, which then stands in
    # for it
    plain = fused_mlp.chain_in_blocks(chains["fp32"][1], xb)[:pows[-1], 0]
    fp32_mma = (want["highest"] - plain).abs().max().item()
    want["highest"] = plain
    off, dmax = [], {}
    for m in list(ROW_SWEEP) + pows:
        xp = torch.zeros((m, h), dtype=torch.float32, device=dev)
        xp[:, :n_in] = pts[:m]
        if not torch.equal(chains["fp32"][1](xp)[:, 0], want["highest"][:m]):
            off.append(m)
        dmax[m] = (chains["three_pass"][1](xp)[:, 0] - want["high"][:m]).abs().max().item()
    blocked = {name: (fused_mlp.chain_in_blocks(chain, xb)[:pows[-1], 0] - want[prec])
               for name, (prec, chain) in chains.items()}
    fp32_rows = int((blocked["fp32"] != 0).sum())
    tp_max = blocked["three_pass"].abs().max().item()
    sweep_max = max(dmax[m] for m in ROW_SWEEP)
    ref = f"the plain FP32 chain in blocks (the kernel's 3xTF32 SDF {fp32_mma:.3g} off it)"
    print(f"row sweep width {h}: plain chain on m seeded points in one product against the "
          f"kernel, m in range({ROW_SWEEP.start}, {ROW_SWEEP.stop}, {ROW_SWEEP.step}) "
          f"({len(ROW_SWEEP)} counts) and 2^10-{pows[-1]}: FP32 row counts with a row off "
          f"{ref} bit for bit {off}; three-pass max |d| {sweep_max:.3g} over the row counts, "
          f"{json.dumps({m: float(f'{dmax[m]:.3g}') for m in pows})} at the powers of two; "
          f"{pows[-1]} points in "
          f"blocks of {fused_mlp.ROW_BLOCK} rows: FP32 rows off {fp32_rows}, "
          f"three-pass max |d| {tp_max:.3g} [{card}]", flush=True)
    if not fp32_mma <= K1_MMA_SDF_ATOL:
        raise RuntimeError(f"width {h}: the FP32 kernel's SDF is {fp32_mma} off its plain "
                           f"chain's, more than {K1_MMA_SDF_ATOL}")
    used = [m for m in pows if fused_mlp.card_min_rows(h) <= m <= fused_mlp.ROW_BLOCK]
    if fp32_rows or any(m in used for m in off):
        raise RuntimeError(f"width {h}: a row count the plain versions use sums in another order")
    worst = max(list(dmax.values()) + [tp_max])
    if not worst <= K2H_SDF_ATOL:
        raise RuntimeError(f"width {h}: the three-pass kernel's SDF is {worst} off its plain "
                           f"chain's, more than {K2H_SDF_ATOL}")
    return dict(fp32=off, three_pass=dmax)


def mixed_bar(img, ref, what: str, ref_name: str = "the default config") -> tuple:
    """The mixed path's bar (tests/test_render.py:85-101): hit masks agree
    on >= 99% of pixels and >= 97% of common hits within 1e-3 in rgba."""
    hit, hit_ref = img[..., 3] > 0, ref[..., 3] > 0
    agree = (hit == hit_ref).float().mean().item()
    both = hit & hit_ref
    close = (img - ref).abs().amax(dim=-1)[both].lt(1e-3).float().mean().item()
    print(f"{what}: hit masks agree with {ref_name} on {agree:.6f}, "
          f"{int(both.sum())} common hits, {close:.6f} of them within 1e-3")
    if agree < 0.99 or close < 0.97 or int(both.sum()) == 0:
        raise RuntimeError(f"{what}: masks agree {agree}, common hits within 1e-3 {close}")
    return agree, close


def time_precisions(params, call, card, reps: int = 5) -> dict:
    """A recorded three-pass coarse call timed through the kernel, FP32 vs
    three-pass, and through the plain version, with its bound: the
    three-pass chain's fused multiply-adds (three products per weight) at
    the bfloat16 tensor-core peak, or its bytes."""
    from cudaneuralrender_torch.kernels import fused_mlp, megakernel

    origin, dirs, state, ccfg, frame, kw = call
    fp32_kw = dict(kw, precision="default")
    ms = time_cuda(lambda: megakernel.march_state(params, origin, dirs, state, ccfg, frame, **kw),
                   reps)
    fp32_ms = time_cuda(
        lambda: megakernel.march_state(params, origin, dirs, state, ccfg, frame, **fp32_kw), reps)
    plain_ms = time_cuda(
        lambda: megakernel.march_state_plain(params, origin, dirs, state, ccfg, frame, **kw), 1)
    steps = {}
    for name, kwp in (("high", kw), ("fp32", fp32_kw)):
        _, lane_steps = megakernel.march_state(params, origin, dirs, state, ccfg, frame,
                                               **dict(kwp, return_resolve=True))
        steps[name] = int((lane_steps.long() - int(state.steps)).sum())
    weights, biases, n_in, hidden = fused_mlp.packed_params(params)
    fmas = 3 * steps["high"] * chain_fmas(hidden, weights.shape[0], n_in)
    n = dirs.shape[0]
    bnd = bound(fmas, n * (12 + 4 + 4 + 1) + n * (4 + 4 + 1 + 1 + 4)
                + 2 * weights.numel() + 4 * biases.numel(), PEAK_BF16_FLOPS)
    print(f"coarse call width {hidden}, {n} rays, eps {kw['march_eps']}: three-pass kernel "
          f"{ms:.3f} ms ({steps['high']} ray-steps), FP32 kernel {fp32_ms:.3f} ms "
          f"({steps['fp32']} ray-steps; three-pass / FP32 {ms / fp32_ms:.3f}), plain three-pass "
          f"{plain_ms:.3f} ms; bound "
          f"{bnd['bound_ms']:.4f} ms (3 x {chain_fmas(hidden, weights.shape[0], n_in)} FMAs per "
          f"ray-step at 989 TFLOP/s bf16) [{card}]", flush=True)
    return dict(ms=ms, fp32_ms=fp32_ms, plain_ms=plain_ms, bnd=bnd)


def drive_high_config(cnr, params, name, fields, ref_img, card, frames=3, precision="high",
                      width=1920, height=1080) -> dict:
    """Phase 10 for one config of the ladder at 1080p: the staged main path
    with the launches at ``precision`` counted (a cold and a warm frame;
    "high": the three-pass chain, "default": the FP32 coarse call), against
    the default image at the mixed bar, the 256x256 golden under the same
    config, the median of ``frames`` warm frames, and kernel = plain on
    every march call of one more frame. Returns the launches, the largest
    |dt|, the recorded calls and the frame times."""
    from cudaneuralrender_torch.kernels import megakernel

    cfg = cnr.RenderConfig(width=width, height=height, march_impl="staged", **fields)
    renderer = cnr.Renderer(params, cfg)
    cam = cnr.Camera(**CAMERA)
    megakernel.reset_launch_counts()
    renderer.render(cam)  # cold: may overflow and teach the memo
    img = renderer.render(cam)
    torch.cuda.synchronize()
    launches = megakernel.PRECISION_LAUNCHES[precision]
    print(f"{name} 1080p: {launches} launches at precision {precision!r} of "
          f"{megakernel.KERNEL_LAUNCHES} in a cold and a warm frame "
          f"{json.dumps(megakernel.PRECISION_LAUNCHES)}, stats {json.dumps(renderer.last_stats)}")
    if launches == 0:
        raise RuntimeError(f"{name}: the staged render never launched the kernel at {precision}")
    check_image(img, name, height, width)
    mixed_bar(img, ref_img, f"{name} 1080p")
    iou, frac2 = golden_render(cnr, params, cam, **fields)
    frame_ms = time_frames(lambda: renderer.render(cam, 0.0), frames)
    print(f"{name}: golden 256x256 IoU {iou:.5f}, {frac2:.5f} of foreground within 2 levels; "
          f"1080p staged frame median {statistics.median(frame_ms):.3f} ms over {frames} warm "
          f"frames {[round(x, 3) for x in frame_ms]} [{card}]")
    calls = record_march_calls(renderer, cam)
    result = compare_recorded_calls(params, calls)
    for call_name, a in result.items():
        print(f"compare {name} 1080p {call_name}: {json.dumps(a)}")
    check_agreement(result)
    return dict(launches=launches, max_abs_err=max(a["max_abs_err"] for a in result.values()),
                calls=calls)


def drive_high_width(cnr, params, hidden, card, size: Sizes) -> dict:
    """Phase 10 for a widened net at ``size``: ``mid_eps`` through the
    staged path at ``size.high_side``^2 with this width's three-pass
    launches counted (a cold and a warm frame), then the three-pass kernel
    vs plain on the same rays for HIGH_VARIANTS, and the coarse call timed
    (the median of ``size.reps``). A bounded width drives its cold coarse
    call alone, with its launches counted."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib

    side = size.high_side
    cfg = cnr.RenderConfig(width=side, height=side, march_impl="staged", mid_eps=1e-3)
    cam = cnr.Camera(**CAMERA)
    if not size.bounded:
        renderer = cnr.Renderer(params, cfg)
        megakernel.reset_launch_counts()
        renderer.render(cam)
        img = renderer.render(cam)
        torch.cuda.synchronize()
        launches = megakernel.THREE_PASS_LAUNCHES[hidden]
        print(f"mid_eps width {hidden} {side}x{side}: {launches} three-pass launches in a cold "
              f"and a warm frame, stats {json.dumps(renderer.last_stats)}")
        check_image(img, f"mid_eps width {hidden}", side, side)
    c2w, _ = camera_lib.view_matrices(cam, params.device)
    origin, dirs = camera_lib.generate_rays(c2w, side, side, cfg.focal)
    r = high_agreement(params, cfg, origin, dirs, hidden, card, size.reps,
                       ("coarse",) if size.bounded else None)
    if size.bounded:
        launches = r["launches"]
    if launches == 0:
        raise RuntimeError(f"width {hidden}: the three-pass calls never launched the kernel")
    return dict(r, launches=launches)


def high_agreement(params, cfg, origin, dirs, hidden, card, reps=5, variants=None) -> dict:
    """K2h kernel vs plain on the rays of one image for HIGH_VARIANTS (of
    ``variants``, all by default), with this width's three-pass launches
    counted from 0 over those calls, and its cold coarse call at HIGH_EPS
    timed (the median of ``reps``)."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import march

    megakernel.reset_launch_counts()
    result = compare_high_with_plain(params, cfg, origin, dirs, variants)
    torch.cuda.synchronize()
    launches = megakernel.THREE_PASS_LAUNCHES[hidden]
    for name, a in result.items():
        print(f"compare three-pass width {hidden} {cfg.width}x{cfg.height} {name}: "
              f"{json.dumps(a)}")
    check_agreement(result)
    cold = march.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
    call = (origin, dirs, cold, cfg, 0.0,
            dict(march_eps=HIGH_EPS, precision="high", relax_omega=1.6, coarse=True))
    t = time_precisions(params, call, card, reps)
    return dict(launches=launches, max_abs_err=max(a["max_abs_err"] for a in result.values()),
                ms=t["ms"], plain_ms=t["plain_ms"], bnd=t["bnd"])


def drive_raygen(cnr, params, card, width=1920, height=1080) -> dict:
    """Phase 10, K5: ``march_raygen`` on the 1080p coarse call (block
    order, relax_omega, cyl_window_coarse) at "default" (COARSE_FP32's
    eps) and "high" (the config's coarse_eps), its launches counted:
    against its plain version at the kernel bar, against the ray build +
    init_state + march_state at the JAX package's bar, and timed both
    ways."""
    from cudaneuralrender_torch.kernels import fused_mlp, megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib
    from cudaneuralrender_torch.ops import march
    from cudaneuralrender_torch.render import renderer as renderer_lib

    dev = params.device
    cfg = cnr.RenderConfig(width=width, height=height)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**CAMERA), dev)
    pos = renderer_lib._block_order(cfg.height, cfg.width, *cfg.coarse_block, dev)
    out = {}
    for prec, eps in (("default", COARSE_FP32["coarse_eps"]), ("high", cfg.coarse_eps)):
        kw = dict(march_eps=eps, precision=prec, relax_omega=cfg.relax_omega,
                  return_resolve=True, cyl_window=cfg.cyl_window_coarse)
        megakernel.reset_launch_counts()
        k = megakernel.march_raygen(params, c2w, pos, cfg, **kw)
        torch.cuda.synchronize()
        launches = megakernel.RAYGEN_LAUNCHES
        if launches == 0:
            raise RuntimeError(f"march_raygen ({prec}) never launched the kernel")
        p = megakernel.march_raygen_plain(params, c2w, pos, cfg, **kw)
        # K5 marches a ray per thread, as a frame's coarse call does
        a = call_agreement(params, (*megakernel.raygen_state(c2w, pos, cfg), cfg, 0.0,
                                    dict(kw, coarse=True)), k, p)
        print(f"compare raygen {prec} 1080p: {json.dumps(a)}")
        check_agreement({f"raygen_{prec}": a})

        def build_and_march():
            origin = c2w[:, 3].contiguous()
            dirs = camera_lib.ray_dirs_from_index(c2w, pos, cfg.height, cfg.width, cfg.focal)
            state = march.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
            return megakernel.march_state(params, origin, dirs, state, cfg, coarse=True, **kw)

        o = build_and_march()
        conv_agree = (o[0].converged == k[0].converged).float().mean().item()
        both = o[0].converged & k[0].converged
        dt_all = (o[0].t - k[0].t).abs()
        dt = dt_all[both]
        t_err, close = dt.max().item(), dt.le(RAYGEN_MAX_T_ERR).float().mean().item()
        same = dt_all[both & (o[1] == k[1])]
        t_err_same = same.max().item() if same.numel() else 0.0
        # at "high", the rays resolving at the same step (RAYGEN_ comment)
        held = t_err_same if prec == "high" else t_err
        one_step = cfg.relax_omega * eps
        print(f"raygen {prec} 1080p vs ray build + init + march_state: converged flags agree on "
              f"{conv_agree:.6f}; over {int(both.sum())} common hits, {close:.7f} within "
              f"{RAYGEN_MAX_T_ERR} in t, max |dt| {t_err:.3g} ({t_err_same:.3g} among the "
              f"{same.numel()} resolving at the same step), "
              f"{int(dt.gt(RAYGEN_MAX_T_ERR).sum())} rays beyond")
        if (conv_agree < RAYGEN_MIN_CONV_AGREE or close < RAYGEN_MIN_T_CLOSE
                or held > one_step):
            raise RuntimeError(f"raygen ({prec}) vs the ray build: converged agree {conv_agree}, "
                               f"t within {RAYGEN_MAX_T_ERR} on {close}, max |dt| {held} held "
                               f"to {one_step}")
        ms = time_cuda(lambda: megakernel.march_raygen(params, c2w, pos, cfg, **kw), 5)
        build_ms = time_cuda(build_and_march, 5)
        plain_ms = time_cuda(lambda: megakernel.march_raygen_plain(params, c2w, pos, cfg, **kw), 1)
        ray_steps = int(k[1].long().sum())
        weights, biases, n_in, hidden = fused_mlp.packed_params(params)
        fmas = ray_steps * chain_fmas(hidden, weights.shape[0], n_in)
        n = pos.shape[0]
        nbytes = n * (4 + 4 + 4 + 1 + 1 + 4) + 4 * (weights.numel() + biases.numel())
        bnd = (bound(3 * fmas, nbytes, PEAK_BF16_FLOPS) if prec == "high"
               else bound(fmas, nbytes))
        print(f"raygen {prec} 1080p ({n} rays, {ray_steps} ray-steps): kernel {ms:.3f} ms, ray "
              f"build + init + march_state {build_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms, {launches} launch [{card}]", flush=True)
        out[prec] = dict(launches=launches, max_abs_err=a["max_abs_err"], ms=ms,
                         plain_ms=plain_ms, bnd=bnd)
    return out


def drive_option(cnr, params, name, fields, card, side=OPTION_SIDE) -> None:
    """Phase 10: one OPTION_SIDE^2 staged frame under an opt-in option
    against the default config's, at the mixed bar, with the kernel's
    launches by precision (tail_pallas: the terminal rungs' "highest"
    launches, which must be > 0)."""
    from cudaneuralrender_torch.kernels import megakernel

    cam = cnr.Camera(**CAMERA)
    base = cnr.RenderConfig(width=side, height=side, march_impl="staged")
    ref = cnr.render_staged(params, cam, base)
    megakernel.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = cnr.Renderer(params, base.replace(**fields)).render(cam)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(megakernel.PRECISION_LAUNCHES)
    print(f"{name} {side}x{side}: one cold staged frame {ms:.3f} ms, kernel launches by "
          f"precision {json.dumps(counts)} [{card}]")
    check_image(img, name, side, side)
    mixed_bar(img, ref, f"{name} {side}x{side}")
    if fields.get("tail_pallas") and counts["highest"] == 0:
        raise RuntimeError(f"{name}: the terminal rungs never reached the kernel")


def x_scale(experiment: str, steps: int = 1) -> float:
    """What an output of unit size becomes in an experiment run ``steps``
    steps: X2's outputs are t itself (2-4 on the rays that hit); X3's v0
    carries x unscaled, v1 and v2 scale x by its SCALE (1e-8) each step,
    and v3-v5p add sdf * SCALE to t from 0 each step. X1's depends on its
    weights: ``x1_scale``."""
    from cudaneuralrender_torch.benchmarks import exp_stepcost2 as x3

    if experiment in ("x2", "v0"):
        return 1.0
    if experiment in ("v1", "v2"):
        return x3.SCALE ** steps
    return x3.SCALE * steps


def x1_float64(x, w, b, reps: int) -> torch.Tensor:
    """X1's reps of x <- relu(W^T x + b) on x [H, lanes] in float64."""
    y = x.double()
    for _ in range(reps):
        y = torch.relu(w.double().t() @ y + b.double()[:, None])
    return y


def x1_scale(exact) -> float:
    """What an output of unit size becomes in X1 (its ``x_scale``): the RMS
    of its float64 outputs ``exact``, whose inputs are unit normal. A fixed
    1e-4, below the outputs' median magnitude (6.7e-4 at H=32, 0.076 at 128
    in phase 11), served while the kernel summed in the plain version's
    order; on the tensor cores an output that a pre-activation's
    cancellation leaves near zero differs from the plain one by an ulp of
    the sum's terms, not of itself (1.9e-3 and 5.1e-3 of (|plain| + 1e-4)
    on the card tests' outputs of unit size, NVIDIA H100), so the scale is
    what X3's is: the size of a typical output."""
    return exact.double().pow(2).mean().sqrt().item()


def x1_library(x, w, b, reps: int) -> torch.Tensor:
    """X1's reps as one PyTorch call a rep on all lanes, the yardstick of
    the kernels line's library_ms (cuBLAS FP32: the caller keeps TF32 off):
    rows [lanes, H] <- addmm(b, rows, W), then relu_ in place."""
    y = x.t().contiguous()
    for _ in range(reps):
        y = torch.addmm(b, y, w).relu_()
    return y


def x3_witness_rays(pts: torch.Tensor):
    """Rays whose point at t0 is exactly pts [n, 3] in every X3 variant:
    origin 0, dirs pts * 2^100 [3, n], t0 2^-100 [1, n] (powers of two, so
    the kernels' fused o + d*t is exact). A t-carried variant adds
    sdf * 1e-8 to t0, far above 2^-100 wherever |sdf| > 2e-3."""
    n = pts.shape[0]
    dirs = (pts.t() * 2.0 ** 100).contiguous()
    t0 = torch.full((1, n), 2.0 ** -100, dtype=torch.float32, device=pts.device)
    return dirs, t0, torch.zeros((3, 1), dtype=torch.float32, device=pts.device)


def x3_float64(variant: str, weights, biases, pts) -> torch.Tensor:
    """One step of an X3 variant in float64 at the rays of
    ``x3_witness_rays(pts)``: v0 the point through n_layers products by the
    first weight; v1 and v2 through the n_layers weights (v2 with the
    biases and ReLU), times 1e-8; v3-v5p 2^-100 + sdf * 1e-8. Returns [n]."""
    from cudaneuralrender_torch.benchmarks import exp_stepcost2 as x3

    kernel = x3.KERNEL_OF[variant][0]
    n_layers, hidden = weights.shape[0], weights.shape[1]
    x = torch.zeros((pts.shape[0], hidden), dtype=torch.float64, device=pts.device)
    x[:, :3] = pts.double()
    w, b = weights.double(), biases.double()
    for l in range(n_layers):
        x = x @ w[0 if kernel == "v0" else l]
        if kernel not in ("v0", "v1"):
            x = x + b[l]
            if l + 1 < n_layers:
                x = torch.relu(x)
    if kernel == "v0":
        return x[:, 0]
    return x[:, 0] * x3.SCALE + (0.0 if kernel in ("v1", "v2") else 2.0 ** -100)


def x_witness(got, plain, exact, scale=None) -> dict:
    """|kernel - float64| and |plain - float64| over the finite outputs,
    each over |float64| + ``scale`` where a scale is given: their means and
    maxima."""
    fin = (torch.isfinite(exact) & torch.isfinite(plain)).reshape(-1)
    den = 1.0 if scale is None else exact.double().reshape(-1)[fin].abs() + scale
    k = (got.double().reshape(-1) - exact.reshape(-1)).abs()[fin] / den
    p = (plain.double().reshape(-1) - exact.reshape(-1)).abs()[fin] / den
    return dict(n=int(fin.sum()), kernel_mean=k.mean().item(), kernel_max=k.max().item(),
                plain_mean=p.mean().item(), plain_max=p.max().item())


def witness_bar(w: dict) -> list:
    """What breaks the float64 witness bars: the kernel's mean |error| above
    WITNESS_MEAN times the plain version's, or its max above WITNESS_MAX
    times."""
    bad = []
    if not w["n"]:
        bad.append("no finite output to witness")
    if not w["kernel_mean"] <= WITNESS_MEAN * w["plain_mean"]:
        bad.append(f"mean |error| {w['kernel_mean']:.3g} > {WITNESS_MEAN} x {w['plain_mean']:.3g}")
    if not w["kernel_max"] <= WITNESS_MAX * w["plain_max"]:
        bad.append(f"max |error| {w['kernel_max']:.3g} > {WITNESS_MAX} x {w['plain_max']:.3g}")
    return bad


def x2_float64(params, pts) -> torch.Tensor:
    """One chain_only step of X2 in float64 at the rays of
    ``x3_witness_rays(pts)``: 2^-100 + sdf (``sdf_float64``; X2's padded
    stack is this net's). Returns [n]."""
    return 2.0 ** -100 + sdf_float64(params, pts)


def x2_witness(weights, biases, params, pts, three_pass: bool) -> dict:
    """X2's float64 witness for one chain: one chain_only step of the kernel
    and of the plain version at the rays of ``x3_witness_rays(pts)``
    against ``x2_float64``."""
    from cudaneuralrender_torch.benchmarks import exp_stepcost as x2

    rays = x3_witness_rays(pts)
    return x_witness(x2.step_cost("chain_only", weights, biases, *rays, steps=1,
                                  three_pass=three_pass),
                     x2.step_cost_plain("chain_only", weights, biases, *rays, steps=1,
                                        three_pass=three_pass),
                     x2_float64(params, pts))


def x2_chains(weights, biases, params, three_pass: bool) -> tuple:
    """X2's two chains as ``exp_stepcost.march_steps`` takes them (points
    [n, 3] -> [n]): the kernel's own, read off the march kernel a ray per
    thread at width 32 (``kernel_sdf``; at "highest" K1's tf32 chain, at
    "high" K2h's bf16 chain: the chains X2 calls), its launches uncounted;
    and the plain version's (``exp_stepcost.plain_sdf``)."""
    from cudaneuralrender_torch.benchmarks import exp_stepcost as x2

    precision = "high" if three_pass else "highest"

    def kernel(pts):
        with uncounted():
            return kernel_sdf(params, pts, precision)

    return kernel, x2.plain_sdf(weights, biases, three_pass)


def equal_floats(a, b) -> torch.Tensor:
    """Where two float tensors are equal, NaN where the other is NaN."""
    return (a == b) | (a.isnan() & b.isnan())


def x2_beyond(variant, chains, sdf64, rays, got, want, beyond, sample, steps: int, act_dtype,
              stride: int = 1) -> dict:
    """X2's lanes beyond X_RTOL (``beyond``), one by one, in
    ``undecided_lanes``' terms, beside a sample of every lane (``sample``)
    that the float64 witness of the march needs, as the lanes beyond are a
    selection: the lanes of both marched again on both sides (``chains``:
    the kernel's, then the plain version's) with a trace, each replay
    landing on its side's t (``got``, ``want``) bit for bit or
    ``replay_equal`` is false; each side's chain against float64
    (``sdf64``, points -> float64) on its own paths, |d - sdf64| / (|sdf64|
    + 1) (the paths reach 1e18), its mean and max; on every ``stride``-th
    point of the kernel's paths the two chains' largest |difference| /
    (|plain| + 1) (``chain_max_diff``); both sides' t against a float64
    march of the same lanes (``sdf64`` on float64 points and t), over
    |t64| + x_scale("x2") (``t_witness``: printed, not held, see the
    note at X_RTOL); and where the two first take
    another branch (``part_lanes``, with delta the larger of the two
    chains' |error| at the lane's two points of that step): the undecided
    lanes (a test within delta of its threshold), the decided ones (their
    states had drifted apart before) and the lanes beyond that never take
    another branch (the step's SDF difference carried and grown, as on a
    ray that grazes the surface and escapes), over the lanes beyond."""
    from cudaneuralrender_torch.benchmarks import exp_stepcost as x2

    dirs, t0, origin = rays
    lanes = torch.unique(torch.cat([beyond, sample]))
    result = dict(lanes=int(beyond.numel()), replayed=int(lanes.numel()),
                  n_call=int(got.numel()), delta=None, n_decided=0, n_undecided=0,
                  n_unparted=0, decided=[], decided_detail=[], replay_equal=True,
                  chain_max_diff=0.0, err_mean=[0.0, 0.0], err_max=[0.0, 0.0],
                  parted_by=dict.fromkeys(STEP_TESTS, 0), t_witness=None)
    if lanes.numel() == 0:
        return result
    runs = []
    for side, (sdf, out) in enumerate(zip(chains, (got, want))):
        recs, rel = {}, []

        def keep(r):
            r["s64"] = sdf64(r["pts"])
            r["err"] = (r["d"].double() - r["s64"]).abs()
            rel.append(r["err"] / (r["s64"].abs() + 1.0))
            if side == 0 and r["idx"].numel():
                plain = chains[1](r["pts"][::stride])
                diff = ((r["d"][::stride] - plain).abs() / (plain.abs() + 1.0)).max().item()
                result["chain_max_diff"] = max(result["chain_max_diff"], diff)
            recs[r["step"]] = r

        t = x2.march_steps(variant, sdf, dirs[:, lanes], t0[:, lanes], origin, steps=steps,
                           act_dtype=act_dtype, trace=keep)
        result["replay_equal"] &= bool(equal_floats(t, out[:, lanes]).all())
        rel = torch.cat(rel)
        result["err_mean"][side], result["err_max"][side] = rel.mean().item(), rel.max().item()
        runs.append(recs)
    t64 = x2.march_steps(variant, sdf64, dirs[:, lanes].double(), t0[:, lanes].double(),
                         origin.double(), steps=steps, act_dtype=act_dtype)
    result["t_witness"] = x_witness(got[:, lanes], want[:, lanes], t64, x_scale("x2"))
    part_lanes(runs, lanes, 1e-6, 1.6 if variant == "march_relax" else 0.0, result,
               among=torch.isin(lanes, beyond))
    return result


def x2_check(variant, chains, sdf64, rays, got, want, *, steps: int, sdf_atol: float,
             act_dtype=torch.float32, stride: int = 1) -> dict:
    """X2's kernel t ``got`` against its plain version's ``want`` ([1, n]
    each, from ``rays``): ``compare_outputs`` over every lane (printed; the
    lanes beyond X_RTOL are held by their account instead), ``n_beyond``,
    ``beyond``, the account of those lanes and of every ``stride``-th lane
    (``x2_beyond``: ``chains``, the kernel's and the plain version's,
    ``x2_chains``; ``sdf64``, the float64 SDF), and ``sdf_atol``, the
    chain's own SDF bar (K1_MMA_SDF_ATOL, K2H_SDF_ATOL) that
    ``chain_max_diff`` is held to."""
    scale = x_scale("x2")
    fin = torch.isfinite(want)
    beyond = (torch.isfinite(got) != fin) | (fin & ((got - want).abs()
                                                    > X_RTOL * (want.abs() + scale)))
    check = compare_outputs(got, want, scale)
    check["n_beyond"] = int(beyond.sum())
    sample = torch.arange(0, got.shape[1], stride, device=got.device)
    check["beyond"] = x2_beyond(variant, chains, sdf64, rays, got, want,
                                beyond.reshape(-1).nonzero().squeeze(1), sample, steps,
                                act_dtype, stride)
    check["sdf_atol"] = sdf_atol
    return check


def compare_outputs(got, want, scale: float) -> dict:
    """An experiment kernel's outputs against its plain version's: whether
    the same outputs are finite, and over the finite ones the largest
    |difference| and the largest |difference| / (|plain| + ``scale``);
    and the share of all outputs that is bit-equal."""
    fin = torch.isfinite(want)
    diff = (got - want).abs()[fin].double()
    rel = diff / (want.abs()[fin].double() + scale)
    return dict(finite_equal=bool(torch.equal(fin, torch.isfinite(got))),
                n_finite=int(fin.sum()), scale=scale,
                max_abs_err=diff.max().item() if diff.numel() else 0.0,
                max_rel_err=rel.max().item() if rel.numel() else 0.0,
                bit_equal=(got == want).float().mean().item())


def check_outputs(name: str, r: dict) -> None:
    """Raise unless the same outputs are finite, each agrees within X_RTOL *
    (|plain| + scale) and the kernel meets the float64 witness bars. X2's
    lanes beyond X_RTOL are held by their account (``x2_check``) instead:
    ``undecided_bar`` on them, their unparted lanes against a float64
    march, the two chains within ``sdf_atol`` on their paths, and the plain
    steps on the kernel's chain landing on the kernel's t."""
    bad = []
    if "beyond" in r:
        u = r["beyond"]
        if r["n_finite"] == 0:
            bad.append("no finite output")
        bad.extend(undecided_bar(u, unparted_ok=True))
        if not u["chain_max_diff"] <= r["sdf_atol"]:
            bad.append(f"the chains differ by {u['chain_max_diff']:.3g} of (|plain| + 1) > "
                       f"{r['sdf_atol']} on the replayed paths")
    elif not r["finite_equal"] or r["n_finite"] == 0 or not r["max_rel_err"] <= X_RTOL:
        bad.append(f"outside X_RTOL {X_RTOL}")
    bad.extend(witness_bar(r["witness"]))
    if bad:
        raise RuntimeError(f"{name}: the kernel disagrees with its plain version: {bad}: {r}")


def _x_entry(name, jax_file, line, launches, check, ms, plain_ms, fmas, nbytes, peak,
             tf32=False):
    """An experiment kernel's entry; a ``tf32`` one (X1, X2's FP32 chain, X3
    v0-v3: FP32-grade products on the tensor cores) takes the 3xTF32 bound as its bound_ms,
    its FFMA bound kept as fp32_bound_ms."""
    bnd = bound(fmas, nbytes, peak)
    if tf32:
        tc = bound(fmas, nbytes, PEAK_TF32_FLOPS / TF32_PASSES)
        bnd = dict(tc, tc_bound_ms=tc["bound_ms"], fp32_bound_ms=bnd["bound_ms"])
    return kernel_entry(name, X_SOURCE, f"benchmarks/{jax_file}:{line}", launches,
                        check["max_abs_err"], ms, plain_ms, bnd)


def drive_experiments(card) -> list:
    """Phase 11: X1-X3's ``main()`` at the JAX scripts' sizes with the
    kernels' launches counted, then each kernel that ``main()`` ran against
    its plain version (the module docstring gives the sizes) and the plain
    version timed once at the JAX sizes. Returns their entries."""
    from cudaneuralrender_torch.benchmarks import exp_blockdiag as x1
    from cudaneuralrender_torch.benchmarks import exp_stepcost as x2
    from cudaneuralrender_torch.benchmarks import exp_stepcost2 as x3
    from cudaneuralrender_torch.models import checkpoint

    dev = torch.device("cuda", torch.cuda.current_device())
    for mod in (x1, x2, x3):
        mod.reset_launch_counts()
    rows = {"x1": x1.main(), "x2": x2.main(), "x3": x3.main()}
    torch.cuda.synchronize()
    launches = {"x1": dict(x1.LAUNCHES), "x2": dict(x2.LAUNCHES), "x3": dict(x3.LAUNCHES)}
    print(f"phase 11 launches {json.dumps(launches)}", flush=True)
    entries = []

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain versions and X1's library loop need TF32 off")
    sub = slice(0, X_MODEL_LANES)
    for h in x1.WIDTHS:  # X1: exp_blockdiag.py:32 _loop_kernel, pallas_call :49
        x, w, b = x1.setup(h, dev)
        got = x1.chain(x, w, b, reps=X1_CHECK_REPS)
        want = x1.chain_plain(x, w, b, X1_CHECK_REPS)
        exact = x1_float64(x, w, b, X1_CHECK_REPS)
        check = compare_outputs(got, want, x1_scale(exact))
        check["model_max_abs_err"] = (
            got[:, sub] - x1.chain_model(x[:, sub], w, b, X1_CHECK_REPS)).abs().max().item()
        check["witness"] = x_witness(got, want, exact)
        print(f"compare x1_loop_h{h} at {X1_CHECK_REPS} reps: {json.dumps(check)}")
        check_outputs(f"x1_loop_h{h}", check)
        plain_ms = time_cuda(lambda: x1.chain_plain(x, w, b, x1.REPS), 1)
        library_ms = time_cuda(lambda: x1_library(x, w, b, x1.REPS), 3)
        ms = next(r["ms"] for r in rows["x1"] if r["hidden"] == h)
        lanes = x.shape[1]
        entry = _x_entry(f"x1_loop_h{h}", "exp_blockdiag.py", 32, launches["x1"][h], check, ms,
                         plain_ms, x1.REPS * lanes * h * h, 8 * h * lanes + 4 * (h * h + h),
                         PEAK_FP32_FLOPS, tf32=True)
        entries.append(dict(entry, library_ms=library_ms))
        print(f"x1_loop_h{h}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, cuBLAS reps loop "
              f"(addmm + relu_) {library_ms:.3f} ms, bound {entry['bound_ms']:.3f} ms (3xTF32), "
              f"{entry['fp32_bound_ms']:.3f} ms (FP32) [{card}]", flush=True)

    gen = torch.Generator(dev).manual_seed(1)
    pts = torch.rand((X3_WITNESS_POINTS, 3), generator=gen, device=dev) * 2.4 - 1.2
    weights, biases, dirs, t0, origin = x2.setup(dev)
    params = checkpoint.load(ASSET, device=dev)  # csg_demo, whose padded stack X2 runs
    n, n_layers = dirs.shape[1], weights.shape[0]
    step_fmas = x2.STEPS * n * chain_fmas(weights.shape[1], n_layers, 3)
    nbytes = n * (12 + 4 + 4) + 4 * (weights.numel() + biases.numel())
    witness = {tp: x2_witness(weights, biases, params, pts, tp) for tp in (False, True)}
    for variant, three_pass in sorted({(r["variant"], r["three_pass"]) for r in rows["x2"]}):
        key = variant + ("_3pass" if three_pass else "")  # X2: exp_stepcost.py:33 make_kernel
        want = []

        def run_plain():
            want.append(x2.step_cost_plain(variant, weights, biases, dirs, t0, origin,
                                           three_pass=three_pass))

        plain_ms = time_cuda(run_plain, 1)
        start = time.perf_counter()
        got = x2.step_cost(variant, weights, biases, dirs, t0, origin, three_pass=three_pass)
        check = x2_check(variant, x2_chains(weights, biases, params, three_pass),
                         lambda p: sdf_float64(params, p), (dirs, t0, origin), got, want[0],
                         steps=x2.STEPS, sdf_atol=K2H_SDF_ATOL if three_pass else K1_MMA_SDF_ATOL,
                         stride=X2_SAMPLE_STRIDE)
        kw = dict(steps=X2_MODEL_STEPS, three_pass=three_pass)
        model_rays = (dirs[:, sub].contiguous(), t0[:, sub].contiguous(), origin)
        check["model_max_abs_err"] = (x2.step_cost(variant, weights, biases, *model_rays, **kw)
                                      - x2.step_cost_model(variant, weights, biases, *model_rays,
                                                           **kw)).abs().max().item()
        check["witness"] = witness[three_pass]
        u = check["beyond"]
        print(f"compare x2_{key} at the JAX sizes: {json.dumps(check)}")
        tw = u["t_witness"] or dict.fromkeys(("kernel_mean", "kernel_max", "plain_mean",
                                              "plain_max"), 0.0)
        print(f"x2_{key}: {u['lanes']} of {n} lanes beyond X_RTOL ({u['n_undecided']} part at a "
              f"test float32 cannot decide, {u['n_decided']} at one it decides, "
              f"{u['n_unparted']} never take another branch); {u['replayed']} lanes replayed, "
              f"{'landing' if u['replay_equal'] else 'NOT landing'} on both sides; "
              f"|SDF - float64| / (|float64| + 1) on their paths kernel mean "
              f"{u['err_mean'][0]:.3g} max {u['err_max'][0]:.3g}, plain mean "
              f"{u['err_mean'][1]:.3g} max {u['err_max'][1]:.3g}; |t - t64| / (|t64| + 1) "
              f"kernel mean {tw['kernel_mean']:.3g} max {tw['kernel_max']:.3g}, plain mean "
              f"{tw['plain_mean']:.3g} max {tw['plain_max']:.3g}; checked in "
              f"{time.perf_counter() - start:.1f} s", flush=True)
        check_outputs(f"x2_{key}", check)
        ms = next(r["ms"] for r in rows["x2"]
                  if (r["variant"], r["three_pass"]) == (variant, three_pass))
        entries.append(_x_entry(f"x2_{key}", "exp_stepcost.py", 33, launches["x2"][key], check,
                                ms, plain_ms, step_fmas * (3 if three_pass else 1), nbytes,
                                PEAK_BF16_FLOPS if three_pass else PEAK_FP32_FLOPS,
                                tf32=not three_pass))

    weights, biases, dirs, t0, origin = x3.setup(dev)
    zero = torch.zeros_like(t0)
    wit_rays = x3_witness_rays(pts)
    for variant in sorted({x3.KERNEL_OF[r["variant"]][0] for r in rows["x3"]}):
        # X3: exp_stepcost2.py:54 make_kernel; x-carried variants from t0,
        # t-carried ones from 0 so that t carries the SDF at full precision
        steps = X3_CHECK_STEPS.get(variant, X3_CHECK_STEPS_DEFAULT)
        start = t0 if variant in ("v0", "v1", "v2") else zero
        got = x3.ablation(variant, weights, biases, dirs, start, origin, steps=steps)
        check = compare_outputs(
            got, x3.ablation_plain(variant, weights, biases, dirs, start, origin, steps=steps),
            x_scale(variant, steps))
        check["model_max_abs_err"] = (got[:, sub] - x3.ablation_model(
            variant, weights, biases, dirs[:, sub], start[:, sub], origin, steps=steps)
        ).abs().max().item()
        check["witness"] = x_witness(
            x3.ablation(variant, weights, biases, *wit_rays, steps=1),
            x3.ablation_plain(variant, weights, biases, *wit_rays, steps=1),
            x3_float64(variant, weights, biases, pts))
        print(f"compare x3_{variant} at {steps} steps: {json.dumps(check)}")
        check_outputs(f"x3_{variant}", check)
        plain_ms = time_cuda(
            lambda: x3.ablation_plain(variant, weights, biases, dirs, t0, origin), 1)
        ms = next(r["ms"] for r in rows["x3"] if x3.KERNEL_OF[r["variant"]][0] == variant)
        h = weights.shape[1]
        if variant in ("v0", "v1", "v2"):
            fmas, peak = x3.STEPS * n_layers * n * h * h, PEAK_FP32_FLOPS
        else:
            passes = {"v3": 1, "v5": 6, "v5p": 5}[variant]
            fmas = passes * x3.STEPS * n * chain_fmas(h, n_layers, 3)
            peak = PEAK_FP32_FLOPS if passes == 1 else PEAK_BF16_FLOPS
        entries.append(_x_entry(f"x3_{variant}", "exp_stepcost2.py", 54,
                                launches["x3"][variant], check, ms, plain_ms, fmas, nbytes, peak,
                                tf32=peak == PEAK_FP32_FLOPS))
    for e in entries:
        if e["launches"] == 0:
            raise RuntimeError(f"{e['name']}: main() never launched the kernel")
    return entries


# Phase 12: training on the card (cudaneuralrender_torch/diff), at 1080p
# with csg_demo, the staged mixed config. TRAIN_WARM untimed and
# TRAIN_TIMED timed steps of pixel_train_step_fast, then train_loop_fast
# over TRAIN_LOOP steps from the same start against the sequential steps.
TRAIN_SIDE = (1920, 1080)
TRAIN_LR = 1e-4
TRAIN_WARM, TRAIN_TIMED, TRAIN_LOOP = 2, 5, 8
TRAIN_NOISE, TRAIN_SEED = 0.01, 7
# Whether the loss falls is read on the shipped architecture distilled to a
# sphere (as tests/test_diff.py's tiny_params): csg_demo's ReLU normals are
# constant on small regions, so its pixel loss rises under Adam in both
# packages (PERF.md, ROADMAP §3); the implicit gradient predicts the loss only
# for parameter steps below SURROGATE_ETAS' scale, which is printed.
SPHERE_RADIUS, SPHERE_FIT_STEPS, SPHERE_FIT_BATCH, SPHERE_FIT_LR = 0.7, 300, 2048, 3e-3
SURROGATE_ETAS = (1e-6, 1e-5, 1e-4, 1e-3)
# The pipelined loop reorders host reads only: its losses and parameters
# equal the sequential steps' (as tests/test_diff.py:412-445 holds JAX's);
# atol for parameters that are near 0.
TRAIN_LOOP_RTOL, TRAIN_LOOP_ATOL = 1e-6, 1e-7
# The card's gradient against the CPU's on the same solve and inputs: the
# plain chains sum in other orders on the two devices.
TRAIN_GRAD_RTOL = 1e-4
SDF_FIT_BATCH, SDF_FIT_STEPS, SDF_FIT_EIKONAL, SDF_FIT_LR = 8192, 20, 0.1, 2e-3
DENSE_TRAIN_SIDE, DENSE_TRAIN_MAX_STEPS, DENSE_TRAIN_STEPS = 256, 300, 3


def _train_target(cnr, params, cfg):
    """The port's ``render_image_diff`` of ``params`` at Camera(rotation_y=24),
    its surface from ``solve_surface``."""
    from cudaneuralrender_torch import diff

    cam = cnr.Camera(rotation_y=24.0)
    with torch.no_grad():
        t_star, hit = diff.solve_surface(params, cam, cfg)
        return diff.render_image_diff(params, cam, cfg, t_star=t_star, hit=hit)


def _leaves_close(a, b, rtol: float, atol: float) -> float:
    """Raise unless every tensor pair is within atol + rtol |b|; the
    largest |a - b| over all of them."""
    worst = 0.0
    for x, y in zip(a, b):
        x, y = x.detach(), y.detach()
        d = (x - y).abs()
        if bool((d > atol + rtol * y.abs()).any()):
            raise RuntimeError(f"tensors differ by up to {float(d.max()):.3g} "
                               f"(rtol {rtol}, atol {atol})")
        worst = max(worst, float(d.max()))
    return worst


def count_host_syncs(run) -> collections.Counter:
    """The synchronising CUDA calls ``run()`` makes, by the Python line
    that made them (``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the debug mode's own notice, that it is a prototype, is not a sync)
    return collections.Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                               for w in caught if "synchroniz" in str(w.message)
                               and "prototype" not in str(w.message))


def _sphere_batch(generator, n: int, radius: float):
    pts = torch.rand((n, 3), generator=generator, device=generator.device) * 2.4 - 1.2
    return pts, torch.linalg.vector_norm(pts, dim=-1) - radius


def drive_training(cnr, params, card) -> dict:
    """Phase 12: csg_demo trained at 1080p through ``diff`` on the card (the
    module docstring lists the steps). Returns K1's entry for the training
    solve: its launches in the timed steps, the agreement of every march
    call of a solve of the trained weights, that solve's coarse call
    timed both ways."""
    from cudaneuralrender_torch import diff
    from cudaneuralrender_torch.diff import train
    from cudaneuralrender_torch.examples.train_sdf import sample
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.models import mlp
    from cudaneuralrender_torch.ops import compaction
    from cudaneuralrender_torch.render import renderer as renderer_lib

    dev = params.device
    cfg = cnr.RenderConfig(width=TRAIN_SIDE[0], height=TRAIN_SIDE[1], march_impl="staged")
    target = _train_target(cnr, params, cfg)
    check_image(target, "training target", TRAIN_SIDE[1], TRAIN_SIDE[0])
    gen = torch.Generator().manual_seed(TRAIN_SEED)
    start = cnr.MLP([(l.w + TRAIN_NOISE * torch.randn(l.w.shape, generator=gen).to(dev),
                      l.b + TRAIN_NOISE * torch.randn(l.b.shape, generator=gen).to(dev))
                     for l in params])
    s0 = train.init_train_state(start, TRAIN_LR)
    cams = [cnr.Camera(rotation_y=20.0 + 2 * i) for i in range(TRAIN_LOOP)]

    # Sequential steps, one stats dict shared: from the second on the
    # pipelined packed path; its grad steps' buckets recorded.
    buckets = []
    real_packed = train._pixel_grad_step_packed

    def counting(state, camera, target, pos, t_packed, conv, config, lr, cap, within):
        buckets.append(cap)
        return real_packed(state, camera, target, pos, t_packed, conv, config, lr, cap, within)

    state, stats, losses, step_ms, rows = s0, {}, [], [], []
    trained = None
    train._pixel_grad_step_packed = counting
    try:
        for i in range(TRAIN_LOOP):
            if i == TRAIN_WARM:
                megakernel.reset_launch_counts()
                first_bucket = len(buckets)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = train.pixel_train_step_fast(state, cams[i], target, cfg, TRAIN_LR,
                                                      stats_out=stats)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            rows.append(dict(stats, bucket=buckets[-1] if buckets else None))
            if i == TRAIN_WARM + TRAIN_TIMED - 1:
                launches = megakernel.KERNEL_LAUNCHES
                timed_buckets = len(buckets) - first_bucket
                trained = state
    finally:
        train._pixel_grad_step_packed = real_packed
    print(f"phase 12 sequential steps: {json.dumps(rows)}", flush=True)
    print(f"phase 12 losses {losses}")
    timed = rows[TRAIN_WARM:TRAIN_WARM + TRAIN_TIMED]
    if not all(r["fast_path"] for r in timed):
        raise RuntimeError(f"a timed 1080p training step left the fast path: {timed}")
    if timed_buckets < TRAIN_TIMED:
        raise RuntimeError(f"{timed_buckets} packed grad steps in {TRAIN_TIMED} timed steps: "
                           "the pipelined packed path was not taken")
    if launches == 0:
        raise RuntimeError("the training solve never launched the march kernel")
    per_step = launches / TRAIN_TIMED
    seq_ms = statistics.median(step_ms[TRAIN_WARM:TRAIN_WARM + TRAIN_TIMED])
    print(f"phase 12 K1 launches: {launches} in {TRAIN_TIMED} timed steps, {per_step:.1f} a step")

    # The loss along the gradient of the trained state at a fixed solve:
    # how far the first-order prediction holds.
    with torch.no_grad():
        t_star, hit = diff.solve_surface(trained.params, cams[0], cfg)
    loss0 = diff.pixel_loss(trained.params, cams[0], cfg, target, t_star=t_star, hit=hit)
    grads = train._grads(loss0, trained.params)
    gnorm = float(torch.sqrt(sum((g ** 2).sum() for g in grads)))
    drops = []
    for eta in SURROGATE_ETAS:
        moved = cnr.MLP([(w.detach() - eta / gnorm * gw, b.detach() - eta / gnorm * gb)
                         for (w, b), gw, gb in zip(trained.params, grads[0::2], grads[1::2])])
        with torch.no_grad():
            loss = diff.pixel_loss(moved, cams[0], cfg, target, t_star=t_star, hit=hit)
        drops.append((eta, float(loss - loss0.detach()), -eta * gnorm))
    print(f"phase 12 csg_demo loss along -grad at a fixed solve (step, change, first-order "
          f"prediction): {drops}")

    # The pipelined loop from the same start, against the sequential steps.
    loop_stats = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop_state, loop_losses = train.train_loop_fast(s0, cams, target, cfg, TRAIN_LR,
                                                    stats_out=loop_stats)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_LOOP
    loss_err = _leaves_close([torch.tensor(loop_losses)], [torch.tensor(losses)],
                             TRAIN_LOOP_RTOL, 0.0)
    param_err = _leaves_close(train._state_leaves(loop_state), train._state_leaves(state),
                              TRAIN_LOOP_RTOL, TRAIN_LOOP_ATOL)
    print(f"phase 12 train_loop_fast: {TRAIN_LOOP} steps, losses within {loss_err:.3g}, "
          f"state within {param_err:.3g} of the sequential steps; fast path "
          f"{[r.get('fast_path') for r in loop_stats]}")

    # K1 on a solve of the trained weights, counted as a check, not the
    # main path; the packed stack follows the update: the solve equals a
    # solve of the same weights loaded fresh.
    fresh = mlp.from_numpy_params(mlp.to_numpy_params(trained.params), device=dev)
    with uncounted(), torch.no_grad():
        calls = record_calls(lambda: diff.solve_surface(trained.params, cams[0], cfg))
        result = compare_recorded_calls(trained.params, calls)
        ms, plain_ms, bnd = time_coarse(trained.params, calls)
        a, b = diff.solve_surface(trained.params, cams[0], cfg), diff.solve_surface(
            fresh, cams[0], cfg)
    for name, agree in result.items():
        print(f"compare training solve {name}: {json.dumps(agree)}")
    check_agreement(result)
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise RuntimeError("the solve of the trained weights differs from a solve of the "
                           "same weights loaded fresh: a stale packed stack")

    # One gradient on the card and the same on the CPU.
    with torch.no_grad():
        t_star, hit = diff.solve_surface(trained.params, cams[0], cfg)
    cap = compaction.capacity_pow2_of(int(hit.sum()), cfg.num_rays, minimum=cfg.compact_min)

    def grad_on(p, d):
        loss = diff.pixel_loss(p, cams[0], cfg, target.to(d), t_star=t_star.to(d),
                               hit=hit.to(d), compact_cap=cap)
        return train._grads(loss, p)

    g_card = [g.cpu() for g in grad_on(trained.params, dev)]
    cpu_params = train._trainable(mlp.from_numpy_params(mlp.to_numpy_params(trained.params),
                                                        device="cpu"))
    g_cpu = grad_on(cpu_params, torch.device("cpu"))
    delta = float(torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(g_card, g_cpu))))
    norm = float(torch.sqrt(sum((y ** 2).sum() for y in g_cpu)))
    print(f"phase 12 gradient card vs CPU ({cap}-lane bucket): |d| {delta:.4g}, "
          f"|g_cpu| {norm:.4g}, ratio {delta / norm:.3g}")
    if not (norm > 0 and delta <= TRAIN_GRAD_RTOL * norm):
        raise RuntimeError(f"card gradient off the CPU's: {delta} > {TRAIN_GRAD_RTOL} * {norm}")

    # The step split: the packed solve and the grad + update, CUDA events.
    hint = rows[-1]["hits"]
    within = renderer_lib._conv_within(renderer_lib.memo_lookup(trained.params, cfg))
    bucket = min(compaction.capacity_pow2_of(hint, cfg.num_rays, minimum=cfg.compact_min),
                 within)
    solve_ms = time_cuda(lambda: diff.solve_surface_packed_async(trained.params, cams[0], cfg),
                         TRAIN_TIMED, warmup=1)
    pos, t_p, conv, w_bound, _ = diff.solve_surface_packed_async(trained.params, cams[0], cfg)
    grad_ms = time_cuda(lambda: train._pixel_grad_step_packed(
        trained, cams[0], target, pos, t_p, conv, cfg, TRAIN_LR, bucket, w_bound),
        TRAIN_TIMED, warmup=1)
    prof = profile_breakdown(lambda: train.pixel_train_step_fast(
        trained, cams[0], target, cfg, TRAIN_LR, stats_out=dict(rows[-1])))
    syncs = count_host_syncs(lambda: train.pixel_train_step_fast(
        trained, cams[0], target, cfg, TRAIN_LR, stats_out=dict(rows[-1])))
    side = f"{TRAIN_SIDE[0]}x{TRAIN_SIDE[1]}"
    print(f"train step {side}: median {seq_ms:.3f} ms over {TRAIN_TIMED} sequential steps "
          f"{[round(x, 3) for x in step_ms]}; solve {solve_ms:.3f} ms, grad + update "
          f"{grad_ms:.3f} ms ({bucket}-lane bucket); loop {loop_ms:.3f} ms a step amortized "
          f"over {TRAIN_LOOP}; K1 {per_step:.1f} launches a step [{card}]")
    print(f"train step {side} profile: {json.dumps(prof)} [{card}]")
    print(f"train step {side} host syncs: {sum(syncs.values())} {json.dumps(syncs.most_common())}")

    # The loss falls: the shipped architecture distilled to a sphere, the
    # same noise, target and steps.
    net = cnr.init_mlp(torch.Generator().manual_seed(3), device=dev)
    sphere, _ = train.fit_sdf(
        net, lambda g, n: _sphere_batch(g, n, SPHERE_RADIUS), steps=SPHERE_FIT_STEPS,
        batch=SPHERE_FIT_BATCH, lr=SPHERE_FIT_LR)
    sphere.requires_grad_(False)
    starget = _train_target(cnr, sphere, cfg)
    gen = torch.Generator().manual_seed(TRAIN_SEED)
    state = train.init_train_state(cnr.MLP(
        [(l.w + TRAIN_NOISE * torch.randn(l.w.shape, generator=gen).to(dev),
          l.b + TRAIN_NOISE * torch.randn(l.b.shape, generator=gen).to(dev)) for l in sphere]),
        TRAIN_LR)
    stats, sphere_losses = {}, []
    for cam in cams:
        state, loss = train.pixel_train_step_fast(state, cam, starget, cfg, TRAIN_LR,
                                                  stats_out=stats)
        sphere_losses.append(float(loss))
    print(f"phase 12 sphere-distilled net: losses {sphere_losses}")
    if not min(sphere_losses[1:]) < sphere_losses[0]:
        raise RuntimeError(f"the training loss did not fall: {sphere_losses}")

    # SDF fitting: the shipped architecture against train_sdf's target.
    net = cnr.init_mlp(torch.Generator().manual_seed(0), device=dev)
    fit = train.init_train_state(net, SDF_FIT_LR)
    sgen = torch.Generator(device=dev).manual_seed(0)
    fit_ms, fit_losses = [], []
    for _ in range(SDF_FIT_STEPS):
        pts, d = sample(sgen, SDF_FIT_BATCH)
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        start_ev.record()
        fit, loss = train.sdf_train_step(fit, pts, d, SDF_FIT_LR, eikonal_weight=SDF_FIT_EIKONAL)
        end_ev.record()
        torch.cuda.synchronize()
        fit_ms.append(start_ev.elapsed_time(end_ev))
        fit_losses.append(float(loss))
    print(f"sdf_train_step batch {SDF_FIT_BATCH}, eikonal {SDF_FIT_EIKONAL}: median "
          f"{statistics.median(fit_ms[1:]):.3f} ms over {SDF_FIT_STEPS - 1} warm steps; losses "
          f"{fit_losses[0]:.5f} -> {fit_losses[-1]:.5f} [{card}]")
    if not (np.isfinite(fit_losses).all() and min(fit_losses[1:]) < fit_losses[0]):
        raise RuntimeError(f"SDF fitting loss not finite or not falling: {fit_losses}")

    # The dense step: the surface solved by the dense march inside.
    dside = DENSE_TRAIN_SIDE
    dcfg = cnr.RenderConfig(width=dside, height=dside, max_steps=DENSE_TRAIN_MAX_STEPS,
                            march_impl="while")
    dtarget = _train_target(cnr, params, dcfg.replace(march_impl="staged"))
    dense, dense_ms, dense_losses = s0, [], []
    for _ in range(DENSE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense, loss = train.pixel_train_step(dense, cams[0], dtarget, dcfg, TRAIN_LR)
        dense_losses.append(float(loss))
        dense_ms.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(dense_losses).all():
        raise RuntimeError(f"dense training step losses not finite: {dense_losses}")
    print(f"pixel_train_step {dside}x{dside} (dense march, max_steps {DENSE_TRAIN_MAX_STEPS}): "
          f"median {statistics.median(dense_ms):.3f} ms over {DENSE_TRAIN_STEPS} "
          f"{[round(x, 3) for x in dense_ms]}; losses {dense_losses} [{card}]", flush=True)
    return dict(launches=launches, max_abs_err=max(a["max_abs_err"] for a in result.values()),
                ms=ms, plain_ms=plain_ms, bnd=bnd)


# Phase 13: the render package. The turntable's frames: csg_demo at 1080p,
# Camera(rotation_x=-20, rotation_y=30 + i), frame number i.
RENDER_FRAMES = 24
CHUNKS = (1, 4, 8, 24)
CHUNK_SCENES = ("neural_raw", "many_sphere")
PROFILED_CHUNK = 8
# Warm against cold, per frame after the first (tests/test_render.py:236-300).
WARM_MIN_HIT_AGREE = 0.995
WARM_MIN_EQUAL = 0.98
MATCAP = os.path.join(ROOT, "benchmarks", "recovered_matcaps", "plane_1.png")
# The card against the port's CPU render (item 10) at this side. The
# tetrahedron frames are compared at TET_NORMAL_EPS: at the reference's
# 1e-5 the 4-tap difference of four float32 SDF values leaves ~2.5e-3 of
# noise in a normal (tests/test_torch_staged_shading.py), which two devices
# summing in their own orders cannot share. At 1e-5 the card's normals are
# held against the same formula in float64 instead, as that test holds the
# CPU port's against JAX's: mean and largest error within TET_WITNESS_MEAN
# and TET_WITNESS_MAX times the CPU port's.
ITEM10_SIDE = 256
TET_NORMAL_EPS = 1e-3
TET_WITNESS_MEAN, TET_WITNESS_MAX = 1.5, 2.0
VIEWER_REQUESTS = 3
MULTIGEOM_COPIES = 4  # csg_demo and this many noisy copies (phase 12's noise)
BATCH_SIDE, BATCH_MAX_STEPS = 128, 500  # the dense march syncs the host every step


def _turntable(cnr, n=RENDER_FRAMES):
    cams = [cnr.Camera(rotation_x=CAMERA["rotation_x"], rotation_y=CAMERA["rotation_y"] + i)
            for i in range(n)]
    return cams, [float(i) for i in range(n)]


def _timed_sequence(cnr, params, cams, cfg, frames, **kw) -> tuple:
    """One synchronised ``render_sequence`` call: (images, stats, ms/frame)."""
    stats = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cnr.render_sequence(params, cams, cfg, frames=frames, stats_out=stats, **kw)
    torch.cuda.synchronize()
    return out, stats, (time.perf_counter() - t0) * 1e3 / len(cams)


def _frame_groups(calls) -> list:
    """Recorded march calls split into frames: each frame opens with its
    coarse call (``coarse=True``)."""
    groups = []
    for call in calls:
        if call[5].get("coarse") or not groups:
            groups.append([])
        groups[-1].append(call)
    return groups


def drive_warm(cnr, params, card) -> dict:
    """Phase 13, warm turntable: 24 frames cold and warm. Returns the warm
    march kernel's entry: launches of the timed warm sequence, kernel =
    plain on every march call of a warm frame, its coarse call both ways."""
    from cudaneuralrender_torch.kernels import megakernel

    cfg = cnr.RenderConfig(width=1920, height=1080, march_impl="staged")
    cams, frames = _turntable(cnr)
    _timed_sequence(cnr, params, cams, cfg, frames)  # teaches the memo its caps
    cold, cold_stats, cold_ms = _timed_sequence(cnr, params, cams, cfg, frames)
    _timed_sequence(cnr, params, cams, cfg, frames, warm_start=True)
    megakernel.reset_launch_counts()
    warm, warm_stats, warm_ms = _timed_sequence(cnr, params, cams, cfg, frames,
                                                warm_start=True)
    launches = megakernel.KERNEL_LAUNCHES
    if launches == 0:
        raise RuntimeError("the warm turntable never launched the march kernel")
    if not torch.equal(warm[0], cold[0]):
        raise RuntimeError("warm frame 0 differs from the cold frame 0")
    agree, equal = [], []
    for c, w in zip(cold[1:], warm[1:]):
        agree.append(((c[..., 3] > 0) == (w[..., 3] > 0)).float().mean().item())
        equal.append((c == w).all(dim=-1).float().mean().item())
    print(f"warm turntable 1080p, {len(cams)} frames: cold {cold_ms:.3f} ms/frame, warm "
          f"{warm_ms:.3f} ms/frame, {launches} kernel launches warm; frames 1-: hit masks agree "
          f"min {min(agree):.6f}, equal pixels min {min(equal):.6f}; steps cold "
          f"{[s['steps'] for s in cold_stats]} warm {[s['steps'] for s in warm_stats]} [{card}]")
    if min(agree) < WARM_MIN_HIT_AGREE or min(equal) < WARM_MIN_EQUAL:
        raise RuntimeError(f"warm turntable: hit agreement {agree}, equal pixels {equal}")
    if not all(s["fast_path"] for s in warm_stats + cold_stats):
        raise RuntimeError("a turntable frame left the fast path")
    for i in (0, len(cams) - 1):
        check_image(warm[i], f"warm turntable frame {i}")

    warm_calls = _frame_groups(record_calls(lambda: cnr.render_sequence(
        params, cams[:3], cfg, frames=frames[:3], warm_start=True)))[-1]
    cold_calls = _frame_groups(record_calls(lambda: cnr.render_sequence(
        params, cams[2:3], cfg, frames=frames[2:3])))[-1]
    result = compare_recorded_calls(params, warm_calls)
    for name, a in result.items():
        print(f"compare warm frame 2 {name}: {json.dumps(a)}")
    check_agreement(result)
    ms, plain_ms, bnd = time_coarse(params, warm_calls)
    cold_ms_call, cold_plain, _ = time_coarse(params, cold_calls)
    lanes = int(warm_calls[0][2].active.sum())
    warm_lanes = int((warm_calls[0][2].t > cold_calls[0][2].t).sum())
    print(f"warm turntable frame 2: coarse call kernel {ms:.3f} ms (cold {cold_ms_call:.3f}), "
          f"plain {plain_ms:.3f} ms (cold {cold_plain:.3f}); {warm_lanes} of {lanes} active "
          f"lanes start warm; bound {bnd['bound_ms']:.3f} ms [{card}]", flush=True)
    for name, kw in (("cold", {}), ("warm", dict(warm_start=True))):
        prof = profile_breakdown(lambda: cnr.render_sequence(params, cams[:3], cfg,
                                                             frames=frames[:3], **kw))
        print(f"warm turntable, 3 frames {name}: {json.dumps(prof)} [{card}]")
    return dict(launches=launches, max_abs_err=max(a["max_abs_err"] for a in result.values()),
                ms=ms, plain_ms=plain_ms, bnd=bnd)


def drive_chunks(cnr, params, card) -> None:
    """Phase 13, fused chunks: the 24 frames under neural_raw and
    many_sphere, ``chunk`` in CHUNKS, each chunked sequence equal to
    ``chunk=1`` bit for bit, images and stats; captures one per key."""
    from cudaneuralrender_torch.render import renderer as renderer_lib

    cams, frames = _turntable(cnr)
    for scene in CHUNK_SCENES:
        cfg = cnr.RenderConfig(width=1920, height=1080, march_impl="staged", scene=scene)
        if renderer_lib.frame_reads_host(renderer_lib.memo_lookup(params, cfg)):
            raise RuntimeError(f"{scene}: the 1080p staged config reads the host")
        _timed_sequence(cnr, params, cams, cfg, frames)  # teaches the memo its caps
        ref, ref_stats, ref_ms = _timed_sequence(cnr, params, cams, cfg, frames)
        rows = {1: dict(ms_per_frame=ref_ms)}
        for k in CHUNKS[1:]:
            before = renderer_lib.graph_stats()
            first, first_stats, first_ms = _timed_sequence(cnr, params, cams, cfg, frames,
                                                           chunk=k)
            out, stats, ms = _timed_sequence(cnr, params, cams, cfg, frames, chunk=k)
            after = renderer_lib.graph_stats()
            graph = [g for g in after["graphs"] if g["k"] == k and g["scene"] == scene][-1]
            captures = after["captures"] - before["captures"]
            replays = after["replays"] - before["replays"]
            for images, st in ((first, first_stats), (out, stats)):
                unequal = [i for i, (a, b) in enumerate(zip(ref, images)) if not torch.equal(a, b)]
                if unequal or st != ref_stats or len(images) != len(ref):
                    raise RuntimeError(f"{scene} chunk={k}: frames {unequal} differ from "
                                       f"chunk=1, stats equal {st == ref_stats}")
            if captures != 1 or replays != 2 * (-(-len(cams) // k)):
                raise RuntimeError(f"{scene} chunk={k}: {captures} captures, {replays} replays")
            rows[k] = dict(ms_per_frame=ms, first_call_ms_per_frame=first_ms,
                           capture_ms=graph["capture_ms"], march_nodes=graph["march_nodes"],
                           replays=replays)
        print(f"chunks 1080p {scene}, {len(cams)} frames, all equal to chunk=1 bit for bit: "
              f"{json.dumps(rows)} [{card}]")
        sub = slice(0, PROFILED_CHUNK)
        per_frame = profile_breakdown(lambda: cnr.render_sequence(
            params, cams[sub], cfg, frames=frames[sub]))
        chunked = profile_breakdown(lambda: cnr.render_sequence(
            params, cams[sub], cfg, frames=frames[sub], chunk=PROFILED_CHUNK))
        for name, prof in (("per frame", per_frame), (f"chunk={PROFILED_CHUNK}", chunked)):
            prof = {k: v for k, v in prof.items() if k != "march_kernel_ms"}
            print(f"chunks 1080p {scene}, {PROFILED_CHUNK} frames {name}: {json.dumps(prof)} "
                  f"[{card}]")
        renderer_lib.reset_graphs()
    print(f"graphs: {json.dumps(renderer_lib.graph_stats())}", flush=True)


def drive_item10(cnr, params, card) -> None:
    """Phase 13, matcap shading and tetrahedron normals through the staged
    path: 1080p frames beside the main path's, the card against the
    port's CPU render at ITEM10_SIDE, and the tetrahedron normals at the
    reference's normal_eps against float64 (``tet_normals_witness``)."""
    from cudaneuralrender_torch.utils import image_io

    matcap = image_io.load_matcap(MATCAP)
    cpu_params = cnr.load(ASSET, device="cpu")
    cam = cnr.Camera(**CAMERA)
    times = {}
    for name, fields in (("main path", {}), ("matcap", dict(shading="matcap")),
                         ("tetrahedron", dict(normal_mode="tetrahedron"))):
        cfg = cnr.RenderConfig(width=1920, height=1080, march_impl="staged", **fields)
        r = cnr.Renderer(params, cfg, matcap if "shading" in fields else None)
        r.render(cam)  # cold: may teach the memo
        check_image(r.render(cam), name)
        times[name] = statistics.median(time_frames(lambda: r.render(cam, 0.0), 3))
    print(f"item 10 1080p staged frames, median of 3 warm: "
          f"{json.dumps({k: round(v, 3) for k, v in times.items()})} ms [{card}]")
    for name, fields in (("matcap", dict(shading="matcap")),
                         ("tetrahedron", dict(normal_mode="tetrahedron",
                                              normal_eps=TET_NORMAL_EPS))):
        cfg = cnr.RenderConfig(width=ITEM10_SIDE, height=ITEM10_SIDE, march_impl="staged",
                               **fields)
        mc = matcap if "shading" in fields else None
        card_img = cnr.Renderer(params, cfg, mc).render(cam)
        cpu_img = cnr.Renderer(cpu_params, cfg, mc).render(cam).to(card_img.device)
        mixed_bar(card_img, cpu_img, f"item 10 {name} {ITEM10_SIDE}x{ITEM10_SIDE}, the card",
                  "the CPU render")
    tet_normals_witness(cnr, params, cpu_params, cam, card)


def tet_normals_witness(cnr, params, cpu_params, cam, card) -> None:
    """Tetrahedron normals at the reference's normal_eps (1e-5, the default
    config's), on the card: the 4-tap normals a staged ITEM10_SIDE^2 frame
    shades with (taken at ``shading.tetrahedron_normals`` with the points
    and eps the frame passes it) against the same formula in float64 at
    1e-5; their mean and largest error must lie within TET_WITNESS_MEAN and
    TET_WITNESS_MAX times the port's CPU normals' at the same points."""
    from cudaneuralrender_torch.ops import shading
    from cudaneuralrender_torch.render import renderer as renderer_lib

    cfg = cnr.RenderConfig(width=ITEM10_SIDE, height=ITEM10_SIDE, march_impl="staged",
                           normal_mode="tetrahedron")
    plain, calls = shading.tetrahedron_normals, []

    def taken(sdf_fn, points, eps=1e-5):
        normals = plain(sdf_fn, points, eps)
        calls.append((points.detach(), eps, normals.detach()))
        return normals

    shading.tetrahedron_normals = taken
    try:
        check_image(cnr.Renderer(params, cfg).render(cam), "item 10 tetrahedron witness frame",
                    ITEM10_SIDE, ITEM10_SIDE)
    finally:
        shading.tetrahedron_normals = plain
    eps = 1e-5
    if not calls or any(e != eps for _, e, _ in calls):
        raise RuntimeError(f"item 10 tetrahedron witness: the frame shaded with eps "
                           f"{[e for _, e, _ in calls]}, not the reference's {eps}")
    pts = torch.cat([c[0] for c in calls]).cpu()
    n_card = torch.cat([c[2] for c in calls]).cpu()
    n_cpu = plain(renderer_lib.shade_fn(cpu_params, cfg, 0.0), pts, eps)
    p64 = cnr.from_numpy_params(cnr.mlp.to_numpy_params(cpu_params), device="cpu",
                                dtype=torch.float64)
    verts = torch.from_numpy(shading.TETRAHEDRON_VERTS).double()
    taps = pts.double()[:, None, :] + verts[None] * eps
    d = cnr.mlp.apply_scalar(p64, taps.reshape(-1, 3)).reshape(-1, 4) @ verts
    n64 = d / d.norm(dim=-1, keepdim=True)
    err_card = (n_card.double() - n64).abs().amax(-1)
    err_cpu = (n_cpu.double() - n64).abs().amax(-1)
    share = (n_card - n_cpu).abs().amax(-1).lt(1e-3).float().mean().item()
    print(f"item 10 tetrahedron normals at normal_eps {eps}, the {pts.shape[0]} points a "
          f"{ITEM10_SIDE}x{ITEM10_SIDE} staged frame shades: |n - float64| mean / max, the "
          f"card {err_card.mean().item():.6g} / {err_card.max().item():.6g}, the CPU "
          f"{err_cpu.mean().item():.6g} / {err_cpu.max().item():.6g}; the card within 1e-3 "
          f"of the CPU on {share:.6f} [{card}]")
    if pts.shape[0] < 500 or not bool(torch.isfinite(n_card).all()):
        raise RuntimeError(f"item 10 tetrahedron witness: {pts.shape[0]} points, or normals "
                           "not finite")
    if (err_card.mean() > TET_WITNESS_MEAN * err_cpu.mean()
            or err_card.max() > TET_WITNESS_MAX * err_cpu.max()):
        raise RuntimeError("item 10 tetrahedron normals at the reference's normal_eps: the "
                           "card's error against float64 exceeds the CPU port's by more than "
                           f"{TET_WITNESS_MEAN}x (mean) or {TET_WITNESS_MAX}x (max)")



def drive_interactive(cnr, params, card) -> None:
    """Phase 13, interactive frames at 1080p: bytes against the synchronous
    frame, each path's time and the fetch of u32 against float32 pixels,
    and the viewer answering VIEWER_REQUESTS frames."""
    import threading
    import urllib.request

    from cudaneuralrender_torch.render import viewer

    cfg = cnr.RenderConfig(width=1920, height=1080, march_impl="staged")
    r = cnr.Renderer(params, cfg)
    cam = cnr.Camera(**CAMERA)
    sync_img = r.render_frame(cam)
    for _ in range(2):
        inter_img = r.render_frame_interactive(cam)
        if not np.array_equal(inter_img, sync_img):
            raise RuntimeError("render_frame_interactive's bytes differ from render_frame's")

    def wall(fn, reps=3):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    rgba = r.render(cam)
    packed = r.render_interactive_packed(cam)
    torch.cuda.synchronize()
    ms = dict(render_frame=wall(lambda: r.render_frame(cam)),
              render_frame_interactive=wall(lambda: r.render_frame_interactive(cam)),
              fetch_f32=wall(lambda: rgba.cpu(), 5), fetch_u32=wall(lambda: packed.cpu(), 5))
    print(f"interactive 1080p, median ms: {json.dumps({k: round(v, 3) for k, v in ms.items()})}; "
          f"last_stats {json.dumps(r.last_stats)} [{card}]")
    srv = viewer.make_server(r, cam, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    latency = []
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/frame?rx=-20&ry="
        for i in range(VIEWER_REQUESTS):
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"{url}{30 + i}&zoom=2", timeout=120) as resp:
                body = resp.read()
            latency.append((time.perf_counter() - t0) * 1e3)
            if resp.status != 200 or not body.startswith(b"\x89PNG"):
                raise RuntimeError(f"viewer /frame answered {resp.status}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    print(f"viewer 1080p: {VIEWER_REQUESTS} /frame requests, latency ms "
          f"{[round(x, 3) for x in latency]} [{card}]", flush=True)


def drive_multigeom(cnr, params, card) -> None:
    """Phase 13, multi-geometry batches: ``render_batch_staged`` over csg_demo
    and MULTIGEOM_COPIES noisy copies at 1080p, each frame equal to its own
    ``render_staged``, pipelined against sequential; ``render_batch`` at
    BATCH_SIDE equal to each geometry's ``render_image``."""
    from cudaneuralrender_torch.render import multigeom
    from cudaneuralrender_torch.utils import memo

    dev = params.device
    geoms = [params]
    for i in range(MULTIGEOM_COPIES):
        gen = torch.Generator().manual_seed(TRAIN_SEED + i)
        g = cnr.MLP([(l.w + TRAIN_NOISE * torch.randn(l.w.shape, generator=gen).to(dev),
                      l.b + TRAIN_NOISE * torch.randn(l.b.shape, generator=gen).to(dev))
                     for l in params])
        memo.tag_geometry(g, f"{ASSET} noisy copy {i}")  # a memo entry of its own
        geoms.append(g)
    cfg = cnr.RenderConfig(width=1920, height=1080, march_impl="staged")
    cam = cnr.Camera(**CAMERA)
    multigeom.render_batch_staged(geoms, cam, cfg)  # teaches each geometry's memo entry
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = []
    out = multigeom.render_batch_staged(geoms, cam, cfg, stats_out=stats)
    torch.cuda.synchronize()
    piped = (time.perf_counter() - t0) * 1e3 / len(geoms)
    t0 = time.perf_counter()
    singles = [cnr.render_staged(g, cam, cfg) for g in geoms]
    torch.cuda.synchronize()
    seq = (time.perf_counter() - t0) * 1e3 / len(geoms)
    unequal = [i for i, (a, b) in enumerate(zip(out, singles)) if not torch.equal(a, b)]
    print(f"multigeom 1080p, {len(geoms)} geometries: {piped:.3f} ms a geometry pipelined, "
          f"{seq:.3f} sequential; hits {[s['hits'] for s in stats]}, fast path "
          f"{[s['fast_path'] for s in stats]} [{card}]")
    if unequal:
        raise RuntimeError(f"multigeom: geometries {unequal} differ from their render_staged")
    for i, img in enumerate(out):
        check_image(img, f"multigeom geometry {i}")
    bcfg = cnr.RenderConfig(width=BATCH_SIDE, height=BATCH_SIDE, max_steps=BATCH_MAX_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = multigeom.render_batch(multigeom.stack_params(geoms), cam, bcfg)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    unequal = [i for i, g in enumerate(geoms)
               if not torch.equal(batch[i], cnr.render_image(g, cam, bcfg))]
    print(f"render_batch {BATCH_SIDE}x{BATCH_SIDE} (dense), {len(geoms)} geometries: "
          f"{batch_ms:.3f} ms [{card}]", flush=True)
    if unequal or tuple(batch.shape) != (len(geoms), BATCH_SIDE, BATCH_SIDE, 4):
        raise RuntimeError(f"render_batch: geometries {unequal} differ from render_image")


def drive_render_package(cnr, params, card) -> dict:
    """Phase 13 (the module docstring lists the steps). Returns the warm
    march kernel's entry."""
    entry = drive_warm(cnr, params, card)
    drive_chunks(cnr, params, card)
    drive_item10(cnr, params, card)
    drive_interactive(cnr, params, card)
    drive_multigeom(cnr, params, card)
    return entry


# Phase 14: parallel/ on the card, csg_demo at 1080p in the default staged
# config at CAMERA. The sharded frame's shard counts (1080 rows divide by
# each; a sharded frame must equal the single-device frame bit for bit: the
# march is per lane, and a shard's rungs march each ray as the frame's do;
# a band render or the 2-process world's image is held to ``mixed_bar``
# where it is not: a band widens its own buckets, or finishes densely); the
# sharded train step's shards; the fault drill's bands and injected faults;
# the 2-process world's image side and shards a rank (a quarter of 1080p's
# pixels keeps its two dense marches short).
PARALLEL_SIDE = (1920, 1080)
SHARDS = (1, 2, 4, 8)
TRAIN_SHARDS = 4
FAULT_BANDS, FAULT_INJECTED = 4, 2
WORLD_SIDE, WORLD_SHARDS = (960, 540), 2


def unequal_pixels(img, ref) -> int:
    return int((img != ref).any(dim=-1).sum())


def drive_sharded(cnr, params, card) -> tuple:
    """Phase 14, the sharded staged frame at SHARDS logical shards of the
    card: each equal to ``render_staged``'s bit for bit,
    its fast path, load stats and ms per frame beside the single-device
    frame's; the 8-shard frame's kernel launches (the main path of this
    phase) and once more a ray per thread throughout; the 1- and 8-shard
    frames profiled; shard 0's march calls of an 8-shard frame against the
    plain version, its coarse call timed both ways. Returns (the kernels line's entry, the single-device frame,
    the 2-shard frame)."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.parallel import mesh as mesh_lib
    from cudaneuralrender_torch.parallel import sharding

    dev = params.device
    cfg = cnr.RenderConfig(width=PARALLEL_SIDE[0], height=PARALLEL_SIDE[1], march_impl="staged")
    cam = cnr.Camera(**CAMERA)
    renderer = cnr.Renderer(params, cfg)
    ref = renderer.render(cam)
    single_ms = statistics.median(time_frames(lambda: renderer.render(cam, 0.0), 3))
    print(f"phase 14 single-device {cfg.width}x{cfg.height} frame: median {single_ms:.3f} ms over 3 [{card}]")
    frames = {}
    for n in SHARDS:
        mesh = mesh_lib.make_mesh((n,), ("data",), [dev] * n)
        sharding.render_image_sharded_staged(params, cam, cfg, mesh)
        stats = {}
        megakernel.reset_launch_counts()
        img = sharding.render_image_sharded_staged(params, cam, cfg, mesh, stats_out=stats)
        torch.cuda.synchronize()
        launches = megakernel.KERNEL_LAUNCHES
        if launches == 0:
            raise RuntimeError(f"the {n}-shard frame never launched the march kernel")
        check_image(img, f"{n}-shard frame", cfg.height, cfg.width)
        unequal = unequal_pixels(img, ref)
        if unequal:
            raise RuntimeError(f"the {n}-shard frame differs from the single-device frame "
                               f"at {unequal} pixels")
        ms = time_frames(lambda: sharding.render_image_sharded_staged(params, cam, cfg, mesh), 3)
        load = {k: stats[k] for k in ("fast_path", "shard_imbalance",
                                      "predicted_scaling_efficiency", "shard_near", "shard_steps")}
        print(f"phase 14 {n}-shard {cfg.width}x{cfg.height} frame: {unequal} pixels off the "
              f"single-device frame; {launches} kernel launches; "
              f"{json.dumps(load)}; median {statistics.median(ms):.3f} ms over 3 "
              f"{[round(x, 3) for x in ms]} against {single_ms:.3f} single-device [{card}]",
              flush=True)
        frames[n] = (img, launches)
    with thread_per_ray():
        mesh8 = mesh_lib.make_mesh((SHARDS[-1],), ("data",), [dev] * SHARDS[-1])
        threads = unequal_pixels(sharding.render_image_sharded_staged(params, cam, cfg, mesh8),
                                 renderer.render(cam))
    print(f"phase 14 {SHARDS[-1]}-shard frame a ray per thread throughout: {threads} pixels off "
          f"the single-device frame a ray per thread")
    if threads:
        raise RuntimeError(f"a ray per thread, the sharded frame differs at {threads} pixels")
    for n, mesh in ((1, mesh_lib.make_mesh((1,), ("data",), [dev])), (SHARDS[-1], mesh8)):
        prof = profile_breakdown(lambda: sharding.render_image_sharded_staged(params, cam, cfg,
                                                                              mesh))
        prof.pop("top_kernels_ms")
        prof["march_kernel_ms"] = sum(prof["march_kernel_ms"])
        print(f"phase 14 {n}-shard frame profile: {json.dumps(prof)} [{card}]")

    with uncounted():
        groups = _frame_groups(record_calls(
            lambda: sharding.render_image_sharded_staged(params, cam, cfg, mesh8)))
        if len(groups) != SHARDS[-1]:
            raise RuntimeError(f"{len(groups)} coarse calls in an {SHARDS[-1]}-shard frame")
        result = compare_recorded_calls(params, groups[0])
        ms, plain_ms, bnd = time_coarse(params, groups[0], lanes=cfg.num_rays // SHARDS[-1])
    for name, a in result.items():
        print(f"compare shard 0 of {SHARDS[-1]} {name}: {json.dumps(a)}")
    check_agreement(result)
    print(f"phase 14 shard 0's coarse call ({cfg.num_rays // SHARDS[-1]} rays): kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.3f} ms [{card}]")
    entry = kernel_entry("march_kernel_sharded", K1_SOURCE,
                         "cudaneuralrender_tpu/pallas/megakernel.py:45", frames[SHARDS[-1]][1],
                         max(a["max_abs_err"] for a in result.values()), ms, plain_ms, bnd)
    return entry, ref, frames[2][0]


def drive_sharded_train(cnr, params, card) -> tuple:
    """Phase 14, the sharded train step at 1080p on TRAIN_SHARDS shards:
    ``solve_surface_sharded`` (against ``diff.solve_surface``) feeding
    ``pixel_train_step_sharded``, against the unsharded step on the same
    solve (loss, and the gradient within TRAIN_GRAD_RTOL of its norm: the
    first Adam moments are a tenth of it), both timed. Returns the step's
    inputs for the NCCL world: (state, target, solve, its new state)."""
    from cudaneuralrender_torch import diff
    from cudaneuralrender_torch.diff import train
    from cudaneuralrender_torch.parallel import mesh as mesh_lib
    from cudaneuralrender_torch.parallel import sharding

    dev = params.device
    cfg = cnr.RenderConfig(width=PARALLEL_SIDE[0], height=PARALLEL_SIDE[1], march_impl="staged")
    target = _train_target(cnr, params, cfg)
    gen = torch.Generator().manual_seed(TRAIN_SEED)
    start = cnr.MLP([(l.w + TRAIN_NOISE * torch.randn(l.w.shape, generator=gen).to(dev),
                      l.b + TRAIN_NOISE * torch.randn(l.b.shape, generator=gen).to(dev))
                     for l in params])
    s0 = train.init_train_state(start, TRAIN_LR)
    cam = cnr.Camera(rotation_y=20.0)
    mesh = mesh_lib.make_mesh((TRAIN_SHARDS,), ("data",), [dev] * TRAIN_SHARDS)

    def sharded_step():
        t_star, hit = sharding.solve_surface_sharded(s0.params, cam, cfg, mesh)
        return sharding.pixel_train_step_sharded(s0, cam, target, cfg, mesh, TRAIN_LR,
                                                 t_star=t_star, hit=hit), (t_star, hit)

    def unsharded_step():
        t_star, hit = diff.solve_surface(s0.params, cam, cfg)
        return train._pixel_grad_step_from_t(s0, cam, target, t_star, hit, cfg, TRAIN_LR)

    (state, loss), (t_star, hit) = sharded_step()
    t1, hit1 = diff.solve_surface(s0.params, cam, cfg)
    both = hit & hit1
    solve = dict(equal=bool(torch.equal(t_star, t1) and torch.equal(hit, hit1)),
                 hit_agree=(hit == hit1).float().mean().item(),
                 max_dt=(t_star - t1).abs()[both].max().item())
    ref_state, ref_loss = train._pixel_grad_step_from_t(s0, cam, target, t_star, hit, cfg,
                                                        TRAIN_LR)
    mu = torch.cat([m.reshape(-1) for m in train._flat(state.opt_state.mu)])
    mu_ref = torch.cat([m.reshape(-1) for m in train._flat(ref_state.opt_state.mu)])
    delta, norm = float((mu - mu_ref).norm()), float(mu_ref.norm())
    loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    sharded_ms = time_frames(sharded_step, 3)
    unsharded_ms = time_frames(unsharded_step, 3)
    print(f"phase 14 sharded train step {cfg.width}x{cfg.height}, {TRAIN_SHARDS} shards: solve against "
          f"diff.solve_surface {json.dumps(solve)}; loss {float(loss):.8g} vs unsharded "
          f"{float(ref_loss):.8g} (rel {loss_err:.3g}); gradient |d| {delta:.4g}, |g| {norm:.4g}, "
          f"ratio {delta / norm:.3g}; step (solve + grad + update) median "
          f"{statistics.median(sharded_ms):.3f} ms {[round(x, 3) for x in sharded_ms]}, "
          f"unsharded {statistics.median(unsharded_ms):.3f} ms [{card}]", flush=True)
    if not (norm > 0 and delta <= TRAIN_GRAD_RTOL * norm and loss_err <= 1e-5):
        raise RuntimeError(f"sharded train step off the unsharded one: loss rel {loss_err}, "
                           f"gradient {delta} vs {TRAIN_GRAD_RTOL} * {norm}")
    return s0, target, (t_star, hit), state


def drive_fault(cnr, params, ref, card) -> None:
    """Phase 14, the fault drill: ``render_tiled`` in FAULT_BANDS bands, once
    fault-free and once with FAULT_INJECTED injected faults; the two images
    equal bit for bit, the faults recovered, and every band execution's
    march on the kernel (its launches counted), so that no retry can hide a
    broken kernel; the bands against the single-device frame."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.parallel import fault

    cfg = cnr.RenderConfig(width=PARALLEL_SIDE[0], height=PARALLEL_SIDE[1], march_impl="staged")
    cam = cnr.Camera(**CAMERA)
    real = fault.render_band_auto
    runs = []

    def counting(*args, **kw):
        before = megakernel.KERNEL_LAUNCHES
        out = real(*args, **kw)
        runs.append((args[5], megakernel.KERNEL_LAUNCHES - before))
        return out

    fault.render_band_auto = counting
    try:
        clean = fault.render_tiled(params, cam, cfg, n_bands=FAULT_BANDS)
        clean_runs = list(runs)
        runs.clear()
        injector = fault.FaultInjector(FAULT_INJECTED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drilled = fault.render_tiled(params, cam, cfg, n_bands=FAULT_BANDS, injector=injector)
        drill_ms = (time.perf_counter() - t0) * 1e3
    finally:
        fault.render_band_auto = real
    drilled_t = torch.as_tensor(drilled, device=ref.device)
    unequal = unequal_pixels(drilled_t, ref)
    print(f"phase 14 fault drill {cfg.width}x{cfg.height}, {FAULT_BANDS} bands: {injector.injected} injected faults "
          f"recovered; band executions (band, kernel launches) {runs}, fault-free {clean_runs}; "
          f"image equal to the fault-free one: {bool(np.array_equal(drilled, clean))}; against "
          f"the single-device frame: {unequal} pixels off; {drill_ms:.3f} ms with the retries "
          f"[{card}]", flush=True)
    if injector.injected != FAULT_INJECTED or not np.array_equal(drilled, clean):
        raise RuntimeError("the fault drill did not recover to the fault-free image")
    if len(runs) != FAULT_BANDS + FAULT_INJECTED or min(n for _, n in runs + clean_runs) == 0:
        raise RuntimeError(f"a band execution left the march kernel: {runs}, {clean_runs}")
    if unequal:
        mixed_bar(drilled_t, ref, "phase 14 the banded frame", "the single-device frame")


def drive_world(cnr, params, card) -> None:
    """Phase 14, a 2-process gloo world on the card (the example
    ``multihost_drill``, each rank on the card, the collectives through the
    CPU): the band tiles and the failover tiles (host 1 failed, its bands
    adopted by host 0) equal to the single-process ``render_tiled`` bit for
    bit; those and the global staged frame's tiles against the
    single-process staged frame, the global dense frame against
    ``render_image``, the memo's broadcast reaching rank 1, and the train
    step's loss equal on both ranks. The kernels' library was built by this
    process; the ranks only load it."""
    import tempfile

    from cudaneuralrender_torch.examples import multihost_drill as drill
    from cudaneuralrender_torch.parallel import multihost

    from cudaneuralrender_torch.parallel import fault

    w, h = WORLD_SIDE
    cfg = cnr.RenderConfig(width=w, height=h, march_impl="staged")
    cam = cnr.Camera(**drill.CAMERA)
    staged_ref = cnr.render_staged(params, cam, cfg)
    dense_ref = cnr.render_image(params, cam, cfg.replace(march_impl="while"))
    banded = fault.render_tiled(params, cam, cfg, n_bands=4)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        env = dict(os.environ, CNR_SCHEDULE_MEMO="")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "cudaneuralrender_torch.examples.multihost_drill",
             "--init", f"file://{tmp}/rendezvous", "--world", "2", "--rank", str(rank),
             "--out", out, "--device", "cuda", "--backend", "gloo", "--shards",
             str(WORLD_SHARDS), "-W", str(w), "-H", str(h), "--steps", str(cfg.max_steps)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        world_s = time.perf_counter() - t0
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {rank} of the 2-process world failed:\n{log[-4000:]}")
        rows, imgs = {}, {}
        for stem in ("bands", "failover", "gspmd_staged", "gspmd"):
            tiles = multihost.assemble_tiles(out, stem)
            img = torch.as_tensor(tiles, device=params.device)
            imgs[stem] = (img, dense_ref if stem == "gspmd" else staged_ref)
            rows[stem] = dict(unequal_pixels=unequal_pixels(*imgs[stem]))
            if stem in ("bands", "failover"):
                rows[stem]["equal_to_single_process_bands"] = bool(np.array_equal(tiles, banded))
        memo = [int(np.load(os.path.join(out, f"memo_fast_p{r}.npy"))[0]) for r in (0, 1)]
        losses = [float(np.load(os.path.join(out, f"loss_p{r}.npy"))) for r in (0, 1)]
    print(f"phase 14 2-process gloo world on the card, {w}x{h}, {WORLD_SHARDS} shards a rank: "
          f"{json.dumps(rows)}; memo broadcast fast path on ranks 0, 1: {memo}; train step "
          f"losses {losses}; {world_s:.1f} s wall with the ranks' start-up [{card}]", flush=True)
    for stem, agree in rows.items():
        if agree["unequal_pixels"]:
            mixed_bar(*imgs[stem], f"phase 14 the 2-process {stem} image",
                      "the single-process frame")
        if not agree.get("equal_to_single_process_bands", True):
            raise RuntimeError(f"the 2-process {stem} tiles differ from the single-process bands")
    if memo != [1, 1] or losses[0] != losses[1]:
        raise RuntimeError(f"2-process world: memo flags {memo}, losses {losses}")


def drive_nccl_world(cnr, params, card, two_shard_frame, train_case) -> None:
    """Phase 14, a world of one process on NCCL: the global staged frame
    over two shards of the card, gathered, equal to the single-process
    2-shard frame bit for bit, and the sharded train step (its gradient
    all-reduced on the card) equal to the single-process one."""
    import socket

    import torch.distributed as dist

    from cudaneuralrender_torch.diff import train
    from cudaneuralrender_torch.parallel import multihost, sharding

    dev = params.device
    cfg = cnr.RenderConfig(width=PARALLEL_SIDE[0], height=PARALLEL_SIDE[1], march_impl="staged")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        mesh = multihost.global_mesh(devices=[dev] * 2)
        img = multihost.render_global(params, cnr.Camera(**CAMERA), cfg, mesh)
        full = torch.as_tensor(multihost.gather_image(img), device=dev)
        s0, target, (t_star, hit), single_state = train_case
        state, loss = sharding.pixel_train_step_sharded(
            s0, cnr.Camera(rotation_y=20.0), target, cfg,
            multihost.global_mesh(devices=[dev] * TRAIN_SHARDS), TRAIN_LR,
            t_star=t_star, hit=hit)
        same = all(torch.equal(a, b) for a, b in zip(train._state_leaves(state),
                                                      train._state_leaves(single_state)))
        print(f"phase 14 NCCL world of 1: backend {dist.get_backend()}, {len(img.tiles)} row "
              f"tiles; the gathered frame equal to the single-process 2-shard frame: "
              f"{bool(torch.equal(full, two_shard_frame))}; the train step's state equal to the "
              f"single-process one: {same} [{card}]", flush=True)
        if not (torch.equal(full, two_shard_frame) and same):
            raise RuntimeError("the NCCL world's frame or train step differs from the "
                               "single-process one")
    finally:
        dist.destroy_process_group()


def drive_parallel(cnr, params, card) -> dict:
    """Phase 14 (the module docstring lists the steps). Returns the sharded
    march kernel's entry."""
    from cudaneuralrender_torch.parallel import dryrun

    entry, ref, two_shard_frame = drive_sharded(cnr, params, card)
    train_case = drive_sharded_train(cnr, params, card)
    drive_fault(cnr, params, ref, card)
    drive_world(cnr, params, card)
    drive_nccl_world(cnr, params, card, two_shard_frame, train_case)
    t0 = time.perf_counter()
    dryrun.run(4)
    print(f"phase 14 dryrun.run(4): completed in {time.perf_counter() - t0:.2f} s", flush=True)
    return entry


# Phase 15: the cone-traced prepass and the baked-grid walk at 1080p, and
# the ReLU tie backward kernel.
EMPTY_SPACE = (("prepass_factor=4", dict(prepass_factor=4)), ("grid_res=64", dict(grid_res=64)))
EMPTY_ENTRIES = ("march_kernel_prepass", "march_kernel_grid")  # the kernels line's names
EMPTY_SIDE = (1920, 1080)
EMPTY_SHARDS = 4
ELEMENTWISE_SOURCE = "cudaneuralrender_torch/csrc/elementwise.cu"
T_START = None  # main()'s start, for the script's total time


def _phase_alone(params, cfg, origin, dirs):
    """A callable that runs the option's init alone on the frame's rays,
    through the renderer's own ``_march_init`` (the prepass, or the
    bounding-sphere init, the bake and the grid walk), and returns the
    state the coarse call starts from and its SDF calls (a cone-trace step
    each; the bake's one)."""
    from cudaneuralrender_torch.render import renderer as renderer_lib

    fine = renderer_lib.scene_fn(params, cfg, 0.0)
    use_prepass = renderer_lib._prepass_on(cfg)
    evals = []

    def counted(p):
        evals.append(1)
        return fine(p)

    def run():
        evals.clear()
        state = renderer_lib._march_init(counted, origin, dirs, cfg, use_prepass=use_prepass)
        return state, len(evals)

    return run


def drive_empty_space(cnr, params, card) -> list:
    """Phase 15, the opt-in empty-space phases on csg_demo at 1080p (the
    default staged config, CAMERA): for each of EMPTY_SPACE a frame with
    its K1 launches counted, at the mixed bar against the default frame,
    kernel = plain version on every march call of a warm frame (the coarse
    call starts from the cone trace's or the grid walk's state), its coarse
    call timed both ways, the median of 3 frames beside the default's, the
    phase alone by CUDA events (with what it leaves active), a profiled
    frame's idle share; with grid_res=64 a 24-frame warm turntable against
    the cold one at the mixed bar, and an EMPTY_SHARDS-shard frame equal to
    the unsharded one. Returns the kernels line's entries, one an option."""
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib
    from cudaneuralrender_torch.parallel import mesh as mesh_lib
    from cudaneuralrender_torch.parallel import sharding

    dev = params.device
    base = cnr.RenderConfig(width=EMPTY_SIDE[0], height=EMPTY_SIDE[1], march_impl="staged")
    cam = cnr.Camera(**CAMERA)
    default = cnr.Renderer(params, base)
    ref = default.render(cam)
    ref_ms = time_frames(lambda: default.render(cam, 0.0), 3)
    print(f"phase 15 default 1080p frame: median {statistics.median(ref_ms):.3f} ms over 3 "
          f"{[round(x, 3) for x in ref_ms]} [{card}]")
    c2w, _ = camera_lib.view_matrices(cam, dev)
    origin, dirs = camera_lib.generate_rays(c2w, base.height, base.width, base.focal)
    entries = []
    for (name, fields), entry_name in zip(EMPTY_SPACE, EMPTY_ENTRIES):
        cfg = base.replace(**fields)
        renderer = cnr.Renderer(params, cfg)
        renderer.render(cam)  # teaches the memo
        megakernel.reset_launch_counts()
        img = renderer.render(cam)
        torch.cuda.synchronize()
        launches, stats = megakernel.KERNEL_LAUNCHES, dict(renderer.last_stats)
        if launches == 0:
            raise RuntimeError(f"the {name} frame never launched the march kernel")
        check_image(img, name, base.height, base.width)
        mixed_bar(img, ref, f"phase 15 {name} 1080p frame")
        with uncounted():
            calls = record_march_calls(renderer, cam)
            result = compare_recorded_calls(params, calls)
            k_ms, plain_ms, bnd = time_coarse(params, calls)
        for cname, a in result.items():
            print(f"compare phase 15 {name} 1080p {cname}: {json.dumps(a)}")
        check_agreement(result)
        print(f"phase 15 {name} coarse march 1080p ({cfg.num_rays} rays, from the option's "
              f"state): kernel {k_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bnd['bound_ms']:.3f} ms [{card}]")
        entries.append(kernel_entry(entry_name, K1_SOURCE,
                                    "cudaneuralrender_tpu/pallas/megakernel.py:45", launches,
                                    max(a["max_abs_err"] for a in result.values()), k_ms,
                                    plain_ms, bnd))
        ms = time_frames(lambda: renderer.render(cam, 0.0), 3)
        print(f"phase 15 {name} 1080p frame: median {statistics.median(ms):.3f} ms over 3 "
              f"{[round(x, 3) for x in ms]} against {statistics.median(ref_ms):.3f} default; "
              f"{launches} K1 launches; stats {json.dumps(stats)} [{card}]")
        run = _phase_alone(params, cfg, origin, dirs)
        state, evals = run()
        print(f"phase 15 {name} init alone (renderer._march_init): "
              f"{time_cuda(run, 3, warmup=1):.3f} ms (CUDA events, median of 3); {evals} SDF "
              f"calls, {int(state.active.sum())} of {cfg.num_rays} rays left active, steps "
              f"{int(state.steps)} [{card}]")
        prof = profile_breakdown(lambda: renderer.render(cam, 0.0))
        prof["march_kernel_ms"] = sum(prof["march_kernel_ms"])
        print(f"phase 15 {name} 1080p frame profile: {json.dumps(prof)} [{card}]", flush=True)

    cfg = base.replace(grid_res=64)
    cams, frames = _turntable(cnr)
    cold, cold_stats, cold_ms = _timed_sequence(cnr, params, cams, cfg, frames)
    _timed_sequence(cnr, params, cams, cfg, frames, warm_start=True)
    warm, warm_stats, warm_ms = _timed_sequence(cnr, params, cams, cfg, frames, warm_start=True)
    if not torch.equal(warm[0], cold[0]):
        raise RuntimeError("grid_res=64: warm frame 0 differs from the cold frame 0")
    bars = [mixed_bar(w, c, f"phase 15 grid_res=64 warm turntable frame {i}", "the cold frame")
            for i, (c, w) in enumerate(zip(cold[1:], warm[1:]), 1)]
    print(f"phase 15 grid_res=64 turntable 1080p, {len(cams)} frames: cold {cold_ms:.3f} "
          f"ms/frame, warm {warm_ms:.3f} ms/frame; hit masks agree min "
          f"{min(b[0] for b in bars):.6f}, common hits within 1e-3 min "
          f"{min(b[1] for b in bars):.6f}; steps cold {[s['steps'] for s in cold_stats]} warm "
          f"{[s['steps'] for s in warm_stats]} [{card}]", flush=True)

    one = cnr.Renderer(params, cfg).render(cam)
    mesh = mesh_lib.make_mesh((EMPTY_SHARDS,), ("data",), [dev] * EMPTY_SHARDS)
    megakernel.reset_launch_counts()
    shard_img = sharding.render_image_sharded_staged(params, cam, cfg, mesh)
    torch.cuda.synchronize()
    unequal = unequal_pixels(shard_img, one)
    print(f"phase 15 grid_res=64 {EMPTY_SHARDS}-shard 1080p frame: {unequal} pixels off the "
          f"unsharded frame, {megakernel.KERNEL_LAUNCHES} K1 launches")
    if unequal or megakernel.KERNEL_LAUNCHES == 0:
        raise RuntimeError(f"grid_res=64: the {EMPTY_SHARDS}-shard frame differs from the "
                           f"unsharded frame at {unequal} pixels")
    return entries


def record_tie_calls(run) -> list:
    """Call ``run()``, recording (g, h) of every ``relu_tie_backward`` call
    it makes, cloned."""
    from cudaneuralrender_torch.kernels import elementwise

    calls = []
    real = elementwise.relu_tie_backward

    def recording(g, h):
        calls.append((g.clone(), h.clone()))
        return real(g, h)

    elementwise.relu_tie_backward = recording
    try:
        run()
    finally:
        elementwise.relu_tie_backward = real
    torch.cuda.synchronize()
    return calls


def drive_relu_tie(cnr, params, launches: int, card) -> dict:
    """Phase 15, ``relu_tie_backward`` (csrc/elementwise.cu): against its
    plain version bit for bit on every call of a 1080p frame's shading
    normals (the main path's pre-activations and gradients), the frame's
    calls timed kernel / plain / ``threshold_backward`` (relu's backward,
    the library yardstick) beside the bound (12 bytes a value at the HBM
    rate); then ``benchmarks/relu_ties.py``'s frame variants. Returns the
    kernels line's entry (``launches``: phase 4's main-path count)."""
    from cudaneuralrender_torch.benchmarks import relu_ties
    from cudaneuralrender_torch.kernels import elementwise

    cfg = cnr.RenderConfig(width=EMPTY_SIDE[0], height=EMPTY_SIDE[1], march_impl="staged")
    cam = cnr.Camera(**CAMERA)
    renderer = cnr.Renderer(params, cfg)
    calls = record_tie_calls(lambda: renderer.render(cam))
    if not calls:
        raise RuntimeError("a 1080p frame's normals made no relu_tie_backward call")
    err, unequal = 0.0, 0
    for g, h in calls:
        got = elementwise.relu_tie_backward(g, h)
        want = elementwise.relu_tie_backward_plain(g, h)
        unequal += int((got != want).sum()) - int((got.isnan() & want.isnan()).sum())
        err = max(err, float((got - want).abs().nan_to_num(0.0).max()))
    values = sum(g.numel() for g, _ in calls)
    ties = sum(int((h == 0).sum()) for _, h in calls)
    torch.cuda.synchronize()
    print(f"phase 15 relu_tie_backward on a 1080p frame's {len(calls)} calls "
          f"({[tuple(g.shape) for g, _ in calls[:2]]}..., {values} values, {ties} exact ties): "
          f"{unequal} values off the plain version, max |d| {err}")
    if unequal:
        raise RuntimeError(f"relu_tie_backward differs from its plain version at {unequal} values")

    def each(fn):
        return lambda: [fn(g, h) for g, h in calls]

    ms = time_cuda(each(elementwise.relu_tie_backward), 10, warmup=2)
    plain_ms = time_cuda(each(elementwise.relu_tie_backward_plain), 10, warmup=2)
    library_ms = time_cuda(each(lambda g, h: torch.ops.aten.threshold_backward(g, h, 0.0)),
                           10, warmup=2)
    bnd = bound(0, 12.0 * values)
    print(f"phase 15 relu_tie_backward, a frame's {len(calls)} calls: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, threshold_backward (relu's backward) {library_ms:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({12 * values} bytes at 3.35 TB/s) [{card}]", flush=True)

    variants = relu_ties.frame_variants(renderer, cam)
    tree_ms, tree_img = variants["relu_tie (tree)"]
    for name, (f_ms, img) in variants.items():
        print(f"phase 15 relu_ties frame 1920x1080, shading normals on {name}: {f_ms:.3f} ms "
              f"(median of {2 * relu_ties.TIMED_RUNS}, {f_ms - tree_ms:+.3f} against the tree); "
              f"{unequal_pixels(img, tree_img)} pixels off the tree's [{card}]", flush=True)
    bnd.pop("tc_bound_ms", None)
    return dict(name="relu_tie_backward", route="cuda", source=ELEMENTWISE_SOURCE,
                replaces="cudaneuralrender_tpu/models/mlp.py:99", launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, **bnd, library_ms=library_ms)


def main() -> int:
    global T_START
    T_START = time.perf_counter()
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    os.environ.setdefault("CNR_SCHEDULE_MEMO", "")  # no learned schedules from disk
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import build, elementwise, megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(card, flush=True)  # name, power limit

    # 2. build
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({build.library_path()})")
    print(build.BUILD_LOG.strip() or "(library already built)", flush=True)
    lib = build.load_library()
    hmma = sass_counts(build.library_path(), "HMMA")
    for label, regs, stack, spill_st, spill_ld in ptxas_table(build.BUILD_LOG):
        line = (f"ptxas {label}: {regs} registers, {stack} bytes stack frame, {spill_st} bytes "
                f"spill stores, {spill_ld} bytes spill loads")
        if "H=" in label and not label.startswith("x"):  # dynamic shared memory at 9 layers
            h = int(label.split("H=")[1].split(",")[0].rstrip(">"))
            kind = (2 if label.startswith("mlp") else 3 if label.startswith("march_split")
                    else int(label.endswith("three_pass=1>")))
            line += f"; {lib.cnr_smem_bytes(kind, h, 9)} bytes dynamic shared memory"
        if "H=" in label:
            line += f"; {hmma.get(label, 'no')} HMMA in its SASS"
        print(line)
    fp32_march = {k: int(k.split("H=")[1].split(",")[0]) for k in hmma
                  if k.endswith("three_pass=0>")}
    tensor_core = [k for k in hmma if k.startswith("mlp") or k.endswith("three_pass=1>")
                   or fp32_march.get(k, 0) in megakernel.TENSOR_CORE_FP32_WIDTHS]
    split = [k for k in hmma if k.startswith("march_split")]
    splittable = [k for k, h in fp32_march.items() if h in megakernel.SPLIT_WIDTHS]
    experiments = [k for k in hmma if k.startswith("x")]  # X1-X3: on the tensor cores
    idle = [k for k in tensor_core + experiments if hmma[k] == 0]
    stray = [k for k in split if hmma[k]]
    print(f"SASS (cuobjdump -sass): {len(tensor_core) - len(idle)} of {len(tensor_core)} K3, "
          f"K2h and FP32 march (widths {megakernel.TENSOR_CORE_FP32_WIDTHS}, a ray per thread) "
          f"instantiations issue HMMA; FP32 march instantiations a ray per warp (widths "
          f"{megakernel.SPLIT_WIDTHS}) with HMMA: {len(stray)} of {len(split)}; X1-X3 "
          f"instantiations with HMMA: {sum(hmma[k] > 0 for k in experiments)} of "
          f"{len(experiments)}", flush=True)
    if (idle or stray or not tensor_core or not split or len(split) != len(splittable)
            or len(experiments) != 14):
        raise RuntimeError(f"tensor-core kernels without HMMA: {idle}; FFMA kernels (a ray per "
                           f"warp) with HMMA: {stray}; {len(experiments)} X1-X3 kernels of 14; "
                           f"{len(split)} ray-per-warp kernels for {len(splittable)} FP32 march "
                           f"kernels at {megakernel.SPLIT_WIDTHS}")

    params = cnr.load(ASSET, device=dev)

    # 3. kernel vs plain at 256x256: the FP32 kernel's three kinds of call
    # and the default coarse call
    cfg256 = cnr.RenderConfig(width=256, height=256)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 256, 256, cfg256.focal)
    result = compare_kernel_with_plain(params, cfg256, origin, dirs)
    result.update(main_coarse_call(params, cfg256, origin, dirs))
    torch.cuda.synchronize()
    for name, a in result.items():
        print(f"compare {name}: {json.dumps(a)}")
    check_agreement(result)
    max_abs_err = max(a["max_abs_err"] for n, a in result.items() if n != "coarse_main")
    k2h_err = result["coarse_main"]["max_abs_err"]

    # 4. the main path at 1080p, counting launches
    narrow = SIZES[32]
    cfg = cnr.RenderConfig(width=narrow.side[0], height=narrow.side[1], march_impl="staged")
    renderer = cnr.Renderer(params, cfg)
    cam = cnr.Camera(**CAMERA)
    megakernel.reset_launch_counts()
    elementwise.reset_launch_counts()
    img = renderer.render(cam)
    torch.cuda.synchronize()
    launches = megakernel.KERNEL_LAUNCHES
    three_pass = megakernel.THREE_PASS_LAUNCHES[32]
    fp32_coarse = megakernel.PRECISION_LAUNCHES["default"]
    split_launches = megakernel.SPLIT_LAUNCHES[32]
    tie_launches = elementwise.RELU_TIE_LAUNCHES
    print(f"main path 1080p: {launches} kernel launches ({three_pass} three-pass, "
          f"{fp32_coarse} FP32 coarse, {split_launches} a ray per warp; coarse_precision "
          f"{cfg.coarse_precision!r}, coarse_eps {cfg.coarse_eps}), {tie_launches} "
          f"relu_tie_backward launches, stats {json.dumps(renderer.last_stats)}")
    if launches == 0:
        raise RuntimeError("the 1080p staged render never launched the march kernel")
    if cfg.coarse_precision == "high" and (three_pass == 0 or fp32_coarse):
        raise RuntimeError(f"the 1080p staged render's coarse calls: {three_pass} three-pass, "
                           f"{fp32_coarse} FP32: the default coarse call runs the three-pass "
                           "chain")
    if tie_launches == 0:
        raise RuntimeError("the 1080p staged render's normals never launched relu_tie_backward")
    if split_launches == 0:
        raise RuntimeError("the 1080p staged render never marched a ray per warp")
    fg = check_image(img, "neural_raw")
    print(f"main path 1080p: foreground fraction {fg:.4f}")

    iou, frac2 = golden_render(cnr, params, cam)
    print(f"golden 256x256: IoU {iou:.5f}, {frac2:.5f} of foreground within 2 levels")

    # 5. timing: the default frame beside the FP32 coarse call's (COARSE_FP32),
    # in the order default, FP32, FP32, default
    fp32_renderer = cnr.Renderer(params, cfg.replace(**COARSE_FP32))
    fp32_renderer.render(cam)
    fp32_renderer.render(cam)
    frame_ms, fp32_ms = [], []
    for run, out in ((renderer, frame_ms), (fp32_renderer, fp32_ms), (fp32_renderer, fp32_ms),
                     (renderer, frame_ms)):
        out += time_frames(lambda: run.render(cam, 0.0), narrow.frames)
    print(f"1080p staged frame: median {statistics.median(frame_ms):.3f} ms over "
          f"{len(frame_ms)} warm frames {[round(x, 3) for x in frame_ms]} (coarse_precision "
          f"{cfg.coarse_precision!r}, coarse_eps {cfg.coarse_eps}); with the FP32 coarse call "
          f"to {COARSE_FP32['coarse_eps']} (coarse_fp32): median "
          f"{statistics.median(fp32_ms):.3f} ms {[round(x, 3) for x in fp32_ms]} [{card}]")

    # 5b. kernel vs plain at the main path's own sizes: the inputs of every
    # march call of one warm 1080p frame (the coarse pass first, then the
    # retuned rungs), the coarse pass (K2h) and the first refine rung (K1)
    # timed both ways.
    calls, plains = record_march_calls(renderer, cam), []
    full = compare_recorded_calls(params, calls, plains)
    for name, a in full.items():
        print(f"compare 1080p {name}: {json.dumps(a)}")
    check_agreement(full)
    errs = [a["max_abs_err"] for a in full.values()]
    k2h_err = max(k2h_err, errs[0])
    max_abs_err = max([max_abs_err] + errs[1:])

    coarse_t = time_coarse(params, calls)
    print(f"coarse march 1080p ({cfg.num_rays} rays, {cfg.coarse_precision}, eps "
          f"{cfg.coarse_eps}): kernel {coarse_t[0]:.3f} ms, plain {coarse_t[1]:.3f} ms, bound "
          f"{coarse_t[2]['bound_ms']:.3f} ms [{card}]")
    ms, plain_ms, bnd = time_call(params, calls[1])
    print(f"refine rung 0 1080p ({calls[1][1].shape[0]} lanes, FP32): kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.3f} ms (FP32), "
          f"{bnd['tc_bound_ms']:.3f} ms (3xTF32) [{card}]")
    tc_sdf_errors(params, 32, card, narrow.points)

    print(f"breakdown 1080p frame: {json.dumps(device_breakdown(renderer, cam))} [{card}]")
    with thread_per_ray():
        frame_ms = time_frames(lambda: renderer.render(cam, 0.0), narrow.frames)
    print(f"1080p staged frame a ray per thread: median {statistics.median(frame_ms):.3f} ms "
          f"over {narrow.frames} warm frames {[round(x, 3) for x in frame_ms]} [{card}]")
    mode_sweep(cnr, params, card)

    rows = compare_modes(params, calls, "1080p neural_raw", card, plains)
    kernels = [kernel_entry("march_kernel", K1_SOURCE,
                            "cudaneuralrender_tpu/pallas/megakernel.py:45",
                            launches - three_pass, max_abs_err, ms, plain_ms, bnd),
               split_entry(params, calls, rows, split_launches, card)]

    # 6. the CSG scenes, composed inside the kernel
    t6 = time.perf_counter()
    anim = cnr.load(ANIM_ASSET, device=dev)
    for entry, scene, frame, asset, num_inputs, line in SCENES:
        r = drive_scene(cnr, anim if asset == ANIM_ASSET else params, scene, frame,
                        num_inputs, card)
        kernels.append(kernel_entry(entry, K1_SOURCE,
                                    f"cudaneuralrender_tpu/pallas/scenes.py:{line}", **r))
    print(f"phase 6 (scenes): {time.perf_counter() - t6:.1f} s wall")

    # 7. the turntable
    t7 = time.perf_counter()
    drive_turntable(cnr, params, card)
    print(f"phase 7 (turntable): {time.perf_counter() - t7:.1f} s wall", flush=True)

    # 8. wide nets through the staged path
    t8 = time.perf_counter()
    nets = {32: params}
    for hidden in WIDE:
        nets[hidden] = wide_params(cnr, hidden // 32, dev)
        kernels.extend(drive_width(cnr, nets[hidden], hidden, card, SIZES[hidden]))
    r = drive_scene(cnr, nets[128], "many_sphere", 90.0, 3, card, 512, 512)
    kernels.append(kernel_entry("compose_many_sphere_h128", K1_SOURCE,
                                "cudaneuralrender_tpu/pallas/scenes.py:57", **r))
    print(f"phase 8 (wide nets): {time.perf_counter() - t8:.1f} s wall", flush=True)

    # 9. the fused forward at every width, and use_pallas
    t9 = time.perf_counter()
    for hidden, net in nets.items():
        kernels.append(drive_forward(cnr, net, hidden, card, SIZES[hidden]))
    print(f"phase 9 (forward kernel): {time.perf_counter() - t9:.1f} s wall", flush=True)

    # 10. the precision ladder and the cold start
    t10 = time.perf_counter()
    k2h, errors = {}, {}
    for hidden, net in nets.items():
        errors[hidden] = sdf_errors(net, hidden, card, SIZES[hidden].points)
        row_sweep(net, card, SIZES[hidden].points)
    chain = "high" if cfg.coarse_precision == "high" else "highest"
    worst = max(e[chain] for e in errors.values())
    print(f"phase 10 default coarse_eps {cfg.coarse_eps} ({cfg.coarse_precision}): "
          f"{cfg.coarse_eps / worst:.1f} x its chain's largest |SDF - float64| over widths "
          f"{list(errors)} ({worst:.3g}; per width "
          f"{json.dumps({h: float(f'{e[chain]:.3g}') for h, e in errors.items()})}) [{card}]")
    if cfg.coarse_eps < ERR_FACTOR * worst:
        raise RuntimeError(f"the default coarse_eps {cfg.coarse_eps} is under {ERR_FACTOR} x "
                           f"its chain's SDF error {worst}")
    for name, fields, frames, precision in HIGH_CONFIGS:
        k2h[name] = drive_high_config(cnr, params, name, fields, img, card, frames, precision)
    time_precisions(params, calls[0], card)  # the main path's coarse call, FP32 beside it
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**CAMERA), dev)
    side = narrow.high_side
    origin, dirs = camera_lib.generate_rays(c2w, side, side, cfg.focal)
    rays = high_agreement(params, cnr.RenderConfig(width=side, height=side), origin, dirs, 32,
                          card, narrow.reps)
    kernels.append(kernel_entry(
        "march_kernel_3pass_h32", K3_SOURCE, "cudaneuralrender_tpu/pallas/fused_mlp.py:130",
        three_pass, max(k2h_err, rays["max_abs_err"], k2h["mid_eps"]["max_abs_err"]),
        *coarse_t))
    fp32 = k2h["coarse_fp32"]
    kernels.append(kernel_entry("march_kernel_fp32_coarse", K1_SOURCE,
                                "cudaneuralrender_tpu/pallas/megakernel.py:45", fp32["launches"],
                                fp32["max_abs_err"], *time_coarse(params, fp32["calls"])))
    for hidden in WIDE:
        kernels.append(kernel_entry(f"march_kernel_3pass_h{hidden}", K3_SOURCE,
                                    "cudaneuralrender_tpu/pallas/fused_mlp.py:130",
                                    **drive_high_width(cnr, nets[hidden], hidden, card,
                                                       SIZES[hidden])))
    raygen = drive_raygen(cnr, params, card)
    kernels.append(kernel_entry("march_kernel_raygen", K1_SOURCE,
                                "cudaneuralrender_tpu/pallas/megakernel.py:377",
                                **raygen[cfg.coarse_precision]))
    drive_option(cnr, params, "relax_newton", dict(relax_newton=True), card)
    drive_option(cnr, params, "tail_pallas", dict(tail_pallas=True, refine_pallas=False), card)
    print(f"phase 10 (precision ladder, cold start): {time.perf_counter() - t10:.1f} s wall",
          flush=True)

    # 11. the step-cost experiment kernels X1-X3
    t11 = time.perf_counter()
    kernels.extend(drive_experiments(card))
    print(f"phase 11 (step-cost experiments): {time.perf_counter() - t11:.1f} s wall",
          flush=True)

    # 12. training on the card
    t12 = time.perf_counter()
    kernels.append(kernel_entry("march_kernel_train_solve", K1_SOURCE,
                                "cudaneuralrender_tpu/pallas/megakernel.py:45",
                                **drive_training(cnr, params, card)))
    print(f"phase 12 (training): {time.perf_counter() - t12:.1f} s wall", flush=True)

    # 13. the render package: warm starts, fused chunks, item 10, interactive, multigeom
    t13 = time.perf_counter()
    kernels.append(kernel_entry("march_kernel_warm", K1_SOURCE,
                                "cudaneuralrender_tpu/pallas/megakernel.py:45",
                                **drive_render_package(cnr, params, card)))
    print(f"phase 13 (render package): {time.perf_counter() - t13:.1f} s wall", flush=True)

    # 14. parallel/: sharded frames and training, the fault drill, process worlds
    t14 = time.perf_counter()
    kernels.append(drive_parallel(cnr, params, card))
    print(f"phase 14 (parallel): {time.perf_counter() - t14:.1f} s wall", flush=True)

    # 15. the empty-space phases (prepass, grid) and the ReLU tie backward
    t15 = time.perf_counter()
    kernels.extend(drive_empty_space(cnr, params, card))
    kernels.append(drive_relu_tie(cnr, params, tie_launches, card))
    print(f"phase 15 (prepass, grid, relu_tie_backward): {time.perf_counter() - t15:.1f} s wall",
          flush=True)
    print(f"chip_smoke total: {time.perf_counter() - T_START:.1f} s wall [{card}]", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
