"""One rank of a multi-process render-and-train world (parallel/multihost.py).

Start one process per rank, each with the same rendezvous, from the repo
root (gloo on the CPU; on one card every rank renders on ``cuda:0`` and the
collectives go through the CPU, since NCCL takes one rank per card):

    python -m cudaneuralrender_torch.examples.multihost_drill \\
        --init file:///tmp/cnr_world --world 2 --rank 0 --out /tmp/cnr_tiles &
    python -m cudaneuralrender_torch.examples.multihost_drill \\
        --init file:///tmp/cnr_world --world 2 --rank 1 --out /tmp/cnr_tiles

Each rank holds ``--shards`` logical shards of the global mesh on
``--device`` and, in order:
  1. renders a dense frame over the global mesh (``render_global``) and
     writes its own rows as tiles ``gspmd.rows*.npy``, no gather;
  2. gathers that frame whole (``gather_image``): ``gather_p{rank}.npy``;
  3. renders its own row bands (``render_bands``, no communication, the
     staged band path): tiles ``bands``; then again with host 1 declared
     failed, host 0 adopting its bands: tiles ``failover``;
  4. renders the staged frame over the global mesh: tiles
     ``gspmd_staged``;
  5. the schedule memo's broadcast: rank 0 alone is taught a schedule for a
     config whose own buckets overflow; every rank must then render that
     config on the fast path: ``memo_fast_p{rank}.npy`` (1 or 0);
  6. one sharded train step on the dense march, and one fed by the staged
     sharded solve: ``loss_p{rank}.npy`` / ``loss_solve_p{rank}.npy``, and
     on rank 0 each step's first Adam moments (a tenth of the gradient),
     ``mu.npz`` / ``mu_solve.npz``.
The caller assembles the tiles (``multihost.assemble_tiles``) and holds them
against a single-process render.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

import cudaneuralrender_torch as cnr
from cudaneuralrender_torch.diff import train
from cudaneuralrender_torch.parallel import multihost, sharding
from cudaneuralrender_torch.render import schedule

CAMERA = dict(rotation_y=30.0, rotation_x=10.0)
# A config whose own refine buckets overflow (tests/_multihost_worker.py's),
# and the schedule rank 0 alone is taught for it: every rung's bucket half
# of a shard.
PRONE = dict(compact_min=8, refine_schedule=((1024, 4), (1024, 0)), adaptive_rungs=False)
TAUGHT_SCHEDULE = ((2, 16), (2, 24), (2, 64), (2, 0))


def train_target(params, cfg):
    """The model's own dense render at Camera(rotation_y=24): the train
    steps' target."""
    return cnr.render_image(params, cnr.Camera(rotation_y=24.0),
                            cfg.replace(march_impl="while"))


def save_moments(path: str, state) -> None:
    np.savez(path, *[m.detach().cpu().numpy() for m in train._flat(state.opt_state.mu)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init", required=True, help="rendezvous: host:port or an init_method URL")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--out", required=True, help="directory for tiles and results")
    ap.add_argument("--model", default=os.path.join("examples", "assets", "csg_demo.npz"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--shards", type=int, default=4, help="logical shards on this rank")
    ap.add_argument("-W", dest="width", type=int, default=32)
    ap.add_argument("-H", dest="height", type=int, default=32)
    ap.add_argument("--steps", type=int, default=300, help="max march steps")
    args = ap.parse_args(argv)

    multihost.initialize(args.init, args.world, args.rank, backend=args.backend)
    rank = multihost.process_index()
    if multihost.process_count() != args.world:
        raise RuntimeError(f"world of {multihost.process_count()}, asked for {args.world}")
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device(args.device)
    params = cnr.load(args.model, device=dev)
    cfg = cnr.RenderConfig(width=args.width, height=args.height, max_steps=args.steps)
    cam = cnr.Camera(**CAMERA)
    mesh = multihost.global_mesh(devices=[dev] * args.shards)
    staged = cfg.replace(march_impl="staged")

    img = multihost.render_global(params, cam, cfg, mesh)
    multihost.write_local_tiles(img, args.out, "gspmd")
    np.save(os.path.join(args.out, f"gather_p{rank}.npy"), multihost.gather_image(img))

    multihost.write_band_tiles(multihost.render_bands(params, cam, staged, n_bands=4),
                               args.out, "bands")
    multihost.write_band_tiles(
        multihost.render_bands(params, cam, staged, n_bands=4, failed_hosts=[1]),
        args.out, "failover")

    multihost.write_local_tiles(multihost.render_global(params, cam, staged, mesh), args.out,
                                "gspmd_staged")

    prone = staged.replace(**PRONE)
    if rank == 0:
        schedule.memo_teach(params, prone, prone.replace(refine_schedule=TAUGHT_SCHEDULE))
    stats: dict = {}
    sharding.render_image_sharded_staged(params, cam, prone, mesh, stats_out=stats)
    fast = bool(stats["fast_path"]) and stats["refine_overflow"] == 0
    np.save(os.path.join(args.out, f"memo_fast_p{rank}.npy"), np.asarray([int(fast)]))

    target = train_target(params, cfg)
    state = train.init_train_state(params)
    new, loss = sharding.pixel_train_step_sharded(state, cam, target, cfg, mesh)
    np.save(os.path.join(args.out, f"loss_p{rank}.npy"), loss.cpu().numpy())
    t_star, hit = sharding.solve_surface_sharded(params, cam, staged, mesh)
    new_s, loss_s = sharding.pixel_train_step_sharded(state, cam, target, staged, mesh,
                                                      t_star=t_star, hit=hit)
    np.save(os.path.join(args.out, f"loss_solve_p{rank}.npy"), loss_s.cpu().numpy())
    if rank == 0:
        save_moments(os.path.join(args.out, "mu.npz"), new)
        save_moments(os.path.join(args.out, "mu_solve.npz"), new_s)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
