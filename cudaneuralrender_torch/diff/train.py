"""Training: optimizer steps for inverse rendering and SDF fitting.

The PyTorch counterpart of the JAX package's ``diff/train.py``. A
``TrainState`` is a value: every step returns a new state and writes into
no tensor of the old one, because ``train_loop_fast`` redoes a step from
the state before it. So the optimizer is not ``torch.optim.Adam`` (which
updates the live parameters in place) but ``Adam`` below, the same
formula as a pure function, in optax.adam's order.

Each step returns its loss as a 0-d tensor on the parameters' device.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.mlp import MLP, DenseParams
from ..ops import compaction
from ..ops.camera import Camera
from ..render import renderer as renderer_lib
from ..render import schedule
from ..utils.config import RenderConfig
from . import losses
from .solve import solve_surface, solve_surface_async, solve_surface_packed_async


class AdamState(NamedTuple):
    """optax.adam's state: the step count and the two moments, one
    ``DenseParams`` of each per layer."""

    count: torch.Tensor  # [] int32
    mu: Tuple[DenseParams, ...]
    nu: Tuple[DenseParams, ...]


class TrainState(NamedTuple):
    params: MLP
    opt_state: AdamState
    step: torch.Tensor  # [] int32


def _flat(layers) -> List[torch.Tensor]:
    """Layer tensors in the JAX package's tree order: w0, b0, w1, b1, ..."""
    return [t for layer in layers for t in (layer.w, layer.b)]


def _layers(flat: Sequence[torch.Tensor]) -> Tuple[DenseParams, ...]:
    return tuple(DenseParams(flat[i], flat[i + 1]) for i in range(0, len(flat), 2))


def _trainable(layers) -> MLP:
    """An ``MLP`` over these tensors whose parameters require grad (no copy)."""
    return MLP([(w.detach(), b.detach()) for w, b in layers], requires_grad=True)


class Adam(NamedTuple):
    """Adam as optax.adam computes it (eps_root 0):

        mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu,   count += 1
        p  = p + (-lr) * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

    out of place: ``update`` returns a new ``MLP`` and a new state."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: MLP) -> AdamState:
        zeros = _layers([torch.zeros_like(t, requires_grad=False) for t in _flat(params)])
        return AdamState(torch.zeros((), dtype=torch.int32, device=params.device), zeros, zeros)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamState,
               params: MLP) -> Tuple[MLP, AdamState]:
        count = torch.where(state.count < torch.iinfo(torch.int32).max, state.count + 1,
                            state.count)
        # The bias corrections in the parameters' dtype, as optax forms them
        # in its default float dtype.
        c = count.to(params[0].w.dtype)
        bc1 = 1 - torch.pow(self.b1, c)
        bc2 = 1 - torch.pow(self.b2, c)
        new_p, mu, nu = [], [], []
        for p, g, m, v in zip(_flat(params), grads, _flat(state.mu), _flat(state.nu)):
            m = (1 - self.b1) * g + self.b1 * m
            v = (1 - self.b2) * (g * g) + self.b2 * v
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            new_p.append(p.detach() + (-self.lr) * u)
            mu.append(m)
            nu.append(v)
        return _trainable(_layers(new_p)), AdamState(count, _layers(mu), _layers(nu))


def make_optimizer(lr: float = 1e-3) -> Adam:
    return Adam(lr)


def init_train_state(params: MLP, lr: float = 1e-3) -> TrainState:
    """A state at step 0 over ``params``' tensors (shared, never written)."""
    params.require_dense("training")
    params = _trainable(params)
    return TrainState(params, make_optimizer(lr).init(params),
                      torch.zeros((), dtype=torch.int32, device=params.device))


def _update(state: TrainState, grads: Sequence[torch.Tensor], lr: float) -> TrainState:
    """One Adam step of ``state`` with ``grads`` (in ``_flat`` order)."""
    params, opt_state = make_optimizer(lr).update(grads, state.opt_state, state.params)
    return TrainState(params, opt_state, state.step + 1)


def _grads(loss: torch.Tensor, params) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``loss`` with respect to ``params``' leaves, in
    ``_flat`` order. A leaf the graph does not reach gets zeros, as JAX's
    gradient does: a pixel loss's shading normals are piecewise constant in
    the biases, and ``mlp.relu_tie`` records no edge for that zero."""
    return torch.autograd.grad(loss, _flat(params), allow_unused=True, materialize_grads=True)


def _apply_grads(state: TrainState, loss: torch.Tensor, lr: float):
    """The gradient of ``loss`` with respect to the state's parameters and
    one Adam step: (new state, loss)."""
    return _update(state, _grads(loss, state.params), lr), loss.detach()


def pixel_train_step(state: TrainState, camera: Camera, target: torch.Tensor,
                     config: RenderConfig, lr: float = 1e-3):
    """One inverse-rendering step: d(pixel L2)/d(weights) via the implicit
    surface gradient, the surface solved by the dense march (which reads
    the host once a step), then Adam."""
    renderer_lib._require_fp32_matmul()
    loss = losses.pixel_loss(state.params, camera, config, target)
    return _apply_grads(state, loss, lr)


def _pixel_grad_step_packed(state: TrainState, camera: Camera, target, pos, t_packed,
                            conv, config: RenderConfig, lr: float, compact_cap: int,
                            within):
    """Grad + update from the solve's PACKED bundle
    (losses.pixel_loss_packed): no image-order restore, no whole-image
    re-pack."""
    loss = losses.pixel_loss_packed(state.params, camera, config, target, pos, t_packed,
                                    conv, compact_cap, within)
    return _apply_grads(state, loss, lr)


def _pixel_grad_step_from_t(state: TrainState, camera: Camera, target, t_star, hit,
                            config: RenderConfig, lr: float, compact_cap=None):
    """Grad + update from a PRECOMPUTED surface solve: one SDF evaluation
    and one SDF gradient per pixel, no march. ``compact_cap`` restricts the
    differentiated shading to a packed hit bucket (losses.pixel_loss)."""
    loss = losses.pixel_loss(state.params, camera, config, target, t_star=t_star, hit=hit,
                             compact_cap=compact_cap)
    return _apply_grads(state, loss, lr)


def _fetch(check, loss) -> np.ndarray:
    """ONE host read for a step's stats and loss (counts < 2^24 are exact
    in float32)."""
    return torch.cat([check.stats.to(torch.float32), loss.reshape(1)]).cpu().numpy()


def pixel_train_step_fast(state: TrainState, camera: Camera, target: torch.Tensor,
                          config: RenderConfig, lr: float = 1e-3, *,
                          stats_out: Optional[dict] = None):
    """One inverse-rendering step at the staged march's speed.

    The march is gradient-severed, so the t* solve runs through the staged
    scheduler and the march kernel (diff/solve.py), and the grad step then
    touches each hit ray twice (one SDF evaluation, one SDF gradient).

    Passing the SAME ``stats_out`` dict across consecutive steps turns on
    the pipelined mode: the previous step's hit count sizes this step's
    grad bucket, so the grad step is queued behind the solve with no host
    read in between; one read of the stats and the loss then validates the
    fast path, and the step is redone synchronously in the rare overflow or
    bucket-miss case.
    """
    renderer_lib._require_fp32_matmul()
    stats = stats_out if stats_out is not None else {}
    n = config.num_rays
    hint = stats.get("hits")
    # The packed handoff holds only under the bound of the config the solve
    # will EXECUTE (the memo may redirect to a widened schedule).
    within = schedule.conv_within(schedule.memo_lookup(state.params, config))

    if hint is not None and within is not None:
        # Packed pipelined path (mixed precision: every hit lives in the
        # first refine bucket); hits <= within, so clamping the bucket to
        # the bound is always valid.
        cap = min(compaction.capacity_pow2_of(hint, n, minimum=config.compact_min), within)
        pos, t_p, conv, w_bound, check = solve_surface_packed_async(state.params, camera, config)
        assert w_bound == within, (w_bound, within)  # same memo, same bound
        new_state, loss = _pixel_grad_step_packed(state, camera, target, pos, t_p, conv,
                                                  config, lr, cap, w_bound)
        if check(stats_out=stats, values=_fetch(check, loss)[:-1]):
            if stats["hits"] <= cap:
                return new_state, loss
            # The bucket was outgrown but the solve is fine: redo only the
            # grad step with a bucket sized from the true count.
            cap = min(compaction.capacity_pow2_of(stats["hits"], n, minimum=config.compact_min),
                      w_bound)
            return _pixel_grad_step_packed(state, camera, target, pos, t_p, conv, config, lr,
                                           cap, w_bound)
        # the solve failed: redo synchronously below

    elif hint is not None:
        # Pipelined, image order: size the bucket from the previous step,
        # queue solve + grad, read the stats and the loss once.
        cap = compaction.capacity_pow2_of(hint, n, minimum=config.compact_min)
        t_star, hit, check = solve_surface_async(state.params, camera, config)
        new_state, loss = _pixel_grad_step_from_t(state, camera, target, t_star, hit, config,
                                                  lr, cap if cap < n else None)
        if check(stats_out=stats, values=_fetch(check, loss)[:-1]):
            if stats["hits"] <= cap:
                return new_state, loss
            cap = compaction.capacity_pow2_of(stats["hits"], n, minimum=config.compact_min)
            return _pixel_grad_step_from_t(state, camera, target, t_star, hit, config, lr,
                                           cap if cap < n else None)
        # the solve failed: redo synchronously below

    t_star, hit = solve_surface(state.params, camera, config, stats_out=stats)
    hits = stats.get("hits") if stats.get("fast_path") else None
    if hits is None:
        hits = int(hit.sum())
        stats["hits"] = hits
    cap = compaction.capacity_pow2_of(hits, n, minimum=config.compact_min)
    return _pixel_grad_step_from_t(state, camera, target, t_star, hit, config, lr,
                                   cap if cap < n else None)


def train_loop_fast(state: TrainState, cameras, targets, config: RenderConfig,
                    lr: float = 1e-3, *, stats_out: Optional[list] = None):
    """Run N pipelined inverse-rendering steps with DEFERRED checks.

    Step k+1's solve and grad are queued BEFORE step k's stats and loss are
    read, so the host read overlaps the next step's device work. Steps
    chain on the device through the parameters (grad k -> solve k+1).

    On a fast-path failure at step k (refine overflow, bucket undershoot)
    the steps already queued after it are discarded and step k is redone
    synchronously from the last good state: the result is that of calling
    ``pixel_train_step_fast`` in a loop.

    cameras/targets: sequences of equal length (the number of steps); a
    single Camera or target is broadcast. Returns (final state, [loss
    floats]).
    """
    if isinstance(cameras, Camera):
        cameras = [cameras]
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    n_steps = max(len(cameras), len(targets))
    if len(cameras) == 1:
        cameras = list(cameras) * n_steps
    if len(targets) == 1:
        targets = list(targets) * n_steps
    if len(cameras) != n_steps or len(targets) != n_steps:
        raise ValueError(f"cameras ({len(cameras)}) and targets ({len(targets)}) must have "
                         "equal length (or be single/broadcastable)")
    n = config.num_rays
    losses_out: list = []

    # Prime the bucket hint with one synchronous step.
    seed_stats: dict = {}
    state, loss0 = pixel_train_step_fast(state, cameras[0], targets[0], config, lr,
                                         stats_out=seed_stats)
    losses_out.append(float(loss0))
    if stats_out is not None:
        stats_out.append(dict(seed_stats))
    cap = compaction.capacity_pow2_of(seed_stats.get("hits", n), n, minimum=config.compact_min)

    # A few steps in flight hide the host read behind device work without
    # an unbounded queue.
    window = 4
    k = 1
    while k < n_steps:
        # The packed bound of the config the solves will EXECUTE (a redo may
        # teach the memo mid-loop).
        within = schedule.conv_within(schedule.memo_lookup(state.params, config))
        inflight = []  # (index, prev_state, new_state, fused, check, bucket)
        s = state
        j = k
        failed_at = None
        while j < n_steps or inflight:
            while j < n_steps and len(inflight) < window:
                if within is not None:
                    bucket = min(cap, within)
                    pos, t_p, conv, w_bound, check = solve_surface_packed_async(
                        s.params, cameras[j], config)
                    assert w_bound == within, (w_bound, within)
                    s2, loss = _pixel_grad_step_packed(s, cameras[j], targets[j], pos, t_p,
                                                       conv, config, lr, bucket, w_bound)
                else:
                    bucket = cap if cap < n else n
                    t_star, hit, check = solve_surface_async(s.params, cameras[j], config)
                    s2, loss = _pixel_grad_step_from_t(s, cameras[j], targets[j], t_star, hit,
                                                       config, lr, cap if cap < n else None)
                fused = torch.cat([check.stats.to(torch.float32), loss.reshape(1)])
                inflight.append((j, s, s2, fused, check, bucket))
                s = s2
                j += 1
            jj, prev_s, new_s, fused, check, bucket = inflight.pop(0)
            vals = fused.cpu().numpy()
            st: dict = {}
            solve_ok = check(stats_out=st, values=vals[:-1])
            if not (solve_ok and st["hits"] <= bucket):  # the bucket actually queued
                # Redo step jj from the last good state; the queued steps
                # after it are discarded. When only the bucket undershot,
                # keep the hit count so the redo queues the right bucket;
                # after a solve failure drop it (the pipelined attempt would
                # rerun the same failing solve before falling back).
                redo_stats: dict = dict(hits=st.get("hits")) if solve_ok else {}
                state, loss = pixel_train_step_fast(prev_s, cameras[jj], targets[jj], config,
                                                    lr, stats_out=redo_stats)
                losses_out.append(float(loss))
                if stats_out is not None:
                    stats_out.append(dict(redo_stats, redone=True))
                cap = compaction.capacity_pow2_of(redo_stats.get("hits", n), n,
                                                  minimum=config.compact_min)
                failed_at = jj
                break
            if stats_out is not None:
                stats_out.append(st)
            losses_out.append(float(vals[-1]))
            state = new_s
        k = failed_at + 1 if failed_at is not None else n_steps
    return state, losses_out


def sdf_train_step(state: TrainState, points: torch.Tensor, target_d: torch.Tensor,
                   lr: float = 1e-3, eikonal_weight: float = 0.0):
    """One SDF-regression step (distillation, analytic fitting), with the
    eikonal term when ``eikonal_weight`` is non-zero."""
    renderer_lib._require_fp32_matmul()
    loss = losses.sdf_distillation_loss(state.params, points, target_d)
    if eikonal_weight:
        loss = loss + eikonal_weight * losses.eikonal_loss(state.params, points)
    return _apply_grads(state, loss, lr)


def fit_sdf(params: MLP, sample_fn, *, steps: int = 200, batch: int = 4096,
            lr: float = 1e-3, seed: int = 0):
    """Fit an MLP to a target field. ``sample_fn(generator, n)`` -> (points
    [n, n_in], d [n]) on the parameters' device, drawn from ``generator``, a
    ``torch.Generator`` on that device seeded with ``seed``. Returns
    (params, [loss floats])."""
    state = init_train_state(params, lr)
    generator = torch.Generator(device=state.params.device).manual_seed(seed)
    history = []
    for _ in range(steps):
        pts, d = sample_fn(generator, batch)
        state, loss = sdf_train_step(state, pts, d, lr)
        history.append(float(loss))
    return state.params, history


def _state_leaves(state: TrainState) -> List[torch.Tensor]:
    """The state's tensors in the JAX package's tree order: params, the
    Adam count, mu, nu, step."""
    opt = state.opt_state
    return (_flat(state.params) + [opt.count] + _flat(opt.mu) + _flat(opt.nu)
            + [state.step])


def save_train_state(path: str, state: TrainState) -> None:
    """Checkpoint a full TrainState (weights, Adam moments, step) as one
    .npz with one ``leaf{i}`` per tensor in the JAX package's tree order,
    so either package resumes the other's file."""
    np.savez(path, **{f"leaf{i}": t.detach().cpu().numpy()
                      for i, t in enumerate(_state_leaves(state))})


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Restore a TrainState saved by ``save_train_state`` (either
    package's) onto the template's device. ``template`` is any state of the
    same structure (e.g. ``init_train_state(params, lr)`` with the same
    model shape); its leaf values are replaced."""
    with np.load(path) as f:
        leaves = [f[f"leaf{i}"] for i in range(len(f.files))]
    t_leaves = _state_leaves(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template has {len(t_leaves)} "
                         "— optimizer or model shape mismatch")
    for got, want in zip(leaves, t_leaves):
        if got.shape != tuple(want.shape):
            raise ValueError(f"leaf shape mismatch: checkpoint {got.shape} vs template "
                             f"{tuple(want.shape)}")
        want_dtype = torch.empty((), dtype=want.dtype).numpy().dtype
        if got.dtype != want_dtype:
            # A state saved under another dtype would load silently and
            # change the numerics; bit-identical resume needs equal dtypes.
            raise ValueError(f"leaf dtype mismatch: checkpoint {got.dtype} vs template "
                             f"{want_dtype} — was this state saved under a different mlp_dtype?")
    dev = template.params.device
    tensors = [torch.as_tensor(x, device=dev) for x in leaves]
    m = 2 * len(template.params)
    return TrainState(
        _trainable(_layers(tensors[:m])),
        AdamState(tensors[m], _layers(tensors[m + 1:2 * m + 1]),
                  _layers(tensors[2 * m + 1:3 * m + 1])),
        tensors[3 * m + 1])
