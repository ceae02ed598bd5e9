"""Optimizers and learning-rate schedules (port of
``hypernerf_tpu/training/optimizers.py``), in steps.

``get_optimizer`` returns (optimizer, schedule); ``train_state.
make_train_step`` writes ``schedule(i)`` into every group's ``lr`` before
update number ``i`` (from 0), as optax reads a schedule at its update count.

Each optimizer computes the update of the optax chain the JAX package
builds, with optax's scalars (the schedule, the bias corrections, RAdam's
rectifier) computed in float32 as JAX computes them:

* ``sgd``: ``torch.optim.SGD(momentum, dampening=0, weight_decay)`` is
  ``add_decayed_weights`` -> ``trace(decay=momentum)`` -> the rate.
* ``adam``: ``Adam``, optax's ``scale_by_adam(eps=1e-8)`` (eps outside the
  square root) after ``add_decayed_weights``. ``torch.optim.Adam`` computes
  the same update but with its bias corrections in float64, 1e-5 apart.
* ``radam``: ``RAdam``, optax's ``scale_by_radam(eps=1e-8)``: the
  bias-corrected first moment over sqrt(v_hat) + eps, scaled by the
  rectifier where rho_t >= 5 (from the sixth update at beta2 0.999), else
  the bias-corrected first moment alone. ``torch.optim.RAdam`` is another
  update: it scales by sqrt(1 - beta2^t) / (sqrt(v) + eps), so its eps is
  1 / sqrt(1 - beta2^t) times larger (13x at t = 6).
* ``ranger``: ``Ranger``, ``optax.lookahead(radam, sync_period=6,
  slow_step_size=0.5)``. The model's parameters are the fast weights (the
  forward, the val render and ``save_weights_only`` read them, as JAX's
  ``forward_params`` does); each parameter's slow weights live in the
  optimizer's state, the updates since the last sync in its group.

Every update writes through the parameter under ``no_grad`` (in-place
foreach ops), so each bumps the version counter that keys the level
kernels' packed weights (``kernels/common.py``); none takes a fused step.

ZeRO-1 (``shard_optimizer_state`` in a launch of N > 1 ranks, the JAX
package's ``train_state.py:100-117, 225-254``): ``get_optimizer`` returns a
``torch.distributed.optim.ZeroRedundancyOptimizer`` over the same class.
Each rank keeps the moments of its share of the parameters (whole tensors,
the largest first, each to the rank that holds the fewest elements so far),
updates that share and broadcasts it to the others. The update of each
parameter is the replicated one; at N = 1 the flag changes nothing, as in
JAX.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from hypernerf_tpu_torch.configs import TrainConfig

_EPS = 1e-8
_F32 = np.float32
# optax.lookahead's arguments for ranger (Ranger's defaults).
SYNC_PERIOD = 6
SLOW_STEP_SIZE = 0.5


def _pow(base: float, t) -> np.float32:
    """``base ** t`` in float32, as JAX computes a float to an int32 power."""
    return _F32(base) ** _F32(t)


def get_scheduler(cfg: TrainConfig, steps_per_epoch: int,
                  total_steps: Optional[int] = None
                  ) -> Callable[[int], float]:
    """step -> learning rate, in float32 as the JAX schedules compute it.

    ``steplr``: ``lr`` times ``decay_gamma`` at each distinct boundary
    ``decay_step[i] * steps_per_epoch`` the step has reached
    (``optax.piecewise_constant_schedule``). ``cosine``:
    ``optax.cosine_decay_schedule(lr, decay_steps=total_steps,
    alpha=1e-8 / lr)``. ``poly``: ``lr * clip(1 - (step / steps_per_epoch) /
    num_epochs, 0, 1) ** poly_exp``; like the JAX schedule it reads
    ``num_epochs`` even when ``max_steps`` sets the run's length. Warm-up
    (not for ``radam`` / ``ranger``): a ramp from ``lr`` to ``lr *
    warmup_multiplier`` over ``warmup_epochs * steps_per_epoch`` steps,
    then the schedule at ``step - warmup`` times the multiplier.
    """
    total_steps = total_steps or max(1, cfg.num_epochs * steps_per_epoch)
    lr = _F32(cfg.lr)
    if cfg.lr_scheduler == 'steplr':
        boundaries = sorted({int(e) * steps_per_epoch for e in cfg.decay_step})

        def base(step):
            v = lr
            for b in boundaries:
                if step >= b:
                    v = _F32(cfg.decay_gamma) * v
            return v
    elif cfg.lr_scheduler == 'cosine':
        alpha = _EPS / cfg.lr

        def base(step):
            count = _F32(min(step, total_steps))
            decay = _F32(0.5) * (_F32(1.0) + np.cos(
                _F32(np.pi) * count / _F32(total_steps)))
            return lr * (_F32(1.0 - alpha) * decay + _F32(alpha))
    elif cfg.lr_scheduler == 'poly':
        def base(step):
            frac = _F32(1.0) - (_F32(step) / _F32(steps_per_epoch)) / _F32(
                max(1, cfg.num_epochs))
            return lr * np.clip(frac, _F32(0.0), _F32(1.0)) ** _F32(
                cfg.poly_exp)
    else:
        raise ValueError(f'scheduler not recognized: {cfg.lr_scheduler}')

    schedule = base
    if cfg.warmup_epochs > 0 and cfg.optimizer not in ('radam', 'ranger'):
        warmup = cfg.warmup_epochs * steps_per_epoch
        multiplier = cfg.warmup_multiplier

        def schedule(step):
            if step <= warmup:
                return lr * (_F32(multiplier - 1.0)
                             * (_F32(step) / _F32(warmup)) + _F32(1.0))
            return base(step - warmup) * _F32(multiplier)
    return lambda step: float(schedule(int(step)))


def get_optimizer(cfg: TrainConfig, params, steps_per_epoch: int,
                  total_steps: Optional[int] = None, mesh=None):
    """(optimizer, schedule) of ``cfg.optimizer`` over ``params``; the
    schedule's value at update 0 is the groups' first ``lr``. With
    ``cfg.shard_optimizer_state`` and a ``parallel.DataParallel`` ``mesh``
    of more than one rank, the optimizer is ZeRO-1's: a
    ``ZeroRedundancyOptimizer`` of the same class on each rank's share of
    ``params``, whose ``step`` bumps every parameter's version on every rank
    and whose ``full_state_dict`` gathers the state to rank 0 (build it on
    every rank)."""
    schedule = get_scheduler(cfg, steps_per_epoch, total_steps)
    kw = dict(lr=schedule(0), weight_decay=cfg.weight_decay)
    if cfg.optimizer == 'sgd':
        cls = torch.optim.SGD
        kw.update(momentum=cfg.momentum, dampening=0.0)
    elif cfg.optimizer in ('adam', 'radam', 'ranger'):
        cls = {'adam': Adam, 'radam': RAdam, 'ranger': Ranger}[cfg.optimizer]
    else:
        raise ValueError(f'optimizer not recognized: {cfg.optimizer}')
    if cfg.shard_optimizer_state and mesh is not None \
            and mesh.world_size > 1:
        return _zero_class()(params, cls, **kw), schedule
    return cls(params, **kw), schedule


@functools.cache
def _zero_class():
    # Imported on first use: torch.distributed.optim takes seconds to load.
    from torch.distributed.optim import ZeroRedundancyOptimizer

    class ZeroOptimizer(ZeroRedundancyOptimizer):
        """``ZeroRedundancyOptimizer`` that keeps the level kernels' packed
        weights current and saves the replicated optimizer's state dict."""

        def step(self, closure=None, **kwargs):
            loss = super().step(closure, **kwargs)
            # Each rank updates its share in place (bumping those versions)
            # and receives the others' by broadcast, which bumps none: the
            # level kernels, whose packed bf16 weights are keyed on the
            # versions, would run the last step's weights on every rank but
            # a parameter's owner. Bumped here, where no caller can forget.
            torch.autograd.graph.increment_version(
                [p for g in self.param_groups for p in g['params']])
            return loss

        def full_state_dict(self):
            """The state dict of the replicated optimizer, each moment
            whole, on rank 0; None on the other ranks. Collective: call it
            on every rank."""
            self.consolidate_state_dict(to=0)
            if self.rank != 0:
                return None
            if self._default_device.type == 'cuda':
                # The consolidation's copies to the host are non-blocking.
                torch.cuda.synchronize(self._default_device)
            state = self.state_dict()
            self._all_state_dicts = []
            # The wrapper's groups hold what was synced from the local
            # optimizer; take every key the replicated groups have.
            for group, local in zip(state['param_groups'],
                                    self.optim.param_groups):
                group.update({k: v for k, v in local.items()
                              if k != 'params'})
            return state

    return ZeroOptimizer


def full_state_dict(optimizer):
    """``optimizer``'s state dict as a replicated run holds it: ZeRO's
    gathered to rank 0 (None elsewhere; collective), else its own."""
    if hasattr(optimizer, 'full_state_dict'):
        return optimizer.full_state_dict()
    return optimizer.state_dict()


def moment_bytes(optimizer) -> int:
    """Bytes of the optimizer state this rank holds (its tensors of more
    than one element: the moments, ranger's slow weights)."""
    # ZeRO-1's local optimizer holds this rank's share.
    state = getattr(optimizer, 'optim', optimizer).state
    return sum(v.numel() * v.element_size() for s in state.values()
               for v in s.values()
               if isinstance(v, torch.Tensor) and v.dim() > 0)


class Adam(torch.optim.Optimizer):
    """optax's ``add_decayed_weights(weight_decay)`` ->
    ``scale_by_adam(b1, b2, eps)`` -> ``scale_by_learning_rate(lr)``.

    Each parameter's state is torch.optim.Adam's: 'step' (the updates
    taken, a float32 CPU tensor), 'exp_avg' and 'exp_avg_sq' (optax's
    ``count``, ``mu`` and ``nu``)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = _EPS, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _rectifier(self, b2: float, t: int) -> Optional[np.float32]:
        """The factor of the update mu_hat / (sqrt(nu_hat) + eps) at update
        ``t``; None: the update is mu_hat alone. Adam: always 1."""
        return _F32(1.0)

    def _after(self, group, params) -> None:
        """Runs after a group's parameters took their update."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group['params'] if p.grad is not None]
            if not params:
                continue
            states = []
            for p in params:
                state = self.state[p]
                if 'step' not in state:
                    state['step'] = torch.tensor(0.0)
                    state['exp_avg'] = torch.zeros_like(p)
                    state['exp_avg_sq'] = torch.zeros_like(p)
                states.append(state)
            grads = [p.grad for p in params]
            if group['weight_decay']:
                grads = torch._foreach_add(grads, params,
                                           alpha=group['weight_decay'])
            b1, b2 = group['betas']
            mus = [s['exp_avg'] for s in states]
            nus = [s['exp_avg_sq'] for s in states]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            torch._foreach_add_([s['step'] for s in states], 1.0)
            t = int(states[0]['step'])
            bc1 = _F32(1.0) - _pow(b1, t)
            scale = self._rectifier(b2, t)
            lr = _F32(group['lr'])
            if scale is None:
                torch._foreach_add_(params, mus, alpha=float(-lr / bc1))
            else:
                denom = torch._foreach_div(nus, float(_F32(1.0)
                                                      - _pow(b2, t)))
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, group['eps'])
                torch._foreach_addcdiv_(params, mus, denom,
                                        value=float(-lr * scale / bc1))
            self._after(group, params)
        return loss


class RAdam(Adam):
    """optax's ``scale_by_radam(b1, b2, eps)`` in the same chain: with
    rho_inf = 2 / (1 - b2) - 1 and rho_t = rho_inf - 2 t b2^t / (1 - b2^t),
    the update is r_t mu_hat / (sqrt(nu_hat) + eps) where rho_t >= 5, with
    r_t = sqrt((rho_t - 4)(rho_t - 2) rho_inf / ((rho_inf - 4)(rho_inf - 2)
    rho_t)), else mu_hat. Same state as ``Adam``."""

    def _rectifier(self, b2: float, t: int) -> Optional[np.float32]:
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = _pow(b2, t)
        ro = _F32(ro_inf) - _F32(2 * t) * b2t / (_F32(1.0) - b2t)
        if not ro >= _F32(5.0):
            return None
        return np.sqrt((ro - _F32(4.0)) * (ro - _F32(2.0)) * _F32(ro_inf)
                       / (_F32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))


class Ranger(RAdam):
    """``optax.lookahead(RAdam chain, SYNC_PERIOD, SLOW_STEP_SIZE)``, with
    ``reset_state=False``: the parameters (the fast weights) take every
    update; on every ``SYNC_PERIOD``-th update, with d = fast - slow after
    it, slow += SLOW_STEP_SIZE * d and fast gets that same point (the
    moments are kept). Weight decay reads the fast weights. Each
    parameter's state adds 'slow'; the group holds 'steps_since_sync'."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = _EPS, weight_decay: float = 0.0):
        super().__init__(params, lr, betas, eps, weight_decay)
        for group in self.param_groups:
            group['steps_since_sync'] = 0
            for p in group['params']:
                self.state[p]['slow'] = p.detach().clone()

    def _after(self, group, params) -> None:
        group['steps_since_sync'] = (group['steps_since_sync'] + 1) \
            % SYNC_PERIOD
        if group['steps_since_sync']:
            return
        # optax's merged form: d = fast + u - slow; the fast weights take
        # u - (1 - a) d, the slow ones a d (the fast weights hold fast + u).
        slows = [self.state[p]['slow'] for p in params]
        diff = torch._foreach_sub(params, slows)
        torch._foreach_add_(slows, diff, alpha=SLOW_STEP_SIZE)
        torch._foreach_add_(params, diff, alpha=-(1.0 - SLOW_STEP_SIZE))

