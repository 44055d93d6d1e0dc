"""Optimizer and schedule factories behind the reference's string names.

Counterpart of ``ppt_tpu/train/optim.py``: the schedules ``cosine``,
``constant``, ``multistep``, ``step``, ``poly``, ``cosine_restarts``/
``sgdr``, ``tanh``/``tanhlr`` and ``plateau`` (each joined to the linear
warmup as ``optax.join_schedules`` joins them), and the optimizer zoo by the
reference's names. Every optimizer is written out from the optax 0.2.6
chain the reference builds (``optax/_src/alias.py``, ``transform.py``,
``factorized.py``), in the same order and in f32 (norms and means summed in
f64 and rounded once, so the card and the host agree), on a fixed dict of
named tensors updated in place; ``torch.optim`` is not used, since its defaults
differ in almost every case. The learning rate is read at ``count`` before
the increment (``adahessian`` reads it after, as the reference's does).

The gradients are first clipped by their global norm when
``grad_norm_clip > 0``; with ``plateau_patience > 0`` the chain ends in
``optax.contrib.reduce_on_plateau``'s stage, which scales the updates (not
the logged learning rate) by the loss averaged over ``steps_per_epoch``
steps. Every branch that depends on data is taken on the card, so a step
never waits for the host.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ppt_torch.train import schedules as S

_f = np.float32
SCHEDULES = ("cosine", "coslr", "constant", "multistep", "step", "poly", "cosine_restarts",
             "sgdr", "tanh", "tanhlr", "plateau")


def build_schedule(name: str, base_lr: float, epochs: int, steps_per_epoch: int, *,
                   final_lr: float = 0.0, warmup_epochs: int = 0, warmup_start_lr: float = 0.0,
                   milestones: Tuple[int, ...] = (120, 160), gamma: float = 0.1,
                   power: float = 0.9) -> Callable:
    """``schedule(step) -> lr`` (a float, computed in numpy f32) as the
    reference's ``build_schedule`` (``train/optim.py:35-127``)."""
    total = epochs * steps_per_epoch
    warm = warmup_epochs * steps_per_epoch
    name = name.lower()
    if name in ("cosine", "coslr"):
        return S.cosine_with_warmup(base_lr, final_lr, epochs, steps_per_epoch,
                                    warmup_epochs=warmup_epochs, warmup_start_lr=warmup_start_lr)
    if name in ("cosine_restarts", "sgdr"):  # one cycle per milestones[0] epochs
        cycle = max(milestones[0], 1) * steps_per_epoch
        return S.cosine_restarts(base_lr, final_lr, warmup_start_lr, max(warm, 1), cycle,
                                 max(total // cycle, 1))
    if name == "multistep":
        sched = S.multistep(base_lr, [m * steps_per_epoch for m in milestones], gamma)
    elif name == "step":
        sched = S.step_decay(base_lr, steps_per_epoch * max(milestones[0], 1), gamma)
    elif name == "poly":
        sched = S.poly(base_lr, final_lr, power, total - warm)
    elif name in ("constant", "plateau"):  # plateau: the curve is the optimizer's stage
        sched = S.constant_with_warmup(base_lr)
    elif name in ("tanh", "tanhlr"):
        sched = S.tanh_decay(base_lr, final_lr, max(total - warm, 1))
    else:
        raise KeyError(f"unknown schedule {name!r}; supported: {' '.join(SCHEDULES)}")
    return S.join_warmup(sched, base_lr, warm, warmup_start_lr)


def _bc(decay: float, count: int) -> float:
    """optax's bias correction ``1 - decay ** count`` in f32."""
    return float(_f(1.0) - _f(decay) ** _f(count))


def _norm(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The L2 norm summed in f64 and rounded once to f32 (as ``_mean`` and
    ``_sum``): the card and the host then agree whatever order each sums
    in, and each stays within optax's f32 rounding of the exact value."""
    return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim, dtype=torch.float64).float()


def _leaf_norm(x: torch.Tensor, group=None) -> torch.Tensor:
    """``_norm`` of a whole leaf; for a tensor-parallel shard (``group`` its
    'model' group) the squares are summed in f64 over every shard."""
    if group is None:
        return _norm(x)
    from ppt_torch.parallel.collectives import all_reduce_

    return _sqrt(all_reduce_((x.double() ** 2).sum(), group))


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    x = x.double()
    return (x.mean() if dim is None else x.mean(dim, keepdim=keepdim)).float()


def _sum(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    return x.double().sum(dim, keepdim=keepdim).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root on every device: the card's
    f32 ``sqrt`` is off by an ulp at times, its f64 one is exact, and an
    exact f64 root rounds to the exact f32 one."""
    return torch.sqrt(x.double()).float()


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(x)``, each step correctly rounded on every device (the
    card's ``rsqrt`` is an approximation)."""
    return torch.reciprocal(_sqrt(x))


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim f32 tensor on ``like``'s device: a divisor of
    this kind divides with one rounding on the card too (a CUDA tensor
    divided by a host number is multiplied by its reciprocal), as optax's
    division does."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], clip: float,
                        shard_groups: Optional[Dict[str, object]] = None
                        ) -> Dict[str, torch.Tensor]:
    """``optax.clip_by_global_norm``: every gradient times ``clip / norm``
    when the f32 L2 norm over all of them is at least ``clip``, else as
    given. Decided on the card: no wait for the host. A tensor-parallel
    shard (named in ``shard_groups`` with its 'model' group) adds the
    squares of every shard."""
    gs = {k: g.float() for k, g in grads.items()}
    sq = [(g.double() ** 2).sum() for g in gs.values()]
    if shard_groups:
        from ppt_torch.parallel.collectives import all_reduce_

        sq = [all_reduce_(s, shard_groups[k]) if k in shard_groups else s
              for k, s in zip(gs, sq)]
    norm = _sqrt(sum(sq))
    keep = norm < clip
    return {k: torch.where(keep, g, g / norm * clip) for k, g in gs.items()}


class ReduceOnPlateau:
    """``optax.contrib.reduce_on_plateau`` as the reference builds it
    (``train/optim.py:402-410``: rtol 1e-4, atol 0, no cooldown, min_scale
    0): the loss is averaged over ``accumulation_size`` steps; when the
    average has not improved on the best by ``rtol`` for ``patience``
    averages the scale is multiplied by ``factor``. The step count is the
    host's; the rest lives on the card as 0-dim tensors."""

    RTOL = 1e-4
    _STATE = ("scale", "best_value", "plateau_count", "avg_value")

    def __init__(self, factor: float, patience: int, accumulation_size: int, device):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"plateau factor must be in (0, 1), got {factor}")
        self.factor, self.patience, self.accumulation_size = factor, patience, accumulation_size
        self.count = 0
        self.scale = torch.ones((), dtype=torch.float32, device=device)
        self.best_value = torch.full((), float("inf"), dtype=torch.float32, device=device)
        self.plateau_count = torch.zeros((), dtype=torch.int32, device=device)
        self.avg_value = torch.zeros((), dtype=torch.float32, device=device)

    def __call__(self, updates: Dict[str, torch.Tensor], value) -> Dict[str, torch.Tensor]:
        if value is None:
            raise ValueError("reduce_on_plateau needs the step's loss: step(grads, value=loss)")
        value = torch.as_tensor(value, dtype=torch.float32, device=self.scale.device)
        new_count = self.count + 1
        self.avg_value = (self.count * self.avg_value + value) / _scalar(new_count, value)
        self.count = new_count
        if new_count == self.accumulation_size:
            improved = self.avg_value < float(_f(1.0 - self.RTOL)) * self.best_value
            self.best_value = torch.where(improved, self.avg_value, self.best_value)
            curr = torch.where(improved, torch.zeros_like(self.plateau_count),
                               self.plateau_count + 1)
            hit = curr == self.patience
            self.scale = torch.where(hit, self.scale * self.factor, self.scale)
            self.plateau_count = torch.where(hit, torch.zeros_like(curr), curr)
            self.count = 0
            self.avg_value = torch.zeros_like(self.avg_value)
        return {k: self.scale * u for k, u in updates.items()}

    def state_dict(self) -> Dict:
        return {"count": self.count, **{k: getattr(self, k) for k in self._STATE}}

    def load_state_dict(self, state: Dict) -> None:
        for k in self._STATE:
            getattr(self, k).copy_(state[k])
        self.count = int(state["count"])


class Optimizer:
    """A dict of named tensors and the reference's update chain on them.

    ``step(grads, *, value=None, hess=None)`` takes the gradients by name
    (and the loss for the plateau stage, the Hessian diagonal for
    ``adahessian``), forms optax's update in f32 and adds it to each
    tensor in place; ``count`` is the number of steps taken. Subclasses
    name their per-leaf state in ``slots`` and write ``update``."""

    slots: Tuple[str, ...] = ()
    # tensor-parallel shards among ``params``, by name, with their 'model'
    # group (``parallel.sharding.shard_groups``): the whole-leaf norms sum
    # over it
    shard_groups: Dict[str, object] = {}
    # the mesh the step runs on (``trainer.create_train_state``), or None for
    # one process: ``step`` first reduces the gradients over its ranks
    mesh = None

    def __init__(self, params: Iterable[Tuple[str, torch.Tensor]], schedule: Callable, *,
                 grad_norm_clip: float = 0.0, plateau: Optional[Tuple[float, int, int]] = None):
        self.params: Dict[str, torch.Tensor] = dict(params)
        self.schedule = schedule
        self.grad_norm_clip = grad_norm_clip
        self.count = 0
        device = next(iter(self.params.values())).device if self.params else "cpu"
        self.plateau = None if plateau is None else ReduceOnPlateau(*plateau, device=device)
        self.init_slots()

    def init_slots(self) -> None:
        for slot in self.slots:
            setattr(self, slot, self._full(0.0))

    def _full(self, value: float) -> Dict[str, torch.Tensor]:
        return {k: torch.full_like(p, value, dtype=torch.float32) for k, p in self.params.items()}

    def lr(self) -> float:
        return self.schedule(self.count)

    def update(self, grads: Dict[str, torch.Tensor], lr: float,
               hess: Optional[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], *, value=None,
             hess: Optional[Dict[str, torch.Tensor]] = None) -> None:
        if self.mesh is not None:
            grads = self.reduce_over_mesh(grads)
            if hess is not None:
                hess = self.reduce_over_mesh(hess)
        lr = self.lr()
        if self.grad_norm_clip > 0.0:
            grads = clip_by_global_norm(grads, self.grad_norm_clip, self.shard_groups)
        else:
            grads = {k: g.float() for k, g in grads.items()}
        updates = self.update(grads, lr, hess)
        if self.plateau is not None:
            updates = self.plateau(updates, value)
        for name, p in self.params.items():
            p.add_(updates[name].to(p.dtype))
        self.count += 1

    def reduce_over_mesh(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``grads`` summed over the ranks that hold each tensor (every rank
        for a replicated one, the data axis for a tensor-parallel shard) and
        divided by the world size (``parallel.collectives`` says why that is
        the gradient of the global mean loss): ``torch.autograd.grad`` fills
        no ``.grad``, so no DDP hook could."""
        from ppt_torch.parallel.collectives import ALONE, reduce_gradients
        from ppt_torch.parallel.mesh import axis_group

        data = axis_group(self.mesh, "data") or ALONE
        return reduce_gradients(grads, self.mesh.size(),
                                {k: data for k in self.shard_groups if k in grads})

    def state_dict(self) -> Dict:
        state = {"count": self.count, **{s: dict(getattr(self, s)) for s in self.slots}}
        if self.plateau is not None:
            state["plateau"] = self.plateau.state_dict()
        return state

    def load_state_dict(self, state: Dict) -> None:
        for slot in self.slots:
            have, got = getattr(self, slot), state[slot]
            if set(have) != set(got):
                raise ValueError(f"optimizer state {slot!r} has leaves {sorted(got)}, the "
                                 f"trainable partition has {sorted(have)}")
            for k, v in got.items():
                if tuple(v.shape) != tuple(have[k].shape):
                    raise ValueError(f"optimizer state {slot!r} leaf {k} has shape "
                                     f"{tuple(v.shape)}, the state {tuple(have[k].shape)}")
                have[k].copy_(v)
        if (self.plateau is None) != ("plateau" not in state):
            raise ValueError("optimizer state and optimizer disagree on the plateau stage")
        if self.plateau is not None:
            self.plateau.load_state_dict(state["plateau"])
        self.count = int(state["count"])


def _decayed(grads, params, wd: float) -> Dict[str, torch.Tensor]:
    """``optax.add_decayed_weights(wd)``: ``g + wd * p``."""
    return {k: g + wd * params[k].float() for k, g in grads.items()}


def _trace(trace: Dict[str, torch.Tensor], updates, decay: float, nesterov: bool):
    """``optax.trace``: ``t = u + decay t``; the update is ``t`` or, with
    Nesterov, ``u + decay t``."""
    out = {}
    for k, u in updates.items():
        trace[k].copy_(u + decay * trace[k])
        out[k] = u + decay * trace[k] if nesterov else trace[k]
    return out


def _trust_ratio(update: torch.Tensor, param: torch.Tensor, coeff: float = 1.0,
                 group=None) -> torch.Tensor:
    """``optax.scale_by_trust_ratio`` (min_norm 0, eps 0) on one leaf (a
    tensor-parallel shard's norms over its ``group``)."""
    pn = _leaf_norm(param.float(), group)
    un = _leaf_norm(update, group)
    ratio = coeff * pn / un
    return update * torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(ratio), ratio)


def _scale(updates, lr: float) -> Dict[str, torch.Tensor]:
    """``optax.scale_by_learning_rate``: every update times ``-lr``."""
    return {k: u * -lr for k, u in updates.items()}


class _Adam(Optimizer):
    """``optax.scale_by_adam`` and what the reference chains around it."""

    slots = ("mu", "nu")

    def __init__(self, params, schedule, *, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, **kw):
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        super().__init__(params, schedule, **kw)

    def adam(self, grads, nesterov: bool = False) -> Dict[str, torch.Tensor]:
        t = self.count + 1
        out = {}
        for k, g in grads.items():
            c1, c2 = _scalar(_bc(self.b1, t), g), _scalar(_bc(self.b2, t), g)
            mu, nu = self.mu[k], self.nu[k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            if nesterov:
                m = self.b1 * (mu / _scalar(_bc(self.b1, t + 1), g)) + (1 - self.b1) * (g / c1)
            else:
                m = mu / c1
            out[k] = m / (_sqrt(nu / c2) + self.eps)
        return out


class AdamW(_Adam):
    """``optax.adamw``: Adam, then the decoupled decay ``wd * p`` on every
    leaf it is given (prompt tokens included), then ``-lr``; moments f32."""

    def __init__(self, params, schedule, weight_decay: float = 0.1,
                 betas: Tuple[float, float] = (0.9, 0.98), eps: float = 1e-8, **kw):
        super().__init__(params, schedule, betas=betas, eps=eps, weight_decay=weight_decay, **kw)

    def update(self, grads, lr, hess):
        return _scale(_decayed(self.adam(grads), self.params, self.weight_decay), lr)


class Adam(_Adam):
    """``optax.adam`` (no decay) or, with ``nesterov``, ``add_decayed_weights``
    then ``optax.nadam``."""

    def __init__(self, params, schedule, *, nesterov: bool = False, **kw):
        self.nesterov = nesterov
        super().__init__(params, schedule, **kw)

    def update(self, grads, lr, hess):
        if self.nesterov:
            grads = _decayed(grads, self.params, self.weight_decay)
        return _scale(self.adam(grads, nesterov=self.nesterov), lr)


class Lamb(_Adam):
    """``optax.lamb``: Adam, then ``+ wd * p``, then the trust ratio
    ``|p| / |u|``, then ``-lr``."""

    def update(self, grads, lr, hess):
        u = _decayed(self.adam(grads), self.params, self.weight_decay)
        return _scale({k: _trust_ratio(v, self.params[k], 1.0, self.shard_groups.get(k))
                       for k, v in u.items()}, lr)


class AdamP(_Adam):
    """The reference's AdamP (``train/optim.py:355-369``): Adam on the raw
    gradient, the radial part projected out of scale-invariant leaves and
    their decay scaled by ``wd_ratio``, then ``-lr``."""

    def update(self, grads, lr, hess):
        if self.shard_groups:
            raise NotImplementedError("adamp: its channel-wise projection reads whole rows of "
                                      "each leaf; it takes no tensor-parallel shards")
        return _scale(_project(self.adam(grads), self.params, self.weight_decay), lr)


def _project(updates, params, weight_decay: float, wd_ratio: float = 0.1, delta: float = 0.1,
             eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """AdamP/SGDP's projection (``_projection_channelwise`` and
    ``_projected``, ``train/optim.py:272-331``): a leaf of two or more
    dimensions whose rows all have ``|cos(p, u)| < delta / sqrt(row size)``
    loses the update's component along each row of ``p`` and has its decay
    scaled by ``wd_ratio``."""
    out = {}
    for k, u in updates.items():
        p = params[k].float()
        if p.dim() < 2:
            pu, ratio = u, 1.0
        else:
            pv, uv = p.reshape(p.shape[0], -1), u.reshape(p.shape[0], -1)
            pn = pv / (_norm(pv, dim=1, keepdim=True) + eps)
            un = uv / (_norm(uv, dim=1, keepdim=True) + eps)
            cos = torch.abs(_sum(pn * un, dim=1))
            dim = torch.tensor(pv.shape[1], dtype=torch.float32, device=p.device)
            invariant = torch.amax(cos) < _scalar(delta, p) / _sqrt(dim)
            projected = uv - pn * _sum(pn * uv, dim=1, keepdim=True)
            pu = torch.where(invariant, projected, uv).reshape(p.shape)
            ratio = torch.where(invariant, torch.tensor(wd_ratio, device=p.device),
                                torch.tensor(1.0, device=p.device))
        out[k] = pu + weight_decay * ratio * p if weight_decay else pu
    return out


class Sgd(Optimizer):
    """``add_decayed_weights`` then ``optax.sgd`` with momentum: ``sgd`` and
    ``nesterov`` are Nesterov (the reference's legacy naming), ``momentum``
    is plain heavy-ball. With ``project`` it is the reference's SGDP (the
    Nesterov trace on the raw gradient, then the AdamP projection)."""

    slots = ("trace",)

    def __init__(self, params, schedule, *, momentum: float = 0.9, nesterov: bool = True,
                 weight_decay: float = 0.0, project: bool = False, **kw):
        self.momentum, self.nesterov = momentum, nesterov
        self.weight_decay, self.project = weight_decay, project
        super().__init__(params, schedule, **kw)

    def update(self, grads, lr, hess):
        if self.project:
            u = _trace(self.trace, grads, self.momentum, self.nesterov)
            return _scale(_project(u, self.params, self.weight_decay), lr)
        grads = _decayed(grads, self.params, self.weight_decay)
        return _scale(_trace(self.trace, grads, self.momentum, self.nesterov), lr)


class Lars(Optimizer):
    """``optax.lars``: ``+ wd * p``, the trust ratio with coefficient 1e-3,
    ``-lr``, then the momentum trace (after the learning rate)."""

    slots = ("trace",)

    def __init__(self, params, schedule, *, weight_decay: float = 0.0, momentum: float = 0.9,
                 **kw):
        self.weight_decay, self.momentum = weight_decay, momentum
        super().__init__(params, schedule, **kw)

    def update(self, grads, lr, hess):
        g = _decayed(grads, self.params, self.weight_decay)
        u = _scale({k: _trust_ratio(v, self.params[k], 0.001, self.shard_groups.get(k))
                    for k, v in g.items()}, lr)
        return _trace(self.trace, u, self.momentum, False)


class AdaBelief(_Adam):
    """``add_decayed_weights`` then ``optax.adabelief`` (eps_root 1e-16,
    kept inside the stored second moment)."""

    def update(self, grads, lr, hess):
        grads = _decayed(grads, self.params, self.weight_decay)
        t = self.count + 1
        out = {}
        for k, g in grads.items():
            c1, c2 = _scalar(_bc(self.b1, t), g), _scalar(_bc(self.b2, t), g)
            mu, nu = self.mu[k], self.nu[k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            err = g - mu
            nu.copy_((1 - self.b2) * (err * err) + self.b2 * nu + 1e-16)
            out[k] = (mu / c1) / (_sqrt(nu / c2) + self.eps)
        return _scale(out, lr)


class RAdam(_Adam):
    """``add_decayed_weights`` then ``optax.radam``: the rectified step once
    the length of the approximated SMA reaches 5, else the bias-corrected
    momentum alone (decided on the host: it depends on the count only)."""

    def update(self, grads, lr, hess):
        grads = _decayed(grads, self.params, self.weight_decay)
        t = self.count + 1
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = _f(self.b2) ** _f(t)
        ro = _f(ro_inf) - _f(2 * t) * b2t / (_f(1.0) - b2t)
        r = np.sqrt((ro - _f(4.0)) * (ro - _f(2.0)) * _f(ro_inf)
                    / (_f((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)) if ro >= 5.0 else None
        out = {}
        for k, g in grads.items():
            c1, c2 = _scalar(_bc(self.b1, t), g), _scalar(_bc(self.b2, t), g)
            mu, nu = self.mu[k], self.nu[k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            m = mu / c1
            out[k] = float(r) * m / (_sqrt(nu / c2) + self.eps) if r is not None else m
        return _scale(out, lr)


class Adamax(_Adam):
    """``add_decayed_weights`` then ``optax.adamax``: the second slot is the
    infinity norm ``max(|g| + eps, b2 nu)``, not bias-corrected."""

    def update(self, grads, lr, hess):
        grads = _decayed(grads, self.params, self.weight_decay)
        out = {}
        for k, g in grads.items():
            c1 = _scalar(_bc(self.b1, self.count + 1), g)
            mu, nu = self.mu[k], self.nu[k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_(torch.maximum(torch.abs(g) + self.eps, self.b2 * nu))
            out[k] = (mu / c1) / nu
        return _scale(out, lr)


class AdaDelta(Optimizer):
    """``add_decayed_weights`` then ``optax.adadelta`` (rho 0.9)."""

    slots = ("e_g", "e_x")

    def __init__(self, params, schedule, *, eps: float = 1e-6, weight_decay: float = 0.0,
                 rho: float = 0.9, **kw):
        self.eps, self.weight_decay, self.rho = eps, weight_decay, rho
        super().__init__(params, schedule, **kw)

    def update(self, grads, lr, hess):
        grads = _decayed(grads, self.params, self.weight_decay)
        rho, out = self.rho, {}
        for k, g in grads.items():
            e_g, e_x = self.e_g[k], self.e_x[k]
            e_g.copy_((1 - rho) * (g * g) + rho * e_g)
            u = (_sqrt(e_x + self.eps) / _sqrt(e_g + self.eps)) * g
            e_x.copy_((1 - rho) * (u * u) + rho * e_x)
            out[k] = u
        return _scale(out, lr)


class AdaGrad(Optimizer):
    """``add_decayed_weights`` then ``optax.adagrad``: the sum of squares
    starts at 0.1, and the step is ``g / sqrt(sum + eps)``."""

    slots = ("sum_of_squares",)

    def __init__(self, params, schedule, *, eps: float = 1e-7, weight_decay: float = 0.0,
                 initial_accumulator_value: float = 0.1, **kw):
        self.eps, self.weight_decay = eps, weight_decay
        self.initial = initial_accumulator_value
        super().__init__(params, schedule, **kw)

    def init_slots(self) -> None:
        self.sum_of_squares = self._full(self.initial)

    def update(self, grads, lr, hess):
        grads = _decayed(grads, self.params, self.weight_decay)
        out = {}
        for k, g in grads.items():
            s = self.sum_of_squares[k]
            s.copy_(g * g + s)
            inv = torch.where(s > 0, _rsqrt(s + self.eps), torch.zeros_like(s))
            out[k] = inv * g
        return _scale(out, lr)


class RmsProp(Optimizer):
    """``add_decayed_weights`` then ``optax.rmsprop(decay=0.9, momentum=0.9)``:
    ``g / sqrt(nu + eps)`` (eps inside the root, optax's default), ``-lr``,
    then the momentum trace. ``rmsprop_tf`` starts ``nu`` at 1."""

    slots = ("nu", "trace")

    def __init__(self, params, schedule, *, eps: float = 1e-8, weight_decay: float = 0.0,
                 momentum: float = 0.9, decay: float = 0.9, initial_scale: float = 0.0, **kw):
        self.eps, self.weight_decay, self.momentum = eps, weight_decay, momentum
        self.decay, self.initial_scale = decay, initial_scale
        super().__init__(params, schedule, **kw)

    def init_slots(self) -> None:
        self.nu = self._full(self.initial_scale)
        self.trace = self._full(0.0)

    def update(self, grads, lr, hess):
        grads = _decayed(grads, self.params, self.weight_decay)
        out = {}
        for k, g in grads.items():
            nu = self.nu[k]
            nu.copy_((1 - self.decay) * (g * g) + self.decay * nu)
            out[k] = _rsqrt(nu + self.eps) * g
        return _trace(self.trace, _scale(out, lr), self.momentum, False)


class NovoGrad(Optimizer):
    """``optax.novograd``: a per-leaf second moment of the squared gradient
    norm (the first step takes it whole), the first moment of
    ``g / (sqrt(nu) + eps) + wd * p``, then ``-lr``."""

    slots = ("mu", "nu")

    def __init__(self, params, schedule, *, betas=(0.9, 0.25), eps: float = 1e-6,
                 weight_decay: float = 0.0, **kw):
        self.b1, self.b2 = betas
        self.eps, self.weight_decay = eps, weight_decay
        super().__init__(params, schedule, **kw)

    def init_slots(self) -> None:
        self.mu = self._full(0.0)
        self.nu = {k: torch.zeros((), dtype=torch.float32, device=p.device)
                   for k, p in self.params.items()}

    def update(self, grads, lr, hess):
        first = self.count == 0
        out = {}
        for k, g in grads.items():
            n = _leaf_norm(g, self.shard_groups.get(k))
            n2 = n * n
            nu, mu = self.nu[k], self.mu[k]
            nu.copy_(n2 if first else (1 - self.b2) * n2 + self.b2 * nu)
            add = g / (_sqrt(nu) + self.eps) + self.weight_decay * self.params[k].float()
            mu.copy_(add if first else self.b1 * mu + add)
            out[k] = mu
        return _scale(out, lr)


class Madgrad(Optimizer):
    """The reference's MADGRAD (``train/optim.py:217-270``): ``wd * p``
    added to the gradient, the weighted sums ``s`` and ``nu`` with
    ``lamb = lr sqrt(count + 1)``, and a step of ``(1 - momentum)`` towards
    ``x0 - s / (cbrt(nu) + eps)``."""

    slots = ("grad_sum", "grad_sum_sq", "x0")

    def __init__(self, params, schedule, *, momentum: float = 0.9, weight_decay: float = 0.0,
                 eps: float = 1e-6, **kw):
        self.momentum, self.weight_decay, self.eps = momentum, weight_decay, eps
        super().__init__(params, schedule, **kw)

    def init_slots(self) -> None:
        self.grad_sum, self.grad_sum_sq = self._full(0.0), self._full(0.0)
        self.x0 = {k: p.detach().float().clone() for k, p in self.params.items()}

    def update(self, grads, lr, hess):
        if self.weight_decay:
            grads = _decayed(grads, self.params, self.weight_decay)
        lamb = float(_f(lr) * np.sqrt(_f(self.count) + _f(1.0)))
        c = 1.0 - self.momentum
        out = {}
        for k, g in grads.items():
            s, v = self.grad_sum[k], self.grad_sum_sq[k]
            s.copy_(s + lamb * g)
            v.copy_(v + lamb * g * g)
            z = self.x0[k] - s / (_cbrt(v) + self.eps)
            out[k] = c * (z - self.params[k].float())
        return out


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root (``jnp.cbrt``): a power of 1/3 on |x| in f64,
    refined by one Newton step and rounded once to f32, so every device
    gives the correctly rounded root."""
    a = torch.abs(x).double()
    r = torch.pow(a, 1.0 / 3.0)
    r = torch.where(r > 0, r - (r * r * r - a) / (3.0 * r * r), r)
    return torch.copysign(r.float(), x)


class AdaFactor(Optimizer):
    """``optax.adafactor(lr, weight_decay_rate=wd)``: the factored second
    moment (a leaf whose two largest dimensions are both at least 128 keeps
    a row and a column mean, others a full ``v``; decay ``1 - (k+1)^-0.8``,
    epsilon 1e-30), the block-RMS clip at 1, ``lr``, the parameter-scale
    factor ``max(rms(p), 1e-3)``, then ``+ wd * p`` (after the learning
    rate), then the sign flip."""

    slots = ("v_row", "v_col", "v")

    def __init__(self, params, schedule, *, weight_decay: float = 0.0, min_dim: int = 128,
                 eps: float = 1e-30, **kw):
        self.weight_decay, self.min_dim, self.eps = weight_decay, min_dim, eps
        super().__init__(params, schedule, **kw)

    def factored_dims(self, shape) -> Optional[Tuple[int, int]]:
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.min_dim:
            return None
        return int(order[-2]), int(order[-1])

    def init_slots(self) -> None:
        self.v_row, self.v_col, self.v = {}, {}, {}
        for k, p in self.params.items():
            z = dict(dtype=torch.float32, device=p.device)
            dims = self.factored_dims(tuple(p.shape))
            one = torch.zeros((1,), **z)
            if dims is None:
                self.v_row[k], self.v_col[k], self.v[k] = one, one.clone(), torch.zeros(p.shape, **z)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                self.v_row[k] = torch.zeros(shape[:d0] + shape[d0 + 1:], **z)
                self.v_col[k] = torch.zeros(shape[:d1] + shape[d1 + 1:], **z)
                self.v[k] = one

    def update(self, grads, lr, hess):
        rate = _f(1.0) - _f(self.count + 1) ** _f(-0.8)
        keep, mix = float(rate), float(_f(1.0) - rate)
        out = {}
        for k, g in grads.items():
            p = self.params[k].float()
            dims = self.factored_dims(tuple(p.shape))
            sq = g * g + self.eps
            if dims is not None:
                d1, d0 = dims
                vr, vc = self.v_row[k], self.v_col[k]
                vr.copy_(keep * vr + mix * _mean(sq, d0))
                vc.copy_(keep * vc + mix * _mean(sq, d1))
                red = d1 - 1 if d1 > d0 else d1
                row = _rsqrt(vr / _mean(vr, red, keepdim=True))
                u = g * row.unsqueeze(d0) * _rsqrt(vc).unsqueeze(d1)
            else:
                v = self.v[k]
                v.copy_(keep * v + mix * sq)
                u = g * _rsqrt(v)
            u = u / torch.clamp_min(_sqrt(_mean(u * u)) / 1.0, 1.0)
            u = u * lr
            rms = _sqrt(_mean(p * p))
            u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
            out[k] = -1 * (u + self.weight_decay * p)
        return out


class AdaHessian(Optimizer):
    """The reference's ADAHESSIAN (``train/optim.py:135-187``): decoupled
    decay, the first moment of the gradient, the second of the squared
    Hutchinson diagonal ``hess``, both bias-corrected, denominator
    ``sqrt(v_hat) + eps`` (the reference's default ``hessian_power`` of 1,
    which no caller changes). It reads the learning rate at ``count + 1``."""

    slots = ("exp_avg", "exp_hess_sq")

    def __init__(self, params, schedule, *, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, **kw):
        self.b1, self.b2 = betas
        self.eps, self.weight_decay = eps, weight_decay
        super().__init__(params, schedule, **kw)

    def lr(self) -> float:
        return self.schedule(self.count + 1)

    def update(self, grads, lr, hess):
        if hess is None:
            raise ValueError("adahessian needs the Hessian diagonal: step(grads, hess=...)")
        t = self.count + 1
        decay = float(_f(-lr) * _f(self.weight_decay))
        step = float(_f(lr) / _f(_bc(self.b1, t)))
        out = {}
        for k, g in grads.items():
            c2 = _scalar(_bc(self.b2, t), g)
            m, v, h = self.exp_avg[k], self.exp_hess_sq[k], hess[k].float()
            m.copy_(self.b1 * m + (1.0 - self.b1) * g)
            v.copy_(self.b2 * v + (1.0 - self.b2) * h * h)
            denom = _sqrt(v / c2) + self.eps
            out[k] = decay * self.params[k].float() - step * m / denom
        return out


OPTIMIZERS = ("adamw", "adam", "sgd", "nesterov", "momentum", "lamb", "lars", "adabelief",
              "adafactor", "radam", "nadam", "adamax", "adadelta", "adagrad", "novograd",
              "nvnovograd", "rmsprop", "rmsproptf", "rmsprop_tf", "madgrad", "sgdp", "adamp",
              "adahessian")


def build_optimizer(name: str, params: Iterable[Tuple[str, torch.Tensor]], schedule: Callable,
                    *, weight_decay: float = 0.1, betas: Tuple[float, float] = (0.9, 0.98),
                    eps: float = 1e-8, momentum: float = 0.9, plateau_patience: int = 0,
                    steps_per_epoch: int = 1, plateau_factor: float = 0.1,
                    grad_norm_clip: float = 0.0) -> Optimizer:
    """The optimizer ``name`` over the named trainable tensors, as the
    reference's ``build_optimizer`` (``train/optim.py:371-518``) chains it:
    a global-norm clip first when ``grad_norm_clip > 0``, the reduce-on-
    plateau stage last when ``plateau_patience > 0``."""
    name = name.lower()
    betas = tuple(betas)
    kw = dict(grad_norm_clip=grad_norm_clip,
              plateau=(plateau_factor, plateau_patience, max(steps_per_epoch, 1))
              if plateau_patience > 0 else None)
    wd = dict(weight_decay=weight_decay)
    adam = dict(betas=betas, eps=eps, **wd, **kw)
    if name == "adamw":
        return AdamW(params, schedule, **adam)
    if name == "adam":
        return Adam(params, schedule, betas=betas, eps=eps, **kw)
    if name == "nadam":
        return Adam(params, schedule, nesterov=True, **adam)
    if name in ("sgd", "nesterov", "momentum", "sgdp"):
        return Sgd(params, schedule, momentum=momentum, nesterov=name != "momentum",
                   project=name == "sgdp", **wd, **kw)
    if name == "lamb":
        return Lamb(params, schedule, **adam)
    if name == "adamp":
        return AdamP(params, schedule, **adam)
    if name == "lars":
        return Lars(params, schedule, momentum=momentum, **wd, **kw)
    if name == "adabelief":
        return AdaBelief(params, schedule, **adam)
    if name == "adafactor":
        return AdaFactor(params, schedule, **wd, **kw)
    if name == "radam":
        return RAdam(params, schedule, **adam)
    if name == "adamax":
        return Adamax(params, schedule, **adam)
    if name == "adadelta":
        return AdaDelta(params, schedule, eps=eps, **wd, **kw)
    if name == "adagrad":
        return AdaGrad(params, schedule, eps=max(eps, 1e-8), **wd, **kw)
    if name in ("novograd", "nvnovograd"):
        return NovoGrad(params, schedule, **adam)
    if name in ("rmsprop", "rmsproptf", "rmsprop_tf"):
        return RmsProp(params, schedule, eps=eps, momentum=momentum,
                       initial_scale=0.0 if name == "rmsprop" else 1.0, **wd, **kw)
    if name == "madgrad":
        return Madgrad(params, schedule, momentum=momentum, **wd, **kw)
    if name == "adahessian":  # the reference's betas (0.9, 0.999), whatever --betas says
        return AdaHessian(params, schedule, betas=(0.9, 0.999), eps=eps, **wd, **kw)
    raise KeyError(f"unknown optimizer {name!r}; supported: {' '.join(OPTIMIZERS)}")
