"""The trainer's optimizer: global-norm clipping, then optax's adafactor (or
adamw), on a warmup-cosine, linear or constant schedule.

Counterpart of the JAX package's ``train/trainer.py::make_optimizer``, which
chains ``optax.clip_by_global_norm`` and ``optax.adafactor`` as configured
there (``multiply_by_parameter_scale=True``, ``clipping_threshold=1.0``,
``decay_rate=0.8``, ``min_dim_size_to_factor=128``, ``eps=1e-30``, factored
second moments, no weight decay) or ``optax.adamw``. The arithmetic follows
optax 0.2.6 step for step. ``torch.optim.Adafactor`` is another algorithm
(no parameter scale, another decay), so it does not serve.

Plain functions on tensors, in the shape of an optax transformation:
``init(params)`` gives the state, a flat dict of tensors;
``update(grads, state, params)`` gives ``(updates, new_state)`` and the
caller adds the updates to the parameters. Parameters, gradients and state
are dicts of fp32 tensors keyed by parameter name.

Under tensor parallelism both take a ``Sharding``: the parameters, the
gradients and the state are then this rank's shards of the tensors that
``parallel.mesh.param_sharding_rules`` splits, and every number the
optimizer reads of a whole tensor is summed over the model group, so the
update is the whole-tensor optimizer's, as GSPMD gives the JAX trainer:
the factored dims come from the full shape; the global norm, the means of
adafactor's factors over a split dim, its block RMS and parameter scale
sum over the model group. A step makes at most three all-reduces of flat
buffers, whatever the number of tensors: the clip norm, the factors'
partial sums (adafactor, where a split tensor is factored), and the
squares of each split tensor's update and parameter (adafactor). Without
a ``Sharding`` nothing of this runs.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from ..parallel.mesh import MODEL_AXIS, Mesh

Params = dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class Sharding(NamedTuple):
    """Tensor parallelism as the optimizer sees it: ``mesh``, whose model
    group holds the other shards, and each parameter's full shape and rule
    (``parallel.mesh.param_sharding_rules``; None where it is
    replicated)."""

    mesh: Mesh
    shapes: Mapping[str, tuple[int, ...]]
    rules: Mapping[str, tuple[int, int] | None]

    def split_dim(self, name: str) -> int | None:
        rule = self.rules[name]
        return None if rule is None else rule[0]

    def model_sum(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor summed over the model group, in one all-reduce of a
        flat buffer."""
        if not tensors:
            return []
        flat = self.mesh.all_reduce(torch.cat([t.reshape(-1) for t in tensors]), MODEL_AXIS)
        return [piece.view_as(t) for piece, t in zip(flat.split([t.numel() for t in tensors]),
                                                     tensors)]


def _full_shape(sharding: Sharding | None, name: str, t: torch.Tensor) -> tuple[int, ...]:
    return tuple(t.shape) if sharding is None else tuple(sharding.shapes[name])


def _split_dim(sharding: Sharding | None, name: str) -> int | None:
    return None if sharding is None else sharding.split_dim(name)


class Optimizer(NamedTuple):
    """``init(params, sharding=None)`` and ``update(grads, state, params,
    sharding=None)``."""

    init: Callable[..., Params]
    update: Callable[..., tuple[Params, Params]]


# --- schedules (optax.linear_schedule / cosine_decay_schedule / join) ------


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_schedule(
    learning_rate: float, total_steps: int, warmup_ratio: float, lr_scheduler_type: str
) -> Schedule:
    """The learning rate at each update count, as ``make_optimizer`` builds
    it: linear warmup from 0 over max(1, total·ratio) steps, then cosine to
    0, linear to 0, or constant."""
    warmup = max(1, int(total_steps * warmup_ratio))
    decay_steps = max(total_steps, warmup + 1)
    warm = _linear(0.0, learning_rate, warmup)
    if lr_scheduler_type == "cosine":
        span = decay_steps - warmup

        def cosine(count: int) -> float:
            count = min(count, span)
            return learning_rate * 0.5 * (1 + math.cos(math.pi * count / span))

        return _join(warm, cosine, warmup)
    if lr_scheduler_type == "linear":
        return _join(warm, _linear(learning_rate, 0.0, max(1, decay_steps - warmup)), warmup)
    if lr_scheduler_type == "constant":
        return _join(warm, lambda count: learning_rate, warmup)
    raise ValueError(f"Unknown lr_scheduler_type: {lr_scheduler_type!r}")


# --- transformations ---------------------------------------------------------


def global_norm(tensors: Params, sharding: Sharding | None = None) -> torch.Tensor:
    """The norm of every tensor together; under ``sharding`` the split
    tensors' squares summed over the model group, the replicated ones'
    counted once."""
    if sharding is None:
        return torch.sqrt(sum(t.float().square().sum() for t in tensors.values()))
    device = next(iter(tensors.values())).device

    def squares(split: bool) -> torch.Tensor:
        return sum((t.float().square().sum() for k, t in tensors.items()
                    if (sharding.split_dim(k) is not None) == split),
                   torch.zeros((), device=device))

    (split_sq,) = sharding.model_sum([squares(True)])
    return torch.sqrt(split_sq + squares(False))


def clip_by_global_norm(grads: Params, max_norm: float,
                        sharding: Sharding | None = None) -> Params:
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm reaches max_norm. The choice stays on the device
    (no host sync), as ``jax.lax.select`` keeps it."""
    norm = global_norm(grads, sharding)
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm) * max_norm) for k, g in grads.items()}


def _factored_dims(shape: tuple[int, ...], min_dim_size_to_factor: int):
    """optax's choice: the two largest dims, if the smaller is large enough."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(t.square().mean())


def adafactor(
    schedule: Schedule,
    *,
    min_dim_size_to_factor: int = 128,
    decay_rate: float = 0.8,
    clipping_threshold: float = 1.0,
    eps: float = 1e-30,
    min_param_scale: float = 1e-3,
) -> Optimizer:
    """optax.adafactor(learning_rate=schedule, multiply_by_parameter_scale=
    True, clipping_threshold, decay_rate, eps, factored=True)."""

    def init(params: Params, sharding: Sharding | None = None) -> Params:
        state = {"count": torch.zeros((), dtype=torch.int64)}
        for name, p in params.items():
            dims = _factored_dims(_full_shape(sharding, name, p), min_dim_size_to_factor)
            if dims is None:
                state[f"v/{name}"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state[f"v_row/{name}"] = torch.zeros_like(p).mean(dim=d0)
                state[f"v_col/{name}"] = torch.zeros_like(p).mean(dim=d1)
        return state

    def update(grads: Params, state: Params, params: Params,
               sharding: Sharding | None = None) -> tuple[Params, Params]:
        count = int(state["count"])
        t = torch.tensor(count + 1, dtype=torch.float32)
        decay = 1.0 - t ** (-decay_rate)
        lr = schedule(count)
        new_state = {"count": state["count"] + 1}
        # 1. The second moments. A mean over a split dim is a local sum
        # here, summed over the model group below, then divided by the
        # dim's full size; so is the mean of a v_row that keeps the split.
        factors, partial, scaled = {}, [], {}
        for name, g in grads.items():
            grad_sqr = g * g + eps
            shape = _full_shape(sharding, name, g)
            dims = _factored_dims(shape, min_dim_size_to_factor)
            if dims is None:
                v = decay * state[f"v/{name}"] + (1.0 - decay) * grad_sqr
                new_state[f"v/{name}"] = v
                scaled[name] = g * v.rsqrt()
                continue
            d1, d0 = dims
            split = _split_dim(sharding, name)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            if split == d0:
                row, col = grad_sqr.sum(dim=d0), grad_sqr.mean(dim=d1)
                partial.append(row)
            elif split == d1:
                row, col = grad_sqr.mean(dim=d0), grad_sqr.sum(dim=d1)
                partial.append(col)
            else:
                row, col = grad_sqr.mean(dim=d0), grad_sqr.mean(dim=d1)
            v_row = decay * state[f"v_row/{name}"] + (1.0 - decay) * row if split != d0 else None
            if split == d1:
                partial.append(v_row.sum(dim=reduced_d1, keepdim=True))
            factors[name] = (dims, split, reduced_d1, row, col, v_row)
        summed = iter(sharding.model_sum(partial) if partial else ())
        for name, ((d1, d0), split, reduced_d1, row, col, v_row) in factors.items():
            shape = _full_shape(sharding, name, grads[name])
            if split == d0:
                row = next(summed) / shape[d0]
                v_row = decay * state[f"v_row/{name}"] + (1.0 - decay) * row
            elif split == d1:
                col = next(summed) / shape[d1]
            v_col = decay * state[f"v_col/{name}"] + (1.0 - decay) * col
            new_state[f"v_row/{name}"], new_state[f"v_col/{name}"] = v_row, v_col
            row_mean = (next(summed) / shape[d1] if split == d1
                        else v_row.mean(dim=reduced_d1, keepdim=True))
            row_factor = (v_row / row_mean) ** -0.5
            scaled[name] = grads[name] * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
        # 2. The block RMS of each update and of its parameter; a split
        # tensor's from its squares summed over the model group.
        split_names = [k for k in grads if _split_dim(sharding, k) is not None]
        squares = {}
        if split_names:
            squares = dict(zip(split_names, sharding.model_sum(
                [torch.stack([scaled[k].square().sum(), params[k].square().sum()])
                 for k in split_names])))
        updates = {}
        for name in grads:
            u, p = scaled[name], params[name]
            if name in squares:
                rms_u, rms_p = torch.sqrt(squares[name] / math.prod(sharding.shapes[name]))
            else:
                rms_u, rms_p = _rms(u), _rms(p)
            u = u / torch.clamp(rms_u / clipping_threshold, min=1.0)  # clip_by_block_rms
            u = u * lr
            u = u * torch.where(rms_p <= min_param_scale, min_param_scale, rms_p)
            updates[name] = -u
        return updates, new_state

    return Optimizer(init, update)


def adamw(
    schedule: Schedule,
    *,
    weight_decay: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    """optax.adamw(schedule, weight_decay=...) with optax's defaults: decay
    on every parameter, added before the learning rate."""

    def init(params: Params, sharding: Sharding | None = None) -> Params:
        state = {"count": torch.zeros((), dtype=torch.int64)}
        for name, p in params.items():
            state[f"mu/{name}"] = torch.zeros_like(p)
            state[f"nu/{name}"] = torch.zeros_like(p)
        return state

    def update(grads: Params, state: Params, params: Params,
               sharding: Sharding | None = None) -> tuple[Params, Params]:
        # Element by element: a shard's update is the whole tensor's there.
        count = int(state["count"])
        lr = schedule(count)
        step = count + 1
        new_state = {"count": state["count"] + 1}
        updates = {}
        for name, g in grads.items():
            mu = (1 - b1) * g + b1 * state[f"mu/{name}"]
            nu = (1 - b2) * (g * g) + b2 * state[f"nu/{name}"]
            new_state[f"mu/{name}"], new_state[f"nu/{name}"] = mu, nu
            mu_hat = mu / (1 - b1**step)
            nu_hat = nu / (1 - b2**step)
            u = mu_hat / (torch.sqrt(nu_hat) + eps) + weight_decay * params[name]
            updates[name] = -(u * lr)
        return updates, new_state

    return Optimizer(init, update)


def make_optimizer(
    *,
    learning_rate: float,
    total_steps: int,
    warmup_ratio: float = 0.1,
    lr_scheduler_type: str = "cosine",
    optim: str = "adafactor",
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
) -> Optimizer:
    """Clipping by global norm (when max_grad_norm > 0), then adafactor or
    adamw on the schedule — ``make_optimizer`` of the JAX trainer. Its
    ``init`` and ``update`` take an optional ``Sharding``."""
    schedule = make_schedule(learning_rate, total_steps, warmup_ratio, lr_scheduler_type)
    if optim == "adafactor":
        inner = adafactor(schedule)
    elif optim in ("adamw", "adamw_torch"):
        inner = adamw(schedule, weight_decay=weight_decay)
    else:
        raise ValueError(f"Unknown optimizer: {optim!r}")
    if not (max_grad_norm and max_grad_norm > 0):
        return inner

    def update(grads: Params, state: Params, params: Params,
               sharding: Sharding | None = None) -> tuple[Params, Params]:
        return inner.update(clip_by_global_norm(grads, max_grad_norm, sharding), state, params,
                            sharding)

    return Optimizer(inner.init, update)
