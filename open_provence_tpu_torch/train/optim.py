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
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

Params = dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class Optimizer(NamedTuple):
    init: Callable[[Params], Params]
    update: Callable[[Params, Params, Params], tuple[Params, Params]]


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


def global_norm(tensors: Params) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors.values()))


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm reaches max_norm. The choice stays on the device
    (no host sync), as ``jax.lax.select`` keeps it."""
    norm = global_norm(grads)
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

    def init(params: Params) -> Params:
        state = {"count": torch.zeros((), dtype=torch.int64)}
        for name, p in params.items():
            dims = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            if dims is None:
                state[f"v/{name}"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state[f"v_row/{name}"] = torch.zeros_like(p).mean(dim=d0)
                state[f"v_col/{name}"] = torch.zeros_like(p).mean(dim=d1)
        return state

    def update(grads: Params, state: Params, params: Params) -> tuple[Params, Params]:
        count = int(state["count"])
        t = torch.tensor(count + 1, dtype=torch.float32)
        decay = 1.0 - t ** (-decay_rate)
        lr = schedule(count)
        new_state = {"count": state["count"] + 1}
        updates = {}
        for name, g in grads.items():
            p = params[name]
            grad_sqr = g * g + eps
            dims = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            if dims is None:
                v = decay * state[f"v/{name}"] + (1.0 - decay) * grad_sqr
                new_state[f"v/{name}"] = v
                u = g * v.rsqrt()
            else:
                d1, d0 = dims
                v_row = decay * state[f"v_row/{name}"] + (1.0 - decay) * grad_sqr.mean(dim=d0)
                v_col = decay * state[f"v_col/{name}"] + (1.0 - decay) * grad_sqr.mean(dim=d1)
                new_state[f"v_row/{name}"], new_state[f"v_col/{name}"] = v_row, v_col
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            u = u / torch.clamp(_rms(u) / clipping_threshold, min=1.0)  # clip_by_block_rms
            u = u * lr
            rms = _rms(p)
            u = u * torch.where(rms <= min_param_scale, min_param_scale, rms)
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

    def init(params: Params) -> Params:
        state = {"count": torch.zeros((), dtype=torch.int64)}
        for name, p in params.items():
            state[f"mu/{name}"] = torch.zeros_like(p)
            state[f"nu/{name}"] = torch.zeros_like(p)
        return state

    def update(grads: Params, state: Params, params: Params) -> tuple[Params, Params]:
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
    adamw on the schedule — ``make_optimizer`` of the JAX trainer."""
    schedule = make_schedule(learning_rate, total_steps, warmup_ratio, lr_scheduler_type)
    if optim == "adafactor":
        inner = adafactor(schedule)
    elif optim in ("adamw", "adamw_torch"):
        inner = adamw(schedule, weight_decay=weight_decay)
    else:
        raise ValueError(f"Unknown optimizer: {optim!r}")
    if not (max_grad_norm and max_grad_norm > 0):
        return inner

    def update(grads: Params, state: Params, params: Params) -> tuple[Params, Params]:
        return inner.update(clip_by_global_norm(grads, max_grad_norm), state, params)

    return Optimizer(inner.init, update)
