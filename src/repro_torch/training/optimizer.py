"""Optimizers and LR schedules over params trees — counterpart of
``repro/training/optimizer.py``.

AdamW and SGD with momentum are written out as the reference writes them,
leaf by leaf over the params tree (``repro_torch.tree``), not through
``torch.optim``: the update, its order of operations and its state
(``step`` an int32 scalar tensor, the moments a tree like the params)
are the reference's, so states cross between the packages and steps match.
Every leaf of the tree is updated, BatchNorm running statistics included
(their gradient is zero, so weight decay alone moves them), as in the
reference. Updates are functional: new tensors, the inputs untouched.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip_norm: Optional[float] = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    # dtype of the first/second-moment accumulators (fp32 master states)
    state_dtype: torch.dtype = torch.float32


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (fp32)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree.leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled so their global norm is at most ``max_norm``, the
    norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree.map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    step_device = tree.leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=step_device),
        mu=tree.map(zeros, params),
        nu=tree.map(zeros, params),
    )


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW step -> (new_params, new_state, metrics)."""
    metrics = {}
    if cfg.grad_clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
        metrics["grad_norm"] = gnorm
    step = state.step + 1
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule is not None else 1.0)
    metrics["lr"] = lr
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(g, m, v, p):
        g32 = g.to(cfg.state_dtype)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(cfg.state_dtype)
        return (p.to(cfg.state_dtype) - lr * delta).to(p.dtype), m, v

    out = [
        upd(g, m, v, p)
        for g, m, v, p in zip(
            tree.leaves(grads), tree.leaves(state.mu), tree.leaves(state.nu), tree.leaves(params)
        )
    ]
    new_params = tree.unflatten(params, [o[0] for o in out])
    new_mu = tree.unflatten(params, [o[1] for o in out])
    new_nu = tree.unflatten(params, [o[2] for o in out])
    return new_params, AdamWState(step=step, mu=new_mu, nu=new_nu), metrics


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class SGDState(NamedTuple):
    step: torch.Tensor
    velocity: Any


def sgd_init(params, cfg: SGDConfig) -> SGDState:
    step_device = tree.leaves(params)[0].device
    return SGDState(
        step=torch.zeros((), dtype=torch.int32, device=step_device),
        velocity=tree.map(torch.zeros_like, params),
    )


def sgd_update(grads, state: SGDState, params, cfg: SGDConfig):
    """One SGD-with-momentum step -> (new_params, new_state, metrics)."""
    step = state.step + 1
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule is not None else 1.0)

    def upd(g, v, p):
        g = g + cfg.weight_decay * p
        v = cfg.momentum * v + g
        return p - lr * v, v

    out = [
        upd(g, v, p)
        for g, v, p in zip(tree.leaves(grads), tree.leaves(state.velocity), tree.leaves(params))
    ]
    new_params = tree.unflatten(params, [o[0] for o in out])
    new_v = tree.unflatten(params, [o[1] for o in out])
    return new_params, SGDState(step=step, velocity=new_v), {"lr": lr}


# --- schedules ---------------------------------------------------------------


def warmup_cosine(warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    """Linear warmup to 1 over ``warmup_steps``, then a cosine to
    ``final_frac`` at ``total_steps`` (a multiplier of the base lr)."""

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)

    return sched


def constant():
    return lambda step: torch.ones((), dtype=torch.float32, device=step.device)
