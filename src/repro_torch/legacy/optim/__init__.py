"""Optimizers, schedules and gradient utilities (mirrors
``repro.legacy.optim``) on pytrees of tensors: nested dicts and lists, as
``DLRM.params()`` gives them.

AdamW's moments mirror the parameter pytree, so ``legacy.checkpoint``
saves ``(params, AdamState)`` in the reference's leaf order and a
checkpoint of either package restores in the other. ``update`` changes the
parameters and the moments in place (the counterpart of the reference's
``donate_argnums=(0, 1)``: no second copy of a 6.66 GB table state) and
returns them. Arithmetic is float32, as the reference's with 64-bit types
off. int8 gradient compression with error feedback is kept beside it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..tree import flatten, tree_map
from ..tree import leaves as tree_leaves


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # cosine | linear | constant
    min_lr_ratio: float = 0.1


class AdamState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: dict
    nu: dict


def tree_unflatten(like, new_leaves):
    """``new_leaves`` (in ``tree_leaves`` order) in the structure of
    ``like``."""
    return flatten(like)[1](list(new_leaves))


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule_lr(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor), float32 on its
    device."""
    dev = step.device
    step = step.to(torch.float32)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, dev))
    frac = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0, 1)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(_f32(math.pi, dev) * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = _f32(1.0, dev)
    return cfg.lr * warm * decay


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, float32."""
    leaves = tree_leaves(grads)
    total = sum(torch.sum(torch.square(g.float())) for g in leaves)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to a global norm of at most max_norm, the norm
    before)``; the leaves are scaled in place."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, gn


def init_adam(params) -> AdamState:
    """Zero moments of each parameter's shape, dtype and device; step 0."""
    dev = tree_leaves(params)[0].device
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                     tree_map(torch.zeros_like, params),
                     tree_map(torch.zeros_like, params))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, state: AdamState):
    """One AdamW step, in place on ``params`` and the moments, which are
    returned: ``(params, AdamState, {"lr", "grad_norm"})``. ``grads`` are
    clipped in place."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    fstep = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, step.device), fstep)
    bc2 = 1 - torch.pow(_f32(b2, step.device), fstep)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g32 = g.float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
    return params, AdamState(step, state.mu, state.nu), \
        {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def sgd_update(cfg: OptimizerConfig, params, grads, state: AdamState):
    """SGD with momentum 0.9 in ``mu`` (``nu`` untouched), in place."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                       tree_leaves(state.mu)):
        m.mul_(0.9).add_(g.float())
        p.copy_(p.float() - lr * m)
    return params, AdamState(step, state.mu, state.nu), \
        {"lr": lr, "grad_norm": gnorm}


def update(cfg: OptimizerConfig, params, grads, state: AdamState):
    if cfg.name == "adamw":
        return adamw_update(cfg, params, grads, state)
    if cfg.name == "sgd":
        return sgd_update(cfg, params, grads, state)
    raise ValueError(cfg.name)


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback (DP all-reduce compression)
# ---------------------------------------------------------------------------

def compress_int8(g: torch.Tensor):
    """``(q int8, scale)``: ``g`` over ``max|g| / 127`` rounded to nearest
    even and clipped to ±127."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_grads_with_feedback(grads, errors):
    """Quantize (grad + carried error); return ``(qs, new_errors)``, ``qs``
    a pytree of ``(q, scale)`` pairs."""
    def one(g, e):
        g32 = g.float() + e
        q, s = compress_int8(g32)
        return (q, s), g32 - decompress_int8(q, s)

    grad_leaves, rebuild = flatten(grads)
    out = [one(g, e) for g, e in zip(grad_leaves, tree_leaves(errors))]
    return rebuild([q for q, _ in out]), rebuild([e for _, e in out])
