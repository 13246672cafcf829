"""AdamW, its learning-rate schedules and global-norm clipping, written out
over the port's parameter trees (no optimizer library).

Port of the JAX package's ``repro.training.optimizer``, the same arithmetic
in the same order: the moments in f32, bias correction by 1 - b^step, and
weight decay on every leaf with two or more dimensions. The port's layer
parameters are stacked on a leading layer axis, as the reference's are,
so its stacked norm scales and biases ([L, d]) are decayed too: a fault of
the reference, kept here for parity. ``torch.optim.AdamW`` would differ in
both the bias correction and that rule.

Everything runs on the parameters' device and reads nothing back to the
host: the step counter, the learning rate and the norm are tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.model import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"  # cosine | constant


@dataclass
class AdamWState:
    """First and second moments (f32 trees shaped as the params) and the
    count of updates taken, an int32 scalar tensor as in the reference."""

    m: object
    v: object
    step: torch.Tensor


def _each_leaf(fn, tree, *others):
    """``fn(leaf, *the others' leaves at the same place)`` over trees of one
    structure, dicts matched by key (not by order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _each_leaf(fn, v, *(o[k] for o in others))
    elif isinstance(tree, (list, tuple)):
        for xs in zip(tree, *others):
            _each_leaf(fn, *xs)
    else:
        fn(tree, *others)


def init_adamw(params) -> AdamWState:
    zeros = lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    device = tree_leaves(params)[0].device
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or an int): linear warmup,
    then cosine decay to ``min_lr_frac`` of ``lr`` (or constant)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(a.float().square().sum() for a in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step. Returns (new_params, new_state, metrics) with new
    tensors (the inputs are not changed); the new params require grad
    where the old ones did. ``metrics``: the raw global gradient norm
    (before clipping) and the learning rate used."""
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * g.square()
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        decay = cfg.weight_decay * p.float() if p.dim() >= 2 else 0.0  # stacked [L, d] leaves too
        new_p = (p.float() - lr * (delta + decay)).to(p.dtype)
        return new_p.requires_grad_(p.requires_grad), m, v

    out = []  # one (p, m, v) per leaf, in the params' walk order
    _each_leaf(lambda *leaves: out.append(upd(*leaves)), params, grads, state.m, state.v)

    def unflatten(i):  # the i-th output of every leaf, in the params' tree
        it = iter(o[i] for o in out)
        return tree_map(lambda _: next(it), params)

    return unflatten(0), AdamWState(unflatten(1), unflatten(2), step), {"grad_norm": gnorm, "lr": lr}
