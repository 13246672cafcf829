"""The train step and its loss, over the port's parameter trees.

Port of the JAX package's ``repro.training.trainer``. Parameters are f32
leaves that require grad; :func:`repro_torch.models.model.forward` casts
them to the compute dtype each step (a tied embedding gets its gradient
from both of its uses) and rematerialises each layer as the config says.
Gradients come from ``torch.autograd``; the update is
:func:`repro_torch.training.optimizer.adamw_update`. Nothing in a step
reads a device value on the host: the metrics are tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_update, init_adamw


@dataclass
class TrainState:
    params: object
    opt: AdamWState
    step: torch.Tensor  # int32 scalar, as in the reference


def train_state(params) -> TrainState:
    """A fresh state over ``params`` (e.g. bridged from the reference):
    leaves detached to require grad, zero moments, step 0."""
    params = tree_map(lambda a: a.detach().requires_grad_(True), params)
    opt = init_adamw(params)
    return TrainState(params=params, opt=opt, step=torch.zeros_like(opt.step))


def init_train_state(cfg: ModelConfig, *, seed: int = 0, device=None) -> TrainState:
    """Random weights from ``seed`` on ``device`` (the card unless
    ``device="cpu"``), and a fresh optimizer state."""
    return train_state(model_lib.init_params(cfg, seed=seed, device=device))


def abstract_train_state(cfg: ModelConfig) -> TrainState:
    """The state's shapes and dtypes on the ``meta`` device (no memory): the
    port's counterpart of the reference's ``jax.eval_shape``."""
    return init_train_state(cfg, device="meta")


def cross_entropy(logits, labels, mask=None):
    """logits [B,S,V] f32, labels [B,S] int; mean over valid tokens."""
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: {"tokens"|"embeds", "labels", optional "mask", "positions"}
    as tensors. Returns (loss, metrics with loss, ce, lb_loss, drop_frac)."""
    inputs = {k: batch[k] for k in ("tokens", "embeds", "positions") if k in batch}
    logits, aux = model_lib.forward(params, cfg, inputs)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    loss = ce + cfg.router_aux_coef * aux["lb_loss"]
    metrics = {"loss": loss, "ce": ce, "lb_loss": aux["lb_loss"], "drop_frac": aux["drop_frac"]}
    return loss, metrics


def _placed_as(g, p):
    """On a mesh, a gradient in its parameter's placement (a partial sum
    reduced, FSDP's reduce-scatter), so the update keeps every leaf's
    placement; a plain tensor as it is."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """(state, batch) -> (new state, metrics): the loss and its gradient
    with respect to every parameter leaf (zero for a leaf the loss does not
    reach, as JAX gives), then one AdamW update. ``metrics`` adds the raw
    gradient norm and the learning rate."""

    def train_step(state: TrainState, batch):
        leaves = tree_leaves(state.params)
        loss, metrics = loss_fn(state.params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(torch.zeros_like(p) if g is None else _placed_as(g, p) for p, g in zip(leaves, grads))
        grads = tree_map(lambda _: next(it), state.params)
        new_params, new_opt, opt_metrics = adamw_update(opt_cfg, state.params, grads, state.opt)
        metrics = {k: v.detach() for k, v in metrics.items()} | opt_metrics
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(params, cfg, batch)[1]

    return eval_step
