"""Abstract inputs for every (arch x input shape): ``meta`` tensors (shape
and dtype, no storage) where the reference has ``ShapeDtypeStruct``s.

Port of the JAX package's ``repro.launch.specs``, the same tables:

    train_4k     seq 4096,    global_batch 256   -> train step
    prefill_32k  seq 32768,   global_batch 32    -> prefill
    decode_32k   seq 32768,   global_batch 128   -> decode step (1 new token)
    long_500k    seq 524288,  global_batch 1     -> decode step, synapse/SSM

Skips: encoder-only archs (hubert) have no decode shapes; long_500k of the
dense, VLM and MoE archs runs ONLY through the synapse cache (the paper's
technique is what makes it sub-quadratic).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import torch_dtype
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# decode budget appended to prefill capacity
DECODE_PAD = 0
# synapse geometry for long-context decode (dense archs)
LONG_LANDMARKS = 4096
LONG_WINDOW = 1024
LONG_INJECT = 128


@dataclass(frozen=True)
class ShapePlan:
    arch: str
    shape: str
    kind: str           # train | prefill | decode
    seq: int
    batch: int
    cache_kind: str     # full | synapse | none (ssm-only or train)
    skip: str = ""      # non-empty -> skipped, with reason


def plan_for(cfg: ModelConfig, shape_name: str) -> ShapePlan:
    info = SHAPES[shape_name]
    kind, seq, batch = info["kind"], info["seq"], info["batch"]
    skip = ""
    cache_kind = "none"
    if kind == "decode":
        if cfg.is_encoder_only:
            skip = "encoder-only architecture: no autoregressive decode step"
        elif cfg.is_attention_free:
            cache_kind = "none"          # O(1) recurrent state
        elif shape_name == "long_500k":
            cache_kind = "synapse"       # paper's technique unlocks 500k
        else:
            cache_kind = "full"
    if kind == "prefill" and cfg.is_encoder_only:
        cache_kind = "none"              # encoder forward, no cache
    elif kind == "prefill":
        cache_kind = "full"
    return ShapePlan(cfg.name, shape_name, kind, seq, batch, cache_kind, skip)


def cache_spec_for(plan: ShapePlan) -> model_lib.CacheSpec:
    if plan.cache_kind == "synapse":
        return model_lib.CacheSpec(kind="synapse", n_landmarks=LONG_LANDMARKS, window=LONG_WINDOW,
                                   n_inject=LONG_INJECT)
    return model_lib.CacheSpec(kind="full", capacity=plan.seq + DECODE_PAD)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, seq: int, batch: int) -> dict:
    i32, f = torch.int32, torch_dtype(cfg.compute_dtype)
    out = {"labels": _meta((batch, seq), i32)}
    if cfg.embed_inputs:
        out["tokens"] = _meta((batch, seq), i32)
    else:
        out["embeds"] = _meta((batch, seq, cfg.d_model), f)
        if cfg.rope_kind == "mrope":
            out["positions"] = _meta((batch, 3, seq), i32)
    return out


def prefill_input_specs(cfg: ModelConfig, seq: int, batch: int) -> dict:
    i32, f = torch.int32, torch_dtype(cfg.compute_dtype)
    if cfg.embed_inputs:
        return {"tokens": _meta((batch, seq), i32)}
    out = {"embeds": _meta((batch, seq, cfg.d_model), f)}
    if cfg.rope_kind == "mrope":
        out["positions"] = _meta((batch, 3, seq), i32)
    return out


def decode_input_specs(cfg: ModelConfig, batch: int) -> dict:
    """Decode generates text tokens through the embed table: a tokens input
    for every decoding arch."""
    i32 = torch.int32
    pos = (batch, 3) if cfg.rope_kind == "mrope" else (batch,)
    return {"tokens": _meta((batch,), i32), "positions": _meta(pos, i32)}


def abstract_caches(cfg: ModelConfig, plan: ShapePlan):
    """(the plan's caches on ``meta``, their CacheSpec)."""
    spec = cache_spec_for(plan)
    return model_lib.init_caches(cfg, plan.batch, spec, device="meta"), spec


def input_specs(cfg: ModelConfig, plan: ShapePlan):
    """Returns (dict of meta input tensors, cache_spec or None)."""
    if plan.kind == "train":
        return train_batch_specs(cfg, plan.seq, plan.batch), None
    if plan.kind == "prefill":
        return prefill_input_specs(cfg, plan.seq, plan.batch), (
            None if plan.cache_kind == "none" else cache_spec_for(plan))
    return decode_input_specs(cfg, plan.batch), cache_spec_for(plan)
