"""The served weights, made on the device from the run's seed.

Every leaf of the program's parameter layout (its shapes and dtypes, read
from ``repro_torch.models.model.abstract_params``) is drawn by one call of
a seeded ``torch.Generator`` on the device, in the type it is served in,
and scaled in place: the same seed gives the same weights. The program
and the reference read these same tensors.
"""
from __future__ import annotations

import math

import torch

# (leaf name -> how it is drawn): "dense" N(0, 1/d_in), "embed" N(0, 0.02²),
# "one" ones, "small" N(0, 0.02²), "conv" N(0, 0.1²), "lora_b" N(0, 0.01/r),
# "a_log" log U(1, 16), "dt_bias" softplus⁻¹ of a log-uniform dt in
# [1e-3, 1e-1] (Mamba2's ranges), "mix" U(0, 0.5) (RWKV6's token shift
# mixes), "log_decay" U(-8, -4) (RWKV6's decay base, w = exp(-exp(.)))
KINDS = {
    "embed": "embed", "head": "dense", "wq": "dense", "wk": "dense", "wv": "dense", "wo": "dense",
    "gate": "dense", "up": "dense", "down": "dense", "w_in": "dense", "w_out": "dense",
    "lora_a": "dense", "lora_b": "lora_b", "bq": "small", "bk": "small", "bv": "small",
    "conv_w": "conv", "conv_b": "small", "a_log": "a_log", "dt_bias": "dt_bias", "d_skip": "one",
    "ln": "one", "ln1": "one", "ln2": "one", "final_norm": "one", "gate_norm": "one",
    "q_norm": "one", "k_norm": "one",
    # MoE router; MLA's low-rank projections and their norms
    "router": "small", "wdq": "dense", "wuq": "dense", "wdkv": "dense", "wuk": "dense", "wuv": "dense",
    "q_lora_norm": "one", "kv_norm": "one",
    # RWKV6's time and channel mixes
    "mu_x": "mix", "mu": "mix", "mu_k": "mix", "mu_r": "mix", "mix_a": "small", "mix_b": "small",
    "decay_a": "small", "decay_b": "small", "w0": "log_decay", "u": "conv", "wr": "dense", "wg": "dense",
    "ln_x": "one",
}


def _draw(kind: str, shape, dtype, g: torch.Generator, device) -> torch.Tensor:
    if kind == "one":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind in ("a_log", "dt_bias", "mix", "log_decay"):
        u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
        if kind == "a_log":
            return torch.log1p(u * 15.0).to(dtype)
        if kind == "mix":
            return (u * 0.5).to(dtype)
        if kind == "log_decay":
            return (u * 4.0 - 8.0).to(dtype)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    w = torch.randn(shape, generator=g, device=device, dtype=dtype)
    scale = {"embed": 0.02, "small": 0.02, "conv": 0.1}.get(kind)
    if kind == "dense":
        scale = 1.0 / math.sqrt(shape[-2])
    elif kind == "lora_b":
        scale = 0.1 / math.sqrt(shape[-2])
    return w.mul_(scale)


def make_weights(cfg, seed: int, device) -> dict:
    """The parameter tree of ``cfg`` (a ``ModelConfig``) on ``device``."""
    from repro_torch.models.model import abstract_params

    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))

    def walk(t, key=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, key) for v in t]
        return _draw(KINDS[key], tuple(t.shape), t.dtype, g, device)

    return walk(abstract_params(cfg))
