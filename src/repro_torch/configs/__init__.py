"""Architecture registry of the port: one module per architecture, the
same ids and configs as the JAX package's ``repro.configs``.

``PORT_ARCHS`` holds the port's own configs, which ``get_config`` reads
too. ``get_config("qwen3-8b")`` returns the full config,
``get_config("qwen3-8b", reduced=True)`` the CPU smoke variant.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# arch id (CLI --arch) -> module name
ARCHS = {
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen1.5-110b": "qwen1p5_110b",
    "qwen3-8b": "qwen3_8b",
    "hubert-xlarge": "hubert_xlarge",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-4b": "qwen3_4b",
    "smollm-135m": "smollm_135m",
    # the paper's own evaluation model (Qwen2.5-0.5B-Instruct)
    "qwen2.5-0.5b": "qwen25_0p5b",
}

# configs of the port alone (the reference has no such architecture)
PORT_ARCHS = {
    # Zamba2-7B-Instruct as published: two alternating shared blocks on
    # [stream; embeddings], grouped Mamba2
    "zamba2-7b": "zamba2_7b",
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    table = {**ARCHS, **PORT_ARCHS}
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(table)}")
    mod = importlib.import_module(f"repro_torch.configs.{table[arch]}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg


def list_archs() -> list[str]:
    return list(ARCHS)
