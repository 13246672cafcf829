"""Architecture registry of the port (the dense-GQA configs of the first
slice; the other families wait for their model code).

``get_config("qwen2.5-0.5b")`` returns the full config,
``get_config("qwen2.5-0.5b", reduced=True)`` the CPU smoke variant.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# arch id -> module name
ARCHS = {
    "smollm-135m": "smollm_135m",
    # the paper's own evaluation model (Qwen2.5-0.5B-Instruct)
    "qwen2.5-0.5b": "qwen25_0p5b",
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg
