"""Long-context decode with the streaming Topological Synapse.

    PYTHONPATH=src python -m repro_torch.examples.long_context_synapse [--device cpu] [--full]

Port of the JAX package's ``examples/long_context_synapse.py``: qwen3-8b
decodes 300 tokens, one lane, through ``model.decode_step`` over a
synapse cache of 32 landmarks, a 32-token window and 4 injection slots,
every layer's attend one ``synapse_attention`` launch. The cache is
O(K+W) whatever the stream's length (hybrid density-coverage eviction
graduates window tokens into the landmarks); the example sets its bytes
against a full cache of the same 300 tokens. It runs on the card unless
``--device cpu``; the reduced config unless ``--full`` (36 layers,
d_model 4096: ~16.4 GB of bf16 weights, cast on the card from the f32
weights ``init_params`` draws there from seed 0). It decodes in the
config's compute dtype (bf16) on either device, as the reference's
example does.

:func:`main` returns what it prints: the cache bytes at the start, after
step 1 and after the last step, the full cache's bytes, the landmarks kept
and their positions, whether the last logits are finite, ms per step and,
on the card, ``torch.cuda.memory_allocated`` after step 10 and after the
last step.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.prism import tree_bytes
from repro_torch.device import resolve_device
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as model_lib

B, STEPS = 1, 300
SPEC = model_lib.CacheSpec(kind="synapse", n_landmarks=32, window=32, n_inject=4)
MEMORY_STEP = 10  # device memory is read after this step and after the last


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true", help="the published widths (default: the reduced config)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("qwen3-8b", reduced=not args.full)
    print(f"[long-context] {cfg.name} ({cfg.n_layers}L d={cfg.d_model}, {cfg.compute_dtype}) on {device}")
    # serving-dtype weights; the f32 tree is dropped once cast
    params = model_lib.cast_params(model_lib.init_params(cfg, seed=0, device=device), cfg)
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    caches = model_lib.init_caches(cfg, B, SPEC, device=device)
    syn_bytes = tree_bytes(caches.tensors())
    tokens = torch.randint(0, cfg.vocab_size, (B, STEPS), dtype=torch.int32, device=device,
                           generator=torch.Generator(device=device).manual_seed(1))

    mem = {}
    sync()
    t0 = time.perf_counter()
    for t in range(STEPS):
        pos = torch.full((B,), t, dtype=torch.int32, device=device)
        logits, _, caches = model_lib.decode_step(params, cfg, {"tokens": tokens[:, t], "positions": pos},
                                                  caches, spec=SPEC)
        if t == 0:
            bytes_step1 = tree_bytes(caches.tensors())
        if t + 1 == MEMORY_STEP:
            sync()
            t_mem = time.perf_counter()
            mem["step"] = torch.cuda.memory_allocated(device) if on_card else None
    sync()
    t_end = time.perf_counter()
    mem["last"] = torch.cuda.memory_allocated(device) if on_card else None

    g = caches.groups[0]
    lm_count = int(g.lm_count[0, 0])
    lm_pos = g.lm_pos[0, 0, :lm_count].tolist()
    full_bytes = cache_lib.cache_bytes(cache_lib.init_full_cache(cfg, B, STEPS, device="meta")) * cfg.n_layers
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model, "device": str(device),
        "compute_dtype": cfg.compute_dtype, "steps": STEPS, "spec": dataclasses.asdict(SPEC),
        "weight_bytes": tree_bytes(params),
        "synapse_bytes": syn_bytes, "synapse_bytes_step1": bytes_step1,
        "synapse_bytes_last": tree_bytes(caches.tensors()), "full_cache_bytes": full_bytes,
        "lm_count": lm_count, "lm_pos": lm_pos,
        "length": int(g.length[0, 0]), "logits_finite": bool(torch.isfinite(logits).all()),
        "logits_shape": list(logits.shape),
        "seconds": t_end - t0, "ms_per_step": (t_end - t_mem) / (STEPS - MEMORY_STEP) * 1e3,
        "memory_allocated_step10": mem["step"], "memory_allocated_last": mem["last"],
    }
    print(f"[long-context] decoded {STEPS} tokens with O(K+W) cache")
    print(f"  synapse cache bytes : {syn_bytes / 1e6:.2f} MB (constant in stream length)")
    print(f"  full cache at {STEPS}: {full_bytes / 1e6:.2f} MB (grows linearly)")
    print(f"  landmarks kept      : {lm_count}, positions span [{min(lm_pos)}, {max(lm_pos)}]")
    print(f"  last logits finite  : {out['logits_finite']}")
    print(f"  {out['ms_per_step']:.2f} ms per step after step {MEMORY_STEP}"
          + (f"; memory_allocated {mem['step']} after step {MEMORY_STEP}, {mem['last']} after step {STEPS}"
             if on_card else ""))
    return out


if __name__ == "__main__":
    main()
