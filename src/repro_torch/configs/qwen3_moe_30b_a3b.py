"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128 experts, top-8, GQA kv=4."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,            # per-expert intermediate size
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    experts_per_token=8,
)
