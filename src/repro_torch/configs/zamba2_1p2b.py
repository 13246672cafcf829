"""Zamba2-1.2B [arXiv:2411.15242] — Mamba2 backbone + shared attention block.

The shared transformer block (applied every 6 mamba layers, per-invocation
LoRA on qkv) is itself an instance of singleton weight sharing.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,       # MHA in the shared block
    d_head=64,
    d_ff=8192,
    vocab_size=32000,
    block_kind="mamba2",
    ssm_state_size=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
    shared_attn_lora_rank=128,
    rope_theta=10_000.0,
)
