"""RWKV6 "Finch" 1.6B [arXiv:2404.05892] — attention-free, data-dep decay."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # = rwkv heads (d_model / head_size)
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    block_kind="rwkv6",
    rwkv_head_size=64,
    rope_kind="none",
)
