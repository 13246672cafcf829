"""Qwen2-VL-72B [arXiv:2409.12191] — M-RoPE decoder; vision frontend stubbed.

Callers may feed precomputed patch+text embeddings (``{"embeds": ...}``)
with [B, 3, S] positions; the decoder still owns the embedding table and
lm head for text decode.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab_size=152064,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    embed_inputs=False,
)
