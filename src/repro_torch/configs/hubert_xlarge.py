"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only audio transformer.

The conv/mel frontend is stubbed: callers pass frame embeddings
(``{"embeds": [B, S, d_model]}``). vocab=504 is the k-means target
codebook (masked-prediction training). Encoder-only: a forward, no
prefill, decode or engine.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    rope_kind="none",
    embed_inputs=False,
)
