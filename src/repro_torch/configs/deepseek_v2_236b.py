"""DeepSeek-V2 236B [arXiv:2405.04434] — MLA (kv_lora=512) + 2 shared/160
routed experts top-6; first layer dense."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,           # per-expert intermediate size
    vocab_size=102400,
    attn_kind="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    n_experts=160,
    n_shared_experts=2,
    experts_per_token=6,
    first_k_dense=1,
    dense_d_ff=12288,
)
