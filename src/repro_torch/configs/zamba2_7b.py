"""Zamba2-7B-Instruct as published
(https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json,
``transformers``' ``modeling_zamba2``): 81 Mamba2 layers with two groups of
B/C; before the Mamba2 layer at each of 13 depths one of two shared blocks,
alternating, runs on [stream; embeddings] (7,168 wide) with 32 heads of
224, scale (224/2)^-0.5, an exact-GELU GeGLU MLP with a rank-128 adapter
per invocation on gate_up and no residual; its output goes through that
depth's linear into the Mamba2 layer's norm input. Tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=224,
    d_ff=14336,
    vocab_size=32000,
    block_kind="mamba2",
    ssm_state_size=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    ssm_ngroups=2,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    n_shared_blocks=2,
    shared_mlp_lora_rank=128,
    attn_scale=(224 / 2) ** -0.5,
    rope_theta=10_000.0,
    norm_eps=1e-5,
    tie_embeddings=True,
    max_position=4096,
)
