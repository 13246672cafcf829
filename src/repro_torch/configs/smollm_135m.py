"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small dense."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    arch_type="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
