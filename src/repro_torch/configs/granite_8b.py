"""granite-8b — llama-arch code model [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    source="arXiv:2405.04324 (Granite Code Models)",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=49_152,
    head_dim=128,
    tie_embeddings=True,
)
