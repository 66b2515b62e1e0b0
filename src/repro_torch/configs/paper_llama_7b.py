"""paper-llama-7b — the survey's own comparison family (LLaMa-2-7B-like)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-llama-7b",
    arch_type="dense",
    source="survey Tables 1-3 (LLaMa-2-7B family)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11_008,
    vocab_size=32_000,
    head_dim=128,
)
