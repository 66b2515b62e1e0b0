"""qwen2.5-32b — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B model-card family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    source="hf:Qwen/Qwen2.5-0.5B (family card); GQA + QKV bias",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27_648,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
