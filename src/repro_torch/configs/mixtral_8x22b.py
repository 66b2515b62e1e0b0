"""mixtral-8x22b — 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    source="arXiv:2401.04088 (Mixtral of Experts)",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32_768,
    head_dim=128,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, num_experts_per_tok=2, d_expert=16384),
)
