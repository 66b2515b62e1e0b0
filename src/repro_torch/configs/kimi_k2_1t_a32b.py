"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].

Per the assignment table: 61L, d_model 7168, 64 q heads / 8 kv heads,
expert hidden 2048, vocab 163840.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    source="arXiv:2501.kimi2 (Kimi K2, paper-table config)",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163_840,
    head_dim=128,
    moe=MoEConfig(num_experts=384, num_experts_per_tok=8, d_expert=2048),
)
