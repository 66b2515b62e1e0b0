"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE [arXiv:2403.19887].

Superblocks of 8 layers with one attention layer (offset 4); MoE FFN
every second layer (16 experts, top-2). The attention layers are the
only KV carriers.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    source="arXiv:2403.19887 (Jamba)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=65_536,
    head_dim=128,
    attn_layer_period=8,
    attn_layer_offset=4,
    moe=MoEConfig(num_experts=16, num_experts_per_tok=2, d_expert=14_336,
                  layer_period=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1),
)
