"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060].

Attention-free: the KV cache degenerates to a constant-size SSM state
(`core.cache.SSMState`); int8 state quantization
(`core.quantization.quantize_ssm_state`) is the closest analogue of the
survey's techniques. The serving engine needs an attention layer and
refuses this config; `nn.model.prefill` / `decode_step` serve it.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
    num_layers=24,
    d_model=768,
    num_heads=24,        # SSD heads: d_inner(1536)/head_dim(64)
    num_kv_heads=24,
    d_ff=0,              # no MLP in mamba2 blocks
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    tie_embeddings=True,
)
