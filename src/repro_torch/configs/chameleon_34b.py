"""chameleon-34b — early-fusion VLM over VQ image tokens [arXiv:2405.09818].

Early fusion means image patches arrive as *discrete tokens* in the shared
vocab (VQ codebook ids); the VQ-VAE tokenizer is the stubbed modality
frontend (spec carve-out) — the decoder consumes ordinary token ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    source="arXiv:2405.09818 (Chameleon; early fusion, VQ image tokens)",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_016,
    vocab_size=65_536,
    head_dim=128,
    qkv_bias=False,
)
