"""minicpm-2b — llama-like arch trained with a WSD schedule [arXiv:2404.06395].

MHA (kv = heads = 36): the GQA-conversion benchmark (L0-Ortho, survey §4)
uses this config as its best case.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    arch_type="dense",
    source="arXiv:2404.06395 (MiniCPM; WSD schedule)",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    head_dim=64,
    tie_embeddings=True,
)
