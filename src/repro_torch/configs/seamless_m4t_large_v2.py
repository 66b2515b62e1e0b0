"""seamless-m4t-large-v2 — encoder-decoder, multimodal [arXiv:2308.11596].

The speech frontend (mel-spectrogram + conv feature extractor) is the
stubbed modality frontend: callers provide precomputed frame embeddings
[B, T_src, d_model]; the port implements the transformer encoder and
the text decoder that consume them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    source="arXiv:2308.11596 (SeamlessM4T v2)",
    num_layers=24,            # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    head_dim=64,
    is_encoder_decoder=True,
    num_encoder_layers=24,
    input_kind="embeds",
)
