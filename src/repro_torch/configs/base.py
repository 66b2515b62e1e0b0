"""Model configuration (counterpart of `repro.configs.base`).

The port serves attention-only decoders over token ids so far
(`arch_type` "dense", or "vlm": early fusion puts the image tokens in
the vocabulary): `get_config` knows the six reference configs of that
kind (`ARCH_IDS`). `dtype` is a torch dtype;
`use_kernels` selects the CUDA kernels (on the card; their plain
versions on the CPU) against the materialize / matmul reference path.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # "dense" | "vlm" (the kinds ported so far)
    source: str                    # citation for the config
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 = full attention
    dtype: Any = torch.bfloat16
    # the fused decode-attention and flash-prefill kernels (True), or the
    # materialize / matmul reference path (False: tests and the on-card
    # kernels-vs-reference comparison only)
    use_kernels: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.arch_type not in ("dense", "vlm"):
            raise NotImplementedError(
                f"arch_type {self.arch_type!r} not yet ported")

    def num_attn_layers(self) -> int:
        return self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        hq = self.num_heads * self.head_dim
        hkv = self.num_kv_heads * self.head_dim
        per_layer = (2 * self.d_model + self.d_model * (hq + 2 * hkv)
                     + hq * self.d_model + 3 * self.d_model * self.d_ff)
        if self.qkv_bias:
            per_layer += hq + 2 * hkv
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        return n + self.num_layers * per_layer + self.d_model

    def active_param_count(self) -> int:
        """Params touched per token: every one (no experts yet)."""
        return self.param_count()

    def kv_bytes_per_token(self, bytes_per_elt: float = 2.0) -> float:
        """KV-cache bytes per token per sequence (the survey's core metric)."""
        return (self.num_layers * 2 * self.num_kv_heads * self.head_dim
                * bytes_per_elt)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same family (<=2 layers, d<=256),
    the same shrink as `repro.configs.base.reduced`."""
    kw: dict[str, Any] = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        num_heads=min(cfg.num_heads, 4),
        num_kv_heads=min(cfg.num_kv_heads, 2),
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=64,
        dtype=torch.float32,
    )
    if cfg.sliding_window:
        kw["sliding_window"] = 64
    kw.update(overrides)
    return cfg.replace(**kw)


# the reference's order (`repro.configs.base.ARCH_IDS`), restricted to
# the configs the port knows
ARCH_IDS = [
    "qwen2.5-32b",
    "minicpm-2b",
    "chameleon-34b",
    "command-r-plus-104b",
    "granite-8b",
    # the survey's own comparison model family
    "paper-llama-7b",
]

_MODULE_FOR: dict[str, str] = {
    "qwen2.5-32b": "qwen2_5_32b",
    "minicpm-2b": "minicpm_2b",
    "chameleon-34b": "chameleon_34b",
    "command-r-plus-104b": "command_r_plus_104b",
    "granite-8b": "granite_8b",
    "paper-llama-7b": "paper_llama_7b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE_FOR:
        raise KeyError(f"arch {arch!r} not ported; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
