"""Model configuration (counterpart of `repro.configs.base`).

The port serves decoders over token ids (`arch_type` "dense"; "vlm":
early fusion puts the image tokens in the vocabulary; "moe": a
mixture-of-experts FFN, `MoEConfig`; "ssm": Mamba-2 mixers only, no
attention; "hybrid": one attention layer per `attn_layer_period` layers,
Mamba-2 mixers between, `SSMConfig`) and the encoder-decoder ("audio": a
bidirectional encoder over stubbed frame embeddings, `input_kind`
"embeds", and a decoder that cross-attends its output): `get_config`
knows all eleven reference configs (`ARCH_IDS`). `dtype` is a torch
dtype; `use_kernels` selects the CUDA kernels (on the card; their plain
versions on the CPU) against the materialize / matmul reference path;
`remat` "block" recomputes each superblock's and encoder layer's
activations in the backward pass (training only).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Any

import torch

# the arch kinds a config may name (all of the reference's)
KNOWN_ARCH_TYPES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_experts_per_tok: int = 0
    d_expert: int = 0              # hidden dim of each expert MLP
    layer_period: int = 1          # every Nth layer is MoE (jamba: 2)
    router_aux_coef: float = 0.01  # load-balance aux loss
    router_z_coef: float = 1e-3
    capacity_factor: float = 1.25  # expert capacity (E == drop-free)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 1e-3
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | vlm | moe | ssm | hybrid | audio
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
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hybrid interleave: 1 attention layer per `attn_layer_period` layers,
    # at offset `attn_layer_offset`; the rest are SSM mixers. 0 = attention
    # everywhere (or SSM everywhere for arch_type == "ssm").
    attn_layer_period: int = 0
    attn_layer_offset: int = 0
    # encoder/decoder (audio): encoder is bidirectional over frame embeddings
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    # what the model consumes: "tokens" (int ids) or "embeds" (stubbed
    # modality frontend producing [B, T, d_model] features)
    input_kind: str = "tokens"
    dtype: Any = torch.bfloat16
    # activation remat policy for training: "none" | "block"
    remat: str = "block"
    # the fused decode-attention and flash-prefill kernels (True), or the
    # materialize / matmul reference path (False: tests and the on-card
    # kernels-vs-reference comparison only)
    use_kernels: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.arch_type not in KNOWN_ARCH_TYPES:
            raise NotImplementedError(
                f"unknown arch_type {self.arch_type!r}; known: "
                f"{', '.join(KNOWN_ARCH_TYPES)}")

    # ---- derived ---------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.moe.num_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim

    def layer_kind(self, idx: int) -> str:
        """Mixer kind of layer `idx`: "attn" or "ssm"."""
        if self.arch_type == "ssm":
            return "ssm"
        if self.attn_layer_period > 0:
            return ("attn" if idx % self.attn_layer_period
                    == self.attn_layer_offset else "ssm")
        return "attn"

    def ffn_kind(self, idx: int) -> str:
        """FFN kind of layer `idx`: "moe" or "dense". Layer period counts
        from 1 like Jamba (odd layers MoE when period==2)."""
        if self.is_moe and idx % self.moe.layer_period == (
                self.moe.layer_period - 1):
            return "moe"
        return "dense"

    def num_attn_layers(self) -> int:
        return sum(1 for i in range(self.num_layers)
                   if self.layer_kind(i) == "attn")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        hq = self.num_heads * self.head_dim
        hkv = self.num_kv_heads * self.head_dim
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        G, N, H = self.ssm.n_groups, self.ssm.d_state, self.ssm_heads
        d_in = self.d_inner
        for i in range(self.num_layers):
            n += 2 * self.d_model                                # norms
            if self.layer_kind(i) == "attn":
                n += self.d_model * (hq + 2 * hkv) + hq * self.d_model
                if self.qkv_bias:
                    n += hq + 2 * hkv
            else:
                n += self.d_model * (2 * d_in + 2 * G * N + H)   # in proj
                n += (d_in + 2 * G * N) * self.ssm.d_conv        # conv
                n += 3 * H                                       # A, D, dt_bias
                n += d_in * self.d_model                         # out proj
                n += d_in                                        # gated norm
            if self.ffn_kind(i) == "moe":
                e = self.moe
                n += e.num_experts * 3 * self.d_model * e.d_expert
                n += self.d_model * e.num_experts                # router
            else:
                n += 3 * self.d_model * self.d_ff                # swiglu
        if self.is_encoder_decoder:
            # encoder blocks + decoder cross-attention
            enc = self.num_encoder_layers * (
                4 * self.d_model * hq + 3 * self.d_model * self.d_ff
                + 2 * self.d_model)
            xattn = self.num_layers * (self.d_model * (hq + 2 * hkv)
                                       + hq * self.d_model + self.d_model)
            n += enc + xattn
        return n + self.d_model                                  # final norm

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k instead of all experts)."""
        n = self.param_count()
        if not self.is_moe:
            return n
        e = self.moe
        n_moe_layers = sum(1 for i in range(self.num_layers)
                           if self.ffn_kind(i) == "moe")
        inactive = e.num_experts - e.num_experts_per_tok
        return n - n_moe_layers * inactive * 3 * self.d_model * e.d_expert

    def kv_bytes_per_token(self, bytes_per_elt: float = 2.0) -> float:
        """KV-cache bytes per token per sequence (the survey's core
        metric): attention layers only, an SSM layer's state is constant
        in sequence length."""
        return (self.num_attn_layers() * 2 * self.num_kv_heads
                * self.head_dim * bytes_per_elt)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same family (<=2 layers, d<=256),
    the same shrink as `repro.configs.base.reduced` (2 encoder layers for
    an encoder-decoder, no remat)."""
    kw: dict[str, Any] = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        num_heads=min(cfg.num_heads, 4),
        num_kv_heads=min(cfg.num_kv_heads, 2),
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=64,
        dtype=torch.float32,
        remat="none",
    )
    if cfg.is_moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            num_experts_per_tok=min(cfg.moe.num_experts_per_tok, 2),
            d_expert=min(cfg.moe.d_expert, 256),
            capacity_factor=float(min(cfg.moe.num_experts, 4)),  # drop-free
        )
    if cfg.arch_type in ("ssm", "hybrid"):
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=min(cfg.ssm.d_state, 32), head_dim=32,
            chunk_size=32)
    if cfg.attn_layer_period > 0:
        kw["attn_layer_period"] = 2
        kw["attn_layer_offset"] = 1
    if cfg.is_encoder_decoder:
        kw["num_encoder_layers"] = 2
    if cfg.sliding_window:
        kw["sliding_window"] = 64
    kw.update(overrides)
    return cfg.replace(**kw)


# ---------------------------------------------------------------------------
# Input shapes: the four workload shapes the dry run lowers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# the reference's order (`repro.configs.base.ARCH_IDS`)
ARCH_IDS = [
    "mamba2-130m",
    "mixtral-8x22b",
    "qwen2.5-32b",
    "minicpm-2b",
    "chameleon-34b",
    "command-r-plus-104b",
    "seamless-m4t-large-v2",
    "jamba-v0.1-52b",
    "kimi-k2-1t-a32b",
    "granite-8b",
    # the survey's own comparison model family
    "paper-llama-7b",
]

_MODULE_FOR: dict[str, str] = {
    "mamba2-130m": "mamba2_130m",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen2.5-32b": "qwen2_5_32b",
    "minicpm-2b": "minicpm_2b",
    "chameleon-34b": "chameleon_34b",
    "command-r-plus-104b": "command_r_plus_104b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-8b": "granite_8b",
    "paper-llama-7b": "paper_llama_7b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
