"""Workload specs for the dry run (counterpart of `repro.launch.specs`):
which step each (arch x input shape) runs, its inputs as meta tensors
(the stand-ins of `jax.ShapeDtypeStruct`), and their partition specs.

Decode shapes run `decode_step` (one token against a seq_len cache);
long_500k uses the survey's bounded-budget compressed cache for dense
archs and shards the cache *length* over the "data" axis, because the
batch is 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.cache import CacheSpec
from repro_torch.nn import model as M
from repro_torch.nn import sharding as shd

# long-context serving policy for archs without native sub-quadratic
# attention: StreamingLLM-style bounded budget (the paper's technique)
LONG_CONTEXT_BUDGET = 8192
LONG_CONTEXT_WINDOW = 128


@dataclass
class Workload:
    kind: str                  # train | prefill | decode
    args: tuple                # meta tensors / trees, in step-fn order
    in_specs: tuple            # matching spec trees
    cache_spec: Optional[CacheSpec] = None   # decode only
    note: str = ""


def src_len_for(cfg: ModelConfig, seq: int) -> int:
    return max(seq // 4, 16) if cfg.is_encoder_decoder else 0


def decode_cache_spec(cfg: ModelConfig, shape: InputShape,
                      opts: frozenset = frozenset()) -> CacheSpec:
    """The cache policy each (arch, shape) uses at decode."""
    bits = 4 if "kivi4_cache" in opts else 2 if "kivi2_cache" in opts else 16
    if bits < 16:
        # the quantization family on top of the serving layout: the whole
        # context at 2/4 bits (KIVI layout), fp window 128
        budget = (shape.seq_len // 128) * 128
        return CacheSpec(budget=budget, window=128, group=128, bits=bits,
                         policy="streaming", sinks=4)
    if shape.name == "long_500k" and cfg.num_attn_layers() > 0:
        if cfg.sliding_window:        # mixtral: native SWA bounds the cache
            return CacheSpec(budget=cfg.sliding_window, policy="streaming",
                             window=0, sinks=4)
        if cfg.arch_type == "hybrid":  # jamba: 4 attn layers keep full 500k
            return CacheSpec(budget=shape.seq_len, policy="none")
        # dense / vlm / audio: a bounded budget makes 500k decode feasible
        return CacheSpec(budget=LONG_CONTEXT_BUDGET,
                         window=LONG_CONTEXT_WINDOW, sinks=4,
                         policy="streaming", group=LONG_CONTEXT_WINDOW,
                         recent_protect=LONG_CONTEXT_WINDOW)
    return CacheSpec(budget=shape.seq_len, policy="none")  # full baseline


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh,
                opts: frozenset = frozenset()) -> Workload:
    """The Workload of one (arch x input shape). `opts` are the sharding
    options (see `nn.sharding.activation_sharding`)."""
    B, S = shape.global_batch, shape.seq_len
    fsdp, tp = shd.mesh_axes(mesh)
    dp = fsdp
    if "pure_fsdp" in opts:   # ZeRO-3: batch over every mesh axis
        dp = tuple(fsdp) + ((tp,) if isinstance(tp, str) else tuple(tp))
    f32, i32 = torch.float32, torch.int32

    if shape.kind in ("train", "prefill"):
        args: dict[str, Any] = {"tokens": _meta((B, S), i32)}
        specs: dict[str, Any] = {"tokens": (dp, None)}
        if cfg.is_encoder_decoder:
            sl = src_len_for(cfg, S)
            args["src_embeds"] = _meta((B, sl, cfg.d_model), f32)
            specs["src_embeds"] = (dp, None, None)
        return Workload(shape.kind, (args,), (specs,))

    # ---- decode ----------------------------------------------------------
    spec = decode_cache_spec(cfg, shape, opts)
    shard_seq = shape.name == "long_500k"   # batch 1: shard cache length
    cache = M.init_cache(cfg, spec, B, S, src_len=src_len_for(cfg, S),
                         device="meta")
    cache_specs = shd.cache_pspecs(cache, mesh, shard_seq=shard_seq,
                                   seq_tp="seq_tp_cache" in opts,
                                   dp_only="cache_dp_only" in opts)
    tok = _meta((B, 1), i32)
    tok_spec = (None if shard_seq else dp, None)
    return Workload("decode", (cache, tok), (cache_specs, tok_spec),
                    cache_spec=spec,
                    note=f"budget={spec.budget} policy={spec.policy} "
                         f"bits={spec.bits} shard_seq={shard_seq}")
