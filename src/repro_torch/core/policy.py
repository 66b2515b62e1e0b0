"""(Counterpart of `repro.core.policy`, unchanged: policies are data.)

The composable compression-policy layer — the survey's §7.1 "universal
fusion framework": every surveyed method is expressed as a
`CompressionPolicy` = CacheSpec (what the cache stores / how it evicts)
× budget allocator (how layers split the global budget) × optional
cross-layer sharing. Policies compose: selective ∘ quantization ∘
layer-budgeting is one spec.

`PRESETS` maps the survey's named methods (Tables 1-3) onto this space —
each entry cites the row it reproduces. The benchmark programs iterate
PRESETS to regenerate the tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.cache import CacheSpec


@dataclass(frozen=True)
class CompressionPolicy:
    name: str
    spec: CacheSpec
    allocator: str = "uniform"        # repro_torch.core.budgets.ALLOCATORS
    allocator_kwargs: dict = field(default_factory=dict)
    sharing_layers: int = 0           # KVSharer: #layers reusing another's KV
    citation: str = ""
    family: str = ""                  # selective | quant | attention | hybrid

    def describe(self) -> str:
        s = self.spec
        parts = [f"policy={s.policy}", f"budget={s.budget}",
                 f"bits={s.bits}", f"window={s.window}", f"alloc={self.allocator}"]
        if self.sharing_layers:
            parts.append(f"share={self.sharing_layers}L")
        return f"{self.name} [{self.family}] (" + ", ".join(parts) + ")"


def presets(budget: int, window: int = 128, sinks: int = 4) -> dict[str, CompressionPolicy]:
    """Survey methods instantiated at a given token budget. `budget` is the
    per-layer main-store size; quantized variants round to the group."""
    g = window  # quant flush group == window (cache.py invariant)
    P = CompressionPolicy
    C = CacheSpec
    return {
        # ---- baselines ----------------------------------------------------
        "full": P("full", C(), family="baseline",
                  citation="uncompressed KV cache"),
        # ---- selective (survey §2, Table 1) -------------------------------
        "streaming": P("streaming", C(budget=budget, sinks=sinks,
                                      policy="streaming", window=window,
                                      bits=16, group=window),
                       family="selective",
                       citation="StreamingLLM sinks+window (NACL's local "
                                "component; survey §2)"),
        "h2o": P("h2o", C(budget=budget, sinks=sinks, policy="h2o",
                          window=window, bits=16, group=window,
                          recent_protect=window),
                 family="selective", citation="H2O heavy-hitter oracle [21]"),
        "nacl": P("nacl", C(budget=budget, sinks=sinks, policy="nacl",
                            window=window, bits=16, group=window,
                            recent_protect=window, nacl_temperature=0.02),
                  family="selective",
                  citation="NACL proxy+random eviction [14]"),
        "keyformer": P("keyformer", C(budget=budget, sinks=sinks,
                                      policy="keyformer", window=window,
                                      bits=16, group=window,
                                      recent_protect=window,
                                      keyformer_tau=2.0),
                       family="selective",
                       citation="Keyformer gumbel scoring [22]"),
        "kvsharer": P("kvsharer", C(), sharing_layers=0,  # set per model
                      family="selective", citation="KVSharer [10]"),
        # ---- quantization (survey §3, Table 2) ----------------------------
        "kivi2": P("kivi2", C(budget=budget, window=window, bits=2, group=g,
                              policy="streaming", sinks=sinks),
                   family="quant", citation="KIVI 2-bit K-chan/V-tok [17]"),
        "kivi4": P("kivi4", C(budget=budget, window=window, bits=4, group=g,
                              policy="streaming", sinks=sinks),
                   family="quant", citation="KVQuant-style 4-bit [15]"),
        "int8": P("int8", C(budget=budget, window=window, bits=8, group=g,
                            policy="streaming", sinks=sinks),
                  family="quant", citation="AlignedKV-style 8-bit [18]"),
        # ---- attention / layer-budget (survey §4, Table 3) ----------------
        "pyramid": P("pyramid", C(budget=budget, sinks=sinks, policy="h2o",
                                  window=window, bits=16, group=window,
                                  recent_protect=window),
                     allocator="pyramid", family="attention",
                     citation="PyramidInfer decaying layer budgets [25]"),
        "squeeze": P("squeeze", C(budget=budget, sinks=sinks, policy="h2o",
                                  window=window, bits=16, group=window,
                                  recent_protect=window),
                     allocator="squeeze", family="attention",
                     citation="SqueezeAttention cosine budgets [24]"),
        "zigzag": P("zigzag", C(budget=budget, sinks=sinks, policy="h2o",
                                window=window, bits=16, group=window,
                                recent_protect=window),
                    allocator="zigzag", family="attention",
                    citation="ZigZagKV uncertainty budgets [6]"),
        # ---- hybrid (survey §5) -------------------------------------------
        "h2o+kivi2": P("h2o+kivi2", C(budget=budget, window=window, bits=2,
                                      group=g, policy="h2o", sinks=sinks,
                                      recent_protect=window),
                       family="hybrid",
                       citation="survey §7.1 fusion: selective ∘ quant"),
        "pyramid+kivi4": P("pyramid+kivi4", C(budget=budget, window=window,
                                              bits=4, group=g, policy="h2o",
                                              sinks=sinks,
                                              recent_protect=window),
                           allocator="pyramid", family="hybrid",
                           citation="layer budgets ∘ quant (GEAR-adjacent)"),
    }
