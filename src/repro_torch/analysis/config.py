"""kvlint rule configuration for the PyTorch port (counterpart of
`repro.analysis.config`).

Everything port-specific lives here — the seam allowlist, the hot-loop
scopes, the per-step function scopes, the duck-typed class pairs, the
kernel wrappers' checkers, the dynamic-import escape hatches — so the
rules themselves stay mechanical and the fixture tests can run them
against synthetic configs.

Path entries match by *suffix component*: ``serving/scheduler.py``
matches any analyzed path ending with those components, so the config
is independent of where the repo is checked out.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Set, Tuple


@dataclass(frozen=True)
class DuckClass:
    """One side of a duck-typed pair: NamedTuple fields minus the
    store-specific ones must equal the partner's."""
    path: str            # suffix, e.g. "core/cache.py"
    class_name: str
    store_fields: Tuple[str, ...]


_MODEL_STEP = {"prefill", "decode_step", "verify_step", "_logits",
               "_layer", "_cross_memory"}
_BLOCK_STEP = {"block_prefill", "block_decode", "block_verify", "_ffn",
               "_ffn_aux", "_cross_attend", "cross_kv"}
_ATTN_STEP = {"qkv", "decode_attention", "_decode_attention",
              "verify_attention", "gqa_attention", "_gqa_attention",
              "_attend_block", "_fold_mass", "_kernel_supported"}
_CACHE_STEP = {"validity_bias", "materialize", "materialize_kv", "gumbel",
               "policy_noise", "_evictable_mask", "select_victim",
               "insert_request", "reset_slot", "insert_request_tree",
               "reset_slot_tree", "_put_rows", "_advance",
               "append_token_dense", "quantize_kv", "plan_group_flush",
               "flush_need", "ring_append", "append_token_quantized",
               "append_token", "append_segment", "accumulate_scores",
               "compress_prompt"}
_PAGING_STEP = {"gather_dense", "_phys_rows", "_scatter_rows",
                "append_token_paged", "_append_quantized_paged",
                "insert_request_paged", "reset_slot_paged"}


@dataclass
class Config:
    # --- release-seam -----------------------------------------------------
    # BlockAllocator ownership methods: callable only from the seam.
    seam_methods: Set[str] = field(
        default_factory=lambda: {"free", "incref", "decref"})
    # receiver expression must mention this substring to count as an
    # allocator call (`self.allocator`, `eng.block_allocator`, ...)
    seam_receiver_hint: str = "allocator"
    # (path suffix, qualname) pairs; qualname "*" allows the whole file,
    # a trailing "/" in the path allows a whole directory
    seam_allowlist: List[Tuple[str, str]] = field(default_factory=lambda: [
        ("serving/scheduler.py", "Scheduler.release"),
        # adopt_blocks takes the prefix index's reference on behalf of a
        # slot — the one legal incref outside prefix.py
        ("serving/scheduler.py", "Scheduler.adopt_blocks"),
        ("core/paging.py", "*"),      # the allocator's own module
        ("serving/prefix.py", "*"),   # index ingest/evict/disown refs
        # unit tests construct throwaway allocators and poke the
        # refcount API directly on purpose
        ("tests/", "*"),
    ])

    # --- host-sync --------------------------------------------------------
    # file suffix -> function qualnames whose loop bodies are the
    # per-step decode/verify hot path (nested defs inherit the scope)
    hot_functions: Dict[str, Set[str]] = field(default_factory=lambda: {
        "serving/engine.py": {"Engine.generate",
                              "Engine.generate_continuous"},
        "serving/speculative.py": {"generate_continuous_spec"},
    })
    # the engine's per-step handles (`Engine._decode`, `_verify`,
    # `_prefill`): a call `obj.<handle>(...)` produces device tensors.
    # `_h2d*` send host arrays to the device (never a sync themselves)
    device_handles: Set[str] = field(default_factory=lambda: {
        "_decode", "_verify", "_prefill", "_h2d", "_h2d_ids"})
    # numpy module aliases whose asarray/array of a tensor fetch it
    host_numpy_roots: Set[str] = field(default_factory=lambda: {"np",
                                                                "numpy"})
    # obs emit calls (repro_torch.obs Tracer sites) whose arguments must
    # be host values; the receiver must mention the hint substring
    obs_emit_methods: Set[str] = field(default_factory=lambda: {
        "instant", "complete", "counter", "span"})
    obs_emit_receiver_hint: str = "trace"

    # --- step-sync / step-copy --------------------------------------------
    # file suffix -> qualnames of the per-step functions (the engine's
    # handles and the functions they reach; "*" = every function of the
    # file). Nested defs inherit the scope.
    step_functions: Dict[str, Set[str]] = field(default_factory=lambda: {
        "serving/engine.py": {"Engine._prefill", "Engine._decode",
                              "Engine._step", "Engine._verify",
                              "Engine._insert", "Engine._reset"},
        "serving/step_graph.py": {"StepGraphs.ready", "StepGraphs.replay"},
        "nn/model.py": set(_MODEL_STEP),
        "nn/blocks.py": set(_BLOCK_STEP),
        "nn/attention.py": set(_ATTN_STEP),
        "core/cache.py": set(_CACHE_STEP),
        "core/paging.py": set(_PAGING_STEP),
        "kernels/decode_qattn/ops.py": {"*"},
        "kernels/flash_prefill/ops.py": {"*"},
        "kernels/kvquant/ops.py": {"*"},
    })
    # parameter names that hold a cache (dense or paged layer store, the
    # model cache, a stacked store) in the step functions
    cache_param_names: Set[str] = field(default_factory=lambda: {
        "cache", "lc", "p", "stacked", "c", "pc", "dcache", "draft_cache"})
    # a cache's store leaves: a whole copy of one holds a second copy of
    # the store's bytes for the step (metadata leaves are left out)
    store_leaves: Set[str] = field(default_factory=lambda: {
        "k", "v", "k_scale", "k_zero", "v_scale", "v_zero", "rk", "rv",
        "pk", "pv", "pk_scale", "pk_zero", "pv_scale", "pv_zero"})

    # --- launch contracts -------------------------------------------------
    # files whose `CudaKernel(...)` declarations and launches are checked
    launch_files: Tuple[str, ...] = ("kernels/decode_qattn/ops.py",
                                     "kernels/flash_prefill/ops.py",
                                     "kernels/kvquant/ops.py")
    # the classes of a kernel's and of its source's declarations
    kernel_class: str = "CudaKernel"
    source_class: str = "CudaSource"
    # calls that check a tensor before its pointer goes to a kernel
    # (a name passed to them, or bound from them, is checked)
    launch_checkers: Set[str] = field(default_factory=lambda: {
        "_check", "_check_q", "_aligned", "contiguous"})
    # module-level scratch buffers: `DeviceScratch(dtype)` allocates per
    # device with its dtype fixed at construction
    launch_scratch_classes: Set[str] = field(default_factory=lambda: {
        "DeviceScratch"})
    # `use_kernels=` is threaded, never a literal, in files under these
    # path components (tests are outside)
    launch_flag_scope: Tuple[str, ...] = ("src/",)
    # CUDA source texts by path suffix, read in place of the file on disk
    # (fixtures); a source not listed here is read from disk
    cuda_sources: Dict[str, str] = field(default_factory=dict)

    # --- duck-type parity -------------------------------------------------
    duck_pairs: List[Tuple[DuckClass, DuckClass]] = field(
        default_factory=lambda: [(
            DuckClass("core/cache.py", "LayerKV",
                      ("k", "v", "k_scale", "k_zero", "v_scale", "v_zero")),
            DuckClass("core/paging.py", "PagedLayerKV",
                      ("pk", "pv", "pk_scale", "pk_zero", "pv_scale",
                       "pv_zero", "block_tbl")),
        )])

    # --- dead/dormant inventory -------------------------------------------
    # first path components that count as entry points (reachability
    # roots); a file at the repo root (chip_smoke.py) is one too
    entry_point_dirs: Tuple[str, ...] = ("tests", "benchmarks", "examples")
    # the launchers and the linter's own `python -m` entry point
    entry_point_packages: Tuple[str, ...] = ("repro_torch.launch",
                                             "repro_torch.analysis")
    # modules loaded dynamically (configs/base.py:get_config imports the
    # arch's module by name) — assumed reachable
    dynamic_module_prefixes: Tuple[str, ...] = ("repro_torch.configs.",)

    # --- unused-import ----------------------------------------------------
    # __init__.py imports are the package's export surface
    unused_import_skip_init: bool = True

    def clone(self, **overrides) -> "Config":
        return replace(self, **overrides)


def default_config() -> Config:
    return Config()


def path_matches(path: str, suffix: str) -> bool:
    """Component-wise suffix match; `suffix` ending in "/" matches any
    file under that directory."""
    norm = path.replace("\\", "/")
    if suffix.endswith("/"):
        return ("/" + suffix) in ("/" + norm) or norm.startswith(suffix)
    return norm == suffix or norm.endswith("/" + suffix)


def qualname_matches(qualname: str, pattern: str) -> bool:
    if pattern == "*":
        return True
    return qualname == pattern or qualname.startswith(pattern + ".")


def scoped_quals(path: str, table: Dict[str, Set[str]]) -> Set[str]:
    """The qualname patterns `table` configures for the file at `path`."""
    for suffix, quals in table.items():
        if path_matches(path, suffix):
            return quals
    return set()
