"""kvlint for the PyTorch port: repo-native static analysis of
`repro_torch` (the counterpart of `repro.analysis`).

JAX's kvlint states its contracts for JAX: its ``host-sync`` rule knows
``jax.device_get`` and ``jnp.*`` producers, and its ``jit-*`` and
``pallas-*`` rules have nothing to match in a package with no
``jax.jit`` and no ``pallas_call``. This package states the same
contracts for eager PyTorch and the CUDA wrappers:

  * ``release-seam``   — `BlockAllocator.free/incref/decref` only from
    the ownership seam (`Scheduler.release` + allowlisted modules).
  * ``host-sync``      — PyTorch syncs (``.item()``, ``.cpu()``,
    ``torch.cuda.synchronize()``, ``int(t.sum())``, ``if t.any():``
    ...) inside the engine's per-step decode / verify loops carry a
    reasoned annotation placing them in the pipeline.
  * ``step-sync`` / ``step-copy`` — the per-step functions (the engine's
    `_prefill` / `_decode` / `_verify` / `_insert` / `_reset` and what
    they reach): no sync anywhere in their bodies (one is a branch on a
    traced value in JAX, and breaks a CUDA-graph capture here), no whole
    copy of a cache store (JAX's missing donation); the counterparts of
    ``jit-branch`` and ``jit-donate``.
  * ``launch-arity`` / ``launch-checked`` / ``launch-flag`` — the CUDA
    launches: a `CudaKernel` declaration's argtypes match its
    ``extern "C"`` entry point and every counted call, each tensor whose
    pointer reaches a launch was checked or explicitly allocated, and
    ``use_kernels=`` is threaded, never a literal (the counterparts of
    ``pallas-grid`` / ``pallas-blockspec``, ``pallas-outshape`` and
    ``pallas-interpret``).
  * ``duck-parity``    — `LayerKV` / `PagedLayerKV` agree on the shared
    metadata names the policies dispatch on.
  * ``dead-module``    — modules reachable from no entry point are
    reported; `# kvlint: dormant(<reason>)` downgrades to an
    informational "dormant" note.
  * ``unused-import`` / ``mutable-default`` — generic hygiene.

``jit-capture`` has no counterpart: eager PyTorch traces nothing, so a
closure reads its variables' current values at each call.

Stdlib-only (`ast` + `tokenize` + `re`): importable and runnable with
neither torch nor JAX present.

Run:  ``python -m repro_torch.analysis [--check] [--json] PATHS...``
Suppress: ``# kvlint: ok(<rule>: <reason>)`` — the reason is required;
a bare ``ok(rule)`` is itself a finding.
"""
from __future__ import annotations

from repro_torch.analysis.config import Config, default_config
from repro_torch.analysis.driver import Analyzer, analyze_paths, analyze_source
from repro_torch.analysis.model import Finding, SourceFile

__all__ = [
    "Analyzer",
    "Config",
    "Finding",
    "SourceFile",
    "analyze_paths",
    "analyze_source",
    "default_config",
]
