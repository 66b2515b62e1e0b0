"""The per-step functions' contracts: no sync, no whole copy of the cache.

In JAX the engine's per-step functions are jitted (`jax.jit` of
prefill / decode / verify / insert / reset in the JAX engine), so a
Python branch on a traced value fails at trace time (``jit-branch``)
and a cache argument without donation doubles the cache for the step
(``jit-donate``). The port runs the same functions eagerly: a branch on
a tensor is a silent device→host sync that also breaks a CUDA-graph
capture of the step, and a whole copy of a cache store is the missing
donation. The per-step functions are configured by name
(`Config.step_functions`: `Engine._prefill`, `_decode`, `_verify`,
`_insert`, `_reset`, and the model, block, attention, cache and paging
functions they reach, and the kernel wrappers).

  * ``step-sync`` — `rules_sync`'s detector over each step function's
    whole body (not only its loops): ``.item()``, ``.cpu()``,
    ``bool(need.any())``, ``if t.any():`` ... Each intended one carries
    ``# kvlint: ok(step-sync: <where it sits and why>)``.
  * ``step-copy`` — a whole copy of a cache argument's store leaf
    (`Config.store_leaves`: K / V codes or values, their scales and
    zeros, the ring, the pools) in a step function: ``.clone()`` of the
    leaf, or ``torch.cat`` / ``torch.stack`` with the leaf among its
    operands. The leaf is an attribute of a parameter named as a cache
    (`Config.cache_param_names`: ``lc``, ``p``, ``cache``, ...), taken
    whole (not indexed, narrowed or sliced) or through a dtype
    conversion (``lc.rk.to(dtype)``). Checked on the port's code, the
    rule counts the copy whether it is bound back into the cache
    (``lc._replace(k=torch.cat(...))``: the store grows a second copy)
    or held beside it for the step (a materialized [main | ring] view):
    either way the step holds the store's bytes twice. Intended ones
    carry ``# kvlint: ok(step-copy: <why>)``.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.config import (Config, qualname_matches,
                                        scoped_quals)
from repro_torch.analysis.model import (Finding, QualnameVisitor,
                                       SourceFile, dotted_name)
from repro_torch.analysis.rules_sync import ScopedSyncVisitor

RULE_SYNC = "step-sync"
RULE_COPY = "step-copy"

_CONVERSIONS = {"to", "float", "half", "bfloat16", "contiguous"}


def check_step_sync(sf: SourceFile, cfg: Config) -> List[Finding]:
    quals = scoped_quals(sf.path, cfg.step_functions)
    if not quals:
        return []
    v = ScopedSyncVisitor(sf, cfg, quals, RULE_SYNC, loops_only=False)
    v.visit(sf.tree)
    return v.findings("{what} in per-step function {scope!r} syncs the "
                      "host with the card on every step and breaks a "
                      "CUDA-graph capture of it; annotate where it sits "
                      "and why, or move it to the host loop")


class _CopyVisitor(QualnameVisitor):
    def __init__(self, sf: SourceFile, cfg: Config, quals: Set[str]) -> None:
        super().__init__()
        self.sf = sf
        self.cfg = cfg
        self.quals = quals
        self.params: List[Set[str]] = []   # cache params of entered scopes
        self.findings: List[Finding] = []

    def _visit_fn(self, node) -> None:
        self.stack.append(node.name)
        qn = self.qualname()
        entering = not self.params and any(
            qualname_matches(qn, q) for q in self.quals)
        if entering:
            a = node.args
            names = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
            self.params.append(names & self.cfg.cache_param_names)
        try:
            self.generic_visit(node)
        finally:
            if entering:
                self.params.pop()
            self.stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _leaf(self, node: ast.AST) -> Optional[str]:
        """`cache.leaf` taken whole (possibly converted), or None."""
        while isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _CONVERSIONS:
            node = node.func.value
        if isinstance(node, ast.Attribute) \
                and node.attr in self.cfg.store_leaves \
                and isinstance(node.value, ast.Name) \
                and node.value.id in self.params[-1]:
            return "%s.%s" % (node.value.id, node.attr)
        return None

    def visit_Call(self, node: ast.Call) -> None:
        if self.params and self.params[-1]:
            what = None
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr == "clone":
                leaf = self._leaf(func.value)
                if leaf:
                    what = "%s.clone()" % leaf
            elif dotted_name(func) in ("torch.cat", "torch.stack") \
                    and node.args \
                    and isinstance(node.args[0], (ast.List, ast.Tuple)):
                for e in node.args[0].elts:
                    leaf = self._leaf(e)
                    if leaf:
                        what = "%s over %s" % (dotted_name(func), leaf)
                        break
            if what:
                self.findings.append(Finding(
                    rule=RULE_COPY, path=self.sf.path, line=node.lineno,
                    message="%s in per-step function %r copies a whole "
                            "cache store: the step holds its bytes twice "
                            "(JAX's missing donation); update in place or "
                            "annotate why" % (what, self.qualname())))
        self.generic_visit(node)


def check_step_copy(sf: SourceFile, cfg: Config) -> List[Finding]:
    quals = scoped_quals(sf.path, cfg.step_functions)
    if not quals:
        return []
    v = _CopyVisitor(sf, cfg, quals)
    v.visit(sf.tree)
    return v.findings
