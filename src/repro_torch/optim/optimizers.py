"""Optimizers as plain functions over parameter trees (counterpart of
`repro.optim.optimizers`; nested dicts of tensors, the `nn.model` tree,
leaves in sorted-key order as JAX orders them).

AdamW with decoupled weight decay; moments stored in f32 whatever the
param dtype (the mixed-precision convention), bias-corrected, decay on
leaves of two or more dims only (no decay on norms and biases), updates
applied in f32 and cast back. `torch.optim.AdamW` keeps its moments in
the param dtype and decays every leaf, so it computes something else.
The step count, bias corrections and learning rate are 0-dim tensors on
the params' device: a step needs no host sync.

`adamw` / `apply_updates` / `clip_by_global_norm` are JAX's functional
API. `adamw_step_` computes the same numbers leaf by leaf in place, for
a training step that holds one copy of the state: the functional path
holds the old and new moments, the f32 gradients and the f32 updates at
once (a 2.7 B-param model would need ~70 GB for them).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class AdamState(NamedTuple):
    step: torch.Tensor   # 0-dim int32
    mu: Any              # first moment, f32, the params' tree
    nu: Any              # second moment, f32


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` (nested dicts; keys in sorted order,
    the JAX leaf order) and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _slots(tree) -> list:
    """(dict, key) of every leaf of a nested dict, in sorted-key order."""
    return [s for k in sorted(tree) for s in
            (_slots(tree[k]) if isinstance(tree[k], dict) else [(tree, k)])]


def _corrections(step: torch.Tensor, b1: float, b2: float):
    t = step.float()
    return 1.0 - b1 ** t, 1.0 - b2 ** t


def _adamw_leaf(g, m, n, p, c1, c2, lr, b1, b2, eps, weight_decay):
    """One leaf: f32 grad `g`, moments `m`, `n` -> (update, m, n)."""
    m = b1 * m + (1 - b1) * g
    n = b2 * n + (1 - b2) * g.square()
    u = (m / c1) / ((n / c2).sqrt() + eps)
    if weight_decay and p.dim() >= 2:   # no decay on norms / biases
        u = u + weight_decay * p.float()
    return -lr * u, m, n


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1):
    """Returns (init_fn, update_fn); update_fn(grads, state, params, lr)
    -> (f32 updates, new AdamState). `lr`: a float or 0-dim tensor."""

    def init(params) -> AdamState:
        def f32(p):
            return torch.zeros_like(p, dtype=torch.float32)
        dev = tree_leaves(params)[0].device
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         tree_map(f32, params), tree_map(f32, params))

    def update(grads, state: AdamState, params, lr):
        step = state.step + 1
        c1, c2 = _corrections(step, b1, b2)
        out = tree_map(
            lambda g, m, n, p: _adamw_leaf(g.float(), m, n, p, c1, c2, lr,
                                           b1, b2, eps, weight_decay),
            grads, state.mu, state.nu, params)
        return (tree_map(lambda o: o[0], out),
                AdamState(step, tree_map(lambda o: o[1], out),
                          tree_map(lambda o: o[2], out)))

    return init, update


def adamw_step_(params, grads, state: AdamState, lr, *, grad_scale=1.0,
                b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                weight_decay: float = 0.1) -> AdamState:
    """`adamw`'s update of the grads times `grad_scale` (the clip factor),
    then `apply_updates`, leaf by leaf in place: each param and moment
    tensor is overwritten and each grad leaf dropped from `grads` once
    used, so only one leaf's f32 temporaries live at a time. Returns the
    AdamState holding the same moment tensors and the next step."""
    step = state.step + 1
    c1, c2 = _corrections(step, b1, b2)
    for (pd, k), (gd, _), (md, _), (nd, _) in zip(
            _slots(params), _slots(grads), _slots(state.mu),
            _slots(state.nu)):
        g, gd[k] = gd[k], None
        p = pd[k]
        u, m, n = _adamw_leaf(g.float() * grad_scale, md[k], nd[k], p, c1,
                              c2, lr, b1, b2, eps, weight_decay)
        del g
        md[k].copy_(m)
        nd[k].copy_(n)
        p.copy_((p.float() + u).to(p.dtype))
    return AdamState(step, state.mu, state.nu)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaves summed
    left to right in JAX's order."""
    gn = 0
    for g in tree_leaves(grads):
        gn = gn + g.float().square().sum()
    return torch.sqrt(gn)


def clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """Scale `grads` to global norm <= max_norm. Returns (f32 grads, the
    norm before clipping, a 0-dim f32 tensor); the clipped leaves are
    f32, as JAX's product of a bf16 leaf and the f32 scale promotes."""
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn
