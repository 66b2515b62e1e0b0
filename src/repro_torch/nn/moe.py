"""Mixture-of-experts FFN with a top-k router (counterpart of
`repro.nn.moe`).

Primary path: **capacity-based sort dispatch**: the assignments are
sorted by expert id into an [E, capacity, d_model] buffer, each expert
runs one dense product (`torch.bmm`, no kernel of the JAX package's
either), and the results come back weighted by the router
probabilities. Capacity is per call: the tokens of one call (every slot
of a decode step, every row of a prefill bucket) share each expert's
`capacity` rows, and an assignment past them is dropped.

`moe_apply_dense` is the soft-dispatch reference (exact, no token
dropping), the oracle for the dispatch path.

The JAX function's sharding constraints (expert / tensor parallel
layouts) have no counterpart here: one card holds every expert.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor   # scalar
    router_z_loss: torch.Tensor       # scalar
    expert_load: torch.Tensor         # [E] fraction of routed mass per expert
    drop_fraction: torch.Tensor       # scalar — tokens dropped at capacity


def moe_shapes(d_model: int, d_expert: int, num_experts: int) -> dict:
    """`nn.model.init_params` leaf specs ``(shape, fan_in[, dtype])`` of
    one MoE FFN, the JAX `moe_init` tree: the router stays f32 as in JAX,
    the experts take the model dtype."""
    e = num_experts
    return {
        "router": ((d_model, e), d_model, torch.float32),
        "gate": ((e, d_model, d_expert), d_model),
        "up": ((e, d_model, d_expert), d_model),
        "down": ((e, d_expert, d_model), d_expert),
    }


def _route(p, x, top_k):
    logits = x.float() @ p["router"].float()                 # [B, T, E]
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, top_k, dim=-1)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    return logits, probs, top_vals, top_idx


def _aux(logits, probs, top_idx, top_vals, E, drop_frac) -> MoEAux:
    N = probs.shape[0] * probs.shape[1]
    load = torch.zeros(E, dtype=torch.float32, device=probs.device)
    load = load.index_add_(0, top_idx.reshape(-1), top_vals.reshape(-1)) / N
    importance = probs.mean(dim=(0, 1))
    lb = E * torch.sum(load * importance)
    zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return MoEAux(lb, zl, load, drop_frac)


def capacity(n_tokens: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Rows per expert for a call of `n_tokens`: the JAX package's Python
    float arithmetic, ceil(A * factor / E) at least 1, at most A."""
    A = n_tokens * top_k
    cap = max(-(-A * capacity_factor // num_experts), 1)
    return int(min(cap, A))                         # never beyond drop-free


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25):
    """Capacity-based sort dispatch. x: [B, T, d_model]. Returns
    (y [B, T, d_model] in x's dtype, MoEAux)."""
    B, T, Dm = x.shape
    E = p["router"].shape[1]
    logits, probs, top_vals, top_idx = _route(p, x, top_k)

    N = B * T
    A = N * top_k                                   # assignments
    cap = capacity(N, top_k, E, capacity_factor)
    dev = x.device
    x_flat = x.reshape(N, Dm)
    flat_e = top_idx.reshape(A)                     # token-major assignments
    flat_w = top_vals.reshape(A)

    # A stable sort keeps each expert's assignments in token order, so an
    # assignment's rank (and whether it is dropped) is that of JAX's
    # stable argsort. torch.topk may order a row's tied experts unlike
    # lax.top_k, but ranks do not depend on that order: one token never
    # picks one expert twice.
    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(sorted_e,
                                torch.arange(E, device=dev, dtype=flat_e.dtype))
    rank = torch.arange(A, device=dev) - starts[sorted_e]
    keep = rank < cap
    rank_c = torch.clamp(rank, max=cap - 1)
    tok = order // top_k

    # every kept assignment owns one (expert, rank) row; the dropped ones
    # land in a spare last row that is cut off (JAX adds their zeros)
    dest = torch.where(keep, sorted_e * cap + rank, E * cap)
    buf = torch.zeros(E * cap + 1, Dm, dtype=x.dtype, device=dev)
    buf[dest] = x_flat[tok]
    buf = buf[:E * cap].view(E, cap, Dm)

    g = torch.bmm(buf, p["gate"])
    u = torch.bmm(buf, p["up"])
    h = F.silu(g.float()).to(x.dtype) * u
    y_buf = torch.bmm(h, p["down"])                 # [E, cap, Dm]

    # The combine, in a fixed order: JAX scatter-adds the contributions
    # into f32 zeros in the sorted (expert-major) order. Here each
    # assignment's contribution goes back to token-major [N, top_k, Dm]
    # and a token's are summed in ascending expert order, with no atomics
    # (index_add_ on the card sums in an order that changes run to run).
    w_sorted = torch.where(keep, flat_w[order], 0.0)
    contrib = y_buf[sorted_e, rank_c].float() * w_sorted[:, None]
    tm = torch.empty_like(contrib)
    tm[order] = contrib
    tm = tm.view(N, top_k, Dm)
    by_expert = torch.argsort(top_idx.reshape(N, top_k), dim=-1)
    tm = torch.gather(tm, 1, by_expert[..., None].expand(N, top_k, Dm))
    out = torch.zeros(N, Dm, dtype=torch.float32, device=dev)
    for j in range(top_k):
        out = out + tm[:, j]

    drop_frac = 1.0 - keep.float().mean()
    aux = _aux(logits, probs, top_idx, top_vals, E, drop_frac)
    return out.reshape(B, T, Dm).to(x.dtype), aux


def moe_apply_dense(p: dict, x: torch.Tensor, *, top_k: int):
    """Soft-dispatch reference: every expert sees every token, masked by
    the combine weights, in f32. Exact (no drops); FLOPs ∝ E — tests and
    the oracle only."""
    B, T, Dm = x.shape
    E = p["router"].shape[1]
    logits, probs, top_vals, top_idx = _route(p, x, top_k)
    combine = torch.sum(F.one_hot(top_idx, E).float() * top_vals[..., None],
                        dim=2)                       # [B, T, E]
    xf = x.float()
    g = torch.einsum("btd,edf->btef", xf, p["gate"].float())
    u = torch.einsum("btd,edf->btef", xf, p["up"].float())
    h = F.silu(g) * u
    h = h * combine[..., None]
    y = torch.einsum("btef,efd->btd", h, p["down"].float())
    aux = _aux(logits, probs, top_idx, top_vals, E,
               torch.zeros((), device=x.device))
    return y.to(x.dtype), aux
