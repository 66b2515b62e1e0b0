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

On sharded (DTensor) params the activation-sharding hooks of the JAX
function sit at the same points (`nn.sharding`: ``weight_gather`` keeps
experts on tp when it divides them, else tp on d_expert;
``moe_ep_dispatch`` pins the expert buffer to tp). The dispatch's sort,
searchsorted and scatter run on tensors replicated over the mesh,
where XLA replicates them too; `nn.moe_ep` is the explicit
expert-parallel alternative.
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


def _dispatch(x_flat, top_idx, E: int, cap: int, top_k: int):
    """The sort dispatch of the call's assignments: (buf [E, cap, Dm],
    sorted_e, rank_c, keep, order), each [A] over the sorted order."""
    dev = x_flat.device
    A = top_idx.numel()
    Dm = x_flat.shape[1]
    flat_e = top_idx.reshape(A)                     # token-major assignments
    # A stable sort keeps each expert's assignments in token order, so an
    # assignment's rank (and whether it is dropped) is that of JAX's
    # stable argsort. torch.topk may order a row's tied experts unlike
    # lax.top_k, but ranks do not depend on that order: one token never
    # picks one expert twice.
    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev, dtype=flat_e.dtype))
    rank = torch.arange(A, device=dev) - starts[sorted_e]
    keep = rank < cap
    rank_c = torch.clamp(rank, max=cap - 1)
    tok = order // top_k

    # every kept assignment owns one (expert, rank) row; the dropped ones
    # land in a spare last row that is cut off (JAX adds their zeros)
    dest = torch.where(keep, sorted_e * cap + rank, E * cap)
    buf = torch.zeros(E * cap + 1, Dm, dtype=x_flat.dtype, device=dev)
    buf[dest] = x_flat[tok]
    return buf[:E * cap].view(E, cap, Dm), sorted_e, rank_c, keep, order


def _combine(y_buf, sorted_e, rank_c, keep, order, top_vals, top_idx):
    """The expert outputs back to tokens: [N, Dm] f32.

    The combine, in a fixed order: JAX scatter-adds the contributions
    into f32 zeros in the sorted (expert-major) order. Here each
    assignment's contribution goes back to token-major [N, top_k, Dm]
    and a token's are summed in ascending expert order, with no atomics
    (index_add_ on the card sums in an order that changes run to run)."""
    N, top_k = top_idx.shape[0] * top_idx.shape[1], top_idx.shape[-1]
    Dm = y_buf.shape[-1]
    w_sorted = torch.where(keep, top_vals.reshape(-1)[order], 0.0)
    contrib = y_buf[sorted_e, rank_c].float() * w_sorted[:, None]
    tm = torch.empty_like(contrib)
    tm[order] = contrib
    tm = tm.view(N, top_k, Dm)
    by_expert = torch.argsort(top_idx.reshape(N, top_k), dim=-1)
    tm = torch.gather(tm, 1, by_expert[..., None].expand(N, top_k, Dm))
    out = torch.zeros(N, Dm, dtype=torch.float32, device=y_buf.device)
    for j in range(top_k):
        out = out + tm[:, j]
    return out


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25):
    """Capacity-based sort dispatch. x: [B, T, d_model]. Returns
    (y [B, T, d_model] in x's dtype, MoEAux).

    On DTensors the dispatch, the combine and the aux statistics (sort,
    searchsorted, scatters: no DTensor sharding rule) run on tensors
    replicated over the mesh (`sharding.on_shards` with a replicated
    layout); the expert products run on the expert-sharded weights
    through DTensor's propagation."""
    from repro_torch.nn import sharding as shd
    if shd.opt_enabled("weight_gather"):
        # keep experts sharded over tp when divisible, else tp stays on
        # d_expert; either way the fsdp'd d_model dim is gathered at use
        E_ = p["gate"].shape[0]
        if shd.tp_divides(E_):
            spec_gu, spec_d = ("tp", None, None), ("tp", None, None)
        else:
            spec_gu, spec_d = (None, None, "tp"), (None, "tp", None)
        p = {**p,
             "gate": shd.constrain(p["gate"], *spec_gu),
             "up": shd.constrain(p["up"], *spec_gu),
             "down": shd.constrain(p["down"], *spec_d)}
    B, T, Dm = x.shape
    E = p["router"].shape[1]
    logits, probs, top_vals, top_idx = _route(p, x, top_k)

    N = B * T
    cap = capacity(N, top_k, E, capacity_factor)
    rep = shd.replicated_layout(x)
    buf, sorted_e, rank_c, keep, order = shd.on_shards(
        lambda xf, ti: _dispatch(xf, ti, E, cap, top_k), rep,
        x.reshape(N, Dm), top_idx, out=(3, 1, 1, 1, 1))
    if shd.opt_enabled("moe_ep_dispatch") and shd.tp_divides(E):
        # expert-parallel dispatch: pin the expert buffer to the tp axis
        buf = shd.constrain(buf, "tp", None, None)
    else:
        # experts over tp, each expert's rows over the fsdp axes, as GSPMD
        # partitions the products
        buf = shd.place(buf, "tp", "fsdp", None)

    g = torch.bmm(buf, shd.gather_fsdp(p["gate"]))
    u = torch.bmm(buf, shd.gather_fsdp(p["up"]))
    h = F.silu(g.float()).to(x.dtype) * u
    y_buf = torch.bmm(h, shd.gather_fsdp(p["down"]))    # [E, cap, Dm]

    out = shd.on_shards(_combine, rep, y_buf, sorted_e, rank_c, keep, order,
                        top_vals, top_idx, out=(2,))
    aux = shd.on_shards(
        lambda lg, pr, ti, tv, kp: _aux(lg, pr, ti, tv, E,
                                        1.0 - kp.float().mean()),
        rep, logits, probs, top_idx, top_vals, keep, out=(0, 0, 1, 0))
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
