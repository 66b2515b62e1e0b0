"""Expert-parallel MoE (counterpart of `repro.nn.moe_ep`): experts live
on the tp axis ("model"), activations are replicated across it (already
batch-sharded over "data"), each rank computes ONLY its local experts'
assignments, and the combine is a single sum all-reduce of the
token-sized partial outputs — [N, d_model] bytes instead of
assignment-sized gathers, and FLOPs split 1/ep per rank.

It computes what the JAX function computes — every token routed against
the full router in f32, a rank's assignments kept by JAX's capacity
arithmetic (the rank among the rank's own assignments by cumsum, the
slot clamp) and their SwiGLU products — but not its op sequence: JAX
gathers a [cap, d_model, d_expert] weight copy per slot, which at
kimi-k2's width is far too large. Here the kept slots are grouped by
local expert and each expert runs one product over its rows (the group
sizes need one host read; on meta tensors, the dry run, the slots are
taken as spread evenly over the local experts).

Correctness contract: equal to `moe_apply_dense` when capacity is
drop-free (tests/test_torch_moe_ep.py, on 4 gloo ranks).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn import sharding as shd


def _local_moe(router, gate, up, down, x, *, top_k: int,
               capacity_factor: float, n_experts: int, shard: int):
    """One ep rank. gate/up/down: [E_loc, ...] (this rank's experts);
    x: [N, Dm] (replicated over ep). Returns this rank's partial y
    [N, Dm] f32."""
    E_loc = gate.shape[0]
    e_lo = shard * E_loc
    dev = x.device

    logits = x.float() @ router.float()                  # [N, E] (global)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, top_k, dim=-1)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)

    N, Dm = x.shape
    A = N * top_k
    cap = max(int(-(-A * capacity_factor // n_experts)), 1)
    cap = min(cap * E_loc, A)          # local buffer across E_loc experts

    flat_e = top_idx.reshape(A)
    flat_w = top_vals.reshape(A)
    local = (flat_e >= e_lo) & (flat_e < e_lo + E_loc)   # my assignments
    # rank within the local set (stable order), capacity-capped
    lrank = torch.cumsum(local.to(torch.int32), 0) - 1
    keep = local & (lrank < cap)
    slot = torch.where(keep, lrank, cap - 1).long()
    tok = torch.arange(A, device=dev) // top_k

    # slot s holds the kept assignment of local rank s (JAX's buffer);
    # an empty slot carries the sentinel expert E_loc
    dest = torch.where(keep, slot, cap)
    buf = torch.zeros(cap + 1, Dm, dtype=x.dtype, device=dev)
    buf[dest] = x[tok]
    eid = torch.full((cap + 1,), E_loc, dtype=torch.long, device=dev)
    eid[dest] = flat_e - e_lo
    buf, eid = buf[:cap], eid[:cap]

    # group the slots by local expert: one product per expert
    by_e = torch.sort(eid, stable=True).indices
    if x.is_meta:
        sizes = [cap // E_loc + (j < cap % E_loc) for j in range(E_loc)]
    else:
        sizes = torch.bincount(eid, minlength=E_loc + 1)[:E_loc].tolist()
    yb = torch.zeros(cap, Dm, dtype=x.dtype, device=dev)
    start = 0
    for j, n in enumerate(sizes):
        if n:
            rows = by_e[start:start + n]
            xr = buf[rows]
            g = xr @ gate[j]
            u = xr @ up[j]
            h = F.silu(g.float()).to(x.dtype) * u
            yb[rows] = h @ down[j]
            start += n

    contrib = yb[slot].float() * torch.where(keep, flat_w, 0.0)[:, None]
    contrib = contrib.view(N, top_k, Dm)
    y = torch.zeros(N, Dm, dtype=torch.float32, device=dev)
    for j in range(top_k):         # a token's assignments in order
        y = y + contrib[:, j]
    return y


def moe_apply_expert_parallel(p: dict, x: torch.Tensor, *, top_k: int, mesh,
                              capacity_factor: float = 1.25,
                              ep_axis: str = "model",
                              dp_spec: shd.PSpec = ()) -> torch.Tensor:
    """x: [B, T, Dm], replicated over `ep_axis` and optionally sharded
    over other axes per `dp_spec` (a DTensor, or a plain tensor every
    rank holds whole). p: MoE params (DTensors or whole tensors) with
    experts divisible by the ep axis: each rank takes its E / ep experts
    (dim 0 over `ep_axis`) and the whole router. Returns y [B, T, Dm] in
    x's dtype — a DTensor placed by `dp_spec` if x is one."""
    from torch.distributed._functional_collectives import (all_reduce,
                                                           wait_tensor)
    from torch.distributed.tensor import DTensor

    B, T, Dm = x.shape
    E = p["router"].shape[1]
    ep = shd.axis_size(mesh, ep_axis)
    assert E % ep == 0, (E, ep)

    def local(t, spec):
        if isinstance(t, DTensor):
            t = t.redistribute(mesh, shd.to_placements(spec, mesh))
        else:
            t = shd.distribute_leaf(t, spec, mesh)
        return t.to_local()

    expert_spec = (ep_axis, None, None)
    x_spec = tuple(dp_spec) + (None,) * (3 - len(dp_spec))
    xl = local(x, x_spec)
    b, t = xl.shape[:2]
    shard = mesh.get_local_rank(ep_axis)
    y = _local_moe(local(p["router"], ()), local(p["gate"], expert_spec),
                   local(p["up"], expert_spec), local(p["down"], expert_spec),
                   xl.reshape(b * t, Dm), top_k=top_k,
                   capacity_factor=capacity_factor, n_experts=E, shard=shard)
    # the combine: one sum all-reduce of the [N, Dm] f32 partials
    y = wait_tensor(all_reduce(y, "sum", mesh.get_group(ep_axis)))
    y = y.reshape(b, t, Dm).to(x.dtype)
    if isinstance(x, DTensor):
        return DTensor.from_local(y, mesh, shd.to_placements(x_spec, mesh),
                                  shape=x.shape, stride=x.stride())
    return y
