"""One kimi-k2-scale MoE block at decode shape, run two ways on the fake
256-rank production mesh (counterpart of `repro.launch.perf_moe`):
DTensor `moe_apply` with the experts on "model" (the model's default
dispatch) and the explicit expert-parallel `moe_apply_expert_parallel`;
the collective bytes of each and their ratio.

    PYTHONPATH=src python -m repro_torch.launch.perf_moe
"""
from __future__ import annotations

import torch

from repro_torch.launch.dryrun import DeviceCounter, fake_world
from repro_torch.launch.mesh import NVLINK_BW, make_production_mesh
from repro_torch.nn import moe as MoE
from repro_torch.nn import sharding as shd
from repro_torch.nn.moe_ep import moe_apply_expert_parallel

Dm, F, E, TOPK = 7168, 2048, 384, 8          # kimi-k2 expert block
B = 128                                      # decode_32k batch


def run() -> dict:
    """{name: (weighted collective bytes, {kind: bytes})} of both
    dispatches."""
    out = {}
    with fake_world(256):
        mesh = make_production_mesh()
        shapes = MoE.moe_shapes(Dm, F, E)
        p = {k: torch.empty(v[0], dtype=(v[2] if len(v) > 2
                                         else torch.bfloat16), device="meta")
             for k, v in shapes.items()}
        ep_spec = {"router": (), "gate": ("model", None, None),
                   "up": ("model", None, None), "down": ("model", None, None)}
        dp = shd.distribute_tree(p, ep_spec, mesh)
        x = shd.distribute_leaf(
            torch.empty(B, 1, Dm, dtype=torch.bfloat16, device="meta"),
            ("data", None, None), mesh)
        for name, fn in (
            ("dtensor_dispatch",
             lambda: MoE.moe_apply(dp, x, top_k=TOPK)[0]),
            ("expert_parallel",
             lambda: moe_apply_expert_parallel(
                 dp, x, top_k=TOPK, mesh=mesh, capacity_factor=1.25,
                 dp_spec=("data",))),
        ):
            c = DeviceCounter()
            with c, torch.no_grad(), shd.replicate_plain():
                fn()
            coll = {k: v["bytes_weighted_n"] for k, v in c.collectives.items()
                    if v["bytes_weighted_n"] > 0}
            total = sum(2 * v if k == "all-reduce" else v
                        for k, v in coll.items())
            out[name] = (total, coll)
    return out


def main() -> None:
    res = run()
    for name, (total, coll) in res.items():
        print(f"{name}: collective_bytes={total:.4g} ({coll}) -> "
              f"{total / NVLINK_BW * 1e6:.1f} us/layer at NVLink 4 "
              f"(H100 SXM5, 450 GB/s per direction)")
    if res["expert_parallel"][0] > 0:
        ratio = res["dtensor_dispatch"][0] / res["expert_parallel"][0]
        print(f"ratio: {ratio:.1f}x")


if __name__ == "__main__":
    main()
