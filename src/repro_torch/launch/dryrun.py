"""Production dry run of the PyTorch port (counterpart of
`repro.launch.dryrun`): every (arch x input shape x mesh) step runs on
the production meshes in ONE process, and the roofline inputs are read
off it.

A fake process group of 256 (or 512) ranks stands in for the cluster
(`torch.testing`'s fake backend: collectives return without moving
data), the mesh is `make_production_mesh`'s, and the params, train
state, batch and cache are meta DTensors placed by the spec rules
(`nn.sharding`, `launch.specs`). The step is the port's own: the train
step with its backward pass and AdamW, `prefill`, `decode_step`. The
model runs its plain path (``use_kernels=False``): the JAX package lowers
its plain path on placeholder CPU devices too, and a CUDA kernel cannot
take a meta tensor.

What it counts, with a dispatch mode that sees each rank's local ops
(`DeviceCounter`):
  * ``dot_flops_per_device``: 2 * M * N * K of every local mm / bmm /
    addmm / baddbmm (einsums lower to these) — one rank's shards, where
    FlopCounterMode over DTensors counts the global op;
  * ``collectives``: per kind, the count, the result bytes and the bytes
    weighted by (n - 1) / n for the group size n, from the
    `_c10d_functional` ops DTensor issues (JAX's accounting over the
    partitioned HLO).
``compile_s``, ``bytes_accessed_per_device`` and ``memory_analysis``
have no counterpart (nothing is compiled) and are written as null.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape decode_32k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core.cache import CacheSpec
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import batch_specs
from repro_torch.nn import model as M
from repro_torch.nn import sharding as shd
from repro_torch.optim import cosine_schedule
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train.loop import make_train_step

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
_DOTS = ("mm", "bmm", "addmm", "baddbmm")


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class DeviceCounter(TorchDispatchMode):
    """Counts one rank's dot FLOPs and collectives. An op on DTensors is
    passed to DTensor (NotImplemented), so the mode sees the local ops it
    runs: the shards' matmuls and the functional collectives of its
    redistributions. Plain tensors (inside `local_map`) are local
    already. Ops on fake tensors are DTensor's sharding propagation
    inferring global shapes, not work: they are not counted."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.collectives = {k: {"count": 0, "bytes": 0.0,
                                "bytes_weighted_n": 0.0} for k in COLL_KINDS}

    def _coll(self, kind: str, nbytes: float, n: int) -> None:
        c = self.collectives[kind]
        c["count"] += 1
        c["bytes"] += nbytes
        c["bytes_weighted_n"] += nbytes * (n - 1) / max(n, 1)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(isinstance(a, FakeTensor) for a in args):
            return out
        ns, name = func.namespace, func.__name__.split(".")[0]
        if ns == "aten" and name in _DOTS:
            a, b = ((args[0], args[1]) if name in ("mm", "bmm")
                    else (args[1], args[2]))
            self.dot_flops += 2.0 * out.numel() * a.shape[-1]
        elif ns == "_c10d_functional":
            x = args[0]
            nbytes = x.numel() * x.element_size()
            if name == "all_reduce":
                self._coll("all-reduce", nbytes, _group_size(args[2]))
            elif name == "all_gather_into_tensor":
                self._coll("all-gather", nbytes * args[1], args[1])
            elif name == "reduce_scatter_tensor":
                self._coll("reduce-scatter", nbytes / args[2], args[2])
            elif name == "all_to_all_single":
                self._coll("all-to-all", nbytes, _group_size(args[3]))
            elif name in ("isend", "irecv", "batch_p2p_ops"):
                self._coll("collective-permute", nbytes, 2)
        return out


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of `n` ranks (this process is rank
    0), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs no process group to be "
                           "initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _bytes(tree) -> int:
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            opts: frozenset = frozenset(), extra_note: str = "",
            cfg=None, shape=None, mesh_dims=None) -> dict:
    """Run one workload's step on the fake production mesh; returns its
    record (the JAX package's keys). `cfg`, `shape` (an `InputShape`) and
    `mesh_dims` (sizes, axis names) replace the arch's config, the named
    input shape and the production mesh (the tests' small runs)."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = (cfg or get_config(arch)).replace(use_kernels=False)
    shape = shape or INPUT_SHAPES[shape_name]
    n_dev = ((512 if multi_pod else 256) if mesh_dims is None
             else math.prod(mesh_dims[0]))
    with fake_world(n_dev):
        mesh = (make_production_mesh(multi_pod=multi_pod) if mesh_dims is None
                else init_device_mesh("cuda", mesh_dims[0],
                                      mesh_dim_names=mesh_dims[1]))
        with shd.activation_sharding(mesh, opts):
            wl = batch_specs(cfg, shape, mesh, opts)
            params = M.init_params(cfg, device="meta")
            dparams = shd.distribute_tree(
                params, shd.param_pspecs(params, cfg, mesh), mesh)
            args = [shd.distribute_tree(a, s, mesh) if isinstance(a, dict)
                    or hasattr(a, "_fields") else shd.distribute_leaf(a, s,
                                                                      mesh)
                    for a, s in zip(wl.args, wl.in_specs)]
            if wl.kind == "train":
                init_state, train_step = make_train_step(
                    cfg, cosine_schedule(3e-4, 100, 10_000))
                state = init_state(dparams)
            counter = DeviceCounter()
            t0 = time.perf_counter()
            with counter, torch.no_grad() if wl.kind != "train" else \
                    contextlib.nullcontext():
                if wl.kind == "train":
                    train_step(state, args[0])
                elif wl.kind == "prefill":
                    M.prefill(dparams, cfg, args[0],
                              CacheSpec(budget=shape.seq_len, policy="none"))
                else:
                    spec = wl.cache_spec
                    # meta tensors cannot answer the ring-full question:
                    # run the flushing step
                    M.decode_step(dparams, cfg, args[0], args[1], spec,
                                  ring_full=True if spec.quantized else None)
            t_lower = time.perf_counter() - t0
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": ("pod2x16x16" if multi_pod else "16x16") if mesh_dims is None
        else "x".join(map(str, mesh_dims[0])),
        "n_devices": n_dev,
        "kind": wl.kind,
        "note": (wl.note + " " + extra_note).strip(),
        "flops_per_device": counter.dot_flops,
        "dot_flops_per_device": counter.dot_flops,
        "bytes_accessed_per_device": None,
        "collectives": counter.collectives,
        "memory_analysis": None,
        "arg_bytes_total": int(_bytes(wl.args)
                               + sum(_bytes(t) for t in tree_leaves(params))),
        "param_count": int(cfg.param_count()),
        "active_param_count": int(cfg.active_param_count()),
        "lower_s": round(t_lower, 2),
        "compile_s": None,
        "status": "ok",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=os.path.abspath(DEFAULT_OUT))
    args = ap.parse_args(argv)

    archs = ([a for a in ARCH_IDS if a != "paper-llama-7b"]
             if args.arch == "all" else args.arch.split(","))
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                try:
                    res = run_one(arch, shape, multi_pod=mp)
                except Exception as e:  # noqa: BLE001 — recorded, counted
                    failures += 1
                    res = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "FAIL", "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=1)
                st = res["status"]
                extra = ("" if st != "ok" else
                         f" flops/dev={res['dot_flops_per_device']:.3g}"
                         f" lower={res['lower_s']}s")
                print(f"[{st}] {tag}{extra}", flush=True)
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
