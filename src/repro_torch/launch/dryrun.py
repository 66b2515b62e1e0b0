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
    partitioned HLO);
  * ``bytes_accessed_per_device``: the input and output bytes of every
    local op (one rank's shards), views and metadata ops (``view``,
    ``t``, ``slice``, ``empty``, ``wait_tensor`` ...) left out. Eager
    PyTorch runs each op on its own, so this is the unfused traffic:
    XLA's "bytes accessed" counts a fusion's inputs and outputs once, and
    an elementwise chain the port reads and writes op by op XLA reads
    once;
  * ``memory_analysis``, with the keys of JAX's compiled memory analysis:
    ``argument_size_in_bytes`` (the local shards of the params, train
    state, batch and cache), ``output_size_in_bytes`` (what the step
    returns), ``alias_size_in_bytes`` (the outputs that are arguments
    updated in place: the cache, and in training the params and
    moments), ``temp_size_in_bytes`` (the peak of the bytes the step
    allocated and still held, at any op: autograd's saved tensors, the
    block remat's recomputation, the in-place AdamW's one-leaf
    temporaries and the outputs — so arguments + temp is the step's peak
    a device), ``generated_code_size_in_bytes`` 0. Live storage is
    tracked by weak references to each new output's `untyped_storage()`
    (meta storages carry their byte size), freed when its last
    reference dies.
``compile_s`` is null: nothing is compiled. The CLI also writes each
run's counted op log, one JSON line per op (its local input and output
shapes, dtypes and element sizes; a collective's kind and group size),
to ``<out>/ops/<tag>.jsonl.gz``; `launch.reanalyze` re-derives the dot
FLOPs, collectives and bytes from it without re-running a step.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape decode_32k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

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


# ops that move no bytes: they make a view, read metadata or allocate
# without writing (counted neither as traffic nor as an op of the log)
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "wait_tensor", "lift_fresh", "sym_size",
               "sym_stride", "sym_numel", "sym_storage_offset"}


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _is_view(func) -> bool:
    """An op whose outputs alias its inputs without writing them."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _tensors(tree) -> list:
    return [t for t in pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def _spec(t: torch.Tensor) -> list:
    return [list(t.shape), str(t.dtype).split(".")[-1], t.element_size()]


def _collective(name: str, args) -> tuple:
    """(kind, group size) of a `_c10d_functional` op, or None."""
    if name == "all_reduce":
        return "all-reduce", _group_size(args[2])
    if name == "all_gather_into_tensor":
        return "all-gather", int(args[1])
    if name == "reduce_scatter_tensor":
        return "reduce-scatter", int(args[2])
    if name == "all_to_all_single":
        return "all-to-all", _group_size(args[3])
    if name in ("isend", "irecv", "batch_p2p_ops"):
        return "collective-permute", 2
    return None


def new_totals() -> dict:
    """The counters `account` adds one op record to."""
    return {"dot_flops": 0.0, "bytes": 0.0,
            "collectives": {k: {"count": 0, "bytes": 0.0,
                                "bytes_weighted_n": 0.0}
                            for k in COLL_KINDS}}


def account(rec: dict, totals: dict) -> None:
    """Add one op record (`DeviceCounter`'s, or a line of a saved op log)
    to `totals`: its bytes, its dot FLOPs, its collective. The live count
    and `launch.reanalyze` both go through here, so a log re-derives its
    run's numbers exactly."""
    def nbytes(spec):
        return math.prod(spec[0]) * spec[2]
    ins, outs = rec["in"], rec["out"]
    totals["bytes"] += sum(map(nbytes, ins)) + sum(map(nbytes, outs))
    name = rec["op"].split(".")[1]
    if rec["op"].startswith("aten.") and name in _DOTS and outs:
        a = ins[0] if name in ("mm", "bmm") else ins[1]
        totals["dot_flops"] += 2.0 * math.prod(outs[0][0]) * a[0][-1]
    if rec.get("coll"):
        kind, n = rec["coll"]
        x = nbytes(ins[0])
        moved = {"all-gather": x * n, "reduce-scatter": x / n}.get(kind, x)
        c = totals["collectives"][kind]
        c["count"] += 1
        c["bytes"] += moved
        c["bytes_weighted_n"] += moved * (n - 1) / max(n, 1)


class DeviceCounter(TorchDispatchMode):
    """Counts one rank's dot FLOPs, collectives, bytes and live memory. An
    op on DTensors is passed to DTensor (NotImplemented), so the mode sees
    the local ops it runs: the shards' matmuls and the functional
    collectives of its redistributions. Plain tensors (inside `local_map`)
    are local already. Ops on fake tensors are DTensor's sharding
    propagation inferring global shapes, not work: they are not counted.

    `arguments(tree)` names the storages the step starts with; every
    storage an op makes after that is live from its op until its last
    reference dies (`live_bytes`, its maximum `peak_bytes`). With `log`,
    each counted op's record is appended to it."""

    def __init__(self, log: list = None):
        super().__init__()
        self.log = log
        self.totals = new_totals()
        self.arg_keys: set = set()
        self.arg_bytes = 0
        self.live: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    @property
    def dot_flops(self) -> float:
        return self.totals["dot_flops"]

    @property
    def collectives(self) -> dict:
        return self.totals["collectives"]

    @property
    def bytes_accessed(self) -> float:
        return self.totals["bytes"]

    def arguments(self, tree) -> int:
        """Record the step's argument storages (local shards); returns
        their bytes."""
        for t in _tensors(_local(tree)):
            st = t.untyped_storage()
            if id(st) not in self.arg_keys:
                self.arg_keys.add(id(st))
                self.arg_bytes += st.nbytes()
        return self.arg_bytes

    def storage_bytes(self, tree, only_args: bool = False) -> int:
        """Bytes of the distinct storages of `tree`'s local tensors (only
        the arguments' with `only_args`)."""
        seen, n = set(), 0
        for t in _tensors(_local(tree)):
            st = t.untyped_storage()
            if id(st) in seen or (only_args and id(st) not in self.arg_keys):
                continue
            seen.add(id(st))
            n += st.nbytes()
        return n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.arg_keys or key in self.live:
            return
        n = st.nbytes()
        self.live[key] = (n, weakref.ref(st, lambda _, k=key: self._free(k)))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key) -> None:
        got = self.live.pop(key, None)
        if got is not None:
            self.live_bytes -= got[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out
        for t in outs:
            self._track(t)
        ns, name = func.namespace, func.__name__.split(".")[0]
        if name in _NO_TRAFFIC or _is_view(func):
            return out
        rec = {"op": f"{ns}.{func.__name__}", "in": [_spec(t) for t in ins],
               "out": [_spec(t) for t in outs]}
        if ns == "_c10d_functional":
            coll = _collective(name, args)
            if coll is not None:
                rec["coll"] = list(coll)
        account(rec, self.totals)
        if self.log is not None:
            self.log.append(rec)
        return out


def _local(tree):
    """`tree` with each DTensor leaf replaced by its local shard."""
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in pytree_leaves(tree)]


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
            cfg=None, shape=None, mesh_dims=None, op_log: list = None
            ) -> dict:
    """Run one workload's step on the fake production mesh; returns its
    record (the JAX package's keys). `cfg`, `shape` (an `InputShape`) and
    `mesh_dims` (sizes, axis names) replace the arch's config, the named
    input shape and the production mesh (the tests' small runs). With
    `op_log`, the step's counted op records are appended to it."""
    from torch.distributed.device_mesh import init_device_mesh
    # kvlint: ok(launch-flag: meta tensors have no data for a CUDA kernel; the dry run counts the plain path, as the JAX dry run lowers its plain path)
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
            counter = DeviceCounter(op_log)
            if wl.kind == "train":
                init_state, train_step = make_train_step(
                    cfg, cosine_schedule(3e-4, 100, 10_000))
                state = init_state(dparams)
                counter.arguments((state, args[0]))
            else:
                counter.arguments((dparams, args))
            t0 = time.perf_counter()
            with counter, torch.no_grad() if wl.kind != "train" else \
                    contextlib.nullcontext():
                if wl.kind == "train":
                    out = train_step(state, args[0])
                elif wl.kind == "prefill":
                    out = M.prefill(dparams, cfg, args[0],
                                    CacheSpec(budget=shape.seq_len,
                                              policy="none"))
                else:
                    spec = wl.cache_spec
                    # meta tensors cannot answer the ring-full question:
                    # run the flushing step
                    out = M.decode_step(dparams, cfg, args[0], args[1], spec,
                                        ring_full=True if spec.quantized
                                        else None)
            t_lower = time.perf_counter() - t0
            memory = {
                "argument_size_in_bytes": int(counter.arg_bytes),
                "output_size_in_bytes": int(counter.storage_bytes(out)),
                "alias_size_in_bytes": int(counter.storage_bytes(
                    out, only_args=True)),
                "temp_size_in_bytes": int(counter.peak_bytes),
                "generated_code_size_in_bytes": 0}
            del out
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
        "bytes_accessed_per_device": counter.bytes_accessed,
        "collectives": counter.collectives,
        "memory_analysis": memory,
        "arg_bytes_total": int(_bytes(wl.args)
                               + sum(_bytes(t) for t in tree_leaves(params))),
        "param_count": int(cfg.param_count()),
        "active_param_count": int(cfg.active_param_count()),
        "lower_s": round(t_lower, 2),
        "compile_s": None,
        "status": "ok",
    }


def write_op_log(path: str, ops: list) -> None:
    """One JSON line per op record, gzipped (`launch.reanalyze` reads it)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        for rec in ops:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")


def _peak(rec: dict) -> float:
    """Arguments + temp bytes a device: the step's predicted peak."""
    m = rec["memory_analysis"]
    return m["argument_size_in_bytes"] + m["temp_size_in_bytes"]


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
                ops: list = []
                try:
                    res = run_one(arch, shape, multi_pod=mp, op_log=ops)
                    write_op_log(os.path.join(args.out, "ops",
                                              tag + ".jsonl.gz"), ops)
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
                         f" bytes/dev={res['bytes_accessed_per_device']:.3g}"
                         f" mem/dev={_peak(res):.3g}"
                         f" lower={res['lower_s']}s")
                print(f"[{st}] {tag}{extra}", flush=True)
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
