"""Training launcher of the PyTorch port (counterpart of
`repro.launch.train`): random weights from seed 0, the synthetic LM
stream, AdamW under a cosine or WSD schedule, an optional checkpoint in
the JAX package's format. On the card unless ``--device cpu``.

    python -m repro_torch.launch.train --arch granite-8b --reduced \\
        --steps 20 --device cpu
    python -m repro_torch.launch.train --arch minicpm-2b --schedule wsd \\
        --steps 4 --batch 8 --seq 256          # full size, on the card

``--mesh host`` shards the params and both AdamW moments over a
("data", "model") mesh of the launcher's world, (max(n // 4, 1),
min(n, 4)) as in the JAX launcher, by `nn.sharding.param_pspecs`, and
the batch over "data"; the step is the same one, on DTensors. The world
is torchrun's (WORLD_SIZE / RANK / LOCAL_RANK; NCCL on the card, gloo
with ``--device cpu``); launched alone it is one rank. Only rank 0
prints.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch granite-8b --reduced --steps 4 --mesh host --device cpu
"""
from __future__ import annotations

import argparse
import os
import socket
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.synthetic import lm_batches
from repro_torch.nn import model as M
from repro_torch.nn import sharding as shd
from repro_torch.optim import cosine_schedule, wsd_schedule
from repro_torch.train.loop import make_train_step


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI. Returns (final TrainState, one dict per step: the
    step's `StepMetrics` as floats, its wall seconds (the metrics' read
    synchronizes) and, on the card, `max_memory_allocated` so far)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant (CPU)")
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default="cosine")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--mesh", choices=["none", "host"], default="none",
                    help="'host': an FSDP x TP mesh over the launcher's "
                         "world of ranks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = None
    own_group = False
    if args.mesh == "host":
        mesh, device, own_group = _host_mesh(device)
    rank0 = mesh is None or dist.get_rank() == 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.schedule == "wsd":
        lr = wsd_schedule(args.lr, warmup=args.steps // 10,
                          stable=args.steps // 2, decay=args.steps // 3)
    else:
        lr = cosine_schedule(args.lr, warmup=args.steps // 10,
                             total=args.steps)

    params = M.init_params(cfg, seed=0, device=device)
    if mesh is not None:
        params = shd.distribute_tree(
            params, shd.param_pspecs(params, cfg, mesh), mesh)
    init_state, train_step = make_train_step(cfg, lr)
    state = init_state(params)      # moments placed like the params
    del params

    data = lm_batches(cfg, args.batch, args.seq, seed=0)
    history = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data).items()}
        if mesh is not None:
            batch = {k: shd.distribute_leaf(
                v, (shd.batch_spec(mesh)[0],) + (None,) * (v.dim() - 1),
                mesh) for k, v in batch.items()}
        t1 = time.perf_counter()
        state, m = train_step(state, batch)
        row = {k: float(v.full_tensor() if shd.is_dtensor(v) else v)
               for k, v in m._asdict().items()}  # one sync
        row["wall_s"] = time.perf_counter() - t1
        if device.type == "cuda":
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
        history.append(row)
        if rank0 and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i:5d}  loss={row['loss']:.4f}  "
                  f"ce={row['ce_loss']:.4f}  lr={row['lr']:.2e}  "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    if args.ckpt:
        save_pytree(state, args.ckpt)  # sharded: every rank gathers, 0 writes
        if rank0:
            print("saved", args.ckpt)
    if own_group:
        dist.destroy_process_group()
    return state, history


def _host_mesh(device: torch.device):
    """The ("data", "model") mesh of `--mesh host` over the launcher's
    world: (max(n // 4, 1), min(n, 4)). Joins torchrun's group
    (env://), or makes a one-rank group; returns (mesh, this rank's
    device, whether this call made the group)."""
    from torch.distributed.device_mesh import init_device_mesh
    own = not dist.is_initialized()
    if own:
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            dist.init_process_group(backend,
                                    init_method=f"tcp://localhost:{port}",
                                    world_size=1, rank=0)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    n = dist.get_world_size()
    mesh = init_device_mesh(device.type, (max(n // 4, 1), min(n, 4)),
                            mesh_dim_names=("data", "model"))
    return mesh, device, own


if __name__ == "__main__":
    main()
