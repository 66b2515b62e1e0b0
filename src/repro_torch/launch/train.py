"""Training launcher of the PyTorch port (counterpart of
`repro.launch.train`): random weights from seed 0, the synthetic LM
stream, AdamW under a cosine or WSD schedule, an optional checkpoint in
the JAX package's format. On the card unless ``--device cpu``.

    python -m repro_torch.launch.train --arch granite-8b --reduced \\
        --steps 20 --device cpu
    python -m repro_torch.launch.train --arch minicpm-2b --schedule wsd \\
        --steps 4 --batch 8 --seq 256          # full size, on the card

One card holds the whole state (bf16 params and grads, f32 moments);
``--mesh host`` (the JAX launcher's FSDP x TP mesh) needs the sharding
slice of the port (`nn/sharding.py` over torch.distributed), not yet
written, and is refused.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.synthetic import lm_batches
from repro_torch.nn import model as M
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
                    help="'host': a mesh over all visible devices (not "
                         "yet in the port)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.mesh == "host":
        ap.error("--mesh host shards params and moments over a device "
                 "mesh: that needs the port's sharding slice (nn/sharding.py "
                 "over torch.distributed, ROADMAP A7), not yet written")

    device = resolve_device(args.device)
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
    init_state, train_step = make_train_step(cfg, lr)
    state = init_state(params)
    del params

    data = lm_batches(cfg, args.batch, args.seq, seed=0)
    history = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data).items()}
        t1 = time.perf_counter()
        state, m = train_step(state, batch)
        row = {k: float(v) for k, v in m._asdict().items()}  # one sync
        row["wall_s"] = time.perf_counter() - t1
        if device.type == "cuda":
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
        history.append(row)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss={row['loss']:.4f}  "
                  f"ce={row['ce_loss']:.4f}  lr={row['lr']:.2e}  "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    if args.ckpt:
        save_pytree(state, args.ckpt)
        print("saved", args.ckpt)
    return state, history


if __name__ == "__main__":
    main()
