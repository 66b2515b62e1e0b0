"""End-to-end training script of the PyTorch / CUDA port (the twin of
`examples/train_tiny.py`): train a small LLaMa-family model on the
synthetic Markov stream and watch the loss drop; checkpoints on exit, in
the JAX package's checkpoint format. Runs on the card unless
``--device cpu``.

Default size is CPU-friendly (~3M params, 200 steps); --preset 100m
selects a ~100M model for the card.

    PYTHONPATH=src python examples/torch_train_tiny.py --steps 200 \\
        [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.synthetic import lm_batches
from repro_torch.nn import model as M
from repro_torch.optim import wsd_schedule
from repro_torch.train.loop import make_train_step


def preset_config(preset: str):
    base = get_config("paper-llama-7b")
    if preset == "tiny":
        return reduced(base, num_layers=4, d_model=256, num_heads=4,
                       num_kv_heads=4, d_ff=512, vocab_size=512)
    # ~100M
    return base.replace(num_layers=12, d_model=768, num_heads=12,
                        num_kv_heads=12, d_ff=2048, vocab_size=32000)


def run(cfg, params, device, *, steps: int = 200, batch: int = 8,
        seq: int = 128, ckpt: str = ""):
    """Train `params` (updated in place) for `steps` steps on `device`,
    printing every 20th; returns (the final TrainState, one StepMetrics
    of floats a step)."""
    # MiniCPM-style WSD schedule (survey-adjacent substrate requirement)
    lr = wsd_schedule(3e-3, warmup=20, stable=steps // 2, decay=steps // 3)
    init_state, train_step = make_train_step(cfg, lr)
    state = init_state(params)

    data = lm_batches(cfg, batch, seq, seed=0)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        b = {k: torch.as_tensor(v, device=device)
             for k, v in next(data).items()}
        state, m = train_step(state, b)
        history.append(type(m)(*(float(v) for v in m)))
        if i % 20 == 0 or i == steps - 1:
            h = history[-1]
            print(f"step {i:4d}  ce={h.ce_loss:.4f}  lr={h.lr:.2e}  "
                  f"gnorm={h.grad_norm:.2f}  "
                  f"({(time.perf_counter() - t0):.0f}s)", flush=True)
    if history:
        first, last = history[0].ce_loss, history[-1].ce_loss
        print(f"\nloss: {first:.3f} -> {last:.3f} "
              f"({'DECREASED' if last < first else 'no improvement'})")
    if ckpt:
        save_pytree(state, ckpt)
        print("checkpoint saved to", ckpt)
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--preset", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = preset_config(args.preset)
    params = M.init_params(cfg, seed=0, device=device)
    return run(cfg, params, device, steps=args.steps, batch=args.batch,
               seq=args.seq, ckpt=args.ckpt)


if __name__ == "__main__":
    main()
