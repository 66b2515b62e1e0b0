"""Quickstart of the PyTorch / CUDA port: the survey's subject in 60
seconds (the twin of `examples/quickstart.py`).

Builds a small LLaMa-family model, serves the same prompts under four
cache policies (full / H2O eviction / KIVI 2-bit / hybrid), and prints
the survey's comparison axes: compression ratio, decode speed, agreement.
Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.policy import presets
from repro_torch.nn import model as M
from repro_torch.serving.engine import Engine

POLICIES = ("full", "h2o", "kivi2", "h2o+kivi2")


def run(cfg, params, device) -> dict:
    """Serve the quickstart's prompts under each of POLICIES on `device`
    and print one row a policy; returns {policy: GenerationResult}."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 128)).astype(np.int32)

    ps = presets(budget=48, window=16, sinks=4)
    out = {}
    ref_tokens = None
    print(f"{'policy':<12} {'ratio':>6} {'tok/s':>8} {'free-run agree':>14}")
    for name in POLICIES:
        eng = Engine(cfg, params, ps[name], prompt_len=128, max_new=16,
                     slots=4, device=device)
        res = eng.generate(prompts)
        if ref_tokens is None:
            ref_tokens = res.tokens
        agree = float((res.tokens == ref_tokens).mean())
        print(f"{name:<12} {res.compression_ratio:>5.1f}x "
              f"{res.decode_tokens_per_s:>8.1f} {agree:>14.2f}")
        out[name] = res
    print("\nnotes: free-running trajectories diverge chaotically on an "
          "untrained model — see benchmarks/ for teacher-forced quality; "
          "on the card decode attention runs the port's CUDA kernels "
          "(KIVI codes dequantized inside the decode kernel), on the CPU "
          "their plain PyTorch versions.")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced(get_config("paper-llama-7b"), num_layers=4)
    params = M.init_params(cfg, seed=0, device=device)
    return run(cfg, params, device)


if __name__ == "__main__":
    main()
