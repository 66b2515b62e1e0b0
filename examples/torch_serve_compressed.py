"""End-to-end serving script of the PyTorch / CUDA port (the twin of
`examples/serve_compressed.py`): batched requests through the wave
engine under every preset policy; prints the survey's Tables 1-3 axes
live. Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_compressed.py \\
        --policies h2o,kivi2 [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.policy import presets
from repro_torch.nn import model as M
from repro_torch.serving.engine import Engine

DEFAULT_POLICIES = "full,streaming,h2o,nacl,kivi4,kivi2,h2o+kivi2,pyramid"


def run(cfg, params, device, *, arch: str = "paper-llama-7b",
        policies: str = DEFAULT_POLICIES, requests: int = 8,
        prompt_len: int = 256, max_new: int = 16, budget: int = 64) -> dict:
    """Serve `requests` seeded prompts under each of `policies` (comma
    separated) on `device` and print one row a policy; returns {policy:
    GenerationResult}."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(requests, prompt_len)).astype(np.int32)
    src = None
    if cfg.is_encoder_decoder:
        src = rng.standard_normal(
            (requests, max(prompt_len // 4, 16), cfg.d_model)
        ).astype(np.float32)

    ps = presets(budget=budget, window=16, sinks=4)
    print(f"arch={arch} (reduced) requests={requests} "
          f"prompt={prompt_len} new={max_new}")
    print(f"{'policy':<12} {'family':<10} {'ratio':>6} {'prefill_s':>9} "
          f"{'tok/s':>8}")
    out = {}
    for name in policies.split(","):
        pol = ps[name]
        eng = Engine(cfg, params, pol, prompt_len=prompt_len,
                     max_new=max_new, slots=4, device=device)
        res = eng.generate(prompts, src_embeds=src)
        print(f"{name:<12} {pol.family:<10} {res.compression_ratio:>5.1f}x "
              f"{res.prefill_seconds:>9.2f} {res.decode_tokens_per_s:>8.1f}")
        out[name] = res
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-llama-7b")
    ap.add_argument("--policies", default=DEFAULT_POLICIES)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch), num_layers=4)
    params = M.init_params(cfg, seed=0, device=device)
    return run(cfg, params, device, arch=args.arch, policies=args.policies,
               requests=args.requests, prompt_len=args.prompt_len,
               max_new=args.max_new, budget=args.budget)


if __name__ == "__main__":
    main()
