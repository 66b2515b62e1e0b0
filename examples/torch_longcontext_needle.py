"""Needle-in-a-Haystack vs cache budget in the PyTorch / CUDA port (the
survey's Table 1 quality benchmark; the twin of
`examples/longcontext_needle.py`). A tiny model is first trained briefly
on the synthetic stream (so attention is meaningful), then we check
whether greedy decode can reproduce a needle planted at several depths
as the cache budget shrinks. Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_longcontext_needle.py \\
        --train-steps 60 [--device cpu]
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.cache import CacheSpec
from repro_torch.data.synthetic import lm_batches, needle_prompt
from repro_torch.nn import model as M
from repro_torch.optim import cosine_schedule
from repro_torch.train.loop import make_train_step

DEPTHS = (0.2, 0.8)


def tiny_config():
    return reduced(get_config("paper-llama-7b"), num_layers=4, d_model=256,
                   num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512)


def train(cfg, params, device, steps: int):
    """`steps` AdamW steps (cosine, peak 3e-3) on 8 x 128-token batches of
    the synthetic stream; updates `params` in place and returns (params,
    the last step's ce, or None for no step)."""
    init_state, step = make_train_step(cfg, cosine_schedule(3e-3, 10, 200))
    state = init_state(params)
    data = lm_batches(cfg, 8, 128, seed=0)
    ce = None
    for _ in range(steps):
        state, m = step(state, {k: torch.as_tensor(v, device=device)
                                for k, v in next(data).items()})
        ce = float(m.ce_loss)
    return state.params, ce


def copy_accuracy(cfg, params, spec, prompt, value, layer_budgets=None):
    """Greedy-decode len(value) tokens after the final MARKER; a model with
    the needle in cache should echo it (copy induction is learnable from
    the Markov stream's repetition)."""
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    toks = torch.as_tensor(prompt, device=leaf.device)[None]
    with torch.no_grad():
        lg, cache = M.prefill(params, cfg, {"tokens": toks}, spec,
                              layer_budgets=layer_budgets)
        hits = 0
        tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
        for i in range(len(value)):
            hits += int(tok[0, 0]) == int(value[i])
            lg, cache = M.decode_step(params, cfg, cache, tok, spec)
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
    return hits / len(value)


def run(cfg, params, device, *, length: int = 256) -> dict:
    """The accuracy table on `device`: one row per (policy, budget),
    printed; returns {(policy, budget, depth): accuracy}."""
    L = length
    table = {}
    print(f"{'policy/budget':<22} {'depth=0.2':>9} {'depth=0.8':>9}")
    for name, budget in [("full", 0), ("h2o", L // 2), ("h2o", L // 4),
                         ("streaming", L // 4)]:
        if budget == 0:
            spec = CacheSpec(budget=L + 16, policy="none")
        else:
            spec = CacheSpec(budget=budget, window=16, sinks=4, policy=name,
                             group=16, recent_protect=16)
        accs = []
        for depth in DEPTHS:
            prompt, value, marker = needle_prompt(cfg.vocab_size, L,
                                                  depth=depth, seed=3)
            accs.append(copy_accuracy(cfg, params, spec, prompt, value))
            table[(name, budget or L + 16, depth)] = accs[-1]
        tag = f"{name}@{budget or L + 16}"
        print(f"{tag:<22} {accs[0]:>9.2f} {accs[1]:>9.2f}")
    return table


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = tiny_config()
    params = M.init_params(cfg, seed=0, device=device)
    params, ce = train(cfg, params, device, args.train_steps)
    print(f"trained {args.train_steps} steps, ce={ce:.3f}")
    return run(cfg, params, device, length=args.length)


if __name__ == "__main__":
    main()
