"""Random weights drawn on the device from the run's seed.

The benchmark makes the weights itself, in the port's parameter layout
(the tree `repro_torch.nn.model.init_params` builds on the "meta" device
gives the shapes and dtypes), one draw per stacked leaf with a
`torch.Generator` on the device, in the dtype they are served in:
weights normal(0, 1/fan_in), norm scales 1 + normal(0, 0.1), biases
normal(0, 0.1). `reference_view` hands the same tensors to the reference,
per layer, under plain names.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def _leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def draw(cfg, seed: int, device, params: Optional[dict] = None) -> dict:
    """The parameter tree of `cfg` drawn from `seed` on `device`; with
    `params`, drawn into those tensors in place (same tree)."""
    from repro_torch.nn import model as M
    shapes = M.init_params(cfg, device="meta")
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    out: dict = {} if params is None else params
    for path, meta in _leaves(shapes):
        if params is None:
            t = torch.empty(meta.shape, dtype=meta.dtype, device=device)
            _set(out, path, t)
        else:
            t = params
            for k in path:
                t = t[k]
        leaf = path[-1]
        torch.randn(t.shape, generator=g, dtype=t.dtype, device=device,
                    out=t)
        if leaf == "scale":
            t.mul_(0.1).add_(1.0)
        elif leaf == "b":
            t.mul_(0.1)
        elif leaf in ("w", "table"):
            fan_in = t.shape[-1] if leaf == "table" else t.shape[-2]
            t.mul_(1.0 / math.sqrt(fan_in))
        else:
            raise ValueError(f"no draw rule for leaf {'/'.join(path)}")
    return out


def reference_view(params: dict, n_layers: int) -> Dict:
    """The same tensors as the reference reads them (views, no copies)."""
    b = params["blocks"]["sub0"]
    a, m = b["attn"], b["mlp"]
    if "b" in a["wo"] or any("b" in m[k] for k in m):
        raise NotImplementedError("the reference has no output or MLP bias")

    def bias(p, i):
        return p["b"][i] if "b" in p else None

    layers = [dict(norm1=b["norm1"]["scale"][i], norm2=b["norm2"]["scale"][i],
                   wq=a["wq"]["w"][i], wk=a["wk"]["w"][i], wv=a["wv"]["w"][i],
                   wo=a["wo"]["w"][i], bq=bias(a["wq"], i),
                   bk=bias(a["wk"], i), bv=bias(a["wv"], i),
                   gate=m["gate"]["w"][i], up=m["up"]["w"][i],
                   down=m["down"]["w"][i])
              for i in range(n_layers)]
    head = params.get("head")
    return dict(embed=params["embed"]["table"],
                final_norm=params["final_norm"]["scale"],
                head=None if head is None else head["w"], layers=layers)
