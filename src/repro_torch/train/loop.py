"""Training loop (counterpart of `repro.train.loop`): next-token CE plus
the MoE aux losses, gradient clipping, AdamW.

`make_train_step` builds the step function; `launch/train.py` runs it.
Gradients come from `torch.autograd` through `nn.model.train_forward`,
which launches no CUDA kernel (the kernels have no backward). On
DTensor params (`launch/train.py --mesh host`) the same step runs
sharded: the gradients come back placed like the params, and the
in-place AdamW updates each rank's shards.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.nn import model as M
from repro_torch.nn import sharding as shd
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import (adamw_step_, clip_scale,
                                          global_norm, tree_leaves, tree_map)


class TrainState(NamedTuple):
    params: Any
    opt: Any              # optim.AdamState
    step: torch.Tensor    # 0-dim int32


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    ce_loss: torch.Tensor
    lb_loss: torch.Tensor
    z_loss: torch.Tensor
    grad_norm: torch.Tensor
    lr: torch.Tensor


def loss_fn(params, cfg, batch: dict):
    """Next-token CE over batch["tokens"] (last-dim shift), in f32;
    returns (loss, (ce, aux))."""
    tokens = batch["tokens"]
    inputs = {**batch, "tokens": tokens[:, :-1]}
    logits, aux = M.train_forward(params, cfg, inputs)       # [B, S-1, V]
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, targets[..., None])[..., 0].mean()
    total = ce
    if cfg.is_moe:
        total = (total + cfg.moe.router_aux_coef * aux.lb_loss
                 + cfg.moe.router_z_coef * aux.z_loss)
    return total, (ce, aux)


def value_and_grad(params, cfg, batch: dict):
    """((loss, (ce, aux)), grads) of `loss_fn`, grads in each leaf's
    dtype (a leaf the loss does not reach gets zeros, as JAX's grad
    gives)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, (ce, aux) = loss_fn(live, cfg, batch)
    leaves = tree_leaves(live)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, gs))
    grads = tree_map(lambda _: next(it), live)
    aux = M.TrainAux(*(a.detach() for a in aux))
    return (loss.detach(), (ce.detach(), aux)), grads


def make_train_step(cfg, lr_schedule: Callable, *, max_grad_norm: float = 1.0,
                    b1: float = 0.9, b2: float = 0.95,
                    weight_decay: float = 0.1):
    """(init_state, train_step). `train_step(state, batch)` returns (the
    next TrainState, StepMetrics) and donates `state`, as the JAX
    launcher's jit donates its argument: the params and moments are
    updated in place (`optim.adamw_step_`, JAX's clip + AdamW + apply
    numbers), so one step holds one copy of the state."""
    opt_init, _ = adamw(b1, b2, weight_decay=weight_decay)

    def init_state(params) -> TrainState:
        opt = opt_init(params)
        return TrainState(params, opt, torch.zeros_like(opt.step))

    @shd.replicates_plain
    def train_step(state: TrainState, batch: dict):
        (loss, (ce, aux)), grads = value_and_grad(state.params, cfg, batch)
        gn = global_norm(grads)
        lr = lr_schedule(state.step)
        opt = adamw_step_(state.params, grads, state.opt, lr,
                          grad_scale=clip_scale(gn, max_grad_norm), b1=b1,
                          b2=b2, weight_decay=weight_decay)
        metrics = StepMetrics(loss, ce, aux.lb_loss, aux.z_loss, gn, lr)
        return TrainState(state.params, opt, state.step + 1), metrics

    return init_state, train_step
