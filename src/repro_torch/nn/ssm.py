"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) mixer
(counterpart of `repro.nn.ssm`).

The chunked dual form serves prefill (quadratic within a chunk, a linear
recurrence across chunks) and the O(1)-state recurrent step serves
decode. The decode state (`core.cache.SSMState`) is the attention-free
analogue of the KV cache: constant in sequence length.

The SSD is plain PyTorch (einsum and elementwise ops, f32 inside), as it
is plain JAX in the reference: no TPU kernel lies on this path. A Python
loop over the chunks takes the place of `lax.scan`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.cache import SSMState
from repro_torch.nn import layers as L

f32 = torch.float32


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state


def ssm_shapes(cfg) -> dict:
    """`nn.model.init_params` leaf specs ``(shape, init[, dtype])`` of one
    mixer, the JAX `ssm_init` tree. `init` is a fan-in (normal /
    sqrt(fan_in)), 0 (zeros), -1 (ones), or "a_log" / "dt_bias" for the
    JAX scheme's two f32 vectors: A_log = log(1..H), and dt_bias the
    inverse softplus of a log-uniform draw in [dt_min, dt_max]."""
    d_in = cfg.d_inner
    G, N, H = cfg.ssm.n_groups, cfg.ssm.d_state, cfg.ssm_heads
    cdim = conv_dim(cfg)
    d_proj = 2 * d_in + 2 * G * N + H   # z, x, B, C, dt
    return {
        "in_proj": {"w": ((cfg.d_model, d_proj), cfg.d_model)},
        "conv_w": ((cfg.ssm.d_conv, cdim), cfg.ssm.d_conv),
        "conv_b": ((cdim,), 0),
        "A_log": ((H,), "a_log", f32),
        "D": ((H,), -1, f32),
        "dt_bias": ((H,), "dt_bias", f32),
        "norm": {"scale": ((d_in,), -1)},
        "out_proj": {"w": ((d_in, cfg.d_model), d_in)},
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0), without torch's threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _split_proj(cfg, proj: torch.Tensor):
    d_in = cfg.d_inner
    G, N = cfg.ssm.n_groups, cfg.ssm.d_state
    return torch.split(proj, [d_in, d_in + 2 * G * N,
                              proj.shape[-1] - 2 * d_in - 2 * G * N], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None):
    """xBC: [B, T, C]; depthwise causal conv of width K = w.shape[0],
    accumulated in f32 tap by tap. Returns (activated output [B, T, C],
    final conv state [B, K-1, C]: the last K-1 inputs)."""
    Bsz, T, C = xBC.shape
    K = w.shape[0]
    if init_state is None:
        init_state = xBC.new_zeros((Bsz, K - 1, C))
    xp = torch.cat([init_state.to(xBC.dtype), xBC], dim=1)  # [B, T+K-1, C]
    out = torch.zeros((Bsz, T, C), dtype=f32, device=xBC.device)
    for i in range(K):  # K is tiny (4): unrolled taps
        out = out + xp[:, i:i + T].float() * w[i].float()
    out = out + b.float()
    return F.silu(out).to(xBC.dtype), xp[:, T:]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_: torch.Tensor, C_: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """SSD dual form.

    x: [B, T, H, P]; dt: [B, T, H] (post-softplus); A: [H] (negative);
    B_, C_: [B, T, G, N] (groups broadcast over heads). T is zero-padded
    to a whole number of chunks (dt = 0 at a padded step is a no-op).
    Returns (y [B, T, H, P] f32, final_state [B, H, P, N] f32)."""
    Bsz, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    T_orig = T
    if T % chunk:
        pad = chunk - T % chunk

        def padt(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        x, dt, B_, C_ = padt(x), padt(dt), padt(B_), padt(C_)
        T = T + pad
    n = T // chunk

    Bh = torch.repeat_interleave(B_, rep, dim=2)             # [B, T, H, N]
    Ch = torch.repeat_interleave(C_, rep, dim=2)

    def r(t):  # chunkify: [B, T, ...] -> [B, n, L, ...]
        return t.reshape(Bsz, n, chunk, *t.shape[2:])

    xc, dtc, Bc, Cc = r(x).float(), r(dt), r(Bh).float(), r(Ch).float()
    a = dtc * A[None, None, None, :]                         # [B, n, L, H]
    cum = torch.cumsum(a, dim=2)                             # within chunk

    # intra-chunk (the dual, attention-like form)
    li = torch.arange(chunk, device=x.device)
    causal = li[:, None] >= li[None, :]                      # [L, L]
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    decay = torch.where(causal[None, None, :, :, None], decay, 0.0)
    cb = torch.einsum("bclhn,bcshn->bclsh", Cc, Bc)          # [B,c,L,S,H]
    att = cb * decay * dtc[:, :, None, :, :]                 # weight dt[s]
    del decay, cb
    y_intra = torch.einsum("bclsh,bcshp->bclhp", att, xc)
    del att

    # per-chunk state contribution: sum_s exp(cum_L - cum_s) dt_s B_s x_s
    tail = torch.exp(cum[:, :, -1:, :] - cum)                # [B, c, L, H]
    sc = torch.einsum("bclhn,bclhp->bchpn",
                      (tail * dtc).float()[..., None] * Bc, xc)

    # inter-chunk recurrence: the state *before* each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])                # [B, n, H]
    s = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.float())
    prev = []
    for c in range(n):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + sc[:, c]
    prev = torch.stack(prev, dim=1)                          # [B, n, H, P, N]

    y_inter = torch.einsum("bclhn,bchpn->bclhp",
                           Cc * torch.exp(cum)[..., None], prev)
    y = (y_intra + y_inter).reshape(Bsz, T, H, P)[:, :T_orig]
    return y, s


def mamba2_forward(p: dict, x: torch.Tensor, cfg,
                   state: Optional[SSMState] = None):
    """Full-sequence mixer (prefill). x: [B, T, d_model].
    Returns (out [B, T, d_model], final SSMState)."""
    Bsz, T, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm.head_dim
    G, N = cfg.ssm.n_groups, cfg.ssm.d_state
    z, xBC, dt = _split_proj(cfg, L.linear(p["in_proj"], x))
    conv_init = state.conv if state is not None else None
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_init)
    xs, B_, C_ = torch.split(xBC, [cfg.d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(Bsz, T, H, P)
    B_ = B_.reshape(Bsz, T, G, N)
    C_ = C_.reshape(Bsz, T, G, N)
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, fin = ssd_chunked(xs, dt, A, B_, C_, min(cfg.ssm.chunk_size, T),
                         init_state=state.state if state is not None
                         else None)
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(Bsz, T, cfg.d_inner).to(x.dtype)
    y = L.rmsnorm(p["norm"], y * F.silu(z.float()).to(z.dtype),
                  cfg.norm_eps)
    return L.linear(p["out_proj"], y), SSMState(conv=conv_state, state=fin)


def mamba2_decode_step(p: dict, x: torch.Tensor, state: SSMState, cfg):
    """One-token recurrent step. x: [B, 1, d_model] -> (out [B, 1,
    d_model], new SSMState); `state` is not written."""
    Bsz = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm.head_dim
    G, N = cfg.ssm.n_groups, cfg.ssm.d_state
    z, xBC, dt = _split_proj(cfg, L.linear(p["in_proj"], x[:, 0]))

    # the conv window: state.conv holds the last K-1 inputs
    win = torch.cat([state.conv, xBC[:, None].to(state.conv.dtype)], dim=1)
    conv_out = (torch.einsum("bkc,kc->bc", win.float(), p["conv_w"].float())
                + p["conv_b"].float())
    xBC_t = F.silu(conv_out).to(x.dtype)

    xs, B_, C_ = torch.split(xBC_t, [cfg.d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(Bsz, H, P)
    B_ = torch.repeat_interleave(B_.reshape(Bsz, G, N), H // G, dim=1)
    C_ = torch.repeat_interleave(C_.reshape(Bsz, G, N), H // G, dim=1)
    dt = _softplus(dt.float() + p["dt_bias"])                    # [B, H]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])                              # [B, H]
    s = state.state * dA[:, :, None, None] + torch.einsum(
        "bhn,bhp->bhpn", dt[:, :, None] * B_.float(), xs.float())
    y = torch.einsum("bhn,bhpn->bhp", C_.float(), s)
    y = y + xs.float() * p["D"][None, :, None]
    y = y.reshape(Bsz, cfg.d_inner).to(x.dtype)
    y = L.rmsnorm(p["norm"], y * F.silu(z.float()).to(z.dtype),
                  cfg.norm_eps)
    return L.linear(p["out_proj"], y)[:, None], SSMState(win[:, 1:], s)
