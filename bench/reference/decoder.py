"""Plain PyTorch reference of a served decoder with a compressed KV cache.

A pre-norm decoder (RMSNorm, half-split RoPE with f32 angles, grouped-query
attention with optional QKV bias, SwiGLU, a tied or separate head) computed
in float32 with TF32 off, layer by layer over whole sequences, so that only
one layer's weights are ever held in float32.

Each sequence is a prompt followed by the tokens a server emitted for it.
The prompt rows attend causally and exactly, as a prefill does. Every later
row attends to what the server's cache holds at that step, worked out here
from the cache policy alone (`cache_schedule`):

* ``full``: every earlier position, exactly;
* ``kivi2``-style streaming (``bits`` < 16): a main store of ``budget`` rows
  in groups of ``window`` rows, K quantized per channel over a group and V
  per token (asymmetric min/max), plus a ring of the newest ``window``
  rows kept exact. The prompt's selection keeps ``sinks`` first rows and the
  most recent rows before the ring; a full ring is quantized into the next
  free group, or into the group holding the oldest positions once the store
  is full (group 0, with the sinks, is never evicted).

``precision="fp8"`` rounds both inputs of every linear layer to float8
e4m3 (per-row scales for activations, per-column for weights): the lower
precision the benchmark's control runs in. Imports torch and numpy only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

F32 = torch.float32
VOCAB_CHUNK = 32768     # head rows cast to f32 at a time


@dataclass(frozen=True)
class Arch:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool
    tied: bool
    rope_theta: float
    norm_eps: float

    @classmethod
    def from_config(cls, c: dict) -> "Arch":
        """From a benchmark configuration file (Hugging Face key names)."""
        return cls(layers=int(c["num_hidden_layers"]),
                   d_model=int(c["hidden_size"]),
                   heads=int(c["num_attention_heads"]),
                   kv_heads=int(c["num_key_value_heads"]),
                   head_dim=int(c["head_dim"]),
                   d_ff=int(c["intermediate_size"]),
                   vocab=int(c["vocab_size"]),
                   qkv_bias=bool(c["attention_bias"]),
                   tied=bool(c["tie_word_embeddings"]),
                   rope_theta=float(c["rope_theta"]),
                   norm_eps=float(c["rms_norm_eps"]))


@dataclass(frozen=True)
class CachePolicy:
    """What the server's cache keeps: ``bits`` 16 with ``budget`` 0 is the
    uncompressed cache."""
    budget: int = 0
    window: int = 0
    sinks: int = 4
    bits: int = 16


# ---------------------------------------------------------------------------
# Which keys each row sees
# ---------------------------------------------------------------------------


@dataclass
class Schedule:
    """Per sequence: ``groups`` lists the positions quantized together
    (-1: a zero row), and ``visible[t]`` is None for an exact causal row
    (the prompt, or every row of an uncompressed cache) or the pair
    (group indices, first exact position) a decode row sees: those groups
    and the exact positions from that one up to the row itself."""
    groups: List[List[int]]
    visible: List[Optional[tuple]]


def cache_schedule(prompt_len: int, n_rows: int,
                   pol: CachePolicy) -> Schedule:
    """The cache a streaming quantized store holds at each of `n_rows`
    positions (prompt first). Prompt rows and buckets are multiples of
    the group, so groups are wholly valid or wholly empty."""
    vis: List[Optional[tuple]] = [None] * n_rows
    if pol.bits >= 16:
        if pol.budget:
            raise NotImplementedError("eviction without quantization")
        return Schedule([], vis)
    G = W = pol.window
    S = pol.budget
    if S % G or prompt_len % G or prompt_len < W:
        raise ValueError("prompt and budget must be multiples of the group")
    n_groups = S // G
    cand = list(range(pol.sinks, prompt_len - W))
    n_main = min(S, prompt_len - W)
    keep = list(range(min(pol.sinks, prompt_len - W)))
    keep += cand[len(cand) - (n_main - len(keep)):] if n_main > len(keep) \
        else []
    # the selection fills the store in position order; the slots past the
    # valid rows hold the ring's rows and then zero padding
    rows = keep + list(range(prompt_len - W, prompt_len))
    rows += [-1] * max(0, S - len(rows))
    groups = [rows[g * G:(g + 1) * G] for g in range(n_groups)]
    slot_group = list(range(n_groups))          # store slot -> group index
    valid_pos = [max(r) if i < n_main // G else -1
                 for i, r in enumerate(groups)]
    length = n_main
    ring_start = prompt_len - W
    for t in range(prompt_len, n_rows):
        if t - ring_start >= W:                 # a full ring flushes first
            if length // G >= n_groups:
                cands = [g for g in range(1, n_groups) if valid_pos[g] >= 0]
                slot = min(cands, key=lambda g: (valid_pos[g], g))
            else:
                slot = length // G
            groups.append(list(range(ring_start, t)))
            slot_group[slot] = len(groups) - 1
            valid_pos[slot] = t - 1
            length = min(length + W, n_groups * G)
            ring_start = t
        live = [slot_group[s] for s in range(length // G)]
        vis[t] = (live, ring_start)
    return Schedule(groups, vis)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


def _linear(x, w, b, precision: str):
    w = w.to(F32)
    if precision == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    y = x @ w
    return y if b is None else y + b.to(F32)


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.to(F32)


def _rope(x, pos, theta):
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=F32,
                                          device=x.device) / d))
    ang = (pos[:, None].to(F32) * freqs)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _quant_groups(x_rows: torch.Tensor, bits: int, dims) -> torch.Tensor:
    """Asymmetric min/max quantize-dequantize reducing over `dims`."""
    lo = x_rows.amin(dim=dims, keepdim=True)
    hi = x_rows.amax(dim=dims, keepdim=True)
    levels = (1 << bits) - 1
    scale = torch.clamp(hi - lo, min=1e-8) / levels
    q = torch.clamp(torch.round((x_rows - lo) / scale), 0, levels)
    return q * scale + lo


def _mask(T: int, sched: Schedule, G: int, device) -> torch.Tensor:
    """Visibility [T, R] over [quantized groups | exact rows] of one
    sequence, made on the host once and shared by every layer."""
    nq = len(sched.groups) * G
    m = np.zeros((T, nq + T), dtype=bool)
    m[:, nq:] = np.tri(T, dtype=bool)                         # causal
    for t, vis in enumerate(sched.visible):
        if vis is None:
            continue
        live, ring0 = vis
        m[t, nq:nq + ring0] = False
        for g in live:
            m[t, g * G:(g + 1) * G] = True
    return torch.from_numpy(m).to(device)


def _keys(k, v, sched: Schedule, pol: CachePolicy):
    """Keys [R, Hkv, D] and values of one sequence: its quantized groups
    (K per channel over a group, V per token and head), then the exact
    rows."""
    if not sched.groups:
        return k, v
    idx = torch.tensor(sched.groups, device=k.device)          # [NG, G]
    zero = (idx < 0)[..., None, None]
    kg = k[idx.clamp(min=0)].masked_fill(zero, 0.0)
    vg = v[idx.clamp(min=0)].masked_fill(zero, 0.0)
    kg = _quant_groups(kg, pol.bits, dims=(1,))
    vg = _quant_groups(vg, pol.bits, dims=(-1,))
    return torch.cat([kg.flatten(0, 1), k]), torch.cat([vg.flatten(0, 1), v])


def _attend(q, kk, vv, mask, q_chunk: int = 256):
    """q [T, Hq, D] over keys [R, Hkv, D] where `mask` [T, R] allows."""
    T, Hq, D = q.shape
    Hkv = kk.shape[1]
    g = Hq // Hkv
    kh = kk.permute(1, 0, 2)                                   # [Hkv, R, D]
    vh = vv.permute(1, 0, 2)
    out = torch.empty_like(q)
    for c0 in range(0, T, q_chunk):
        c1 = min(c0 + q_chunk, T)
        qh = q[c0:c1].reshape(c1 - c0, Hkv, g, D).permute(1, 2, 0, 3)
        s = torch.einsum("hgtd,hrd->hgtr", qh, kh) / math.sqrt(D)
        s = s.masked_fill(~mask[c0:c1], float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("hgtr,hrd->hgtd", p, vh)
        out[c0:c1] = o.permute(2, 0, 1, 3).reshape(c1 - c0, Hq, D)
    return out


# ---------------------------------------------------------------------------
# The forward pass
# ---------------------------------------------------------------------------


def logits_of(arch: Arch, weights: Dict, seqs: Sequence[Sequence[int]],
              prompt_lens: Sequence[int], pol: CachePolicy, *,
              precision: str = "f32") -> List[torch.Tensor]:
    """For each sequence (prompt + emitted tokens but the last), the f32
    logits [n_emitted, vocab] of the rows that predict the emitted tokens:
    the prompt's last row, then each decode row.

    `weights`: ``embed`` [V, d]; ``final_norm`` [d]; ``head`` [d, V] or
    None (tied); ``layers``: per layer a dict of ``norm1``, ``norm2``,
    ``wq``, ``wk``, ``wv``, ``wo``, ``gate``, ``up``, ``down`` ([d_in,
    d_out], applied as ``x @ w``) and ``bq``, ``bk``, ``bv`` or None.
    Any dtype, on one device; each layer is cast to f32 as it is used."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_of(arch, weights, seqs, prompt_lens, pol, precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _logits_of(arch, weights, seqs, prompt_lens, pol, precision):
    dev = weights["embed"].device
    toks = [torch.as_tensor(list(s), dtype=torch.long, device=dev)
            for s in seqs]
    lens = [t.shape[0] for t in toks]
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + n)
    x = weights["embed"][torch.cat(toks)].to(F32)
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    scheds = [cache_schedule(int(p), n, pol)
              for p, n in zip(prompt_lens, lens)]
    Hq, Hkv, D = arch.heads, arch.kv_heads, arch.head_dim
    masks = [_mask(n, sc, pol.window, dev) for n, sc in zip(lens, scheds)]
    for lw in weights["layers"]:
        h = _rmsnorm(x, lw["norm1"], arch.norm_eps)
        q = _linear(h, lw["wq"], lw.get("bq"), precision).view(-1, Hq, D)
        k = _linear(h, lw["wk"], lw.get("bk"), precision).view(-1, Hkv, D)
        v = _linear(h, lw["wv"], lw.get("bv"), precision).view(-1, Hkv, D)
        q = _rope(q, pos, arch.rope_theta)
        k = _rope(k, pos, arch.rope_theta)
        o = torch.empty_like(q)
        for i, sc in enumerate(scheds):
            a, b = offs[i], offs[i + 1]
            kk, vv = _keys(k[a:b], v[a:b], sc, pol)
            o[a:b] = _attend(q[a:b], kk, vv, masks[i])
        x = x + _linear(o.reshape(-1, Hq * D), lw["wo"], None, precision)
        h = _rmsnorm(x, lw["norm2"], arch.norm_eps)
        g = _linear(h, lw["gate"], None, precision)
        u = _linear(h, lw["up"], None, precision)
        x = x + _linear(torch.nn.functional.silu(g) * u, lw["down"], None,
                        precision)
        del h, q, k, v, o, g, u
    rows = torch.cat([torch.arange(offs[i] + p - 1, offs[i + 1])
                      for i, p in enumerate(prompt_lens)]).to(dev)
    xf = _rmsnorm(x[rows], weights["final_norm"], arch.norm_eps)
    if precision == "fp8":
        xf = _fp8(xf, -1)
    outs = []
    for v0 in range(0, arch.vocab, VOCAB_CHUNK):
        v1 = min(v0 + VOCAB_CHUNK, arch.vocab)
        w = (weights["embed"][v0:v1].to(F32).T if weights.get("head") is None
             else weights["head"][:, v0:v1].to(F32))
        if precision == "fp8":
            w = _fp8(w, 0)
        outs.append(xf @ w)
    logits = torch.cat(outs, dim=1)
    res, r0 = [], 0
    for i, p in enumerate(prompt_lens):
        n = lens[i] - p + 1
        res.append(logits[r0:r0 + n])
        r0 += n
    return res


def row_gaps(ref_logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """Per row, the gap by which the emitted token's reference logit lies
    below the reference's best."""
    t = torch.as_tensor(list(tokens), dtype=torch.long,
                        device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, t[:, None])[:, 0]

