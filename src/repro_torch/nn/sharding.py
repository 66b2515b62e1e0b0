"""Parameter / activation / cache partition rules on DTensor (counterpart
of `repro.nn.sharding`).

Two logical axes:
  * ``fsdp`` — parameter shards over the data(-and-pod) mesh axes
    (fully-sharded data parallel);
  * ``tp``   — tensor parallel over the "model" mesh axis (attention heads
    via the fused head*dim projection dim, FFN hidden, experts, vocab).

The rules are data: a spec (`PSpec`) is a tuple with one entry per tensor
dim — None, a mesh axis name, or a tuple of axis names — with
`jax.sharding.PartitionSpec`'s meaning, so the spec trees here equal the
JAX package's entry for entry. Rules match on parameter *path names*
(``blocks/sub0/attn/wq/w``, JAX's rendering), then are left-padded with
None for stacked leading dims (superblock / encoder-layer stacks). An
axis that does not divide its dim is dropped (`fit_spec`: the dim is
replicated, as the JAX package's explicit input shardings require).

The rule functions take anything with axis names and sizes: a
`torch.distributed.device_mesh.DeviceMesh`, or a `MeshShape` (names and
sizes only, no process group: the spec tests and the dry run's
bookkeeping). `to_placements` turns a spec into DTensor placements in
mesh-dim order, and `distribute_tree` places a tree of tensors by a tree
of specs; DTensor's sharding propagation then inserts the collectives
that GSPMD inserts in the JAX package.
"""
from __future__ import annotations

import functools
import math
import re
from contextlib import contextmanager
from typing import Any, NamedTuple

import torch

PSpec = tuple


class MeshShape(NamedTuple):
    """Axis names and sizes of a mesh, without devices or a process
    group (the counterpart of `jax.sharding.AbstractMesh`)."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def _names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _sizes(mesh) -> dict:
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(_names(mesh), mesh.shape))


# ---------------------------------------------------------------------------
# Activation-sharding context: when active, the model redistributes
# DTensor activations / weights at known-hot points. Inactive (the
# default) every hook returns its input untouched.
#
# Options (the JAX package's):
#   kv_replicated  — replicate K/V over the tp axis after projection
#   weight_gather  — gather fsdp-sharded weights at use (ZeRO-3)
#   seq_tp_cache   — decode: shard the cache length over the tp axis
#   moe_ep_dispatch — pin the MoE expert buffer to the tp axis
#   pure_fsdp / params_tp_only / cache_dp_only / kivi{2,4}_cache — layouts
# ---------------------------------------------------------------------------

_ACTIVE: dict | None = None


class activation_sharding:
    def __init__(self, mesh, opts=frozenset()):
        self.ctx = {"mesh": mesh, "opts": frozenset(opts)}

    def __enter__(self):
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self.ctx
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev


def opt_enabled(name: str) -> bool:
    return _ACTIVE is not None and name in _ACTIVE["opts"]


def tp_divides(n: int) -> bool:
    if _ACTIVE is None:
        return False
    _, tp = mesh_axes(_ACTIVE["mesh"])
    return n % axis_size(_ACTIVE["mesh"], tp) == 0


def constrain(x, *entries):
    """Redistribute a DTensor `x` to the placements of the logical spec
    `entries` ("fsdp" | "tp" | None; axes that do not divide are
    dropped) on the active mesh. A plain tensor, or any tensor with no
    context active, comes back untouched."""
    if _ACTIVE is None:
        return x
    return place(x, *entries)


def place(x, *entries):
    """Redistribute a DTensor `x` to the logical spec `entries` ("fsdp" |
    "tp" | None; axes that do not divide are dropped) on its own mesh,
    with or without an activation context; a plain tensor passes."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    fsdp, tp = mesh_axes(mesh)
    resolved = tuple(fsdp if e == "fsdp" else tp if e == "tp" else e
                     for e in entries)
    pl = to_placements(fit_spec(resolved, x.shape, mesh), mesh)
    return x if pl == tuple(x.placements) else x.redistribute(mesh, pl)


def mesh_axes(mesh):
    """Returns (fsdp_axes, tp_axis) given a production mesh."""
    if "pod" in _names(mesh):
        return (("pod", "data"), "model")
    return (("data",), "model")


# rule: (path regex, spec for the *trailing* dims of the leaf)
def _rules(fsdp, tp, expert_axis_tp: bool):
    F, T = fsdp, tp
    return [
        (r"embed/table$", (T, F)),
        (r"head/w$", (F, T)),
        (r"moe/router$", (F, None)),
        (r"moe/(gate|up)$", (T, F, None) if expert_axis_tp else (None, F, T)),
        (r"moe/down$", (T, None, F) if expert_axis_tp else (None, T, F)),
        (r"(wq|wk|wv)/w$", (F, T)),
        (r"(wq|wk|wv)/b$", (T,)),
        (r"wo/w$", (T, F)),
        (r"wo/b$", (F,)),
        (r"mlp/(gate|up)/w$", (F, T)),
        (r"mlp/(gate|up)/b$", (T,)),
        (r"mlp/down/w$", (T, F)),
        (r"mlp/down/b$", (F,)),
        (r"ssm/in_proj/w$", (F, T)),
        (r"ssm/out_proj/w$", (T, F)),
        (r"ssm/conv_w$", (None, T)),
        (r"ssm/conv_b$", (T,)),
        (r"ssm/norm/scale$", (T,)),
        (r"ssm/(A_log|D|dt_bias)$", (None,)),
        (r"norm\w*/(scale|bias)$", (None,)),
    ]


def axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(entry, (tuple, list)):
        n = 1
        for e in entry:
            n *= sizes[e]
        return n
    return sizes[entry]


def fit_spec(spec: PSpec, shape, mesh) -> PSpec:
    """Drop spec axes that do not divide the corresponding dim evenly
    (those dims are replicated instead)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(entry if dim % axis_size(mesh, entry) == 0 else None
                 for dim, entry in zip(shape, entries))


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def tree_map_with_path(fn, tree, path=()):
    """fn(path, leaf) over a nested dict (keys in sorted order, the JAX
    leaf order); `path` is the tuple of keys."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    return fn(path, tree)


def param_pspecs(params: Any, cfg, mesh) -> Any:
    """Spec tree matching `params` (leaves: anything with `.ndim` and
    `.shape` — tensors, meta tensors)."""
    fsdp, tp = mesh_axes(mesh)
    if opt_enabled("pure_fsdp"):
        # ZeRO-3 layout: every mesh axis is data-parallel; params shard
        # over all of them on their fsdp dim, no tensor parallelism
        fsdp = tuple(fsdp) + ((tp,) if isinstance(tp, str) else tuple(tp))
        tp = None
    tp_size = axis_size(mesh, tp)
    expert_axis_tp = cfg.is_moe and cfg.moe.num_experts % tp_size == 0
    rules = _rules(fsdp, tp, expert_axis_tp)
    # serving layout: replicate over the fsdp axes — decode must not
    # all-gather FSDP'd params every step
    tp_only = opt_enabled("params_tp_only")

    def spec_for(path, leaf):
        ps = _path_str(path)
        for pat, trailing in rules:
            if re.search(pat, ps):
                pad = leaf.ndim - len(trailing)
                assert pad >= 0, (ps, leaf.shape, trailing)
                t = tuple(None if (tp_only and e == fsdp) else e
                          for e in trailing)
                return fit_spec((None,) * pad + t, leaf.shape, mesh)
        return ()    # default: replicate (small tensors)

    return tree_map_with_path(spec_for, params)


# ---------------------------------------------------------------------------
# Activation / cache specs
# ---------------------------------------------------------------------------


def batch_spec(mesh) -> PSpec:
    fsdp, _ = mesh_axes(mesh)
    return (fsdp,)  # batch over ("pod","data") / ("data",)


def cache_pspecs(cache: Any, mesh, *, shard_seq: bool = False,
                 seq_tp: bool = False, dp_only: bool = False) -> Any:
    """Spec tree for a `ModelCache` (dense `LayerKV`, `SSMState`, cross
    memory).

    Default: batch over the fsdp axes, kv-heads over tp.
    ``shard_seq=True`` (long-context decode, batch 1): the cache length
    shards over "data" instead, and batch is replicated. ``seq_tp=True``:
    cache length shards over the tp axis (batch stays on fsdp).
    ``dp_only``: no tp sharding of a budgeted cache at all."""
    from repro_torch.core.cache import LayerKV, SSMState
    from repro_torch.nn.model import ModelCache

    fsdp, tp = mesh_axes(mesh)
    b = None if shard_seq else fsdp       # batch axis sharding
    s = tp if seq_tp else ("data" if shard_seq else None)
    if dp_only:
        s = None
    tp_size = axis_size(mesh, tp)

    def kv_hd(n_heads: int):
        """Shard kv-heads over tp when divisible, else head_dim."""
        if seq_tp or dp_only:
            return (None, None)
        return (tp, None) if n_heads % tp_size == 0 else (None, tp)

    def layerkv_specs(lk: LayerKV, nlead: int) -> LayerKV:
        pre = (None,) * nlead
        h, d = kv_hd(lk.k.shape[nlead + 2])

        def mk(leaf, *rest):
            return fit_spec((*pre, *rest), leaf.shape, mesh)

        return LayerKV(
            k=mk(lk.k, b, s, h, d), v=mk(lk.v, b, s, h, d),
            k_scale=mk(lk.k_scale, b, s, h, d),
            k_zero=mk(lk.k_zero, b, s, h, d),
            v_scale=mk(lk.v_scale, b, s, h), v_zero=mk(lk.v_zero, b, s, h),
            rk=mk(lk.rk, b, None, h, d), rv=mk(lk.rv, b, None, h, d),
            r_scores=mk(lk.r_scores, b, None), scores=mk(lk.scores, b, s),
            slot_pos=mk(lk.slot_pos, b, s),
            length=mk(lk.length, b), rlen=mk(lk.rlen, b), pos=mk(lk.pos, b),
            budget=(),
        )

    def ssm_specs(st: SSMState, nlead: int) -> SSMState:
        pre = (None,) * nlead
        return SSMState(
            conv=fit_spec((*pre, b, None, tp), st.conv.shape, mesh),
            state=fit_spec((*pre, b, tp, None, None), st.state.shape, mesh),
        )

    attn = layerkv_specs(cache.attn, 2) if cache.attn is not None else None
    ssm = ssm_specs(cache.ssm, 2) if cache.ssm is not None else None
    ck = cv = cb = None
    if cache.cross_k is not None:
        h, d = kv_hd(cache.cross_k.shape[3])
        ck = fit_spec((None, b, s, h, d), cache.cross_k.shape, mesh)
        cv = fit_spec((None, b, s, h, d), cache.cross_v.shape, mesh)
        cb = fit_spec((b, s), cache.cross_bias.shape, mesh)
    return ModelCache(attn, ssm, ck, cv, cb)


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------


def to_placements(spec: PSpec, mesh) -> tuple:
    """DTensor placements of `spec` in mesh-dim order: ``Shard(d)`` on a
    mesh dim that tensor dim d names (a dim over ("pod", "data") takes
    both), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in _names(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, (tuple, list)) and name in e)]
        assert len(dims) <= 1, (spec, name)
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(shape, spec: PSpec, mesh) -> tuple:
    """The shape of one rank's shard of a tensor of `shape` (every
    sharded dim divides: `fit_spec`)."""
    out = list(shape)
    for d, e in enumerate(spec):
        out[d] //= axis_size(mesh, e)
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def distribute_leaf(t: torch.Tensor, spec: PSpec, mesh):
    """One tensor as a DTensor placed by `spec`. A full tensor is cut
    locally (every rank holds the same full tensor: no communication)
    into a shard of its own storage; a meta tensor becomes a meta shard
    of the right local shape."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = to_placements(spec, mesh)
    if t.is_meta:
        local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, placements, run_check=False)
    d = distribute_tensor(t, mesh, placements, src_data_rank=None)
    loc = d.to_local()
    if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
        # a view into the full tensor would keep all of it alive
        d = DTensor.from_local(loc.clone(), mesh, placements, run_check=False)
    return d


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """`tree` (nested dicts / NamedTuples of tensors, None) with each
    leaf placed by the matching spec of `specs` (`param_pspecs`,
    `cache_pspecs`, `batch_spec` trees)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute_tree(a, s, mesh)
                            for a, s in zip(tree, specs)))
    assert _is_spec(specs), specs
    return distribute_leaf(tree, specs, mesh)


def full_tree(tree: Any) -> Any:
    """`tree` with every DTensor leaf gathered to its full tensor (other
    leaves as they are)."""
    from torch.distributed.tensor import DTensor
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(full_tree(a) for a in tree))
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


# ---------------------------------------------------------------------------
# DTensor execution: the model on sharded params, batch and cache
# ---------------------------------------------------------------------------


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@contextmanager
def replicate_plain():
    """Plain tensors made inside the model (aranges, masks, zeros of a
    global shape — the same on every rank) meet DTensors as replicated
    DTensors (`implicit_replication`, restored on exit so contexts
    nest). Without DTensors it changes nothing."""
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def replicates_plain(fn):
    """Decorator: run `fn` under `replicate_plain` (the model's entry
    points and the train step, backward pass included)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with replicate_plain():
            return fn(*args, **kwargs)
    return wrapped


def gather_fsdp(w):
    """A DTensor weight with its fsdp shards (the data / pod mesh dims)
    gathered, its tp shards kept: FSDP's gather at use, whose backward
    reduce-scatters the gradient. Left to DTensor's propagation, whose
    cost model counts bytes moved and not work, a matmul with
    activations smaller than the weight moves the activations instead
    and repeats the product on every data rank. Plain tensors pass."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    fsdp, _ = mesh_axes(w.device_mesh)
    names = _names(w.device_mesh)
    pl = tuple(Replicate() if names[i] in fsdp else p
               for i, p in enumerate(w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


def rows_whole(x):
    """A DTensor activation [B, ..., d] laid out as the residual stream:
    batch over the fsdp axes (where they divide it), whole on every
    other mesh dim (a partial sum is all-reduced). Plain tensors
    pass."""
    return place(x, "fsdp")


def split_last(y: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """y [..., n*d] -> [..., n, d]. A DTensor sharded on the last dim
    over a mesh dim that does not divide n (GQA kv heads under a wider
    tp) is first replicated on that mesh dim: DTensor has no view of a
    head_dim shard, where GSPMD shards head_dim."""
    if is_dtensor(y):
        from torch.distributed.tensor import Replicate
        last = y.dim() - 1
        mesh = y.device_mesh
        pl = tuple(Replicate() if (p.is_shard(last) and n % mesh.size(i))
                   else p for i, p in enumerate(y.placements))
        if pl != tuple(y.placements):
            y = y.redistribute(mesh, pl)
    return y.unflatten(-1, (n, d))


def merge_last(o: torch.Tensor) -> torch.Tensor:
    """o [..., n, d] -> [..., n*d]. On a DTensor the merge runs on the
    local shards (`local_map`), so the gradient comes back with o's own
    placements: DTensor has no view that splits a sharded merged dim
    into heads that the mesh does not divide."""
    if not is_dtensor(o):
        return o.flatten(-2)
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(o.placements)
    assert not any(p.is_shard(o.dim() - 1) for p in pl), pl
    return local_map(lambda t: t.flatten(-2), out_placements=(pl,),
                     in_placements=(pl,), device_mesh=o.device_mesh)(o)


def embed_lookup(table, ids):
    """``table[ids]`` for a DTensor table ``[V, d]``: each rank looks up
    the rows of its own vocabulary shard (zeros for ids outside it), a
    partial sum over the mesh dims that shard the vocabulary, all-reduced
    as GSPMD's sharded gather is; the table's other shards (d over fsdp)
    are gathered first and the ids keep their batch shards. Written out with
    `local_map` because DTensor's own vocab-parallel embedding mishandles
    a batch-sharded index (its mask takes the local batch for the
    global one)."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    t_pl = tuple(Shard(0) if i in vocab else Replicate()
                 for i in range(mesh.ndim))
    i_pl = tuple(Replicate() if i in vocab or not p.is_shard(0) else p
                 for i, p in enumerate(ids.placements))
    o_pl = tuple(Partial() if i in vocab else p for i, p in enumerate(i_pl))
    # a whole table on a mesh dim that splits the batch: partial gradients
    g_pl = tuple(Partial() if (i not in vocab and p.is_shard()) else q
                 for i, (p, q) in enumerate(zip(i_pl, t_pl)))
    idx = 0
    for i in vocab:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    lo = idx * (table.shape[0] // math.prod(mesh.size(i) for i in vocab))

    def local(t, ix):
        ix = ix.long() - lo
        hit = (ix >= 0) & (ix < t.shape[0])
        rows = F.embedding(ix.clamp(0, t.shape[0] - 1), t)
        return rows * hit[..., None].to(rows.dtype)

    out = local_map(local, out_placements=(o_pl,),
                    in_placements=(t_pl, i_pl),
                    in_grad_placements=(g_pl, i_pl),
                    device_mesh=mesh, redistribute_inputs=True)(table, ids)
    return out.redistribute(mesh, i_pl)   # the partial sum, all-reduced


# per-layer `LayerKV` leaves' ranks, in field order (B, S, H, D layouts)
LAYER_KV_NDIMS = (4, 4, 4, 4, 3, 3, 4, 4, 2, 2, 2, 1, 1, 1, 0)


def _shard_placements(ref_pl, ndim: int) -> tuple:
    """The placements a rank-local function sees for a tensor of `ndim`
    dims: the shards of the batch dim (0) and the heads dim (2) in
    `ref_pl`, where the tensor has them; every other dim whole."""
    from torch.distributed.tensor import Replicate
    return tuple(p if (p.is_shard() and p.dim in (0, 2) and p.dim < ndim)
                 else Replicate() for p in ref_pl)


def _sum_placements(ref_pl, ndim: int) -> tuple:
    """A per-rank sum over heads (attention mass): batch shards kept, a
    partial sum over the mesh dims that shard the heads."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if p.is_shard(2) else q for p, q in
                 zip(ref_pl, _shard_placements(ref_pl, ndim)))


def heads_layout(t, n_heads: int = 0):
    """(mesh, placements) of the cache layout for a DTensor ``t``
    ``[B, T, H, D]``: batch over the fsdp axes and heads over tp where
    they divide (`cache_pspecs`' default), the rest whole; with
    ``n_heads`` 0 only the batch is sharded."""
    mesh = t.device_mesh
    fsdp, tp = mesh_axes(mesh)
    heads = tp if n_heads and n_heads % axis_size(mesh, tp) == 0 else None
    spec = fit_spec((fsdp, None, heads)[:t.dim()], t.shape, mesh)
    return mesh, to_placements(spec, mesh)


def replicated_layout(t):
    """(mesh, all-Replicate placements) for a DTensor ``t`` — ops with no
    DTensor sharding rule run on replicated tensors, where XLA
    replicates them too — or None for a plain tensor."""
    if not is_dtensor(t):
        return None
    from torch.distributed.tensor import Replicate
    return t.device_mesh, (Replicate(),) * t.device_mesh.ndim


def on_shards(fn, ref, *args, out=None, writes=(), whole=()):
    """``fn(*args)`` on each rank's own batch rows and heads, through
    `local_map`. `ref` is a DTensor — a cache leaf ``[B, S, H, D]`` — or
    a ``(mesh, placements)`` pair (`heads_layout`) whose batch (dim 0)
    and heads (dim 2) shards every tensor argument takes, where it has
    those dims. Shards of other dims (head_dim, cache length) are
    gathered first: a kernel cannot attend over part of a head. `writes`:
    the positions of the arguments that `fn` updates in place; a DTensor
    among them that had to be redistributed gets the update copied back.
    `whole`: the positions of the arguments every rank takes whole
    (parameters). Plain tensors count as replicated. A whole input of a
    function whose work the mesh splits gets a partial gradient. `out`:
    None for a function run for its in-place writes (its return is
    dropped), else one entry per flat output — its ndim (placed like
    the inputs), ``("sum", ndim)`` for a per-rank partial sum over heads
    (attention mass), or None for a None output. Without a DTensor `ref`
    this is just ``fn(*args)``."""
    if not (is_dtensor(ref) or isinstance(ref, tuple)):
        res = fn(*args)
        return None if out is None else res
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, ref_pl = ((ref.device_mesh, tuple(ref.placements))
                    if is_dtensor(ref) else ref)
    new_args, in_pl, grad_pl, moved = [], [], [], []
    for j, arg in enumerate(args):
        flat, tree = pytree.tree_flatten(arg)
        for i, a in enumerate(flat):
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor):
                a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            if isinstance(a, DTensor):
                want = _shard_placements(ref_pl, 0 if j in whole
                                         else a.dim())
                if tuple(a.placements) != want:
                    b = a.redistribute(mesh, want)
                    if j in writes and isinstance(flat[i], DTensor):
                        moved.append((flat[i], b))
                    a = b
                in_pl.append(want)
                # a whole input of a function whose work the mesh splits
                # gets a partial gradient from each rank
                grad_pl.append(tuple(
                    Partial() if (w.is_replicate() and r.is_shard()) else w
                    for w, r in zip(want, ref_pl)))
            else:
                in_pl.append(None)
                grad_pl.append(None)
            flat[i] = a
        new_args.append(pytree.tree_unflatten(flat, tree))

    def place(o):
        if o is None:
            return None
        if isinstance(o, tuple):
            return _sum_placements(ref_pl, o[1])
        return _shard_placements(ref_pl, o)

    if out is None:
        out_pl = (None,)
        body = lambda *a: fn(*a) and None   # noqa: E731
    else:
        out_pl = tuple(place(o) for o in out)
        body = fn
    res = local_map(body, out_placements=out_pl, in_placements=tuple(in_pl),
                    in_grad_placements=tuple(grad_pl),
                    device_mesh=mesh)(*new_args)
    for orig, tmp in moved:
        orig.copy_(tmp.redistribute(mesh, orig.placements))
    return res
