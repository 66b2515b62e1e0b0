"""Checkpointing: a tree of tensors <-> on-disk .npz shards + a JSON
manifest, in the JAX package's format (counterpart of
`repro.checkpoint.io`), so either package restores the other's files.

A tree is nested dicts (keys in sorted order), NamedTuples (field
order), lists / tuples and tensor leaves; None holds no leaf. Leaves are
addressed by their path as `jax.tree_util.keystr` renders it
(``.params['blocks']['sub0']['attn']['wq']['w']``) and written in that
order as ``leaf_NNNNN`` of ``shard_NNNN.npz``, a new shard whenever the
next leaf would pass `shard_bytes`. numpy has no bfloat16: a bf16 leaf
is stored as JAX's `np.asarray` stores it, 2-byte void (``|V2``) with
manifest dtype ``"bfloat16"``, and restored by viewing its 16 bits as
bf16, bit for bit. (The JAX loader's ``astype`` cannot cast those void
bytes back, so it fails on any bf16 leaf; this one restores them.)

A sharded tree (DTensor leaves) is saved whole: every rank gathers each
leaf (`full_tensor`, a collective: every rank calls `save_pytree`) and
rank 0 writes, so the files equal those of the unsharded tree. Loading
into a sharded template places each leaf by the template leaf's
placements.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, path: str = ""):
    """(path, leaf) pairs in the JAX leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _rebuild(tree: Any, leaves):
    """`tree`'s structure with its leaves taken from the iterator
    `leaves`, in `_flatten`'s order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _sharded(leaves) -> bool:
    return any(_is_dtensor(x) for _, x in leaves)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array JAX would save, and its manifest dtype."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_pytree(tree: Any, directory: str, *,
                shard_bytes: int = 2 << 30) -> None:
    import torch.distributed as dist
    leaves = _flatten(tree)
    sharded = _sharded(leaves)
    # a sharded tree is saved by every rank together: rank 0 writes
    write = not sharded or dist.get_rank() == 0
    if write:
        os.makedirs(directory, exist_ok=True)
    manifest = {"leaves": [], "version": 1}
    shard_idx, shard_payload, shard_size = 0, {}, 0

    def flush():
        nonlocal shard_idx, shard_payload, shard_size
        if shard_payload:
            if write:
                np.savez(os.path.join(directory,
                                      f"shard_{shard_idx:04d}.npz"),
                         **shard_payload)
            shard_idx += 1
            shard_payload, shard_size = {}, 0

    for i, (name, leaf) in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        key = f"leaf_{i:05d}"
        if shard_size + arr.nbytes > shard_bytes:
            flush()
        shard_payload[key] = arr
        shard_size += arr.nbytes
        manifest["leaves"].append({
            "path": name, "key": key, "shard": shard_idx,
            "shape": list(arr.shape), "dtype": dtype,
        })
    flush()
    if write:
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
    if sharded:
        dist.barrier()      # the files exist before any rank returns


def load_pytree(template: Any, directory: str) -> Any:
    """Restore into the structure of `template` (tensor leaves: shapes
    checked; each leaf takes the template leaf's dtype and device, and a
    DTensor leaf its mesh and placements)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    shards: dict[int, Any] = {}
    out = []
    for name, leaf in _flatten(template):
        e = by_path[name]
        if e["shard"] not in shards:
            shards[e["shard"]] = np.load(
                os.path.join(directory, f"shard_{e['shard']:04d}.npz"))
        arr = shards[e["shard"]][e["key"]]
        assert tuple(arr.shape) == tuple(leaf.shape), (name, arr.shape,
                                                       leaf.shape)
        if e["dtype"] == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        t = t.to(device=leaf.device, dtype=leaf.dtype)
        if _is_dtensor(leaf):
            from torch.distributed.tensor import distribute_tensor
            t = distribute_tensor(t, leaf.device_mesh, leaf.placements,
                                  src_data_rank=None)
        out.append(t)
    return _rebuild(template, iter(out))
