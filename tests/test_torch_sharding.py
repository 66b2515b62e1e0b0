"""The port's partition rules against the JAX package's, in one process
with no process group: `param_pspecs` for all 11 configs (full size on
meta / `jax.eval_shape`, and reduced) on a (2, 4) and a (2, 2, 4) mesh,
with and without ``pure_fsdp`` / ``params_tp_only``; `cache_pspecs` for
dense, KIVI, SSM and cross caches under ``shard_seq`` / ``seq_tp`` /
``dp_only``; `decode_cache_spec` and `batch_specs` for every arch x
input shape with each option on the production (16, 16) mesh;
`fit_spec` / `to_placements` against the numpy slice a rank should
hold; `constrain` is the identity outside a context.

`jax.sharding.PartitionSpec` stores a one-axis tuple entry ``("data",)``
as ``"data"``; the port keeps the tuple. Both mean the same sharding, so
entries are compared after that one normalization.
"""
import dataclasses
import itertools
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import base as JB
from repro.core.cache import CacheSpec as JCacheSpec
from repro.launch import specs as JSP
from repro.nn import model as JM
from repro.nn import sharding as JS
from repro_torch.configs import base as TB
from repro_torch.core.cache import CacheSpec
from repro_torch.launch import specs as TSP
from repro_torch.nn import model as M
from repro_torch.nn import sharding as shd

MESHES = {
    "2x4": (((2, 4), ("data", "model"))),
    "2x2x4": (((2, 2, 4), ("pod", "data", "model"))),
}
OPTS = [frozenset(), frozenset({"pure_fsdp"}), frozenset({"params_tp_only"})]
WL_OPTS = [frozenset(), frozenset({"pure_fsdp"}),
           frozenset({"seq_tp_cache"}), frozenset({"cache_dp_only"}),
           frozenset({"kivi2_cache"}), frozenset({"kivi4_cache"})]


def _norm(entry):
    if isinstance(entry, tuple):
        return entry[0] if len(entry) == 1 else entry
    return entry


def _norm_spec(spec) -> tuple:
    return tuple(_norm(e) for e in spec)


def _meshes(key):
    sizes, names = MESHES[key]
    return AbstractMesh(sizes, names), shd.MeshShape(names, sizes)


def _jax_leaves(tree):
    return [(tuple(getattr(k, "key", getattr(k, "name", k)) for k in path),
             _norm_spec(s)) for path, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]]


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_leaves(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields if getattr(tree, f) is not None
                for x in _port_leaves(getattr(tree, f), path + (f,))]
    return [(path, _norm_spec(tree))]


@pytest.mark.parametrize("opts", OPTS, ids=lambda o: "+".join(o) or "none")
@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_param_pspecs_equal_jax(size, mesh_key, opts):
    jmesh, tmesh = _meshes(mesh_key)
    for arch in JB.ARCH_IDS:
        jcfg, cfg = JB.get_config(arch), TB.get_config(arch)
        if size == "reduced":
            jcfg, cfg = JB.reduced(jcfg), TB.reduced(cfg)
        jp = jax.eval_shape(partial(JM.init_params, cfg=jcfg),
                            jax.random.key(0))
        tp = M.init_params(cfg, device="meta")
        with JS.activation_sharding(jmesh, opts):
            want = _jax_leaves(JS.param_pspecs(jp, jcfg, jmesh))
        with shd.activation_sharding(tmesh, opts):
            got = _port_leaves(shd.param_pspecs(tp, cfg, tmesh))
        assert got == want, arch


def _cache_cases():
    def attn(bits=16):
        if bits < 16:
            return (JCacheSpec(budget=32, window=8, group=8, bits=bits,
                               policy="streaming", sinks=2),
                    CacheSpec(budget=32, window=8, group=8, bits=bits,
                              policy="streaming", sinks=2))
        return (JCacheSpec(budget=32, window=8, group=8, policy="h2o",
                           sinks=2),
                CacheSpec(budget=32, window=8, group=8, policy="h2o",
                          sinks=2))
    return [("granite-8b", *attn()), ("granite-8b", *attn(2)),
            ("qwen2.5-32b", *attn(4)), ("jamba-v0.1-52b", *attn()),
            ("mamba2-130m", *attn()), ("seamless-m4t-large-v2", *attn())]


@pytest.mark.parametrize("flags", [
    {}, {"shard_seq": True}, {"seq_tp": True}, {"dp_only": True},
    {"shard_seq": True, "dp_only": True}], ids=lambda f: "+".join(f) or "none")
@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_cache_pspecs_equal_jax(mesh_key, flags):
    jmesh, tmesh = _meshes(mesh_key)
    for arch, jspec, spec in _cache_cases():
        jcfg, cfg = JB.get_config(arch), TB.get_config(arch)
        src = 24 if jcfg.is_encoder_decoder else 0
        jc = JM.init_cache(jcfg, jspec, 8, 64, src_len=src, as_spec=True)
        tc = M.init_cache(cfg, spec, 8, 64, src_len=src, device="meta")
        want = _jax_leaves(JS.cache_pspecs(jc, jmesh, **flags))
        got = _port_leaves(shd.cache_pspecs(tc, tmesh, **flags))
        assert got == want, (arch, spec)


def _shapes(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    return [(tuple(x.shape), np.dtype(x.dtype).name) for x in leaves]


def _port_shapes(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_shapes(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree if v is not None for x in _port_shapes(v)]
    return [(tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


@pytest.mark.parametrize("opts", WL_OPTS, ids=lambda o: "+".join(o) or "none")
def test_workloads_equal_jax(opts):
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    tmesh = shd.MeshShape(("data", "model"), (16, 16))
    for arch, name in itertools.product(JB.ARCH_IDS, JB.INPUT_SHAPES):
        jcfg, cfg = JB.get_config(arch), TB.get_config(arch)
        js, ts = JB.INPUT_SHAPES[name], TB.INPUT_SHAPES[name]
        assert dataclasses.asdict(js) == dataclasses.asdict(ts)
        assert (dataclasses.asdict(JSP.decode_cache_spec(jcfg, js, opts))
                == dataclasses.asdict(TSP.decode_cache_spec(cfg, ts, opts)))
        jw = JSP.batch_specs(jcfg, js, jmesh, opts)
        tw = TSP.batch_specs(cfg, ts, tmesh, opts)
        tag = (arch, name)
        assert (tw.kind, tw.note) == (jw.kind, jw.note), tag
        assert (dataclasses.asdict(tw.cache_spec) if tw.cache_spec else None
                ) == (dataclasses.asdict(jw.cache_spec) if jw.cache_spec
                      else None), tag
        assert _port_shapes(tw.args) == _shapes(jw.args), tag
        assert (_port_leaves({str(i): s for i, s in enumerate(tw.in_specs)})
                == _jax_leaves({str(i): s for i, s in
                                enumerate(jw.in_specs)})), tag


def _jax_slice(spec, shape, sizes: dict, coord: dict):
    """The index a rank at mesh coordinate `coord` holds under a
    PartitionSpec: a dim over axes (a1, a2, ...) splits into
    prod(sizes) chunks, the chunk index major-to-minor."""
    idx = []
    for d, e in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if e is None else (e,) if isinstance(e, str) else e
        n, c = 1, 0
        for a in axes:
            c = c * sizes[a] + coord[a]
            n *= sizes[a]
        step = shape[d] // n
        idx.append(slice(c * step, (c + 1) * step))
    return tuple(idx)


def _placement_slice(placements, names, shape, sizes, coord):
    """The index under DTensor placements in mesh-dim order: each
    ``Shard(d)`` cuts the remaining extent of dim d into the mesh dim's
    size and keeps this rank's piece."""
    lo, ext = [0] * len(shape), list(shape)
    for name, p in zip(names, placements):
        if p.is_shard():
            ext[p.dim] //= sizes[name]
            lo[p.dim] += coord[name] * ext[p.dim]
    return tuple(slice(a, a + e) for a, e in zip(lo, ext))


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_fit_spec_and_placements_hold_the_rank_slice(mesh_key):
    jmesh, tmesh = _meshes(mesh_key)
    sizes = tmesh.shape
    fsdp, tp = shd.mesh_axes(tmesh)
    cases = [
        ((fsdp, tp), (16, 24)), ((tp, fsdp), (12, 16)),
        ((None, fsdp, tp), (2, 8, 12)), ((fsdp, None, tp, None), (8, 3, 8, 4)),
        ((fsdp, tp), (6, 8)), ((tp, None), (6, 5)), ((), (4, 4)),
    ]
    for spec, shape in cases:
        fitted = shd.fit_spec(spec, shape, tmesh)
        want_fit = _norm_spec(JS.fit_spec(P(*spec), shape, jmesh))
        assert _norm_spec(fitted) + (None,) * (len(shape) - len(want_fit)) \
            == want_fit + (None,) * (len(shape) - len(want_fit))
        pl = shd.to_placements(fitted, tmesh)
        a = np.arange(np.prod(shape)).reshape(shape)
        for vals in itertools.product(*(range(sizes[n])
                                        for n in tmesh.axis_names)):
            coord = dict(zip(tmesh.axis_names, vals))
            want = a[_jax_slice(fitted, shape, sizes, coord)]
            got = a[_placement_slice(pl, tmesh.axis_names, shape, sizes,
                                     coord)]
            np.testing.assert_array_equal(got, want)
            assert got.shape == shd.local_shape(shape, fitted, tmesh)


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(4, 8)
    assert shd.constrain(x, "fsdp", "tp") is x
    assert not shd.opt_enabled("weight_gather")
    assert not shd.tp_divides(8)
    with shd.activation_sharding(shd.MeshShape(("data", "model"), (2, 4)),
                                 {"weight_gather"}):
        assert shd.opt_enabled("weight_gather")
        assert shd.tp_divides(8) and not shd.tp_divides(6)
        assert shd.constrain(x, "fsdp", "tp") is x   # a plain tensor
    assert not shd.opt_enabled("weight_gather")
