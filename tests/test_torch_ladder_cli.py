"""The overload ladder with the prefix cache, through the engine and the
serving CLI, and `launch/train.py --mesh host` on four ranks, against the
JAX package and against one rank, on the CPU at reduced size:

  * every ladder flag at once (kivi2 paged + chunked, the prefix cache,
    lazy growth, preemption, degradation, the host tier, periodic audits)
    as engine options on reduced granite-8b with the JAX parameters
    through `repro_torch.bridge`: the streams, the prefix, tier, degrade
    and preemption counters and a clean audit equal the JAX engine's; the
    port's CLI with those flags ends with a clean audit;
  * the small-pool speculative ladder through the CLI (the case where the
    JAX loop livelocks): every run ends, a request the pool holds is
    served whole with the ample pool's stream, any other ends "failed" or
    "oom" with a prefix of it;
  * `launch/train.py --mesh host` in four spawned gloo ranks (mesh 1 x 4,
    f32) on reduced minicpm-2b with a vocabulary 4 does not divide: each
    step's loss and grad norm within TRAIN_TOL of the one-rank run, every
    rank's loss the same, and the checkpoint the ranks write loads equal
    to their gathered state.
"""
import json
import os
import signal
import tempfile
import time
import traceback

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import numpy as np

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.policy import presets as jax_presets
from repro.nn import model as JM
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.policy import presets
from repro_torch.launch import serve
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

# the ladder run at reduced size: prompts of PROMPT tokens, the first
# SHARED of them one template; kivi2 at the budget that keeps the whole
# pre-window prompt shareable (PROMPT - WINDOW), WINDOW-row groups in
# WINDOW-row blocks: SLOTS x BUDGET / WINDOW blocks is parity, and POOL
# below it makes the degradation controller and the tier's spill rung
# fire, as the card's run does at full size
PROMPT, SHARED, WINDOW, NEW, SLOTS, N_REQ = 64, 48, 8, 8, 8, 16
BUDGET = PROMPT - WINDOW
POOL, HOST = 32, 64
LADDER = dict(paged=True, chunked_prefill=True, chunk_len=16,
              prefix_sharing=True, block_growth="lazy", preemption=True,
              degrade=True, tiering=True, pool_blocks=POOL, host_blocks=HOST,
              audit_every=4)
CLI_LADDER = ["--arch", "granite-8b", "--reduced", "--policy", "kivi2",
              "--budget", str(BUDGET), "--window", str(WINDOW),
              "--continuous", "--buckets", str(PROMPT), "--requests",
              str(N_REQ), "--max-new", str(NEW), "--slots", str(SLOTS),
              "--paged", "--chunked-prefill", "--chunk-len", "16",
              "--prefix-sharing", "--shared-prefix", str(SHARED),
              "--block-growth", "lazy", "--preemption", "--degrade",
              "--tiering", "--host-blocks", str(HOST), "--pool-blocks",
              str(POOL), "--audit-every", "4", "--device", "cpu"]
TIER_KEYS = ("spills", "fetches", "drops", "bytes_spilled", "bytes_fetched",
             "refused_spills", "refused_fetches", "n_spills", "n_fetches",
             "bytes_moved", "host_entries")
PREFIX_KEYS = ("warm_hits", "cold", "near_hits", "cow_copies",
               "ingested_blocks", "evicted_blocks")


@pytest.fixture(scope="module")
def granite():
    jcfg = jax_reduced(jax_get_config("granite-8b"))
    cfg = reduced(get_config("granite-8b"))
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


def _templated(vocab, seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=SHARED).astype(np.int32)
    return [np.concatenate([shared, rng.integers(
        0, vocab, size=PROMPT - SHARED).astype(np.int32)])
        for _ in range(N_REQ)]


def _streams(res):
    return [r.tokens.tolist() for r in sorted(res.results,
                                              key=lambda r: r.uid)]


def test_every_ladder_flag_equals_jax(granite):
    """Phase `ladder` (b)'s flag set as engine options: the JAX engine and
    the port's give the same streams, finish reasons, preemptions, prefix
    counters, tier counts and bytes and degrade counts, both audits clean;
    degradation and the tier's spills both fire."""
    jcfg, jp, cfg, p = granite
    prompts = _templated(cfg.vocab_size)
    kw = dict(prompt_len=PROMPT, max_new=NEW, slots=SLOTS, buckets=(PROMPT,),
              **LADDER)
    jeng = JaxEngine(jcfg, jp, jax_presets(BUDGET, WINDOW)["kivi2"],
                     use_kernels=False, seed=0, **kw)
    want = jeng.generate_continuous([JaxRequest(tokens=t, max_new=NEW)
                                     for t in prompts])
    eng = Engine(cfg, p, presets(BUDGET, WINDOW)["kivi2"], device="cpu",
                 **kw)
    got = eng.generate_continuous([Request(tokens=t, max_new=NEW)
                                   for t in prompts])
    assert _streams(got) == _streams(want)
    g = sorted(got.results, key=lambda r: r.uid)
    w = sorted(want.results, key=lambda r: r.uid)
    for f in ("finish_reason", "n_preemptions", "n_spills", "n_fetches"):
        assert [getattr(r, f) for r in g] == [getattr(r, f) for r in w], f
    assert got.decode_steps == want.decode_steps
    assert {k: got.prefix[k] for k in PREFIX_KEYS} == \
        {k: want.prefix[k] for k in PREFIX_KEYS}
    assert {k: got.tier[k] for k in TIER_KEYS} == \
        {k: want.tier[k] for k in TIER_KEYS}
    st, jst = eng.pressure.stats, jeng.pressure.stats
    assert (st["degrades"], st["blocks_dropped"]) == \
        (jst["degrades"], jst["blocks_dropped"])
    assert eng.last_audit["clean"] and jeng.last_audit["clean"]
    assert all(r.finish_reason == "length" for r in g)
    assert st["degrades"] >= 1 and got.tier["spills"] >= 1
    assert got.prefix["warm_hits"] >= 1


def test_every_ladder_flag_through_the_cli(tmp_path):
    """The port's CLI with every ladder flag (the card's phase `ladder`
    (b) at reduced size) on the CPU: every request completes, the
    end-of-run audit is clean, degrades and spills fire, and the metrics
    snapshot's counters equal the engine result's and the trace's."""
    trace, mj = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    eng, res = serve.main(CLI_LADDER + ["--trace", trace,
                                        "--metrics-json", mj])
    assert all(r.finish_reason == "length" for r in res.results)
    assert len(res.results) == N_REQ and eng.last_audit["clean"]
    st = eng.pressure.stats
    assert st["degrades"] >= 1 and res.tier["spills"] >= 1
    with open(mj) as f:
        snap = json.load(f)["metrics"]
    with open(trace) as f:
        evs = [e["name"] for e in json.load(f)["traceEvents"]
               if e["ph"] == "i"]
    assert snap["tier.spills"] == res.tier["n_spills"]
    assert snap["tier.fetches"] == res.tier["n_fetches"]
    assert snap["pressure.degrades"] == st["degrades"] == evs.count("degrade")
    assert evs.count("spill") == res.tier["spills"]
    assert evs.count("fetch") == res.tier["fetches"]
    assert snap["engine.decode_steps"] == res.decode_steps


class _Deadline:
    def __init__(self, seconds):
        self.seconds = seconds

    def __enter__(self):
        def ring(*_):
            raise TimeoutError(f"not done in {self.seconds} s")
        self.prev = signal.signal(signal.SIGALRM, ring)
        signal.alarm(self.seconds)

    def __exit__(self, *exc):
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self.prev)


SPEC_CLI = ["--arch", "granite-8b", "--reduced", "--policy", "full",
            "--continuous", "--buckets", "32", "--requests", "4",
            "--max-new", "12", "--slots", "2", "--speculative", "--gamma",
            "4", "--draft-policy", "same", "--paged", "--block-len", "8",
            "--block-growth", "lazy", "--preemption", "--audit-every", "2",
            "--device", "cpu"]


# pools of 4-row blocks (the 44-row store resolves block_len 8 to 4): 9
# holds less than one whole request, 11 exactly one (the longest, 32 + 12
# rows), 14 one and not two
@pytest.mark.parametrize("pool", [9, 11, 14])
def test_small_pool_speculative_cli_ends(pool):
    """tests/test_torch_preempt.py::test_speculative_ladder_converges_on_
    small_pool through the serving CLI (phase `ladder` (c) at reduced
    size): the run ends inside its deadline, the pool ends empty with a
    clean audit, a request the pool holds is served whole with the parity
    pool's stream, any other ends "failed" or "oom" with a prefix of it."""
    _, ample = serve.main(SPEC_CLI)
    with _Deadline(60):
        eng, res = serve.main(SPEC_CLI + ["--pool-blocks", str(pool)])
    assert eng.last_audit["clean"] and eng.block_allocator.used == 0
    for got, want in zip(res.results, ample.results):
        fits = pool * eng.block_len >= 32 + want.n_tokens
        assert (got.finish_reason == "length") == fits
        if fits:
            assert got.tokens.tolist() == want.tokens.tolist()
        else:
            assert got.finish_reason in ("failed", "oom")
            assert got.tokens.tolist() == \
                want.tokens.tolist()[:len(got.tokens)]
    if pool >= 11:
        assert sum(r.n_preemptions for r in res.results) >= 1


# ---- launch/train.py --mesh host on four gloo ranks ----------------------

WORLD = 4
VOCAB = 509          # reduced minicpm-2b's vocabulary would be 512
TRAIN_ARGV = ["--arch", "minicpm-2b", "--reduced", "--steps", "3",
              "--batch", "4", "--seq", "16", "--schedule", "wsd",
              "--device", "cpu"]
# |loss - one rank's| per step and the grad norms' relative difference:
# f32, the four ranks sum the row-parallel partial products and the
# vocabulary shards' logsumexp in another order than one rank does
TRAIN_TOL = (1e-5, 1e-5)


def _odd_vocab(train_cli):
    get = train_cli.get_config
    train_cli.get_config = lambda arch: get(arch).replace(vocab_size=VOCAB)


def _train_rank(rank, rdv, ckpt, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    res = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=rank, world_size=WORLD)
        from repro_torch.launch import train as train_cli
        from repro_torch.nn import sharding as shd
        _odd_vocab(train_cli)
        state, hist = train_cli.main(TRAIN_ARGV + ["--mesh", "host",
                                                   "--ckpt", ckpt])
        from repro_torch.optim.optimizers import tree_leaves
        emb = state.params["embed"]["table"]
        leaves = tree_leaves(state.params)
        res = {"hist": [{k: h[k] for k in ("loss", "grad_norm")}
                        for h in hist],
               "mesh": list(emb.device_mesh.shape),
               "embed_local": list(emb.to_local().shape),
               "sharded": sum(x.to_local().numel() < x.numel()
                              for x in leaves),
               "leaves": len(leaves)}
        full = shd.full_tree(state)
        if rank == 0:
            torch.save(full, out + ".state")
    except Exception:  # noqa: BLE001 — reported to the test
        res["error"] = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def four_ranks():
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp()
    ckpt, out = os.path.join(tmp, "ck"), os.path.join(tmp, "out")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_train_rank,
                         args=(r, os.path.join(tmp, "rdv"), ckpt, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 240
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 1))
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
        pytest.fail("the ranks did not finish in 240 s")
    ranks = []
    for r in range(WORLD):
        with open(f"{out}.{r}") as f:
            ranks.append(json.load(f))
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return ranks, ckpt, torch.load(out + ".state", weights_only=False)


@pytest.fixture(scope="module")
def one_rank():
    from repro_torch.launch import train as train_cli
    get = train_cli.get_config
    _odd_vocab(train_cli)
    try:
        return train_cli.main(TRAIN_ARGV)
    finally:
        train_cli.get_config = get


def test_four_rank_mesh_host_matches_one_rank(four_ranks, one_rank):
    """The launcher's own mesh for four ranks, (1, 4), tp 4: the weights
    4 divides are sharded, the 509-row tied table stays whole on every
    rank (`sharding.fit_spec` drops an axis that does not divide, as the
    JAX package does); each step within TRAIN_TOL of the one-rank run,
    every rank's loss equal."""
    ranks, _, _ = four_ranks
    _, hist = one_rank
    assert [r["mesh"] for r in ranks] == [[1, 4]] * WORLD
    assert [r["embed_local"] for r in ranks] == [[VOCAB, 256]] * WORLD
    assert all(0 < r["sharded"] < r["leaves"] for r in ranks)
    for i, h in enumerate(hist):
        got = [r["hist"][i] for r in ranks]
        assert len({g["loss"] for g in got}) == 1
        assert abs(got[0]["loss"] - h["loss"]) <= TRAIN_TOL[0]
        assert abs(got[0]["grad_norm"] - h["grad_norm"]) <= \
            TRAIN_TOL[1] * h["grad_norm"]


def test_four_rank_checkpoint_loads_equal(four_ranks, one_rank):
    """The checkpoint the four ranks write (rank 0 writes what every rank
    gathers) loads into the one-rank state's template equal, leaf for
    leaf, to the four ranks' gathered state."""
    from repro_torch.checkpoint import load_pytree
    from repro_torch.checkpoint.io import _flatten
    _, ckpt, full = four_ranks
    template, _ = one_rank
    a, b = _flatten(load_pytree(template, ckpt)), _flatten(full)
    assert [k for k, _ in a] == [k for k, _ in b] and len(a) > 3
    for (k, x), (_, y) in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), k
