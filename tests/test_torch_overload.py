"""The port's overload-ladder units against the JAX package's own classes
on the CPU, call sequence for call sequence: `FaultPlan` injection on
`BlockAllocator` (explicit indices, the seeded rate, the failure cap,
refcount skew), `audit_pool` on hand-built states (clean, leak, double
and freed maps, orphaned increfs, nonpositive refcounts, the device
block-table cross-check, also on the port's own paged table), and the
scheduler's preemption, victim policy, retry accounting, tail release
and shortest-prompt admission order. Each sequence runs against both
packages; the observations must be equal, and equal to what the JAX
package's own tests pin."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import paging as JP
from repro.serving.scheduler import Request as JaxRequest
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.core import paging as TP
from repro_torch.core.cache import CacheSpec
from repro_torch.serving.scheduler import Request, Scheduler

# (paging module, Scheduler, Request) of each package
PACKAGES = {"jax": (JP, JaxScheduler, JaxRequest),
            "port": (TP, Scheduler, Request)}


def _both(fn, *args):
    """Run `fn(package, *args)` for both packages; the observations must
    be equal. Returns the port's."""
    got = {k: fn(v, *args) for k, v in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _drain(alloc, n_calls, n=1):
    """`n_calls` allocs of `n` blocks, each freed at once; the refused
    call indices."""
    refused = set()
    for k in range(n_calls):
        ids = alloc.alloc(n)
        if ids is None:
            refused.add(k)
        else:
            alloc.free(ids)
    return refused


# ---------------------------------------------------------------------------
# FaultPlan on the allocator
# ---------------------------------------------------------------------------


def test_fault_plan_has_the_reference_alloc_fields():
    """The port's plan carries the JAX plan's allocator fields with their
    defaults; the reference's fetch faults (host tier, not ported) are
    refused, not silently dropped."""
    fields = {f.name: f.default for f in dataclasses.fields(TP.FaultPlan)}
    ref = {f.name: f.default for f in dataclasses.fields(JP.FaultPlan)}
    assert fields == {k: ref[k] for k in fields}
    assert set(ref) - set(fields) == {
        "fail_fetches", "fetch_fail_rate", "max_fetch_failures",
        "delay_fetches", "fetch_delay_s"}
    with pytest.raises(TypeError):
        TP.FaultPlan(fail_fetches=(0,))


def test_fault_plan_explicit_indices():
    def run(pkg):
        P = pkg[0]
        a = P.BlockAllocator(4, fault_plan=P.FaultPlan(fail_allocs=(1, 3)))
        return _drain(a, 6), a.faults_injected, a.alloc_calls
    assert _both(run) == ({1, 3}, 2, 6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_plan_rate_matches_jax(seed):
    """The seeded rate refuses the same call indices in both packages (one
    stdlib `random.Random(seed)` draw per would-succeed call), replays
    identically, and differs for another seed."""
    def run(pkg, s):
        P = pkg[0]
        a = P.BlockAllocator(4, fault_plan=P.FaultPlan(seed=s,
                                                       fail_rate=0.3))
        # 2-block calls on a 4-block pool: some calls cannot succeed and
        # draw nothing
        refused = _drain(a, 20)
        held = a.alloc(3)
        refused |= {20 + k for k in _drain(a, 10, n=2)}
        return refused, a.faults_injected, held is None
    first = _both(run, seed)
    assert first == _both(run, seed)
    assert 0 < first[1] < 30
    assert _both(run, seed + 10) != first


def test_fault_plan_max_failures_bounds_injection():
    def run(pkg):
        P = pkg[0]
        a = P.BlockAllocator(4, fault_plan=P.FaultPlan(
            seed=0, fail_rate=1.0, max_failures=3))
        return _drain(a, 10), a.faults_injected
    assert _both(run) == ({0, 1, 2}, 3)


def test_fault_plan_only_fires_on_would_succeed_calls():
    def run(pkg):
        P = pkg[0]
        a = P.BlockAllocator(2, fault_plan=P.FaultPlan(fail_allocs=(0,)))
        too_big = a.alloc(5)            # a genuine refusal, not injected
        return too_big, a.faults_injected, a.alloc(1) is not None
    assert _both(run) == (None, 0, True)


@pytest.mark.parametrize("delta", [1, -1])
def test_fault_plan_refcount_skew_is_caught(delta):
    """A positive skew leaks the block, a negative one under-counts it;
    `audit_pool` reports either, with the same report in both packages."""
    def run(pkg):
        P = pkg[0]
        a = P.BlockAllocator(4, fault_plan=P.FaultPlan(skew_alloc=1,
                                                       skew_delta=delta))
        ids0 = a.alloc(1)
        ids1 = a.alloc(2)               # call 1: first id skewed
        out = [a.skews_injected, a.refcount(ids1[0])]
        with pytest.raises(P.PoolAuditError) as err:
            P.audit_pool(a, {0: ids0, 1: ids1})
        out.append(str(err.value))
        return out
    skews, rc, msg = _both(run)
    assert skews == 1 and rc == 1 + delta
    assert "skew" in msg
    if delta < 0:
        assert "nonpositive refcount" in msg


def test_skewed_block_leaks_after_every_holder_frees():
    def run(pkg):
        P = pkg[0]
        a = P.BlockAllocator(4, fault_plan=P.FaultPlan(skew_alloc=1))
        ids0, ids1 = a.alloc(1), a.alloc(2)
        a.free(ids0)
        a.free(ids1)
        with pytest.raises(P.PoolAuditError, match="leak"):
            P.audit_pool(a, {})
        return a.refcount(ids1[0]), ids1[0] in a.free_ids()
    assert _both(run) == (1, False)


# ---------------------------------------------------------------------------
# audit_pool on hand-built states
# ---------------------------------------------------------------------------

_REPORT_KEYS = ("n_blocks", "free", "allocated", "holders", "leaked",
                "double_mapped", "skewed", "lost", "clean")


def test_audit_clean_report():
    def run(pkg):
        P = pkg[0]
        a = P.BlockAllocator(6)
        x, y = a.alloc(2), a.alloc(1)
        a.incref([x[0]])                # the index's second reference
        rep = P.audit_pool(a, {0: x, 1: y}, index_blocks=[x[0]])
        return {k: rep[k] for k in _REPORT_KEYS}
    rep = _both(run)
    assert rep["clean"] and rep["allocated"] == 3 and rep["free"] == 3
    assert not (rep["leaked"] or rep["double_mapped"] or rep["skewed"])


@pytest.mark.parametrize("case", ["leak", "twice", "freed", "orphan"])
def test_audit_detects(case):
    def run(pkg):
        P = pkg[0]
        a = P.BlockAllocator(4)
        ids = a.alloc(1)
        holders = {0: ids}
        if case == "leak":
            holders = {}
        elif case == "twice":
            holders = {0: ids + ids}
        elif case == "freed":
            a.free(ids)
        else:
            a.incref(ids)               # refcount 2, one holder
        with pytest.raises(P.PoolAuditError) as err:
            P.audit_pool(a, holders)
        return str(err.value)
    msg = _both(run)
    assert {"leak": "leak", "twice": "twice", "freed": "freed",
            "orphan": "skew"}[case] in msg


def test_audit_device_table_cross_check():
    def run(pkg):
        P = pkg[0]
        a = P.BlockAllocator(8)
        ids = a.alloc(3)
        tbl = np.full((2, 2, 4), -1, np.int32)      # [L, slots, n_max]
        tbl[:, 0, :3] = ids
        out = [P.audit_pool(a, {0: ids}, block_tbl=tbl,
                            tbl_slots=[0])["clean"]]
        bad = tbl.copy()
        bad[1, 0, 1] = ids[0]                       # layer copies diverge
        swapped = tbl.copy()
        swapped[:, 0, :3] = ids[::-1]               # row order != grants
        for t in (bad, swapped):
            with pytest.raises(P.PoolAuditError) as err:
                P.audit_pool(a, {0: ids}, block_tbl=t, tbl_slots=[0])
            out.append(str(err.value))
        # a prefilling slot's unwritten row is exempt unless listed
        out.append(P.audit_pool(a, {0: ids}, block_tbl=swapped,
                                tbl_slots=[])["clean"])
        return out
    out = _both(run)
    assert out[0] and out[3]
    assert "diverge" in out[1] and "grant list" in out[2]


def test_audit_reads_the_ports_paged_table():
    """The port's pool carries a drop block past the grantable ids; no
    table entry ever maps it, so the table cross-check of a stacked
    paged cache (the engine's layout) sees only granted ids."""
    spec = CacheSpec(budget=64, policy="none")
    p = TP.stacked_paged_kv(spec, 2, 3, 64, 2, 8, n_blocks=12, block_len=8)
    a = TP.BlockAllocator(12)
    grants = {0: a.alloc(3), 2: a.alloc(5)}
    for s, ids in grants.items():
        TP.write_block_table(p, s, 0, torch.tensor(ids, dtype=torch.int32))
    assert TP.n_blocks(p) == 12 and p.pk.shape[1] == 13
    rep = TP.audit_pool(a, grants, block_tbl=p.block_tbl.numpy())
    assert rep["clean"]
    TP.clear_block_table_from(p, 2, 4)
    with pytest.raises(TP.PoolAuditError, match="grant list"):
        TP.audit_pool(a, grants, block_tbl=p.block_tbl.numpy())


# ---------------------------------------------------------------------------
# Scheduler: preemption, victims, retries, tail release, admission order
# ---------------------------------------------------------------------------


def _req(R, L, max_new=4):
    return R(tokens=np.zeros(L, np.int32), max_new=max_new)


def test_scheduler_preempt_requeues_with_prefix():
    """Preemption folds the emitted tokens into the continuation prefix,
    releases the blocks and requeues at the front; the re-admission's
    length budget and the retired result count the prefix."""
    def run(pkg):
        P, S, R = pkg
        alloc = P.BlockAllocator(8)
        sched = S((16,), n_slots=2, clock=_FakeClock(), allocator=alloc,
                  block_need=lambda r: 2)
        r1, r2 = _req(R, 16, 6), _req(R, 16, 6)
        sched.submit(r1)
        sched.submit(r2)
        out = [sched.admit_next(0) is r1, alloc.used]
        sched.record_token(0, 7)
        sched.record_token(0, 8)
        out += [sched.emitted_total(0), sched.preempt(0) is r1, alloc.used,
                sched.active_slots(), list(r1.emitted_prefix),
                r1.n_preemptions, sched.n_preemptions,
                len(r1.token_times_prefix), sched.pending, r1.remaining_new]
        out.append(sched.admit_next(1) is r1)    # jumps r2
        out.append([sched.record_token(1, t) for t in (9, 10, 11, 12)])
        res = sched.retire(1, "length")
        out += [res.tokens.tolist(), res.n_preemptions,
                res.token_times.tolist(), res.ttft_s, res.total_s,
                res.decode_s]
        return out
    out = _both(run)
    assert out[:13] == [True, 2, 2, True, 0, [], [7, 8], 1, 1, 2, 2, 4,
                        True]
    assert out[13] == [None, None, None, "length"]    # 2 prefix + 4 = 6
    assert out[14] == [7, 8, 9, 10, 11, 12] and out[15] == 1
    assert len(out[16]) == 6 and out[17] > 0      # first-token time carried


def test_scheduler_preempt_guards():
    def run(pkg):
        _, S, R = pkg
        sched = S((16,), n_slots=2, clock=_FakeClock())
        with pytest.raises(ValueError):
            sched.preempt(0)                     # empty slot
        sched.submit(_req(R, 16))
        sched.begin_prefill(0)
        with pytest.raises(ValueError, match="prefilling"):
            sched.preempt(0)                     # cancel, don't preempt
        return sched.prefilling_slots()
    assert _both(run) == [0]


def test_scheduler_preempt_victim_policy():
    """Lowest progress fraction loses; ties break youngest-admitted first;
    prefilling and excluded slots are never victims; a continuation's
    prefix counts as progress."""
    def run(pkg):
        _, S, R = pkg
        sched = S((16,), n_slots=4, clock=_FakeClock())
        reqs = [_req(R, 16, 4), _req(R, 16, 4), _req(R, 16, 8),
                _req(R, 16, 4)]
        for r in reqs:
            sched.submit(r)
        for s in (0, 1, 2):
            sched.admit_next(s)
        sched.begin_prefill(3)
        for s in (0, 1, 2):
            sched.record_token(s, 1)
        out = [sched.preempt_victim(), sched.preempt_victim(exclude=(2,)),
               sched.preempt_victim(exclude=(1, 2)),
               sched.preempt_victim(exclude=(0, 1, 2))]
        sched.preempt(2)
        out.append(sched.preempt_victim())
        return out
    out = _both(run)
    assert out[:4] == [2, 1, 0, None] and out[4] in (0, 1)


def test_scheduler_note_retry_counts():
    def run(pkg):
        _, S, R = pkg
        sched = S((16,), n_slots=1, clock=_FakeClock())
        out = [sched.note_retry()]               # empty queue: no-op
        sched.submit(_req(R, 16))
        out += [sched.note_retry(), sched.note_retry(), sched.n_retries]
        res = sched.fail_head()
        out += [res.n_retries, res.finish_reason, sched.all_done()]
        return out
    assert _both(run) == [0, 1, 2, 2, 2, "failed", True]


def test_fail_head_keeps_a_continuations_tokens():
    """A preempted continuation that proves unservable still surfaces the
    tokens it emitted."""
    def run(pkg):
        _, S, R = pkg
        sched = S((16,), n_slots=1, clock=_FakeClock())
        sched.submit(_req(R, 16, 6))
        sched.admit_next(0)
        sched.record_token(0, 3)
        sched.preempt(0)
        res = sched.fail_head()
        return (res.tokens.tolist(), res.n_preemptions, res.ttft_s > 0,
                res.token_times.shape)
    assert _both(run) == ([3], 1, True, (1,))


def test_release_blocks_frees_tail():
    def run(pkg):
        P, S, R = pkg
        alloc = P.BlockAllocator(8)
        sched = S((4,), 1, allocator=alloc, block_need=lambda r: 3)
        req = _req(R, 4)
        sched.submit(req)
        sched.admit_next(0)
        ids0 = sched.slot_blocks(0)
        sched.grant_blocks(0, 2)
        grown = sched.slot_blocks(0)
        freed = sched.release_blocks(0, 2)
        out = [freed == grown[3:], sched.slot_blocks(0) == ids0, alloc.used,
               sched.release_blocks(0, 0)]
        sched.retire(0, "length")
        return out + [alloc.used]
    assert _both(run) == [True, True, 3, [], 0]


def test_shortest_prompt_admission_order():
    """The shortest queued prompt is admitted first, FIFO among equal
    lengths; `begin_prefill` takes the same head; FIFO order is kept by
    default."""
    def run(pkg, order):
        _, S, R = pkg
        sched = S((8, 32), 1, admission_order=order)
        reqs = [R(tokens=np.zeros(32, np.int32), max_new=4),
                R(tokens=np.zeros(8, np.int32), max_new=4),
                R(tokens=np.ones(32, np.int32), max_new=4)]
        for r in reqs:
            sched.submit(r)

        def which(r):
            return [x is r for x in reqs].index(True)

        out = [which(sched.head_request())]
        for k in range(3):
            got = (sched.admit_next(0) if k % 2 == 0
                   else sched.begin_prefill(0))
            out.append(which(got))
            sched.retire(0, "length")
        return out
    assert _both(run, "shortest-prompt") == [1, 1, 0, 2]
    assert _both(run, "fifo") == [0, 0, 1, 2]
    for S in (JaxScheduler, Scheduler):
        with pytest.raises(ValueError, match="admission_order"):
            S((8,), 1, admission_order="lifo")
