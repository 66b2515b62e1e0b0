"""kvlint for the port (`repro_torch.analysis`), stdlib-only like its JAX
counterpart's tests (`tests/test_analysis.py`):

  * each port rule fires on a minimal positive case, stays quiet on the
    idiomatic negative and respects a reasoned suppression —
    ``host-sync`` (the five PyTorch syncs of an engine loop: ``y.cpu()``,
    ``int(y.sum())``, ``if y.any():``, ``torch.cuda.synchronize()``,
    ``y.item()``), ``step-sync``, ``step-copy``, ``launch-arity`` (an
    argtypes list against a fixture ``.cu`` with one parameter too
    many), ``launch-checked``, ``launch-flag``;
  * parity with `repro.analysis`: on fixtures of the shared rules
    (``release-seam``, ``duck-parity``, ``dead-module``,
    ``unused-import``, ``mutable-default``, ``kvlint-syntax``) the two
    analyzers give equal (rule, line, severity), and on every host-sync
    fixture of `tests/test_analysis.py` that names no ``jnp`` / ``jax``
    the port's ``host-sync`` finds at least JAX's;
  * the whole port (package, `test_torch_*` tests, `torch_*` examples,
    chip_smoke.py) is clean under ``--check``, with suppressed
    ``host-sync`` and ``step-sync`` findings, and the eight CUDA entry
    points' declarations are checked against their ``.cu`` sources;
  * the CLI's exit codes and its ``--json`` reasons.
"""
import ast
import glob
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from repro import analysis as jax_kvlint
from repro_torch.analysis import (analyze_paths, analyze_source,
                                  default_config)
from repro_torch.analysis.config import DuckClass
from repro_torch.analysis.rules_launch import cu_param_count, fold_len

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = ("release-seam", "duck-parity", "dead-module", "unused-import",
          "mutable-default", "kvlint-syntax")


def dedent(src):
    return textwrap.dedent(src).lstrip("\n")


def by_rule(findings, rule):
    return [f for f in findings if f.rule == rule]


def violations(findings, rule=None):
    out = [f for f in findings if f.is_violation]
    if rule is not None:
        out = [f for f in out if f.rule == rule]
    return out


# ---------------------------------------------------------------------------
# host-sync: the engine's per-step loops
# ---------------------------------------------------------------------------

HOT_CFG = default_config().clone(hot_functions={"fixture.py": {"hot"}})

PROBE = dedent("""
    class Engine:
        def generate_continuous(self, steps):
            for t in range(steps):
                y = self._decode(t)
                {sync}
            return y
""")
PROBE_SYNCS = ["host = y.cpu()", "n = int(y.sum())",
               "if y.any():\n                break",
               "torch.cuda.synchronize()", "tok = y.item()"]


@pytest.mark.parametrize("sync", PROBE_SYNCS)
def test_host_sync_flags_each_pytorch_sync(sync):
    src = PROBE.replace("{sync}", sync)
    fs = analyze_source(src, path="src/repro_torch/serving/engine.py")
    hits = violations(fs, "host-sync")
    assert [f.line for f in hits] == [5], [f.render() for f in fs]


def test_host_sync_probe_all_five_at_once():
    body = "\n            ".join(PROBE_SYNCS)
    src = PROBE.replace("{sync}", body)
    fs = analyze_source(src, path="src/repro_torch/serving/engine.py")
    assert [f.line for f in violations(fs, "host-sync")] == [5, 6, 7, 9, 10]


@pytest.mark.parametrize("sync", ['h = y.to("cpu")',
                                  "h = y.to(device='cpu')",
                                  "h = y.numpy()",
                                  "h = np.asarray(y)",
                                  "ok = torch.equal(y, y)",
                                  "ev.synchronize()",
                                  "f = y > 0 and t"])
def test_host_sync_flags_more_syncs(sync):
    src = dedent("""
        def hot(eng, ev, steps):
            for t in range(steps):
                y = eng._decode(t)
                %s
            return y
    """ % sync)
    fs = analyze_source(src, config=HOT_CFG)
    assert len(violations(fs, "host-sync")) == 1, [f.render() for f in fs]


def test_host_sync_quiet_outside_loop_and_outside_hot_fn():
    src = dedent("""
        def hot(eng):
            y = eng._decode(0)
            return y.item()

        def cold(eng, steps):
            for t in range(steps):
                out = eng._decode(t).cpu()
            return out
    """)
    assert not by_rule(analyze_source(src, config=HOT_CFG), "host-sync")


def test_host_sync_host_to_device_and_host_values_exempt():
    # host->device transfers, host mirrors and metadata reads are not syncs
    src = dedent("""
        def hot(eng, feed, steps, mirror):
            for t in range(steps):
                a = torch.tensor(feed)
                b = torch.as_tensor(feed, device=eng.device)
                c = torch.from_numpy(np.zeros(4))
                tok = eng._decode(eng._h2d(feed), a, b, c)
                n = int(mirror[t])
                if tok.shape[0] > 2 and tok is not None:
                    pass
                m = len(steps)
                flags = np.zeros(4, bool)
                if flags.any():
                    pass
                k = int(tok.size(0)) + tok.dim()
            return tok, n, m, k
    """)
    fs = analyze_source(src, config=HOT_CFG)
    assert not violations(fs, "host-sync"), [f.render() for f in fs]


def test_host_sync_cast_only_on_tensors():
    src = dedent("""
        def hot(eng, steps):
            for t in range(steps):
                tok = eng._decode(t)
                n = int(tok)
                hosts = np.zeros(4)
                m = int(hosts)
                k = float(t)
            return n + m + k
    """)
    hits = violations(analyze_source(src, config=HOT_CFG), "host-sync")
    assert [f.line for f in hits] == [4]
    assert "int() of a tensor" in hits[0].message


def test_host_sync_tag_flows_through_tensor_methods():
    src = dedent("""
        def hot(eng, steps):
            for t in range(steps):
                tok = eng._decode(t)
                nxt = tok.argmax(-1)[:, None]
                done = nxt == 2
                if done:
                    break
            return nxt
    """)
    hits = violations(analyze_source(src, config=HOT_CFG), "host-sync")
    assert [f.line for f in hits] == [6]


def test_host_sync_obs_emit_flags_tensor_arg():
    src = dedent("""
        def hot(eng, trace, steps):
            for t in range(steps):
                tok = eng._decode(t)
                trace.instant("token", args=dict(tok=tok))
            return tok
    """)
    hits = violations(analyze_source(src, config=HOT_CFG), "host-sync")
    assert len(hits) == 1 and "emit args" in hits[0].message


def test_host_sync_follows_same_module_syncing_calls():
    # the engine's pipelined reads: a method whose body waits on the card
    src = dedent("""
        class Fetch:
            def get(self, handle):
                handle[1].synchronize()
                return handle[0].numpy()

            def start(self, tok):
                return tok, None


        class Engine:
            def _sync(self):
                torch.cuda.synchronize(self.device)

            def _mirror(self, rows):
                full = rows >= 4
                return bool(full.any())

            def _noted(self, t):
                # kvlint: ok(host-sync: documented where it sits)
                return t.item()

            def generate(self, steps):
                fetch = Fetch()
                for t in range(steps):
                    h = fetch.start(self._decode(t))
                    out = fetch.get(h)
                    self._sync()
                    self._mirror(out)
                    self._noted(out)
                return out
    """)
    fs = analyze_source(src, path="src/repro_torch/serving/engine.py")
    hits = violations(fs, "host-sync")
    assert [f.line for f in hits] == [26, 27], [f.render() for f in fs]
    assert "Fetch.get syncs" in hits[0].message


def test_host_sync_suppression_standalone_comment():
    src = dedent("""
        def hot(eng, steps):
            for t in range(steps):
                tok = eng._decode(t)
                # kvlint: ok(host-sync: the one pipelined read per step)
                out = tok.cpu()
            return out
    """)
    fs = analyze_source(src, config=HOT_CFG)
    hits = by_rule(fs, "host-sync")
    assert len(hits) == 1 and hits[0].suppressed
    assert hits[0].suppress_reason == "the one pipelined read per step"
    assert not violations(fs, "host-sync")


# ---------------------------------------------------------------------------
# step-sync / step-copy: the per-step functions
# ---------------------------------------------------------------------------

STEP_CFG = default_config().clone(step_functions={
    "fixture.py": {"append", "Engine._decode"}})


def test_step_sync_fires_anywhere_in_a_step_function():
    src = dedent("""
        def append(lc, spec, ring_full=None):
            need = lc.rlen >= spec.window
            if ring_full is None:
                ring_full = bool(need.any())
            rows = torch.arange(4)
            if rows.sum() > 0:
                pass
            n = rows.max().item()
            return ring_full, n

        def helper(lc):
            return bool(lc.rlen.any())
    """)
    fs = analyze_source(src, config=STEP_CFG)
    hits = violations(fs, "step-sync")
    assert [f.line for f in hits] == [4, 6, 8], [f.render() for f in fs]
    assert "'append'" in hits[0].message


def test_step_sync_method_scope_and_static_reads_quiet():
    src = dedent("""
        class Engine:
            def _decode(self, cache, tok, ring_full):
                self.flush_steps += bool(ring_full)
                if tok.shape[1] > 1 and cache is not None:
                    pass
                if tok.is_meta:
                    pass
                logits = torch.matmul(tok, tok)
                return logits.argmax(-1)

            def generate(self, tok):
                return tok.item()
    """)
    fs = analyze_source(src, config=STEP_CFG)
    assert not by_rule(fs, "step-sync"), [f.render() for f in fs]


def test_step_sync_suppressed():
    src = dedent("""
        def append(lc, ring_full=None):
            if ring_full is None:
                # kvlint: ok(step-sync: only when the caller passes no host flag)
                ring_full = bool(lc.rlen.any())
            return ring_full
    """)
    fs = analyze_source(src, config=STEP_CFG)
    hits = by_rule(fs, "step-sync")
    assert len(hits) == 1 and hits[0].suppressed
    assert not violations(fs, "step-sync")


def test_step_copy_fires_on_whole_store_copies():
    src = dedent("""
        def append(lc, k_new):
            k = lc.k.clone()
            lc = lc._replace(rk=torch.cat([lc.rk, k_new], dim=1))
            both = torch.stack((lc.v.float(), lc.v.float()))
            return k, lc, both
    """)
    hits = violations(analyze_source(src, config=STEP_CFG), "step-copy")
    assert [f.line for f in hits] == [2, 3, 4]
    assert "lc.k.clone()" in hits[0].message
    assert "torch.cat over lc.rk" in hits[1].message


def test_step_copy_quiet_on_slices_metadata_and_other_scopes():
    src = dedent("""
        def append(lc, x):
            part = lc.k[:, :4].clone()
            pos = lc.pos[:, None].clone()
            kv = torch.cat([lc.slot_pos, x], 1)
            y = torch.cat([x, x])
            return part, pos, kv, y

        def not_a_step(lc):
            return lc.k.clone()
    """)
    assert not by_rule(analyze_source(src, config=STEP_CFG), "step-copy")


def test_step_copy_suppressed():
    src = dedent("""
        def append(lc, k):
            # kvlint: ok(step-copy: a step-local view, freed after the layer)
            return torch.cat([k, lc.rk], dim=1)
    """)
    fs = analyze_source(src, config=STEP_CFG)
    hits = by_rule(fs, "step-copy")
    assert len(hits) == 1 and hits[0].suppressed
    assert not violations(fs, "step-copy")


# ---------------------------------------------------------------------------
# launch-arity / launch-checked / launch-flag
# ---------------------------------------------------------------------------

CU = dedent("""
    // the fixture kernel's entry point
    extern "C" int fix_launch(const void* q, void* out, int B, int T,
                              float scale, /* the stream */ void* stream) {
      return 0;
    }
""")
OPS = dedent("""
    import ctypes
    from pathlib import Path

    import torch

    from repro_torch.kernels.build import CudaKernel, CudaSource

    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    SOURCE = CudaSource(Path(__file__).parent / "csrc" / "fix.cu")
    fix_kernel = CudaKernel(SOURCE, "fix_launch", [_P] * 2 + [_I] * 2
                            + [_F, _P])


    def _check(q):
        if q.device.type != "cuda":
            raise ValueError("CUDA only")


    def fix_cuda(q, stream):
        _check(q)
        q = q.contiguous()
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        fix_kernel(q.data_ptr(), out.data_ptr(), 1, 2, 1.0, stream)
        return out
""")
OPS_PATH = "src/repro_torch/kernels/fix/ops.py"


def launch_cfg(cu=CU):
    return default_config().clone(
        launch_files=("kernels/fix/ops.py",),
        cuda_sources={"kernels/fix/csrc/fix.cu": cu})


def test_fold_len_and_cu_param_count():
    expr = ast.parse("[_P] * 16 + [_I] * 12 + [_F, _P]", mode="eval").body
    assert fold_len(expr) == 30
    assert fold_len(ast.parse("2 * [_P] + x", mode="eval").body) is None
    assert cu_param_count(CU, "fix_launch") == 6
    assert cu_param_count(CU, "other_launch") is None
    assert cu_param_count('extern "C" int f(void) {}', "f") == 0


def test_launch_contracts_quiet_on_compliant_wrapper():
    fs = analyze_source(OPS, path=OPS_PATH, config=launch_cfg())
    assert not [f for f in fs if f.rule.startswith("launch-")], \
        [f.render() for f in fs]


def test_launch_arity_cu_with_one_parameter_too_many():
    cu = CU.replace("int B, int T,", "int B, int T, int H,")
    fs = analyze_source(OPS, path=OPS_PATH, config=launch_cfg(cu))
    hits = violations(fs, "launch-arity")
    assert len(hits) == 1 and hits[0].line == 10
    assert "hold 6 entries" in hits[0].message and "takes 7" in \
        hits[0].message


def test_launch_arity_direct_call_count_and_missing_symbol():
    src = OPS.replace("1, 2, 1.0, stream)", "1, 2, stream)")
    hits = violations(analyze_source(src, path=OPS_PATH,
                                     config=launch_cfg()), "launch-arity")
    assert len(hits) == 1 and "passes 5 arguments" in hits[0].message
    src = OPS.replace('"fix_launch", [', '"gone_launch", [')
    hits = violations(analyze_source(src, path=OPS_PATH,
                                     config=launch_cfg()), "launch-arity")
    assert len(hits) == 1 and 'no extern "C" gone_launch' in hits[0].message


def test_launch_checked_fires_on_an_unchecked_pointer():
    src = OPS.replace("    _check(q)\n    q = q.contiguous()\n", "")
    hits = violations(analyze_source(src, path=OPS_PATH,
                                     config=launch_cfg()), "launch-checked")
    assert len(hits) == 1 and "'q'" in hits[0].message
    src = OPS.replace("dtype=q.dtype, device=q.device", "dtype=q.dtype")
    hits = violations(analyze_source(src, path=OPS_PATH,
                                     config=launch_cfg()), "launch-checked")
    assert len(hits) == 1 and "'out'" in hits[0].message


def test_launch_checked_follows_helpers_lists_and_scratch():
    src = dedent("""
        import torch
        from repro_torch.kernels.build import DeviceScratch

        _SCRATCH = DeviceScratch("float32")


        def _check(tensors, device):
            pass


        def _outputs(q, n):
            return torch.empty_like(q), _SCRATCH(q.device, n)


        def _ptr(t):
            return None if t is None else t.data_ptr()


        def _aligned(t):
            return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


        def run(q, k, bias, kern, quant):
            q = q.contiguous()
            tensors = [(k, torch.int8)]
            tensors.append((bias, torch.float32))
            _check(tensors, q.device)
            k = _aligned(k)
            out, part = _outputs(q, 4)
            kern(_ptr(q), _ptr(k if quant else None), _ptr(bias),
                 _ptr(out), _ptr(part))
    """)
    fs = analyze_source(src, path=OPS_PATH, config=launch_cfg())
    assert not by_rule(fs, "launch-checked"), [f.render() for f in fs]


def test_launch_flag_literal_fires_in_the_package_only():
    src = "cfg = cfg.replace(use_kernels=False)\nrun(x, use_kernels=flag)\n"
    hits = violations(analyze_source(src, path="src/repro_torch/x.py"),
                      "launch-flag")
    assert len(hits) == 1 and hits[0].line == 1
    assert not by_rule(analyze_source(src, path="tests/test_x.py"),
                       "launch-flag")
    sup = ("# kvlint: ok(launch-flag: meta tensors take no kernel)\n" + src)
    fs = analyze_source(sup, path="src/repro_torch/x.py")
    assert not violations(fs, "launch-flag")


# ---------------------------------------------------------------------------
# parity with repro.analysis on the shared rules
# ---------------------------------------------------------------------------

SEAM_SRC = dedent("""
    class Runner:
        def retire(self, ids):
            self.allocator.free(ids)
""")
DENSE = dedent("""
    class DenseKV(NamedTuple):
        k: int
        scores: int
        length: int
""")
PAGED_OK = dedent("""
    class PagedKV(NamedTuple):
        pk: int
        tbl: int
        scores: int
        length: int
""")
SHARED_FIXTURES = [
    ("seam_fires", SEAM_SRC, "src/repro/serving/other.py", None),
    ("seam_allowlisted", SEAM_SRC, "src/repro/core/paging.py", None),
    ("seam_other_receiver", SEAM_SRC.replace("allocator", "arena"),
     "src/repro/serving/other.py", None),
    ("seam_suppressed", SEAM_SRC.replace(
        "free(ids)", "free(ids)  # kvlint: ok(release-seam: a doc example)"),
     "src/repro/serving/other.py", None),
    ("seam_bare_ok", SEAM_SRC.replace(
        "free(ids)", "free(ids)  # kvlint: ok(release-seam)"),
     "src/repro/serving/other.py", None),
    ("dead_module", "import repro.alive\n", "tests/fix_root.py",
     {"src/repro/alive.py": "X = 1\n", "src/repro/dead.py": "Y = 2\n"}),
    ("dormant_module", "import repro.alive\n", "tests/fix_root.py",
     {"src/repro/alive.py": "X = 1\n", "src/repro/dead.py":
      "# kvlint: dormant(parked until it lands)\nY = 2\n"}),
    ("unused_import", "import os\nimport sys\n\nprint(sys.argv)\n",
     "src/repro/fixture.py", None),
    ("unused_import_init", "import os\n", "src/repro/pkg/__init__.py", None),
    ("all_counts_as_use", 'from repro.x import thing\n\n__all__ = ["thing"]\n',
     "src/repro/fixture.py", None),
    ("mutable_default", "def f(a, b=[], c=None, d=dict()):\n    return a\n",
     "src/repro/fixture.py", None),
    ("malformed_directive", "x = 1  # kvlint: pls-ignore\n",
     "src/repro/fixture.py", None),
]


def _shared(findings):
    """(rule, path, line, severity, suppressed) of the shared rules'
    findings, sorted."""
    return sorted((f.rule, f.path, f.line, f.severity, f.suppressed)
                  for f in findings if f.rule in SHARED)


@pytest.mark.parametrize("name,src,path,extra", SHARED_FIXTURES,
                         ids=[f[0] for f in SHARED_FIXTURES])
def test_shared_rules_equal_jax(name, src, path, extra):
    got = _shared(analyze_source(src, path=path, extra=extra))
    want = _shared(jax_kvlint.analyze_source(src, path=path, extra=extra))
    assert got == want


@pytest.mark.parametrize("paged", [PAGED_OK, PAGED_OK.replace("length",
                                                              "rlen")])
def test_duck_parity_equal_jax(paged):
    from repro.analysis.config import DuckClass as JDuck
    pair = ((DuckClass, default_config()), (JDuck, jax_kvlint.default_config()))
    results = []
    for duck, cfg in pair:
        cfg = cfg.clone(duck_pairs=[(duck("fix_dense.py", "DenseKV", ("k",)),
                                     duck("fix_paged.py", "PagedKV",
                                          ("pk", "tbl")))])
        an = (analyze_source if duck is DuckClass
              else jax_kvlint.analyze_source)
        results.append([t for t in _shared(an(
            DENSE, path="src/repro/fix_dense.py", config=cfg,
            extra={"src/repro/fix_paged.py": paged}))
            if t[0] == "duck-parity"])
    assert results[0] == results[1]
    assert bool(results[0]) == ("rlen" in paged)


def _jax_host_sync_fixtures():
    """The `src` fixtures of tests/test_analysis.py's host-sync tests."""
    with open(os.path.join(REPO, "tests", "test_analysis.py")) as f:
        tree = ast.parse(f.read())
    out = []
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) \
                and fn.name.startswith("test_host_sync"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Name) and node.func.id == "dedent":
                    out.append((fn.name, dedent(node.args[0].value)))
    return out


def test_host_sync_finds_at_least_jax_on_its_fixtures():
    fixtures = _jax_host_sync_fixtures()
    assert len(fixtures) >= 8
    jcfg = jax_kvlint.default_config().clone(
        hot_functions={"fixture.py": {"hot"}})
    compared = 0
    for name, src in fixtures:
        if "jnp" in src or "jax" in src:
            continue
        compared += 1
        want = {(f.rule, f.line) for f in jax_kvlint.analyze_source(
            src, config=jcfg) if f.rule == "host-sync"}
        got = {(f.rule, f.line) for f in analyze_source(
            src, path="src/repro/fixture.py", config=HOT_CFG)
            if f.rule == "host-sync"}
        assert want <= got, (name, want, got)
    assert compared >= 7


def test_seam_allowlist_entry_is_load_bearing_on_the_port():
    sched = os.path.join(REPO, "src", "repro_torch", "serving",
                         "scheduler.py")
    assert not by_rule(analyze_paths([sched]), "release-seam")
    cfg = default_config()
    pruned = [e for e in cfg.seam_allowlist
              if e != ("serving/scheduler.py", "Scheduler.release")]
    hits = violations(analyze_paths([sched], config=cfg.clone(
        seam_allowlist=pruned)), "release-seam")
    assert any("Scheduler.release" in f.message for f in hits)


# ---------------------------------------------------------------------------
# the whole port, and the CLI
# ---------------------------------------------------------------------------

def port_paths():
    return ([os.path.join(REPO, "src", "repro_torch")]
            + sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
            + sorted(glob.glob(os.path.join(REPO, "examples", "torch_*.py")))
            + [os.path.join(REPO, "chip_smoke.py")])


def test_whole_port_has_no_unsuppressed_findings():
    findings = analyze_paths(port_paths())
    bad = [f.render() for f in findings if f.is_violation]
    assert not bad, "\n".join(bad)
    for rule in ("host-sync", "step-sync", "step-copy", "launch-flag"):
        assert any(f.suppressed and f.rule == rule for f in findings), rule
    assert all(f.suppress_reason for f in findings if f.suppressed)


def test_the_eight_entry_points_are_checked_against_their_sources():
    ops = sorted(glob.glob(os.path.join(REPO, "src", "repro_torch", "kernels",
                                        "*", "ops.py")))
    assert len(ops) == 3
    decls = []
    for p in ops:
        with open(p) as f:
            tree = ast.parse(f.read())
        decls += [n.value.args[1].value for n in tree.body
                  if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)
                  and getattr(n.value.func, "id", "") == "CudaKernel"]
    assert len(decls) == 8
    # a .cu with one parameter fewer in each entry point: every declaration
    # and every counted call disagrees
    cfg = default_config()
    srcs = {}
    for cu in glob.glob(os.path.join(REPO, "src", "repro_torch", "kernels",
                                     "*", "csrc", "*.cu")):
        with open(cu) as f:
            text = f.read()
        srcs[os.path.relpath(cu, REPO).replace("\\", "/")] = re.sub(
            r",\s*void\* stream\)", ")", text)
    hits = violations(analyze_paths(ops, config=cfg.clone(
        cuda_sources=srcs)), "launch-arity")
    assert sum("takes" in f.message for f in hits) == 8


def run_cli(args, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis"]
                          + args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_cli_exit_codes_and_json_reasons(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\n")
    ok = tmp_path / "ok.py"
    ok.write_text("import os  # kvlint: ok(unused-import: re-exported)\n")
    r = run_cli(["--check", str(bad)])
    assert r.returncode == 1 and "unused-import" in r.stdout
    assert "# kvlint: ok(unused-import: <reason>)" in r.stdout
    r = run_cli(["--check", str(ok)])
    assert r.returncode == 0, r.stdout
    assert "0 violation(s), 1 suppressed" in r.stdout
    r = run_cli(["--json", str(ok), str(bad)])
    assert r.returncode == 0
    rep = json.loads(r.stdout)
    assert rep["files"] == 2
    sup = [f for f in rep["findings"] if f["suppressed"]]
    assert [f["suppress_reason"] for f in sup] == ["re-exported"]
    assert run_cli(["--json", "--check", str(bad)]).returncode == 1


def test_cli_whole_port_check_exits_zero():
    r = run_cli(["--check", "src/repro_torch"]
                + [os.path.relpath(p, REPO) for p in port_paths()[1:]])
    assert r.returncode == 0, r.stdout + r.stderr
    assert " 0 violation(s)" in r.stdout
