"""What decides `correct`, at a size a CPU test holds: the reference
follows the port's prefill and decode through the compressed cache; a
sound run is correct; the timed path broken underneath (a token altered
where it is produced, a decode step that leaves its cache unchanged, half
of the batch's rows served from the other half) and the control (the
reference in float8 in the program's place) come out not correct."""
import time

import pytest
import torch

from bench.harness import check, core, faults, weights
from bench.reference import decoder


def _program_logits(cfg, params, tokens, prompt_len, spec):
    from repro_torch.nn import model as M
    lg, cache = M.prefill(params, cfg, {"tokens": tokens[:, :prompt_len]},
                          spec)
    rows = [lg[0]]
    for t in range(prompt_len, tokens.shape[1] - 1):
        lg, cache = M.decode_step(params, cfg, cache, tokens[:, t:t + 1],
                                  spec)
        rows.append(lg[0])
    return torch.stack(rows)


@pytest.mark.parametrize("policy,prompt,n,budget,window", [
    ("full", 48, 20, 0, 8),
    ("kivi2", 64, 40, 32, 8),      # evictions from the prompt on
    ("kivi2", 32, 30, 32, 8),      # a partly empty store that fills
    ("kivi2", 16, 40, 64, 8),      # zero-padded groups, then eviction
])
def test_reference_follows_the_port(tiny, policy, prompt, n, budget, window):
    from repro_torch.core.cache import CacheSpec
    from repro_torch.core.policy import presets
    _, config, _, _ = tiny
    cfg = core.program_config(config)
    params = weights.draw(cfg, 11, torch.device("cpu"))
    spec = presets(budget, window)[policy].spec
    if not spec.compressed:
        spec = CacheSpec(budget=prompt + n, policy="none")
    toks = torch.randint(0, config["vocab_size"], (1, prompt + n),
                         generator=torch.Generator().manual_seed(3))
    prog = _program_logits(cfg, params, toks, prompt, spec)
    pol = decoder.CachePolicy(budget=budget, window=window, sinks=4,
                              bits=2 if policy == "kivi2" else 16)
    ref = decoder.logits_of(decoder.Arch.from_config(config),
                            weights.reference_view(params, 2),
                            [toks[0, :-1].tolist()], [prompt], pol)[0]
    diff = (prog - ref).abs().amax(dim=-1)
    # f32 on both sides: equal to rounding, but for the odd 2-bit code a
    # rounding difference flips at a tie (one row at most)
    assert int((diff > 1e-4).sum()) <= 1
    assert float(diff.median()) < 1e-5


def _run(tiny, seed=2 ** 31 + 9):
    cell, config, tr, bench = tiny
    return core.run("tiny", cell, config, tr, seed=seed, seconds=0.01,
                    trace=False, device="cpu", t_start=time.perf_counter(),
                    bench=bench, log=lambda s: None)


def test_a_sound_run_is_correct(tiny):
    out = _run(tiny)
    assert out["correct"] is True
    assert out["check"]["max_logit_gap"]["value"] <= 1e-3
    assert out["check"]["unserved_requests"]["value"] == 0
    assert out["attempted"] >= 6 and out["failed"] == 0
    assert set(out["metrics"]) == {"output_tok_s", "ttft_p90_s",
                                   "itl_p95_ms", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", faults.NAMES)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    monkeypatch.setattr(*faults.patch(fault))
    out = _run(tiny)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["check"].values())


def test_the_control_is_not_correct(tiny):
    """The reference in float8 put in the program's place, on the served
    requests of a sound run: its gaps exceed the cell's limit."""
    cell, config, tr, bench = tiny
    cfg = core.program_config(config)
    seed = 77
    params = weights.draw(cfg, seed, torch.device("cpu"))
    eng = core.make_engine(cfg, params, cell, tr, seed, "cpu")
    from bench.harness import traffic
    reqs = core.requests_of(traffic.batch(tr, seed, 0, config["vocab_size"]))
    b = core.Batch(0.0, reqs, eng.generate_continuous(reqs))
    whole, missing = check.served([b])
    picked = check.sample(whole, 3, seed)
    ref = check.reference_logits(cell, config, params, picked)
    low = check.reference_logits(cell, config, params, picked,
                                 precision="fp8")
    assert missing == 0
    got = check.control_gaps(ref, low)
    assert any(got[k] > lim for k, lim in cell["check"]["limits"].items())


def test_the_sample_holds_the_longest_request(tiny):
    from types import SimpleNamespace as NS
    import numpy as np
    pairs = [(NS(tokens=np.zeros(p)), NS(n_tokens=n))
             for p, n in [(64, 5), (32, 40), (64, 30), (32, 2), (64, 1)]]
    for seed in range(5):
        got = check.sample(pairs, 3, seed)
        assert got[0] is pairs[2] and len(got) == 3
        assert len({id(g) for g in got}) == 3


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    """Run the smallest cell once on the card (skips without one)."""
    import json
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card only")
    root = check.weights.__file__.rsplit("/bench/", 1)[0]
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "granite-8b.rag-full", "--seed", "5", "--seconds",
                        "1", "--trace", "0"], cwd=root, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("fault", faults.NAMES)
def test_a_planted_fault_is_taken_out_again(fault):
    mod, attr, _ = faults.patch(fault)
    real = getattr(mod, attr)
    with faults.planted(fault):
        assert getattr(mod, attr) is not real
    assert getattr(mod, attr) is real


def test_readings_report_sound_control_and_fault_runs(tiny, monkeypatch,
                                                      tmp_path, capsys):
    """`readings.py` at the tiny size on the CPU: a sound seed passes the
    limits, its control does not, and a planted fault does not."""
    import json
    from bench import readings
    from bench.harness import spec
    cell, config, tr, _ = tiny
    monkeypatch.setattr(spec, "workload", lambda name: cell)
    monkeypatch.setattr(spec, "config", lambda name: config)
    monkeypatch.setattr(spec, "traffic", lambda name: tr)
    out = tmp_path / "r.jsonl"
    assert readings.main(["--workload", "tiny", "--seeds", "5",
                          "--control-seeds", "5", "--faults",
                          "half_batch:6", "--device", "cpu",
                          "--out", str(out)]) == 0
    sound, broken = [json.loads(l) for l in out.read_text().splitlines()]
    assert sound["passes_limits"] and sound["fault"] is None
    assert any(sound["control"][k] > lim
               for k, lim in cell["check"]["limits"].items())
    assert broken["fault"] == "half_batch" and not broken["passes_limits"]
