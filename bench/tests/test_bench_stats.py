"""Rates and tails are taken over all the window's work, time, requests
and token gaps: a planted stall moves them."""
import math
from types import SimpleNamespace

import numpy as np

from bench.harness import core


def _batch(t_submit, starts, n_tokens, step=0.05, stall=None):
    results = []
    for i, t0 in enumerate(starts):
        tt = t0 + step * np.arange(n_tokens)
        if stall is not None and i == stall[0]:
            tt[stall[1]:] += stall[2]
        results.append(SimpleNamespace(
            n_tokens=n_tokens, token_times=tt, finish_reason="length",
            uid=i, prompt_len=512))
    return core.Batch(t_submit, [], SimpleNamespace(results=results))


def test_rates_and_tails_over_all_samples():
    b1 = _batch(0.0, [0.1 * i for i in range(20)], 50)
    b2 = _batch(10.0, [10.0 + 0.1 * i for i in range(20)], 50)
    m = core.window_metrics([b1, b2], 20.0)
    assert m["tokens"] == 2000 and m["output_tok_s"] == 100.0
    assert m["requests"] == 40 and m["gaps"] == 40 * 49
    # ttft: 0, 0.1, ..., 1.9 twice; the 36th of 40 is 1.7
    assert math.isclose(m["ttft_p90_s"], 1.7)
    assert math.isclose(m["itl_p95_ms"], 50.0)


def _stalled(stalls):
    """20 requests of 50 tokens 50 ms apart; `stalls` (request, token)
    pairs whose token and all after it come 2 s late."""
    b = _batch(0.0, [0.1 * i for i in range(20)], 50)
    for i, k in stalls:
        b.result.results[i].token_times[k:] += 2.0
    return core.window_metrics([b], 10.0)


def test_a_planted_stall_moves_the_tails():
    base = _stalled([])
    assert math.isclose(base["itl_p95_ms"], 50.0)
    # 20 of 980 gaps stalled: within the top 5 %, the tail holds
    assert math.isclose(_stalled([(i, 10) for i in range(20)])
                        ["itl_p95_ms"], 50.0)
    # 60 of 980 stalled: past the 95th percentile
    hit = _stalled([(i, k) for i in range(20) for k in (5, 20, 30)])
    assert math.isclose(hit["itl_p95_ms"], 2050.0)
    # and the rate counts the stalls' time: same tokens, longer window
    assert hit["tokens"] == base["tokens"]
    b = _batch(0.0, [0.1 * i + (3.0 if i >= 17 else 0.0)
                     for i in range(20)], 50)
    late = core.window_metrics([b], 10.0)
    assert late["ttft_p90_s"] > base["ttft_p90_s"] + 2.0


def test_a_failed_request_counts_as_missing_its_first_token():
    b = _batch(0.0, [0.0] * 10, 5)
    for r in b.result.results[:2]:
        r.finish_reason, r.token_times, r.n_tokens = "failed", \
            np.zeros(0), 0
    m = core.window_metrics([b], 1.0)
    assert m["ttft_p90_s"] == math.inf
