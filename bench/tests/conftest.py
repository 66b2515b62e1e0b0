"""The benchmark's CPU tests: the repository root and its `src` on the
path, and a tiny cell (full widths cut to a few dozen) that the harness
runs end to end on the CPU through the port's plain kernel versions."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_CONFIG = {
    "name": "tiny", "arch": "granite-8b", "source": "tests",
    "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
    "vocab_size": 256, "attention_bias": True, "tie_word_embeddings": False,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "torch_dtype": "float32",
}
TINY_TRAFFIC = {
    "batch_requests": 6, "prompt_buckets": [32, 64],
    "prompt_weights": [0.5, 0.5],
    "output": {"dist": "lognormal", "median": 20, "sigma": 0.6,
               "min": 4, "max": 40},
}
TINY_CELL = {
    "config": "tiny", "traffic": "tiny", "policy": "kivi2",
    "cache": {"budget": 32, "window": 8, "sinks": 4, "bits": 2},
    "engine": {}, "slots": 3, "profile": {"start_step": 2, "steps": 3},
    "check": {"requests": 3, "limits": {"max_logit_gap": 1e-3,
                                        "mean_logit_gap": 1e-4}},
}
TINY_BENCH = {
    "end_to_end": [
        {"name": "output_tok_s", "unit": "tokens/s"},
        {"name": "ttft_p90_s", "unit": "s"},
        {"name": "itl_p95_ms", "unit": "ms"},
        {"name": "peak_mem_gib", "unit": "GiB"},
        {"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": n, "unit": "%"} for n in (
        "occupancy", "decode_step_ms", "kv_mib_per_seq", "step_mfu",
        "prefill_ms_per_ktok", "ttft_p90_s.host", "itl_p95_ms.host")],
}


@pytest.fixture
def tiny():
    import copy
    return (copy.deepcopy(TINY_CELL), copy.deepcopy(TINY_CONFIG),
            copy.deepcopy(TINY_TRAFFIC), copy.deepcopy(TINY_BENCH))
