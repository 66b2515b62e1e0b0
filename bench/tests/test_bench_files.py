"""The harness finds everything by name, from files alone: each cell's
workload, configuration and traffic file, each per-layer metric's reader
and each roofline's kernel names; and a new metric, cell or traffic is
picked up by adding files."""
import json

import pytest

from bench.harness import core, spec, traffic

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_has_its_files(name):
    entry = {w["name"]: w for w in BENCH["workloads"]}[name]
    cell = spec.workload(name)
    assert (cell["config"], cell["traffic"]) == (entry["config"],
                                                entry["traffic"])
    config = spec.config(cell["config"])
    tr = spec.traffic(cell["traffic"])
    assert traffic.max_output(tr) >= 1
    cfg = core.program_config(config)
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (
        config["num_hidden_layers"], config["hidden_size"],
        config["vocab_size"])
    core.policy_of(cell)
    mine = spec.metrics_of(name, BENCH)
    assert any(m["name"] == "setup_s" for m in mine["end_to_end"])
    assert len(mine["end_to_end"]) >= 2 and mine["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_layer_metric_has_a_reader(metric):
    assert callable(spec.layer_reader(metric))
    if metric.endswith("_roofline"):
        assert spec.kernel_names(metric)


def test_config_entries_match_their_files():
    for c in BENCH["configs"]:
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_new_files_are_found(tmp_path, monkeypatch):
    for d in ("layer_metrics", "kernel_names", "traffic", "workloads"):
        (tmp_path / d).mkdir()
    (tmp_path / "layer_metrics" / "answer.x.py").write_text(
        "def read(rec):\n    return 42 if rec else None\n")
    (tmp_path / "kernel_names" / "k_roofline.json").write_text(
        json.dumps({"contains": ["my_kernel"]}))
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps(
        {"batch_requests": 4, "prompt_buckets": [64],
         "prompt_weights": [1], "output": {"dist": "uniform", "min": 2,
                                           "max": 5}}))
    (tmp_path / "workloads" / "m.burst.json").write_text(json.dumps(
        {"config": "m", "traffic": "burst"}))
    monkeypatch.setattr(spec, "BENCH", tmp_path)
    assert spec.layer_reader("answer.x")(True) == 42
    assert spec.layer_reader("answer.x")(None) is None
    assert spec.kernel_names("k_roofline") == ["my_kernel"]
    assert spec.workload("m.burst")["traffic"] == "burst"
    assert len(traffic.batch(spec.traffic("burst"), 3, 0, 10)) == 4
    mine = spec.metrics_of("m.burst", {
        "end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
        "per_layer": [{"name": "answer.x", "workloads": ["m.burst"]}]})
    assert [m["name"] for m in mine["end_to_end"]] == ["a"]
    assert [m["name"] for m in mine["per_layer"]] == ["answer.x"]


def test_engine_options_come_from_the_workload_file(tiny):
    """A layout (here paged, chunked, a pool below parity) is a workload
    file's ``engine`` object alone: the harness hands it to `Engine`."""
    import torch
    from bench.harness import weights
    cell, config, tr, _ = tiny
    cell["engine"] = {"paged": True, "chunked_prefill": True,
                      "chunk_len": 16, "pool_blocks": 9}
    cfg = core.program_config(config)
    params = weights.draw(cfg, 3, torch.device("cpu"))
    eng = core.make_engine(cfg, params, cell, tr, 3, "cpu")
    assert eng.paged and eng.chunked_prefill and eng.chunk_len == 16
    assert eng.pool_blocks == 9 and eng.slots == cell["slots"]
