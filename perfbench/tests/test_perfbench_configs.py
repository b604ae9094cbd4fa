"""BENCHMARK.json and the files it names: the contract's shape, each
configuration's published keys and `reduced`, each mix's driver, each
cell's limits, and a reader for each per-layer metric."""

import json
import re

import pytest

from perfbench import cells, harness

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden_size", "intermediate_size", "num_attention_heads",
          "num_key_value_heads", "num_experts_per_tok", "vocab_size")

# the published values of the source (DeepSeek LLM 7B base's config.json
# and arXiv:2401.02954 Table 2)
DEEPSEEK_LLM_7B = {
    "hidden_size": 4096, "intermediate_size": 11008,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "num_hidden_layers": 30, "vocab_size": 102400,
    "max_position_embeddings": 4096, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16"}
PUBLISHED = {"deepseek-llm-7b-8l": DEEPSEEK_LLM_7B,
             "deepseek-llm-7b": DEEPSEEK_LLM_7B}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"])
                assert entry["better"] in ("lower", "higher")


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    data = cells.load_json(cells.ROOT / conf["file"])
    assert data["name"] == conf["name"]
    assert data["source"] == conf["source"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    assert "assumed" in data and "deployment" in data
    for key, value in PUBLISHED[conf["name"]].items():
        if key in data["reduced"]:
            assert data["reduced"][key] == value
            assert data[key] != value
        else:
            assert data[key] == value, key
    assert not set(data["reduced"]) & set(WIDTHS)
    cells.sizes(data)          # raises on what the port's block lacks


def test_cells_and_metrics_agree():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        cell = cells.cell(w["name"], BENCH)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
            assert harness.reader_path(m["name"]).exists()
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert (cells.PKG / "drivers" / f"{cell.driver}.py").exists()


def test_port_refusals():
    bad = dict(cells.load_json(cells.PKG / "configs" /
                               "deepseek-llm-7b-8l.json"),
               num_key_value_heads=8)
    with pytest.raises(ValueError):
        cells.sizes(bad)
    with pytest.raises(ValueError):       # the reference has no MoE layer
        cells.sizes(dict(bad, num_key_value_heads=32, num_experts=8))
    with pytest.raises(KeyError):
        cells.cell("no-such-cell")
