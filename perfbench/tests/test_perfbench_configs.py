"""BENCHMARK.json and the files it names: the contract's shape, each
configuration's published keys (`configs/published/<config>.json`) and
`reduced`, each mix's driver and its gate, each cell's limits, and a
reader for each per-layer metric."""

import importlib
import json
import re
import sys
import types

import pytest

from perfbench import cells, harness

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# keys no cut may touch: widths, head sizes, ranks, experts per token,
# windows (a key ending in _dim or _rank is one too); the expert count
# and the vocabulary may be the chip's share, listed in `reduced`
WIDTHS = ("hidden_size", "intermediate_size", "num_attention_heads",
          "num_key_value_heads", "num_experts_per_tok",
          "moe_intermediate_size", "n_shared_experts", "kv_lora_rank",
          "q_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
          "v_head_dim", "head_dim", "sliding_window")
WIDTH_SUFFIXES = ("_dim", "_rank")


def published(name, pkg=cells.PKG):
    """The source's keys and values of configuration `name`."""
    return cells.load_json(pkg / "configs" / "published" / f"{name}.json")


def drivers_of(name, bench, pkg=cells.PKG):
    """The drivers of the cells that run configuration `name`."""
    return sorted({cells.load_json(pkg / "mixes" /
                                   f"{w['traffic']}.json")["driver"]
                   for w in bench["workloads"] if w["config"] == name})


def check_config(conf, bench, pkg=cells.PKG):
    """A `configs` entry against its file and its published file, and
    its file against the gate of every driver whose cells run it."""
    data = cells.load_json(pkg.parent / conf["file"])
    assert data["name"] == conf["name"]
    assert data["source"] == conf["source"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    assert "assumed" in data and "deployment" in data
    pub = published(conf["name"], pkg)
    for key, value in pub.items():
        if key in data["reduced"]:
            assert data["reduced"][key] == value
            assert data[key] != value
        else:
            assert data[key] == value, key
    for key in data["reduced"]:
        assert key not in WIDTHS and not key.endswith(WIDTH_SUFFIXES), key
    for key in WIDTHS:
        if key in data:
            assert pub.get(key) == data[key], key
    for name in drivers_of(conf["name"], bench, pkg):
        # raises on what the driver cannot run
        importlib.import_module(f"perfbench.drivers.{name}").accepts(data)


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
    path = cells.PKG / "configs" / "published" / f"{conf['name']}.json"
    assert path.exists(), f"{conf['name']} has no published file"
    check_config(conf, BENCH)


def check_cells_and_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        cell = cells.cell(w["name"], bench)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
            assert harness.reader_path(m["name"]).exists()
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert (cells.PKG / "drivers" / f"{cell.driver}.py").exists()


def test_cells_and_metrics_agree():
    check_cells_and_metrics(BENCH)


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (cells.PKG / "pending").glob("*.json")))
def test_a_pending_cell_fits_the_benchmark(name):
    from perfbench.tests import tiny
    bench = tiny.with_pending(name)
    check_cells_and_metrics(bench)
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(names) // 4)
    for entry in bench["workloads"] + bench["per_layer"]:
        assert NAME.match(entry["name"])
        for key in ("why", "layer"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200
    for conf in bench["configs"]:
        check_config(conf, bench)


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


# -- a configuration the dense block lacks, as new files only ----------

SYNTHETIC = {
    "hidden_size": 2048, "intermediate_size": 11264,
    "moe_intermediate_size": 1408, "num_attention_heads": 16,
    "num_key_value_heads": 4, "num_experts": 64, "num_experts_per_tok": 6,
    "n_shared_experts": 2, "kv_lora_rank": 512, "qk_rope_head_dim": 64,
    "num_hidden_layers": 27, "vocab_size": 163840, "rms_norm_eps": 1e-5,
    "rope_theta": 50000.0, "max_position_embeddings": 8192,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16"}


def _stub_accepts(config):
    """A driver that runs grouped KV heads and experts."""
    if not config.get("num_experts") or config["num_attention_heads"] % \
            config["num_key_value_heads"]:
        raise ValueError("the stub runs grouped-KV expert models only")


def synthetic(tmp_path, driver, cut=None, reduced=None, **changed):
    """(configs entry, BENCHMARK) of a synthetic grouped-KV expert model
    under `driver`, its files written under tmp_path/perfbench; `cut`
    sets keys and lists them in `reduced`, `changed` sets them alone."""
    pkg = tmp_path / "perfbench"
    for sub in ("configs/published", "mixes"):
        (pkg / sub).mkdir(parents=True, exist_ok=True)
    cut = cut or {}
    data = dict(SYNTHETIC, name="synthetic-moe",
                source="https://example.org/synthetic-moe",
                assumed={}, deployment="a test's",
                reduced={k: SYNTHETIC[k] for k in cut})
    data.update(cut)
    data.update(changed)
    (pkg / "configs" / "synthetic-moe.json").write_text(json.dumps(data))
    (pkg / "configs" / "published" / "synthetic-moe.json").write_text(
        json.dumps(SYNTHETIC))
    (pkg / "mixes" / "synthetic-mix.json").write_text(
        json.dumps({"driver": driver}))
    conf = {"name": "synthetic-moe", "source": data["source"],
            "file": "perfbench/configs/synthetic-moe.json",
            "reduced": sorted(data["reduced"] if reduced is None
                              else reduced), "why": "a test's"}
    bench = {"configs": [conf], "workloads": [
        {"name": "synthetic.train", "config": "synthetic-moe",
         "traffic": "synthetic-mix", "chips": 1, "why": "a test's"}]}
    return conf, bench, pkg


@pytest.fixture
def stub_driver(monkeypatch):
    stub = types.ModuleType("perfbench.drivers.stub_moe")
    stub.accepts = _stub_accepts
    monkeypatch.setitem(sys.modules, "perfbench.drivers.stub_moe", stub)


def test_a_config_the_dense_block_lacks_passes_under_its_own_driver(
        tmp_path, stub_driver):
    conf, bench, pkg = synthetic(tmp_path, "stub_moe")
    check_config(conf, bench, pkg)
    # the chip's share of the experts and of the vocabulary may be cut
    conf, bench, pkg = synthetic(tmp_path, "stub_moe",
                                 cut={"num_experts": 8, "vocab_size": 20480})
    check_config(conf, bench, pkg)


@pytest.mark.parametrize("driver", ["train", "serve", "train_mesh"])
def test_a_dense_driver_refuses_it(tmp_path, driver):
    conf, bench, pkg = synthetic(tmp_path, driver)
    with pytest.raises(ValueError):
        check_config(conf, bench, pkg)


@pytest.mark.parametrize("cut", [{"moe_intermediate_size": 704},
                                 {"kv_lora_rank": 256},
                                 {"num_experts_per_tok": 2},
                                 {"hidden_size": 1024}])
def test_a_width_cut_fails(tmp_path, stub_driver, cut):
    conf, bench, pkg = synthetic(tmp_path, "stub_moe", cut=cut)
    with pytest.raises(AssertionError):
        check_config(conf, bench, pkg)


@pytest.mark.parametrize("changed", [{"moe_intermediate_size": 704},
                                     {"qk_rope_head_dim": 32},
                                     {"num_experts": 8}])
def test_a_change_not_listed_in_reduced_fails(tmp_path, stub_driver,
                                              changed):
    conf, bench, pkg = synthetic(tmp_path, "stub_moe", **changed)
    with pytest.raises(AssertionError):
        check_config(conf, bench, pkg)


def test_a_width_missing_from_the_published_file_fails(tmp_path,
                                                       stub_driver):
    conf, bench, pkg = synthetic(tmp_path, "stub_moe", head_dim=192)
    with pytest.raises(AssertionError):
        check_config(conf, bench, pkg)


def test_a_config_without_a_published_file_fails(tmp_path, stub_driver):
    conf, bench, pkg = synthetic(tmp_path, "stub_moe")
    (pkg / "configs" / "published" / "synthetic-moe.json").unlink()
    with pytest.raises(FileNotFoundError):
        check_config(conf, bench, pkg)
