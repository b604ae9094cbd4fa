"""The benchmark's data, found by name.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration and traffic mix; each lives in a file of its own:

- `perfbench/configs/<config>.json`: the model's published keys (as in
  its `config.json`), `reduced` (each key cut, with its published
  value), `assumed` and the deployment it stands for;
- `perfbench/mixes/<traffic>.json`: the traffic's parameters and the
  driver that runs it (`perfbench/drivers/<driver>.py`);
- `perfbench/limits/<workload>.json`: the limit of each number that
  decides the cell's `correct`.

Nothing here imports torch or the program.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

# the port's block has these fixed (`model._rms_norm`, `model._rotary`)
_PORT_FIXED = {"rms_norm_eps": 1e-6, "rope_theta": 10000.0,
               "hidden_act": "silu", "tie_word_embeddings": False,
               "attention_bias": False}


def load_json(path: Path) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """A configuration's sizes under the names the harness uses."""
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    max_seq: int
    dtype: str
    eps: float
    rope_theta: float

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def sizes(config: Dict[str, Any]) -> Sizes:
    """The sizes of a configuration file; raises where it asks for
    something the port's block does not have."""
    for key, want in _PORT_FIXED.items():
        if config.get(key, want) != want:
            raise ValueError(f"{config['name']}: {key} {config[key]!r}; the "
                             f"port's block has {want!r}")
    if config["num_key_value_heads"] != config["num_attention_heads"]:
        raise ValueError(f"{config['name']}: grouped KV heads; the port's "
                         "attention has as many KV heads as query heads")
    if config.get("num_experts"):
        raise ValueError(f"{config['name']}: experts; the reference has no "
                         "MoE layer")
    return Sizes(
        vocab=config["vocab_size"], d_model=config["hidden_size"],
        n_layers=config["num_hidden_layers"],
        n_heads=config["num_attention_heads"],
        d_ff=config["intermediate_size"],
        max_seq=config["max_position_embeddings"],
        dtype=config["torch_dtype"], eps=config["rms_norm_eps"],
        rope_theta=config["rope_theta"])


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    per_layer: List[Dict[str, Any]]
    end_to_end: List[Dict[str, Any]]

    @property
    def sizes(self) -> Sizes:
        return sizes(self.config)

    @property
    def driver(self) -> str:
        return self.mix["driver"]


def _reports(metric: Dict[str, Any], name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def cell(name: str, bench: Dict[str, Any] = None) -> Cell:
    bench = benchmark() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=w["chips"],
        config=load_json(ROOT / conf["file"]),
        mix=load_json(PKG / "mixes" / f"{w['traffic']}.json"),
        limits=load_json(PKG / "limits" / f"{name}.json"),
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)])
