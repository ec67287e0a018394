"""What ``BENCHMARK.json`` and the data files under ``bench/`` say about a cell.

Everything is found by name: the cell in ``BENCHMARK.json``'s
``workloads``, its configuration in ``bench/configs/<config>.json``, its
traffic in ``bench/traffic/<traffic>.json``, the limits of its correctness
comparison in ``bench/workloads/<cell>.json`` and each per-layer metric's
reader in ``bench/metrics/<metric>.py``. A new configuration, traffic mix,
cell or metric is a new file (and a new entry in ``BENCHMARK.json``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict           # the configuration file's object
    traffic_name: str
    traffic: dict          # the traffic file's object
    limits: dict           # name -> limit of each number compared
    end_to_end: list       # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list        # and its per-layer metrics


def _load(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(root / configs[w["config"]]["file"])
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=_load(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=_load(BENCH / "workloads" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)],
    )


def metric_module(name: str):
    """``bench/metrics/<name>.py``: its ``read(run)``, and where the metric
    times a function of the program, that function as ``WRAPS``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
