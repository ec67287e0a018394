"""BENCHMARK.json against the benchmark's contract, and every cell, file
and per-layer metric found by its name."""
import json
import re

import pytest

from bench import spec, train
from bench.reference.dims import Dims

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in BENCH[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and 1 <= len(e["why"]) <= 200
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"train_tokens_per_s", "train_peak_gb", "setup_s"}
    assert cell.per_layer and set(cell.limits) == {"loss_gap", "grad_gap", "change_gap",
                                                   "nonfinite_losses"}
    for lim in cell.limits.values():
        assert lim >= 0
    assert set(cell.traffic) == {"seq_len", "global_batch", "optimizer"}


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads_by_name(name):
    m = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]} and m["layer"]
    mod = spec.metric_module(name)
    assert callable(mod.read)
    # a metric timed from the trace names the program's function it times
    assert (m["source"] == "device_trace") == (hasattr(mod, "WRAPS") or name == "device_idle_pct")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config_file_states_what_runs(entry):
    """The file is the configuration as run: its keys cut from the source
    are in ``reduced`` with the published values beside them, and the
    program's model built from it has the registry's published widths."""
    from repro_torch.configs.registry import get_config

    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    assert sorted(cfg["published"]) == sorted(entry["reduced"])
    for k in entry["reduced"]:
        assert cfg[k] != cfg["published"][k]
        assert not (k.endswith(("_dim", "_rank", "_size")) or "width" in k)
    dm = Dims.of(cfg)
    full = get_config(cfg["port_arch"])
    fields = train.port_fields(cfg, dm)
    assert fields.pop("n_layers") < full.n_layers
    for k, v in fields.items():
        assert getattr(full, k) == v, k


def test_metric_coverage_each_cell():
    for name in CELLS:
        cell = spec.load_cell(name)
        assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
        assert cell.per_layer

