"""The harness finds every cell, configuration, traffic mix, limit and
metric by its name in BENCHMARK.json, and the file keeps to the contract's
shape; each configuration file holds the port's preset as it is run."""

import dataclasses
import json
import re

import pytest

from portbench_tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_is_found_by_name(w):
    from portbench.harness.spec import Cell, load_benchmark, metric_reader

    cell = Cell(load_benchmark(), w)
    assert (ROOT / "portbench" / "harness" / f"{cell.traffic['kind']}.py").exists()
    checks = {"serve": {"rgb_gap", "state_gap", "start_gap"},
              "train": {"loss_gap", "grad_gap", "change_gap", "pool_gap"}}
    assert set(cell.limits) == checks[cell.traffic["kind"]]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(metric_reader(m["name"]))
        assert m["moves"] in names


def test_names_units_and_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("config,preset", [("edge_conditioned", "edge_conditioned"),
                                           ("video_motion", "video_motion")])
def test_configuration_is_the_ports_preset(config, preset):
    from vsnca_tpu_torch.train.presets import PRESETS

    data = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    nca, loss, train = PRESETS[preset]()
    for group, obj in (("nca", nca), ("loss", loss), ("train", train)):
        fields = dataclasses.asdict(obj)
        for k, v in data[group].items():
            if k in fields:
                want = list(fields[k]) if isinstance(fields[k], tuple) else fields[k]
                assert v == want, (group, k)
