"""Cells, configurations, traffic mixes and metrics are found by name from
their files, and `BENCHMARK.json` keeps to the benchmark's contract."""

import dataclasses
import json
import re

import pytest

from portbench import harness, program

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.traffic["driver"] in ("video", "train")
    assert harness.driver_class(c).__name__ == "Driver"
    assert set(c.spec["limits"]) and c.spec["check"]
    assert [m["name"] for m in c.end_to_end if m["name"] == "setup_s"] == ["setup_s"]
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]).read)


@pytest.mark.parametrize("metric", [m for m in BENCH["per_layer"]], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(metric):
    for cell in metric["workloads"]:
        reported = [m["name"] for m in harness.load_cell(cell).end_to_end]
        assert metric["moves"] in reported


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file_is_the_ports_preset(cfg):
    """Nothing cut: the file builds the port's registered preset field for
    field."""
    from bevformer_torch.configs.config import get_config

    d = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert cfg["reduced"] == [] and d["about"]["reduced"] == []
    assert program.port_config(d) == get_config(cfg["name"])
    assert dataclasses.asdict(get_config(cfg["name"])).keys() <= d.keys()


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        harness.load_cell("no.such.cell")


def test_reader_falls_back_to_the_metrics_base_name():
    for name in ("mfu.video", "mfu.train", "idle_pct.train", "dcn_roofline.video"):
        assert harness.reader(name).__file__.endswith(f"/{name.partition('.')[0]}.py")
    assert harness.reader("video_fps").__file__.endswith("/video_fps.py")
