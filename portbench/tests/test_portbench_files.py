"""Every cell's files are found by the names BENCHMARK.json gives, and
the file keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from portbench import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = cells.find_cell(BENCH, cell)
    cfg = cells.load_config(w["config"])
    assert cfg["name"] == w["config"]
    assert os.path.isfile(cfg["template_path"])
    traffic = cells.load_traffic(w["traffic"])
    assert traffic["name"] == w["traffic"]
    assert len(traffic["phase_rot"]) == len(traffic["ddm"])
    limits = cells.load_limits(cell)
    assert limits["missing_toas"] == 0
    assert w["chips"] == 1


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = cells.metric_reader(metric)
    empty = {"events": [], "window_s": 0.0, "busy_s": 0.0, "device": [],
             "b1_calls": []}
    assert read(empty) is None   # nothing to read: no value, never 0


def test_benchmark_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert json.load(open(os.path.join(cells.ROOT, c["file"])))[
            "reduced"] == c["reduced"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"toas_per_s", "setup_s"} <= e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if "roofline" in m["name"]:
            # a kernel's share of its roofline: <kernel>_roofline, in %
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
