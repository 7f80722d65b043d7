"""BENCHMARK.json names only files that exist, and keeps to the shape the
benchmark's runs and checks rely on."""
import json
import os
import re

import pytest

from wavebench import harness

ROOT = harness.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["wavebench"]
    assert BENCH["command"] == ["python3", "wavebench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_configs_name_files_that_exist():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("wavebench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert harness.load_json(os.path.join(ROOT, c["file"]))["name"] == c["name"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workloads_name_files_that_exist(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    spec = harness.Spec(w["name"])
    assert set(spec.cell["limits"]) == set(spec.op.CHECKS)
    for m in spec.metrics("end_to_end") + spec.metrics("per_layer"):
        assert os.path.isfile(os.path.join(ROOT, "wavebench", "metrics", m["name"] + ".py"))


def test_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        spec = harness.Spec(w["name"])
        e2e = [m["name"] for m in spec.metrics("end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2 and spec.metrics("per_layer")
