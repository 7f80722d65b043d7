"""The harness driven on the CPU through the program's plain path: a whole
run but the card's check and timing, a cell, configuration and metric found
from added files alone, and the command's refusal without a card."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch
from tiny_cells import TINY, tiny_cell

from wavebench import harness

ROOT = harness.ROOT


@pytest.mark.parametrize("name", sorted(TINY))
def test_cpu_run(name):
    res = harness.run(harness.Spec(name, cell=tiny_cell(name)), 3000000019, 0.2, False,
                      torch.device("cpu"), time.perf_counter())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert {"throughput", "call_ms_p95", "setup_s"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    json.dumps(res)


def _copy_benchmark(dst):
    shutil.copytree(os.path.join(ROOT, "wavebench"), os.path.join(dst, "wavebench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)


#: a 3D configuration and its cells, added as data: the operations take
#: the transformed axes from the configuration
DB4_3D = {"name": "db4_3d", "wavelet": "db4", "ndim": 3, "boundary": "periodization",
          "dtype": "float32", "precision": None, "tf32": False, "reduced": []}
CELLS_3D = {
    "roundtrip": {"shape": [2, 16, 32, 32], "levels": 2, "inflight": 3,
                  "input": {"kind": "uniform", "low": 0, "high": 255},
                  "limits": {"coeff_err": 5e-5, "recon_err": 1e-4}},
    "ti_step": {"shape": [16, 32, 32], "levels": 2, "beta": 1.0, "threshold": "soft",
                "inflight": 3, "limits": {"denoised_err": 1e-4, "norm_err": 1e-5},
                "input": {"kind": "phantom", "low": 0, "high": 255, "ellipsoids": 4,
                          "noise_sigma": 0.2}},
}


@pytest.mark.parametrize("traffic", sorted(CELLS_3D))
def test_new_cell_config_and_metric_from_added_files(tmp_path, traffic):
    _copy_benchmark(tmp_path)
    wb = tmp_path / "wavebench"
    name = f"db4_3d.{traffic}"
    (wb / "configs" / "db4_3d.json").write_text(json.dumps(DB4_3D))
    (wb / "workloads" / f"{name}.json").write_text(json.dumps(CELLS_3D[traffic]))
    (wb / "metrics" / "calls_in_window.py").write_text("def read(r):\n    return r.calls\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "db4_3d", "source": "x", "file": "wavebench/configs/db4_3d.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": name, "config": "db4_3d", "traffic": traffic,
                               "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "calls_in_window", "unit": "count", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.Spec(name, root=str(tmp_path))
    res = harness.run(spec, 5, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert res["correct"]
    assert res["metrics"]["calls_in_window"]["value"] == res["attempted"]
    other = harness.Spec(f"db7_2d.{traffic}", root=str(tmp_path)).metrics("end_to_end")
    assert "calls_in_window" not in [m["name"] for m in other]


def test_a_second_mix_of_an_operation_from_added_files(tmp_path):
    _copy_benchmark(tmp_path)
    name = "db7_2d.roundtrip.single"
    cell = dict(tiny_cell("db7_2d.roundtrip"), shape=[128, 64])
    (tmp_path / "wavebench" / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "db7_2d", "traffic": "roundtrip.single",
                               "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run(harness.Spec(name, root=str(tmp_path)), 6, 0.1, False, torch.device("cpu"),
                      time.perf_counter())
    assert res["correct"] and set(res["checks"]) == {"coeff_err", "recon_err"}


def _command(cwd):
    return subprocess.run([sys.executable, "wavebench/run.py", "--workload", "db7_2d.roundtrip",
                           "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_command_without_a_card_prints_no_result():
    proc = _command(ROOT)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_command_without_the_program_prints_no_result(tmp_path):
    _copy_benchmark(tmp_path)
    proc = _command(str(tmp_path))
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_the_configuration_states_type_and_precision(monkeypatch):
    name = "db7_2d.roundtrip"
    spec = harness.Spec(name, cell=tiny_cell(name))
    spec.config = dict(spec.config, tf32=True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert harness.run(spec, 11, 0.1, False, torch.device("cpu"), time.perf_counter())["correct"]
    assert torch.backends.cuda.matmul.allow_tf32
    spec.config = dict(spec.config, dtype="float64")
    with pytest.raises(ValueError):
        harness.run(spec, 11, 0.1, False, torch.device("cpu"), time.perf_counter())
