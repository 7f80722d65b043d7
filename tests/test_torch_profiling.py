"""``utils.profiling`` on the CPU: the slope method of ``device_time`` and
``device_time_any`` (the eager chains between ``time.perf_counter`` reads)
cancels a fixed cost of each chain, and ``trace`` writes its Chrome trace
(by default into a directory of its own).
The CUDA-graph timing runs on the card (``chip_smoke.py``'s backends
phase)."""
import json
import os
import shutil
import time

import pytest
import torch

from pdwt_tpu_torch.utils import device_time, device_time_any, trace

PER_CALL, PER_CHAIN = 0.004, 0.030


def _costly():
    """A call of PER_CALL seconds, whose chain pays PER_CHAIN once (on the
    first call, fed the original input)."""
    origin = torch.zeros(8)

    def fn(x):
        time.sleep(PER_CALL + (PER_CHAIN if x is origin else 0.0))
        return x + 1
    return fn, origin


def test_device_time_is_the_slope_and_cancels_a_fixed_cost():
    fn, x = _costly()
    t = device_time(fn, x, K=2, M1=1, M2=3, reps=2)
    # a chain of M calls costs PER_CHAIN + M * PER_CALL; the mean over the
    # chain would read (PER_CHAIN + PER_CALL) for M = 1
    assert 0.5 * PER_CALL < t < PER_CALL + 0.25 * PER_CHAIN


def test_device_time_any_chains_a_shape_changing_function():
    calls = []

    def fn(a, b):
        calls.append(1)
        time.sleep(PER_CALL)
        return (a @ b).sum(), a.mean()

    t = device_time_any(fn, torch.ones(4, 3), torch.ones(3, 5), K=2, M1=1, M2=2, reps=1)
    assert t > 0.5 * PER_CALL
    assert len(calls) == (1 + 2) + 6 * 2 * (1 + 2)  # one warm run a chain, 6 samples of K = 2


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "tr")
    with trace(log_dir) as d:
        assert d == log_dir
        torch.nn.functional.conv2d(torch.ones(1, 1, 8, 8), torch.ones(1, 1, 3, 3))
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


def test_trace_closes_on_an_error(tmp_path):
    with pytest.raises(RuntimeError):
        with trace(str(tmp_path)):
            raise RuntimeError("inside")
    assert os.path.isfile(tmp_path / "trace.json")


def test_two_default_traces_land_apart():
    dirs = []
    try:
        for _ in range(2):
            with trace() as d:
                torch.ones(3).sum()
            dirs.append(d)
        assert dirs[0] != dirs[1]
        assert all(os.path.basename(d).startswith("pdwt_trace_") for d in dirs)
        assert all(os.path.isfile(os.path.join(d, "trace.json")) for d in dirs)
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
