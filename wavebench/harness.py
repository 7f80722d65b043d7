"""One run of one benchmark cell, driven by data.

``BENCHMARK.json`` names the cell, its configuration (the file the entry
names) and its traffic, whose name up to its first dot names the operation,
``traffic/<operation>.py`` (traffic ``roundtrip`` and a later
``roundtrip.single`` both run ``traffic/roundtrip.py``); the cell's
parameters are ``workloads/<cell>.json`` (the input's shape and kind, the
operation's parameters, the calls in flight, the limits of the check), and
each metric's reader is ``metrics/<metric>.py``.  So a cell, a configuration or a metric is added
by adding files and entries.

A run: set-up (the card's check, the inputs from the seed on the card, the
kernel library built or loaded, a warm-up of the cell's own shapes), then a
closed-loop window: before issuing call i the host waits for call
i - inflight to end, every call records a CUDA event at its end, and the
host issues calls until ``--seconds`` have passed.  With ``--trace 1`` the
window runs under ``torch.profiler`` (at most ``TRACE_SECONDS``) and the
per-layer metrics are read from it.  Then the outputs of two calls (one
drawn from the seed, and the last) are compared with the plain reference,
and one JSON line is printed.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
#: the checkout the benchmark runs from
ROOT = os.path.dirname(HERE)
#: top-level module names the run may not hold (the JAX package and JAX)
BANNED = frozenset(("jax", "jaxlib", "flax", "pdwt_tpu"))
WARMUP_CALLS = 8
#: the longest traced window, seconds: the per-layer metrics are means per
#: call, and a longer trace only costs the time to read it
TRACE_SECONDS = 2.0
#: the compared call drawn from the seed lies among the first calls
SAMPLE_FROM = 16


def cache_env(root: str = ROOT) -> Dict[str, str]:
    """Fixed build and kernel-cache directories inside the checkout."""
    cache = os.path.join(root, ".wavebench_cache")
    return {"PDWT_TPU_COMPILE_CACHE": os.path.join(root, "pdwt_tpu_torch", "kernels", "_build"),
            "TORCH_EXTENSIONS_DIR": os.path.join(cache, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(cache, "triton"),
            "CUDA_CACHE_PATH": os.path.join(cache, "cuda")}


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import a file of the benchmark by its path (metric and traffic names
    may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError(f"cannot import {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that equal a banned name whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


class Spec:
    """``BENCHMARK.json`` and the files it names, for one cell."""

    def __init__(self, name: str, root: str = ROOT, cell: Optional[dict] = None):
        self.root = root
        self.dir = os.path.join(root, "wavebench")
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"wavebench: no workload {name!r} in BENCHMARK.json")
        self.entry = entries[name]
        self.name = name
        self.cell = cell or load_json(os.path.join(self.dir, "workloads", f"{name}.json"))
        cfg = {c["name"]: c for c in self.bench["configs"]}[self.entry["config"]]
        self.config = load_json(os.path.join(root, cfg["file"]))
        op = self.entry["traffic"].split(".")[0]
        self.op = load_module(os.path.join(self.dir, "traffic", f"{op}.py"), f"wavebench_op_{op}")

    def metrics(self, kind: str) -> List[dict]:
        """The metrics of ``kind`` ("end_to_end" or "per_layer") this cell
        reports."""
        return [m for m in self.bench[kind] if self.name in m.get("workloads", [self.name])]


class HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the host's clock, for runs of
    the harness on the CPU (its tests)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


def make_event(device) -> Callable[[], object]:
    if device.type == "cuda":
        import torch

        return lambda: torch.cuda.Event(enable_timing=True)
    return HostEvent


def closed_loop(call: Callable, x, seconds: float, inflight: int, keep: int, device):
    """One window (module docstring): its calls, length, intervals between
    end events, host seconds per call, and the outputs of call ``keep``
    and of the last call."""
    import torch

    from wavebench import tracing

    event = make_event(device)
    ends, host, kept = [], [], []
    start = event()
    start.record()
    stop = time.perf_counter() + seconds
    out = None
    while not ends or time.perf_counter() < stop:
        i = len(ends)
        if i >= inflight:
            ends[i - inflight].synchronize()
        with torch.profiler.record_function(tracing.SPAN + "call"):
            h0 = time.perf_counter()
            out = call(x)
            host.append(time.perf_counter() - h0)
        e = event()
        e.record()
        ends.append(e)
        if i == keep:
            kept.append(out)
    ends[-1].synchronize()
    if len(ends) - 1 != keep:
        kept.append(out)
    marks = [start] + ends
    intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return SimpleNamespace(calls=len(ends), window_s=start.elapsed_time(ends[-1]) / 1e3,
                           intervals_ms=intervals, host_s=host, kept=kept)


def power_limit_w() -> Optional[float]:
    """The card's power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def read_metrics(spec: Spec, kind: str, reading) -> dict:
    """{name: {value, unit}} of the metrics whose reader found a value."""
    out = {}
    for m in spec.metrics(kind):
        mod = load_module(os.path.join(spec.dir, "metrics", f"{m['name']}.py"),
                          f"wavebench_metric_{m['name']}")
        value = mod.read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(spec: Spec, seed: int, seconds: float, trace: bool, device, t0: float):
    """Set-up, the window, the check; returns the result line's dict (the
    check's numbers last, under ``checks``)."""
    import torch

    from wavebench import inputs, tracing

    marks = {"torch": time.perf_counter()}
    cell, cfg, op = spec.cell, spec.config, spec.op
    # the products' precision as the configuration states it
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    import pdwt_tpu_torch as P
    from pdwt_tpu_torch.kernels import LAUNCHES, _build

    marks["program"] = time.perf_counter()
    ndim, inflight = int(cfg["ndim"]), int(cell["inflight"])
    x = inputs.make(cell["input"], cell["shape"], ndim, inputs.generator(seed, device), device)
    call = op.program_call(P, cfg, cell)
    keep = random.Random(seed).randrange(SAMPLE_FROM)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks["inputs"] = time.perf_counter()
    # the warm-up holds every output it makes, so the allocator's pool has
    # room for the window's calls in flight and its kept outputs
    warm = [call(x) for _ in range(WARMUP_CALLS)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    del warm
    power = power_limit_w() if trace and device.type == "cuda" else None
    setup_s = time.perf_counter() - t0
    marks["warm-up"] = t0 + setup_s
    last, stages = t0, []
    for stage, t in marks.items():  # where set-up went, in order
        stages.append(f"{stage} {t - last:.3f}")
        last = t

    def window():
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        return closed_loop(call, x, min(seconds, TRACE_SECONDS) if trace else seconds,
                           inflight, keep, device)

    names = tracing.port_kernels(_build.SOURCES)
    if trace:
        win, t = tracing.profiled(window, lambda: sum(LAUNCHES.values()), names)
        if t is None:
            raise SystemExit("wavebench: three traced windows fell short of the launch counters")
    else:
        win, t = window(), None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"wavebench: {win.calls} calls in {win.window_s:.4f} s, host "
          f"{sum(win.host_s) / len(win.host_s) * 1e3:.4f} ms a call, set-up {setup_s:.3f} s "
          f"({', '.join(stages)})",
          file=sys.stderr)
    flops, nbytes = op.work(cfg, cell)
    reading = SimpleNamespace(
        calls=win.calls, window_s=win.window_s, intervals_ms=win.intervals_ms, host_s=win.host_s,
        samples_per_call=math.prod(cell["shape"]), setup_s=setup_s, peak_bytes=peak,
        flops=flops, bytes=nbytes, trace=t,
        device_kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        peaks=load_json(os.path.join(spec.dir, "peaks.json")))
    metrics = read_metrics(spec, "per_layer" if trace else "end_to_end", reading)

    limits = cell["limits"]
    checks = {name: 0.0 for name in op.CHECKS}
    failed = 0
    for out in win.kept:
        got = op.check(out, x, cfg, cell)
        failed += any(not got[n] <= limits[n] for n in op.CHECKS)
        checks = {n: max(checks[n], got[n]) for n in op.CHECKS}
    correct = failed == 0
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": reading.device_kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": win.calls, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = t.busy_ms_per_call * win.calls / 1e3
        dev["window_s"] = win.window_s
        dev["power_limit_w"] = power
        result["breakdown"] = t.breakdown
    result["checks"] = {n: {"value": checks[n], "limit": limits[n]} for n in op.CHECKS}
    return result


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    spec = Spec(args.workload)
    import torch

    chips = int(spec.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"wavebench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)
    program = os.path.abspath(sys.modules["pdwt_tpu_torch"].__file__)
    if not program.startswith(spec.root + os.sep):
        print(f"wavebench: pdwt_tpu_torch comes from {program}, not the checkout", file=sys.stderr)
        return 3
    found = banned_modules()
    if found:
        print(f"wavebench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
