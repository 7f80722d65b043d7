"""What a traced window gives: device time per call by kernel name, the
launches per call, and the breakdown of device operations and idle gaps,
read from ``torch.profiler`` and the program's launch counters.

The profiler now and then drops a few of a kernel's events.  So a name's
time per call is its mean per recorded event times its launches per call,
its recorded events over the window's calls rounded up (every call
launches the same kernels, and a drop only lowers the count), and the
program's own kernels are held to its launch counters: a window where
they do not add up is read as nothing, and the harness profiles again.
"""
from __future__ import annotations

import bisect
import re
import sys
from types import SimpleNamespace
from typing import Callable, Dict, Iterable, List, Tuple

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)")
_ANON = re.compile(r"(?:void )?\(anonymous namespace\)::(\w+)[<(]")
#: the prefix of the benchmark's own ``record_function`` ranges
SPAN = "wavebench."
TOP = 10


def port_kernels(sources: Iterable[str]) -> frozenset:
    """The ``__global__`` function names of the program's CUDA sources."""
    names = set()
    for src in sources:
        with open(src) as fh:
            names.update(_GLOBAL.findall(fh.read()))
    return frozenset(names)


def is_port_kernel(event_name: str, names: frozenset) -> bool:
    """Is a device event one of the program's kernels?  They sit in the
    sources' top-level anonymous namespace."""
    m = _ANON.match(event_name)
    return m is not None and m.group(1) in names


def is_annotation(event) -> bool:
    """A ``record_function`` range that the profiler mirrors on the
    device's timeline: no work of the device."""
    return bool(getattr(event, "is_user_annotation", False)) or event.name.startswith(SPAN)


def busy_per_call(events: List[Tuple[str, float]], reps: int, launched: int, names: frozenset):
    """(busy ms per call, {name: ms per call}, {name: launches per call})
    from one window of ``reps`` calls, ``events`` its device events as
    (name, ms) and ``launched`` what the program's launch counters gained
    over it; None where the program's kernels do not add up to the
    counters or the window recorded nothing (module docstring)."""
    sums: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for name, ms in events:
        sums[name] = sums.get(name, 0.0) + ms
        counts[name] = counts.get(name, 0) + 1
    per_call = {k: -(-n // reps) for k, n in counts.items()}
    if not sums or reps * sum(n for k, n in per_call.items() if is_port_kernel(k, names)) != launched:
        return None
    by_name = {k: sums[k] / counts[k] * per_call[k] for k in sums}
    return sum(by_name.values()), by_name, per_call


def _top(totals: Dict[str, float]) -> List[list]:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def breakdown(device: List[Tuple[str, float, float]], host: List[Tuple[str, float, float]]):
    """{"device_ops": the device operations that took most time, "idle_gaps":
    the device's idle time between its operations summed by what the host
    was running at each gap's middle (the innermost host range covering
    it)}, in seconds; intervals are (name, start us, end us)."""
    totals: Dict[str, float] = {}
    for name, s, e in device:
        totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps: Dict[str, float] = {}
    device = sorted(device, key=lambda d: d[1])
    last_end = device[0][2] if device else 0.0
    for name, s, e in device[1:]:
        if s > last_end:
            mid = (s + last_end) / 2
            label = "no host range"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if host[j][2] >= mid:
                    label = host[j][0]
                    break
            gaps[label] = gaps.get(label, 0.0) + (s - last_end) / 1e6
        last_end = max(last_end, e)
    return {"device_ops": _top(totals), "idle_gaps": _top(gaps)}


def profiled(window: Callable[[], object], launches: Callable[[], int], names: frozenset,
             attempts: int = 3):
    """Run ``window()`` (one closed-loop window; it returns an object with
    ``calls``) under the profiler until the program's kernels add up,
    ``attempts`` windows at most.  Returns (the window, a namespace of the
    per-call readings and the breakdown), or (the last window, None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    win = None
    for _ in range(attempts):
        before = launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            win = window()
        launched = launches() - before
        dev, host = [], []
        for e in prof.events():
            iv = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append(iv)
            elif not is_annotation(e):
                dev.append(iv)
        busy = busy_per_call([(n, (b - a) / 1e3) for n, a, b in dev], win.calls, launched, names)
        if busy is not None:
            ms, by_name, per_call = busy
            return win, SimpleNamespace(busy_ms_per_call=ms, by_name=by_name, per_call=per_call,
                                        port_launches=launched / win.calls, names=names,
                                        breakdown=breakdown(dev, host))
        print(f"wavebench: the program's kernels in the trace fall short of its "
              f"{launched} counted launches over {win.calls} calls; profiling again",
              file=sys.stderr, flush=True)
    return win, None


def per_call_ms(t, keep: Callable[[str], bool]) -> float:
    """Device ms per call in the kernels ``keep`` accepts."""
    return sum((ms for name, ms in t.by_name.items() if keep(name)), 0.0)


def other_launches(t) -> int:
    """Launches per call of kernels that are not the program's own."""
    return sum(n for name, n in t.per_call.items() if not is_port_kernel(name, t.names))
