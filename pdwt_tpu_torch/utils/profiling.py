"""Timing and tracing (counterpart of ``pdwt_tpu/utils/profiling.py``).

* :func:`device_time` / :func:`device_time_any`: device seconds per call
  by JAX's slope method.  Chains of ``M1`` and ``M2`` calls are each run
  ``K`` times, sampled interleaved ``reps`` times, and the slope
  ``(t(M2) - t(M1)) / (K (M2 - M1))`` of the two minima cancels every
  fixed cost of a run.  JAX times one jitted ``fori_loop``, one device
  program with no host between the calls; on the card the port captures
  each chain once in a ``torch.cuda.CUDAGraph`` (after one warm eager
  chain, which builds the kernels and uploads their taps) and times ``K``
  replays between two CUDA events.  A ``fn`` that cannot be captured (a
  host sync, say) raises with the capture's error; nothing falls back to
  eager timing.  On the CPU the chains run eagerly between
  ``time.perf_counter`` reads.
* :func:`trace`: ``torch.profiler`` over a block (CPU activity, and CUDA
  activity where a card is present), written as a Chrome trace into
  ``log_dir`` (a fresh temporary directory by default).
* The span recorder: :func:`spanned` marks the port's functions at its
  layer boundaries, each span named ``pdwt.<layer>.<function>`` --
  ``facade`` (``Wavelets.forward``, ``inverse``, ``run_denoise``),
  ``models`` (the denoising steps and denoisers, ``ista``),
  ``transform`` (the entry points of ``core/separable.py`` and
  ``core/separable3d.py``), ``ops`` (the norms and thresholds) and
  ``kernels`` (each CUDA kernel wrapper, under its ``LAUNCHES`` key); :func:`span` marks a
  block.  The recorder is on while a ``torch.profiler`` session runs
  and inside :func:`record_spans`, the host-only reading, and off
  otherwise, where a span is one check of that state and a plain call.
  On, a span opens a ``torch.profiler.record_function`` range of its
  name while the profiler runs (on the profiler's clock, the one the
  device events use), and adds its count, its time and its self time
  (its time less its child spans') to the table :func:`span_table`
  reads and :func:`reset_spans` clears.  A kernel span also adds the
  operand bytes of its call -- every tensor the wrapper takes and returns,
  each once -- to ``OPERAND_BYTES[<kernel>]``, and an ``ops`` span that no
  other ops span holds adds its call's, counted alike, to
  ``OPS_OPERAND_BYTES[<function>]`` (an ops function run inside another's
  span is not counted twice).
  ``NORM_PATHS`` counts the thresholded L1 norms by route, fused into
  kernel 5 or 7 or plain torch, and ``DENOISE_PATHS`` the
  ``Wavelets.run_denoise`` calls by where the threshold ran, in a kernel
  or in the threshold ops.
"""
from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return []


def _on_cuda(args) -> bool:
    return any(t.is_cuda for a in args for t in _leaves(a))


def _slope(run1, run2, K: int, M1: int, M2: int, reps: int) -> float:
    """JAX's interleaved minima: the slope of the two chains' best times."""
    t1 = t2 = float("inf")
    for _ in range(reps):
        t1 = min(t1, run1())
        t2 = min(t2, run2())
    return (t2 - t1) / (K * (M2 - M1))


def _graph_runner(chain, K: int):
    """Capture ``chain()`` once in a CUDA graph (after a warm eager run on
    a side stream) and return a function timing ``K`` replays in seconds,
    with the graph's outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()  # warm: builds the kernels, uploads the taps
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chain()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run() -> float:
        start.record()
        for _ in range(K):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3

    run.graph, run.out = graph, out
    return run


def _eager_runner(chain, K: int):
    chain()  # warm

    def run() -> float:
        t0 = time.perf_counter()
        for _ in range(K):
            chain()
        return time.perf_counter() - t0

    return run


def _runners(make_chain, args, K: int, M1: int, M2: int):
    cuda = _on_cuda(args)
    runner = _graph_runner if cuda else _eager_runner
    return runner(make_chain(M1), K), runner(make_chain(M2), K)


def device_time(fn, arg, *, K: int = 8, M1: int = 1, M2: int = 5, reps: int = 8) -> float:
    """Device seconds per ``fn(x) -> x``-shaped call (module docstring):
    the chains feed each call's output to the next."""
    def make_chain(M):
        def chain():
            v = arg
            for _ in range(M):
                v = fn(v)
            return v
        return chain

    with torch.no_grad():
        r1, r2 = _runners(make_chain, (arg,), K, M1, M2)
        return _slope(r1, r2, K, M1, M2, reps)


def device_time_any(fn, *args, K: int = 24, M1: int = 1, M2: int = 4, reps: int = 3) -> float:
    """Device seconds per call of a shape-changing ``fn(*args)``: as JAX
    chains it, every input is perturbed by a tiny scalar probe of the
    previous output (forcing sequential execution without asking ``fn``
    to be an endomorphism), so the result slightly overestimates cheap
    calls (one add an input a call)."""
    def probe(out):
        s = None
        for t in _leaves(out):
            v = t.reshape(-1)[0]
            v = (v.real if v.is_complex() else v).float()
            s = v if s is None else s + v
        return s * 1e-30

    def make_chain(M):
        def chain():
            s = None
            for _ in range(M):
                xs = args if s is None else [a + s.to(a.dtype) for a in args]
                s = probe(fn(*xs))
            return s
        return chain

    with torch.no_grad():
        r1, r2 = _runners(make_chain, args, K, M1, M2)
        return _slope(r1, r2, K, M1, M2, max(reps, 6))


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile a block: ``with trace("dir"): run()`` writes
    ``dir/trace.json`` (a Chrome trace: CPU ops and the port's spans, and
    the card's kernels where one is present) and yields ``dir``; without a
    ``log_dir``, a new directory ``pdwt_trace_*`` under the system's
    temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="pdwt_trace_")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# the span recorder (module docstring)
# ---------------------------------------------------------------------------

#: the profiler's state: True while a ``torch.profiler`` session runs
_profiler_on = torch.autograd._profiler_enabled
#: open :func:`record_spans` blocks
_explicit = 0
#: name -> [count, total ns, self ns]
_TABLE: Dict[str, List[int]] = {}
#: operand bytes by kernel wrapper (the keys of ``kernels.LAUNCHES``),
#: counted while the recorder is on
OPERAND_BYTES: Dict[str, int] = {}
#: operand bytes by ops function (``soft_threshold``, ``norm1``, ...), of
#: the outermost ops span of a call, counted while the recorder is on
OPS_OPERAND_BYTES: Dict[str, int] = {}
#: thresholded L1 norms by route, counted while the recorder is on: "fused"
#: (kernel 5's or kernel 7's epilogue, ``ops.norms.sum_norm_partials``)
#: and "plain" (``ops.thresholded_norm1``)
NORM_PATHS: Dict[str, int] = {"fused": 0, "plain": 0}
#: ``Wavelets.run_denoise`` calls by where the threshold ran, counted while
#: the recorder is on: "fused" (in a kernel: kernel 7's norm launches in
#: 1D, the thresholding syntheses of ``iswt2d_denoise``/``iswt3d_denoise``)
#: and "plain" (the threshold ops)
DENOISE_PATHS: Dict[str, int] = {"fused": 0, "plain": 0}
_local = threading.local()


def recording() -> bool:
    """Is the recorder on?"""
    return _explicit > 0 or _profiler_on()


@contextlib.contextmanager
def record_spans():
    """Turn the recorder on for a block, without the profiler."""
    global _explicit
    _explicit += 1
    try:
        yield
    finally:
        _explicit -= 1


def span_table() -> Dict[str, Dict[str, int]]:
    """{span name: {"count", "total_ns", "self_ns"}} since the last
    :func:`reset_spans`."""
    return {k: {"count": c, "total_ns": t, "self_ns": s} for k, (c, t, s) in _TABLE.items()}


def reset_spans() -> None:
    """Clear the span table, ``OPERAND_BYTES`` and ``OPS_OPERAND_BYTES``, and
    zero ``NORM_PATHS`` and ``DENOISE_PATHS``."""
    _TABLE.clear()
    OPERAND_BYTES.clear()
    OPS_OPERAND_BYTES.clear()
    for paths in (NORM_PATHS, DENOISE_PATHS):
        for k in paths:
            paths[k] = 0


class _Span:
    """One recorded span (the recorder on)."""

    __slots__ = ("name", "range", "stack", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = None
        if _profiler_on():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(0)  # the time of this span's children
        self.stack = stack
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        child = self.stack.pop()
        if self.stack:
            self.stack[-1] += dt
        row = _TABLE.get(self.name)
        if row is None:
            row = _TABLE[self.name] = [0, 0, 0]
        row[0] += 1
        row[1] += dt
        row[2] += dt - child
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A span over a block: ``with span("pdwt.<layer>.<block>"): ...``;
    with the recorder off, one shared no-op context."""
    return _Span(name) if recording() else _OFF


def operand_bytes(*objs) -> int:
    """The ``nbytes`` of every tensor in ``objs`` (tuples, lists and dict
    values flattened), each tensor once."""
    seen, total, todo = set(), 0, list(objs)
    while todo:
        o = todo.pop()
        if isinstance(o, torch.Tensor):
            if id(o) not in seen:
                seen.add(id(o))
                total += o.nbytes
        elif isinstance(o, (tuple, list)):
            todo.extend(o)
        elif isinstance(o, dict):
            todo.extend(o.values())
    return total


def spanned(layer: str):
    """Decorate a function of the port's ``layer`` with a span named
    ``pdwt.<layer>.<qualified name>`` (the wrapper's ``span_name``); a
    ``kernels`` span also counts the operand bytes of its call in
    ``OPERAND_BYTES[<name>]``, and an ``ops`` span outside any other ops
    span in ``OPS_OPERAND_BYTES[<name>]``."""
    def deco(fn):
        name = f"pdwt.{layer}.{fn.__qualname__}"
        counts = {"kernels": OPERAND_BYTES, "ops": OPS_OPERAND_BYTES}.get(layer)
        key = fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_explicit or _profiler_on()):
                return fn(*args, **kwargs)
            with _Span(name):
                if layer != "ops":
                    out = fn(*args, **kwargs)
                elif getattr(_local, "in_ops", False):  # counted by the outer ops span
                    return fn(*args, **kwargs)
                else:
                    _local.in_ops = True
                    try:
                        out = fn(*args, **kwargs)
                    finally:
                        _local.in_ops = False
                if counts is not None:
                    counts[key] = counts.get(key, 0) + operand_bytes(args, kwargs, out)
            return out

        wrapper.span_name = name
        return wrapper

    return deco
