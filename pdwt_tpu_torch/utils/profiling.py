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
  ``log_dir``.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

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
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "pdwt_trace")):
    """Profile a block: ``with trace("dir"): run()`` writes
    ``dir/trace.json`` (a Chrome trace: CPU ops, and the card's kernels
    where one is present) and yields ``dir``."""
    from torch.profiler import ProfilerActivity, profile

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
