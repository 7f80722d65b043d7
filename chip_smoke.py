#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pdwt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root.  It builds the CUDA kernels from
``pdwt_tpu_torch/kernels/csrc``, holds each kernel against its plain
PyTorch version at the shapes of the main path, then drives the main path
(the ``Wavelets`` facade: db7, 5 levels, a 2048x2048 float32 image) and
checks its output, the launch counters and a roundtrip.  It prints one
JSON line with the per-kernel results and, last, one JSON line with
``"ok": true``.  Any failed check exits non-zero before that line; so does
a machine without a CUDA device.  Imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N, WNAME, LEVELS, BETA = 2048, "db7", 5, 10.0
# kernel vs plain version: max|diff| <= KERNEL_RTOL * max|plain|.  nvcc
# contracts each multiply-add into one FMA, the plain version rounds twice.
KERNEL_RTOL = 1e-5
# main path vs the plain path on the card, same bound and reason
PATH_RTOL = 1e-5
# max |idwt2d(dwt2d(x)) - x| on [0, 255] float32 data
ROUNDTRIP_ATOL = 1e-3
REPLACES = {
    "fwd_level_2d": "pdwt_tpu/kernels/separable_pallas.py:234",
    "inv_level_2d": "pdwt_tpu/kernels/separable_pallas.py:385",
    "fwd_tail_2d": "pdwt_tpu/kernels/separable_pallas.py:576",
    "inv_tail_2d": "pdwt_tpu/kernels/separable_pallas.py:648",
}
SOURCE = "pdwt_tpu_torch/kernels/csrc/separable.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of one fn() call over ``reps`` calls, by CUDA
    events: the time the card takes from the call's first launch to its
    last, idle gaps while the host prepares launches included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def device_ms(fn, reps: int = 10):
    """(busy milliseconds per fn() call, {kernel name: ms per call}) from
    the device activity torch.profiler records; (None, {}) when it records
    none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    if not by_name:
        return None, {}
    return sum(by_name.values()), by_name


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def max_err(got, want) -> tuple:
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return err, scale


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a CUDA card")
    from pdwt_tpu_torch import Coeffs2D, Wavelets, dwt2d, get_wavelet, idwt2d, ops
    from pdwt_tpu_torch.core import conv
    from pdwt_tpu_torch.core.shapes import level_sizes
    from pdwt_tpu_torch.kernels import _build
    from pdwt_tpu_torch.kernels import separable as K

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.library_path()}", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    wav = get_wavelet(WNAME)
    lo, hi, rlo, rhi = wav.dec_lo, wav.dec_hi, wav.rec_lo, wav.rec_hi
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.rand(s, device=dev, generator=gen) * 255.0

    # -- shapes the main path hands each kernel (core/separable.py dispatch)
    fwd_shapes, tail = [], None
    r = N
    for lvl in range(LEVELS):
        if K.tail_supported((r, r), wav.hlen, LEVELS - lvl):
            tail = (r, LEVELS - lvl)
            break
        fwd_shapes.append(r)
        r //= 2
    check(tail is not None and fwd_shapes, f"main path dispatch {fwd_shapes}, {tail}")
    inv_shapes = [n // 2 for n in reversed(fwd_shapes)]
    tail_r, tail_k = tail

    flat = lambda a, dets: [a, *[t for band in dets for t in band]]
    m0 = tail_r >> tail_k
    # (name, input, kernel, plain version, shape) for each launch of one pass
    cases = [("fwd_level_2d", rand(1, n, n), lambda x: K.fwd_level_2d(x, lo, hi),
              lambda x: K.fwd_level_2d_ref(x, lo, hi), (n, n)) for n in fwd_shapes]
    cases += [("inv_level_2d", [rand(1, m, m) for _ in range(4)],
               lambda b: K.inv_level_2d(*b, rlo, rhi),
               lambda b: K.inv_level_2d_ref(*b, rlo, rhi), (m, m)) for m in inv_shapes]
    cases.append(("fwd_tail_2d", rand(1, tail_r, tail_r),
                  lambda x: flat(*K.fwd_tail_2d(x, lo, hi, tail_k)),
                  lambda x: flat(*K.fwd_tail_2d_ref(x, lo, hi, tail_k)), (tail_r, tail_r)))
    tail_in = (rand(1, m0, m0), [tuple(rand(1, m0 << j, m0 << j) for _ in range(3))
                                 for j in range(tail_k)])
    cases.append(("inv_tail_2d", tail_in, lambda t: K.inv_tail_2d(t[0], t[1], rlo, rhi),
                  lambda t: K.inv_tail_2d_ref(t[0], t[1], rlo, rhi), (m0, m0)))

    # per kernel: worst error and the summed time of its launches in one pass
    # ms: per call by CUDA events (host launch gaps included); device_ms:
    # busy time on the card by torch.profiler
    report = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0,
                     "plain_device_ms": 0.0} for name in REPLACES}
    for name, arg, kern, plain, shape in cases:
        got, want = kern(arg), plain(arg)
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        k_ms, p_ms = cuda_ms(lambda: kern(arg)), cuda_ms(lambda: plain(arg))
        k_dev, p_dev = device_ms(lambda: kern(arg))[0], device_ms(lambda: plain(arg))[0]
        print(f"kernel {name} at {shape}: max|kernel-plain| {err:.3e} "
              f"(limit {KERNEL_RTOL * scale:.3e}); per call {k_ms:.4f} ms vs plain "
              f"{p_ms:.4f} ms; device busy {fmt(k_dev)} vs plain {fmt(p_dev)} [{card}]",
              flush=True)
        check(err <= KERNEL_RTOL * scale, f"{name} at {shape} disagrees with its plain version")
        rep = report[name]
        rep["max_abs_err"] = max(rep["max_abs_err"], err)
        rep["ms"] += k_ms
        rep["plain_ms"] += p_ms
        for key, val in (("device_ms", k_dev), ("plain_device_ms", p_dev)):
            rep[key] = None if val is None or rep[key] is None else rep[key] + val

    # -- main path: the facade, as a user drives it
    img = np.random.default_rng(0).uniform(0, 255, (N, N)).astype(np.float32)
    x = torch.from_numpy(img).to(dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    W = Wavelets(x, wname=WNAME, levels=LEVELS, device=dev)
    W.forward()
    W.soft_threshold(BETA)
    n1 = W.norm1()
    den = W.inverse()
    W2 = Wavelets(x, wname=WNAME, levels=LEVELS, device=dev)
    W2.forward()
    rt = W2.inverse()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"main path launches: {launches}", flush=True)
    for name in REPLACES:
        check(launches[name] > 0, f"the main path never launched {name}")
    check(tuple(den.shape) == (N, N) and bool(torch.isfinite(den).all()),
          "denoised image is not finite or has the wrong shape")
    rt_err = float((rt - x).abs().max())
    print(f"roundtrip max|idwt2d(dwt2d(x)) - x| = {rt_err:.3e} (limit {ROUNDTRIP_ATOL})")
    check(rt_err <= ROUNDTRIP_ATOL, "roundtrip error")

    # the plain path on the card: the kernels' plain versions, level by level
    def plain_dwt2d(t):
        a, dets = t[None], []
        for _ in range(LEVELS):
            a = conv.odd_extend(conv.odd_extend(a, -1), -2)
            a, h, v, d = K.fwd_level_2d_ref(a, lo, hi)
            dets.append((h[0], v[0], d[0]))
        return Coeffs2D(a[0], tuple(dets))

    def plain_idwt2d(c):
        rows = level_sizes(N, LEVELS)
        a = c.approx[None]
        for i in range(LEVELS - 1, -1, -1):
            h, v, d = (t[None] for t in c.details[i])
            a = K.inv_level_2d_ref(a, h, v, d, rlo, rhi)[:, :rows[i], :rows[i]]
        return a[0]

    pc = ops.soft_threshold(plain_dwt2d(x), BETA)
    p_n1 = float(ops.norm1(pc))
    p_den = plain_idwt2d(pc)
    err, scale = max_err(den, p_den)
    print(f"denoised vs plain path: max|diff| {err:.3e} (limit {PATH_RTOL * scale:.3e}); "
          f"norm1 {n1!r} vs plain {p_n1!r}", flush=True)
    check(err <= PATH_RTOL * scale, "denoised image disagrees with the plain path")
    check(abs(n1 - p_n1) <= PATH_RTOL * abs(p_n1), "norm1 disagrees with the plain path")

    # against the repository's golden coefficients (float64 reference data)
    gold = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "golden", "golden.npz"))
    gx = torch.tensor(gold["dwt2d/db7/x"], dtype=torch.float32, device=dev)
    gl = int(gold["dwt2d/db7/levels"])
    gc = dwt2d(gx, wav, gl)
    want = [gold["dwt2d/db7/a"]] + [gold[f"dwt2d/db7/L{i}/{b}"]
                                    for i in range(1, gl + 1) for b in "hvd"]
    got = [gc.approx] + [t for band in gc.details for t in band]
    gerr = max(float(np.abs(g.cpu().numpy() - w).max()) for g, w in zip(got, want))
    gscale = max(float(np.abs(w).max()) for w in want)
    yr = idwt2d(gc, wav, tuple(gx.shape))
    rerr = float((yr - gx).abs().max())
    print(f"golden dwt2d/db7 ({tuple(gx.shape)}, {gl} levels): max err {gerr:.3e} "
          f"(limit {KERNEL_RTOL * gscale:.3e}); roundtrip {rerr:.3e}")
    check(gerr <= KERNEL_RTOL * gscale and rerr <= KERNEL_RTOL * float(gx.abs().max()),
          "golden coefficients")

    # roundtrip times, kernels and plain path, on the same card in turns
    kern_rt = lambda: idwt2d(dwt2d(x, wav, LEVELS), wav, (N, N))
    plain_rt = lambda: plain_idwt2d(plain_dwt2d(x))
    times = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        times[which].append(cuda_ms(plain_rt if which == "plain" else kern_rt))
    print(f"roundtrip {N}x{N} {WNAME} {LEVELS} levels, median of 20 (CUDA events): "
          f"kernels {min(times['kernels']):.4f} ms, plain {min(times['plain']):.4f} ms "
          f"(runs {times}) [{card}]", flush=True)
    for label, fn in (("kernels", kern_rt), ("plain", plain_rt)):
        busy, by_name = device_ms(fn)
        idle = "not measured" if busy is None else f"{1 - busy / min(times[label]):.3f}"
        print(f"roundtrip {label}: device busy {fmt(busy)} per call, idle share {idle}")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {ms:.4f} ms  {kname[:100]}")

    kernels = [{"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                "launches": launches[name], **report[name]} for name in REPLACES]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
