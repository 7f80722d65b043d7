#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pdwt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root.  It builds the CUDA kernels from
``pdwt_tpu_torch/kernels/csrc`` and drives the port's three paths, each
with the launch counters set to 0 just before it and read just after:

* the DWT path: each of its four kernels against its plain PyTorch version
  at the path's shapes, then the ``Wavelets`` facade (db7, 5 levels, a
  2048x2048 float32 image), the golden coefficients and roundtrip timings;
* the TI-denoise path (``bench.py``'s second metric: db7, 3 levels, a
  1024x1024 float32 image, soft threshold at beta 10): the two stationary
  kernels against their plain versions (levels 1-3 and 6 of 1024x1024,
  every threshold, small, odd and batched shapes), then
  ``Wavelets(do_swt=True)`` through ``run_denoise`` and through
  forward/threshold/norm1/inverse, a roundtrip, the fused norm, and the
  TI step's timings;
* the batched 1D path (``bench_all.py``'s third configuration: sym8, 4
  levels, 1024 signals of 4096 float32 samples, soft threshold at beta
  0.1, ``norm1``, inverse): the four 1D kernels against their plain
  versions (the path's levels, then odd, short, long, many, Haar and
  odd-length cases), ``Wavelets(ndim=1)`` with ``do_swt`` off and on,
  through forward/threshold/norm1/inverse and ``run_denoise``, for the
  batch and for one signal, roundtrips, the golden 1D coefficients, and
  the denoise step's timings.

It prints one JSON line with the per-kernel results and, last, one JSON
line with ``"ok": true``.  Any failed check exits non-zero before that
line; so does a machine without a CUDA device.  Imports no JAX.
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
# the TI-denoise step (bench.py:126-145)
TI_N, TI_LEVELS, TI_BETA = 1024, 3, 10.0
# the batched 1D denoise step (bench_all.py:87-97): standard normal signals
B1_SIGNALS, B1_N, B1_WNAME, B1_LEVELS, B1_BETA = 1024, 4096, "sym8", 4, 0.1
# kernel vs plain version: max|diff| <= KERNEL_RTOL * max|plain|.  nvcc
# contracts each multiply-add into one FMA, the plain version rounds twice.
KERNEL_RTOL = 1e-5
# main path vs the plain path on the card, same bound and reason
PATH_RTOL = 1e-5
# max |idwt2d(dwt2d(x)) - x| (and of iswt2d(swt2d(x))) on [0, 255] float32 data
ROUNDTRIP_ATOL = 1e-3
# thresholded_norm1(c) against norm1(soft_threshold(c)): float32 sums in
# another order
NORM_RTOL = 1e-5
REPLACES = {
    "fwd_level_2d": "pdwt_tpu/kernels/separable_pallas.py:234",
    "inv_level_2d": "pdwt_tpu/kernels/separable_pallas.py:385",
    "fwd_tail_2d": "pdwt_tpu/kernels/separable_pallas.py:576",
    "inv_tail_2d": "pdwt_tpu/kernels/separable_pallas.py:648",
    "swt_fwd_level_2d": "pdwt_tpu/kernels/swt_pallas.py:95",
    "swt_inv_level_2d": "pdwt_tpu/kernels/swt_pallas.py:231",
    "fwd_level_1d": "pdwt_tpu/kernels/swt_pallas.py:395",
    "inv_level_1d": "pdwt_tpu/kernels/swt_pallas.py:455",
    "swt_fwd_level_1d": "pdwt_tpu/kernels/swt_pallas.py:528",
    "swt_inv_level_1d": "pdwt_tpu/kernels/swt_pallas.py:593",
}
SOURCES = {name: "pdwt_tpu_torch/kernels/csrc/" + (
    "batched1d.cu" if name.endswith("_1d") else
    "swt.cu" if name.startswith("swt") else "separable.cu") for name in REPLACES}


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
    the device activity torch.profiler records; (None, {}) when three
    profiled windows in a row record none (the profiler now and then
    returns a window without device events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
        if by_name:
            return sum(by_name.values()), by_name
    return None, {}


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def max_err(got, want) -> tuple:
    """(max |got - want|, max |want|) over all outputs of one call: at a
    dilation as large as the image the stationary H and D are roundoff, so
    the bound is relative to the call's largest output."""
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return err, scale


def run_cases(cases, report, card) -> None:
    """Hold each kernel call against its plain version on the same input;
    time the calls marked ``timed`` (the path's shapes) and add them to the
    kernel's row of ``report``."""
    for name, arg, kern, plain, label, timed in cases:
        got, want = kern(arg), plain(arg)
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        line = (f"kernel {name} at {label}: max|kernel-plain| {err:.3e} "
                f"(limit {KERNEL_RTOL * scale:.3e})")
        rep = report[name]
        rep["max_abs_err"] = max(rep["max_abs_err"], err)
        if timed:
            k_ms, p_ms = cuda_ms(lambda: kern(arg)), cuda_ms(lambda: plain(arg))
            k_dev, p_dev = device_ms(lambda: kern(arg))[0], device_ms(lambda: plain(arg))[0]
            line += (f"; per call {k_ms:.4f} ms vs plain {p_ms:.4f} ms; device busy "
                     f"{fmt(k_dev)} vs plain {fmt(p_dev)} [{card}]")
            rep["ms"] += k_ms
            rep["plain_ms"] += p_ms
            for key, val in (("device_ms", k_dev), ("plain_device_ms", p_dev)):
                rep[key] = None if val is None or rep[key] is None else rep[key] + val
        print(line, flush=True)
        check(err <= KERNEL_RTOL * scale, f"{name} at {label} disagrees with its plain version")


def time_in_turns(label, kern_fn, plain_fn, card) -> None:
    """CUDA-event medians of the kernel and plain versions of one step, in
    turns (plain, kernels, kernels, plain), then device busy time and idle
    share by torch.profiler, with the busiest kernels."""
    times = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        times[which].append(cuda_ms(plain_fn if which == "plain" else kern_fn))
    print(f"{label}, median of 20 (CUDA events): kernels {min(times['kernels']):.4f} ms, "
          f"plain {min(times['plain']):.4f} ms (runs {times}) [{card}]", flush=True)
    for which, fn in (("kernels", kern_fn), ("plain", plain_fn)):
        busy, by_name = device_ms(fn)
        idle = "not measured" if busy is None else f"{1 - busy / min(times[which]):.3f}"
        print(f"{label} {which}: device busy {fmt(busy)} per call, idle share {idle}")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {ms:.4f} ms  {kname[:100]}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a CUDA card")
    from pdwt_tpu_torch import (Coeffs1D, Coeffs2D, Wavelets, dwt1d, dwt2d, get_wavelet,
                                idwt1d, idwt2d, iswt1d, iswt2d, iswt2d_denoise, ops, swt1d,
                                swt2d)
    from pdwt_tpu_torch.core import conv
    from pdwt_tpu_torch.core.shapes import level_sizes
    from pdwt_tpu_torch.filters import make_custom_wavelet
    from pdwt_tpu_torch.kernels import _build
    from pdwt_tpu_torch.kernels import batched1d as K1
    from pdwt_tpu_torch.kernels import separable as K
    from pdwt_tpu_torch.kernels import swt as S

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
              lambda x: K.fwd_level_2d_ref(x, lo, hi), (n, n), True) for n in fwd_shapes]
    cases += [("inv_level_2d", [rand(1, m, m) for _ in range(4)],
               lambda b: K.inv_level_2d(*b, rlo, rhi),
               lambda b: K.inv_level_2d_ref(*b, rlo, rhi), (m, m), True) for m in inv_shapes]
    cases.append(("fwd_tail_2d", rand(1, tail_r, tail_r),
                  lambda x: flat(*K.fwd_tail_2d(x, lo, hi, tail_k)),
                  lambda x: flat(*K.fwd_tail_2d_ref(x, lo, hi, tail_k)), (tail_r, tail_r), True))
    tail_in = (rand(1, m0, m0), [tuple(rand(1, m0 << j, m0 << j) for _ in range(3))
                                 for j in range(tail_k)])
    cases.append(("inv_tail_2d", tail_in, lambda t: K.inv_tail_2d(t[0], t[1], rlo, rhi),
                  lambda t: K.inv_tail_2d_ref(t[0], t[1], rlo, rhi), (m0, m0), True))

    # per kernel: worst error and the summed time of its launches in one pass
    # of its path; ms: per call by CUDA events (host launch gaps included);
    # device_ms: busy time on the card by torch.profiler
    report = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0,
                     "plain_device_ms": 0.0} for name in REPLACES}
    run_cases(cases, report, card)

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
    for name in ("fwd_level_2d", "inv_level_2d", "fwd_tail_2d", "inv_tail_2d"):
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
    time_in_turns(f"roundtrip {N}x{N} {WNAME} {LEVELS} levels",
                  lambda: idwt2d(dwt2d(x, wav, LEVELS), wav, (N, N)),
                  lambda: plain_idwt2d(plain_dwt2d(x)), card)

    # ======================= the TI-denoise path =======================
    # -- each stationary kernel against its plain version.  The inverse
    # runs on the plain forward's subbands, so the hard and garrote masks
    # see the same values in both versions.  Timed: the path's own calls
    # (1024^2, levels 1-3, forward and the soft-thresholded inverse).
    odd5 = make_custom_wavelet("odd5", *np.random.default_rng(5).standard_normal((4, 5)))
    thresholds = [("soft", TI_BETA), None, ("hard", TI_BETA), ("garrote", TI_BETA)]
    ti_cases = []

    def swt_cases(w, shape, level, timed):
        xl = rand(*shape)
        ti_cases.append(("swt_fwd_level_2d", xl,
                         lambda t: S.swt_fwd_level_2d(t, w.dec_lo, w.dec_hi, level),
                         lambda t: S.swt_fwd_level_2d_ref(t, w.dec_lo, w.dec_hi, level),
                         f"{w.name} {shape} level {level}", timed))
        bands = S.swt_fwd_level_2d_ref(xl, w.dec_lo, w.dec_hi, level)
        for thr in thresholds:
            ti_cases.append((
                "swt_inv_level_2d", bands,
                lambda b, thr=thr: S.swt_inv_level_2d(*b, w.rec_lo, w.rec_hi, level, thr),
                lambda b, thr=thr: S.swt_inv_level_2d_ref(*b, w.rec_lo, w.rec_hi, level, thr),
                f"{w.name} {shape} level {level} threshold {thr and thr[0]}",
                timed and thr is not None and thr[0] == "soft"))

    for level in range(1, TI_LEVELS + 1):
        swt_cases(wav, (1, TI_N, TI_N), level, True)
    swt_cases(wav, (1, TI_N, TI_N), 6, False)  # the facade's deepest level at 1024^2
    for level in range(1, 5):  # db2 8x16: at level 4 the support (25) exceeds 8 rows
        swt_cases(get_wavelet("db2"), (1, 8, 16), level, False)
    for level in (1, 2):
        swt_cases(wav, (1, 37, 53), level, False)
    swt_cases(wav, (3, 256, 256), 2, False)  # batch 3
    swt_cases(odd5, (1, 23, 29), 3, False)   # an odd-length custom bank
    run_cases(ti_cases, report, card)

    # -- the TI path, as a user drives it
    ti_img = np.random.default_rng(1).uniform(0, 255, (TI_N, TI_N)).astype(np.float32)
    xt = torch.from_numpy(ti_img).to(dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    T = Wavelets(xt, wname=WNAME, levels=TI_LEVELS, do_swt=True, device=dev)
    run_out, run_n1 = T.run_denoise(TI_BETA)
    T.forward()
    T.soft_threshold(TI_BETA)
    ti_n1 = T.norm1()
    ti_den = T.inverse()
    T2 = Wavelets(xt, wname=WNAME, levels=TI_LEVELS, do_swt=True, device=dev)
    T2.forward()
    ti_rt = T2.inverse()
    torch.cuda.synchronize()
    ti_launches = dict(K.LAUNCHES)
    print(f"TI path launches: {ti_launches}", flush=True)
    for name in ("swt_fwd_level_2d", "swt_inv_level_2d"):
        check(ti_launches[name] > 0, f"the TI path never launched {name}")
        launches[name] = ti_launches[name]
    for label, img in (("run_denoise", run_out), ("inverse", ti_den)):
        check(tuple(img.shape) == (TI_N, TI_N) and bool(torch.isfinite(img).all()),
              f"TI {label} image is not finite or has the wrong shape")
    rt_err = float((ti_rt - xt).abs().max())
    print(f"roundtrip max|iswt2d(swt2d(x)) - x| = {rt_err:.3e} (limit {ROUNDTRIP_ATOL})")
    check(rt_err <= ROUNDTRIP_ATOL, "SWT roundtrip error")

    def plain_swt2d(t):
        a, dets = t[None], []
        for level in range(1, TI_LEVELS + 1):
            a, h, v, d = S.swt_fwd_level_2d_ref(a, lo, hi, level)
            dets.append((h[0], v[0], d[0]))
        return Coeffs2D(a[0], tuple(dets))

    def plain_iswt2d(c, threshold=None):
        a = c.approx[None]
        for i in range(TI_LEVELS - 1, -1, -1):
            h, v, d = (t[None] for t in c.details[i])
            a = S.swt_inv_level_2d_ref(a, h, v, d, rlo, rhi, i + 1, threshold)
        return a[0]

    pc = ops.soft_threshold(plain_swt2d(xt), TI_BETA)
    p_n1 = float(ops.norm1(pc))
    p_den = plain_iswt2d(pc)
    for label, img, n1v in (("run_denoise", run_out, float(run_n1)), ("inverse", ti_den, ti_n1)):
        err, scale = max_err(img, p_den)
        print(f"TI {label} vs plain path: max|diff| {err:.3e} (limit {PATH_RTOL * scale:.3e}); "
              f"norm1 {n1v!r} vs plain {p_n1!r}", flush=True)
        check(err <= PATH_RTOL * scale, f"TI {label} disagrees with the plain path")
        check(abs(n1v - p_n1) <= PATH_RTOL * abs(p_n1), f"TI {label} norm1 disagrees")
    kc = swt2d(xt, wav, TI_LEVELS)
    fused = float(ops.thresholded_norm1(kc, TI_BETA))
    full = float(ops.norm1(ops.soft_threshold(kc, TI_BETA)))
    print(f"thresholded_norm1 {fused!r} vs norm1(soft_threshold) {full!r} "
          f"(limit {NORM_RTOL * abs(full):.3e})")
    check(abs(fused - full) <= NORM_RTOL * abs(full), "thresholded_norm1")

    # -- the TI step (bench.py's ti_swt_mpix_s), kernels and plain path, in turns
    time_in_turns(f"TI step {TI_N}x{TI_N} {WNAME} {TI_LEVELS} levels soft beta {TI_BETA}",
                  lambda: iswt2d_denoise(swt2d(xt, wav, TI_LEVELS), wav, TI_BETA),
                  lambda: plain_iswt2d(plain_swt2d(xt), ("soft", TI_BETA)), card)

    # ======================= the batched 1D path =======================
    # -- each 1D kernel against its plain version.  The inverses run on the
    # plain forwards' bands.  Timed: the path's own calls (1024 signals;
    # decimated levels 1-4 of 4096 samples each way, stationary levels 1-4).
    w8 = get_wavelet(B1_WNAME)
    randn = lambda *s: torch.randn(s, device=dev, generator=gen)
    b1_cases = []

    def dwt1d_cases(w, x, timed):
        xe = conv.odd_extend(x, -1)
        label = f"{w.name} {tuple(xe.shape)}"
        b1_cases.append(("fwd_level_1d", xe, lambda t: K1.fwd_level_1d(t, w.dec_lo, w.dec_hi),
                         lambda t: K1.fwd_level_1d_ref(t, w.dec_lo, w.dec_hi), label, timed))
        bands = K1.fwd_level_1d_ref(xe, w.dec_lo, w.dec_hi)
        b1_cases.append(("inv_level_1d", bands,
                         lambda b: K1.inv_level_1d(*b, w.rec_lo, w.rec_hi),
                         lambda b: K1.inv_level_1d_ref(*b, w.rec_lo, w.rec_hi),
                         f"{w.name} bands {tuple(bands[0].shape)}", timed))
        return bands[0]

    def swt1d_cases(w, x, levels, timed):
        for level in levels:
            b1_cases.append(("swt_fwd_level_1d", x,
                             lambda t, lv=level: K1.swt_fwd_level_1d(t, w.dec_lo, w.dec_hi, lv),
                             lambda t, lv=level: K1.swt_fwd_level_1d_ref(t, w.dec_lo, w.dec_hi,
                                                                         lv),
                             f"{w.name} {tuple(x.shape)} level {level}", timed))
            bands = K1.swt_fwd_level_1d_ref(x, w.dec_lo, w.dec_hi, level)
            b1_cases.append(("swt_inv_level_1d", bands,
                             lambda b, lv=level: K1.swt_inv_level_1d(*b, w.rec_lo, w.rec_hi, lv),
                             lambda b, lv=level: K1.swt_inv_level_1d_ref(*b, w.rec_lo,
                                                                         w.rec_hi, lv),
                             f"{w.name} {tuple(x.shape)} level {level}", timed))

    xa = randn(B1_SIGNALS, B1_N)
    for _ in range(B1_LEVELS):  # the shapes dwt1d hands each level
        xa = dwt1d_cases(w8, xa, True)
    swt1d_cases(w8, randn(B1_SIGNALS, B1_N), range(1, B1_LEVELS + 1), True)
    for w, shape, levels in [(w8, (3, 1023), (1, 2)),          # odd length
                             (w8, (2, 10), (1, 3)),            # shorter than the support
                             (get_wavelet("db2"), (4, 8), (1, 2, 3, 4)),  # dilation 8 > 8 samples
                             (w8, (1, 1 << 22), (1, 4)),       # one long signal
                             (w8, (70000, 64), (1, 4)),        # more signals than gridDim.y
                             (get_wavelet("haar"), (5, 64), (1, 4)),
                             (odd5, (3, 29), (1, 3))]:         # an odd-length bank
        x = randn(*shape)
        dwt1d_cases(w, x, False)
        swt1d_cases(w, x, levels, False)
    run_cases(b1_cases, report, card)

    # -- the batched 1D path, as a user drives it: the batch and one signal,
    # decimated and stationary, step by step and through run_denoise
    sig = np.random.default_rng(2).standard_normal((B1_SIGNALS, B1_N)).astype(np.float32)
    xs = torch.from_numpy(sig).to(dev)
    rt_sig = np.random.default_rng(3).uniform(0, 255, (B1_SIGNALS, B1_N)).astype(np.float32)
    xr = torch.from_numpy(rt_sig).to(dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    b1_out = {}
    for swt in (False, True):
        for label, data in (("batch", xs), ("one signal", sig[0])):
            D = Wavelets(data, wname=B1_WNAME, levels=B1_LEVELS, ndim=1, do_swt=swt, device=dev)
            D.forward()
            D.soft_threshold(B1_BETA)
            n1 = D.norm1()
            den = D.inverse()
            run, run_n1 = Wavelets(data, wname=B1_WNAME, levels=B1_LEVELS, ndim=1,
                                   do_swt=swt, device=dev).run_denoise(B1_BETA)
            b1_out[swt, label] = (den, n1, run, float(run_n1))
        R = Wavelets(xr, wname=B1_WNAME, levels=B1_LEVELS, ndim=1, do_swt=swt, device=dev)
        R.forward()
        b1_out[swt, "roundtrip"] = R.inverse()
    torch.cuda.synchronize()
    b1_launches = dict(K.LAUNCHES)
    print(f"batched 1D path launches: {b1_launches}", flush=True)
    for name in ("fwd_level_1d", "inv_level_1d", "swt_fwd_level_1d", "swt_inv_level_1d"):
        check(b1_launches[name] > 0, f"the batched 1D path never launched {name}")
        launches[name] = b1_launches[name]

    def plain_dwt1d(t):
        a, dets = t, []
        for _ in range(B1_LEVELS):
            a, d = K1.fwd_level_1d_ref(conv.odd_extend(a, -1), w8.dec_lo, w8.dec_hi)
            dets.append(d)
        return Coeffs1D(a, tuple(dets))

    def plain_idwt1d(c):
        sizes = level_sizes(B1_N, B1_LEVELS)
        a = c.approx
        for i in range(B1_LEVELS - 1, -1, -1):
            a = K1.inv_level_1d_ref(a, c.details[i], w8.rec_lo, w8.rec_hi)[:, :sizes[i]]
        return a

    def plain_swt1d(t):
        a, dets = t, []
        for level in range(1, B1_LEVELS + 1):
            a, d = K1.swt_fwd_level_1d_ref(a, w8.dec_lo, w8.dec_hi, level)
            dets.append(d)
        return Coeffs1D(a, tuple(dets))

    def plain_iswt1d(c):
        a = c.approx
        for i in range(B1_LEVELS - 1, -1, -1):
            a = K1.swt_inv_level_1d_ref(a, c.details[i], w8.rec_lo, w8.rec_hi, i + 1)
        return a

    for swt in (False, True):
        kind = "SWT" if swt else "DWT"
        pc = ops.soft_threshold((plain_swt1d if swt else plain_dwt1d)(xs), B1_BETA)
        p_n1 = float(ops.norm1(pc))
        p_den = (plain_iswt1d if swt else plain_idwt1d)(pc)
        for label in ("batch", "one signal"):
            den, n1, run, run_n1 = b1_out[swt, label]
            want = p_den if label == "batch" else p_den[:1]
            w_n1 = p_n1 if label == "batch" else float(ops.norm1(ops.soft_threshold(
                (plain_swt1d if swt else plain_dwt1d)(xs[:1]), B1_BETA)))
            for how, img, n1v in (("inverse", den, n1), ("run_denoise", run, run_n1)):
                check(tuple(img.shape) == tuple(want.shape) and bool(torch.isfinite(img).all()),
                      f"1D {kind} {label} {how}: not finite or the wrong shape")
                err, scale = max_err(img, want)
                print(f"1D {kind} {label} {how} vs plain path: max|diff| {err:.3e} "
                      f"(limit {PATH_RTOL * scale:.3e}); norm1 {n1v!r} vs plain {w_n1!r}",
                      flush=True)
                check(err <= PATH_RTOL * scale, f"1D {kind} {label} {how} disagrees with the "
                      "plain path")
                check(abs(n1v - w_n1) <= PATH_RTOL * abs(w_n1), f"1D {kind} {label} {how} norm1")
        rt_err = float((b1_out[swt, "roundtrip"] - xr).abs().max())
        print(f"1D {kind} roundtrip max|inverse(forward(x)) - x| = {rt_err:.3e} "
              f"(limit {ROUNDTRIP_ATOL})")
        check(rt_err <= ROUNDTRIP_ATOL, f"1D {kind} roundtrip error")

    # against the repository's golden 1D coefficients (float64 reference data)
    for key in ("dwt1d/sym4", "dwt1d/db2", "dwt1d/db5", "swt1d/db2"):
        kind, gname = key.split("/")
        gw = get_wavelet(gname)
        gx = torch.tensor(gold[f"{key}/x"], dtype=torch.float32, device=dev)
        gl = int(gold[f"{key}/levels"]) if kind == "dwt1d" else 2
        gc = (dwt1d if kind == "dwt1d" else swt1d)(gx, gw, gl)
        want = [gold[f"{key}/a"]] + [gold[f"{key}/L{i}/d"] for i in range(1, gl + 1)]
        gerr = max(float(np.abs(g.cpu().numpy() - w).max())
                   for g, w in zip([gc.approx, *gc.details], want))
        gscale = max(float(np.abs(w).max()) for w in want)
        yr = idwt1d(gc, gw, gx.shape[-1]) if kind == "dwt1d" else iswt1d(gc, gw)
        rerr = float((yr - gx).abs().max())
        print(f"golden {key} ({tuple(gx.shape)}, {gl} levels): max err {gerr:.3e} "
              f"(limit {KERNEL_RTOL * gscale:.3e}); roundtrip {rerr:.3e}")
        check(gerr <= KERNEL_RTOL * gscale and rerr <= KERNEL_RTOL * float(gx.abs().max()),
              f"golden {key}")

    # -- the batched 1D denoise step (bench_all.py:91-95), kernels and plain
    # path, in turns
    def b1_step(fwd, inv):
        c = ops.soft_threshold(fwd(xs), B1_BETA)
        ops.norm1(c)
        return inv(c)

    time_in_turns(f"batched 1D step {B1_SIGNALS}x{B1_N} {B1_WNAME} {B1_LEVELS} levels soft "
                  f"beta {B1_BETA}",
                  lambda: b1_step(lambda t: dwt1d(t, w8, B1_LEVELS),
                                  lambda c: idwt1d(c, w8, B1_N)),
                  lambda: b1_step(plain_dwt1d, plain_idwt1d), card)

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name], **report[name]}
               for name in REPLACES]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
