"""Device time per level of the kernels redesigned for Hopper's CUDA cores
(kernels 14 and 18, the banded-product inverses; kernels 2 and 6, the exact
inverses; kernels 16 and 17, the batched 1D synthesis and the rank-r
analysis; kernels 13 and 15, the 2D a-trous and the batched 1D analyses;
kernels 12 and 10, 11 and 9, 8 and 5, 1 and 7, which run the bodies of 2
and 16, 13 and 15, 16 and 13, 13 and 15; the tails 3 and 4, which run the
bodies of 1 and 2 level by level in one launch) at the cells' shapes, for
one checkout of the port.

    python3 scripts/inverse_kernel_times.py ROOT [OUTDIR]

ROOT is the checkout to import (``.`` for this one; an unpacked
``git archive`` of another commit to compare in turns: parent, change,
change, parent).  With OUTDIR, the outputs of kernels 5, 1 and 3 are
saved there under ROOT's name, and for each other checkout's file already
there it prints one line each, K5DIFF (K1DIFF, T3DIFF) ROOT OTHER {json}:
per level (per tail call), max|ROOT - OTHER| over max|OTHER| of the
outputs.  Needs a CUDA card.  It builds the kernels (and reports
the build time), brings the card's clocks up with a few large products,
then times with torch.profiler, per call, the device time of these
kernels' launches at: the TI cell's three levels (db7, 1024^2, soft beta
10; fd as under bf16-fast and b2f as under bf16-balanced; float32 subbands
on kernel 6 as under the exact tier; kernel 13 in b1 on a bf16 image at
level 1 then fd on float32 as under bf16-fast, and b2f at every level as
under bf16-balanced and -accurate, bf16 details), the rank-3 cell's a-trous
synthesis levels 1-3 (1024^2, fd) and polyphase levels 1-4 (subbands
1024^2 to 128^2; fd, then b3), the DWT roundtrip's synthesis levels on
kernel 2 (db7, float32 subbands 1024^2 to 128^2), the rank-3 cell's
analysis levels on kernel 17 (stride 2: 2048^2 to 256^2 images, b1 on bf16
then b3 on float32, bf16 details, as under bf16-fast; stride 1: 1024^2
levels 1-3, b1 then fd as under bf16-fast, and b2f at every level as under
bf16-balanced and -accurate) and the batched 1D cells' levels on kernels
16 and 15 (sym8, 1024 signals; polyphase synthesis: bands of 2048 down to
256, fd into bf16 then b3; a-trous synthesis: 4096 samples, levels 1-4,
fd, bf16 out at level 1; decimated analysis: 4096 down to 512 samples in,
b1 on bf16 then b3 on float32, bf16 high band; a-trous analysis: 4096
samples, levels 1-4, b1 on bf16 then fd on float32, bf16 high band), the
tier DWT roundtrip's synthesis levels on kernel 12 (db7, subbands 1024^2
to 128^2: under bf16-fast fd into bf16 then b3, under mixed b3 on float32
details, under bf16-balanced b2f into bf16 then b3), the exact 1D SWT
cell's synthesis levels on kernel 10 (sym8, 1024 x 4096, levels 1-4,
float32), the tier DWT roundtrip's analysis levels on kernel 11 (db7,
2048^2 down to 256^2 images: under bf16-fast b1 on bf16 then b3, under
mixed b3 on float32, under bf16-balanced b2f on bf16 then b3) and the exact
1D SWT cell's analysis levels on kernel 9 (sym8, 1024 x 4096, levels 1-4,
float32), the exact 1D DWT cell's synthesis levels on kernel 8 (sym8, 1024
signals, float32 bands of 2048 down to 256 samples), the exact TI cell's
analysis levels on kernel 5 (db7, 1024^2, levels 1-3, float32), the DWT
roundtrip's analysis levels on kernel 1 (db7, float32 images of 2048^2 down
to 256^2) and the exact 1D DWT cell's analysis levels on kernel 7 (sym8,
1024 float32 signals of 4096 down to 512 samples), and per call the tails
3 and 4 at the DWT cell's shape (db7: a 128^2 image into 64^2 subbands and
back, one level) and at 4 levels (down to 8^2 and back), these also at
clusters of 8 and 16 where the checkout has ``tail_launch_plan``; the
padded entry points of kernels 1, 2, 7 and 8 at one level of the mode
cells (symmetric), and where the checkout has them those of 5, 6, 9 and 10
at a rank's shards of the sharded cells (db7 512^2, levels 1-3; sym8 1024
x 1024, levels 1-4) and those of 11-16 there under bf16-fast (db7 1024^2
DWT shards, levels 1-3; the 512^2 and 1024 x 1024 shards as 5p-10p's,
the 1D decimated pair at levels 1-3).  Beside
1, 3, 4, 5, 7, 8, 9, 11, 12, 13 and 15 it times their PyTorch yardsticks
in the same call, by CUDA events: the dense-band ``torch.matmul`` products
of ``chip_smoke.yardstick`` (a pair per 2D level, one per 1D level; bf16,
and float32 for kernels 1, 3, 4, 5, 7, 8 and 9).
Prints one line: RESULT ROOT {json}, each level in ms and each pass
summed, and one line: SUMS ROOT {json}, a SHA-256 prefix of the bytes of
each timed kernel's output (the same inputs on every checkout, made from
one seed), so that runs in turns show where two checkouts agree bit for
bit; and one line: NONFINITE ROOT {json}, for kernels 8, 5, 1 and 7 given
one inf sample (sym8 on 33 x 200 bands, db7 level 2 and db7 on a 64 x 96
image, sym8 on 33 x 400 signals), and for the tails 3 and 4 (db7, two
levels: that image; 16 x 24 subbands, an inf in the deepest H), the
outputs that are inf and that are NaN, from the kernel and from its plain
version.  Imports no JAX.
"""
import glob
import hashlib
import importlib.util
import json
import os
import sys
import time

root = sys.argv[1]
outdir = sys.argv[2] if len(sys.argv) > 2 else None
sys.path.insert(0, root)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as CS  # noqa: E402
from pdwt_tpu_torch import get_wavelet  # noqa: E402
from pdwt_tpu_torch.core import nonseparable as NSC  # noqa: E402
from pdwt_tpu_torch.kernels import LAUNCHES, _build  # noqa: E402
from pdwt_tpu_torch.kernels import batched1d as K1  # noqa: E402
from pdwt_tpu_torch.kernels import matmul as M  # noqa: E402
from pdwt_tpu_torch.kernels import mxu1d as M1  # noqa: E402
from pdwt_tpu_torch.kernels import ns_matmul as NM  # noqa: E402
from pdwt_tpu_torch.kernels import separable as K  # noqa: E402
from pdwt_tpu_torch.kernels import swt as S  # noqa: E402
from pdwt_tpu_torch.kernels import swt_matmul as SM  # noqa: E402

t0 = time.time()
_build.load()
build_s = time.time() - t0
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
f32, bf16 = torch.float32, torch.bfloat16


def rand(*shape):
    return torch.rand(shape, device=dev, generator=gen) * 255.0


def bands(n):
    return [rand(1, n, n)] + [(rand(1, n, n) - 127.5).to(bf16) for _ in range(3)]


big = torch.randn(4096, 4096, device=dev)
for _ in range(50):  # bring the clocks up
    big @ big
torch.cuda.synchronize()


KERNELS = ("inv_mxu", "inv_level", "inv1d", "ns_fwd", "fwd_mxu", "fwd1d", "swt_fwd_level",
           "fwd_level", "tail", "padded")


def digest(t):
    """A SHA-256 prefix of the bytes of a tensor, or of a tuple of tensors
    one after the other (any dtype)."""
    h = hashlib.sha256()
    for u in (t if isinstance(t, (tuple, list)) else (t,)):
        h.update(u.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dev_ms(fn, reps=30):
    """Device ms per fn() call of the timed kernels' launches (by name:
    kernel 2's and 6's old and new bodies, 14's, 18's, 16's and 17's, 13's
    and 15's, 12's, 10's, 11's, 9's, 8's, 5's, 1's and 7's old and new
    bodies); the digest of one
    call's output goes to ``sums`` under the row's key (``timed``).  The
    profiler now and then drops a few events, so the time is the mean per
    recorded launch times the launches per call that the port's launch
    counters gained over the window; None (not measured) if the window
    recorded none."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    before = sum(LAUNCHES.values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launched = sum(LAUNCHES.values()) - before
    t = [e.time_range.elapsed_us() for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and any(k in e.name for k in KERNELS)]
    return sum(t) / len(t) * launched / reps / 1e3 if t else None


sums = {}


def timed(key, fn):
    res[key] = dev_ms(fn)
    sums[key] = digest(fn())


w7 = get_wavelet("db7")
A, Bc = NSC._rank_decomp(CS.pr_quads()[1])
Af, Bf = NSC._rank_decomp(CS.pr_quads()[0])
res = {"build_s": build_s}
for lvl, out in ((1, bf16), (2, f32), (3, f32)):
    b = bands(1024)
    res[f"k14 L{lvl}"] = dev_ms(lambda: SM.swt_inv_level_2d_mxu(
        *b, w7.rec_lo, w7.rec_hi, lvl, "fd", out, ("soft", 10.0)))
    res[f"k14b L{lvl}"] = dev_ms(lambda: SM.swt_inv_level_2d_mxu(
        *b, w7.rec_lo, w7.rec_hi, lvl, "b2f", out, ("soft", 10.0)))
    res[f"k18s L{lvl}"] = dev_ms(lambda: NM.ns_swt_inv_level_2d_mxu(*b, A, Bc, lvl, "fd", out))
for m, sch, out in ((1024, "fd", bf16), (512, "b3", f32), (256, "b3", f32), (128, "b3", f32)):
    b = bands(m)
    res[f"k18p {m} {sch}"] = dev_ms(lambda: NM.ns_inv_level_2d_mxu(*b, A, Bc, sch, out))
beta = torch.tensor([10.0], device=dev)  # on the card: no fill kernel in the window
for lvl in (1, 2, 3):
    b = [rand(1, 1024, 1024)] + [rand(1, 1024, 1024) - 127.5 for _ in range(3)]
    res[f"k6 L{lvl}"] = dev_ms(lambda: S.swt_inv_level_2d(*b, w7.rec_lo, w7.rec_hi, lvl,
                                                          ("soft", beta)))
for m in (1024, 512, 256, 128):
    b = [rand(1, m, m) for _ in range(4)]
    timed(f"k2 {m}", lambda: K.inv_level_2d(*b, w7.rec_lo, w7.rec_hi))
for r, sch, in_dt in ((2048, "b1", bf16), (1024, "b3", f32), (512, "b3", f32), (256, "b3", f32)):
    x = rand(1, r, r).to(in_dt)
    res[f"k17d {r} {sch}"] = dev_ms(lambda: NM.ns_fwd_level_2d_mxu(x, Af, Bf, sch, (f32, bf16)))
for lvl, (fast, in_dt) in enumerate((("b1", bf16), ("fd", f32), ("fd", f32)), 1):
    x = rand(1, 1024, 1024).to(in_dt)
    res[f"k17s L{lvl} {fast}"] = dev_ms(lambda: NM.ns_swt_fwd_level_2d_mxu(x, Af, Bf, lvl, fast,
                                                                           (f32, bf16)))
    res[f"k17b L{lvl}"] = dev_ms(lambda: NM.ns_swt_fwd_level_2d_mxu(x, Af, Bf, lvl, "b2f",
                                                                     (f32, bf16)))
w8 = get_wavelet("sym8")
for m, sch, out in ((2048, "fd", bf16), (1024, "b3", f32), (512, "b3", f32), (256, "b3", f32)):
    lo, hi = torch.randn(1024, m, device=dev), torch.randn(1024, m, device=dev).to(bf16)
    res[f"k16d {m} {sch}"] = dev_ms(lambda: M1.inv_level_1d_mxu(lo, hi, w8.rec_lo, w8.rec_hi, sch,
                                                                out))
for lvl in (1, 2, 3, 4):
    lo, hi = torch.randn(1024, 4096, device=dev), torch.randn(1024, 4096, device=dev).to(bf16)
    out = bf16 if lvl == 1 else f32
    res[f"k16a L{lvl}"] = dev_ms(lambda: M1.swt_inv_level_1d_mxu(lo, hi, w8.rec_lo, w8.rec_hi,
                                                                 lvl, "fd", out))
for lvl, (fast, in_dt) in enumerate((("b1", bf16), ("fd", f32), ("fd", f32)), 1):
    x = rand(1, 1024, 1024).to(in_dt)
    timed(f"k13 L{lvl} {fast}", lambda: SM.swt_fwd_level_2d_mxu(
        x, w7.dec_lo, w7.dec_hi, lvl, fast, (f32, bf16)))
    timed(f"k13b L{lvl}", lambda: SM.swt_fwd_level_2d_mxu(x, w7.dec_lo, w7.dec_hi, lvl, "b2f",
                                                          (f32, bf16)))
    res[f"y13 L{lvl}"] = CS.cuda_ms(CS.yardstick("swt_fwd2d", w7, bf16, lvl)(x))
for n, sch, in_dt in ((4096, "b1", bf16), (2048, "b3", f32), (1024, "b3", f32), (512, "b3", f32)):
    x = torch.randn(1024, n, device=dev, generator=gen).to(in_dt)
    timed(f"k15d {n} {sch}", lambda: M1.fwd_level_1d_mxu(x, w8.dec_lo, w8.dec_hi, sch, bf16))
    res[f"y15d {n}"] = CS.cuda_ms(CS.yardstick("fwd", w8, bf16)(x))
for lvl in (1, 2, 3, 4):
    sch, in_dt = ("b1", bf16) if lvl == 1 else ("fd", f32)
    x = torch.randn(1024, 4096, device=dev, generator=gen).to(in_dt)
    timed(f"k15a L{lvl} {sch}", lambda: M1.swt_fwd_level_1d_mxu(x, w8.dec_lo, w8.dec_hi, lvl,
                                                                sch, bf16))
    res[f"y15a L{lvl}"] = CS.cuda_ms(CS.yardstick("swt_fwd", w8, bf16, lvl)(x))
# kernel 12 at the tier DWT roundtrip's synthesis levels, its inputs from a
# generator of its own (the rows above keep theirs)
gen = torch.Generator(device=dev).manual_seed(12)
for i, m in enumerate((1024, 512, 256, 128)):
    a = rand(1, m, m)
    dets = [rand(1, m, m) - 127.5 for _ in range(3)]
    for key, sch, det, out in (("k12f", "fd" if i == 0 else "b3", bf16, bf16 if i == 0 else f32),
                               ("k12m", "b3", f32, f32),
                               ("k12b", "b2f" if i == 0 else "b3", bf16, bf16 if i == 0 else f32)):
        b = [a] + [t.to(det) for t in dets]
        timed(f"{key} {m} {sch}", lambda: M.inv_level_2d_mxu(*b, w7.rec_lo, w7.rec_hi, sch, out))
    res[f"y12 {m}"] = CS.cuda_ms(CS.yardstick("inv2d", w7, bf16)([a] + [t.to(bf16) for t in dets]))
# kernel 10 at the exact 1D SWT cell's synthesis levels
for lvl in (1, 2, 3, 4):
    lo, hi = (torch.randn(1024, 4096, device=dev, generator=gen) for _ in range(2))
    timed(f"k10 L{lvl}", lambda: K1.swt_inv_level_1d(lo, hi, w8.rec_lo, w8.rec_hi, lvl))
# kernel 11 at the tier DWT roundtrip's analysis levels (db7, 2048^2 down to
# 256^2 images): under bf16-fast b1 on a bf16 image then b3 on the float32
# approximation chain, under mixed b3 on float32, under bf16-balanced b2f
# then b3, bf16 details under the bf16 tiers (inputs from a generator of
# their own)
gen = torch.Generator(device=dev).manual_seed(11)
for i, r in enumerate((2048, 1024, 512, 256)):
    x = rand(1, r, r)
    for key, sch, in_dt, det in (("k11f", "b1" if i == 0 else "b3", bf16 if i == 0 else f32, bf16),
                                 ("k11m", "b3", f32, f32),
                                 ("k11b", "b2f" if i == 0 else "b3", bf16 if i == 0 else f32,
                                  bf16)):
        xin = x.to(in_dt)
        timed(f"{key} {r} {sch}", lambda: M.fwd_level_2d_mxu(xin, w7.dec_lo, w7.dec_hi, sch,
                                                             (f32, det)))
    res[f"y11 {r}"] = CS.cuda_ms(CS.yardstick("fwd2d", w7, bf16)(x.to(bf16)))
# kernel 9 at the exact 1D SWT cell's analysis levels (sym8, 1024 x 4096,
# levels 1-4, float32), beside its float32 dense-band yardstick
gen = torch.Generator(device=dev).manual_seed(9)
for lvl in (1, 2, 3, 4):
    x = torch.randn(1024, 4096, device=dev, generator=gen)
    timed(f"k9 L{lvl}", lambda: K1.swt_fwd_level_1d(x, w8.dec_lo, w8.dec_hi, lvl))
    res[f"y9 L{lvl}"] = CS.cuda_ms(CS.yardstick("swt_fwd", w8, f32, lvl)(x))
# kernel 8 at the exact 1D DWT cell's synthesis levels (sym8, 1024 signals,
# float32 bands of 2048 down to 256 samples), beside its float32 yardstick
gen = torch.Generator(device=dev).manual_seed(8)
for m in (2048, 1024, 512, 256):
    b = [torch.randn(1024, m, device=dev, generator=gen) for _ in range(2)]
    timed(f"k8 {m}", lambda: K1.inv_level_1d(*b, w8.rec_lo, w8.rec_hi))
    res[f"y8 {m}"] = CS.cuda_ms(CS.yardstick("inv", w8, f32)(b))
# kernel 5 at the exact TI cell's analysis levels (db7, 1024^2, levels 1-3,
# float32), beside its float32 yardstick; its outputs kept for K5DIFF
gen = torch.Generator(device=dev).manual_seed(5)
k5 = {}
for lvl in (1, 2, 3):
    x = rand(1, 1024, 1024)
    timed(f"k5 L{lvl}", lambda: S.swt_fwd_level_2d(x, w7.dec_lo, w7.dec_hi, lvl))
    res[f"y5 L{lvl}"] = CS.cuda_ms(CS.yardstick("swt_fwd2d", w7, f32, lvl)(x))
    k5[lvl] = [t.cpu() for t in S.swt_fwd_level_2d(x, w7.dec_lo, w7.dec_hi, lvl)]
# kernel 1 at the DWT roundtrip's analysis levels (db7, float32 images of
# 2048^2 down to 256^2), beside its float32 yardstick; its outputs kept for
# K1DIFF
gen = torch.Generator(device=dev).manual_seed(1)
k1 = {}
for r in (2048, 1024, 512, 256):
    x = rand(1, r, r)
    timed(f"k1 {r}", lambda: K.fwd_level_2d(x, w7.dec_lo, w7.dec_hi))
    res[f"y1 {r}"] = CS.cuda_ms(CS.yardstick("fwd2d", w7, f32)(x))
    k1[r] = [t.cpu() for t in K.fwd_level_2d(x, w7.dec_lo, w7.dec_hi)]
# kernel 7 at the exact 1D DWT cell's analysis levels (sym8, 1024 float32
# signals of 4096 down to 512 samples), beside its float32 yardstick
gen = torch.Generator(device=dev).manual_seed(7)
for n in (4096, 2048, 1024, 512):
    x = torch.randn(1024, n, device=dev, generator=gen)
    timed(f"k7 {n}", lambda: K1.fwd_level_1d(x, w8.dec_lo, w8.dec_hi))
    res[f"y7 {n}"] = CS.cuda_ms(CS.yardstick("fwd", w8, f32)(x))
# the tails 3 and 4 at the DWT cell's shape (db7, a 1 x 128^2 image into
# 64^2 subbands, one level; 64^2 subbands into 128^2) and at 4 levels (128^2
# down to 8^2, 8^2 subbands up to 128^2), beside their float32 yardsticks
# (chip_smoke.tail_yardstick); on a checkout with tail_launch_plan, the
# 4-level calls also at clusters of 8 and of 16; 3's outputs kept for T3DIFF
gen = torch.Generator(device=dev).manual_seed(34)
k3 = {}
tail_plan = getattr(K, "tail_launch_plan", None)
if not hasattr(CS, "tail_yardstick"):  # ROOT's chip_smoke predates it: this tree's
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                        "chip_smoke.py"))
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
for levels in (1, 4):
    x = rand(1, 128, 128)
    a = rand(1, 128 >> levels, 128 >> levels)
    dets = [tuple(rand(1, 128 >> j, 128 >> j) for _ in range(3)) for j in range(levels, 0, -1)]
    fwd = lambda: K.fwd_tail_2d(x, w7.dec_lo, w7.dec_hi, levels)
    inv = lambda: K.inv_tail_2d(a, dets, w7.rec_lo, w7.rec_hi)
    flat = lambda o: [o[0], *[t for band in o[1] for t in band]]
    timed(f"k3 {levels}L", lambda: flat(fwd()))
    timed(f"k4 {levels}L", inv)
    k3[levels] = [t.cpu() for t in flat(fwd())]
    res[f"y3 {levels}L"] = CS.cuda_ms(CS.tail_yardstick(w7, levels)(x))
    res[f"y4 {levels}L"] = CS.cuda_ms(CS.tail_yardstick(w7, levels, inverse=True)((a, dets)))
    if tail_plan is not None and levels > 1:
        pick = K._tail_cluster
        for cs in (8, 16):
            K._tail_cluster = lambda B, tiles, cs=cs: cs
            tail_plan.cache_clear()
            res[f"k3 {levels}L cs{cs}"] = dev_ms(fwd)
            res[f"k4 {levels}L cs{cs}"] = dev_ms(inv)
        K._tail_cluster = pick
        tail_plan.cache_clear()
# the padded entry points of kernels 1, 2, 7 and 8 (the boundary modes:
# db7 symmetric levels of a 2048^2 image and of 1024^2 subbands, sym8
# symmetric levels of 1024 x 4096 signals and 1024 x 2048 bands) and, on a
# checkout that has them, of 5, 6, 9 and 10 at a rank's shards of the
# sharded cells (db7 512^2 shards of the TI step, levels 1-3; sym8 1024 x
# 1024 shards of the 1D cell, levels 1-4; each wrapped by its halo)
from pdwt_tpu_torch.core import conv as CV  # noqa: E402
from pdwt_tpu_torch.core import separable as SEP  # noqa: E402

gen = torch.Generator(device=dev).manual_seed(16)
w8 = get_wavelet("sym8")
sym = "symmetric"
xp = SEP.fwd_mode_pad(SEP.fwd_mode_pad(rand(1, 2048, 2048), -1, 14, sym), -2, 14, sym).contiguous()
timed("k1p 2048", lambda: K.fwd_level_2d_padded(xp, w7.dec_lo, w7.dec_hi))
sb = [rand(1, 1030, 1030) for _ in range(4)]
timed("k2p 1030", lambda: K.inv_level_2d_padded(*sb, w7.rec_lo, w7.rec_hi, (-1, -1), (2048, 2048)))
sp = SEP.fwd_mode_pad(rand(1024, 4096), -1, 16, sym).contiguous()
timed("k7p 4096", lambda: K1.fwd_level_1d_padded(sp, w8.dec_lo, w8.dec_hi))
lb, hb = rand(1024, 2055), rand(1024, 2055)
timed("k8p 2055", lambda: K1.inv_level_1d_padded(lb, hb, w8.rec_lo, w8.rec_hi, -1, 4096))
if hasattr(S, "swt_fwd_level_2d_padded"):
    import pdwt_tpu_torch.kernels as KK  # noqa: E402

    def halo(t, lohi, axes):
        for ax in axes:
            t = CV.wrap_pad(t, ax, *lohi)
        return t.contiguous()

    for lvl in (1, 2, 3):
        xs = halo(rand(1, 512, 512), KK.swt_fwd_halo(14, lvl), (-1, -2))
        timed(f"k5p L{lvl}", lambda: S.swt_fwd_level_2d_padded(xs, w7.dec_lo, w7.dec_hi, lvl))
        bs = [halo(rand(1, 512, 512), KK.swt_inv_halo(14, lvl), (-1, -2)) for _ in range(4)]
        timed(f"k6p L{lvl}", lambda: S.swt_inv_level_2d_padded(*bs, w7.rec_lo, w7.rec_hi, lvl))
    for lvl in (1, 2, 3, 4):
        ss = halo(torch.randn(1024, 1024, device=dev, generator=gen), KK.swt_fwd_halo(16, lvl),
                  (-1,))
        timed(f"k9p L{lvl}", lambda: K1.swt_fwd_level_1d_padded(ss, w8.dec_lo, w8.dec_hi, lvl))
        ls, hs = (halo(torch.randn(1024, 1024, device=dev, generator=gen),
                       KK.swt_inv_halo(16, lvl), (-1,)) for _ in range(2))
        timed(f"k10p L{lvl}", lambda: K1.swt_inv_level_1d_padded(ls, hs, w8.rec_lo, w8.rec_hi,
                                                                 lvl))
# and, on a checkout that has them, those of 11-16 at a rank's shards under
# bf16-fast (db7 1024^2 shards of the DWT cell, levels 1-3: b1 on bf16,
# then b3 on float32, bf16 details, and back, fd into bf16 at level 1; the
# TI step's 512^2 shards, levels 1-3: b1 then fd, fd into bf16 at level 1;
# sym8 1024 x 1024 shards of the 1D cell, decimated levels 1-3 and a-trous
# levels 1-4, as under the 2D cells)
if hasattr(M, "fwd_level_2d_mxu_padded"):  # a checkout with 11p has 5p's halo above
    def ext(t, axes, hlen):
        for ax in axes:
            t = SEP.fwd_mode_pad(t, ax, hlen, "periodization")
        return t.contiguous()

    def ipad(t, axes, hlen, out):
        c0 = []
        for ax, n in zip(axes, out):
            t, c = SEP.inv_mode_pad(t, ax, hlen, "periodization", n)
            c0.append(c)
        return t.contiguous(), tuple(c0)

    for lvl in (1, 2, 3):
        n, sch, dt = 1024 >> (lvl - 1), ("b1" if lvl == 1 else "b3"), (bf16 if lvl == 1 else f32)
        xp = ext(rand(1, n, n).to(dt), (-1, -2), 14)
        timed(f"k11p {n} {sch}", lambda: M.fwd_level_2d_mxu_padded(xp, w7.dec_lo, w7.dec_hi, sch,
                                                                     (f32, bf16)))
        isch = "fd" if lvl == 1 else "b3"
        pb = [ipad(t, (-2, -1), 14, (n, n)) for t in bands(n // 2)]
        timed(f"k12p {n // 2} {isch}", lambda: M.inv_level_2d_mxu_padded(
            *(t for t, _ in pb), w7.rec_lo, w7.rec_hi, isch, pb[0][1], (n, n), dt))
        sch = "b1" if lvl == 1 else "fd"
        xs = halo(rand(1, 512, 512).to(dt), KK.swt_fwd_halo(14, lvl), (-1, -2))
        timed(f"k13p L{lvl} {sch}", lambda: SM.swt_fwd_level_2d_mxu_padded(
            xs, w7.dec_lo, w7.dec_hi, lvl, sch, (f32, bf16)))
        bs = [halo(t, KK.swt_inv_halo(14, lvl), (-1, -2)) for t in bands(512)]
        timed(f"k14p L{lvl} fd", lambda: SM.swt_inv_level_2d_mxu_padded(
            *bs, w7.rec_lo, w7.rec_hi, lvl, "fd", dt))
        n, sch = 1024 >> (lvl - 1), ("b1" if lvl == 1 else "b3")
        sp = ext(torch.randn(1024, n, device=dev, generator=gen).to(dt), (-1,), 16)
        timed(f"k15pd {n} {sch}", lambda: M1.fwd_level_1d_mxu_padded(sp, w8.dec_lo, w8.dec_hi,
                                                                      sch, bf16))
        (lp, c0), (hp, _) = (ipad(torch.randn(1024, n // 2, device=dev, generator=gen).to(t),
                                  (-1,), 16, (n,)) for t in (f32, bf16))
        timed(f"k16pd {n // 2} {isch}", lambda: M1.inv_level_1d_mxu_padded(
            lp, hp, w8.rec_lo, w8.rec_hi, isch, c0[0], n, dt))
    for lvl in (1, 2, 3, 4):
        sch, dt = ("b1", bf16) if lvl == 1 else ("fd", f32)
        ss = halo(torch.randn(1024, 1024, device=dev, generator=gen).to(dt),
                  KK.swt_fwd_halo(16, lvl), (-1,))
        timed(f"k15pa L{lvl} {sch}", lambda: M1.swt_fwd_level_1d_mxu_padded(
            ss, w8.dec_lo, w8.dec_hi, lvl, sch, bf16))
        ls, hs = (halo(torch.randn(1024, 1024, device=dev, generator=gen).to(t),
                       KK.swt_inv_halo(16, lvl), (-1,)) for t in (f32, bf16))
        timed(f"k16pa L{lvl} fd", lambda: M1.swt_inv_level_1d_mxu_padded(
            ls, hs, w8.rec_lo, w8.rec_hi, lvl, "fd", dt))
for k in ("k14", "k14b", "k18s", "k18p", "k6", "k2", "k17d", "k17s", "k17b", "k16d", "k16a",
          "k13", "k13b", "y13", "k15d", "y15d", "k15a", "y15a", "k12f", "k12m", "k12b", "y12",
          "k10", "k11f", "k11m", "k11b", "y11", "k9", "y9", "k8", "y8", "k5", "y5", "k1", "y1",
          "k7", "y7", "k1p", "k2p", "k7p", "k8p", "k5p", "k6p", "k9p", "k10p", "k11p", "k12p",
          "k13p", "k14p", "k15pd", "k15pa", "k16pd", "k16pa"):
    res[k + " pass"] = sum(v for n, v in res.items() if n.startswith(k + " ") and v)
print("RESULT", root, json.dumps({k: None if v is None else round(v, 5) for k, v in res.items()}))
print("SUMS", root, json.dumps(sums))
# one inf sample through kernels 8, 5, 1 and 7 and their plain versions
gen = torch.Generator(device=dev).manual_seed(1)
lo, hi = (torch.rand(33, 200, device=dev, generator=gen) for _ in range(2))
hi[3, 100] = float("inf")
x = rand(1, 64, 96)
x[0, 30, 40] = float("inf")
s = torch.rand(33, 400, device=dev, generator=gen)
s[3, 200] = float("inf")
ia = rand(1, 16, 24)
ibands = [tuple(rand(1, 16 << k, 24 << k) for _ in range(3)) for k in range(2)]
ibands[0][0][0, 5, 7] = float("inf")
nonfinite = {}
for key, kern, plain in (
        ("k8", lambda: [K1.inv_level_1d(lo, hi, w8.rec_lo, w8.rec_hi)],
         lambda: [K1.inv_level_1d_ref(lo, hi, w8.rec_lo, w8.rec_hi)]),
        ("k5", lambda: S.swt_fwd_level_2d(x, w7.dec_lo, w7.dec_hi, 2),
         lambda: S.swt_fwd_level_2d_ref(x, w7.dec_lo, w7.dec_hi, 2)),
        ("k1", lambda: K.fwd_level_2d(x, w7.dec_lo, w7.dec_hi),
         lambda: K.fwd_level_2d_ref(x, w7.dec_lo, w7.dec_hi)),
        ("k7", lambda: K1.fwd_level_1d(s, w8.dec_lo, w8.dec_hi),
         lambda: K1.fwd_level_1d_ref(s, w8.dec_lo, w8.dec_hi)),
        ("k3", lambda: flat(K.fwd_tail_2d(x, w7.dec_lo, w7.dec_hi, 2)),
         lambda: flat(K.fwd_tail_2d_ref(x, w7.dec_lo, w7.dec_hi, 2))),
        ("k4", lambda: [K.inv_tail_2d(ia, ibands, w7.rec_lo, w7.rec_hi)],
         lambda: [K.inv_tail_2d_ref(ia, ibands, w7.rec_lo, w7.rec_hi)])):
    for which, fn in (("kernel", kern), ("plain", plain)):
        outs = fn()
        nonfinite[f"{key} {which}"] = {"inf": sum(int(t.isinf().sum()) for t in outs),
                                       "nan": sum(int(t.isnan().sum()) for t in outs)}
print("NONFINITE", root, json.dumps(nonfinite))
if outdir:
    os.makedirs(outdir, exist_ok=True)
    name = os.path.basename(os.path.abspath(root))
    for key, outs in (("k5", k5), ("k1", k1), ("k3", k3)):
        torch.save(outs, os.path.join(outdir, f"{key}-{name}.pt"))
        for other in sorted(glob.glob(os.path.join(outdir, f"{key}-*.pt"))):
            oname = os.path.basename(other)[3:-3]
            if oname == name:
                continue
            ref = torch.load(other)
            rel = {lvl: max(float((a - b).abs().max()) for a, b in zip(outs[lvl], ref[lvl]))
                   / max(float(b.abs().max()) for b in ref[lvl]) for lvl in outs}
            label = "T3DIFF" if key == "k3" else f"{key.upper()}DIFF"
            print(label, name, oname, json.dumps(rel))
