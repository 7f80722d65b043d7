"""Device time per launch of kernel 7 (the exact decimated 1D analysis,
``batched1d.fwd_level_1d``) at the batched 1D cell's four levels (sym8,
1024 float32 signals of 4096 down to 512 samples), on its own launch plan
and, where the checkout has one (``mxu1d.fwd1d_launch_plan``), on every
tile of 16 to 256 outputs with 64, 128 and 256 threads.

    python3 scripts/decimated_1d_plan_probe.py ROOT

ROOT is the checkout to import (``.`` for this one; an unpacked
``git archive`` of another commit to compare in turns: parent, change,
change, parent).  Needs a CUDA card.  Prints one line, PROBE7 ROOT
{json}: per level, "default N" (the checkout's own plan), "default plan
N" (its tile and threads) and "lc<tile> t<threads> N", each the mean
device ms of a launch over 50 calls by torch.profiler (on a checkout
whose kernel 7 takes no launch plan, such as one before it ran kernel
15's body, every row times that kernel as it is).  Imports no JAX.
"""
import json
import sys

root = sys.argv[1]
sys.path.insert(0, root)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from pdwt_tpu_torch import get_wavelet  # noqa: E402
from pdwt_tpu_torch.kernels import batched1d as K1  # noqa: E402

dev = torch.device("cuda")
big = torch.randn(4096, 4096, device=dev)
for _ in range(50):  # bring the clocks up
    big @ big
torch.cuda.synchronize()


def dev_ms(fn, reps=50):
    """Mean device ms of the analysis kernel's launches over ``reps`` calls
    (the first body and the strip body both have "fwd" in their names);
    None if the profiler recorded none."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    t = [e.time_range.elapsed_us() for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA and "fwd" in e.name]
    return sum(t) / len(t) / 1e3 if t else None


w8 = get_wavelet("sym8")
gen = torch.Generator(device=dev).manual_seed(7)
res = {}
try:
    from pdwt_tpu_torch.kernels import mxu1d as M1
except ImportError:  # a checkout before kernel 15
    M1 = None
# the module whose fwd1d_launch_plan kernel 7's wrapper reads: batched1d
# where it launches kernel 7 itself, mxu1d where kernel 15's launcher does
owner = K1 if hasattr(K1, "fwd1d_launch_plan") else M1
plans = hasattr(owner, "fwd1d_launch_plan")
for n in (4096, 2048, 1024, 512):
    x = torch.randn(1024, n, device=dev, generator=gen)
    res[f"default {n}"] = dev_ms(lambda: K1.fwd_level_1d(x, w8.dec_lo, w8.dec_hi))
    if not plans:
        continue
    base = M1.fwd1d_launch_plan(1024, n, 16, 1, "fd", True)
    res[f"default plan {n}"] = f"lc {base.lc} threads {base.threads}"
    own = owner.fwd1d_launch_plan
    for lc in (16, 32, 64, 128, 256):
        if lc > n // 2:
            continue
        for th in (64, 128, 256):
            pl = base._replace(lc=lc, threads=th, grid=(-(-(n // 2) // lc), base.grid[1], 1),
                               smem=M1._fwd1d_smem("fd", 2, lc, 1, base.nt))
            owner.fwd1d_launch_plan = lambda *a, pl=pl: pl
            res[f"lc{lc} t{th} {n}"] = dev_ms(lambda: K1.fwd_level_1d(x, w8.dec_lo, w8.dec_hi))
    owner.fwd1d_launch_plan = own
print("PROBE7", root, json.dumps(res))
