"""The ranks of ``tests/test_torch_sharded.py``: every case of the port's
sharded transforms on 4 gloo processes on the CPU.  Imports the port only
(no JAX), so that spawned ranks stay light; rank 0 saves each result as
numpy arrays for the test to hold against the JAX package."""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from pdwt_tpu_torch import TIERS, get_wavelet, make_custom_wavelet, precision_scope
from pdwt_tpu_torch import parallel as par
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.models import sharded_denoise_step

WORLD = 4
#: an odd-length filter bank (5 taps): its levels take the conv passes
ODD5 = np.random.default_rng(5).standard_normal((4, 5))


def image(shape, seed):
    """The cases' inputs, float32 on [0, 255), made from a seed with numpy
    (the test makes the same arrays for JAX)."""
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _full(t):
    """The gathered global array (bf16 as its float32 values)."""
    t = t.full_tensor()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _coeffs(c):
    return [_full(c.approx)] + [_full(t) for band in c.details
                                for t in (band if isinstance(band, tuple) else (band,))]


def _error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def cases(rank: int) -> dict:
    """name -> list of numpy arrays (or an error message), every case."""
    out = {}
    db7, sym8, db4 = get_wavelet("db7"), get_wavelet("sym8"), get_wavelet("db4")
    m2 = par.make_mesh((1, 2, 2), device_type="cpu")
    ax2 = dict(data_axis=None, row_axis="row", col_axis="col")
    x = torch.from_numpy(image((64, 64), 0))
    xs = par.shard_image(x, m2, **ax2)
    for swt in (False, True):
        c = par.dwt2d(xs, db7, 3, m2, swt=swt, **ax2)
        y = par.idwt2d(c, db7, (64, 64), m2, swt=swt, **ax2)
        out[f"2d_{'swt' if swt else 'dwt'}"] = _coeffs(c) + [_full(y)]
        den, n1 = sharded_denoise_step(xs, "db7", 3, 10.0, m2, swt=swt, **ax2)
        out[f"step_{'swt' if swt else 'dwt'}"] = [_full(den), np.asarray(n1.numpy())]
    # the conv passes with the ring pad_fn: float64, and an odd filter
    x64 = par.shard_image(x.double(), m2, **ax2)
    for swt in (False, True):
        c = par.dwt2d(x64, db7, 3, m2, swt=swt, **ax2)
        out[f"f64_{'swt' if swt else 'dwt'}"] = _coeffs(c) + [
            _full(par.idwt2d(c, db7, (64, 64), m2, swt=swt, **ax2))]
    odd5 = make_custom_wavelet("odd5", *ODD5)
    c = par.swt2d(xs, odd5, 2, m2, **ax2)
    out["odd_filter"] = _coeffs(c) + _coeffs(par.dwt2d(xs, odd5, 2, m2, **ax2))
    # an odd unsharded axis: 63 rows, the columns over col (the row axis
    # of the mesh replicates)
    xo = torch.from_numpy(image((2, 63, 64), 1))
    axo = dict(data_axis=None, row_axis=None, col_axis="col")
    c = par.dwt2d(par.shard_image(xo, m2, **axo), db4, 2, m2, **axo)
    out["odd_rows"] = _coeffs(c) + [_full(par.idwt2d(c, db4, (63, 64), m2, **axo))]
    # a batch over data: mesh (data, row, col) = (2, 1, 2)
    mb = par.make_mesh((2, 1, 2), device_type="cpu")
    axb = dict(data_axis="data", row_axis="row", col_axis="col")
    xb = torch.from_numpy(image((4, 32, 32), 2))
    c = par.swt2d(par.shard_image(xb, mb, **axb), db4, 2, mb, **axb)
    out["batch_swt"] = _coeffs(c) + [_full(par.iswt2d(c, db4, (32, 32), mb, **axb))]
    # 1D: (data, col) = (1, 4)
    m1 = par.make_mesh((1, 4), ("data", "col"), device_type="cpu")
    ax1 = dict(data_axis="data", col_axis="col")
    s = torch.from_numpy(image((4, 256), 3))
    for swt in (False, True):
        c = par.dwt1d(par.shard_image(s, m1, **ax1), sym8, 4, m1, swt=swt, **ax1)
        out[f"1d_{'swt' if swt else 'dwt'}"] = _coeffs(c) + [
            _full(par.idwt1d(c, sym8, 256, m1, swt=swt, **ax1))]
    # halos wider than a shard, sym8 SWT over col = 4: 8 x 256 (64 samples a
    # shard) to level 5, whose halo sides of 112 and 128 samples take two
    # hops (level 4's, 56 and 64, take one); 8 x 128 (32 a shard) to level
    # 5, four hops a side, the fourth back to the shard itself
    axw = dict(col_axis="col")
    for n in (256, 128):
        sw = torch.from_numpy(image((8, n), 4))
        c = par.swt1d(par.shard_image(sw, m1, **axw), sym8, 5, m1, **axw)
        out[f"wide_halo_{n}"] = _coeffs(c) + [_full(par.iswt1d(c, sym8, n, m1, **axw))]
    # bf16 through gloo's send and receive, byte for byte: every rank's ring
    # halo of a bf16 image (5 and 7 columns, 6 and 3 rows, one hop each)
    # equals the same window of its periodic wrap
    xb = x.bfloat16()
    pad = par.make_pad_fn(m2, "row", "col")
    halo = pad(pad(par.shard_image(xb, m2, **ax2).to_local(), -1, 5, 7), -2, 6, 3)
    r0, c0 = 32 * m2.get_local_rank("row"), 32 * m2.get_local_rank("col")
    full = conv.wrap_pad(conv.wrap_pad(xb, -1, 5, 7), -2, 6, 3)
    ok = torch.tensor([int(halo.dtype == torch.bfloat16
                           and torch.equal(halo, full[r0:r0 + 41, c0:c0 + 44]))])
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    out["bf16_halo"] = [ok.numpy()]
    # the precision tiers: each level whose shard the route rule accepts
    # runs a banded-product padded kernel, bf16 halos for a bf16 level.  The
    # 2D DWT of 128 x 512 on (row, col) = (2, 2), 2 levels (64 x 256 shards:
    # level 1 banded, level 2 exact), under each tier (bf16 image under the
    # bf16 ones); the 2D SWT (levels 1-2 banded) and the TI step on a bf16
    # image under two rungs; the 1D DWT and SWT of 16 x 1024 over col = 4
    # (16 x 256 shards: the DWT's level 1 banded, every SWT level banded).
    # Each case records its dtypes beside its values.
    xt = torch.from_numpy(image((128, 512), 6))
    s1 = torch.from_numpy(image((16, 1024), 7))
    for tier in TIERS[1:]:
        cast = (lambda t: t.bfloat16()) if tier.startswith("bf16-") else (lambda t: t)
        with precision_scope(tier):
            xs_t = par.shard_image(cast(xt), m2, **ax2)
            c = par.dwt2d(xs_t, db7, 2, m2, **ax2)
            _tiered(out, f"tier_dwt2d_{tier}", _leaves(c) + [par.idwt2d(c, db7, (128, 512), m2,
                                                                         **ax2)])
            ss = par.shard_image(cast(s1), m1, **ax1)
            for swt in (False, True):
                c = par.dwt1d(ss, sym8, 3, m1, swt=swt, **ax1)
                y = par.idwt1d(c, sym8, 1024, m1, swt=swt, **ax1)
                _tiered(out, f"tier_{'swt' if swt else 'dwt'}1d_{tier}", _leaves(c) + [y])
            if tier in ("bf16-fast", "bf16-accurate"):
                c = par.swt2d(xs_t, db7, 2, m2, **ax2)
                _tiered(out, f"tier_swt2d_{tier}", _leaves(c) + [par.iswt2d(c, db7, (128, 512),
                                                                           m2, **ax2)])
                den, n1 = sharded_denoise_step(xs_t, "db7", 2, 10.0, m2, swt=True, **ax2)
                _tiered(out, f"tier_step_{tier}", [den, n1])
    # the errors, raised before any exchange
    out["err_row"] = _error(lambda: par.dwt2d(torch.zeros(60, 64), db7, 3, m2, **ax2))
    out["err_col_swt"] = _error(lambda: par.swt2d(torch.zeros(64, 65), db7, 2, m2, **ax2))
    out["err_signal"] = _error(lambda: par.dwt1d(torch.zeros(4, 100), sym8, 4, m1, **ax1))
    out["err_batch"] = _error(lambda: par.dwt2d(torch.zeros(3, 32, 32), db4, 1, mb, **axb))
    # the MXU modes, which raised before the tier route: they run now
    out["err_bf16"] = _error(lambda: par.dwt2d(xs.to_local().bfloat16(), db7, 1, m2, **ax2))
    with precision_scope("mixed"):
        out["err_mixed"] = _error(lambda: par.dwt2d(xs, db7, 1, m2, **ax2))
    return out


def _leaves(c):
    return [c.approx] + [t for band in c.details
                         for t in (band if isinstance(band, tuple) else (band,))]


def _tiered(out: dict, name: str, ts) -> None:
    """A tier case: the gathered float32 values of each DTensor (a plain
    tensor, the norm, as it is) under ``name`` and their dtypes under
    ``name + "#dtypes"``."""
    out[name] = [_full(t) if hasattr(t, "full_tensor") else t.numpy() for t in ts]
    out[name + "#dtypes"] = " ".join(str(t.dtype).split(".")[-1] for t in ts)


def run(rank: int, store_path: str, out_dir: str) -> None:
    store = dist.FileStore(store_path, WORLD)
    # a rank stuck on another raises after a minute instead of hanging
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = cases(rank)
        if rank == 0:
            arrays, errors = {}, {}
            for name, val in out.items():
                if isinstance(val, str):
                    errors[name] = np.asarray(val)
                else:
                    arrays.update({f"{name}/{k}": a for k, a in enumerate(val)})
            np.savez(os.path.join(out_dir, "sharded.npz"), **arrays, **errors)
        dist.barrier()
    finally:
        dist.destroy_process_group()
