"""The ranks of ``tests/test_torch_sharded_3d.py`` and
``tests/test_torch_sharded_ns.py``: every case of the port's sharded volume
and non-separable transforms on 4 gloo processes on the CPU.  Imports the
port only (no JAX), so that spawned ranks stay light; rank 0 saves each
result as numpy arrays for the tests to hold against the JAX package."""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from pdwt_tpu_torch import get_wavelet, make_custom_wavelet, precision_scope
from pdwt_tpu_torch import parallel as par
from pdwt_tpu_torch.filters import quad_filters
from pdwt_tpu_torch.models import sharded_denoise_step_3d
from torch_sharded_worker import ODD5, WORLD, _error, _leaves, _tiered, image

#: the 3D cases' volume (JAX's own sharded 3D tests, tests/test_parallel.py:275-410)
VOL = (16, 32, 32)
#: the tier cases' volume: (dep, row) = (2, 2) shards of 4 x 64 x 512, level
#: 1 on the banded-product padded kernels (32 x 256 subbands), level 2 exact
TIER_VOL = (8, 128, 512)
#: the non-separable cases' image, and the data-axis batch's
NS_IMG, NS_BATCH = (32, 32), (4, 64, 256)
AXES4 = ("data", "dep", "row", "col")


def rank2_quads() -> np.ndarray:
    """The rank-2 6 x 6 quads of ``tests/test_parallel.py:243-273``."""
    q = np.zeros((4, 6, 6))
    g = np.random.default_rng(3)
    for _ in range(2):
        q += np.einsum("si,j->sij", g.standard_normal((4, 6)), g.standard_normal(6))
    return q / np.abs(q).sum(axis=(1, 2), keepdims=True)


def aniso_quads(kind: str = "dec") -> np.ndarray:
    """Jointly separable quads with db4 along the rows and sym4 along the
    columns."""
    r, c = get_wavelet("db4"), get_wavelet("sym4")
    lo_r, hi_r = getattr(r, kind + "_lo"), getattr(r, kind + "_hi")
    lo_c, hi_c = getattr(c, kind + "_lo"), getattr(c, kind + "_hi")
    return np.stack([np.outer(lo_r, lo_c), np.outer(hi_r, lo_c), np.outer(lo_r, hi_c),
                     np.outer(hi_r, hi_c)])


def ns_quads() -> dict:
    """name -> (forward quads, inverse quads): genuinely 2D (rank 2; its
    inverse takes the same quads, as JAX's test does), anisotropic
    factored, and db2's isotropic outer products."""
    db2 = get_wavelet("db2")
    return {"rank2": (rank2_quads(), rank2_quads()),
            "aniso": (aniso_quads(), aniso_quads("rec")),
            "db2": (quad_filters(db2.dec_lo, db2.dec_hi), quad_filters(db2.rec_lo, db2.rec_hi))}


def cases_3d(rank: int) -> dict:
    out = {}
    db4 = get_wavelet("db4")
    m22 = par.make_mesh((1, 2, 2, 1), AXES4, device_type="cpu")
    m4 = par.make_mesh((1, 4, 1, 1), AXES4, device_type="cpu")
    ax = dict(dep_axis="dep", row_axis="row", col_axis="col")
    v = torch.from_numpy(image(VOL, 10))
    # exact float32 on (dep, row) = (2, 2) and on dep = 4 (4 planes a shard:
    # level 2's halos take several hops, 14 planes for the SWT)
    for tag, mesh in (("22", m22), ("4", m4)):
        xs = par.shard_image(v, mesh, **ax)
        for swt in (False, True):
            c = par.dwt3d(xs, db4, 2, mesh, swt=swt, **ax)
            y = par.idwt3d(c, db4, VOL, mesh, swt=swt, **ax)
            _tiered(out, f"{'swt' if swt else 'dwt'}_{tag}", _leaves(c) + [y])
    # an odd-length bank in float64: the conv passes with the ring
    odd5 = make_custom_wavelet("odd5", *ODD5)
    x64 = par.shard_image(v.double(), m22, **ax)
    for swt in (False, True):
        c = par.dwt3d(x64, odd5, 2, m22, swt=swt, **ax)
        _tiered(out, f"odd_{'swt' if swt else 'dwt'}", _leaves(c))
    # a batch of volumes over data, the depth unsharded: (data, col) = (2, 2)
    mb = par.make_mesh((2, 1, 1, 2), AXES4, device_type="cpu")
    axb = dict(data_axis="data", col_axis="col")
    xb = torch.from_numpy(image((4, 8, 16, 32), 11))
    xbs = par.shard_image(xb, mb, dep_axis=None, **axb)
    for swt in (False, True):
        c = par.dwt3d(xbs, db4, 2, mb, swt=swt, **axb)
        y = par.idwt3d(c, db4, (8, 16, 32), mb, swt=swt, **axb)
        _tiered(out, f"batch_{'swt' if swt else 'dwt'}", _leaves(c) + [y])
    # the denoising step, soft, beta 10
    for swt in (False, True):
        den, n1 = sharded_denoise_step_3d(par.shard_image(v, m22, **ax), db4, 2, 10.0, m22,
                                          swt=swt, **ax)
        _tiered(out, f"step_{'swt' if swt else 'dwt'}", [den, n1])
    # the tiers: a bf16 volume under bf16-fast (the DWT, the SWT and the TI
    # step), a float32 one under mixed (the DWT; its SWT runs exact)
    xt = torch.from_numpy(image(TIER_VOL, 12))
    for tier, cast in (("bf16-fast", torch.bfloat16), ("mixed", torch.float32)):
        with precision_scope(tier):
            xs = par.shard_image(xt.to(cast), m22, **ax)
            for swt in (False, True):
                c = par.dwt3d(xs, db4, 2, m22, swt=swt, **ax)
                y = par.idwt3d(c, db4, TIER_VOL, m22, swt=swt, **ax)
                _tiered(out, f"tier_{'swt' if swt else 'dwt'}_{tier}", _leaves(c) + [y])
            if tier == "bf16-fast":
                den, n1 = sharded_denoise_step_3d(xs, db4, 2, 10.0, m22, swt=True, **ax)
                _tiered(out, f"tier_step_{tier}", [den, n1])
    # the errors, raised before any exchange
    out["err_depth"] = _error(lambda: par.dwt3d(torch.zeros(12, 32, 32), db4, 2, m22, **ax))
    out["err_depth_swt"] = _error(lambda: par.swt3d(torch.zeros(6, 32, 32), db4, 2, m4, **ax))
    out["err_rank"] = _error(lambda: par.dwt3d(torch.zeros(32, 32), db4, 1, m22, **ax))
    out["err_batch"] = _error(lambda: par.dwt3d(torch.zeros(16, 32, 32), db4, 1, mb, **axb))
    out["err_inverse"] = _error(lambda: par.idwt3d(
        par.dwt3d(par.shard_image(v, m22, **ax), db4, 1, m22, **ax), db4, (18, 32, 32), m22,
        **ax))
    return out


def cases_ns(rank: int) -> dict:
    out = {}
    m2 = par.make_mesh((1, 2, 2), device_type="cpu")
    md = par.make_mesh((4, 1, 1), device_type="cpu")
    ax2 = dict(row_axis="row", col_axis="col")
    axd = dict(data_axis="data")
    x = torch.from_numpy(image(NS_IMG, 20))
    xb = torch.from_numpy(image(NS_BATCH, 21))
    for name, (qf, qi) in ns_quads().items():
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[-1]
            for tag, mesh, axes, img in (("ring", m2, ax2, x), ("data", md, axd, xb)):
                if tag == "data" and (name != "rank2" or dt != torch.bfloat16):
                    img = img[:, :32, :32]  # the exact data-axis cases run small
                shape = tuple(img.shape[-2:])
                xs = par.shard_image(img.to(dt), mesh, **axes)
                c = par.dwt2d_ns(xs, qf, 2, mesh, **axes)
                y = par.idwt2d_ns(c, qi, shape, mesh, **axes)
                _tiered(out, f"{name}_{tag}_{dn}_dwt", _leaves(c) + [y])
                c = par.swt2d_ns(xs, qf, 2, mesh, **axes)
                y = par.iswt2d_ns(c, qi, mesh, **axes)
                _tiered(out, f"{name}_{tag}_{dn}_swt", _leaves(c) + [y])
    out["err_row"] = _error(lambda: par.dwt2d_ns(torch.zeros(36, 32), rank2_quads(), 2, m2,
                                                 **ax2))
    return out


SUITES = {"3d": cases_3d, "ns": cases_ns}


def run(rank: int, store_path: str, out_dir: str, suite: str) -> None:
    """One rank of ``suite``; rank 0 saves ``<suite>.npz`` in ``out_dir``:
    each case's values under ``name/k``, its dtypes under ``name#dtypes``,
    each error message under its name."""
    store = dist.FileStore(store_path, WORLD)
    # a rank stuck on another raises after a minute instead of hanging
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = SUITES[suite](rank)
        if rank == 0:
            arrays = {}
            for name, val in out.items():
                if isinstance(val, str):
                    arrays[name] = np.asarray(val)
                else:
                    arrays.update({f"{name}/{k}": a for k, a in enumerate(val)})
            np.savez(os.path.join(out_dir, f"{suite}.npz"), **arrays)
        dist.barrier()
    finally:
        dist.destroy_process_group()
