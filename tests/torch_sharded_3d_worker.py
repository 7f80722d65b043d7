"""The ranks of ``tests/test_torch_sharded_3d.py``,
``tests/test_torch_sharded_ns.py`` and ``tests/test_torch_sharded_families.py``:
every case of the port's sharded volume, non-separable, fully separable,
starlet and packet transforms on 4 gloo processes on the CPU.  Imports the
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


#: the families' inputs: fs_dwt on (row, col) and on (None, col), the
#: starlet in 2D and 1D, the 2D, 1D and 3D packets
FS_IMG, FS_ODD, ST_IMG, ST_SIG = (2, 64, 128), (2, 45, 128), (2, 64, 64), (2, 256)
WP_IMG, WP_SIG, WP_VOL = (2, 64, 128), (4, 256), (16, 32, 64)


def cases_families(rank: int) -> dict:
    from pdwt_tpu_torch.core import packets as PK
    from pdwt_tpu_torch.parallel import anisotropic as PA
    from pdwt_tpu_torch.parallel import packets as PP

    out = {}
    m2 = par.make_mesh((1, 2, 2), device_type="cpu")
    m1 = par.make_mesh((2, 2), ("data", "col"), device_type="cpu")
    db4, db3, db2 = get_wavelet("db4"), get_wavelet("db3"), get_wavelet("db2")
    full = lambda t: t.full_tensor()
    # fs_dwt / fs_idwt: (row, col) = (2, 2), levels (2, 1); the rows
    # unsharded and odd, the columns over col, levels (1, 2); the
    # all-gathers of the packs and unpacks counted
    for tag, shape, lv, axes, w, seed in (("22", FS_IMG, (2, 1), ("row", "col"), db4, 30),
                                          ("none_col", FS_ODD, (1, 2), (None, "col"), db3, 31)):
        x = torch.from_numpy(image(shape, seed))
        n0 = PA.COLLECTIVES["all_gather"]
        y = par.fs_dwt(x, w, lv, m2, axes=axes)
        n1 = PA.COLLECTIVES["all_gather"]
        r = par.fs_idwt(y, w, shape[-2:], lv, m2, axes=axes)
        n2 = PA.COLLECTIVES["all_gather"]
        _tiered(out, f"fs_{tag}", [y, r])
        out[f"fs_{tag}_gathers"] = f"{n1 - n0} {n2 - n1}"
    # the 2D case again as a bf16 image under bf16-fast, against the port's
    # own single-device call on the same image
    from pdwt_tpu_torch.core.anisotropic import fs_dwt as fs_single

    xb = torch.from_numpy(image(FS_IMG, 30)).bfloat16()
    with precision_scope("bf16-fast"):
        y = par.fs_dwt(xb, db4, (2, 1), m2, axes=("row", "col"))
        _tiered(out, "fs_bf16", [y, fs_single(xb, db4, (2, 1))])
    # the starlet: 2D over (row, col), gen 2 and gen 1; 1D over (data, col)
    for gen in (2, 1):
        x = torch.from_numpy(image(ST_IMG, 32))
        c = par.starlet(x, 3, m2, spatial_axes=("row", "col"), gen=gen)
        y = par.istarlet(c, m2, spatial_axes=("row", "col"), gen=gen)
        _tiered(out, f"starlet2d_gen{gen}", _leaves(c) + [y])
    s = torch.from_numpy(image(ST_SIG, 33))
    c = par.starlet(s, 3, m1, data_axis="data", spatial_axes=("col",))
    y = par.istarlet(c, m1, data_axis="data", spatial_axes=("col",))
    _tiered(out, "starlet1d", _leaves(c) + [y])
    # the packets: the tree, a best-basis reconstruction (the cover from the
    # gathered nodes, saved for the test), the full inverse
    ax2 = dict(row_axis="row", col_axis="col")
    x = torch.from_numpy(image(WP_IMG, 34))
    pk = PP.wp2d(x, db3, 2, m2, **ax2)
    leaves, _ = PK.best_basis(pk, "shannon")  # the DTensor nodes: cost sums all-reduced
    soft = lambda v, j, i: v if i == 0 else torch.sign(v) * torch.clamp(v.abs() - 20.0, min=0)
    _tiered(out, "wp2d", list(pk.nodes) + [PP.wp_reconstruct(pk, leaves, db3, m2, **ax2),
                                           PP.wp_reconstruct(pk, leaves, db3, m2, map_fn=soft,
                                                             **ax2),
                                           PP.iwp2d(pk.nodes[-1], db3, WP_IMG[-2:], m2, **ax2)])
    out["wp2d_leaves"] = np.asarray(leaves, np.int64)
    with precision_scope("bf16-fast"):
        xb = x.bfloat16()
        pk = PP.wp2d(xb, db3, 2, m2, **ax2)
        one = PK.wp2d(xb, db3, 2)
        _tiered(out, "wp2d_bf16", list(pk.nodes) + [PP.iwp2d(pk.nodes[-1], db3, WP_IMG[-2:],
                                                             m2, **ax2)])
        _tiered(out, "wp2d_bf16_one", [t.float() for t in list(one.nodes) + [
            PK.iwp2d(one.nodes[-1], db3, WP_IMG[-2:])]])
    ax1 = dict(data_axis="data", col_axis="col")
    s = torch.from_numpy(image(WP_SIG, 35))
    pk = PP.wp1d(s, db2, 3, m1, **ax1)
    _tiered(out, "wp1d", list(pk.nodes) + [PP.iwp1d(pk.nodes[-1], db2, WP_SIG[-1], m1, **ax1)])
    v = torch.from_numpy(image(WP_VOL, 36))
    pk = PP.wp3d(v, db2, 2, m2, **ax2)
    leaves, _ = PK.best_basis(PK.Packets3D(tuple(map(full, pk.nodes))), "l1")
    _tiered(out, "wp3d", list(pk.nodes) + [PP.wp_reconstruct(pk, leaves, db2, m2, **ax2),
                                           PP.iwp3d(pk.nodes[-1], db2, WP_VOL, m2, **ax2)])
    out["wp3d_leaves"] = np.asarray(leaves, np.int64)
    m22 = par.make_mesh((1, 2, 2, 1), AXES4, device_type="cpu")
    ax3 = dict(dep_axis="dep", row_axis="row")
    pk = PP.wp3d(v, db2, 2, m22, **ax3)
    _tiered(out, "wp3d_dep", list(pk.nodes) + [PP.iwp3d(pk.nodes[-1], db2, WP_VOL, m22, **ax3)])
    # the errors, raised before any exchange
    out["err_fs_div"] = _error(lambda: par.fs_dwt(torch.zeros(2, 60, 128), db4, (2, 1), m2,
                                                  axes=("row", "col")))
    out["err_fs_batch"] = _error(lambda: par.fs_dwt(torch.zeros(64, 128), db4, (1, 1), m2,
                                                    axes=("row", "col"), data_axis="data"))
    out["err_fs_axes"] = _error(lambda: par.fs_dwt(torch.zeros(64, 128), db4, (1, 1, 1), m2,
                                                   axes=("row", "col")))
    out["err_starlet_div"] = _error(lambda: par.starlet(torch.zeros(2, 63, 64), 2, m2,
                                                        spatial_axes=("row", "col")))
    out["err_starlet_batch"] = _error(lambda: par.starlet(torch.zeros(3, 64), 2, m1,
                                                          data_axis="data",
                                                          spatial_axes=("col",)))
    out["err_wp2d_div"] = _error(lambda: PP.wp2d(torch.zeros(2, 60, 128), db3, 2, m2, **ax2))
    return out


SUITES = {"3d": cases_3d, "ns": cases_ns, "families": cases_families}


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
