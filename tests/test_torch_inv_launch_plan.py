"""Launch plans of the two banded-product inverses (kernels 14 and 18):
``swt_matmul.swt_inv_launch_plan`` and ``ns_matmul.ns_inv_launch_plan``
pick each launch's tile, grid, threads and shared memory on the host, so
their geometry is checked here on the CPU:

* every output position falls in exactly one tile of one block;
* every plan fits the H100's shared memory, for every scheme, rank and
  tap count the kernels take, and keeps the strips' divisibility;
* the cells' launches fill the card (about two blocks per SM);
* a numpy model of the kernels' tiling (window tables, zero-padded taps,
  strips, phases) reproduces the plain versions.
"""
import numpy as np
import pytest
import torch

from pdwt_tpu_torch import get_wavelet
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.kernels import _launch as L
from pdwt_tpu_torch.kernels import ns_matmul as NM
from pdwt_tpu_torch.kernels import swt_matmul as SM
from pdwt_tpu_torch.kernels.matmul import SCHEMES, kernel_taps
from pdwt_tpu_torch.kernels.mxu1d import _half


def _axis(index, n, lt, g, f):
    """(positions, in range) of one block's tile along one axis, as the
    kernels place it: consecutive (g = 1) or one residue class mod f."""
    fr = 1 if g == 1 else min(f, n)
    rho, q0 = index % fr, (index // fr) * lt
    pos = rho + g * (q0 + np.arange(lt))
    return pos, pos < n


def _coverage(plan, n_r, n_c, f, st, B):
    """How many times each output position of a (B, st n_r, st n_c)
    output is written by the plan's grid."""
    hits = np.zeros((B, st * n_r, st * n_c), dtype=np.int64)
    gx, gy, gz = plan.grid
    assert gz == min(B, 65535)
    for by in range(gy):
        rows, rin = _axis(by, n_r, plan.lr, f, f)
        for bx in range(gx):
            cols, cin = _axis(bx, n_c, plan.lc, plan.gc, f)
            r, c = rows[rin], cols[cin]
            for q in range(st):
                for p in range(st):
                    hits[:, (st * r + q)[:, None], (st * c + p)[None, :]] += 1
    return hits


def _check_shape_rules(plan, scheme, f):
    dc = f // plan.gc
    assert plan.gc in (1, f)
    assert plan.lr % L.ROW_STRIP[scheme] == 0
    assert plan.lc % (L.COL_STRIP * dc) == 0
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.smem <= L.SMEM_LIMIT


COVER_14 = [(1, 1, 1), (1, 2, 3), (2, 3, 5), (4, 3, 7), (8, 1, 13), (16, 3, 37), (32, 1, 53),
            (64, 3, 101), (64, 1, 8)]


@pytest.mark.parametrize("f,B,n", COVER_14)
@pytest.mark.parametrize("scheme", ["fd", "b3"])
def test_swt_inv_plan_covers_every_output_once(f, B, n, scheme):
    for R, C in ((n, n + 2), (max(1, n - 1), 3 * n)):
        plan = SM.swt_inv_launch_plan(B, R, C, 14, f, scheme)
        _check_shape_rules(plan, scheme, f)
        assert (_coverage(plan, R, C, f, 1, B) == 1).all(), plan


COVER_18 = [(None, 1, 1), (None, 3, 7), (None, 1, 33), (None, 3, 64), (1, 1, 5), (2, 3, 17),
            (4, 1, 29), (8, 3, 31), (16, 1, 41), (64, 1, 67)]


@pytest.mark.parametrize("f,B,n", COVER_18)
@pytest.mark.parametrize("rank,hlen", [(1, 2), (3, 8), (4, 40)])
def test_ns_inv_plan_covers_every_output_once(f, B, n, rank, hlen):
    st = 2 if f is None else 1
    for Mr, Mc in ((n, n + 2), (n + 1, 2 * n + 1)):
        plan = NM.ns_inv_launch_plan(B, Mr, Mc, hlen, rank, f, "b2f")
        _check_shape_rules(plan, "b2f", f or 1)
        assert (_coverage(plan, Mr, Mc, f or 1, st, B) == 1).all(), plan


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("shape,f", [((1, 1024, 1024), 1), ((1, 1024, 1024), 4),
                                     ((3, 300, 257), 16), ((1, 37, 53), 64)])
def test_swt_inv_plan_fits_shared_memory_for_every_tap_count(scheme, shape, f):
    for hlen in range(2, L.MAX_HLEN + 1):
        plan = SM.swt_inv_launch_plan(*shape, hlen, f, scheme)
        _check_shape_rules(plan, scheme, f)
        assert plan.nt >= hlen and plan.nt % SM.INV_CHUNK == 0


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("shape,f", [((1, 1024, 1024), None), ((1, 128, 128), None),
                                     ((1, 1024, 1024), 4), ((2, 45, 61), 16)])
def test_ns_inv_plan_fits_shared_memory_for_every_rank_and_tap_count(scheme, shape, f):
    for rank in range(1, NM.MAX_RANK + 1):
        for hlen in range(2, 41):
            plan = NM.ns_inv_launch_plan(*shape, hlen, rank, f, scheme)
            _check_shape_rules(plan, scheme, f or 1)
            nb = NM.inv_phases(hlen, f)[4:6]
            assert plan.nt >= max(nb) and plan.nt % NM.INV_CHUNK == 0


def _blocks(plan):
    return plan.grid[0] * plan.grid[1] * plan.grid[2]


def _want_blocks(ro, co):
    """Design rule: about two blocks per SM where the output has at least
    2 * 132 tiles of 16 x 16, else one block per two such tiles."""
    n16 = -(-ro // 16) * -(-co // 16)
    return 256 if n16 >= 2 * L.SMS else n16 // 2


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("scheme", ["fd", "b2f"])
def test_ti_cell_fills_the_card(f, scheme):
    plan = SM.swt_inv_launch_plan(1, 1024, 1024, 14, f, scheme)
    assert _blocks(plan) >= 2 * L.SMS
    assert plan.smem <= L.SMEM_TWO_BLOCKS


@pytest.mark.parametrize("m,scheme", [(1024, "fd"), (512, "b3"), (256, "b3"), (128, "b3")])
def test_rank3_polyphase_levels_fill_the_card(m, scheme):
    plan = NM.ns_inv_launch_plan(1, m, m, 8, 3, None, scheme)
    want = _want_blocks(2 * m, 2 * m)
    assert _blocks(plan) >= want
    if want >= 2 * L.SMS - 8:
        assert _blocks(plan) >= 132
    assert plan.smem <= L.SMEM_TWO_BLOCKS


@pytest.mark.parametrize("f", [1, 2, 4])
def test_rank3_atrous_levels_fill_the_card(f):
    plan = NM.ns_inv_launch_plan(1, 1024, 1024, 8, 3, f, "fd")
    assert _blocks(plan) >= 2 * L.SMS and plan.smem <= L.SMEM_TWO_BLOCKS


def test_ti_cell_reads_consecutive_columns_where_the_window_allows():
    """Consecutive columns (coalesced) at f = 1 and 2; at f = 4 db7's window
    would grow 1.57x over one residue class, and one class is taken."""
    gcs = [SM.swt_inv_launch_plan(1, 1024, 1024, 14, f, "fd").gc for f in (1, 2, 4)]
    assert gcs == [1, 1, 4]


# -- a numpy model of the kernels' tiling, against the plain versions ------

def _model_swt_inv(bands, rlo, rhi, level, scheme="fd"):
    """Kernel 14's tiling in float64: per block, the window tables, the
    zero-padded taps, the row pass into two temps and the column pass."""
    B, R, C = bands[0].shape
    f = 1 << (level - 1)
    tp = kernel_taps((_half(rlo), _half(rhi)), scheme)
    hlen = len(tp[0])
    cen = conv.swt_inv_center(hlen)
    pl = SM.swt_inv_launch_plan(B, R, C, hlen, f, scheme)
    nt, dc = pl.nt, f // pl.gc
    lo, hi = np.zeros(nt), np.zeros(nt)
    lo[:hlen], hi[:hlen] = tp[0], tp[2]
    WR, WC = pl.lr + nt - 1, pl.lc + (nt - 1) * dc
    x = [t.double().numpy() for t in bands]
    out = np.zeros((B, R, C))
    for by in range(pl.grid[1]):
        rows, rin = _axis(by, R, pl.lr, f, f)
        wrows = (rows[0] - cen * f + f * np.arange(WR)) % R
        for bx in range(pl.grid[0]):
            cols, cin = _axis(bx, C, pl.lc, pl.gc, f)
            wcols = (cols[0] - cen * f + pl.gc * np.arange(WC)) % C
            for b in range(B):
                w = [t[b][np.ix_(wrows, wcols)] for t in x]
                tmp = [sum(lo[j] * u[j:j + pl.lr] for j in range(nt))
                       + sum(hi[j] * v[j:j + pl.lr] for j in range(nt))
                       for u, v in ((w[0], w[1]), (w[2], w[3]))]
                o = (sum(lo[j] * tmp[0][:, j * dc:j * dc + pl.lc] for j in range(nt))
                     + sum(hi[j] * tmp[1][:, j * dc:j * dc + pl.lc] for j in range(nt)))
                out[b][np.ix_(rows[rin], cols[cin])] = o[np.ix_(rin, cin)]
    return out


def _model_ns_inv(bands, A, Bc, f, scheme="fd"):
    """Kernel 18's tiling in float64, polyphase (f None) or a-trous."""
    B, Mr, Mc = bands[0].shape
    taps = NM.ns_taps(A, Bc, scheme)
    rank, hlen = taps.shape[0], taps.shape[3]
    st, org, p0, p1, nb0, nb1, off0, off1 = NM.inv_phases(hlen, f)
    p, nb, off = (p0, p1), (nb0, nb1), (off0, off1)
    pl = NM.ns_inv_launch_plan(B, Mr, Mc, hlen, rank, f, scheme)
    f = f or 1
    nt, dc = pl.nt, f // pl.gc
    offmax = max(off[:st])
    WR, WC = pl.lr + offmax + nt - 1, pl.lc + (offmax + nt - 1) * dc
    rt, ct = np.zeros((st, rank, 4, nt)), np.zeros((st, rank, nt))
    for q in range(st):
        for bb in range(nb[q]):
            j = p[q] + st * bb
            ct[q, :, bb] = taps[:, 0, 0, j]
            rt[q, :, :, bb] = taps[:, 1:, 0, j]
    x = [t.double().numpy() for t in bands]
    out = np.zeros((B, st * Mr, st * Mc))
    for by in range(pl.grid[1]):
        rows, rin = _axis(by, Mr, pl.lr, f, f)
        wrows = (rows[0] - org * f + f * np.arange(WR)) % Mr
        for bx in range(pl.grid[0]):
            cols, cin = _axis(bx, Mc, pl.lc, pl.gc, f)
            wcols = (cols[0] - org * f + pl.gc * np.arange(WC)) % Mc
            for b in range(B):
                w = [t[b][np.ix_(wrows, wcols)] for t in x]
                tmp = np.zeros((rank, st * pl.lr, WC))
                for q in range(st):
                    for k in range(rank):
                        tmp[k, q::st] = sum(rt[q, k, s, j] * w[s][off[q] + j:off[q] + j + pl.lr]
                                            for s in range(4) for j in range(nt))
                tile = np.zeros((st * pl.lr, st * pl.lc))
                for q in range(st):
                    tile[:, q::st] = sum(ct[q, k, j] * tmp[k][:, (off[q] + j) * dc:
                                                             (off[q] + j) * dc + pl.lc]
                                         for k in range(rank) for j in range(nt))
                r, c = rows[rin], cols[cin]
                for q in range(st):
                    for s2 in range(st):
                        out[b][np.ix_(st * r + q, st * c + s2)] = \
                            tile[q::st, s2::st][np.ix_(rin, cin)]
    return out


@pytest.mark.parametrize("shape,level", [((1, 40, 70), 1), ((2, 37, 53), 2), ((1, 30, 41), 4),
                                         ((1, 8, 16), 5)])
def test_model_of_kernel_14_tiling_matches_the_plain_version(shape, level):
    w = get_wavelet("db7")
    g = np.random.default_rng(level)
    bands = [torch.from_numpy(g.uniform(-1, 1, shape).astype(np.float32)) for _ in range(4)]
    want = SM.swt_inv_level_2d_mxu_ref(*bands, w.rec_lo, w.rec_hi, level, "fd")
    got = _model_swt_inv(bands, w.rec_lo, w.rec_hi, level)
    np.testing.assert_allclose(got, want.double().numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,f,rank,hlen", [((1, 20, 36), None, 3, 8), ((2, 9, 13), None, 4, 6),
                                               ((1, 17, 40), 2, 3, 8), ((1, 33, 29), 8, 1, 4)])
def test_model_of_kernel_18_tiling_matches_the_plain_version(shape, f, rank, hlen):
    g = np.random.default_rng(hlen)
    A, Bc = g.standard_normal((4, rank, hlen)) / hlen, g.standard_normal((rank, hlen)) / hlen
    bands = [torch.from_numpy(g.uniform(-1, 1, shape).astype(np.float32)) for _ in range(4)]
    if f is None:
        want = NM.ns_inv_level_2d_mxu_ref(*bands, A, Bc, "fd")
        got = _model_ns_inv(bands, A, Bc, None)
    else:
        want = NM.ns_swt_inv_level_2d_mxu_ref(*bands, A, Bc, f.bit_length(), "fd")
        got = _model_ns_inv(bands, A, 0.25 * Bc, f)
    np.testing.assert_allclose(got, want.double().numpy(), rtol=0, atol=1e-5)
