"""Launch plans of kernels 17 and 16, redesigned for Hopper's CUDA cores on
``csrc/band_strip.cuh``, checked on the CPU:

* kernel 17, the rank-r analysis (``ns_matmul.ns_fwd_launch_plan``, both
  strides), and kernel 16, the batched 1D synthesis
  (``mxu1d.inv1d_launch_plan``, polyphase and a-trous): every output falls
  in exactly one tile of one block, across shapes no tile divides,
  dilations 1-16 and one past the signal, batches 1 and 3, ranks 1-4 and
  2-40 taps (17) or 2-128 taps (16), in every scheme;
* every plan fits the H100's shared memory and keeps the strips'
  divisibility;
* the cells' levels get at least 128 blocks;
* float64 numpy models of both tilings (window tables, residue classes,
  strips of outputs OS samples apart, zero-padded taps on a common origin)
  reproduce the plain versions;
* for 16, a model of the words the lanes of a warp read and write in
  shared memory shows no bank conflict at the cells' dilations.
"""
import numpy as np
import pytest
import torch

from pdwt_tpu_torch import get_wavelet
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.filters import make_custom_wavelet
from pdwt_tpu_torch.kernels import _launch as L
from pdwt_tpu_torch.kernels import mxu1d as M1
from pdwt_tpu_torch.kernels import ns_matmul as NM
from pdwt_tpu_torch.kernels.matmul import SCHEMES, kernel_taps
from test_torch_inv_launch_plan import _axis, _coverage

F32 = torch.float32


def _blocks(plan):
    return plan.grid[0] * plan.grid[1] * plan.grid[2]


def _check_rules(plan, scheme, f):
    """The strips' divisibility and the card's limits, as the C entry
    points check them."""
    dc = f // plan.gc
    assert plan.gc in (1, f)
    assert plan.lr % L.ROW_STRIP[scheme] == 0
    assert plan.lc % (L.ROW_STRIP[scheme] * dc) == 0
    assert plan.threads == 256 and plan.nph == 1
    assert plan.smem <= L.SMEM_LIMIT


# -- kernel 17: ns_fwd_launch_plan ------------------------------------------

COVER_17 = [(2, 1, 1, (2, 2)), (2, 1, 3, (6, 10)), (2, 1, 1, (70, 134)), (2, 1, 3, (130, 66)),
            (1, 1, 1, (5, 7)), (1, 2, 3, (17, 29)), (1, 4, 1, (37, 53)), (1, 8, 3, (45, 61)),
            (1, 16, 1, (101, 77)), (1, 64, 1, (37, 53)), (1, 2, 1, (129, 200))]


@pytest.mark.parametrize("stride,f,B,shape", COVER_17)
@pytest.mark.parametrize("rank,hlen", [(1, 2), (3, 8), (4, 40)])
def test_ns_fwd_plan_covers_every_output_once(stride, f, B, shape, rank, hlen):
    R, C = shape
    for scheme in ("fd", "b3"):
        plan = NM.ns_fwd_launch_plan(B, R, C, hlen, rank, stride, f, scheme)
        _check_rules(plan, scheme, f)
        assert stride == 1 or plan.gc == 1
        assert (_coverage(plan, R // stride, C // stride, f, 1, B) == 1).all(), plan


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("shape,stride,f", [((1, 2048, 2048), 2, 1), ((1, 256, 256), 2, 1),
                                            ((1, 1024, 1024), 1, 4), ((3, 37, 53), 1, 16),
                                            ((2, 70, 134), 2, 1)])
def test_ns_fwd_plan_fits_shared_memory_for_every_rank_and_tap_count(scheme, shape, stride, f):
    for rank in range(1, NM.MAX_RANK + 1):
        for hlen in range(2, 41):
            plan = NM.ns_fwd_launch_plan(*shape, hlen, rank, stride, f, scheme)
            _check_rules(plan, scheme, f)
            assert plan.nt >= hlen and plan.nt % NM.INV_CHUNK == 0
            assert plan.smem == NM._fwd_smem(scheme, rank, stride, plan.lr, plan.lc,
                                             f // plan.gc, plan.nt)


@pytest.mark.parametrize("r,scheme", [(2048, "b1"), (1024, "b3"), (512, "b3"), (256, "b3"),
                                      (2048, "b2f"), (1024, "fd")])
def test_rank3_decimated_levels_get_128_blocks(r, scheme):
    """The DWT cell's levels 1-4 (2048^2 in, 128^2 out at level 4)."""
    plan = NM.ns_fwd_launch_plan(1, r, r, 8, 3, 2, 1, scheme)
    assert _blocks(plan) >= 128 and plan.smem <= L.SMEM_TWO_BLOCKS


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("scheme", ["b1", "b2f", "fd"])
def test_rank3_atrous_levels_fill_the_card(f, scheme):
    plan = NM.ns_fwd_launch_plan(1, 1024, 1024, 8, 3, 1, f, scheme)
    assert _blocks(plan) >= 2 * L.SMS and plan.smem <= L.SMEM_TWO_BLOCKS
    assert plan.gc == 1  # the window grows at most 1.4x at the cell's dilations


def _model_ns_fwd(x, A, Bc, stride, f, scheme="fd"):
    """Kernel 17's tiling in float64: per block, the window tables (rows of
    one residue class, columns consecutive or of one class), the column
    pass in strips of outputs `stride` samples apart into the rank temps,
    then the row pass over (k, tap) for the four subbands."""
    B, R, C = x.shape
    taps = NM.ns_taps(A, Bc, scheme)
    rank, hlen = taps.shape[0], taps.shape[3]
    pl = NM.ns_fwd_launch_plan(B, R, C, hlen, rank, stride, f, scheme)
    nt, dc, st = pl.nt, f // pl.gc, stride
    ct, rt = np.zeros((rank, nt)), np.zeros((4, rank, nt))
    ct[:, :hlen] = taps[:, 0, 0]
    rt[:, :, :hlen] = taps[:, 1:, 0].transpose(1, 0, 2)
    cen = conv.fwd_center(hlen)
    WR, WC = st * (pl.lr - 1) + nt, st * (pl.lc - 1) + (nt - 1) * dc + 1
    ro, co = R // st, C // st
    xs = x.double().numpy()
    out = np.zeros((4, B, ro, co))
    for by in range(pl.grid[1]):
        rows, rin = _axis(by, ro, pl.lr, f, f)
        wrows = (st * rows[0] - cen * f + f * np.arange(WR)) % R
        for bx in range(pl.grid[0]):
            cols, cin = _axis(bx, co, pl.lc, pl.gc, f)
            wcols = (st * cols[0] - cen * f + pl.gc * np.arange(WC)) % C
            t = np.arange(pl.lc)
            for b in range(B):
                w = xs[b][np.ix_(wrows, wcols)]
                tmp = [sum(ct[k, j] * w[:, st * t + j * dc] for j in range(nt))
                       for k in range(rank)]
                r = np.arange(pl.lr)
                for s in range(4):
                    o = sum(rt[s, k, j] * tmp[k][st * r + j] for k in range(rank)
                            for j in range(nt))
                    out[s, b][np.ix_(rows[rin], cols[cin])] = o[np.ix_(rin, cin)]
    return out


@pytest.mark.parametrize("shape,stride,f,rank,hlen", [
    ((1, 40, 70), 2, 1, 3, 8), ((2, 18, 26), 2, 1, 4, 6), ((1, 30, 44), 2, 1, 1, 40),
    ((1, 37, 53), 1, 1, 3, 8), ((2, 17, 40), 1, 2, 2, 5), ((1, 33, 29), 1, 8, 1, 4),
    ((1, 21, 19), 1, 32, 3, 8)])
def test_model_of_kernel_17_tiling_matches_the_plain_version(shape, stride, f, rank, hlen):
    g = np.random.default_rng(hlen + f)
    A, Bc = g.standard_normal((4, rank, hlen)) / hlen, g.standard_normal((rank, hlen)) / hlen
    x = torch.from_numpy(g.uniform(-1, 1, shape).astype(np.float32))
    if stride == 2:
        want = NM.ns_fwd_level_2d_mxu_ref(x, A, Bc, "fd")
    else:
        want = NM.ns_swt_fwd_level_2d_mxu_ref(x, A, Bc, f.bit_length(), "fd")
    got = _model_ns_fwd(x, A, Bc, stride, f)
    for s in range(4):
        np.testing.assert_allclose(got[s], want[s].double().numpy(), rtol=0, atol=1e-5)


# -- kernel 16: inv1d_launch_plan -------------------------------------------

def _coverage_1d(plan, B, M, f, decimated):
    """How many times each output of a (B, 2M) or (B, M) synthesis is
    written by the plan's grid: 32 signals per block row, lc positions of
    the bands per block column."""
    nph = 2 if decimated else 1
    hits = np.zeros((B, nph * M), dtype=np.int64)
    gx, gy, gz = plan.grid
    assert gz == 1 and gy == min(-(-B // 32), 65535) and plan.lr == M1.INV_ROWS
    for grp in range(-(-B // 32)):  # the kernel loops the groups past gy
        sig = np.arange(32 * grp, min(32 * grp + 32, B))
        for bx in range(gx):
            pos, pin = _axis(bx, M, plan.lc, plan.gc, f)
            for q in range(nph):
                hits[np.ix_(sig, nph * pos[pin] + q)] += 1
    return hits


COVER_16 = [(1, 1), (1, 3), (3, 7), (1, 33), (3, 100), (40, 257), (1, 1000), (70, 65)]


@pytest.mark.parametrize("B,M", COVER_16)
@pytest.mark.parametrize("f", [None, 1, 2, 4, 8, 16, 2048])
@pytest.mark.parametrize("hlen", [2, 16, 128])
def test_inv1d_plan_covers_every_output_once(B, M, f, hlen):
    for scheme in ("fd", "b3"):
        plan = M1.inv1d_launch_plan(B, M, hlen, f or 1, scheme, f is None)
        _check_rules(plan, scheme, f or 1)
        assert f is not None or plan.gc == 1
        assert (_coverage_1d(plan, B, M, f or 1, f is None) == 1).all(), plan


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("B,M,f", [(1024, 2048, None), (1024, 256, None), (1024, 4096, 8),
                                   (3, 101, 16), (2, 5000, 2048), (1, 6, 4)])
def test_inv1d_plan_fits_shared_memory_for_every_tap_count(scheme, B, M, f):
    for hlen in range(2, L.MAX_HLEN + 1):
        plan = M1.inv1d_launch_plan(B, M, hlen, f or 1, scheme, f is None)
        _check_rules(plan, scheme, f or 1)
        need, _ = M1.inv1d_taps(hlen, f is None)
        assert plan.nt >= need and plan.nt % M1.INV_CHUNK[f is None] == 0
        assert plan.smem == M1._inv1d_smem(scheme, 2 if f is None else 1, plan.lc,
                                           (f or 1) // plan.gc, plan.nt)


@pytest.mark.parametrize("m,scheme", [(2048, "fd"), (1024, "b3"), (512, "b3"), (256, "b3"),
                                      (2048, "b2f")])
def test_decimated_cell_levels_get_128_blocks(m, scheme):
    """The 1D DWT cell's synthesis levels: sym8, 1024 signals, bands 2048
    down to 256 samples."""
    plan = M1.inv1d_launch_plan(1024, m, 16, 1, scheme, True)
    assert _blocks(plan) >= 128 and plan.smem <= L.SMEM_TWO_BLOCKS


@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_atrous_cell_levels_fill_the_card(f):
    plan = M1.inv1d_launch_plan(1024, 4096, 16, f, "fd", False)
    assert _blocks(plan) >= 2 * L.SMS and plan.smem <= L.SMEM_TWO_BLOCKS
    assert plan.gc == 1  # consecutive positions: coalesced loads and stores


def test_a_dilation_of_thousands_takes_one_residue_class():
    """sym8 at level 12 on 5000 samples: the window does not grow with f."""
    plan = M1.inv1d_launch_plan(2, 5000, 16, 2048, "b3", False)
    assert plan.gc == 2048 and plan.lc + plan.nt - 1 < 300


def _model_inv1d(lo, hi, rlo, rhi, f, decimated, scheme="fd"):
    """Kernel 16's tiling in float64: per block, the window table (its
    origin at the earlier parity's first sample, or at -cen f), both
    bands' windows for 32 signal rows (the last signal repeated past B),
    strips over the parities' zero-padded tap tables on a common origin,
    or over taps dc window entries apart."""
    B, M = lo.shape
    filters = (rlo, rhi) if decimated else (M1._half(rlo), M1._half(rhi))
    tp = kernel_taps(filters, scheme)
    hlen = len(tp[0])
    pl = M1.inv1d_launch_plan(B, M, hlen, f, scheme, decimated)
    nt, dc, nph = pl.nt, f // pl.gc, 2 if decimated else 1
    need, sh = M1.inv1d_taps(hlen, decimated)
    tq = np.zeros((nph, 2, nt))
    if decimated:
        g = conv.poly_geometry(hlen)
        for q in range(2):
            for b in range(g.nb[q]):
                tq[q, :, sh[q] + b] = tp[0][g.p[q] + 2 * b], tp[2][g.p[q] + 2 * b]
        shift = min(g.o)
    else:
        tq[0, :, :hlen] = tp[0], tp[2]
        shift = -conv.swt_inv_center(hlen) * f
    W = pl.lc + (nt - 1) * dc
    x = [t.double().numpy() for t in (lo, hi)]
    out = np.zeros((B, nph * M))
    for grp in range(pl.grid[1]):
        sig = np.minimum(32 * grp + np.arange(32), B - 1)
        for bx in range(pl.grid[0]):
            pos, pin = _axis(bx, M, pl.lc, pl.gc, f)
            wcols = (pos[0] + shift + pl.gc * np.arange(W)) % M
            w = [t[np.ix_(sig, wcols)] for t in x]
            t = np.arange(pl.lc)
            keep = 32 * grp + np.arange(32) < B
            for q in range(nph):
                o = sum(tq[q, band, j] * w[band][:, t + j * dc] for band in range(2)
                        for j in range(nt))
                out[np.ix_(sig[keep], nph * pos[pin] + q)] = o[np.ix_(keep, pin)]
    return out


def _wavelet(name):
    if name == "w128":
        return make_custom_wavelet(name, *np.random.default_rng(128).standard_normal((4, 128)))
    return get_wavelet(name)


@pytest.mark.parametrize("wname,B,M,f", [("sym8", 40, 70, None), ("db2", 3, 5, None),
                                         ("db7", 33, 129, None), ("sym8", 35, 300, 1),
                                         ("sym8", 2, 77, 4), ("db3", 3, 50, 16),
                                         ("db2", 2, 6, 8), ("w128", 3, 90, None),
                                         ("w128", 2, 150, 2)])
def test_model_of_kernel_16_tiling_matches_the_plain_version(wname, B, M, f):
    w = _wavelet(wname)
    g = np.random.default_rng(M)
    lo, hi = (torch.from_numpy(g.standard_normal((B, M)).astype(np.float32)) for _ in range(2))
    if f is None:
        want = M1.inv_level_1d_mxu_ref(lo, hi, w.rec_lo, w.rec_hi, "fd")
    else:
        want = M1.swt_inv_level_1d_mxu_ref(lo, hi, w.rec_lo, w.rec_hi, f.bit_length(), "fd")
    got = _model_inv1d(lo, hi, w.rec_lo, w.rec_hi, f or 1, f is None)
    np.testing.assert_allclose(got, want.double().numpy(), rtol=0, atol=2e-5)


def _conflicts(words):
    """Bank conflicts of one warp access: the most distinct 32-bit words
    the lanes touch in one bank, less one."""
    by_bank = {}
    for wd in words:
        by_bank.setdefault(wd % 32, set()).add(wd)
    return max(len(s) for s in by_bank.values()) - 1


@pytest.mark.parametrize("scheme", ["fd", "b3", "b1"])
@pytest.mark.parametrize("m,f", [(2048, None), (1024, None), (512, None), (256, None),
                                 (4096, 1), (4096, 2), (4096, 4), (4096, 8)])
def test_inv1d_lanes_hit_distinct_banks_at_the_cells_dilations(scheme, m, f):
    """A warp is 32 signals on one strip: every load of the strip reads
    element r * LP + t0 + (p + j) dc of lane r's line (LP an odd number of
    words), every tile write r * OP + u (OP odd); the staging writes
    consecutive elements of a line (a warp that straddles two lines may
    meet one 2-way conflict, once per line).  None of them conflicts."""
    from pdwt_tpu_torch.kernels._launch import stage_bytes, temp_pitch

    dec = f is None
    pl = M1.inv1d_launch_plan(1024, m, 16, f or 1, scheme, dec)
    nd, es = stage_bytes(scheme)
    dc, p = (f or 1) // pl.gc, L.ROW_STRIP[scheme]
    W = pl.lc + (pl.nt - 1) * dc
    LP, OP = temp_pitch(W, es), ((2 if dec else 1) * pl.lc) | 1
    lanes = np.arange(32)
    bases = [0, nd * 32 * LP] + ([32 * LP, nd * 32 * LP + 32 * LP] if nd > 1 else [])
    ch = M1.INV_CHUNK[dec]
    for sp in range(pl.lc // p):
        t0 = sp % dc + dc * (sp // dc) * p
        for c in range(0, pl.nt, ch):
            for i in range(p + ch - 1):
                for base in bases:  # both bands, both operands
                    el = base + lanes * LP + t0 + (c + i) * dc
                    assert _conflicts(el * es // 4) == 0, (sp, c, i)
        for q in range(p):
            assert _conflicts(lanes * OP + (2 if dec else 1) * (t0 + dc * q)) == 0
    for k in range(0, W - 31, 32):  # staging: a warp stores 32 consecutive elements of a line
        assert _conflicts((5 * LP + k + lanes) * es // 4) == 0
