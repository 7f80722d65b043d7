"""Launch plans of kernels 13 and 15, redesigned for Hopper's CUDA cores on
``csrc/band_strip.cuh``, checked on the CPU:

* kernel 13, the 2D a-trous analysis (``swt_matmul.swt_fwd_launch_plan``),
  and kernel 15, the batched 1D analysis (``mxu1d.fwd1d_launch_plan``,
  decimated and a-trous): every output falls in exactly one tile of one
  block, across shapes no tile divides, odd and prime sizes, dilations
  1-16 and one past the image or signal, batches 1 and 3, 2-40 taps, in
  every scheme;
* every plan fits the H100's shared memory and keeps the strips'
  divisibility, for every tap count the kernels take;
* the cells' levels get at least 128 blocks;
* a dilation of thousands takes one residue class;
* float64 numpy models of both tilings (index tables, residue classes,
  strips of outputs OS samples or dc window entries apart, zero-padded
  taps) reproduce the plain versions;
* for 15, a model of the words the lanes of a warp read and write in
  shared memory shows no bank conflict at the cells' dilations and at
  stride 2.
"""
import numpy as np
import pytest
import torch

from pdwt_tpu_torch import get_wavelet
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.filters import make_custom_wavelet
from pdwt_tpu_torch.kernels import _launch as L
from pdwt_tpu_torch.kernels import mxu1d as M1
from pdwt_tpu_torch.kernels import swt_matmul as SM
from pdwt_tpu_torch.kernels.matmul import SCHEMES, kernel_taps
from test_torch_inv_launch_plan import _axis, _coverage
from test_torch_strip_plan_16_17 import _blocks, _conflicts, _coverage_1d


def _check_13(plan, scheme, f):
    """Kernel 13's entry point's rules: row strips, column strips dc apart,
    the card's limits."""
    dc = f // plan.gc
    assert plan.gc in (1, f)
    assert plan.lr % L.ROW_STRIP[scheme] == 0 and plan.lc % (L.COL_STRIP * dc) == 0
    assert plan.threads == 256 and plan.nph in (1, 2) and plan.nt % L.FWD_CHUNK == 0
    assert plan.smem <= L.SMEM_LIMIT


def _check_15(plan, scheme, f):
    dc = f // plan.gc
    assert plan.gc in (1, f) and plan.lr == M1.INV_ROWS
    assert plan.lc % (L.ROW_STRIP[scheme] * dc) == 0
    assert plan.threads == 256 and plan.nph == 1 and plan.nt % M1.FWD_CHUNK == 0
    assert plan.smem <= L.SMEM_LIMIT


# -- kernel 13: swt_fwd_launch_plan -----------------------------------------

COVER_13 = [(1, 1, (1, 1)), (1, 3, (37, 53)), (1, 1, (101, 77)), (2, 1, (17, 29)),
            (2, 3, (70, 134)), (4, 1, (45, 61)), (4, 3, (301, 203)), (8, 1, (97, 131)),
            (16, 1, (101, 77)), (16, 3, (33, 47)), (64, 1, (37, 53)), (2, 1, (129, 200))]


@pytest.mark.parametrize("f,B,shape", COVER_13)
@pytest.mark.parametrize("hlen", [2, 14, 40])
def test_swt_fwd_plan_covers_every_output_once(f, B, shape, hlen):
    R, C = shape
    for scheme in SCHEMES:
        plan = SM.swt_fwd_launch_plan(B, R, C, hlen, f, scheme)
        _check_13(plan, scheme, f)
        assert (_coverage(plan, R, C, f, 1, B) == 1).all(), plan


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("shape,f", [((1, 1024, 1024), 1), ((1, 1024, 1024), 4),
                                     ((3, 37, 53), 16), ((1, 128, 128), 2),
                                     ((2, 70, 134), 2048)])
def test_swt_fwd_plan_fits_shared_memory_for_every_tap_count(scheme, shape, f):
    for hlen in range(2, L.MAX_HLEN + 1):
        plan = SM.swt_fwd_launch_plan(*shape, hlen, f, scheme)
        _check_13(plan, scheme, f)
        assert plan.nt >= hlen
        assert plan.smem == L.fwd_smem(scheme, plan.lr, plan.lc, f // plan.gc, plan.nt,
                                         plan.nph)


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("scheme", ["b1", "fd", "b2f"])
def test_ti_tier_cell_levels_fill_the_card(f, scheme):
    """db7 on the TI tier cell's 1024^2 image, levels 1-3: about two
    blocks per SM, consecutive columns (coalesced loads and stores)."""
    plan = SM.swt_fwd_launch_plan(1, 1024, 1024, 14, f, scheme)
    assert _blocks(plan) >= L.block_target(1, 1024, 1024) == 256
    assert plan.smem <= L.SMEM_TWO_BLOCKS and plan.gc == 1


@pytest.mark.parametrize("n,f", [(256, 1), (256, 4), (128, 2), (64, 1), (37, 8)])
def test_swt_fwd_small_images_reach_the_block_target(n, f):
    """Smaller tiles on small images: the plan's blocks reach
    ``block_target`` (about one per two 16 x 16 tiles of outputs)."""
    plan = SM.swt_fwd_launch_plan(1, n, n, 14, f, "b3")
    assert _blocks(plan) >= L.block_target(1, n, n) and plan.smem <= L.SMEM_TWO_BLOCKS


def test_swt_fwd_a_dilation_of_thousands_takes_one_residue_class():
    plan = SM.swt_fwd_launch_plan(1, 3000, 2500, 14, 2048, "b3")
    assert plan.gc == 2048 and plan.lc + plan.nt - 1 < 200


def _model_swt_fwd(x, lo, hi, level, scheme="fd"):
    """Kernel 13's tiling in float64: per block, the window tables (rows of
    one residue class, columns consecutive or of one class), the row pass
    over window rows into the low and high temps, then the column pass over
    temp columns dc apart; tile u + 2k of temp u and filter k."""
    B, R, C = x.shape
    tp = kernel_taps((lo, hi), scheme)
    hlen, f = len(tp[0]), 1 << (level - 1)
    pl = SM.swt_fwd_launch_plan(B, R, C, hlen, f, scheme)
    nt, dc = pl.nt, f // pl.gc
    t = np.zeros((2, nt))
    t[0, :hlen], t[1, :hlen] = tp[0], tp[2]
    cen = conv.fwd_center(hlen)
    WR, WC = pl.lr + nt - 1, pl.lc + (nt - 1) * dc
    xs = x.double().numpy()
    out = np.zeros((4, B, R, C))
    r, tt = np.arange(pl.lr), np.arange(pl.lc)
    for by in range(pl.grid[1]):
        rows, rin = _axis(by, R, pl.lr, f, f)
        wrows = (rows[0] - cen * f + f * np.arange(WR)) % R
        for bx in range(pl.grid[0]):
            cols, cin = _axis(bx, C, pl.lc, pl.gc, f)
            wcols = (cols[0] - cen * f + pl.gc * np.arange(WC)) % C
            for b in range(B):
                w = xs[b][np.ix_(wrows, wcols)]
                tmp = [sum(t[k, j] * w[r + j] for j in range(nt)) for k in range(2)]
                for u in range(2):
                    for k in range(2):
                        o = sum(t[k, j] * tmp[u][:, tt + j * dc] for j in range(nt))
                        out[u + 2 * k, b][np.ix_(rows[rin], cols[cin])] = o[np.ix_(rin, cin)]
    return out


@pytest.mark.parametrize("wname,shape,level", [
    ("db7", (1, 37, 53), 1), ("db7", (2, 40, 70), 2), ("db7", (1, 45, 61), 3),
    ("db2", (3, 17, 29), 4), ("haar", (1, 33, 29), 5), ("db7", (1, 21, 19), 7),
    ("w40", (1, 50, 44), 1)])
def test_model_of_kernel_13_tiling_matches_the_plain_version(wname, shape, level):
    w = _wavelet(wname)
    x = torch.from_numpy(np.random.default_rng(sum(shape)).uniform(-1, 1, shape)
                         .astype(np.float32))
    want = SM.swt_fwd_level_2d_mxu_ref(x, w.dec_lo, w.dec_hi, level, "fd")
    got = _model_swt_fwd(x, w.dec_lo, w.dec_hi, level)
    scale = max(1.0, max(float(t.abs().max()) for t in want))  # w40's outputs reach about 50
    for s in range(4):
        np.testing.assert_allclose(got[s], want[s].double().numpy(), rtol=0, atol=2e-5 * scale)


# -- kernel 15: fwd1d_launch_plan -------------------------------------------

COVER_15 = [(1, 2), (1, 6), (3, 14), (1, 66), (3, 202), (40, 514), (1, 2000), (70, 130)]


@pytest.mark.parametrize("B,N", COVER_15)
@pytest.mark.parametrize("f", [None, 1, 2, 4, 8, 16, 2048])
@pytest.mark.parametrize("hlen", [2, 16, 40])
def test_fwd1d_plan_covers_every_output_once(B, N, f, hlen):
    dec = f is None
    for n in ((N,) if dec else (N, N + 1)):  # the a-trous analysis takes odd lengths
        n_out = n // 2 if dec else n
        for scheme in SCHEMES:
            plan = M1.fwd1d_launch_plan(B, n, hlen, f or 1, scheme, dec)
            _check_15(plan, scheme, f or 1)
            assert not dec or plan.gc == 1
            assert (_coverage_1d(plan, B, n_out, f or 1, False) == 1).all(), plan


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("B,N,f", [(1024, 4096, None), (1024, 512, None), (1024, 4096, 8),
                                   (3, 101, 16), (2, 5000, 2048), (1, 6, 4)])
def test_fwd1d_plan_fits_shared_memory_for_every_tap_count(scheme, B, N, f):
    dec = f is None
    for hlen in range(2, L.MAX_HLEN + 1):
        plan = M1.fwd1d_launch_plan(B, N, hlen, f or 1, scheme, dec)
        _check_15(plan, scheme, f or 1)
        assert plan.nt >= hlen
        assert plan.smem == M1._fwd1d_smem(scheme, 2 if dec else 1, plan.lc,
                                           (f or 1) // plan.gc, plan.nt)


@pytest.mark.parametrize("n,scheme", [(4096, "b1"), (2048, "b3"), (1024, "b3"), (512, "b3"),
                                      (4096, "b2f"), (2048, "fd")])
def test_decimated_cell_levels_get_128_blocks(n, scheme):
    """The 1D DWT cell's analysis levels: sym8, 1024 signals of 4096 down
    to 512 samples in."""
    plan = M1.fwd1d_launch_plan(1024, n, 16, 1, scheme, True)
    assert _blocks(plan) >= 128 and plan.smem <= L.SMEM_TWO_BLOCKS


@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("scheme", ["b1", "fd", "b2f"])
def test_atrous_cell_levels_fill_the_card(f, scheme):
    plan = M1.fwd1d_launch_plan(1024, 4096, 16, f, scheme, False)
    assert _blocks(plan) >= 2 * L.SMS and plan.smem <= L.SMEM_TWO_BLOCKS
    assert plan.gc == 1  # consecutive positions: coalesced loads and stores


def test_fwd1d_a_dilation_of_thousands_takes_one_residue_class():
    """sym8 at level 12 on 5000 samples: the window does not grow with f."""
    plan = M1.fwd1d_launch_plan(2, 5000, 16, 2048, "b3", False)
    assert plan.gc == 2048 and plan.lc + plan.nt - 1 < 300


def _model_fwd1d(x, lo, hi, f, decimated, scheme="fd"):
    """Kernel 15's tiling in float64: per block, the window table (its
    origin at OS (rho + gc q0) - cen), the windows of 32 signal rows (the
    last signal repeated past B), strips of outputs reading samples OS apart
    and taps dc window entries apart, both filters."""
    B, N = x.shape
    tp = kernel_taps((lo, hi), scheme)
    hlen = len(tp[0])
    pl = M1.fwd1d_launch_plan(B, N, hlen, f, scheme, decimated)
    nt, dc, os_ = pl.nt, f // pl.gc, 2 if decimated else 1
    t = np.zeros((2, nt))
    t[0, :hlen], t[1, :hlen] = tp[0], tp[2]
    cen = conv.fwd_center(hlen) * f
    n_out, W = N // os_, os_ * (pl.lc - 1) + (nt - 1) * dc + 1
    xs = x.double().numpy()
    out = np.zeros((2, B, n_out))
    tt = np.arange(pl.lc)
    for grp in range(pl.grid[1]):
        sig = np.minimum(32 * grp + np.arange(32), B - 1)
        keep = 32 * grp + np.arange(32) < B
        for bx in range(pl.grid[0]):
            pos, pin = _axis(bx, n_out, pl.lc, pl.gc, f)
            w = xs[np.ix_(sig, (os_ * pos[0] - cen + pl.gc * np.arange(W)) % N)]
            for k in range(2):
                o = sum(t[k, j] * w[:, os_ * tt + j * dc] for j in range(nt))
                out[k][np.ix_(sig[keep], pos[pin])] = o[np.ix_(keep, pin)]
    return out


def _wavelet(name):
    if name.startswith("w"):
        n = int(name[1:])
        return make_custom_wavelet(name, *np.random.default_rng(n).standard_normal((4, n)))
    return get_wavelet(name)


@pytest.mark.parametrize("wname,B,N,f", [("sym8", 40, 140, None), ("db2", 3, 6, None),
                                         ("db7", 33, 258, None), ("sym8", 35, 300, 1),
                                         ("sym8", 2, 77, 4), ("db3", 3, 50, 16),
                                         ("db2", 2, 6, 8), ("w40", 3, 90, None),
                                         ("w40", 2, 151, 2)])
def test_model_of_kernel_15_tiling_matches_the_plain_version(wname, B, N, f):
    w = _wavelet(wname)
    x = torch.from_numpy(np.random.default_rng(N).standard_normal((B, N)).astype(np.float32))
    if f is None:
        want = M1.fwd_level_1d_mxu_ref(x, w.dec_lo, w.dec_hi, "fd")
    else:
        want = M1.swt_fwd_level_1d_mxu_ref(x, w.dec_lo, w.dec_hi, f.bit_length(), "fd")
    got = _model_fwd1d(x, w.dec_lo, w.dec_hi, f or 1, f is None)
    for k in range(2):
        np.testing.assert_allclose(got[k], want[k].double().numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("scheme", ["fd", "b3", "b1"])
@pytest.mark.parametrize("n,f", [(4096, None), (2048, None), (1024, None), (512, None),
                                 (4096, 1), (4096, 2), (4096, 4), (4096, 8)])
def test_fwd1d_lanes_hit_distinct_banks_at_the_cells_dilations(scheme, n, f):
    """A warp is 32 signals on one strip: every load of the strip reads
    element r * LP + OS t0 + (c + i) dc of lane r's line (LP an odd number
    of words; OS = 2 decimated), every tile write r * OP + t0 + dc q (OP
    odd); the staging writes consecutive elements of a line.  None of them
    conflicts."""
    dec = f is None
    pl = M1.fwd1d_launch_plan(1024, n, 16, f or 1, scheme, dec)
    nd, es = L.stage_bytes(scheme)
    dc, p, os_ = (f or 1) // pl.gc, L.ROW_STRIP[scheme], 2 if dec else 1
    W = os_ * (pl.lc - 1) + (pl.nt - 1) * dc + 1
    LP, OP = L.temp_pitch(W, es), pl.lc | 1
    lanes = np.arange(32)
    bases = [0] + ([32 * LP] if nd > 1 else [])
    ch = M1.FWD_CHUNK
    for sp in range(pl.lc // p):
        t0 = sp % dc + dc * (sp // dc) * p
        for c in range(0, pl.nt, ch):
            for i in range(os_ * (p - 1) + ch):
                for base in bases:
                    el = base + lanes * LP + os_ * t0 + (c + i) * dc
                    assert _conflicts(el * es // 4) == 0, (sp, c, i)
        for k in range(2):
            for q in range(p):
                assert _conflicts((k * 32 + lanes) * OP + t0 + dc * q) == 0
    for k in range(0, W - 31, 32):
        assert _conflicts((5 * LP + k + lanes) * es // 4) == 0
