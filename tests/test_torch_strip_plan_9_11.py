"""Launch plans and tilings of kernels 11 and 9, redesigned for Hopper's
CUDA cores on the strip bodies that already computed their functions,
checked on the CPU:

* kernel 11, the decimated 2D analysis of the precision tiers
  (``matmul.fwd_level_2d_mxu``), runs kernel 13's body at output step 2 on
  ``matmul.fwd_launch_plan``: in every scheme every output falls in
  exactly one tile of one block, on shapes the route rule takes and on
  shapes it does not (odd subband sizes, 1 x 1 subbands, batches of 1 to 3,
  2 to 128 taps); the plan fits the H100's shared memory for every filter
  of up to 128 taps (byte for byte the C ``fwd_smem<S>`` at step 2); the
  main path's levels (1024^2 to 128^2 subbands) get their block target; and
  a float32 numpy model of the tiling (window tables at step 2, the row
  pass into the low and high temps, the temps split per scheme, the column
  pass at step 2, one rounding as the tiles are stored; taps from
  ``kernel_taps``) equals ``fwd_level_2d_mxu_ref`` bit for bit in b1, b2f,
  b2d and b3, and within ``tier_limit`` in fd;
* kernel 9, the exact a-trous 1D analysis (``batched1d.swt_fwd_level_1d``),
  runs kernel 15's a-trous body in ``fd`` on a float32 input and high band,
  on ``mxu1d.fwd1d_launch_plan(..., "fd", False)``: the plan covers every
  output once and fits for 2 to 128 taps, N = 1, odd N and 4096, dilations
  up to 2^12 past the signal, and batches of 1, 33 and 1024, and kernel
  15's tiling model equals kernel 9's plain version within 1e-5 of its
  largest output.
"""
import numpy as np
import pytest
import torch

from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.kernels import _launch as L
from pdwt_tpu_torch.kernels import batched1d as K1
from pdwt_tpu_torch.kernels import matmul as M
from pdwt_tpu_torch.kernels import mxu1d as M1
from test_torch_inv_launch_plan import _coverage
from test_torch_strip_plan_10_12 import _blocks, _split, _strip_sums, _wavelet
from test_torch_strip_plan_13_15 import _check_13, _check_15, _model_fwd1d
from test_torch_strip_plan_16_17 import _coverage_1d

F32, BF16 = torch.float32, torch.bfloat16


# -- kernel 11: fwd_launch_plan in every scheme -----------------------------------

# (B, R, C) images: on the route rule (64 x 256, 256 x 256), odd subband
# sizes (37 x 53, 35 x 67, 101 x 77), 1 x 1 subbands, batches of 2 and 3
COVER_11 = [(1, 2, 2), (3, 2, 2), (1, 64, 256), (2, 256, 256), (1, 74, 106), (3, 70, 134),
            (1, 202, 154), (2, 8, 30)]


@pytest.mark.parametrize("scheme", M.SCHEMES)
@pytest.mark.parametrize("B,R,C", COVER_11)
@pytest.mark.parametrize("hlen", [2, 14, 40, 128])
def test_fwd_plan_covers_every_subband_output_once(scheme, B, R, C, hlen):
    plan = M.fwd_launch_plan(B, R, C, hlen, scheme)
    _check_13(plan, scheme, 1)
    assert plan.gc == 1 and plan.nt >= hlen
    assert (_coverage(plan, R // 2, C // 2, 1, 1, B) == 1).all(), plan


def _c_fwd_smem(scheme, os_, lr, lc, dc, nt, nph):
    """swt_matmul.cu: fwd_smem<S>, term by term as the C source writes it:
    taps (16 nt), the index tables, the window or the 4 / nph tiles, the
    two temps of nd operands at temp_pitch<St>(WC)."""
    st = 4 if scheme == "fd" else 2                      # sizeof(Stage<S>)
    nd = 2 if scheme in ("b2d", "b3") else 1             # kDataLo<S>
    WR, WC = os_ * (lr - 1) + nt, os_ * (lc - 1) + (nt - 1) * dc + 1
    win, tile = nd * WR * WC * st, (4 // nph) * lr * (lc + 1) * 4
    tp = (WC | 1) if st == 4 else ((WC + 1) // 4) * 4 + 2
    a16 = lambda b: (b + 15) & ~15
    return 16 * nt + a16((WR + WC) * 4) + a16(max(win, tile)) + 2 * nd * lr * tp * st


@pytest.mark.parametrize("scheme", M.SCHEMES)
@pytest.mark.parametrize("shape", [(1, 2048, 2048), (1, 256, 256), (3, 74, 106), (1, 2, 2),
                                   (70000, 8, 8)])
def test_fwd_plan_fits_shared_memory_for_every_tap_count(scheme, shape):
    """2 to 128 taps, the entry point's range (the route rule stops at 40):
    no filter length kernel 11 took before is refused."""
    for hlen in range(2, L.MAX_HLEN + 1):
        plan = M.fwd_launch_plan(*shape, hlen, scheme)
        _check_13(plan, scheme, 1)
        assert plan.nt >= hlen and plan.gc == 1
        assert plan.smem == _c_fwd_smem(scheme, 2, plan.lr, plan.lc, 1, plan.nt, plan.nph)
        assert plan.smem == L.fwd_smem(scheme, plan.lr, plan.lc, 1, plan.nt, plan.nph, 2)
        assert plan.grid[2] == min(shape[0], 65535)


@pytest.mark.parametrize("scheme", M.SCHEMES)
def test_atrous_smem_is_the_step_1_formula(scheme):
    """Kernel 13's shared memory at step 1 is what it was before the step
    became a template argument (WR = lr + nt - 1, WC = lc + (nt - 1) dc)."""
    for lr, lc, dc, nt, nph in [(32, 128, 1, 16, 1), (16, 32, 4, 16, 2), (8, 16, 2, 40, 1),
                                (32, 64, 1, 128, 2)]:
        wr, wc = lr + nt - 1, lc + (nt - 1) * dc
        assert (L.fwd_smem(scheme, lr, lc, dc, nt, nph)
                == _c_fwd_smem(scheme, 1, lr, lc, dc, nt, nph))
        assert wr == 1 * (lr - 1) + nt and wc == 1 * (lc - 1) + (nt - 1) * dc + 1


@pytest.mark.parametrize("scheme", M.SCHEMES)
@pytest.mark.parametrize("m", [1024, 512, 256, 128])
def test_main_path_levels_get_their_block_target(scheme, m):
    """The tier DWT roundtrip's analysis levels (db7, 2048^2 images down to
    256^2, subbands 1024^2 to 128^2): the block target of the level's four
    subbands together (128 at 128^2, 256 above), at most the shared memory
    that lets two blocks share an SM."""
    plan = M.fwd_launch_plan(1, 2 * m, 2 * m, 14, scheme)
    assert _blocks(plan) >= L.block_target(1, 2 * m, 2 * m)
    assert _blocks(plan) >= (128 if m == 128 else 256)
    assert plan.smem <= L.SMEM_TWO_BLOCKS


def _model_fwd_level(x, lo, hi, scheme, out_dtypes):
    """swt_fwd_mxu_kernel<S, 2> in float32: per block, the window tables
    (input rows and columns 2 q0 - cen + i, wrapped), the window split per
    scheme, the row pass (output row r from window rows 2 r + j) into the
    low and the high temp, the temps split per scheme, the column pass
    (output column t from temp columns 2 t + j) of both filters on each
    temp, and one rounding of each tile to its output's dtype.  Products of
    bf16 values are exact in float32, so numpy's multiply-then-add is the
    kernel's FMA in the b-schemes."""
    B, R, C = x.shape
    tp = M.kernel_taps((lo, hi), scheme)
    hlen = len(tp[0])
    pl = M.fwd_launch_plan(B, R, C, hlen, scheme)
    nt, lr, lc = pl.nt, pl.lr, pl.lc
    t1, t2 = np.zeros((2, nt), dtype=np.float32), np.zeros((2, nt), dtype=np.float32)
    t1[0, :hlen], t2[0, :hlen], t1[1, :hlen], t2[1, :hlen] = tp
    cen = conv.fwd_center(hlen)
    ro, co = R // 2, C // 2
    WR, WC = 2 * (lr - 1) + nt, 2 * (lc - 1) + nt
    xs = x.float().numpy()
    outs = [torch.zeros((B, ro, co), dtype=dt) for dt in (out_dtypes[0], *[out_dtypes[1]] * 3)]
    for by in range(pl.grid[1]):
        orows = by * lr + np.arange(lr)
        wrows = (2 * by * lr - cen + np.arange(WR)) % R
        for bx in range(pl.grid[0]):
            ocols = bx * lc + np.arange(lc)
            wcols = (2 * bx * lc - cen + np.arange(WC)) % C
            rin, cin = orows < ro, ocols < co
            for b in range(B):
                win = _split(xs[b][np.ix_(wrows, wcols)], scheme)
                tmp = [_split(_strip_sums(t1[k:k + 1], t2[k:k + 1], [win],
                                          lambda a, j: a[j:j + 2 * lr:2], (lr, WC), scheme),
                              scheme) for k in (0, 1)]
                for u in (0, 1):
                    for k in (0, 1):
                        tile = _strip_sums(t1[k:k + 1], t2[k:k + 1], [tmp[u]],
                                           lambda a, j: a[:, j:j + 2 * lc:2], (lr, lc), scheme)
                        o = outs[u + 2 * k]
                        keep = torch.from_numpy(tile[np.ix_(rin, cin)]).to(o.dtype)
                        o[b][np.ix_(orows[rin], ocols[cin])] = keep
    return outs


@pytest.mark.parametrize("scheme", M.SCHEMES)
@pytest.mark.parametrize("wname,shape,in_dt,det", [
    ("db7", (1, 80, 140), BF16, BF16), ("db7", (2, 74, 106), F32, F32),
    ("db2", (3, 18, 26), BF16, F32), ("odd5", (1, 70, 134), F32, BF16),
    ("w40", (1, 140, 76), BF16, F32), ("haar", (1, 2, 2), F32, F32),
    ("w128", (1, 20, 34), F32, BF16)])
def test_model_of_kernel_11_tiling_matches_the_plain_version(scheme, wname, shape, in_dt, det):
    """b-schemes bit for bit; fd within tier_limit (the kernel's FMAs round
    once where the plain version rounds twice)."""
    w = _wavelet(wname)
    x = torch.from_numpy(np.random.default_rng(sum(shape) + len(wname))
                         .uniform(0, 255, shape).astype(np.float32)).to(in_dt)
    want = M.fwd_level_2d_mxu_ref(x, w.dec_lo, w.dec_hi, scheme, (F32, det))
    got = _model_fwd_level(x, w.dec_lo, w.dec_hi, scheme, (F32, det))
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype and g.shape == wt.shape
        if scheme == "fd":
            limit = (2.0 ** -7 if wt.dtype == BF16 else 1e-5) * float(wt.float().abs().max())
            assert float((g.float() - wt.float()).abs().max()) <= limit
        else:
            assert torch.equal(g, wt)


# -- kernel 9: fwd1d_launch_plan in fd, a-trous, on a float32 input ---------------

PLAN_9 = [(1, 1), (1, 7), (33, 1), (33, 7), (1, 100), (33, 257), (1024, 64), (3, 4096)]


def _c_fwd1d_smem(os_, lc, dc, nt):
    """mxu1d.cu: fwd1d_smem<FD>: taps, the index table, 32 signals' lines of
    float32 at temp_pitch<float>(W), the two float tiles."""
    W = os_ * (lc - 1) + (nt - 1) * dc + 1
    a16 = lambda b: (b + 15) & ~15
    return 16 * nt + a16(4 * W) + a16(32 * (W | 1) * 4) + 2 * 32 * (lc | 1) * 4


@pytest.mark.parametrize("B,N", PLAN_9)
@pytest.mark.parametrize("f", [1, 2, 16, 256, 4096])
@pytest.mark.parametrize("hlen", [2, 3, 16, 64, 127, 128])
def test_kernel_9_plan_covers_every_output_once(B, N, f, hlen):
    plan = M1.fwd1d_launch_plan(B, N, hlen, f, "fd", False)
    _check_15(plan, "fd", f)
    assert plan.nt >= hlen and plan.nt <= L.MAX_HLEN  # mxu1d.cu: launch_fwd
    assert plan.smem == _c_fwd1d_smem(1, plan.lc, f // plan.gc, plan.nt)
    assert (_coverage_1d(plan, B, N, f, False) == 1).all(), plan


@pytest.mark.parametrize("B,N,f", [(1024, 4096, 1), (1024, 4096, 8), (33, 7, 4096), (1, 1, 4096),
                                   (1, 5000, 2048), (33, 100, 64), (70000, 64, 8)])
def test_kernel_9_plan_fits_for_every_filter_length(B, N, f):
    """2 to 128 taps, odd ones too (custom banks), with supports far wider
    than the signal at the large dilations: no length, tap count or
    dilation kernel 9 took before is refused."""
    for hlen in range(2, L.MAX_HLEN + 1):
        plan = M1.fwd1d_launch_plan(B, N, hlen, f, "fd", False)
        _check_15(plan, "fd", f)
        assert plan.nt >= hlen and plan.nt <= L.MAX_HLEN
        assert plan.grid[1] == min(-(-B // 32), 65535)


@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_kernel_9_cell_levels_fill_the_card(level):
    """The 1D SWT cell (sym8, 1024 x 4096, levels 1-4) on kernel 9:
    consecutive positions and about two blocks per SM, as kernel 15's."""
    plan = M1.fwd1d_launch_plan(1024, 4096, 16, L.dilation(level), "fd", False)
    assert plan.gc == 1 and _blocks(plan) >= 2 * L.SMS and plan.smem <= L.SMEM_TWO_BLOCKS


@pytest.mark.parametrize("wname,B,N,level", [
    ("sym8", 33, 300, 1), ("sym8", 2, 77, 3), ("odd3", 3, 50, 2), ("odd3", 33, 7, 5),
    ("w64", 2, 150, 2), ("w128", 3, 90, 1), ("w128", 1, 7, 13), ("db2", 1, 1, 4),
    ("sym8", 33, 1, 2), ("db7", 5, 7, 6)])
def test_model_of_kernel_9_tiling_matches_the_plain_version(wname, B, N, level):
    """Kernel 15's a-trous tiling in fd (its float64 model) against kernel
    9's plain version: hlen 3 (odd), 64 and 128, dilations past the signal,
    N = 1 and 7, a batch of 33."""
    w = _wavelet("w3" if wname == "odd3" else wname)
    x = torch.from_numpy(np.random.default_rng(N + level).standard_normal((B, N))
                         .astype(np.float32))
    want = K1.swt_fwd_level_1d_ref(x, w.dec_lo, w.dec_hi, level)
    got = _model_fwd1d(x, w.dec_lo, w.dec_hi, L.dilation(level), False)
    scale = max(float(t.abs().max()) for t in want)
    for k in range(2):
        assert np.abs(got[k] - want[k].double().numpy()).max() <= 1e-5 * scale
