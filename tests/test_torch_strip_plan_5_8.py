"""Launch plans and tilings of kernels 8 and 5, moved for Hopper's CUDA
cores onto the strip bodies that already computed their functions,
checked on the CPU:

* kernel 8, the exact polyphase 1D synthesis (``batched1d.inv_level_1d``),
  runs kernel 16's polyphase body in ``fd`` on float32 bands, on
  ``mxu1d.inv1d_launch_plan(..., "fd", True)``: the plan covers every
  output once and fits shared memory for 2 to 128 taps (odd too), bands of
  1, 7, odd and 2048 samples and batches of 1, 33 and 1024; the batched 1D
  cell's four synthesis levels get their block target; and kernel 16's
  polyphase tiling model (the parities' zero-padded tables on a common
  origin) equals kernel 8's plain version within 1e-5 of its largest
  output;
* kernel 5, the exact a-trous 2D analysis (``swt.swt_fwd_level_2d``), runs
  kernel 13's body at output step 1 in ``fd`` with float32 details, on
  ``swt_matmul.swt_fwd_launch_plan(..., "fd")``: the plan covers every
  output once and fits for 2 to 128 taps, 1 x 1, 8 x 8, odd and prime
  sizes, batches of 1 to 3 and dilations up to 2^12 past the image; the TI
  cell's three levels get their block target; and kernel 13's tiling model
  (rows first) equals kernel 5's plain version (columns first) within 1e-5
  of its largest output.
"""
import numpy as np
import pytest
import torch

from pdwt_tpu_torch.kernels import _launch as L
from pdwt_tpu_torch.kernels import batched1d as K1
from pdwt_tpu_torch.kernels import mxu1d as M1
from pdwt_tpu_torch.kernels import swt as S
from pdwt_tpu_torch.kernels import swt_matmul as SM
from test_torch_inv_launch_plan import _coverage
from test_torch_strip_plan_10_12 import _blocks, _wavelet
from test_torch_strip_plan_13_15 import _check_13, _model_swt_fwd
from test_torch_strip_plan_16_17 import _check_rules, _coverage_1d, _model_inv1d


# -- kernel 8: inv1d_launch_plan in fd, polyphase, on float32 bands ----------

PLAN_8 = [(1, 1), (1, 7), (33, 1), (33, 7), (1, 101), (33, 257), (1024, 64), (3, 2048)]


@pytest.mark.parametrize("B,M", PLAN_8)
@pytest.mark.parametrize("hlen", [2, 3, 16, 64, 127, 128])
def test_kernel_8_plan_covers_every_output_once(B, M, hlen):
    plan = M1.inv1d_launch_plan(B, M, hlen, 1, "fd", True)
    _check_rules(plan, "fd", 1)
    need, _ = M1.inv1d_taps(hlen, True)
    assert plan.gc == 1 and plan.nt >= need and plan.nt % M1.INV_CHUNK[True] == 0
    assert plan.nt <= L.MAX_HLEN + M1.INV_CHUNK[True]  # mxu1d.cu: launch_inv
    assert plan.smem == M1._inv1d_smem("fd", 2, plan.lc, 1, plan.nt)
    assert (_coverage_1d(plan, B, M, 1, True) == 1).all(), plan


@pytest.mark.parametrize("B,M", [(1024, 2048), (1024, 256), (33, 7), (1, 1), (70000, 32),
                                 (1, 1 << 21), (3, 1001)])
def test_kernel_8_plan_fits_for_every_filter_length(B, M):
    """2 to 128 taps, odd ones too (custom banks), on bands shorter than
    the support, a batch past gridDim.y and one long signal: no length,
    tap count or batch kernel 8 took before is refused."""
    for hlen in range(2, L.MAX_HLEN + 1):
        plan = M1.inv1d_launch_plan(B, M, hlen, 1, "fd", True)
        _check_rules(plan, "fd", 1)
        need, _ = M1.inv1d_taps(hlen, True)
        assert plan.nt >= need and plan.nt <= L.MAX_HLEN + M1.INV_CHUNK[True]
        assert plan.grid[1] == min(-(-B // 32), 65535) and plan.grid[2] == 1


@pytest.mark.parametrize("m", [2048, 1024, 512, 256])
def test_kernel_8_cell_levels_get_their_block_target(m):
    """The batched 1D cell's synthesis levels (sym8, 1024 signals, bands of
    2048 down to 256 samples): the block target of the level's output (256
    blocks), at most the shared memory that lets two blocks share an SM."""
    plan = M1.inv1d_launch_plan(1024, m, 16, 1, "fd", True)
    assert _blocks(plan) >= L.block_target(1, 1024, 2 * m) == 256
    assert plan.smem <= L.SMEM_TWO_BLOCKS and plan.gc == 1


@pytest.mark.parametrize("wname,B,M", [
    ("sym8", 33, 300), ("sym8", 2, 77), ("sym8", 1, 7), ("w3", 3, 50), ("w3", 33, 7),
    ("odd5", 2, 41), ("w64", 2, 150), ("w128", 3, 90), ("w128", 1, 7), ("db2", 33, 1),
    ("haar", 5, 1), ("db7", 40, 129)])
def test_model_of_kernel_8_tiling_matches_the_plain_version(wname, B, M):
    """Kernel 16's polyphase tiling in fd on float32 bands (its float64
    model) against kernel 8's plain version: 2, 3 and 5 taps (odd), 64 and
    128, bands of 1 and 7 samples, batches of 33 and 40."""
    w = _wavelet(wname)
    g = np.random.default_rng(M + B)
    lo, hi = (torch.from_numpy(g.standard_normal((B, M)).astype(np.float32)) for _ in range(2))
    want = K1.inv_level_1d_ref(lo, hi, w.rec_lo, w.rec_hi)
    got = _model_inv1d(lo, hi, w.rec_lo, w.rec_hi, 1, True)
    assert got.shape == tuple(want.shape)
    assert np.abs(got - want.double().numpy()).max() <= 1e-5 * float(want.abs().max())


# -- kernel 5: swt_fwd_launch_plan in fd, on a float32 image -----------------

COVER_5 = [(1, (1, 1)), (3, (1, 1)), (1, (8, 8)), (2, (8, 8)), (1, (37, 53)), (3, (31, 17)),
           (1, (101, 77)), (2, (1, 29))]


@pytest.mark.parametrize("B,shape", COVER_5)
@pytest.mark.parametrize("f", [1, 2, 16, 256, 4096])
@pytest.mark.parametrize("hlen", [2, 3, 14, 40, 128])
def test_kernel_5_plan_covers_every_output_once(B, shape, f, hlen):
    R, C = shape
    plan = SM.swt_fwd_launch_plan(B, R, C, hlen, f, "fd")
    _check_13(plan, "fd", f)
    assert plan.nt >= hlen and plan.nt <= L.MAX_HLEN  # swt_matmul.cu: launch_fwd
    assert plan.smem == L.fwd_smem("fd", plan.lr, plan.lc, f // plan.gc, plan.nt, plan.nph)
    assert (_coverage(plan, R, C, f, 1, B) == 1).all(), plan


@pytest.mark.parametrize("shape,f", [((1, 1024, 1024), 1), ((1, 1024, 1024), 4),
                                     ((1, 1024, 1024), 32), ((3, 37, 53), 16),
                                     ((1, 8, 8), 32), ((2, 1, 1), 4096), ((1, 301, 203), 16),
                                     ((1, 7, 13), 4096)])
def test_kernel_5_plan_fits_for_every_filter_length(shape, f):
    """2 to 128 taps, odd ones too, with supports far wider than the image
    at the large dilations (level 6 on 1024^2, level 13 on 7 x 13): no
    size, tap count or dilation kernel 5 took before is refused."""
    for hlen in range(2, L.MAX_HLEN + 1):
        plan = SM.swt_fwd_launch_plan(*shape, hlen, f, "fd")
        _check_13(plan, "fd", f)
        assert plan.nt >= hlen and plan.nt <= L.MAX_HLEN
        assert plan.grid[2] == min(shape[0], 65535) and plan.grid[1] <= 65535


@pytest.mark.parametrize("level", [1, 2, 3])
def test_kernel_5_ti_cell_levels_get_their_block_target(level):
    """The exact TI cell (db7, 1024^2, levels 1-3) on kernel 5: 256 blocks,
    consecutive columns, two blocks an SM."""
    plan = SM.swt_fwd_launch_plan(1, 1024, 1024, 14, L.dilation(level), "fd")
    assert _blocks(plan) >= L.block_target(1, 1024, 1024) == 256
    assert plan.smem <= L.SMEM_TWO_BLOCKS and plan.gc == 1


@pytest.mark.parametrize("wname,shape,level", [
    ("haar", (1, 1, 1), 1), ("db7", (1, 8, 8), 6), ("db7", (2, 37, 53), 1),
    ("db7", (1, 31, 17), 3), ("w3", (3, 17, 29), 2), ("odd5", (1, 23, 29), 4),
    ("db2", (1, 7, 13), 13), ("w40", (1, 50, 44), 2), ("w128", (1, 9, 11), 1)])
def test_model_of_kernel_13_tiling_matches_kernel_5_plain_version(wname, shape, level):
    """Kernel 13's tiling in fd (its float64 model, rows first) against
    kernel 5's plain version (columns first): 1 x 1, 8 x 8, odd and prime
    sizes, 2, 3, 5, 40 and 128 taps, dilations past the image, a batch of
    3."""
    w = _wavelet(wname)
    x = torch.from_numpy(np.random.default_rng(sum(shape) + level).uniform(0, 255, shape)
                         .astype(np.float32))
    want = S.swt_fwd_level_2d_ref(x, w.dec_lo, w.dec_hi, level)
    got = _model_swt_fwd(x, w.dec_lo, w.dec_hi, level)
    scale = max(float(t.abs().max()) for t in want)
    for s in range(4):
        assert np.abs(got[s] - want[s].double().numpy()).max() <= 1e-5 * scale
