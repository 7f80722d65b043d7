"""Launch plans of the two exact-path inverses redesigned for Hopper's CUDA
cores, checked on the CPU:

* kernel 2, the polyphase synthesis level (``separable.inv_level_2d``):
  ``separable.inv_level_launch_plan`` covers every output exactly once,
  fits shared memory for every filter length the kernel takes, gives the
  main path's deep levels about two blocks per SM, and a float64 numpy
  model of its tiling (window tables, per-parity zero-padded taps, strips)
  reproduces the plain version;
* kernel 6, the a-trous synthesis with the fused threshold
  (``swt.swt_inv_level_2d``), which runs kernel 14's body in ``fd`` on
  float32 subbands: its plan covers every output and fits at the shapes and
  levels ``chip_smoke.py`` drives, dilations past the image included, and
  kernel 14's tiling model on thresholded float32 subbands reproduces
  kernel 6's plain version.
"""
import numpy as np
import pytest
import torch

from pdwt_tpu_torch import get_wavelet
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.filters import make_custom_wavelet
from pdwt_tpu_torch.kernels import _launch as L
from pdwt_tpu_torch.kernels import separable as K
from pdwt_tpu_torch.kernels import swt as S
from pdwt_tpu_torch.kernels import swt_matmul as SM
from pdwt_tpu_torch.ops.threshold import THR_ELEM
from test_torch_inv_launch_plan import _check_shape_rules, _coverage, _model_swt_inv


def _wavelet(name):
    if name == "odd5":  # an odd-length custom bank, as tests/test_torch_cuda.py makes it
        return make_custom_wavelet("odd5", *np.random.default_rng(5).standard_normal((4, 5)))
    return get_wavelet(name)


def _blocks(plan):
    return plan.grid[0] * plan.grid[1] * plan.grid[2]


# -- kernel 2: inv_level_launch_plan -----------------------------------------

@pytest.mark.parametrize("B,Mr,Mc", [(1, 1, 1), (1, 8, 8), (3, 8, 8), (2, 37, 53), (1, 40, 70),
                                     (1, 64, 64), (3, 35, 67), (1, 128, 128), (2, 100, 9)])
@pytest.mark.parametrize("hlen", [2, 5, 14, 40, 128])
def test_inv_level_plan_covers_every_output_once(B, Mr, Mc, hlen):
    plan = K.inv_level_launch_plan(B, Mr, Mc, hlen)
    _check_shape_rules(plan, "fd", 1)
    assert plan.gc == 1 and plan.nph == 1
    assert (_coverage(plan, Mr, Mc, 1, 2, B) == 1).all(), plan


@pytest.mark.parametrize("shape", [(1, 1024, 1024), (1, 128, 128), (3, 37, 53), (1, 8, 8),
                                   (70000, 4, 4)])
def test_inv_level_plan_fits_shared_memory_for_every_tap_count(shape):
    for hlen in range(2, L.MAX_HLEN + 1):
        plan = K.inv_level_launch_plan(*shape, hlen)
        _check_shape_rules(plan, "fd", 1)
        assert plan.nt >= max(conv.poly_geometry(hlen).nb) and plan.nt % K.INV_CHUNK == 0
        assert plan.smem == K._inv_smem(conv.poly_geometry(hlen).lo
                                        + max(conv.poly_geometry(hlen).o),
                                        plan.lr, plan.lc, plan.nt)
        assert plan.grid[2] == min(shape[0], 65535)


@pytest.mark.parametrize("m", [1024, 512, 256, 128])
def test_main_path_levels_get_their_block_target(m):
    """The DWT roundtrip's synthesis levels (db7, subbands 1024^2 down to
    128^2): about two blocks per SM, where the old 32 x 32 tiles gave the
    128^2 and 256^2 levels 16 and 64 blocks."""
    plan = K.inv_level_launch_plan(1, m, m, 14)
    assert _blocks(plan) >= L.block_target(1, 2 * m, 2 * m)
    assert _blocks(plan) >= (128 if m == 128 else 256)
    assert plan.smem <= L.SMEM_TWO_BLOCKS


def _model_inv_level(bands, rlo, rhi):
    """Kernel 2's tiling in float64: per block, the window tables, the
    per-parity zero-padded taps, the row pass into the temps of (A, H) and
    (V, D), the column pass, and the tile's store."""
    B, Mr, Mc = bands[0].shape
    tl, th = L.taps(rlo), L.taps(rhi)
    hlen = len(tl)
    g = conv.poly_geometry(hlen)
    pl = K.inv_level_launch_plan(B, Mr, Mc, hlen)
    nt, lr, lc = pl.nt, pl.lr, pl.lc
    off = [g.lo + g.o[q] for q in (0, 1)]
    WR, WC = lr + max(off) + nt - 1, lc + max(off) + nt - 1
    tq = np.zeros((2, 2, nt))
    for q in (0, 1):
        for j in range(g.nb[q]):
            tq[q, 0, j], tq[q, 1, j] = tl[g.p[q] + 2 * j], th[g.p[q] + 2 * j]
    x = [t.double().numpy() for t in bands]
    out = np.zeros((B, 2 * Mr, 2 * Mc))
    for by in range(pl.grid[1]):
        r0 = by * lr
        wrows = (r0 - g.lo + np.arange(WR)) % Mr
        orows = 2 * r0 + np.arange(2 * lr)
        for bx in range(pl.grid[0]):
            c0 = bx * lc
            wcols = (c0 - g.lo + np.arange(WC)) % Mc
            ocols = 2 * c0 + np.arange(2 * lc)
            rin, cin = orows < 2 * Mr, ocols < 2 * Mc
            for b in range(B):
                w = [t[b][np.ix_(wrows, wcols)] for t in x]
                tmp = np.zeros((2, 2 * lr, WC))
                for q in (0, 1):
                    for k in (0, 1):
                        tmp[k, q::2] = sum(tq[q, 0, j] * w[2 * k][off[q] + j:off[q] + j + lr]
                                           + tq[q, 1, j] * w[2 * k + 1][off[q] + j:off[q] + j + lr]
                                           for j in range(nt))
                tile = np.zeros((2 * lr, 2 * lc))
                for q in (0, 1):
                    tile[:, q::2] = sum(tq[q, 0, j] * tmp[0][:, off[q] + j:off[q] + j + lc]
                                        + tq[q, 1, j] * tmp[1][:, off[q] + j:off[q] + j + lc]
                                        for j in range(nt))
                out[b][np.ix_(orows[rin], ocols[cin])] = tile[np.ix_(rin, cin)]
    return out


@pytest.mark.parametrize("shape", [(1, 40, 70), (2, 37, 53), (1, 8, 8)])
@pytest.mark.parametrize("wname", ["db7", "db2", "odd5"])
def test_model_of_kernel_2_tiling_matches_the_plain_version(shape, wname):
    w = _wavelet(wname)
    g = np.random.default_rng(sum(shape))
    bands = [torch.from_numpy(g.uniform(-1, 1, shape).astype(np.float32)) for _ in range(4)]
    want = K.inv_level_2d_ref(*bands, w.rec_lo, w.rec_hi)
    got = _model_inv_level(bands, w.rec_lo, w.rec_hi)
    np.testing.assert_allclose(got, want.double().numpy(), rtol=0, atol=1e-5)


def test_model_of_kernel_2_tiling_is_the_adjoint_of_the_analysis():
    """With reversed filters the synthesis is the analysis level's adjoint
    (the pairing of kernel 1's backward): <fwd(x), y> = <x, inv(y)>."""
    w = _wavelet("odd5")
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.standard_normal((1, 18, 26)))
    ys = [torch.from_numpy(g.standard_normal((1, 9, 13))) for _ in range(4)]
    lhs = sum(float((u * y).sum()) for u, y in zip(K.fwd_level_2d_ref(x, w.dec_lo, w.dec_hi),
                                                   ys))
    back = _model_inv_level([y.float() for y in ys], L.rev(w.dec_lo), L.rev(w.dec_hi))
    assert abs(lhs - float((x.numpy() * back).sum())) <= 1e-4 * abs(lhs)


# -- kernel 6: swt_inv_launch_plan in fd on float32 subbands ---------------------

# chip_smoke.py's TI cases: 1024^2 at levels 1-3 and 6, db2 8x16 at levels 1-4,
# 37x53 at levels 1-2, a batch of 3, odd5 at level 3; then dilations past the
# image (f > R and f > C)
TI_PLAN_CASES = [((1, 1024, 1024), 14, lv) for lv in (1, 2, 3, 6)] + \
    [((1, 8, 16), 4, lv) for lv in (1, 2, 3, 4)] + \
    [((1, 37, 53), 14, lv) for lv in (1, 2)] + \
    [((3, 256, 256), 14, 2), ((1, 23, 29), 5, 3), ((1, 8, 16), 4, 6), ((2, 5, 3), 14, 4),
     ((1, 301, 203), 128, 2), ((1, 64, 96), 2, 3)]


@pytest.mark.parametrize("shape,hlen,level", TI_PLAN_CASES)
def test_swt_inv_plan_on_float32_bands_covers_and_fits(shape, hlen, level):
    B, R, C = shape
    f = L.dilation(level)
    plan = SM.swt_inv_launch_plan(B, R, C, hlen, f, "fd")
    _check_shape_rules(plan, "fd", f)
    assert plan.nt >= hlen
    assert (_coverage(plan, R, C, f, 1, B) == 1).all(), plan


@pytest.mark.parametrize("shape,level,mode", [((1, 40, 70), 1, "soft"), ((2, 37, 53), 2, "hard"),
                                              ((1, 30, 41), 4, "garrote"), ((1, 8, 16), 5, None)])
@pytest.mark.parametrize("wname", ["db7", "odd5"])
def test_model_of_kernel_6_tiling_matches_the_plain_version(shape, level, mode, wname):
    """Kernel 14's tiling model in fd, on float32 subbands whose details are
    thresholded once as they are staged, against kernel 6's plain version."""
    w = _wavelet(wname)
    g = np.random.default_rng(level)
    bands = [torch.from_numpy(g.uniform(-1, 1, shape).astype(np.float32)) for _ in range(4)]
    thr = None if mode is None else (mode, 0.3)
    staged = bands if thr is None else [bands[0]] + [THR_ELEM[mode](t, 0.3) for t in bands[1:]]
    want = S.swt_inv_level_2d_ref(*bands, w.rec_lo, w.rec_hi, level, thr)
    got = _model_swt_inv(staged, w.rec_lo, w.rec_hi, level, "fd")
    np.testing.assert_allclose(got, want.double().numpy(), rtol=0, atol=1e-5)
