"""The plain versions of the padded entry points of kernels 5, 6, 9 and 10
(the sharded SWT) against the JAX package's ``*_padded`` Pallas kernels
(interpret mode), their halos and their launch plans.

Each side pads the same periodic input with its own geometry: JAX's
``swt_fwd_geometry`` / ``swt_inv_geometry`` (``swt1d_*`` in 1D) add Mosaic
alignment margins to the periodic support, the port's ``swt_fwd_halo`` /
``swt_inv_halo`` exchange the bare support; both then compute the same
a-trous level of the periodic signal, which is compared.  One
interpret-mode level takes a few seconds, so one geometry a kernel (level 2
or 3, so that the dilation shows).  Tolerance: max|port - jax| <= 1e-5 *
max|jax| in float32 (the same taps in the same order; either side may
contract a multiply-add).  The CUDA kernels are held to these plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from pdwt_tpu import kernels as jk
from pdwt_tpu.core import conv as jconv
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu_torch import kernels as K
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.kernels import _launch
from pdwt_tpu_torch.kernels import batched1d as K1
from pdwt_tpu_torch.kernels import mxu1d as M1
from pdwt_tpu_torch.kernels import swt as S
from pdwt_tpu_torch.kernels import swt_matmul as SM
from pdwt_tpu_torch.utils import wavelet_from_arrays

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")


def _close(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        assert float(np.abs(g - w).max()) <= RTOL * scale


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _taps(f):
    return tuple(float(v) for v in f)


def _jpad(x, lo_hi_per_axis):
    """numpy periodic pad with JAX's geometry, ((axis, lo, hi), ...)."""
    for ax, lo, hi in lo_hi_per_axis:
        x = np.asarray(jconv.wrap_pad(x, ax, lo, hi))
    return x


def _tpad(x, lo, hi, axes):
    t = torch.from_numpy(x)
    for ax in axes:
        t = conv.wrap_pad(t, ax, lo, hi)
    return t.contiguous()


def test_swt_fwd_level_2d_padded_ref_matches_pallas():
    w = wavelet_from_arrays(jget_wavelet("db7"))
    B, r, c, level = 1, 16, 128, 2
    x = _rand(B, r, c, seed=1)
    lo_r, lo_c, hi_r, hi_c = jk.swt_fwd_geometry(r, c, w.hlen, level)
    want = jk.swt_fwd_level_2d_padded(_jpad(x, ((-1, lo_c, hi_c), (-2, lo_r, hi_r))),
                                      _taps(w.dec_lo), _taps(w.dec_hi), level, (r, c))
    lo, hi = K.swt_fwd_halo(w.hlen, level)
    _close(S.swt_fwd_level_2d_padded_ref(_tpad(x, lo, hi, (-1, -2)), w.dec_lo, w.dec_hi,
                                         level), want)


def test_swt_inv_level_2d_padded_ref_matches_pallas():
    w = wavelet_from_arrays(jget_wavelet("sym4"))
    B, r, c, level = 2, 16, 128, 3
    bands = [_rand(B, r, c, seed=k) for k in range(4)]
    lo_r, lo_c, hi_r, hi_c = jk.swt_inv_geometry(r, c, w.hlen, level)
    want = jk.swt_inv_level_2d_padded(
        *(_jpad(t, ((-1, lo_c, hi_c), (-2, lo_r, hi_r))) for t in bands), _taps(w.rec_lo),
        _taps(w.rec_hi), level, (r, c))
    lo, hi = K.swt_inv_halo(w.hlen, level)
    got = S.swt_inv_level_2d_padded_ref(*(_tpad(t, lo, hi, (-1, -2)) for t in bands),
                                        w.rec_lo, w.rec_hi, level)
    _close([got], [want])


def test_swt_fwd_level_1d_padded_ref_matches_pallas():
    w = wavelet_from_arrays(jget_wavelet("sym8"))
    B, n, level = 8, 256, 3
    x = _rand(B, n, seed=2)
    lo_c, hi_c = jk.swt1d_fwd_geometry(B, n, w.hlen, level)
    want = jk.swt_fwd_level_1d_padded(_jpad(x, ((-1, lo_c, hi_c),)), _taps(w.dec_lo),
                                      _taps(w.dec_hi), level, n)
    lo, hi = K.swt_fwd_halo(w.hlen, level)
    _close(K1.swt_fwd_level_1d_padded_ref(_tpad(x, lo, hi, (-1,)), w.dec_lo, w.dec_hi, level),
           want)


def test_swt_inv_level_1d_padded_ref_matches_pallas():
    w = wavelet_from_arrays(jget_wavelet("db4"))
    B, n, level = 8, 256, 2
    lo_b, hi_b = _rand(B, n, seed=3), _rand(B, n, seed=4)
    lo_c, hi_c = jk.swt1d_inv_geometry(B, n, w.hlen, level)
    want = jk.swt_inv_level_1d_padded(_jpad(lo_b, ((-1, lo_c, hi_c),)),
                                      _jpad(hi_b, ((-1, lo_c, hi_c),)), _taps(w.rec_lo),
                                      _taps(w.rec_hi), level, n)
    lo, hi = K.swt_inv_halo(w.hlen, level)
    got = K1.swt_inv_level_1d_padded_ref(_tpad(lo_b, lo, hi, (-1,)), _tpad(hi_b, lo, hi, (-1,)),
                                         w.rec_lo, w.rec_hi, level)
    _close([got], [want])


@pytest.mark.parametrize("hlen", [2, 5, 14, 16])
@pytest.mark.parametrize("level", [1, 2, 4])
def test_halos_are_the_periodic_support(hlen, level):
    """lo + hi is the dilated span; lo is the centre the periodic kernels
    read from (fwd_center, swt_inv_center), so a wrap by the halo gives
    the periodic level (plain versions on a 2D and a 1D input)."""
    f = 1 << (level - 1)
    for halo, c in ((K.swt_fwd_halo, conv.fwd_center(hlen)),
                    (K.swt_inv_halo, conv.swt_inv_center(hlen))):
        lo, hi = halo(hlen, level)
        assert (lo, lo + hi) == (c * f, (hlen - 1) * f)
    g = np.random.default_rng(hlen).standard_normal((4, hlen))
    x = torch.from_numpy(_rand(2, 12, 20, seed=level))
    lo, hi = K.swt_fwd_halo(hlen, level)
    got = S.swt_fwd_level_2d_padded_ref(conv.wrap_pad(conv.wrap_pad(x, -1, lo, hi), -2, lo, hi),
                                        g[0], g[1], level)
    for a, b in zip(got, S.swt_fwd_level_2d_ref(x, g[0], g[1], level)):
        assert torch.allclose(a, b, rtol=0, atol=1e-4)
    lo, hi = K.swt_inv_halo(hlen, level)
    s, t = x[0], x[1]
    got = K1.swt_inv_level_1d_padded_ref(conv.wrap_pad(s, -1, lo, hi),
                                         conv.wrap_pad(t, -1, lo, hi), g[2], g[3], level)
    assert torch.allclose(got, K1.swt_inv_level_1d_ref(s, t, g[2], g[3], level), rtol=0,
                          atol=1e-4)


T8 = np.ones(8)  # 8 taps: a span of 7 f = 14 at level 2
BAND = torch.rand(1, 14, 14)


@pytest.mark.parametrize("call", [
    lambda: S.swt_fwd_level_2d_padded(BAND, T8, T8, 2),
    lambda: S.swt_inv_level_2d_padded(BAND, BAND, BAND, BAND, T8, T8, 2),
    lambda: K1.swt_fwd_level_1d_padded(BAND[0], T8, T8, 2),
    lambda: K1.swt_inv_level_1d_padded(BAND[0], BAND[0], T8, T8, 2),
], ids=["5p", "6p", "9p", "10p"])
def test_padded_entry_points_refuse_reads_outside(call):
    """An input no longer than the dilated span holds no output: every
    output would read past it, so the entry points refuse it (the C entry
    checks the same, R >= Ro + (hlen - 1) f, against its plan)."""
    with pytest.raises(ValueError, match="needs more than 14 samples"):
        call()
    assert conv.padded_atrous_len(15, 8, 2) == 1


def _grid_fits(pl, B, R, C, f):
    """band_strip.cuh: grid_fits, the C entry's check of a 2D plan."""
    want_x = -(-C // pl.lc) if pl.gc == 1 else _launch.axis_blocks(C, f, pl.lc)
    return pl.grid == (want_x, _launch.axis_blocks(R, f, pl.lr), min(B, 65535))


def _lines_fit(pl, B, n, f):
    """mxu1d.cu: lines_fit, the C entry's check of a 1D plan."""
    want_x = -(-n // pl.lc) if pl.gc == 1 else _launch.axis_blocks(n, f, pl.lc)
    return pl.grid == (want_x, min(-(-B // 32), 65535), 1)


@pytest.mark.parametrize("B,R,C,hlen,level", [(1, 512, 512, 14, 1), (1, 512, 512, 14, 3),
                                              (4, 64, 256, 16, 4), (1, 37, 53, 5, 2),
                                              (3, 8, 8, 40, 6)])
def test_padded_plans_cover_the_outputs(B, R, C, hlen, level):
    """The plans are the periodic kernels' for the output size, and their
    grids pass the C entries' checks for it (not for the padded input)."""
    f = 1 << (level - 1)
    fwd = SM.swt_fwd_padded_launch_plan(B, R, C, hlen, f, "fd")
    inv = SM.swt_inv_padded_launch_plan(B, R, C, hlen, f, "fd")
    assert _grid_fits(fwd, B, R, C, f) and _grid_fits(inv, B, R, C, f)
    assert fwd.lc % (8 * (f // fwd.gc)) == 0 and inv.lc % (8 * (f // inv.gc)) == 0
    f1 = M1.swt_fwd1d_padded_launch_plan(B * R, C, hlen, f, "fd")
    i1 = M1.swt_inv1d_padded_launch_plan(B * R, C, hlen, f, "fd")
    assert _lines_fit(f1, B * R, C, f) and _lines_fit(i1, B * R, C, f)
    assert f1.lc % (8 * (f // f1.gc)) == 0 and i1.lc % (8 * (f // i1.gc)) == 0
