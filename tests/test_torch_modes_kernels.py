"""The plain versions of the padded entry points of kernels 1, 2, 7 and 8
(the boundary modes) against the JAX package's ``*_padded`` Pallas kernels
(interpret mode, on JAX's own geometry), the offsets of the padded
synthesis against its C model, their launch plans, and their autograd
Functions.

The JAX kernels read the pad they are given at their aligned offsets: the
analysis's output n sums ``xp[lo + 2n - c + j]`` (c = ``fwd_center``), so
the port's plain version, whose output n sums ``xp[2n + j]``, takes the
input from ``lo - c`` on and is compared on the outputs JAX computes; the
synthesis's output t sums the stuffed coefficients ``t - s + j`` of the
array from ``lo`` on (s = ``inv_shift``), the port's offset ``c0 = 2 lo -
s``.  One interpret-mode level takes about two seconds, so two cases each.
Tolerance: max|port - jax| <= 4e-6 * max|jax| in float32 (the same taps in
the same order; either side may contract a multiply-add).  The CUDA
kernels are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from pdwt_tpu import kernels as jk
from pdwt_tpu.core import conv as jconv
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.kernels import _launch
from pdwt_tpu_torch.kernels import batched1d as K1
from pdwt_tpu_torch.kernels import matmul as M
from pdwt_tpu_torch.kernels import mxu1d as M1
from pdwt_tpu_torch.kernels import separable as K
from pdwt_tpu_torch.utils import wavelet_from_arrays

RTOL = 4e-6


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")


def _close(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        assert float(np.abs(g - w).max()) <= RTOL * float(np.abs(w).max())


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _taps(f):
    return tuple(float(v) for v in f)


@pytest.mark.parametrize("wname,B,mshape", [("db7", 1, (64, 128)), ("sym8", 2, (8, 128))])
def test_fwd_level_2d_padded_ref_matches_pallas(wname, B, mshape):
    jw = jget_wavelet(wname)
    w = wavelet_from_arrays(jw)
    mr, mc = mshape
    lo_r, lo_c, hi_r, hi_c = jk.fwd_geometry(2 * mr, 2 * mc, w.hlen)
    xp = _rand(B, lo_r + 2 * mr + hi_r, lo_c + 2 * mc + hi_c, seed=B)
    want = jk.fwd_level_2d_padded(xp, _taps(w.dec_lo), _taps(w.dec_hi), mshape)
    c = jconv.fwd_center(w.hlen)
    got = K.fwd_level_2d_padded_ref(torch.from_numpy(xp[:, lo_r - c:, lo_c - c:].copy()),
                                    w.dec_lo, w.dec_hi)
    assert all(t.shape[-2] >= mr and t.shape[-1] >= mc for t in got)
    _close([t[:, :mr, :mc] for t in got], want)


@pytest.mark.parametrize("wname,B,mshape", [("db7", 1, (64, 128)), ("db2", 2, (8, 128))])
def test_inv_level_2d_padded_ref_matches_pallas(wname, B, mshape):
    jw = jget_wavelet(wname)
    w = wavelet_from_arrays(jw)
    mr, mc = mshape
    lo_r, lo_c, hi_r, hi_c = jk.inv_geometry(mr, mc, w.hlen)
    bands = [_rand(B, lo_r + mr + hi_r, lo_c + mc + hi_c, seed=k) for k in range(4)]
    want = jk.inv_level_2d_padded(*bands, _taps(w.rec_lo), _taps(w.rec_hi), mshape)
    s = jconv.inv_shift(w.hlen)
    got = K.inv_level_2d_padded_ref(*map(torch.from_numpy, bands), w.rec_lo, w.rec_hi,
                                    (2 * lo_r - s, 2 * lo_c - s), (2 * mr, 2 * mc))
    _close([got], [want])


@pytest.mark.parametrize("wname,B,m", [("sym8", 16, 128), ("db2", 8, 256)])
def test_fwd_level_1d_padded_ref_matches_pallas(wname, B, m):
    jw = jget_wavelet(wname)
    w = wavelet_from_arrays(jw)
    lo, hi = jk.fwd1d_geometry(B, 2 * m, w.hlen)
    xp = _rand(B, lo + 2 * m + hi, seed=m)
    want = jk.fwd_level_1d_padded(xp, _taps(w.dec_lo), _taps(w.dec_hi), m)
    c = jconv.fwd_center(w.hlen)
    got = K1.fwd_level_1d_padded_ref(torch.from_numpy(xp[:, lo - c:].copy()), w.dec_lo,
                                     w.dec_hi)
    _close([t[:, :m] for t in got], want)


@pytest.mark.parametrize("wname,B,m", [("sym8", 16, 128), ("db7", 8, 256)])
def test_inv_level_1d_padded_ref_matches_pallas(wname, B, m):
    jw = jget_wavelet(wname)
    w = wavelet_from_arrays(jw)
    lo, hi = jk.inv1d_geometry(B, m, w.hlen)
    bands = [_rand(B, lo + m + hi, seed=k) for k in range(2)]
    want = jk.inv_level_1d_padded(*bands, _taps(w.rec_lo), _taps(w.rec_hi), m)
    got = K1.inv_level_1d_padded_ref(*map(torch.from_numpy, bands), w.rec_lo, w.rec_hi,
                                     2 * lo - jconv.inv_shift(w.hlen), 2 * m)
    _close([got], [want])


def _pad_axis_reads(p, hlen, n):
    """A model of ``band_strip.cuh: pad_axis_ok``: do the stored outputs
    of a padded synthesis read inside the ``n`` coefficients of their
    axis?"""
    g = conv.poly_geometry(hlen)
    if p.off not in (0, 1) or p.n_out < 1:
        return False
    for q in (0, 1):
        last = p.off + p.n_out - 1 - q
        if last < 0:
            continue
        m0, m1 = (p.off - q + 1) // 2, last // 2
        if m1 >= m0 and (p.base + m0 + g.o[q] < 0 or p.base + m1 + g.o[q] + g.nb[q] - 1 > n - 1):
            return False
    return True


def _stuffed_synthesis(x, rev, c0, out_len):
    """``out[i] = sum_j rev[j] U[i + c0 + j]`` in float64 with the
    zero-stuffed ``U`` written out, reading zeros outside ``x``."""
    u = np.zeros(2 * len(x) + 2 * len(rev) + abs(c0) + out_len + 4)
    base = len(rev) + abs(c0) + 2  # index of U[0] in u
    u[base:base + 2 * len(x):2] = x
    return np.array([sum(rev[j] * u[base + i + c0 + j] for j in range(len(rev)))
                     for i in range(out_len)])


@pytest.mark.parametrize("hlen", [2, 4, 6, 14, 16])
def test_padded_synthesis_offsets_and_read_check(hlen):
    """The plain synthesis at offset c0 is the zero-stuffed correlation;
    its read check (``conv.check_padded_synthesis``) agrees with the C
    entry points' (``_pad_axis_reads``) on the periodic body's (base, off),
    and every output it admits reads inside the coefficients."""
    rng = np.random.default_rng(hlen)
    rev = rng.standard_normal(hlen)
    for n in (1, 2, 3, 7, 10):
        x = rng.standard_normal(n)
        for c0 in range(-3, 2 * n):
            for out_len in range(0, 2 * n + 3):
                pa = _launch.pad_axis(hlen, c0, out_len)
                assert pa.off in (0, 1) and pa.n_out == out_len
                try:
                    conv.check_padded_synthesis(n, hlen, c0, out_len)
                    ok = True
                except ValueError:
                    ok = False
                assert ok == _pad_axis_reads(pa, hlen, n), (n, c0, out_len)
                if not ok:
                    continue
                # reading zeros outside x changes nothing where the check admits
                z = torch.from_numpy(np.stack([x, np.zeros(n)]))[None, :, None]
                got = conv.padded_synthesis_pass(z, (rev[::-1].copy(), np.zeros(hlen)), -1,
                                                 c0, out_len)[0, 0, 0].numpy()
                want = _stuffed_synthesis(x, rev, c0, out_len)
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("hlen,mshape,c0,out", [(14, (1030, 1030), (-1, -1), (2048, 2048)),
                                                (16, (9, 2055), (-1, 7), (3, 4096)),
                                                (4, (1, 1), (-1, -1), (1, 1))])
def test_padded_launch_plans_cover_the_outputs(hlen, mshape, c0, out):
    """Kernel 1's padded plan covers its outputs; kernel 2's covers the
    positions ``pad_positions`` (every stored output, two a position); the
    1D plans likewise, on 32-signal groups."""
    ro, co = (conv.padded_len(2 * n + hlen, hlen) for n in mshape)
    pl = M.fwd_padded_launch_plan(2, ro, co, hlen, "fd")
    assert pl.grid[0] * pl.lc >= co and pl.grid[1] * pl.lr >= ro and pl.gc == 1
    rows, cols = (_launch.pad_axis(hlen, c, n) for c, n in zip(c0, out))
    pl = M.inv_padded_launch_plan(2, rows, cols, hlen, "fd")
    for axis, lt, g in ((rows, pl.lr, pl.grid[1]), (cols, pl.lc, pl.grid[0])):
        assert 2 * g * lt >= axis.off + axis.n_out
        assert g == -(-_launch.pad_positions(axis) // lt)
    pl1 = M1.fwd1d_padded_launch_plan(33, co, hlen, "fd")
    assert pl1.grid[0] * pl1.lc >= co and pl1.grid[1] == 2
    pl1 = M1.inv1d_padded_launch_plan(33, cols, hlen, "fd")
    assert 2 * pl1.grid[0] * pl1.lc >= cols.off + cols.n_out


def test_padded_autograd_is_the_adjoint():
    """The four ``*_padded_ad`` Functions (the plain versions on the CPU)
    give the exact adjoint: <grad, input> = <cotangent, output> for these
    linear maps, in float64."""
    rng = np.random.default_rng(3)
    w = wavelet_from_arrays(jget_wavelet("db3"))
    t = lambda *s: torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
    cases = [(lambda x: K.fwd_level_2d_padded_ad(x, w.dec_lo, w.dec_hi), [t(2, 13, 11)]),
             (lambda *b: K.inv_level_2d_padded_ad(*b, w.rec_lo, w.rec_hi, (-1, 1), (9, 8)),
              [t(2, 7, 8) for _ in range(4)]),
             (lambda x: K1.fwd_level_1d_padded_ad(x, w.dec_lo, w.dec_hi), [t(3, 17)]),
             (lambda lo, hi: K1.inv_level_1d_padded_ad(lo, hi, w.rec_lo, w.rec_hi, -1, 12),
              [t(3, 9), t(3, 9)])]
    for fn, args in cases:
        out = fn(*args)
        outs = list(out) if isinstance(out, tuple) else [out]
        cts = [torch.from_numpy(rng.standard_normal(o.shape)) for o in outs]
        grads = torch.autograd.grad(outs, args, cts)
        lhs = sum(float((g * a.detach()).sum()) for g, a in zip(grads, args))
        rhs = sum(float((c * o.detach()).sum()) for c, o in zip(cts, outs))
        assert abs(lhs - rhs) <= 1e-10 * max(1.0, abs(rhs))


def test_padded_wrappers_refuse_reads_outside():
    w = wavelet_from_arrays(jget_wavelet("db2"))
    with pytest.raises(ValueError, match="needs at least 4 samples"):
        K.fwd_level_2d_padded_ref(torch.zeros(1, 3, 8), w.dec_lo, w.dec_hi)
    with pytest.raises(ValueError, match="reads outside"):
        K.inv_level_2d_padded_ref(*[torch.zeros(1, 4, 4)] * 4, w.rec_lo, w.rec_hi, (-1, -1),
                                  (8, 6))
    with pytest.raises(ValueError, match="reads outside"):
        K1.inv_level_1d_padded_ref(torch.zeros(1, 4), torch.zeros(1, 4), w.rec_lo, w.rec_hi,
                                   -2, 4)
