"""The port's plain reference path (``pdwt_tpu_torch.core.conv``) against
the JAX package's fma formulation, one pass at a time.

Both sides get the same numpy inputs (``default_rng``) and the same
filters (carried over with ``utils.convert``).  Tolerances, relative to
max|ref|: 4e-6 in float32 (same taps in the same order, but either side
may contract a multiply-add), 1e-12 in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu.core import conv as jconv
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu.kernels import separable_pallas as jsp
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.utils import wavelet_from_arrays

RTOL = {np.float32: 4e-6, np.float64: 1e-12}
TORCH_DT = {np.float32: torch.float32, np.float64: torch.float64}


def _close(got: torch.Tensor, want, dt):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == dt
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= RTOL[dt] * float(np.abs(want).max()), err


def _pair(wname):
    jw = jget_wavelet(wname)
    return jw, wavelet_from_arrays(jw)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("hw", [(12, 16), (11, 13)], ids=["even", "odd"])
def test_analysis_pass_matches_jax_fma(wname, dt, hw):
    jw, w = _pair(wname)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 1) + hw).astype(dt)
    wants = jax.jit(lambda t: [jconv.analysis_pass(t, (jw.dec_lo, jw.dec_hi), axis,
                                                   backend="fma") for axis in (-1, -2)])(x)
    for axis, want in zip((-1, -2), wants):
        got = conv.analysis_pass(torch.from_numpy(x), (w.dec_lo, w.dec_hi), axis)
        _close(got, want, dt)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("out", [(12, 16), (11, 13)], ids=["even", "odd"])
def test_synthesis_pass_matches_jax_fma(wname, dt, out):
    jw, w = _pair(wname)
    m = tuple((n + 1) // 2 for n in out)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 2) + m).astype(dt)
    cases = ((-1, out[1]), (-2, out[0]))
    wants = jax.jit(lambda t: [jconv.synthesis_pass(t, (jw.rec_lo, jw.rec_hi), axis,
                                                    out_len=n, backend="fma")
                               for axis, n in cases])(x)
    for (axis, n), want in zip(cases, wants):
        got = conv.synthesis_pass(torch.from_numpy(x), (w.rec_lo, w.rec_hi), axis,
                                  out_len=n)
        _close(got, want, dt)


@pytest.mark.parametrize("hlen", [2, 3, 4, 5, 6, 7, 14, 18, 36, 40])
def test_index_helpers_match_jax(hlen):
    assert conv.fwd_center(hlen) == jconv.fwd_center(hlen)
    assert conv.inv_shift(hlen) == jconv.inv_shift(hlen)
    g = conv.poly_geometry(hlen)
    p, o, lo, hi = jsp._poly_geometry(hlen)
    assert (g.p, g.o, g.lo, g.hi) == (p, o, lo, hi)
    assert g.nb == tuple(len(range(p[q], hlen, 2)) for q in (0, 1))


@pytest.mark.parametrize("n,lo,hi", [(5, 2, 3), (3, 7, 8), (4, 0, 0), (1, 2, 1)])
def test_wrap_pad_and_odd_extend_match_jax(n, lo, hi):
    """Pads wider than the axis tile whole periods, as JAX's do."""
    x = np.arange(2 * n, dtype=np.float64).reshape(2, n)
    want = jconv.wrap_pad(jnp.asarray(x), -1, lo, hi)
    np.testing.assert_array_equal(conv.wrap_pad(torch.from_numpy(x), -1, lo, hi).numpy(),
                                  np.asarray(want))
    want = jconv.odd_extend(jnp.asarray(x), -1)
    np.testing.assert_array_equal(conv.odd_extend(torch.from_numpy(x), -1).numpy(),
                                  np.asarray(want))


def test_passes_reject_integer_input():
    w = wavelet_from_arrays(jget_wavelet("db2"))
    with pytest.raises(TypeError, match="float32 or float64"):
        conv.analysis_pass(torch.zeros(1, 1, 4, 4, dtype=torch.int32),
                           (w.dec_lo, w.dec_hi), -1)
