"""The port's batched 1D slice against the JAX package: ``dwt1d``,
``idwt1d``, ``swt1d`` (``keep_approx`` included), ``iswt1d``, the
thresholds and norms on a ``Coeffs1D``, gradients, the golden 1D entries,
and the ``Wavelets`` facade with ``ndim=1``.

JAX runs its ``backend="fma"`` path, the formulation the port's plain path
follows; inputs come from ``default_rng`` and cross as numpy arrays.
Tolerances, relative to the largest magnitude of the compared coefficient
tree or signal: 4e-6 in float32 (the same taps in the same order; either
side may contract a multiply-add), 1e-12 in float64, also against the
golden float64 coefficients; norms, which sum thousands of terms in another
order, 1e-5 in float32.  A float64 roundtrip back to the golden input is
held to 1e-10 absolute, as ``tests/test_golden.py`` holds the JAX package:
the bank's filters reconstruct perfectly to about 1e-12 only.
"""
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from pdwt_tpu import Wavelets as JWavelets
from pdwt_tpu import ops as jops
from pdwt_tpu.core import separable as jsep
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu.filters import make_custom_wavelet as jmake_custom_wavelet
from pdwt_tpu_torch import (Coeffs1D, Wavelets, dwt1d, get_wavelet, idwt1d, iswt1d, ops,
                            swt1d)
from pdwt_tpu_torch.utils import coeffs1d_from_numpy, coeffs1d_to_numpy, wavelet_from_arrays

RTOL = {np.float32: 4e-6, np.float64: 1e-12}
NORM_RTOL = {np.float32: 1e-5, np.float64: 1e-12}
GOLD = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "golden.npz"))


def _leaves(c):
    a, dets = coeffs1d_to_numpy(c)
    return [a, *dets]


def _close(got, want, dt=np.float32):
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    want = [np.asarray(w) for w in want]
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape and g.dtype == w.dtype == dt
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= RTOL[dt] * scale, err


def _pair(wname):
    """(JAX wavelet, port wavelet); "odd7" is an odd-length custom bank."""
    if wname == "odd7":
        jw = jmake_custom_wavelet("odd7", *np.random.default_rng(7).standard_normal((4, 7)))
    else:
        jw = jget_wavelet(wname)
    return jw, wavelet_from_arrays(jw)


def _sig(shape, dt=np.float32, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(dt)


CASES = [("sym8", (64,), 2),          # no batch dimension, even length
         ("db2", (3, 37), 3),         # prime length
         ("haar", (2, 3, 45), 4),     # odd length, two batch dimensions
         ("sym8", (3, 10), 1),        # shorter than the support (hlen 16)
         ("odd7", (2, 3, 29), 2)]     # an odd-length bank


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("wname,shape,levels", CASES)
def test_dwt1d_and_idwt1d_match_jax(wname, shape, levels, dt):
    jw, w = _pair(wname)
    x = _sig(shape, dt, seed=1)
    want = jax.jit(lambda t: jsep.dwt1d(t, jw, levels, backend="fma"))(x)
    got = dwt1d(torch.from_numpy(x), w, levels)
    assert isinstance(got, Coeffs1D) and got.levels == levels
    _close(_leaves(got), _leaves(want), dt)
    # the inverse of the same (JAX) coefficients on both sides
    n = shape[-1]
    want_y = jax.jit(lambda c: jsep.idwt1d(c, jw, n, backend="fma"))(want)
    got_y = idwt1d(coeffs1d_from_numpy(*coeffs1d_to_numpy(want)), w, n)
    _close(got_y, want_y, dt)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("wname,shape,levels", CASES)
def test_swt1d_and_iswt1d_match_jax(wname, shape, levels, dt):
    """At level 4 of haar and level 3 of db2 the dilated support exceeds
    short signals; the one 1/2 of a 1D synthesis on both sides."""
    jw, w = _pair(wname)
    x = _sig(shape, dt, seed=2)
    want = jax.jit(lambda t: jsep.swt1d(t, jw, levels, backend="fma"))(x)
    got = swt1d(torch.from_numpy(x), w, levels)
    assert all(tuple(t.shape) == shape for t in [got.approx, *got.details])
    _close(_leaves(got), _leaves(want), dt)
    want_y = jax.jit(lambda c: jsep.iswt1d(c, jw, backend="fma"))(want)
    _close(iswt1d(coeffs1d_from_numpy(*coeffs1d_to_numpy(want)), w), want_y, dt)
    if wname != "odd7":  # a random bank does not reconstruct
        _close(iswt1d(got, w), x, dt)


def test_swt1d_keep_approx_matches_jax():
    jw, w = _pair("db2")
    x = _sig((2, 40), seed=3)
    jc, ja = jax.jit(lambda t: jsep.swt1d(t, jw, 3, backend="fma", keep_approx=True))(x)
    c, a = swt1d(torch.from_numpy(x), w, 3, keep_approx=True)
    assert len(a) == 3 and torch.equal(a[-1], c.approx)
    _close(_leaves(c) + list(a), _leaves(jc) + [np.asarray(t) for t in ja])


@pytest.mark.parametrize("key", ["dwt1d/sym4", "dwt1d/db2", "dwt1d/db5", "swt1d/db2"])
def test_golden_1d_coefficients(key):
    """The float64 golden data, and the inverse back to its input."""
    kind, wname = key.split("/")
    w = get_wavelet(wname)
    x = torch.from_numpy(GOLD[f"{key}/x"])
    levels = int(GOLD[f"{key}/levels"]) if kind == "dwt1d" else 2
    c = (dwt1d if kind == "dwt1d" else swt1d)(x, w, levels)
    want = [GOLD[f"{key}/a"]] + [GOLD[f"{key}/L{i}/d"] for i in range(1, levels + 1)]
    _close(_leaves(c), want, np.float64)
    y = idwt1d(c, w, x.shape[-1]) if kind == "dwt1d" else iswt1d(c, w)
    assert y.shape == x.shape and float((y - x).abs().max()) < 1e-10


# ---------------------------------------------------------------------------
# ops on a Coeffs1D
# ---------------------------------------------------------------------------

def _trees(swt=False, seed=4):
    jw, w = _pair("sym8")
    x = _sig((3, 200), seed=seed)
    fn = jsep.swt1d if swt else jsep.dwt1d
    jc = jax.jit(lambda t: fn(t, jw, 3, backend="fma"))(x)
    return jc, coeffs1d_from_numpy(*coeffs1d_to_numpy(jc))


BETAS = [40.0, [60.0, 40.0, 20.0], [[60.0], [40.0], [20.0]]]


@pytest.mark.parametrize("beta", BETAS, ids=["scalar", "per_level", "per_level_band"])
@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
def test_thresholds_on_coeffs1d_match_jax(mode, beta):
    """A 1D level's one band takes band index None (the first entry of a
    per-band sequence), as JAX's ``_map_details`` gives it."""
    jc, c = _trees()
    name = f"{mode}_threshold"
    for kwargs in ({}, {"normalize": True, "do_thresh_appcoeffs": True}):
        got = getattr(ops, name)(c, beta, **kwargs)
        want = getattr(jops, name)(jc, beta, **kwargs)
        assert isinstance(got, Coeffs1D) and all(isinstance(d, torch.Tensor)
                                                 for d in got.details)
        _close(_leaves(got), _leaves(want))


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_norms_on_coeffs1d_match_jax(swt):
    jc, c = _trees(swt=swt, seed=5)
    for fn in ("norm1", "norm2sq"):
        assert np.isclose(float(getattr(ops, fn)(c)), float(getattr(jops, fn)(jc)),
                          rtol=NORM_RTOL[np.float32], atol=0)
    for mode in ("soft", "hard", "garrote"):
        for beta, kw in [(40.0, {}), ([60.0, 40.0, 20.0], {"do_thresh_appcoeffs": True}),
                         (40.0, {"normalize": True})]:
            got = float(ops.thresholded_norm1(c, beta, mode=mode, **kw))
            want = float(jops.thresholded_norm1(jc, beta, mode=mode, **kw))
            assert np.isclose(got, want, rtol=NORM_RTOL[np.float32], atol=0), (mode, beta, kw)
            full = float(ops.norm1(getattr(ops, f"{mode}_threshold")(c, beta, **kw)))
            assert np.isclose(got, full, rtol=NORM_RTOL[np.float32], atol=0)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wname,swt", [("sym8", False), ("db2", False), ("odd7", False),
                                       ("db7", True)])
def test_gradients_match_jax_grad(wname, swt):
    """d/dx of a loss through the level-1 details and the inverse of the
    soft-thresholded tree, against jax.grad of the fma path (float64)."""
    jw, w = _pair(wname)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 45))
    u = rng.standard_normal((2, 45 if swt else 23))
    v = rng.standard_normal((2, 45))

    def jloss(t):
        c = (jsep.swt1d if swt else jsep.dwt1d)(t, jw, 3, backend="fma")
        c = jops.soft_threshold(c, 0.3)
        y = (jsep.iswt1d(c, jw, backend="fma") if swt
             else jsep.idwt1d(c, jw, 45, backend="fma"))
        return (c.details[0] * u).sum() + (y * v).sum()

    want = np.asarray(jax.jit(jax.grad(jloss))(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    c = (swt1d if swt else dwt1d)(xt, w, 3)
    c = ops.soft_threshold(c, 0.3)
    y = iswt1d(c, w) if swt else idwt1d(c, w, 45)
    loss = (c.details[0] * torch.from_numpy(u)).sum() + (y * torch.from_numpy(v)).sum()
    (got,) = torch.autograd.grad(loss, xt)
    _close(got, want, np.float64)


def test_1d_transforms_refuse_what_they_do_not_take():
    """The boundary modes are ported: a mode, and a one-mode tuple, give
    JAX's fma coefficients and invert; two modes for one axis, an unknown
    mode and a 0-d input are refused."""
    jw = jget_wavelet("db2")
    w = wavelet_from_arrays(jw)
    x = np.random.default_rng(3).standard_normal((2, 11)).astype(np.float32)
    for mode in ("symmetric", ("zero",)):
        got = dwt1d(torch.from_numpy(x), w, 2, mode=mode)
        want = jax.jit(lambda t: jsep.dwt1d(t, jw, 2, mode=mode, backend="fma"))(x)
        _close(_leaves(got), _leaves(want))
        np.testing.assert_allclose(idwt1d(got, w, 11, mode=mode).numpy(), x, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="expected 1 boundary modes"):
        dwt1d(torch.zeros(8), w, 1, mode=("zero", "zero"))
    with pytest.raises(ValueError, match="unknown boundary mode"):
        idwt1d(dwt1d(torch.zeros(8), w, 1), w, 8, mode="zeros")
    with pytest.raises(ValueError, match="at least 1D"):
        swt1d(torch.zeros(()), w, 1)


# ---------------------------------------------------------------------------
# the facade with ndim=1
# ---------------------------------------------------------------------------

def _pair_facade(sig, **kw):
    W, J = Wavelets(sig, device="cpu", **kw), JWavelets(sig, backend="fma", **kw)
    assert W.spec.ndim == J.spec.ndim == 1 and W.spec.nlevels == J.spec.nlevels
    return W, J


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
@pytest.mark.parametrize("shape,kwargs", [((257,), {}), ((6, 300), {"ndim": 1}),
                                          ((1, 150), {})],
                         ids=["signal", "batch", "nr1"])
def test_facade_ndim1_matches_jax(shape, kwargs, swt):
    """forward, soft_threshold, norm1, norm2sq, inverse; a 1D array and an
    (1, n) array become one signal, an (nr, nc) array with ``ndim=1`` is a
    batch of nr signals."""
    sig = _sig(shape, seed=7)
    W, J = _pair_facade(sig, wname="sym8", levels=3, do_swt=swt, **kwargs)
    rows = 1 if len(shape) == 1 else shape[0]
    assert (W.spec.nr, W.spec.nc) == (J.spec.nr, J.spec.nc) == (rows, shape[-1])
    assert tuple(W.d_image.shape) == (rows, shape[-1])
    _close(_leaves(W.coeffs), _leaves(J.coeffs))  # the zero trees have one shape
    _close(_leaves(W.forward()), _leaves(J.forward()))
    assert np.isclose(W.norm2sq(), J.norm2sq(), rtol=NORM_RTOL[np.float32], atol=0)
    W.soft_threshold(30.0)
    J.soft_threshold(30.0)
    _close(_leaves(W.coeffs), _leaves(J.coeffs))
    assert np.isclose(W.norm1(), J.norm1(), rtol=NORM_RTOL[np.float32], atol=0)
    _close(W.inverse(), J.inverse())
    _close(W.get_image(), J.get_image())


@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_facade_ndim1_run_denoise_matches_jax(swt, mode):
    """Never fused in 1D: threshold, norm1, inverse in turn."""
    sig = _sig((4, 512), seed=8)
    W, J = _pair_facade(sig, wname="sym8", levels=4, ndim=1, do_swt=swt)
    out, n1 = W.run_denoise(0.1 * 255, mode=mode, normalize=True)
    jout, jn1 = J.run_denoise(0.1 * 255, mode=mode, normalize=True)
    _close(out, jout)
    assert np.isclose(float(n1), float(jn1), rtol=NORM_RTOL[np.float32], atol=0)
    _close(W.get_image(), sig)  # the facade's image is left as it was


def test_facade_ndim1_haar_rides_the_level_kernels():
    """JAX's facade routes a 1D Haar DWT off the TPU to the butterflies of
    ``core/haar.py``; the port runs Haar on its level kernels.  The values
    agree to roundoff."""
    sig = _sig((5, 97), seed=9)
    W, J = _pair_facade(sig, wname="haar", levels=5, ndim=1)
    _close(_leaves(W.forward()), _leaves(J.forward()))
    W.hard_threshold(20.0)
    J.hard_threshold(20.0)
    _close(W.inverse(), J.inverse())


@pytest.mark.parametrize("nc,levels", [(100, 9), (10, 3), (64, 0)])
def test_facade_ndim1_level_clamping_matches_jax(nc, levels):
    with warnings.catch_warnings(record=True) as ours:
        warnings.simplefilter("always")
        W = Wavelets(nr=3, nc=nc, wname="db7", levels=levels, ndim=1, device="cpu")
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        J = JWavelets(nr=3, nc=nc, wname="db7", levels=levels, ndim=1)
    assert W.spec.nlevels == J.spec.nlevels
    assert [str(w.message) for w in ours] == [str(w.message) for w in theirs]
    assert any("length-" in str(w.message) for w in ours) == (levels > 1)
    assert [tuple(t.shape) for t in _leaves(W.coeffs)] == [t.shape for t in _leaves(J.coeffs)]


def test_facade_ndim1_flags_follow_jax():
    """Cycle spinning raises; do_separable=False warns and is ignored."""
    sig = _sig((2, 64))
    for cls in (Wavelets, JWavelets):
        kw = {"device": "cpu"} if cls is Wavelets else {}
        with pytest.raises(ValueError, match="cycle spinning is not implemented for 1D"):
            cls(sig, wname="db2", levels=1, ndim=1, do_cycle_spinning=True, **kw)
        with pytest.warns(UserWarning, match="ignoring do_separable"):
            W = cls(sig[0], wname="db2", levels=1, do_separable=False, **kw)
        assert W.spec.ndim == 1
    W = Wavelets(sig[0], wname="db2", levels=2, device="cpu")
    W.forward()
    W.set_image(sig[1])
    assert tuple(W.d_image.shape) == (1, 64)
    assert "ndim=1" in repr(W)
