"""The port's TI-denoise slice against the JAX package: ``swt2d``,
``iswt2d``, ``iswt2d_denoise``, ``garrote_threshold``,
``thresholded_norm1``, ``denoise_step(swt=True)`` and the ``Wavelets``
facade with ``do_swt=True`` (``run_denoise`` included).

JAX runs its ``backend="fma"`` path, the formulation the port's plain
path follows; inputs come from ``default_rng`` and cross as numpy arrays.
Tolerances, relative to the largest magnitude of the compared tensors
(of the whole coefficient tree, since at a dilation as large as the image
the row high-pass sums its taps over one row and H and D are roundoff):
4e-6 in float32 (the same taps in the same order; either side may contract
a multiply-add), 1e-12 in float64; norms, which sum thousands of terms in
another order, 1e-5 in float32.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import Wavelets as JWavelets
from pdwt_tpu import ops as jops
from pdwt_tpu.core import separable as jsep
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu.models.denoiser import denoise_step as jdenoise_step
from pdwt_tpu_torch import Wavelets, iswt2d, iswt2d_denoise, ops, swt2d
from pdwt_tpu_torch.models import denoise_step
from pdwt_tpu_torch.utils import coeffs2d_from_numpy, coeffs2d_to_numpy, wavelet_from_arrays

RTOL = {np.float32: 4e-6, np.float64: 1e-12}
NORM_RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _leaves(c):
    a, dets = coeffs2d_to_numpy(c)
    return [a, *[t for band in dets for t in band]]


def _close(got, want, dt):
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
    jw = jget_wavelet(wname)
    return jw, wavelet_from_arrays(jw)


def _img(shape, dt=np.float32, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(dt)


CASES = [("db7", (2, 37, 53), 2),       # odd sizes
         ("sym8", (3, 1, 31, 29), 2),   # primes, two batch dimensions
         ("db2", (8, 16), 4),           # dilation 8: support 25 > 8 rows
         ("haar", (1, 61, 67), 3),
         ("bior4.4", (2, 24, 40), 3)]


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("wname,shape,levels", CASES)
def test_swt2d_and_iswt2d_match_jax(wname, shape, levels, dt):
    jw, w = _pair(wname)
    x = _img(shape, dt, seed=4)
    want = jax.jit(lambda t: jsep.swt2d(t, jw, levels, backend="fma"))(x)
    got = swt2d(torch.from_numpy(x), w, levels)
    assert got.levels == levels and tuple(got.approx.shape) == shape
    _close(_leaves(got), _leaves(want), dt)

    # the inverse of the same (JAX) coefficients on both sides
    want_y = jax.jit(lambda c: jsep.iswt2d(c, jw, backend="fma"))(want)
    got_y = iswt2d(coeffs2d_from_numpy(*coeffs2d_to_numpy(want)), w)
    _close(got_y, want_y, dt)
    assert float(np.abs(got_y.numpy().astype(np.float64) - x).max()) < (
        1e-3 if dt == np.float32 else 1e-9)


def test_swt2d_keep_approx_matches_jax():
    jw, w = _pair("db3")
    x = _img((2, 20, 24), seed=1)
    c, approxs = jax.jit(lambda t: jsep.swt2d(t, jw, 3, backend="fma", keep_approx=True))(x)
    got_c, got_a = swt2d(torch.from_numpy(x), w, 3, keep_approx=True)
    assert len(got_a) == 3 and torch.equal(got_a[-1], got_c.approx)
    _close(list(got_a), [np.asarray(a) for a in approxs], np.float32)
    _close(_leaves(got_c), _leaves(c), np.float32)


DENOISE = [("soft", False, False, 20.0), ("hard", True, False, 20.0),
           ("garrote", True, True, 20.0), ("soft", True, True, 20.0),
           ("hard", False, True, [40.0, 30.0, 20.0]),                      # per level
           ("garrote", False, False, [[40.0, 35.0, 30.0]] * 3)]             # per band


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("mode,normalize,app,beta", DENOISE)
def test_iswt2d_denoise_matches_jax(mode, normalize, app, beta, dt):
    """On the same (JAX) coefficients, so the hard and garrote masks see the
    same values on both sides."""
    jw, w = _pair("db4")
    x = _img((2, 30, 36), dt, seed=2)
    c = jax.jit(lambda t: jsep.swt2d(t, jw, 3, backend="fma"))(x)
    kw = dict(mode=mode, normalize=normalize, do_thresh_appcoeffs=app)
    want = jax.jit(lambda cc: jsep.iswt2d_denoise(cc, jw, beta, backend="fma", **kw))(c)
    got = iswt2d_denoise(coeffs2d_from_numpy(*coeffs2d_to_numpy(c)), w, beta, **kw)
    _close(got, want, dt)


@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
@pytest.mark.parametrize("normalize", [False, True])
def test_fused_denoise_equals_threshold_then_iswt2d(mode, normalize):
    """The port's own identities: the fused inverse equals the threshold op
    followed by iswt2d, and thresholded_norm1 equals norm1 of the
    thresholded tree (to 1e-6 relative, the bound of tests/test_swt.py)."""
    w = _pair("db4")[1]
    c = swt2d(torch.from_numpy(_img((1, 32, 40), seed=3)), w, 3)
    thr = {"soft": ops.soft_threshold, "hard": ops.hard_threshold,
           "garrote": ops.garrote_threshold}[mode]
    ct = thr(c, 30.0, normalize=normalize)
    assert torch.equal(iswt2d_denoise(c, w, 30.0, mode=mode, normalize=normalize),
                       iswt2d(ct, w))
    n_ref = float(ops.norm1(ct))
    n_fast = float(ops.thresholded_norm1(c, 30.0, mode=mode, normalize=normalize))
    assert abs(n_fast - n_ref) <= 1e-6 * n_ref


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("mode,normalize,app,beta", DENOISE)
def test_garrote_and_thresholded_norm1_match_jax(mode, normalize, app, beta, dt):
    jw, w = _pair("db4")
    c = jax.jit(lambda t: jsep.swt2d(t, jw, 3, backend="fma"))(_img((1, 24, 32), dt, seed=5))
    tc = coeffs2d_from_numpy(*coeffs2d_to_numpy(c))
    kw = dict(normalize=normalize, do_thresh_appcoeffs=app)
    j_thr, j_n1 = jax.jit(lambda cc: (jops.garrote_threshold(cc, beta, **kw),
                                      jops.thresholded_norm1(cc, beta, mode=mode, **kw)))(c)
    _close(_leaves(ops.garrote_threshold(tc, beta, **kw)), _leaves(j_thr), dt)
    want = float(j_n1)
    got = ops.thresholded_norm1(tc, beta, mode=mode, **kw)
    assert got.dtype == torch.from_numpy(np.zeros(1, dt)).dtype
    assert abs(float(got) - want) <= NORM_RTOL[dt] * abs(want)


@pytest.mark.parametrize("mode,normalize,beta", [("soft", False, 15.0), ("hard", True, 15.0),
                                                 ("garrote", False, 15.0),
                                                 ("soft", True, [30.0, 20.0, 10.0])])
def test_denoise_step_swt_matches_jax(mode, normalize, beta):
    """Scalar beta takes the fused path on both sides; a sequence the
    threshold-then-inverse path."""
    img = _img((50, 64), seed=6)
    j_out, j_n1 = jax.jit(lambda x: jdenoise_step(x, None, "db4", 3, beta, swt=True, mode=mode,
                                                  normalize=normalize, backend="fma"))(img)
    out, n1 = denoise_step(torch.from_numpy(img), None, "db4", 3, beta, swt=True, mode=mode,
                           normalize=normalize)
    _close(out, j_out, np.float32)
    assert abs(float(n1) - float(j_n1)) <= NORM_RTOL[np.float32] * abs(float(j_n1))


@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
def test_swt_facade_matches_jax(mode):
    """forward, the threshold, norm1, norm2sq and inverse with do_swt=True."""
    img = _img((40, 56), seed=7)
    W = Wavelets(img, wname="db3", levels=3, do_swt=True, device="cpu")
    J = JWavelets(img, wname="db3", levels=3, do_swt=True, backend="fma")
    assert W.spec.nlevels == J.spec.nlevels == 3
    assert [tuple(t.shape) for t in _torch_leaves(W.coeffs)] == [t.shape for t in
                                                                   _leaves(J.coeffs)]
    _close(_leaves(W.forward()), _leaves(J.forward()), np.float32)
    assert np.isclose(W.norm2sq(), J.norm2sq(), rtol=NORM_RTOL[np.float32], atol=0)
    getattr(W, f"{mode}_threshold")(12.0, normalize=True)
    getattr(J, f"{mode}_threshold")(12.0, normalize=True)
    _close(_leaves(W.coeffs), _leaves(J.coeffs), np.float32)
    assert np.isclose(W.norm1(), J.norm1(), rtol=NORM_RTOL[np.float32], atol=0)
    _close(W.inverse(), J.inverse(), np.float32)


def _torch_leaves(c):
    return [c.approx, *[t for band in c.details for t in band]]


@pytest.mark.parametrize("do_swt,spin,mode,app", [(True, False, "soft", False),
                                                  (True, True, "garrote", True),
                                                  (True, True, "hard", False),
                                                  (False, True, "soft", True)])
def test_run_denoise_matches_jax(do_swt, spin, mode, app):
    """The same seed draws the same cycle-spinning shifts; the facade's
    image and coefficients stay as they were."""
    img = _img((36, 44), seed=8)
    kw = dict(wname="db2", levels=2, do_swt=do_swt, do_cycle_spinning=spin, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        W = Wavelets(img, device="cpu", **kw)
        J = JWavelets(img, backend="fma", **kw)
    for _ in range(2):
        out, n1 = W.run_denoise(10.0, mode=mode, do_thresh_appcoeffs=app, normalize=True)
        j_out, j_n1 = J.run_denoise(10.0, mode=mode, do_thresh_appcoeffs=app, normalize=True)
        _close(out, j_out, np.float32)
        assert abs(float(n1) - float(j_n1)) <= NORM_RTOL[np.float32] * abs(float(j_n1))
    assert W.state.value == "W_INIT" and np.array_equal(W.get_image(), img)


def test_swt_facade_warns_like_jax_on_cycle_spinning():
    with warnings.catch_warnings(record=True) as ours:
        warnings.simplefilter("always")
        Wavelets(nr=64, nc=64, wname="db7", levels=9, do_swt=True, do_cycle_spinning=True,
                 device="cpu")
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        JWavelets(nr=64, nc=64, wname="db7", levels=9, do_swt=True, do_cycle_spinning=True)
    assert [str(w.message) for w in ours] == [str(w.message) for w in theirs]
    assert len(ours) == 2


@pytest.mark.parametrize("mode", ["soft", "garrote"])
def test_denoise_gradients_match_jax(mode):
    """Gradients of a linear loss through swt2d and iswt2d_denoise (the
    autograd Functions on the CPU) against jax.vjp of the fma path, with
    respect to the image and to beta, in float64."""
    jw, w = _pair("db3")
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 255, (2, 20, 28))
    ct = rng.standard_normal(x.shape)
    fn = lambda t, b: jsep.iswt2d_denoise(jsep.swt2d(t, jw, 2, backend="fma"), jw, b,
                                          mode=mode, normalize=True, backend="fma")
    want_x, want_b = jax.jit(lambda t, b, c: jax.vjp(fn, t, b)[1](c))(x, jnp.float64(25.0), ct)
    xt = torch.from_numpy(x).requires_grad_(True)
    bt = torch.tensor(25.0, dtype=torch.float64, requires_grad=True)
    y = iswt2d_denoise(swt2d(xt, w, 2), w, bt, mode=mode, normalize=True)
    got_x, got_b = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), [xt, bt])
    _close(got_x, want_x, np.float64)
    assert abs(float(got_b) - float(want_b)) <= 1e-9 * abs(float(want_b))
