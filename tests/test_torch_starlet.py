"""The port's starlet against the JAX package's, on the CPU (both run the
lowpass-only stationary conv passes: JAX its fma formulation): ``starlet``/
``istarlet`` for generations 1 and 2 over 1-3 trailing axes, batched,
float32 and float64; ``starlet_noise_gains``; ``starlet_denoise``;
``models.starlet_auto_denoise``; the ``Starlet`` facade; a gradient.

Tolerances, max|port - jax| relative to the largest |jax| value of one
output: float32 1e-5 (the passes' products and sums in one order, so
0 when this file was written), float64 1e-12; the noise gains equal; a
roundtrip against its input 1e-5 (float32) and 1e-12 (float64).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import Starlet as JStarlet
from pdwt_tpu import models as jmodels
from pdwt_tpu_torch import Starlet, core, models
from pdwt_tpu_torch.utils import tensor_to_numpy

# core/__init__ binds "starlet" to the function, in both packages
jst = importlib.import_module("pdwt_tpu.core.starlet")
st = importlib.import_module("pdwt_tpu_torch.core.starlet")

F32_RTOL, F64_RTOL = 1e-5, 1e-12


def _close(got, want, rtol):
    g = tensor_to_numpy(got).astype(np.float64) if isinstance(got, torch.Tensor) else got
    w = np.asarray(jnp.asarray(want).astype(jnp.float64))
    assert np.shape(g) == w.shape
    err = float(np.abs(g - w).max())
    assert err <= rtol * max(float(np.abs(w).max()), 1e-30), err


def _leaves(c):
    return [c.approx, *c.details]


@functools.lru_cache(maxsize=None)
def _jstarlet(levels, ndim, gen):
    return jax.jit(lambda x: jst.starlet(x, levels, ndim=ndim, gen=gen, backend="fma"))


CASES = [(gen, ndim, shape, dt) for gen in (1, 2) for ndim, shape, dt in (
    (1, (3, 97), np.float32), (2, (33, 40), np.float32), (2, (2, 16, 24), np.float64),
    (3, (6, 12, 10), np.float32), (1, (50,), np.float64))]


@pytest.mark.parametrize("gen,ndim,shape,dt", CASES)
def test_starlet_matches_jax_and_inverts(gen, ndim, shape, dt):
    x = np.random.default_rng(ndim).uniform(0, 255, shape).astype(dt)
    c = st.starlet(torch.from_numpy(x), 3, ndim=ndim, gen=gen)
    jc = _jstarlet(3, ndim, gen)(jnp.asarray(x))
    assert c.levels == 3 and all(t.dtype == torch.from_numpy(x).dtype for t in _leaves(c))
    rtol = F32_RTOL if dt == np.float32 else F64_RTOL
    for g, w in zip(_leaves(c), _leaves(jc)):
        _close(g, w, rtol)
    y = st.istarlet(c, ndim=ndim, gen=gen)
    _close(y, jst.istarlet(jc, ndim=ndim, gen=gen, backend="fma"), rtol)
    _close(y, x, rtol)


def test_noise_gains_equal_jax():
    for levels, ndim, gen in ((4, 2, 2), (3, 1, 1), (5, 3, 2), (2, 2, 1)):
        assert st.starlet_noise_gains(levels, ndim, gen) == jst.starlet_noise_gains(
            levels, ndim, gen)
    assert np.array_equal(st.B3_SPLINE, jst.B3_SPLINE) and core.B3_SPLINE is st.B3_SPLINE
    assert core.starlet is st.starlet and core.StarletCoeffs is st.StarletCoeffs


def test_errors_match_jax():
    x = torch.zeros(16, 16)
    for kw in (dict(gen=3), dict(ndim=4)):
        with pytest.raises(ValueError) as mine:
            st.starlet(x, 2, **kw)
        with pytest.raises(ValueError) as theirs:
            jst.starlet(jnp.zeros((16, 16)), 2, **kw)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="need 2 betas"):
        st.starlet_denoise(x, 2, [1.0])
    with pytest.raises(ValueError, match="need 2 k values"):
        models.starlet_auto_denoise(x, 2, k=[1.0, 2.0, 3.0])


def _noisy(shape, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(*(np.linspace(0, 3, n) for n in shape[-2:]), indexing="ij")
    return (80 * np.sin(yy) * np.cos(2 * xx) + 120 + rng.normal(0, 12, shape)).astype(np.float32)


@pytest.mark.parametrize("mode,beta", [("soft", 20.0), ("hard", [30.0, 10.0, 5.0])])
def test_starlet_denoise_matches_jax(mode, beta):
    x = _noisy((40, 36), 1)
    got = st.starlet_denoise(torch.from_numpy(x), 3, beta, mode=mode)
    want = jax.jit(lambda t: jst.starlet_denoise(t, 3, beta, mode=mode, backend="fma"))(
        jnp.asarray(x))
    _close(got, want, F32_RTOL)


@pytest.mark.parametrize("shape,ndim,gen,k", [((48, 40), 2, 2, 3.0), ((48, 40), 2, 1, 3.0),
                                              ((6, 20, 24), 3, 2, (4.0, 3.0, 3.0)),
                                              ((2, 128), 1, 2, 2.5)])
def test_starlet_auto_denoise_matches_jax(shape, ndim, gen, k):
    x = _noisy(shape, 2)
    got = models.starlet_auto_denoise(torch.from_numpy(x), 3, k=k, ndim=ndim, gen=gen)
    want = jax.jit(lambda t: jmodels.starlet_auto_denoise(t, 3, k=k, ndim=ndim, gen=gen,
                                                          backend="fma"))(jnp.asarray(x))
    assert got.dtype == torch.float32
    _close(got, want, F32_RTOL)


def test_starlet_facade_matches_jax():
    x = _noisy((32, 40), 3)
    S = Starlet(x, levels=3, device="cpu")
    J = JStarlet(x, levels=3, backend="fma")
    with pytest.raises(ValueError, match="forward"):
        S.inverse()
    for g, w in zip(_leaves(S.forward()), _leaves(J.forward())):
        _close(g, w, F32_RTOL)
    _close(S.inverse(), J.inverse(), F32_RTOL)
    _close(S.denoise(), J.denoise(), F32_RTOL)
    _close(S.denoise(k=[4.0, 3.0, 2.0], mode="hard"), J.denoise(k=[4.0, 3.0, 2.0], mode="hard"),
           F32_RTOL)
    V = Starlet(np.zeros((4, 8, 8), np.float32), levels=1, gen=1, device="cpu")
    assert V.ndim == 3 and V.gen == 1
    for kw, msg in ((dict(levels=0), "levels"), (dict(gen=3), "gen"), (dict(ndim=0), "ndim")):
        with pytest.raises(ValueError, match=msg):
            Starlet(x, device="cpu", **kw)


def test_gradient_matches_jax():
    x = _noisy((24, 32), 4)

    def jloss(t):
        c = jst.starlet(t, 2, backend="fma")
        return sum(jnp.sum(d * d) for d in c.details) + jnp.sum(jnp.sin(c.approx))

    t = torch.from_numpy(x).requires_grad_(True)
    c = st.starlet(t, 2)
    (g,) = torch.autograd.grad(sum((d * d).sum() for d in c.details) + torch.sin(c.approx).sum(),
                               t)
    _close(g, jax.jit(jax.grad(jloss))(jnp.asarray(x)), F32_RTOL)
