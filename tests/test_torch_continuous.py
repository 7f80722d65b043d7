"""The port's continuous wavelet transform (``core/continuous.py``) against
the JAX package's on the CPU.

Inputs are made from a seed with numpy.  ``tests/conftest.py`` turns on
JAX's x64, so both sides' dtypes are pinned: float32 inputs, complex64
scaleograms for ``morlet``, ``paul`` and ``cwt2d``, float32 for ``ricker``
and ``icwt``.  Both multiply the same float32 scale bank (built in float64
numpy) against the FFT of the signal, so the transforms agree to float32
FFT roundoff: max|port - jax| <= 2e-5 * max|W|.  The scale helpers are
numpy on both sides and agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu.core import continuous as jC
from pdwt_tpu_torch.core import continuous as C

RTOL = 2e-5
MOTHERS = ("morlet", "ricker", "paul")
DTYPES = {"morlet": "complex64", "ricker": "float32", "paul": "complex64"}


def _sig(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == want.dtype.name == dtype
    assert tuple(got.shape) == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= RTOL * scale


@pytest.mark.parametrize("mother", MOTHERS)
@pytest.mark.parametrize("shape,dt", [((3, 256), 1.0), ((2, 2, 150), 0.25), ((97,), 1.0)],
                         ids=["batch256", "batch2x2_150_dt", "prime97"])
def test_cwt_and_icwt_match_jax(mother, shape, dt):
    x = _sig(shape, seed=len(shape))
    n = shape[-1]
    scales = jC.log_scales(n, dt, dj=0.25)
    want = jax.jit(lambda v: jC.cwt(v, scales, mother, dt=dt))(jnp.asarray(x))
    got = C.cwt(torch.from_numpy(x), scales, mother, dt=dt)
    _close(got, want, DTYPES[mother])
    jback = jax.jit(lambda w: jC.icwt(w, scales, mother, dt=dt, dj=0.25))(want)
    back = C.icwt(got, scales, mother, dt=dt, dj=0.25)
    _close(back, jback, "float32")


@pytest.mark.parametrize("thetas", [None, (0.0, 0.3, 1.2)], ids=["four_default", "three"])
@pytest.mark.parametrize("sigma", [1.0, 0.6])
def test_cwt2d_matches_jax(thetas, sigma):
    x = _sig((2, 24, 40), seed=5)
    scales = (2.0, 4.0, 8.0)
    want = jax.jit(lambda v: jC.cwt2d(v, scales, thetas, sigma=sigma))(jnp.asarray(x))
    _close(C.cwt2d(torch.from_numpy(x), scales, thetas, sigma=sigma), want, "complex64")


def test_custom_scales_and_float64_input_are_float32_computations():
    """A float64 input is cast to float32 first on both sides."""
    x = np.random.default_rng(7).standard_normal((2, 64))
    scales = np.array([1.5, 3.0, 7.0])
    want = jC.cwt(jnp.asarray(x), scales, "paul")
    _close(C.cwt(torch.from_numpy(x), scales, "paul"), want, "complex64")


def test_the_bank_is_cached_per_device():
    x = torch.from_numpy(_sig((64,)))
    C.cwt(x, (2.0, 4.0))
    before = C._bank.cache_info().hits
    C.cwt(x, (2.0, 4.0))
    assert C._bank.cache_info().hits == before + 1


@pytest.mark.parametrize("mother", MOTHERS)
def test_scale_helpers_are_numpy_exact(mother):
    assert np.array_equal(C.log_scales(4096, dj=0.25), jC.log_scales(4096, dj=0.25))
    assert np.array_equal(C.log_scales(300, 0.5, dj=0.1, s0=1.0, j1=20),
                          jC.log_scales(300, 0.5, dj=0.1, s0=1.0, j1=20))
    s = C.log_scales(512)
    assert np.array_equal(C.fourier_wavelength(mother, s), jC.fourier_wavelength(mother, s))
    for n, dt in ((128, 1.0), (77, 0.3)):
        assert np.array_equal(C.cone_of_influence(n, dt, mother),
                              jC.cone_of_influence(n, dt, mother))


def _msg(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


@pytest.mark.parametrize("call", [
    lambda m, x: m.cwt(x, [], "morlet"),
    lambda m, x: m.cwt(x, [1.0, -2.0], "morlet"),
    lambda m, x: m.cwt(x, [[1.0, 2.0]], "morlet"),
    lambda m, x: m.cwt(x, [1.0, 2.0], "haar"),
    lambda m, x: m.cwt2d(x, [0.0]),
    lambda m, x: m.fourier_wavelength("dog", [1.0]),
    lambda m, x: m.cone_of_influence(16, 1.0, "dog"),
], ids=["empty", "negative", "2d_scales", "unknown_mother", "zero_scale_2d",
        "wavelength_unknown", "coi_unknown"])
def test_errors_are_jaxs(call):
    x = _sig((4, 16))
    want = _msg(lambda: call(jC, jnp.asarray(x)))
    assert _msg(lambda: call(C, torch.from_numpy(x))) == want != "no error"
