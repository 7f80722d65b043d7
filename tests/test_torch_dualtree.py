"""The port's dual-tree complex wavelet transform against the JAX
package's, on the CPU (the port's kernel wrappers run their plain
versions, JAX its fma path): the filter design bit for bit, ``dtcwt1d``/
``dtcwt2d`` and their inverses at 1-3 levels, batched, float32 and
float64, the dtypes, ``dtcwt_denoise``, ``dtcwt_auto_denoise``, the
size refusal, the ``DualTree`` facade and a gradient.

JAX runs this file with x64 on, so its ``/ np.sqrt(2)`` (a float64 numpy
scalar) gives complex128 from float32 data; the port gives complex64, as
JAX does without x64.  Values are compared in float64.  Tolerances,
max|port - jax| relative to the largest |jax| value of one output (the
real and imaginary parts each): float32 1e-5, float64 1e-12.  The
magnitude threshold is ``thr(|z|) * exp(i angle(z))`` on both sides
(``torch.polar`` would differ in the last ulp).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import DualTree as JDualTree
from pdwt_tpu.core import dualtree as jdt
from pdwt_tpu_torch import DualTree
from pdwt_tpu_torch.core import dualtree as dt
from pdwt_tpu_torch.utils import tensor_to_numpy

F32_RTOL, F64_RTOL = 1e-5, 1e-12


def _parts(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.is_complex():
            return [tensor_to_numpy(t.real).astype(np.float64),
                    tensor_to_numpy(t.imag).astype(np.float64)]
        return [tensor_to_numpy(t).astype(np.float64)]
    t = np.asarray(t)
    if np.iscomplexobj(t):
        return [t.real.astype(np.float64), t.imag.astype(np.float64)]
    return [t.astype(np.float64)]


def _close(got, want, rtol):
    for g, w in zip(_parts(got), _parts(want), strict=True):
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert err <= rtol * max(float(np.abs(w).max()), 1e-30), err


def _leaves(c):
    return [c.approx, *c.details]


def test_banks_equal_jax_bit_for_bit():
    for order in ((2, 4), (4, 4), (2, 6)):
        for a, b in zip(dt.design_dtcwt_banks(*order), jdt.design_dtcwt_banks(*order)):
            assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b)
        for w, jw in zip(dt.dtcwt_wavelets(*order), jdt.dtcwt_wavelets(*order)):
            assert w.name == jw.name
            for f in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
                assert np.array_equal(getattr(w, f), getattr(jw, f)), f
    np.testing.assert_array_equal(dt._thiran_half(3), jdt._thiran_half(3))
    with pytest.raises(ValueError, match="L must be even"):
        dt.dtcwt_wavelets(3, 4)


@functools.lru_cache(maxsize=None)
def _jfwd(nd, levels):
    fwd = jdt.dtcwt2d if nd == 2 else jdt.dtcwt1d
    return jax.jit(lambda x: fwd(x, levels, backend="fma"))


CASES = [(2, (32, 48), 1, np.float32), (2, (32, 48), 3, np.float32),
         (2, (2, 16, 24), 2, np.float64), (1, (3, 64), 3, np.float32),
         (1, (40,), 2, np.float64)]


@pytest.mark.parametrize("nd,shape,levels,dt_", CASES)
def test_dtcwt_matches_jax_and_inverts(nd, shape, levels, dt_):
    x = np.random.default_rng(levels).uniform(0, 255, shape).astype(dt_)
    fwd, inv = (dt.dtcwt2d, dt.idtcwt2d) if nd == 2 else (dt.dtcwt1d, dt.idtcwt1d)
    jinv = jdt.idtcwt2d if nd == 2 else jdt.idtcwt1d
    c = fwd(torch.from_numpy(x), levels)
    jc = _jfwd(nd, levels)(jnp.asarray(x))
    cplx = torch.complex64 if dt_ == np.float32 else torch.complex128
    assert c.levels == levels and c.approx.dtype == torch.from_numpy(x).dtype
    assert all(d.dtype == cplx for d in c.details)
    assert c.approx.shape[0] == 2 * nd and (nd == 1 or c.details[0].shape[-3] == 6)
    rtol = F32_RTOL if dt_ == np.float32 else F64_RTOL
    for g, w in zip(_leaves(c), _leaves(jc)):
        _close(g, w, rtol)
    size = tuple(shape[-2:]) if nd == 2 else shape[-1]
    y = inv(c, size)
    _close(y, jax.jit(lambda t: jinv(t, size, backend="fma"))(jc), rtol)
    _close(y, x, rtol)


def test_bf16_mixes_in_float32():
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (16, 16)).astype(np.float32))
    c = dt.dtcwt2d(x.bfloat16(), 2)
    assert c.approx.dtype == torch.float32 and c.details[0].dtype == torch.complex64
    z = dt._cplx(torch.ones(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64))
    assert z.dtype == torch.complex128


def test_size_refusals_match_jax():
    for fwd, jfwd, shape in ((dt.dtcwt1d, jdt.dtcwt1d, (100,)),
                             (dt.dtcwt2d, jdt.dtcwt2d, (32, 36))):
        with pytest.raises(ValueError) as mine:
            fwd(torch.zeros(shape), 3)
        with pytest.raises(ValueError) as theirs:
            jfwd(jnp.zeros(shape), 3)
        assert str(mine.value) == str(theirs.value)


def _noisy(shape, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, shape[-1])
    clean = 50 * np.sin(t) * (np.cos(np.linspace(0, 4 * np.pi, shape[0]))[:, None]
                              if len(shape) == 2 else 1.0)
    return (clean + rng.normal(0, 10, shape)).astype(np.float32)


@pytest.mark.parametrize("shape,beta,mode", [((32, 48), 25.0, "soft"),
                                             ((32, 48), [30.0, 20.0, 10.0], "hard"),
                                             ((64,), 15.0, "garrote")])
def test_dtcwt_denoise_matches_jax(shape, beta, mode):
    x = _noisy(shape, 1)
    got = dt.dtcwt_denoise(torch.from_numpy(x), 3, beta, mode=mode)
    want = jax.jit(lambda t: jdt.dtcwt_denoise(t, 3, beta, mode=mode, backend="fma"))(
        jnp.asarray(x))
    _close(got, want, F32_RTOL)


@pytest.mark.parametrize("shape,k", [((32, 48), 3.0), ((64,), (4.0, 3.0, 2.0))])
def test_dtcwt_auto_denoise_matches_jax(shape, k):
    x = _noisy(shape, 2)
    got = dt.dtcwt_auto_denoise(torch.from_numpy(x), 3, k=k)
    want = jax.jit(lambda t: jdt.dtcwt_auto_denoise(t, 3, k=k, backend="fma"))(jnp.asarray(x))
    assert got.dtype == torch.float32
    _close(got, want, F32_RTOL)
    with pytest.raises(ValueError, match="need 3 k values"):
        dt.dtcwt_auto_denoise(torch.from_numpy(x), 3, k=[1.0])
    with pytest.raises(ValueError, match="need 3 betas"):
        dt.dtcwt_denoise(torch.from_numpy(x), 3, [1.0])


def test_magnitude_threshold_keeps_zero_and_phase():
    z = torch.tensor([0j, 3 + 4j, -1e-3j], dtype=torch.complex64)
    from pdwt_tpu_torch.ops.threshold import THR_ELEM

    out = dt._magnitude_threshold(z, THR_ELEM["soft"], 1.0)
    assert out[0] == 0 and torch.isfinite(torch.view_as_real(out)).all()
    assert torch.allclose(out[1], torch.tensor(2.4 + 3.2j, dtype=torch.complex64))
    assert out[2] == 0


def test_dualtree_facade_matches_jax():
    x = _noisy((32, 32), 3)
    D = DualTree(x, levels=3, device="cpu")
    J = JDualTree(x, levels=3, backend="fma")
    for fn in (D.inverse, D.magnitudes):
        with pytest.raises(ValueError, match="forward"):
            fn()
    for g, w in zip(_leaves(D.forward()), _leaves(J.forward())):
        _close(g, w, F32_RTOL)
    for g, w in zip(D.magnitudes(), J.magnitudes()):
        _close(g, w, F32_RTOL)
    _close(D.inverse(), J.inverse(), F32_RTOL)
    _close(D.denoise(), J.denoise(), F32_RTOL)
    S = DualTree(x[0], levels=2, device="cpu")
    _close(S.denoise(k=2.0, mode="hard"),
           JDualTree(x[0], levels=2, backend="fma").denoise(k=2.0, mode="hard"), F32_RTOL)
    with pytest.raises(ValueError) as mine:
        DualTree(np.zeros((2, 8, 8), np.float32), device="cpu")
    with pytest.raises(ValueError) as theirs:
        JDualTree(np.zeros((2, 8, 8), np.float32))
    assert str(mine.value).replace("torch.Size", "") == str(theirs.value)
    with pytest.raises(ValueError, match="levels"):
        DualTree(x, levels=0, device="cpu")


def test_gradient_matches_jax():
    x = _noisy((32, 32), 4)
    jloss = lambda t: jnp.sum(jdt.dtcwt_denoise(t, 2, 20.0, backend="fma") ** 2)
    t = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad((dt.dtcwt_denoise(t, 2, 20.0) ** 2).sum(), t)
    assert bool(torch.isfinite(g).all())
    _close(g, jax.jit(jax.grad(jloss))(jnp.asarray(x)), F32_RTOL)
