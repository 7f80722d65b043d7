"""The port's multi-level ``dwt2d``/``idwt2d`` against the JAX package's
(fma formulation) and against the vendored golden coefficients.

Inputs come from ``default_rng``; filters and coefficients cross between
the packages as numpy arrays (``utils.convert``).  Tolerances, relative to
max|ref|: 4e-6 in float32, 1e-12 in float64; golden.npz is held to 1e-10
absolute in float64, as ``tests/test_golden.py`` holds the JAX package.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu.core import separable as jsep
from pdwt_tpu.core.separable import Coeffs2D as JCoeffs2D
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu_torch import dwt2d, get_wavelet, idwt2d
from pdwt_tpu_torch.utils import coeffs2d_from_numpy, coeffs2d_to_numpy, wavelet_from_arrays

RTOL = {np.float32: 4e-6, np.float64: 1e-12}
GOLD = np.load(os.path.join(os.path.dirname(__file__), "golden", "golden.npz"))


def _leaves(c):
    a, dets = coeffs2d_to_numpy(c)
    return [a, *[t for band in dets for t in band]]


def _close(got, want, dt):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype == dt
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= RTOL[dt] * float(np.abs(w).max()), err


CASES = [("db7", (2, 37, 53), 3),       # odd sizes at every level
         ("sym8", (3, 1, 31, 29), 2),   # primes, two batch dimensions
         ("bior4.4", (2, 64, 48), 3),   # even: the CPU tail path
         ("haar", (1, 61, 67), 4),
         ("db2", (17, 19), 2)]          # no batch


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("wname,shape,levels", CASES)
def test_dwt2d_and_idwt2d_match_jax(wname, shape, levels, dt):
    jw = jget_wavelet(wname)
    w = wavelet_from_arrays(jw)
    x = np.random.default_rng(4).uniform(0, 255, shape).astype(dt)
    want = jax.jit(lambda t: jsep.dwt2d(t, jw, levels, backend="fma"))(x)
    got = dwt2d(torch.from_numpy(x), w, levels)
    assert got.levels == levels
    _close(_leaves(got), _leaves(want), dt)

    # the inverse of the same (JAX) coefficients on both sides
    a, dets = coeffs2d_to_numpy(want)
    want_y = jax.jit(lambda c: jsep.idwt2d(c, jw, shape[-2:], backend="fma"))(want)
    got_y = idwt2d(coeffs2d_from_numpy(a, dets), w, shape[-2:])
    _close([got_y.numpy()], [want_y], dt)
    assert float(np.abs(got_y.numpy().astype(np.float64) - x).max()) < (
        1e-3 if dt == np.float32 else 1e-9)


@pytest.mark.parametrize("wname", ["haar", "db2", "db7", "bior4.4", "db3", "sym8"])
def test_dwt2d_matches_golden(wname):
    x = torch.from_numpy(GOLD[f"dwt2d/{wname}/x"])
    levels = int(GOLD[f"dwt2d/{wname}/levels"])
    c = dwt2d(x, get_wavelet(wname), levels)
    want = [GOLD[f"dwt2d/{wname}/a"]] + [GOLD[f"dwt2d/{wname}/L{l}/{b}"]
                                        for l in range(1, levels + 1) for b in "hvd"]
    for g, w in zip(_leaves(c), want):
        assert g.dtype == np.float64
        assert float(np.abs(g - w).max()) < 1e-10


@pytest.mark.parametrize("wname,m", [("db7", 16), ("bior4.4", 12), ("haar", 8)])
def test_idwt2d_matches_golden(wname, m):
    g = lambda k: GOLD[f"idwt2d/{wname}/{k}"]
    y = idwt2d(coeffs2d_from_numpy(g("a"), [(g("h"), g("v"), g("d"))]),
               get_wavelet(wname), (2 * m, 2 * m))
    assert float(np.abs(y.numpy() - g("y")).max()) < 1e-10


@pytest.mark.parametrize("shape,levels", [((2, 21, 34), 3), ((32, 64), 3)])
def test_gradients_match_jax(shape, levels):
    """Gradients of a linear loss through dwt2d and through idwt2d (the
    autograd Functions on the CPU) against jax.vjp of the fma path, float64."""
    jw = jget_wavelet("db3")
    w = wavelet_from_arrays(jw)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape)
    fwd = lambda t: jsep.dwt2d(t, jw, levels, backend="fma")
    inv = lambda cc: jsep.idwt2d(cc, jw, shape[-2:], backend="fma")
    c = jax.jit(fwd)(x)
    cts = jax.tree_util.tree_map(lambda t: jnp.asarray(rng.standard_normal(t.shape)), c)
    (want,) = jax.jit(lambda t, ct: jax.vjp(fwd, t)[1](ct))(x, cts)
    xt = torch.from_numpy(x).requires_grad_(True)
    ct_np = _leaves(cts)
    loss = sum((t * torch.tensor(ct)).sum()
               for t, ct in zip(_torch_leaves(dwt2d(xt, w, levels)), ct_np))
    (got,) = torch.autograd.grad(loss, xt)
    _close([got.numpy()], [want], np.float64)

    ct_y = rng.standard_normal(shape)
    (want_c,) = jax.jit(lambda cc, ct: jax.vjp(inv, cc)[1](ct))(c, ct_y)
    a, dets = coeffs2d_to_numpy(c)
    ct = coeffs2d_from_numpy(a, dets)
    leaves = [t.requires_grad_(True) for t in _torch_leaves(ct)]
    ct = ct._replace(approx=leaves[0],
                     details=tuple(tuple(leaves[1 + 3 * i:4 + 3 * i]) for i in range(levels)))
    loss = (idwt2d(ct, w, shape[-2:]) * torch.from_numpy(ct_y)).sum()
    got_c = torch.autograd.grad(loss, leaves)
    _close([t.numpy() for t in got_c], _leaves(want_c), np.float64)


def _torch_leaves(c):
    return [c.approx, *[t for band in c.details for t in band]]


def test_jax_coeffs_structure_carries_over():
    """coeffs2d_from_numpy takes the JAX Coeffs2D's leaves as they are."""
    jw = jget_wavelet("db2")
    c = jax.jit(lambda t: jsep.dwt2d(t, jw, 2, backend="fma"))(np.zeros((8, 8), np.float32))
    assert isinstance(c, JCoeffs2D)
    a, dets = coeffs2d_to_numpy(c)
    tc = coeffs2d_from_numpy(a, dets)
    assert tc.approx.dtype == torch.float32 and tc.levels == 2
    assert [tuple(t.shape) for t in _torch_leaves(tc)] == [t.shape for t in _leaves(c)]


def test_dwt2d_rejects_what_this_slice_lacks():
    """The boundary modes are ported: a mode and a per-axis tuple give JAX's
    fma coefficients and invert; an unknown mode, a wrong number of modes,
    integer input and 1D input are refused."""
    jw = jget_wavelet("db2")
    w = wavelet_from_arrays(jw)
    x = np.random.default_rng(3).uniform(0, 255, (9, 8)).astype(np.float32)
    for mode in ("symmetric", ("periodization", "zero")):
        got = dwt2d(torch.from_numpy(x), w, 1, mode=mode)
        want = jax.jit(lambda t: jsep.dwt2d(t, jw, 1, mode=mode, backend="fma"))(x)
        _close(_leaves(got), _leaves(want), np.float32)
        y = idwt2d(got, w, (9, 8), mode=mode)
        assert float((y - torch.from_numpy(x)).abs().max()) <= 1e-3
    with pytest.raises(ValueError, match="unknown boundary mode"):
        dwt2d(torch.from_numpy(x), w, 1, mode="symmetri")
    with pytest.raises(ValueError, match="expected 2 boundary modes"):
        idwt2d(dwt2d(torch.from_numpy(x), w, 1), w, (9, 8), mode=("zero",))
    x = torch.zeros(8, 8)
    with pytest.raises(TypeError, match="float32 or float64"):
        dwt2d(x.to(torch.int64), w, 1)
    with pytest.raises(ValueError, match="at least 2D"):
        dwt2d(torch.zeros(8), w, 1)
    # the per-axis tuple form of periodization is periodization
    c = dwt2d(x, w, 1, mode=("periodization", "periodization"))
    assert tuple(c.approx.shape) == (4, 4)
