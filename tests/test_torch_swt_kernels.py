"""The plain versions of the port's two stationary (a-trous) kernels against
the JAX package's Pallas kernels (interpret mode, as the JAX tests run them
on the CPU), and the port's three autograd Functions against ``jax.vjp`` of
the JAX ``*_ad`` wrappers, d/dbeta of the fused denoise included.

Shapes respect the Pallas tile rules (rows a multiple of 8, columns a
multiple of 128) and stay small.  Tolerance: max|port - jax| <= 4e-6 *
max|jax| in float32 (the same taps in the same order; either side may
contract a multiply-add).  d/dbeta sums thousands of float32 terms in
another order, so it is held to 4e-6 * sum|terms|.  The CUDA kernels
themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import kernels as jk
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu.filters import make_custom_wavelet as jmake_custom_wavelet
from pdwt_tpu_torch.kernels import swt as S
from pdwt_tpu_torch.kernels import swt_matmul as SM
from pdwt_tpu_torch.kernels._launch import LAUNCHES, reset_launch_counts, rev
from pdwt_tpu_torch.utils import wavelet_from_arrays

RTOL = 4e-6
THRESHOLDS = [None, ("soft", 60.0), ("hard", 60.0), ("garrote", 60.0)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")


def _close(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        err = float(np.abs(g - w).max())
        assert err <= RTOL * float(np.abs(w).max()), err


def _rand(*shape, seed=0, lo=0.0, hi=255.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _pair(wname):
    """(JAX wavelet, port wavelet); "odd7" is an odd-length custom bank."""
    if wname == "odd7":
        jw = jmake_custom_wavelet("odd7", *np.random.default_rng(7).standard_normal((4, 7)))
    else:
        jw = jget_wavelet(wname)
    return jw, wavelet_from_arrays(jw)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("wname", ["db7", "sym8", "odd7"])
def test_swt_fwd_level_ref_matches_pallas(wname, level):
    jw, w = _pair(wname)
    x = _rand(2, 16, 128)
    want = jk.swt_fwd_level_2d(jnp.asarray(x), jw.dec_lo, jw.dec_hi, level)
    assert want is not None
    _close(S.swt_fwd_level_2d_ref(torch.from_numpy(x), w.dec_lo, w.dec_hi, level), want)


@pytest.mark.parametrize("threshold", THRESHOLDS, ids=["none", "soft", "hard", "garrote"])
@pytest.mark.parametrize("wname", ["db7", "sym8", "odd7"])
def test_swt_inv_level_ref_matches_pallas(wname, threshold):
    """Level 2 (dilation 2); beta 60 zeroes about half of the details."""
    jw, w = _pair(wname)
    bands = [_rand(1, 16, 128, seed=s, lo=-127.0, hi=127.0) for s in range(4)]
    want = jk.swt_inv_level_2d(*map(jnp.asarray, bands), jw.rec_lo, jw.rec_hi, 2,
                               threshold=threshold)
    assert want is not None
    got = S.swt_inv_level_2d_ref(*map(torch.from_numpy, bands), w.rec_lo, w.rec_hi, 2,
                                 threshold=threshold)
    _close([got], [want])


# ---------------------------------------------------------------------------
# autograd: the port's Functions against jax.vjp of the JAX *_ad wrappers
# ---------------------------------------------------------------------------

def _grads(outs, cts, inputs):
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts))
    return torch.autograd.grad(loss, inputs)


def _leaf(arr):
    return torch.from_numpy(arr).requires_grad_(True)


def test_swt_fwd_level_ad_matches_jax_vjp():
    jw, w = _pair("db7")
    x = _rand(1, 16, 128)
    cts = [_rand(1, 16, 128, seed=s, lo=-1.0, hi=1.0) for s in range(1, 5)]
    _, vjp = jax.vjp(lambda t: jk.swt_fwd_level_2d_ad(t, tuple(jw.dec_lo), tuple(jw.dec_hi), 2),
                     jnp.asarray(x))
    want = vjp(tuple(map(jnp.asarray, cts)))
    xt = _leaf(x)
    _close(_grads(S.swt_fwd_level_2d_ad(xt, w.dec_lo, w.dec_hi, 2), cts, [xt]), want)


def test_swt_inv_level_ad_matches_jax_vjp():
    jw, w = _pair("db7")
    bands = [_rand(1, 16, 128, seed=s, lo=-255.0) for s in range(4)]
    ct = _rand(1, 16, 128, seed=9, lo=-1.0, hi=1.0)
    _, vjp = jax.vjp(lambda *b: jk.swt_inv_level_2d_ad(*b, tuple(jw.rec_lo), tuple(jw.rec_hi), 2),
                     *map(jnp.asarray, bands))
    want = vjp(jnp.asarray(ct))
    leaves = [_leaf(b) for b in bands]
    _close(_grads([S.swt_inv_level_2d_ad(*leaves, w.rec_lo, w.rec_hi, 2)], [ct], leaves), want)


@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
def test_swt_inv_level_denoise_ad_matches_jax_vjp(mode):
    """Gradients for the four subbands and for beta (a tensor)."""
    jw, w = _pair("db7")
    bands = [_rand(1, 16, 128, seed=s, lo=-127.0, hi=127.0) for s in range(4)]
    beta = np.float32(60.0)
    ct = _rand(1, 16, 128, seed=9, lo=-1.0, hi=1.0)
    _, vjp = jax.vjp(lambda *b: jk.swt_inv_level_2d_denoise_ad(
        *b, tuple(jw.rec_lo), tuple(jw.rec_hi), 1, mode), *map(jnp.asarray, bands),
        jnp.asarray(beta))
    want = vjp(jnp.asarray(ct))
    leaves = [_leaf(b) for b in bands] + [torch.tensor(beta, requires_grad=True)]
    got = _grads([S.swt_inv_level_2d_denoise_ad(*leaves, w.rec_lo, w.rec_hi, 1, mode)], [ct],
                 leaves)
    _close(got[:4], want[:4])
    # d/dbeta: the bound is relative to the sum of the magnitudes it adds
    g_bands = S.swt_fwd_level_2d_ref(torch.from_numpy(ct), 0.5 * rev(w.rec_lo),
                                     0.5 * rev(w.rec_hi), 1)[1:]
    scale = 0.0
    for t, g in zip(bands[1:], g_bands):
        t = torch.from_numpy(t)
        dfdb = SM._thresh_vjp_factors(mode, t, torch.tensor(beta))[1]
        if dfdb is not None:
            scale += float(torch.where(t.abs() > 60.0, g * dfdb, 0.0).abs().sum())
    assert got[4].dtype == torch.float32 and got[4].shape == ()
    assert abs(float(got[4]) - float(want[4])) <= RTOL * max(scale, 1.0)
    if mode == "hard":
        assert float(got[4]) == float(want[4]) == 0.0


# ---------------------------------------------------------------------------
# port-only properties
# ---------------------------------------------------------------------------

def _grads_t(outs, cts, inputs):
    """Gradients of a linear loss; an input the loss does not reach (beta
    through the hard threshold) gets zeros."""
    gs = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cts)), inputs,
                             allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for g, t in zip(gs, inputs)]


@pytest.mark.parametrize("wname,shape,level", [("haar", (2, 8, 12), 2), ("db7", (1, 9, 13), 2),
                                               ("odd7", (2, 10, 6), 3), ("db2", (1, 8, 16), 4)])
def test_swt_backward_pairing_is_the_adjoint(wname, shape, level):
    """Each Function's backward (the paired kernel with reversed, rescaled
    taps) equals autograd through the plain version, in float64 (tolerance
    1e-12 relative), for even and odd filter lengths, odd sizes and a
    dilation larger than the image."""
    w = _pair(wname)[1]
    rng = np.random.default_rng(0)
    r = lambda: torch.from_numpy(rng.standard_normal(shape))

    def check(fn_ad, fn_ref, inputs, cts):
        for a, b in zip(_grads_t(fn_ad(*inputs), cts, inputs),
                        _grads_t(fn_ref(*inputs), cts, inputs)):
            assert float((a - b).abs().max()) <= 1e-12 * max(float(b.abs().max()), 1.0)

    x = r().requires_grad_(True)
    check(lambda t: S.swt_fwd_level_2d_ad(t, w.dec_lo, w.dec_hi, level),
          lambda t: S.swt_fwd_level_2d_ref(t, w.dec_lo, w.dec_hi, level), [x],
          [r() for _ in range(4)])
    bands = [r().requires_grad_(True) for _ in range(4)]
    check(lambda *b: [S.swt_inv_level_2d_ad(*b, w.rec_lo, w.rec_hi, level)],
          lambda *b: [S.swt_inv_level_2d_ref(*b, w.rec_lo, w.rec_hi, level)], bands, [r()])
    for mode in ("soft", "hard", "garrote"):
        beta = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
        check(lambda *b: [S.swt_inv_level_2d_denoise_ad(*b, w.rec_lo, w.rec_hi, level, mode)],
              lambda *b: [S.swt_inv_level_2d_ref(*b[:4], w.rec_lo, w.rec_hi, level,
                                                 threshold=(mode, b[4]))],
              bands + [beta], [r()])


def test_cpu_swt_wrappers_run_the_plain_versions_and_count_nothing():
    w = _pair("db3")[1]
    x = torch.from_numpy(_rand(2, 16, 24))
    reset_launch_counts()
    bands = S.swt_fwd_level_2d(x, w.dec_lo, w.dec_hi, 2)
    for got, want in zip(bands, S.swt_fwd_level_2d_ref(x, w.dec_lo, w.dec_hi, 2)):
        assert torch.equal(got, want)
    for thr in THRESHOLDS:
        assert torch.equal(S.swt_inv_level_2d(*bands, w.rec_lo, w.rec_hi, 2, threshold=thr),
                           S.swt_inv_level_2d_ref(*bands, w.rec_lo, w.rec_hi, 2, threshold=thr))
    assert set(LAUNCHES) >= {"swt_fwd_level_2d", "swt_inv_level_2d"}
    assert set(LAUNCHES.values()) == {0}


def test_swt_wrappers_refuse_what_they_do_not_take():
    w = _pair("db2")[1]
    with pytest.raises(ValueError, match="unsupported device"):
        S.swt_fwd_level_2d(torch.empty(1, 8, 8, device="meta"), w.dec_lo, w.dec_hi, 1)
    with pytest.raises(ValueError, match="level"):
        S.swt_fwd_level_2d(torch.zeros(1, 8, 8), w.dec_lo, w.dec_hi, 0)
    bands = [torch.zeros(1, 8, 8)] * 4
    with pytest.raises(ValueError, match="threshold mode"):
        S.swt_inv_level_2d(*bands, w.rec_lo, w.rec_hi, 1, threshold=("firm", 1.0))
