"""The plain versions of the port's four batched 1D kernels against the JAX
package's Pallas kernels (interpret mode, as the JAX tests run them on the
CPU), an odd-length bank against JAX's fma path (the JAX 1D kernels refuse
odd filter lengths), and the port's four autograd Functions against
``jax.vjp`` of the JAX ``*_ad`` wrappers.

Shapes respect the Pallas tile rules (a batch of 8, lengths a multiple of
128) and stay small.  Tolerance: max|port - jax| <= 4e-6 * max|jax| in
float32 (the same taps in the same order; either side may contract a
multiply-add); the adjoint pairing is checked in float64 to 1e-12.  The
CUDA kernels themselves are held to these plain versions on the card
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
from pdwt_tpu.kernels import swt_pallas as jsp
from pdwt_tpu_torch.kernels import _build
from pdwt_tpu_torch.kernels import batched1d as K1
from pdwt_tpu_torch.kernels._launch import LAUNCHES, launch, reset_launch_counts
from pdwt_tpu_torch.utils import wavelet_from_arrays

RTOL = 4e-6
B, N = 8, 256


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")


def _close(got, want):
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
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


def _bands(m, seed=1):
    return [_rand(B, m, seed=seed + s, lo=-127.0, hi=127.0) for s in range(2)]


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wname", ["db7", "sym8"])
def test_fwd_level_1d_ref_matches_pallas(wname):
    jw, w = _pair(wname)
    x = _rand(B, N)
    want = jk.fwd_level_1d(jnp.asarray(x), jw.dec_lo, jw.dec_hi)
    assert want is not None
    _close(K1.fwd_level_1d_ref(torch.from_numpy(x), w.dec_lo, w.dec_hi), want)


@pytest.mark.parametrize("wname", ["db7", "sym8"])
def test_inv_level_1d_ref_matches_pallas(wname):
    jw, w = _pair(wname)
    lo, hi = _bands(N // 2)
    want = jk.inv_level_1d(jnp.asarray(lo), jnp.asarray(hi), jw.rec_lo, jw.rec_hi)
    assert want is not None
    _close(K1.inv_level_1d_ref(torch.from_numpy(lo), torch.from_numpy(hi), w.rec_lo, w.rec_hi),
           want)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("wname", ["db7", "sym8"])
def test_swt_fwd_level_1d_ref_matches_pallas(wname, level):
    jw, w = _pair(wname)
    x = _rand(B, N, seed=2)
    want = jk.swt_fwd_level_1d(jnp.asarray(x), jw.dec_lo, jw.dec_hi, level)
    assert want is not None
    _close(K1.swt_fwd_level_1d_ref(torch.from_numpy(x), w.dec_lo, w.dec_hi, level), want)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("wname", ["db7", "sym8"])
def test_swt_inv_level_1d_ref_matches_pallas(wname, level):
    """The one 1/2 of a 1D synthesis, on both sides."""
    jw, w = _pair(wname)
    lo, hi = _bands(N, seed=3)
    want = jk.swt_inv_level_1d(jnp.asarray(lo), jnp.asarray(hi), jw.rec_lo, jw.rec_hi, level)
    assert want is not None
    _close(K1.swt_inv_level_1d_ref(torch.from_numpy(lo), torch.from_numpy(hi), w.rec_lo,
                                   w.rec_hi, level), want)


@pytest.mark.parametrize("kernel", ["fwd", "inv", "swt_fwd", "swt_inv"])
def test_odd_length_bank_matches_jax_fma(kernel):
    """hlen 7 at odd and short lengths, against the fma formulations the JAX
    wrappers fall back to (``swt_pallas.py:801-871``)."""
    jw, w = _pair("odd7")
    t = torch.from_numpy
    if kernel == "fwd":
        x = _rand(3, 22, seed=4)
        want = jsp._fma_fwd1(jnp.asarray(x), jw.dec_lo, jw.dec_hi)
        got = K1.fwd_level_1d_ref(t(x), w.dec_lo, w.dec_hi)
    elif kernel == "inv":
        lo, hi = (_rand(3, 5, seed=s, lo=-1.0, hi=1.0) for s in (5, 6))
        want = jsp._fma_inv1(jnp.asarray(lo), jnp.asarray(hi), jw.rec_lo, jw.rec_hi)
        got = K1.inv_level_1d_ref(t(lo), t(hi), w.rec_lo, w.rec_hi)
    elif kernel == "swt_fwd":
        x = _rand(3, 13, seed=7)
        want = jsp._fma_swt_fwd1(jnp.asarray(x), jw.dec_lo, jw.dec_hi, 2)
        got = K1.swt_fwd_level_1d_ref(t(x), w.dec_lo, w.dec_hi, 2)
    else:
        lo, hi = (_rand(3, 13, seed=s, lo=-1.0, hi=1.0) for s in (8, 9))
        want = jsp._fma_swt_inv1(jnp.asarray(lo), jnp.asarray(hi), jw.rec_lo, jw.rec_hi, 3)
        got = K1.swt_inv_level_1d_ref(t(lo), t(hi), w.rec_lo, w.rec_hi, 3)
    _close(got, want)


# ---------------------------------------------------------------------------
# autograd: the port's Functions against jax.vjp of the JAX *_ad wrappers
# ---------------------------------------------------------------------------

def _leaf(arr):
    return torch.from_numpy(arr).requires_grad_(True)


def _grads(outs, cts, inputs):
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts))
    return torch.autograd.grad(loss, inputs)


def test_fwd_level_1d_ad_matches_jax_vjp():
    jw, w = _pair("db7")
    x = _rand(B, N)
    cts = _bands(N // 2, seed=10)
    _, vjp = jax.vjp(lambda t: jk.fwd_level_1d_ad(t, tuple(jw.dec_lo), tuple(jw.dec_hi)),
                     jnp.asarray(x))
    want = vjp(tuple(map(jnp.asarray, cts)))
    xt = _leaf(x)
    _close(_grads(K1.fwd_level_1d_ad(xt, w.dec_lo, w.dec_hi), cts, [xt]), want)


def test_inv_level_1d_ad_matches_jax_vjp():
    jw, w = _pair("sym8")
    bands = _bands(N // 2)
    ct = _rand(B, N, seed=11, lo=-1.0, hi=1.0)
    _, vjp = jax.vjp(lambda lo, hi: jk.inv_level_1d_ad(lo, hi, tuple(jw.rec_lo),
                                                       tuple(jw.rec_hi)),
                     *map(jnp.asarray, bands))
    want = vjp(jnp.asarray(ct))
    leaves = [_leaf(b) for b in bands]
    _close(_grads(K1.inv_level_1d_ad(*leaves, w.rec_lo, w.rec_hi), [ct], leaves), want)


def test_swt_fwd_level_1d_ad_matches_jax_vjp():
    jw, w = _pair("db7")
    x = _rand(B, N, seed=12)
    cts = _bands(N, seed=13)
    _, vjp = jax.vjp(lambda t: jk.swt_fwd_level_1d_ad(t, tuple(jw.dec_lo), tuple(jw.dec_hi), 2),
                     jnp.asarray(x))
    want = vjp(tuple(map(jnp.asarray, cts)))
    xt = _leaf(x)
    _close(_grads(K1.swt_fwd_level_1d_ad(xt, w.dec_lo, w.dec_hi, 2), cts, [xt]), want)


def test_swt_inv_level_1d_ad_matches_jax_vjp():
    jw, w = _pair("sym8")
    bands = _bands(N, seed=14)
    ct = _rand(B, N, seed=15, lo=-1.0, hi=1.0)
    _, vjp = jax.vjp(lambda lo, hi: jk.swt_inv_level_1d_ad(lo, hi, tuple(jw.rec_lo),
                                                           tuple(jw.rec_hi), 2),
                     *map(jnp.asarray, bands))
    want = vjp(jnp.asarray(ct))
    leaves = [_leaf(b) for b in bands]
    _close(_grads(K1.swt_inv_level_1d_ad(*leaves, w.rec_lo, w.rec_hi, 2), [ct], leaves), want)


# ---------------------------------------------------------------------------
# port-only properties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wname,shape,level", [("haar", (2, 12), 2), ("db7", (3, 26), 1),
                                               ("odd7", (2, 10), 3), ("db2", (1, 8), 4),
                                               ("sym8", (2, 10), 2)])
def test_backward_pairing_is_the_adjoint(wname, shape, level):
    """Each Function's backward (the paired kernel with reversed, rescaled
    taps) equals autograd through the plain version, in float64 (tolerance
    1e-12 relative), for even and odd filter lengths, signals shorter than
    the support and a dilation larger than the signal."""
    w = _pair(wname)[1]
    rng = np.random.default_rng(0)
    r = lambda s: torch.from_numpy(rng.standard_normal(s))
    half = (shape[0], shape[1] // 2)

    def check(fn_ad, fn_ref, inputs, cts):
        inputs = [t.requires_grad_(True) for t in inputs]

        def grads(fn):
            outs = fn(*inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            return torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cts)), inputs)

        for a, b in zip(grads(fn_ad), grads(fn_ref)):
            assert float((a - b).abs().max()) <= 1e-12 * max(float(b.abs().max()), 1.0)

    check(lambda x: K1.fwd_level_1d_ad(x, w.dec_lo, w.dec_hi),
          lambda x: K1.fwd_level_1d_ref(x, w.dec_lo, w.dec_hi), [r(shape)], [r(half), r(half)])
    check(lambda lo, hi: K1.inv_level_1d_ad(lo, hi, w.rec_lo, w.rec_hi),
          lambda lo, hi: K1.inv_level_1d_ref(lo, hi, w.rec_lo, w.rec_hi),
          [r(half), r(half)], [r(shape)])
    check(lambda x: K1.swt_fwd_level_1d_ad(x, w.dec_lo, w.dec_hi, level),
          lambda x: K1.swt_fwd_level_1d_ref(x, w.dec_lo, w.dec_hi, level), [r(shape)],
          [r(shape), r(shape)])
    check(lambda lo, hi: K1.swt_inv_level_1d_ad(lo, hi, w.rec_lo, w.rec_hi, level),
          lambda lo, hi: K1.swt_inv_level_1d_ref(lo, hi, w.rec_lo, w.rec_hi, level),
          [r(shape), r(shape)], [r(shape)])


def test_cpu_1d_wrappers_run_the_plain_versions_and_count_nothing():
    w = _pair("db3")[1]
    x = torch.from_numpy(_rand(3, 24))
    reset_launch_counts()
    for got, want in [(K1.fwd_level_1d(x, w.dec_lo, w.dec_hi),
                       K1.fwd_level_1d_ref(x, w.dec_lo, w.dec_hi)),
                      (K1.swt_fwd_level_1d(x, w.dec_lo, w.dec_hi, 2),
                       K1.swt_fwd_level_1d_ref(x, w.dec_lo, w.dec_hi, 2)),
                      ([K1.inv_level_1d(x, x, w.rec_lo, w.rec_hi)],
                       [K1.inv_level_1d_ref(x, x, w.rec_lo, w.rec_hi)]),
                      ([K1.swt_inv_level_1d(x, x, w.rec_lo, w.rec_hi, 3)],
                       [K1.swt_inv_level_1d_ref(x, x, w.rec_lo, w.rec_hi, 3)])]:
        for g, wt in zip(got, want):
            assert torch.equal(g, wt)
    assert set(LAUNCHES) >= {"fwd_level_1d", "inv_level_1d", "swt_fwd_level_1d",
                             "swt_inv_level_1d"}
    assert set(LAUNCHES.values()) == {0}


def test_1d_wrappers_refuse_what_they_do_not_take():
    w = _pair("db2")[1]
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K1.fwd_level_1d(meta, w.dec_lo, w.dec_hi)
    with pytest.raises(ValueError, match="unsupported device"):
        K1.inv_level_1d(meta, meta, w.rec_lo, w.rec_hi)
    with pytest.raises(ValueError, match="level"):
        K1.swt_fwd_level_1d(torch.zeros(2, 8), w.dec_lo, w.dec_hi, 0)
    with pytest.raises(ValueError, match="several devices"):
        K1.swt_inv_level_1d(torch.zeros(2, 8), meta, w.rec_lo, w.rec_hi, 1)
    # a signal of 2^31 samples does not fit the kernels' int arguments; the
    # check comes before the library is loaded
    with pytest.raises(ValueError, match="32-bit int"):
        launch("fwd_level_1d", torch.device("cpu"), [None, 1, 1 << 31])
    assert _build.load.cache_info().currsize == 0
