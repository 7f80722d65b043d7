"""The plain versions of the port's four separable kernels against the JAX
package's Pallas kernels (interpret mode, as the JAX tests run them on the
CPU), and the port's autograd Functions against ``jax.vjp`` of the JAX
``*_ad`` wrappers.

Shapes respect the Pallas tile rules (subband columns a multiple of 128;
tails with rows % 8 == 0 and columns % 128 == 0) and stay small: one
interpret-mode level takes about two seconds.  Tolerance: max|port - jax|
<= 4e-6 * max|jax| in float32 (the same taps in the same order; either
side may contract a multiply-add).  The CUDA kernels themselves are held
to these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import kernels as jk
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu_torch.filters import make_custom_wavelet
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
        g = g.detach().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        err = float(np.abs(g - w).max())
        assert err <= RTOL * float(np.abs(w).max()), err


def _rand(*shape, seed=0, lo=0.0, hi=255.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _pair(wname):
    jw = jget_wavelet(wname)
    return jw, wavelet_from_arrays(jw)


def _flat(a, dets):
    return [a, *[t for band in dets for t in band]]


@pytest.mark.parametrize("wname", ["db7", "sym8"])
def test_fwd_level_ref_matches_pallas(wname):
    jw, w = _pair(wname)
    x = _rand(2, 64, 256)
    want = jk.fwd_level_2d(jnp.asarray(x), jw.dec_lo, jw.dec_hi)
    assert want is not None
    _close(K.fwd_level_2d_ref(torch.from_numpy(x), w.dec_lo, w.dec_hi), want)


@pytest.mark.parametrize("wname", ["db7", "sym8"])
def test_inv_level_ref_matches_pallas(wname):
    jw, w = _pair(wname)
    bands = [_rand(2, 32, 128, seed=s, lo=-255.0) for s in range(4)]
    want = jk.inv_level_2d(*map(jnp.asarray, bands), jw.rec_lo, jw.rec_hi)
    assert want is not None
    _close([K.inv_level_2d_ref(*map(torch.from_numpy, bands), w.rec_lo, w.rec_hi)], [want])


@pytest.mark.parametrize("wname,shape,levels", [("db7", (2, 16, 128), 1),
                                                ("db18", (1, 64, 128), 3)])
def test_tail_refs_match_pallas(wname, shape, levels):
    """db18 at 64x128, 3 levels: the 17-sample periodic halo is wider than
    the 8-row deepest level."""
    jw, w = _pair(wname)
    x = _rand(*shape)
    want = jk.fwd_tail_2d(jnp.asarray(x), jw.dec_lo, jw.dec_hi, levels)
    assert want is not None
    a, dets = K.fwd_tail_2d_ref(torch.from_numpy(x), w.dec_lo, w.dec_hi, levels)
    _close(_flat(a, dets), _flat(*want))
    deepest_first = [tuple(map(jnp.asarray, band)) for band in want[1][::-1]]
    want_y = jk.inv_tail_2d(want[0], deepest_first, jw.rec_lo, jw.rec_hi)
    assert want_y is not None
    got_y = K.inv_tail_2d_ref(torch.tensor(np.asarray(want[0])),
                              [tuple(torch.tensor(np.asarray(t)) for t in band)
                               for band in deepest_first], w.rec_lo, w.rec_hi)
    _close([got_y], [want_y])


# ---------------------------------------------------------------------------
# autograd: the port's Functions against jax.vjp of the JAX *_ad wrappers
# ---------------------------------------------------------------------------

def _grads(outs, cts, inputs):
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts))
    return torch.autograd.grad(loss, inputs)


def _leaf(arr):
    return torch.from_numpy(arr).requires_grad_(True)


def test_fwd_level_ad_matches_jax_vjp():
    jw, w = _pair("db7")
    x = _rand(1, 32, 256)
    cts = [_rand(1, 16, 128, seed=s, lo=-1.0, hi=1.0) for s in range(1, 5)]
    _, vjp = jax.vjp(lambda t: jk.fwd_level_2d_ad(t, tuple(jw.dec_lo), tuple(jw.dec_hi)),
                     jnp.asarray(x))
    want = vjp(tuple(map(jnp.asarray, cts)))
    xt = _leaf(x)
    _close(_grads(K.fwd_level_2d_ad(xt, w.dec_lo, w.dec_hi), cts, [xt]), want)


def test_inv_level_ad_matches_jax_vjp():
    jw, w = _pair("db7")
    bands = [_rand(1, 16, 128, seed=s, lo=-255.0) for s in range(4)]
    ct = _rand(1, 32, 256, seed=9, lo=-1.0, hi=1.0)
    _, vjp = jax.vjp(lambda *b: jk.inv_level_2d_ad(*b, tuple(jw.rec_lo), tuple(jw.rec_hi)),
                     *map(jnp.asarray, bands))
    want = vjp(jnp.asarray(ct))
    leaves = [_leaf(b) for b in bands]
    _close(_grads([K.inv_level_2d_ad(*leaves, w.rec_lo, w.rec_hi)], [ct], leaves), want)


def test_fwd_tail_ad_matches_jax_vjp():
    jw, w = _pair("db7")
    levels = 2
    x = _rand(1, 32, 128)
    _, vjp = jax.vjp(lambda t: jk.fwd_tail_2d_ad(t, tuple(jw.dec_lo), tuple(jw.dec_hi),
                                                 levels), jnp.asarray(x))
    ct_a = _rand(1, 8, 32, seed=1, lo=-1.0, hi=1.0)
    ct_d = [tuple(_rand(1, 32 >> l, 128 >> l, seed=10 * l + b, lo=-1.0, hi=1.0)
                  for b in range(3)) for l in range(1, levels + 1)]
    want = vjp((jnp.asarray(ct_a), [tuple(map(jnp.asarray, band)) for band in ct_d]))
    xt = _leaf(x)
    a, dets = K.fwd_tail_2d_ad(xt, w.dec_lo, w.dec_hi, levels)
    _close(_grads(_flat(a, dets), _flat(ct_a, ct_d), [xt]), want)


def test_inv_tail_ad_matches_jax_vjp():
    jw, w = _pair("db7")
    levels = 2
    a = _rand(1, 8, 32, lo=-255.0)
    dets = [tuple(_rand(1, 8 << l, 32 << l, seed=10 * l + b, lo=-255.0) for b in range(3))
            for l in range(levels)]  # deepest first
    flat = [t for band in dets for t in band]
    ct = _rand(1, 32, 128, seed=3, lo=-1.0, hi=1.0)
    _, vjp = jax.vjp(lambda a_, f_: jk.inv_tail_2d_ad(a_, f_, tuple(jw.rec_lo),
                                                      tuple(jw.rec_hi), levels),
                     jnp.asarray(a), tuple(map(jnp.asarray, flat)))
    want_a, want_flat = vjp(jnp.asarray(ct))
    leaves = [_leaf(t) for t in [a, *flat]]
    bands = [tuple(leaves[1 + 3 * k:4 + 3 * k]) for k in range(levels)]
    got = _grads([K.inv_tail_2d_ad(leaves[0], bands, w.rec_lo, w.rec_hi)], [ct], leaves)
    _close(got, [want_a, *want_flat])


# ---------------------------------------------------------------------------
# port-only properties
# ---------------------------------------------------------------------------

def _bank(name):
    if name.startswith("odd"):  # odd-length custom banks
        n = int(name[3:])
        return make_custom_wavelet(name, *np.random.default_rng(n).standard_normal((4, n)))
    return wavelet_from_arrays(jget_wavelet(name))


@pytest.mark.parametrize("wname", ["haar", "db7", "bior4.4", "odd3", "odd5"])
def test_backward_pairing_is_the_adjoint(wname):
    """Each Function's backward (the paired kernel with reversed taps)
    equals autograd through the plain version, in float64, for even and
    odd filter lengths: on even sizes the synthesis shift equals the
    complementary analysis center hlen - 1 - fwd_center(hlen) for both."""
    w = _bank(wname)
    rng = np.random.default_rng(0)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s))
    tol = 1e-12

    def check(fn_ad, fn_ref, inputs, cts):
        g1 = _grads_t(fn_ad(*inputs), cts, inputs)
        g2 = _grads_t(fn_ref(*inputs), cts, inputs)
        for a, b in zip(g1, g2):
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())

    x = r(2, 16, 24).requires_grad_(True)
    check(lambda t: K.fwd_level_2d_ad(t, w.dec_lo, w.dec_hi),
          lambda t: K.fwd_level_2d_ref(t, w.dec_lo, w.dec_hi), [x],
          [r(2, 8, 12) for _ in range(4)])
    bands = [r(2, 8, 12).requires_grad_(True) for _ in range(4)]
    check(lambda *b: [K.inv_level_2d_ad(*b, w.rec_lo, w.rec_hi)],
          lambda *b: [K.inv_level_2d_ref(*b, w.rec_lo, w.rec_hi)], bands, [r(2, 16, 24)])
    check(lambda t: _flat(*K.fwd_tail_2d_ad(t, w.dec_lo, w.dec_hi, 3)),
          lambda t: _flat(*K.fwd_tail_2d_ref(t, w.dec_lo, w.dec_hi, 3)), [x],
          [r(2, 2, 3)] + [r(2, 16 >> l, 24 >> l) for l in (1, 1, 1, 2, 2, 2, 3, 3, 3)])
    leaves = [r(2, 2, 3).requires_grad_(True)] + [
        r(2, 2 << l, 3 << l).requires_grad_(True) for l in (0, 0, 0, 1, 1, 1)]
    split = lambda t: (t[0], [tuple(t[1:4]), tuple(t[4:7])])
    check(lambda *t: [K.inv_tail_2d_ad(*split(t), w.rec_lo, w.rec_hi)],
          lambda *t: [K.inv_tail_2d_ref(*split(t), w.rec_lo, w.rec_hi)], leaves,
          [r(2, 8, 12)])


def _grads_t(outs, cts, inputs):
    return torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cts)), inputs)


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    w = _bank("db3")
    x = torch.from_numpy(_rand(2, 16, 32))
    K.reset_launch_counts()
    for got, want in zip(K.fwd_level_2d(x, w.dec_lo, w.dec_hi),
                         K.fwd_level_2d_ref(x, w.dec_lo, w.dec_hi)):
        assert torch.equal(got, want)
    a, dets = K.fwd_tail_2d(x, w.dec_lo, w.dec_hi, 2)
    assert torch.equal(K.inv_tail_2d(a, dets[::-1], w.rec_lo, w.rec_hi),
                       K.inv_tail_2d_ref(a, dets[::-1], w.rec_lo, w.rec_hi))
    assert torch.equal(K.inv_level_2d(*K.fwd_level_2d(x, w.dec_lo, w.dec_hi), w.rec_lo,
                                      w.rec_hi),
                       K.inv_level_2d_ref(*K.fwd_level_2d_ref(x, w.dec_lo, w.dec_hi),
                                          w.rec_lo, w.rec_hi))
    assert set(K.LAUNCHES.values()) == {0}


def test_wrappers_refuse_devices_without_a_kernel():
    w = _bank("db2")
    with pytest.raises(ValueError, match="unsupported device"):
        K.fwd_level_2d(torch.empty(1, 8, 8, device="meta"), w.dec_lo, w.dec_hi)


@pytest.mark.parametrize("shape,hlen,levels,ok", [
    ((128, 128), 14, 1, True),    # the 2048^2 db7 main path's deepest level
    ((256, 256), 14, 1, False),   # 2 * 256 * 256 floats exceed 227 KiB
    ((64, 128), 36, 3, True),     # db18, halo wider than the deepest level
    ((12, 16), 4, 3, False),      # 12 does not halve three times
    ((160, 160), 4, 5, True),
    ((16, 16), 2, 0, False),
    ((16, 16), 200, 1, False),    # longer than the kernels' tap arrays
])
def test_tail_supported(shape, hlen, levels, ok):
    assert K.tail_supported(shape, hlen, levels) is ok
