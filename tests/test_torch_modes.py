"""The port's boundary modes against the JAX package's on the same inputs:
``core/modes.py`` (the extensions and the size rules), the conv passes'
``mode=``, and ``dwt2d``/``idwt2d``/``dwt1d``/``idwt1d(mode=)`` on both
of their routes, against JAX's fma formulation (``backend="fma"``, the
route JAX runs off the TPU and on bf16), ``tests/np_oracle.py``, and
``jax.vjp`` for the gradients.

Inputs come from ``default_rng`` and cross as numpy arrays; float32 is
pinned on both sides (``tests/conftest.py`` turns on x64).  Tolerances:
coefficients and inverses within 1e-5 of the largest output (the two sides
sum the same taps in the same order; a kernel contracts multiply-adds);
bf16 within one bf16 ulp of the largest value (2^-7 relative: a float32
sum one ulp apart can flip one rounding, and XLA's CPU may keep excess
precision in bf16 arithmetic); roundtrips on [0, 255] within 1e-3, the
exact tier's limit (``PERF.md`` section 2): the smooth mode extrapolates
up to hlen - 1 times the edge slope, so its float32 roundoff reaches
6.1e-4 with db7, the same on JAX's side (held within 1e-5 * 255 of JAX's);
gradients within 1e-5 of the largest.  The padded route (the CUDA path's
algebra: the extension per axis, the kernels' plain versions, the
synthesis's offsets) runs here with ``mode_route`` pinned to it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import np_oracle as O
from pdwt_tpu.core import conv as jconv
from pdwt_tpu.core import modes as jmodes
from pdwt_tpu.core import separable as jsep
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu.filters import make_custom_wavelet as jmake_custom_wavelet
from pdwt_tpu_torch import MODES, dwt1d, dwt2d, idwt1d, idwt2d, precision_scope
from pdwt_tpu_torch.core import conv, modes
from pdwt_tpu_torch.core import separable as sep
from pdwt_tpu_torch.core.shapes import coeff_shapes_1d, coeff_shapes_2d
from pdwt_tpu_torch.utils import wavelet_from_arrays

RTOL, BF16_RTOL, GRAD_RTOL, RT_ATOL = 1e-5, 2.0 ** -7, 1e-5, 1e-3
NP_MODES = MODES[1:]
MIXED = (("periodization", "symmetric"), ("reflect", "periodization"))


def _pair(wname):
    if wname == "odd5":  # an odd-length custom bank
        jw = jmake_custom_wavelet("odd5", *np.random.default_rng(5).standard_normal((4, 5)))
    else:
        jw = jget_wavelet(wname)
    return jw, wavelet_from_arrays(jw)


def _leaves(c):
    if isinstance(c, (sep.Coeffs2D, jsep.Coeffs2D)):
        return [c.approx, *[t for band in c.details for t in band]]
    return [c.approx, *c.details]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    scale = max(float(np.abs(_np(w)).max()) for w in want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)
        assert float(np.abs(_np(g) - _np(w)).max()) <= rtol * scale


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_roundtrip(ndim, mode, wname, shape, levels, seed, dtype="float32"):
    """JAX's fma coefficients of ``_img(shape, seed)`` and its inverse of
    them, one jitted call (each eager op would compile on its own), shared
    by both routes' cases."""
    jw, _ = _pair(wname)
    x = jnp.asarray(_img(shape, seed)).astype(dtype)
    fwd, inv = ((jsep.dwt2d, jsep.idwt2d) if ndim == 2 else (jsep.dwt1d, jsep.idwt1d))
    size = shape[-2:] if ndim == 2 else shape[-1]

    @jax.jit
    def run(t):
        c = fwd(t, jw, levels, mode=mode, backend="fma")
        return c, inv(c, jw, size, mode=mode, backend="fma")

    return run(x)


# ---------------------------------------------------------------------------
# core/modes.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,lo,hi", [(8, 3, 5), (8, 20, 19), (2, 7, 6), (5, 11, 12),
                                     (3, 0, 4), (1, 2, 3)])
def test_extend_matches_jax_and_the_oracle(mode, n, lo, hi):
    """Every mode, pads wider than the signal (reflection cycling,
    antireflect's build-up), one sample; float64 to 1e-12 and float32 bit
    for bit against JAX, float64 against ``np_oracle.ext1``."""
    x = np.random.default_rng(n + lo).standard_normal((2, n))
    if mode in ("reflect", "antireflect") and n < 2:
        with pytest.raises(ValueError, match="at least 2 samples"):
            modes.extend(torch.from_numpy(x), -1, lo, hi, mode)
        return
    got = modes.extend(torch.from_numpy(x), -1, lo, hi, mode).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodes.extend(jnp.asarray(x), -1, lo, hi, mode)),
                               rtol=0, atol=1e-12)
    if mode != "periodization":
        np.testing.assert_allclose(got, O.ext1(x, lo, hi, mode), rtol=0, atol=1e-12)
    x32 = x.astype(np.float32)
    got32 = modes.extend(torch.from_numpy(x32), -1, lo, hi, mode).numpy()
    np.testing.assert_array_equal(got32, np.asarray(jmodes.extend(jnp.asarray(x32), -1, lo, hi,
                                                                  mode)))


def test_extend_along_another_axis_zero_pad_and_errors():
    x = np.random.default_rng(1).standard_normal((4, 6))
    got = modes.extend(torch.from_numpy(x), 0, 2, 3, "smooth").numpy()
    np.testing.assert_allclose(got, O.ext1(x.T, 2, 3, "smooth").T, rtol=0, atol=1e-12)
    z = modes.zero_pad(torch.from_numpy(x), -2, 1, 2).numpy()
    np.testing.assert_array_equal(z, np.asarray(jmodes.zero_pad(jnp.asarray(x), -2, 1, 2)))
    with pytest.raises(ValueError, match="unknown boundary mode"):
        modes.check_mode("sym")  # no pywt aliases, as in JAX
    with pytest.raises(ValueError, match="expected 2 boundary modes"):
        modes.per_axis(("zero",), 2)
    assert modes.per_axis("zero", 3) == ("zero",) * 3


def test_size_rules_match_jax():
    for mode in MODES:
        for hlen in (2, 4, 5, 14, 16):
            for n in range(1, 40):
                assert modes.dec_len(n, hlen, mode) == jmodes.dec_len(n, hlen, mode)
                assert modes.rec_len(n, hlen, mode) == jmodes.rec_len(n, hlen, mode)
            assert modes.level_sizes(37, 4, hlen, mode) == jmodes.level_sizes(37, 4, hlen, mode)
    a, dets = coeff_shapes_2d(37, 29, 2, mode=("symmetric", "periodization"), hlen=8)
    assert dets == [(22, 15), (14, 8)] and a == (14, 8)
    assert coeff_shapes_1d(29, 2, mode="zero", hlen=4) == (9, [16, 9])


# ---------------------------------------------------------------------------
# the transforms against JAX's fma formulation
# ---------------------------------------------------------------------------

WAVS = ("haar", "db2", "db7", "sym8")
SHAPES = ((2, 23, 17), (13, 29), (1, 31, 37), (3, 5, 8))  # odd, prime, shorter than the filter
CASES_2D = [(m, WAVS[i % 4], SHAPES[(i + i // 4) % 4], 1 + i % 3)
            for i, m in enumerate(NP_MODES + MIXED)]


@pytest.fixture(params=["plain", "padded"])
def route(request, monkeypatch):
    """The route the transforms take: the plain one (this CPU's), or the
    padded one of the CUDA path, whose kernel wrappers run their plain
    versions here; each padded call is counted."""
    calls = {}
    if request.param == "padded":
        from pdwt_tpu_torch import kernels

        route_on_card = sep.mode_route
        monkeypatch.setattr(sep, "mode_route", lambda dt, dev, hlen: route_on_card(
            dt, torch.device("cuda"), hlen))
        for name in ("fwd_level_2d_padded_ad", "inv_level_2d_padded_ad",
                     "fwd_level_1d_padded_ad", "inv_level_1d_padded_ad"):
            def counted(*args, _fn=getattr(kernels, name), _name=name):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*args)
            monkeypatch.setattr(kernels, name, counted)
    return request.param, calls


@pytest.mark.parametrize("mode,wname,shape,levels", CASES_2D)
def test_dwt2d_idwt2d_match_jax(mode, wname, shape, levels, route):
    _, w = _pair(wname)
    x = _img(shape, seed=levels)
    want, jy = _jax_roundtrip(2, mode, wname, shape, levels, levels)
    got = dwt2d(torch.from_numpy(x), w, levels, mode=mode)
    _close(_leaves(got), _leaves(want))
    y = idwt2d(got, w, shape[-2:], mode=mode)
    _close([y], [jy])
    err, jerr = (float(np.abs(_np(t) - x).max()) for t in (y, jy))
    assert err <= RT_ATOL and abs(err - jerr) <= RTOL * 255
    kind, calls = route
    if kind == "padded":
        assert calls == {"fwd_level_2d_padded_ad": levels, "inv_level_2d_padded_ad": levels}


CASES_1D = [(m, WAVS[i % 4], ((3, 29), (2, 7), (1, 64), (4, 1))[i % 4], 1 + i % 3)
            for i, m in enumerate(NP_MODES)]


@pytest.mark.parametrize("mode,wname,shape,levels", CASES_1D)
def test_dwt1d_idwt1d_match_jax(mode, wname, shape, levels, route):
    jw, w = _pair(wname)
    x = _img(shape, seed=levels)
    if mode in ("reflect", "antireflect") and shape[-1] < 2:
        for fn, arr in ((dwt1d, torch.from_numpy(x)), (jsep.dwt1d, jnp.asarray(x))):
            with pytest.raises(ValueError, match="at least 2 samples"):
                fn(arr, w if fn is dwt1d else jw, levels, mode=mode)
        return
    want, jy = _jax_roundtrip(1, mode, wname, shape, levels, levels)
    got = dwt1d(torch.from_numpy(x), w, levels, mode=mode)
    _close(_leaves(got), _leaves(want))
    y = idwt1d(got, w, shape[-1], mode=mode)
    _close([y], [jy])
    assert float(np.abs(_np(y) - x).max()) <= RT_ATOL
    kind, calls = route
    if kind == "padded":
        assert calls == {"fwd_level_1d_padded_ad": levels, "inv_level_1d_padded_ad": levels}


def test_odd_length_bank_forward_matches_and_inverse_refuses(route):
    """An odd filter takes the plain forward on every route; the inverse
    raises JAX's ValueError (pywt's parity rule)."""
    jw, w = _pair("odd5")
    x = _img((2, 19, 14))
    for mode in ("symmetric", ("periodization", "zero")):
        want = jax.jit(lambda t: jsep.dwt2d(t, jw, 2, mode=mode, backend="fma"))(x)
        got = dwt2d(torch.from_numpy(x), w, 2, mode=mode)
        _close(_leaves(got), _leaves(want))
        for fn, c, ww in ((idwt2d, got, w), (jsep.idwt2d, want, jw)):
            kw = {"backend": "fma"} if fn is jsep.idwt2d else {}
            with pytest.raises(ValueError, match="even filter length"):
                fn(c, ww, (19, 14), mode=mode, **kw)
    assert route[1] == {}
    assert sep.mode_route(torch.float32, torch.device("cuda"), 5) == "plain"


@pytest.mark.parametrize("mode", ["zero", "smooth", "antireflect", MIXED[0]])
def test_bf16_keeps_jax_dtypes_and_values(mode):
    """bf16 runs the plain extension route, every band bf16 (JAX's fma
    formulation rounds each pass to the input's dtype), the inverse too."""
    _, w = _pair("db7")
    x = torch.from_numpy(_img((2, 21, 26))).bfloat16()
    want, jy = _jax_roundtrip(2, mode, "db7", (2, 21, 26), 2, 0, "bfloat16")
    got = dwt2d(x, w, 2, mode=mode)
    assert all(t.dtype == torch.bfloat16 for t in _leaves(got))
    _close(_leaves(got), _leaves(want), BF16_RTOL)
    _close([idwt2d(got, w, (21, 26), mode=mode)], [jy], BF16_RTOL)
    want, jy = _jax_roundtrip(1, "smooth", "db7", (3, 33), 2, 0, "bfloat16")
    got = dwt1d(torch.from_numpy(_img((3, 33))).bfloat16(), w, 2, mode="smooth")
    _close(_leaves(got), _leaves(want), BF16_RTOL)
    _close([idwt1d(got, w, 33, mode="smooth")], [jy], BF16_RTOL)


def test_mixed_tier_runs_the_exact_mode_route():
    """JAX's mode route takes no precision tier (it routes by dtype): float32
    under ``mixed`` gives the exact coefficients."""
    _, w = _pair("db2")
    x = torch.from_numpy(_img((18, 23)))
    with precision_scope("mixed"):
        got = dwt2d(x, w, 2, mode="reflect")
    _close(_leaves(got), _leaves(dwt2d(x, w, 2, mode="reflect")), 0.0)


def test_mixed_periodization_tuple_is_the_fma_not_jax_tpu_route(monkeypatch):
    """A per-axis tuple that mixes periodization with a pywt mode holds to
    JAX's fma coefficients and to ``np_oracle`` composed per axis.  JAX's
    TPU route (``_mode_fwd_level_pallas_raw`` / ``_inv_...``, run here in
    Pallas interpret mode) pads the periodization axis at the pywt phase
    and zero-pads its inverse with pywt's offset: its coefficients differ
    by units (``ROADMAP.md``, "Open faults of the reference"), and the port
    does not copy them."""
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")
    jw, w = _pair("db2")
    x = _img((16, 20), seed=7)
    mode = ("periodization", "symmetric")
    got = dwt2d(torch.from_numpy(x), w, 1, mode=mode)
    fma, fma_y = _jax_roundtrip(2, mode, "db2", (16, 20), 1, 7)
    _close(_leaves(got), _leaves(fma))
    lo_c, hi_c = O.dwt1_level_mode(x.astype(np.float64), w.dec_lo, w.dec_hi, "symmetric")
    a, h = (t.T for t in O.dwt1_level(lo_c.T, w.dec_lo, w.dec_hi))
    v, d = (t.T for t in O.dwt1_level(hi_c.T, w.dec_lo, w.dec_hi))
    _close([t.double() for t in _leaves(got)], [a, h, v, d], RTOL)
    tpu = jsep._mode_fwd_level_pallas_raw(jnp.asarray(x)[None], jw, *mode)
    assert float(np.abs(np.asarray(tpu[0][0]) - _np(got.approx)).max()) > 1.0
    y = idwt2d(got, w, (16, 20), mode=mode)
    _close([y], [fma_y])
    assert float(np.abs(_np(y) - x).max()) <= RT_ATOL
    bands = [jnp.asarray(_np(t))[None] for t in _leaves(got)]
    tpu_y = jsep._mode_inv_level_pallas_raw(*bands, jw, 16, 20)
    assert float(np.abs(np.asarray(tpu_y[0]) - x).max()) > 1.0


@functools.lru_cache(maxsize=None)
def _jax_vjps(mode):
    """JAX's cotangents of the test below: jitted vjps of dwt2d, idwt2d
    and dwt1d (smooth) on fixed inputs and cotangents."""
    jw, _ = _pair("db3")
    rng = np.random.default_rng(2)
    x, s = _img((2, 17, 22)), _img((3, 25))
    fwd = lambda t: jsep.dwt2d(t, jw, 2, mode=mode, backend="fma")
    inv = lambda c: jsep.idwt2d(c, jw, (17, 22), mode=mode, backend="fma")
    fwd1 = lambda t: jsep.dwt1d(t, jw, 2, mode="smooth", backend="fma")
    c = jax.jit(fwd)(x)
    cts = [rng.standard_normal(t.shape).astype(np.float32) for t in _leaves(c)]
    ct_tree = jsep.Coeffs2D(cts[0], tuple(tuple(cts[1 + 3 * i:4 + 3 * i]) for i in range(2)))
    ct_y = rng.standard_normal((2, 17, 22)).astype(np.float32)
    c1 = jax.jit(fwd1)(s)
    cts1 = [rng.standard_normal(t.shape).astype(np.float32) for t in _leaves(c1)]
    run = jax.jit(lambda: (jax.vjp(fwd, jnp.asarray(x))[1](ct_tree)[0],
                           jax.vjp(inv, c)[1](jnp.asarray(ct_y))[0],
                           jax.vjp(fwd1, jnp.asarray(s))[1](
                               jsep.Coeffs1D(cts1[0], tuple(cts1[1:])))[0]))
    return x, s, c, cts, ct_y, cts1, run()


@pytest.mark.parametrize("mode", ["symmetric", ("periodization", "reflect")])
def test_gradients_match_jax_vjp(mode, route):
    _, w = _pair("db3")
    x, s, c, cts, ct_y, cts1, (want_g, want_inv, want_g1) = _jax_vjps(mode)
    xt = torch.from_numpy(x).requires_grad_(True)
    (got_g,) = torch.autograd.grad(_leaves(dwt2d(xt, w, 2, mode=mode)), xt,
                                   [torch.from_numpy(t) for t in cts])
    _close([got_g], [want_g], GRAD_RTOL)
    # the inverse, with respect to every band
    leaves = [torch.from_numpy(_np(t)).requires_grad_(True) for t in _leaves(c)]
    tree = sep.Coeffs2D(leaves[0], tuple(tuple(leaves[1 + 3 * i:4 + 3 * i]) for i in range(2)))
    got = torch.autograd.grad(idwt2d(tree, w, (17, 22), mode=mode), leaves, torch.from_numpy(ct_y))
    _close(got, _leaves(want_inv), GRAD_RTOL)
    # 1D
    st = torch.from_numpy(s).requires_grad_(True)
    (got_g,) = torch.autograd.grad(_leaves(dwt1d(st, w, 2, mode="smooth")), st,
                                   [torch.from_numpy(t) for t in cts1])
    _close([got_g], [want_g1], GRAD_RTOL)


def test_mode_route_rule():
    """float32 on the card with an even filter: the padded kernels; CPU,
    bf16 and odd filters: the plain extension route (float64 on the card is
    refused before, by ``check_supported``)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    assert sep.mode_route(f32, cuda, 14) == sep.mode_route(f32, cuda, 2) == "padded"
    for dt, dev, hlen in ((bf16, cuda, 14), (f32, cpu, 14), (f64, cpu, 16), (f32, cuda, 3)):
        assert sep.mode_route(dt, dev, hlen) == "plain"


def test_mode_errors_match_jax():
    jw, w = _pair("db2")
    x = _img((8, 8))
    for fn, arr, ww in ((dwt2d, torch.from_numpy(x), w), (jsep.dwt2d, jnp.asarray(x), jw)):
        with pytest.raises(ValueError, match="unknown boundary mode"):
            fn(arr, ww, 1, mode="symmetri")
        with pytest.raises(ValueError, match="expected 2 boundary modes"):
            fn(arr, ww, 1, mode=("zero",))
    z = torch.from_numpy(x)[None, None]
    with pytest.raises(ValueError, match="decimated DWT only"):
        conv.analysis_pass(z, (w.dec_lo, w.dec_hi), -1, decimate=False, mode="symmetric")
    with pytest.raises(ValueError, match="decimated inverse DWT only"):
        conv.synthesis_pass(z.repeat(1, 2, 1, 1), (w.rec_lo, w.rec_hi), -1, decimated=False,
                            mode="zero")
    with pytest.raises(ValueError, match="exceeds the mode's full inverse length"):
        conv.synthesis_pass(z.repeat(1, 2, 1, 1), (w.rec_lo, w.rec_hi), -1, out_len=15,
                            mode="zero")
    with pytest.raises(ValueError, match="exceeds the mode's full inverse length"):
        jconv.synthesis_pass(jnp.asarray(x)[None, None].repeat(2, 1), (jw.rec_lo, jw.rec_hi),
                             -1, out_len=15, mode="zero", backend="fma")
