"""The plain versions of the port's four banded-product kernels (the
precision tiers' level kernels, ``kernels/matmul.py`` and
``kernels/mxu1d.py``) against the JAX package's Pallas kernels in interpret
mode, scheme by scheme; the port's autograd Functions against ``jax.vjp``
of the JAX ``*_ad`` wrappers; and a ladder that shows the tolerances tell
neighbouring schemes apart.

The JAX side picks a scheme with its raw knobs (``PDWT_TPU_BF16_L1FWD`` /
``_L1INV``, ``PDWT_TPU_BF16_ACCURACY``); the port is handed the scheme.
Inputs are made with numpy from a seed and rounded to bf16 the same way on
both sides.  Shapes: 256 x 256 images (db7, db4) and 32 signals of 512
samples (sym8, db4), which the TPU tiles divide.

Tolerances, max|port - jax| relative to max|jax| over one output:

* float32-stored outputs of a 2D level: 2e-3 for ``b1``/``b2f``, whose
  float32 row-pass result is rounded to bf16 before the column pass (an
  f32-ulp difference in the sum order can flip one such rounding, which
  costs about 3e-3 at the maximum; none does on these inputs, the gaps are
  about 1e-7), 1e-4 for ``b2d``/``b3`` and 1e-5 for ``fd`` (float32 sums in
  another order, about 1e-5 and 2e-7);
* float32-stored outputs of a 1D level (one pass, no intermediate
  rounding): 1e-5 for every scheme (gaps about 2e-7);
* bf16-stored outputs: 2^-7, one bf16 rounding flipped by a float32 sum
  in another order.

Neighbouring schemes differ by more (the ladder test): on the 2D forward's
float32 approximation b1 and b2f differ by about 7e-3, b2f or b2d and b3 by
about 3e-3; on the 2D inverse's bf16 output b1 and b2f by about 1.2e-2; on
the 1D forward b1 and b2f by about 1.2e-3.  Where a bf16 output's rounding
is the larger error (the 1D inverse) the schemes do not separate, and
nothing is claimed there.  The CUDA kernels are held to these plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import kernels as jk
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu.kernels.mxu1d_pallas import _pick_1d_tiles
from pdwt_tpu_torch.kernels import matmul as M
from pdwt_tpu_torch.kernels import mxu1d as M1
from pdwt_tpu_torch.kernels._launch import LAUNCHES, reset_launch_counts
from pdwt_tpu_torch.utils import tensor_from_numpy, tensor_to_numpy, wavelet_from_arrays

TOL_2D = {"b1": 2e-3, "b2f": 2e-3, "b2d": 1e-4, "b3": 1e-4, "fd": 1e-5}
TOL_1D = 1e-5
TOL_BF16 = 2.0 ** -7
SCHEMES = ("b1", "fd", "b2f", "b2d", "b3")
N2, B1, N1 = 256, 32, 512
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")
    for knob in ("PDWT_TPU_BF16_L1FWD", "PDWT_TPU_BF16_L1INV", "PDWT_TPU_BF16_ACCURACY",
                 "PDWT_TPU_SWT_BF16_SCHEME", "PDWT_TPU_PRECISION"):
        monkeypatch.delenv(knob, raising=False)


def _pair(wname):
    jw = jget_wavelet(wname)
    return jw, wavelet_from_arrays(jw)


def _np(t):
    """A host float32 array of a JAX array or a tensor, with its dtype name."""
    if isinstance(t, torch.Tensor):
        return tensor_to_numpy(t), str(t.dtype).split(".")[-1]
    return np.asarray(jnp.asarray(t).astype(jnp.float32)), jnp.dtype(t.dtype).name


def _err(got, want):
    """max|got - want| / max|want|, after checking shape and dtype agree."""
    (g, gd), (w, wd) = _np(got), _np(want)
    assert g.shape == w.shape and gd == wd, (g.shape, gd, w.shape, wd)
    return float(np.abs(g - w).max()) / float(np.abs(w).max())


def _tol(dtype_name, scheme, one_d=False):
    if dtype_name == "bfloat16":
        return TOL_BF16
    return TOL_1D if one_d else TOL_2D[scheme]


def _close(got, want, scheme, one_d=False):
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        err = _err(g, w)
        assert err <= _tol(_np(w)[1], scheme, one_d), (scheme, err)


def _rand(*shape, seed=0, lo=0.0, hi=255.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _both(arr, bf16):
    """The same values as a JAX array and a tensor, bf16 or float32."""
    j = jnp.asarray(arr)
    if bf16:
        j = j.astype(jnp.bfloat16)
    return j, tensor_from_numpy(arr, dtype=BF16 if bf16 else F32)


def _bands_2d(seed, det_bf16):
    """(a, h, v, d): a float32 approximation and details, as JAX arrays and
    tensors, from one forward level of a [0, 255] image (realistic ranges)."""
    jw = jget_wavelet("db7")
    x = jnp.asarray(_rand(1, N2, N2, seed=seed))
    a, h, v, d = jk.fwd_level_2d_mxu(x, jw.dec_lo, jw.dec_hi, "mixed")
    js = [a] + [t.astype(jnp.bfloat16) if det_bf16 else t for t in (h, v, d)]
    return js, [tensor_from_numpy(np.asarray(t.astype(jnp.float32)),
                                  dtype=BF16 if t.dtype == jnp.bfloat16 else F32) for t in js]


def _bands_1d(seed, hi_bf16, n=N1 // 2):
    lo, hi = _rand(B1, n, seed=seed, lo=-4, hi=4), _rand(B1, n, seed=seed + 1, lo=-2, hi=2)
    return [_both(lo, False), _both(hi, hi_bf16)]


# ---------------------------------------------------------------------------
# kernels 11 and 12: the 2D level, scheme by scheme
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("wname", ["db7", "db4"])
def test_fwd_level_2d_mxu_ref_matches_pallas_bf16(monkeypatch, wname, scheme):
    """bf16 input (the bf16 tiers' level 1): a float32, details bf16."""
    jw, w = _pair(wname)
    jx, tx = _both(_rand(1, N2, N2), bf16=True)
    monkeypatch.setenv("PDWT_TPU_BF16_L1FWD", scheme)
    want = jk.fwd_level_2d_mxu(jx, jw.dec_lo, jw.dec_hi, "bf16")
    _close(M.fwd_level_2d_mxu_ref(tx, w.dec_lo, w.dec_hi, scheme, (F32, BF16)), want, scheme)


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
@pytest.mark.parametrize("wname", ["db7", "db4"])
def test_fwd_level_2d_mxu_ref_matches_pallas_f32(wname, mode):
    """float32 input: ``mixed`` (all float32) and the bf16 tiers' deep
    approximation chain (float32 in, bf16 details), both ``b3``."""
    jw, w = _pair(wname)
    jx, tx = _both(_rand(1, N2, N2, seed=1), bf16=False)
    want = jk.fwd_level_2d_mxu(jx, jw.dec_lo, jw.dec_hi, mode)
    assert M.mode_scheme(mode, F32) == "b3"
    _close(M.fwd_level_2d_mxu_ref(tx, w.dec_lo, w.dec_hi, "b3", M.mode_out_dtypes(mode)),
           want, "b3")


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("wname", ["db7", "db4"])
def test_inv_level_2d_mxu_ref_matches_pallas_bf16_out(monkeypatch, wname, scheme):
    """The bf16 tiers' last inverse level: float32 a, bf16 details, bf16 out."""
    jw, w = _pair(wname)
    js, ts = _bands_2d(2, det_bf16=True)
    monkeypatch.setenv("PDWT_TPU_BF16_L1INV", scheme)
    want = jk.inv_level_2d_mxu(*js, jw.rec_lo, jw.rec_hi, "bf16", out_dtype=jnp.bfloat16)
    _close(M.inv_level_2d_mxu_ref(*ts, w.rec_lo, w.rec_hi, scheme, BF16), want, scheme)


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
def test_inv_level_2d_mxu_ref_matches_pallas_f32_out(mode):
    """``mixed`` (all float32) and the bf16 tiers' deep levels (bf16
    details, float32 out), both ``b3``."""
    jw, w = _pair("db7")
    js, ts = _bands_2d(3, det_bf16=mode == "bf16")
    want = jk.inv_level_2d_mxu(*js, jw.rec_lo, jw.rec_hi, mode, out_dtype=jnp.float32)
    assert M.inv_plan(mode, F32) == ("b3", F32)
    _close(M.inv_level_2d_mxu_ref(*ts, w.rec_lo, w.rec_hi, "b3", F32), want, "b3")


# ---------------------------------------------------------------------------
# kernels 15 and 16: the batched 1D level, decimated and a-trous
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("wname", ["sym8", "db4"])
def test_fwd_level_1d_mxu_ref_matches_pallas(monkeypatch, wname, scheme):
    jw, w = _pair(wname)
    jx, tx = _both(_rand(B1, N1, seed=4, lo=-3, hi=3), bf16=True)
    monkeypatch.setenv("PDWT_TPU_BF16_L1FWD", scheme)
    want = jk.fwd_level_1d_mxu(jx, jw.dec_lo, jw.dec_hi, "bf16")
    _close(M1.fwd_level_1d_mxu_ref(tx, w.dec_lo, w.dec_hi, scheme, BF16), want, scheme, True)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("wname", ["sym8", "db4"])
def test_inv_level_1d_mxu_ref_matches_pallas(monkeypatch, wname, scheme):
    jw, w = _pair(wname)
    (jlo, tlo), (jhi, thi) = _bands_1d(5, hi_bf16=True)
    monkeypatch.setenv("PDWT_TPU_BF16_L1INV", scheme)
    want = jk.inv_level_1d_mxu(jlo, jhi, jw.rec_lo, jw.rec_hi, "bf16", out_dtype=jnp.bfloat16)
    _close(M1.inv_level_1d_mxu_ref(tlo, thi, w.rec_lo, w.rec_hi, scheme, BF16), want, scheme,
           True)


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
def test_1d_mxu_refs_match_pallas_on_f32(mode):
    """float32 input and low band: ``mixed`` everywhere, and the bf16 tiers'
    deep decimated levels (``b3``, bf16 high band)."""
    jw, w = _pair("sym8")
    jx, tx = _both(_rand(B1, N1, seed=6, lo=-3, hi=3), bf16=False)
    hi_dt = M.mode_out_dtypes(mode)[1]
    want = jk.fwd_level_1d_mxu(jx, jw.dec_lo, jw.dec_hi, mode)
    _close(M1.fwd_level_1d_mxu_ref(tx, w.dec_lo, w.dec_hi, "b3", hi_dt), want, "b3", True)
    (jlo, tlo), (jhi, thi) = _bands_1d(7, hi_bf16=mode == "bf16")
    want = jk.inv_level_1d_mxu(jlo, jhi, jw.rec_lo, jw.rec_hi, mode, out_dtype=jnp.float32)
    _close(M1.inv_level_1d_mxu_ref(tlo, thi, w.rec_lo, w.rec_hi, "b3", F32), want, "b3", True)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("rung", ["fast", "balanced"])
@pytest.mark.parametrize("in_bf16", [True, False], ids=["bf16", "f32"])
def test_swt_fwd_level_1d_mxu_ref_matches_pallas(monkeypatch, in_bf16, rung, level):
    """A-trous analysis in the bf16 mode: b1 (bf16 in) or fd (float32 in)
    under ``fast``, b2f under ``balanced``."""
    jw, w = _pair("sym8")
    jx, tx = _both(_rand(B1, N1, seed=8, lo=-3, hi=3), bf16=in_bf16)
    monkeypatch.setenv("PDWT_TPU_BF16_ACCURACY", rung)
    scheme = M.swt_scheme("bf16", tx.dtype)
    assert scheme == {"fast": "b1" if in_bf16 else "fd", "balanced": "b2f"}[rung]
    want = jk.swt_fwd_level_1d_mxu(jx, jw.dec_lo, jw.dec_hi, level, "bf16")
    _close(M1.swt_fwd_level_1d_mxu_ref(tx, w.dec_lo, w.dec_hi, level, scheme, BF16), want,
           scheme, True)


@pytest.mark.parametrize("mode,out", [("bf16", "bf16"), ("bf16", "f32"), ("mixed", "f32")])
@pytest.mark.parametrize("level", [1, 3])
def test_swt_inv_level_1d_mxu_ref_matches_pallas(level, mode, out):
    """A-trous synthesis: fd at every level in the bf16 mode (the 1/2 in
    the taps before they are rounded), b3 under ``mixed``."""
    jw, w = _pair("db4")
    (jlo, tlo), (jhi, thi) = _bands_1d(9, hi_bf16=mode == "bf16", n=N1)
    out_j, out_t = (jnp.bfloat16, BF16) if out == "bf16" else (jnp.float32, F32)
    want = jk.swt_inv_level_1d_mxu(jlo, jhi, jw.rec_lo, jw.rec_hi, level, mode,
                                   out_dtype=out_j)
    scheme = "fd" if mode == "bf16" else "b3"
    _close(M1.swt_inv_level_1d_mxu_ref(tlo, thi, w.rec_lo, w.rec_hi, level, scheme, out_t),
           want, scheme, True)


def test_swt_mixed_and_f32_a_trous_forward_match_pallas():
    """``mixed`` a-trous analysis (b3, all float32)."""
    jw, w = _pair("sym8")
    jx, tx = _both(_rand(B1, N1, seed=10, lo=-3, hi=3), bf16=False)
    want = jk.swt_fwd_level_1d_mxu(jx, jw.dec_lo, jw.dec_hi, 2, "mixed")
    _close(M1.swt_fwd_level_1d_mxu_ref(tx, w.dec_lo, w.dec_hi, 2, "b3", F32), want, "b3", True)


# ---------------------------------------------------------------------------
# the ladder: each tolerance is tighter than the gap to the next scheme
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,lower,upper", [
    ("fwd2d", "b1", "b2f"), ("fwd2d", "b2f", "b3"), ("fwd2d", "b2d", "b3"),
    ("inv2d", "b1", "b2f"), ("fwd1d", "b1", "b2f"), ("swt_fwd1d", "b1", "b2f")])
def test_tolerances_tell_neighbouring_schemes_apart(monkeypatch, kernel, lower, upper):
    """The port run with ``upper`` passes the comparison with JAX run with
    ``upper``; run with ``lower`` it fails it, by a factor of at least 1.2.
    For the forward levels the float32 output shows the compute (details
    are stored bf16); for the 2D inverse the bf16 output."""
    jw, w = _pair("db7" if kernel.endswith("2d") else "sym8")

    def run(port_scheme):
        if kernel == "fwd2d":
            jx, tx = _both(_rand(1, N2, N2, seed=11), bf16=True)
            monkeypatch.setenv("PDWT_TPU_BF16_L1FWD", upper)
            want = jk.fwd_level_2d_mxu(jx, jw.dec_lo, jw.dec_hi, "bf16")[0]
            return M.fwd_level_2d_mxu_ref(tx, w.dec_lo, w.dec_hi, port_scheme, (F32, BF16))[0], \
                want, False
        if kernel == "inv2d":
            js, ts = _bands_2d(12, det_bf16=True)
            monkeypatch.setenv("PDWT_TPU_BF16_L1INV", upper)
            want = jk.inv_level_2d_mxu(*js, jw.rec_lo, jw.rec_hi, "bf16", out_dtype=jnp.bfloat16)
            return M.inv_level_2d_mxu_ref(*ts, w.rec_lo, w.rec_hi, port_scheme, BF16), want, False
        jx, tx = _both(_rand(B1, N1, seed=13, lo=-3, hi=3), bf16=True)
        if kernel == "fwd1d":
            monkeypatch.setenv("PDWT_TPU_BF16_L1FWD", upper)
            want = jk.fwd_level_1d_mxu(jx, jw.dec_lo, jw.dec_hi, "bf16")[0]
            return M1.fwd_level_1d_mxu_ref(tx, w.dec_lo, w.dec_hi, port_scheme)[0], want, True
        monkeypatch.setenv("PDWT_TPU_BF16_ACCURACY", "balanced")  # b2f on the JAX side
        want = jk.swt_fwd_level_1d_mxu(jx, jw.dec_lo, jw.dec_hi, 1, "bf16")[0]
        return M1.swt_fwd_level_1d_mxu_ref(tx, w.dec_lo, w.dec_hi, 1, port_scheme)[0], want, True

    got, want, one_d = run(upper)
    tol = _tol(_np(want)[1], upper, one_d)
    assert _err(got, want) <= tol
    got, want, _ = run(lower)
    assert _err(got, want) > 1.2 * tol, (lower, upper, _err(got, want), tol)


# ---------------------------------------------------------------------------
# autograd: the port's Functions against jax.vjp of the JAX *_ad wrappers
# ---------------------------------------------------------------------------

def _grads(outs, cts, inputs):
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    loss = sum((o.float() * c.float()).sum() for o, c in zip(outs, cts))
    return torch.autograd.grad(loss, inputs)


def _leaf(t):
    return t.clone().requires_grad_(True)


def _cts(shapes_dtypes, seed):
    """Cotangents as (JAX arrays, tensors) in the outputs' dtypes."""
    js, ts = [], []
    for i, (shape, bf16) in enumerate(shapes_dtypes):
        j, t = _both(_rand(*shape, seed=seed + i, lo=-1, hi=1), bf16)
        js.append(j)
        ts.append(t)
    return js, ts


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
def test_fwd_level_2d_mxu_ad_matches_jax_vjp(mode):
    """The backward is the inverse level with reversed taps, in the same
    mode, into the input's dtype (bf16 mode: the rung's inverse scheme)."""
    jw, w = _pair("db4")
    jx, tx = _both(_rand(1, N2, N2, seed=20), bf16=mode == "bf16")
    m = N2 // 2
    jcts, tcts = _cts([((1, m, m), False)] + [((1, m, m), mode == "bf16")] * 3, 21)
    _, vjp = jax.vjp(lambda t: jk.fwd_level_2d_mxu_ad(t, tuple(jw.dec_lo), tuple(jw.dec_hi),
                                                      mode), jx)
    want = vjp(tuple(jcts))
    xt = _leaf(tx)
    got = _grads(M.fwd_level_2d_mxu_ad(xt, w.dec_lo, w.dec_hi, mode), tcts, [xt])
    _close(got, want, M.inv_plan(mode, tx.dtype)[0])


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
def test_inv_level_2d_mxu_ad_matches_jax_vjp(mode):
    """The backward is the forward level with reversed taps, each gradient
    in its input's dtype."""
    jw, w = _pair("db7")
    js, ts = _bands_2d(22, det_bf16=mode == "bf16")
    out_j = jnp.bfloat16 if mode == "bf16" else jnp.float32
    jcts, tcts = _cts([((1, N2, N2), mode == "bf16")], 23)
    _, vjp = jax.vjp(lambda *b: jk.inv_level_2d_mxu_ad(*b, tuple(jw.rec_lo), tuple(jw.rec_hi),
                                                       mode, out_j), *js)
    want = vjp(jcts[0])
    leaves = [_leaf(t) for t in ts]
    got = _grads(M.inv_level_2d_mxu_ad(*leaves, w.rec_lo, w.rec_hi, mode,
                                       BF16 if mode == "bf16" else F32), tcts, leaves)
    _close(got, want, M.mode_scheme(mode, BF16 if mode == "bf16" else F32))


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_fwd_level_1d_mxu_ad_matches_jax_vjp(mode, swt):
    """Decimated: the polyphase synthesis with reversed taps; a-trous: the
    a-trous synthesis with 2 * reversed taps."""
    jw, w = _pair("sym8")
    jx, tx = _both(_rand(B1, N1, seed=24, lo=-3, hi=3), bf16=mode == "bf16")
    n = N1 if swt else N1 // 2
    jcts, tcts = _cts([((B1, n), False), ((B1, n), mode == "bf16")], 25)
    lo_t, hi_t = tuple(jw.dec_lo), tuple(jw.dec_hi)
    if swt:
        fj = lambda t: jk.swt_fwd_level_1d_mxu_ad(t, lo_t, hi_t, 2, mode)
        fp = lambda t: M1.swt_fwd_level_1d_mxu_ad(t, w.dec_lo, w.dec_hi, 2, mode)
        scheme = M1._swt_inv_plan(mode, tx.dtype)[0]
    else:
        fj = lambda t: jk.fwd_level_1d_mxu_ad(t, lo_t, hi_t, mode)
        fp = lambda t: M1.fwd_level_1d_mxu_ad(t, w.dec_lo, w.dec_hi, mode)
        scheme = M.inv_plan(mode, tx.dtype)[0]
    _, vjp = jax.vjp(fj, jx)
    want = vjp(tuple(jcts))
    xt = _leaf(tx)
    _close(_grads(fp(xt), tcts, [xt]), want, scheme, True)


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_inv_level_1d_mxu_ad_matches_jax_vjp(mode, swt):
    """Decimated: the analysis with reversed taps; a-trous: the a-trous
    analysis with 0.5 * reversed taps."""
    jw, w = _pair("db4")
    n = N1 if swt else N1 // 2
    (jlo, tlo), (jhi, thi) = _bands_1d(26, hi_bf16=mode == "bf16", n=n)
    out_j, out_t = (jnp.bfloat16, BF16) if mode == "bf16" else (jnp.float32, F32)
    jcts, tcts = _cts([((B1, N1), mode == "bf16")], 27)
    lo_t, hi_t = tuple(jw.rec_lo), tuple(jw.rec_hi)
    if swt:
        fj = lambda lo, hi: jk.swt_inv_level_1d_mxu_ad(lo, hi, lo_t, hi_t, 2, mode, out_j)
        fp = lambda lo, hi: M1.swt_inv_level_1d_mxu_ad(lo, hi, w.rec_lo, w.rec_hi, 2, mode, out_t)
        scheme = M.swt_scheme(mode, out_t)
    else:
        fj = lambda lo, hi: jk.inv_level_1d_mxu_ad(lo, hi, lo_t, hi_t, mode, out_j)
        fp = lambda lo, hi: M1.inv_level_1d_mxu_ad(lo, hi, w.rec_lo, w.rec_hi, mode, out_t)
        scheme = M.mode_scheme(mode, out_t)
    _, vjp = jax.vjp(fj, jlo, jhi)
    want = vjp(jcts[0])
    leaves = [_leaf(tlo), _leaf(thi)]
    _close(_grads(fp(*leaves), tcts, leaves), want, scheme, True)


# ---------------------------------------------------------------------------
# port-only properties
# ---------------------------------------------------------------------------

def test_route_rules_copy_the_tpu_gates():
    """2D: even hlen <= 40, subbands divisible by 32 rows and 128 columns;
    1D: batch divisible by 16, output length by 128, the a-trous span within
    twice the column tile."""
    assert M.mxu_route_2d(1024, 1024, 14) and M.mxu_route_2d(32, 128, 40)
    assert not M.mxu_route_2d(64, 64, 14)       # level 5 of 2048^2: the exact tail
    assert not M.mxu_route_2d(1024, 1024, 15)   # odd filter
    assert not M.mxu_route_2d(1024, 1024, 42)   # longer than the band tiles
    assert not M.mxu_route_2d(48, 128, 14)
    assert M1.mxu_route_1d(1024, 4096, 16) and M1.mxu_route_1d(16, 256, 16)
    assert not M1.mxu_route_1d(8, 4096, 16) and not M1.mxu_route_1d(16, 4098, 16)
    assert M1.mxu_route_1d(1024, 4096, 16, level=4)          # span 120 <= 512
    assert not M1.mxu_route_1d(1024, 128, 16, level=6)       # span 480 > 256
    assert M1.mxu_route_1d(16, 128, 16, level=4) and not M1.mxu_route_1d(16, 200, 16, level=1)
    for B, n, hlen in [(32, 512, 16), (16, 384, 8), (48, 256, 4)]:
        ok = _pick_1d_tiles(B, n // 2) is not None and hlen % 2 == 0
        assert M1.mxu_route_1d(B, n, hlen) == ok


def test_schemes_follow_the_rungs(monkeypatch):
    """The rung's (forward, inverse) level-1 schemes, the b3 deep chain and
    the a-trous schemes, as JAX picks them."""
    from pdwt_tpu.core import precision as jprec
    from pdwt_tpu.kernels import matmul_pallas as jmp
    from pdwt_tpu.kernels import swt_matmul_pallas as jsm
    from pdwt_tpu_torch.core import precision

    for tier in ("bf16-fast", "bf16-balanced", "bf16-accurate"):
        with precision.precision_scope(tier), jprec.precision_scope(tier):
            assert M.bf16_l1_schemes() == jmp._bf16_l1_schemes()
            for dt, jdt in ((BF16, jnp.bfloat16), (F32, jnp.float32)):
                for mode in ("bf16", "mixed"):
                    assert M.mode_scheme(mode, dt) == jsm._mode_scheme(mode, jdt)
                    assert M.swt_scheme(mode, dt) == jsm._swt_scheme(mode, jdt)
    monkeypatch.setenv("PDWT_TPU_BF16_ACCURACY", "accurate")
    assert M.bf16_l1_schemes() == ("b3", "b3") == jmp._bf16_l1_schemes()
    with pytest.raises(ValueError, match="unknown MXU mode"):
        M.mode_scheme("exact", F32)


def test_scheme_taps_round_through_float32():
    """Taps go float64 -> float32 -> bf16: the split is of the float32 tap,
    and f_h + f_l holds it to about 2^-16."""
    f = np.array([0.1, -0.7071067811865476, 1e-3, 3.0])
    hi, lo = M.scheme_taps(f, "b3")
    f32 = f.astype(np.float32).astype(np.float64)
    assert np.array_equal(tensor_from_numpy(hi, dtype=BF16).double().numpy(), hi)
    assert np.abs(hi + lo - f32).max() <= 2.0 ** -16 * np.abs(f32).max()
    fd_hi, fd_lo = M.scheme_taps(f, "fd")
    assert np.array_equal(fd_hi, f32) and not fd_lo.any()


def test_cpu_mxu_wrappers_run_the_plain_versions_and_count_nothing():
    w = _pair("db2")[1]
    x = tensor_from_numpy(_rand(1, 64, 256), dtype=BF16)
    s = tensor_from_numpy(_rand(16, 256), dtype=BF16)
    reset_launch_counts()
    a, h, v, d = M.fwd_level_2d_mxu(x, w.dec_lo, w.dec_hi, "b1", (F32, BF16))
    for g, want in zip((a, h, v, d), M.fwd_level_2d_mxu_ref(x, w.dec_lo, w.dec_hi, "b1",
                                                            (F32, BF16))):
        assert torch.equal(g, want)
    assert torch.equal(M.inv_level_2d_mxu(a, h, v, d, w.rec_lo, w.rec_hi, "fd", BF16),
                       M.inv_level_2d_mxu_ref(a, h, v, d, w.rec_lo, w.rec_hi, "fd", BF16))
    lo, hi = M1.fwd_level_1d_mxu(s, w.dec_lo, w.dec_hi, "b2f", BF16)
    assert torch.equal(M1.inv_level_1d_mxu(lo, hi, w.rec_lo, w.rec_hi, "b3"),
                       M1.inv_level_1d_mxu_ref(lo, hi, w.rec_lo, w.rec_hi, "b3"))
    slo, shi = M1.swt_fwd_level_1d_mxu(s, w.dec_lo, w.dec_hi, 2, "b1", BF16)
    assert torch.equal(M1.swt_inv_level_1d_mxu(slo, shi, w.rec_lo, w.rec_hi, 2, "fd", BF16),
                       M1.swt_inv_level_1d_mxu_ref(slo, shi, w.rec_lo, w.rec_hi, 2, "fd", BF16))
    assert set(LAUNCHES) >= {"fwd_level_2d_mxu", "inv_level_2d_mxu", "fwd_level_1d_mxu",
                             "inv_level_1d_mxu", "swt_fwd_level_1d_mxu", "swt_inv_level_1d_mxu"}
    assert set(LAUNCHES.values()) == {0}


def test_mxu_wrappers_refuse_what_they_do_not_take():
    w = _pair("db2")[1]
    meta = torch.empty(1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        M.fwd_level_2d_mxu(meta, w.dec_lo, w.dec_hi, "b1")
    with pytest.raises(ValueError, match="unknown compute scheme"):
        M.fwd_level_2d_mxu_ref(torch.zeros(1, 8, 8), w.dec_lo, w.dec_hi, "b4")
    with pytest.raises(ValueError, match="unsupported device"):
        M1.swt_inv_level_1d_mxu(meta[0], meta[0], w.rec_lo, w.rec_hi, 1, "fd")
