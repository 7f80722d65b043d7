"""The precision tiers of the port against the JAX package's: the tier API
and its errors, the six decimated and batched 1D entry points under each
tier (the JAX side with ``backend="pallas"`` in interpret mode inside
``precision_scope``), the route rule level by level, the dtype contract,
the ``Wavelets`` facade with ``precision=``, the bf16 crossing of
``utils/convert.py`` and the ops on trees that mix a float32 approximation
with bf16 details.

Sizes put some levels on the banded-product kernels and the others on the
exact ones: a 256 x 256 db7 image to 3 levels (level 1 banded, levels 2-3
the exact tail) and an odd 70 x 134 image (exact throughout); 32 signals of
512 samples (sym8, levels 1-2 banded, level 3 exact) and 32 of 384 (db20
a-trous, levels 1-3 banded, level 4 exact: its dilated span outgrows the
column tile).

Tolerances, max|port - jax| relative to max|jax| over one output
(``tests/test_torch_mxu_kernels.py`` gives the reasons):

* bf16-stored outputs (details, the bf16 tiers' image): 2^-7;
* float32-stored outputs under ``bf16-fast`` and ``bf16-balanced``, whose
  2D level 1 rounds its row-pass result to bf16: 2e-3;
* float32-stored outputs under ``mixed`` and ``bf16-accurate`` (b3): 1e-4;
* the exact tier and the exact stationary 1D path under ``mixed``: 1e-5;
* norms: 1e-5 (float32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import Wavelets as JWavelets
from pdwt_tpu import kernels as jk
from pdwt_tpu import ops as jops
from pdwt_tpu.core import precision as jprec
from pdwt_tpu.core import separable as jsep
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu_torch import (TIERS, Wavelets, dwt1d, dwt2d, idwt1d, idwt2d, iswt1d, iswt2d,
                            iswt2d_denoise, kernels, ops, precision_scope, swt1d, swt2d)
from pdwt_tpu_torch.core import precision
from pdwt_tpu_torch.core.separable import Coeffs1D, Coeffs2D
from pdwt_tpu_torch.utils import (coeffs1d_from_numpy, coeffs1d_to_numpy, coeffs2d_from_numpy,
                                  coeffs2d_to_numpy, tensor_from_numpy, tensor_to_numpy,
                                  wavelet_from_arrays)

BF16_TIERS = ("bf16-fast", "bf16-balanced", "bf16-accurate")
TIERED = ("mixed",) + BF16_TIERS
TOL_BF16 = 2.0 ** -7
TOL_F32 = {"exact": 1e-5, "mixed": 1e-4, "bf16-fast": 2e-3, "bf16-balanced": 2e-3,
           "bf16-accurate": 1e-4}
NORM_RTOL = 1e-5
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")
    for knob in ("PDWT_TPU_PRECISION", "PDWT_TPU_BF16_ACCURACY", "PDWT_TPU_BF16_L1FWD",
                 "PDWT_TPU_BF16_L1INV", "PDWT_TPU_SWT_BF16_SCHEME"):
        monkeypatch.delenv(knob, raising=False)


def _pair(wname):
    jw = jget_wavelet(wname)
    return jw, wavelet_from_arrays(jw)


def _np(t):
    """(float32 host array, dtype name) of a tensor or a JAX array."""
    if isinstance(t, torch.Tensor):
        return tensor_to_numpy(t), str(t.dtype).split(".")[-1]
    return np.asarray(jnp.asarray(t).astype(jnp.float32)), jnp.dtype(t.dtype).name


def _flat(tree):
    """The leaves of a coefficient tree (port or JAX): approximation, then
    the details level by level."""
    if not hasattr(tree, "details"):
        return [tree]
    out = [tree.approx]
    for d in tree.details:
        out.extend(d if isinstance(d, (list, tuple)) else [d])
    return out


def _close(got, want, tier):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        (gv, gd), (wv, wd) = _np(g), _np(w)
        assert gv.shape == wv.shape and gd == wd, (gv.shape, gd, wv.shape, wd)
        tol = TOL_BF16 if wd == "bfloat16" else TOL_F32[tier]
        err = float(np.abs(gv - wv).max()) / float(np.abs(wv).max())
        assert err <= tol, (tier, err, tol)


def _rand(*shape, seed=0, lo=0.0, hi=255.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _inputs(arr, tier):
    """The same values as a JAX array and a tensor, bf16 under a bf16 tier."""
    j = jnp.asarray(arr)
    bf16 = tier.startswith("bf16-")
    return (j.astype(jnp.bfloat16) if bf16 else j), tensor_from_numpy(
        arr, dtype=BF16 if bf16 else F32)


def _to_port_2d(c):
    return coeffs2d_from_numpy(*coeffs2d_to_numpy(c))


def _to_port_1d(c):
    return coeffs1d_from_numpy(*coeffs1d_to_numpy(c))


# ---------------------------------------------------------------------------
# the tier API
# ---------------------------------------------------------------------------

def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "ValueError", str(e).split(";")[0].split("(")[0]


def test_tier_names_scopes_and_environment_defaults_follow_jax(monkeypatch):
    assert TIERS == jprec.TIERS
    for tier in ("exact", "fast", "bf16", None):
        if tier is not None:
            assert _outcome(precision.check_tier, tier) == _outcome(jprec.check_tier, tier)
    with precision_scope("mixed"):
        assert precision.current() == "mixed" and precision.mixed_requested()
        with precision_scope(None), precision_scope("bf16-balanced"):
            assert precision.current() == "bf16-balanced"
            assert precision.bf16_accuracy() == "balanced" and not precision.mixed_requested()
        assert precision.current() == "mixed"
    assert precision.current() is None
    with pytest.raises(ValueError, match="unknown precision tier"):
        with precision_scope("fast"):
            pass
    for env_prec in ("", "mixed", "bf16x3", "MIXED", "exact"):
        for env_acc in ("fast", "accurate"):
            monkeypatch.setenv("PDWT_TPU_PRECISION", env_prec)
            monkeypatch.setenv("PDWT_TPU_BF16_ACCURACY", env_acc)
            for tier in (None,) + TIERS:
                with precision_scope(tier), jprec.precision_scope(tier):
                    assert precision.mixed_requested() == jprec.mixed_requested()
                    assert precision.bf16_accuracy() == jprec.bf16_accuracy()
    monkeypatch.setenv("PDWT_TPU_BF16_ACCURACY", "typo")
    assert _outcome(precision.bf16_accuracy) == _outcome(jprec.bf16_accuracy)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_tier_for_follows_jax(dtype):
    for tier in (None,) + TIERS:
        got = _outcome(precision.tier_for, getattr(torch, dtype), tier)
        want = _outcome(jprec.tier_for, dtype, tier)
        assert got[0] == want[0], (dtype, tier, got, want)
        if got[0] == "ok":
            assert got == want


def test_precision_keyword_checks_the_dtypes_as_jax_does():
    jw, w = _pair("db2")
    x = np.zeros((16, 16), np.float32)
    cases = [("bf16-fast", False), ("mixed", True), ("exact", True), ("bf16-accurate", True),
             ("mixed", False)]
    for tier, bf16 in cases:
        jx, tx = _inputs(x, "bf16-" if bf16 else "exact")
        got = _outcome(lambda: dwt2d(tx, w, 1, precision=tier))[0]
        want = _outcome(lambda: jsep.idwt2d(jsep.dwt2d(jx, jw, 1), jw, (16, 16),
                                            precision=tier))[0]
        assert got == want, (tier, bf16)
        if got == "ValueError":
            with pytest.raises(ValueError, match="does not match the input dtypes"):
                idwt1d(dwt1d(tx, w, 1), w, 16, precision=tier)
    with pytest.raises(ValueError, match="unknown precision tier"):
        swt1d(torch.zeros(16), w, 1, precision="nope")
    # the bf16 2D SWT (kernels 13-14) keeps the bf16 dtype contract
    c = swt2d(torch.zeros(16, 16, dtype=BF16), w, 1)
    assert c.approx.dtype == F32 and c.details[0][0].dtype == BF16
    assert iswt2d_denoise(c, w, 1.0).dtype == BF16


# ---------------------------------------------------------------------------
# the six entry points under each tier against JAX's Pallas path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", TIERED)
@pytest.mark.parametrize("shape,levels", [((256, 256), 3), ((70, 134), 2)])
def test_dwt2d_idwt2d_match_jax(tier, shape, levels):
    """The forward from the same image; the inverse from JAX's coefficients
    (carried over bit for bit, bf16 details included)."""
    jw, w = _pair("db7")
    jx, tx = _inputs(_rand(*shape, seed=1), tier)
    with jprec.precision_scope(tier):
        jc = jsep.dwt2d(jx, jw, levels, backend="pallas")
        jy = jsep.idwt2d(jc, jw, shape, backend="pallas")
    c = dwt2d(tx, w, levels, precision=tier)
    _close(c, jc, tier)
    _close(idwt2d(_to_port_2d(jc), w, shape, precision=tier), jy, tier)


@pytest.mark.parametrize("tier", TIERED)
def test_dwt1d_idwt1d_match_jax(tier):
    jw, w = _pair("sym8")
    jx, tx = _inputs(_rand(2, 16, 512, seed=2, lo=-3, hi=3), tier)
    with jprec.precision_scope(tier):
        jc = jsep.dwt1d(jx, jw, 3, backend="pallas")
        jy = jsep.idwt1d(jc, jw, 512, backend="pallas")
    _close(dwt1d(tx, w, 3, precision=tier), jc, tier)
    _close(idwt1d(_to_port_1d(jc), w, 512, precision=tier), jy, tier)


@pytest.mark.parametrize("tier", TIERED)
def test_swt1d_iswt1d_match_jax(tier):
    """``mixed`` runs the stationary 1D transform exact, as JAX does."""
    jw, w = _pair("db20")
    jx, tx = _inputs(_rand(32, 384, seed=3, lo=-3, hi=3), tier)
    with jprec.precision_scope(tier):
        jc = jsep.swt1d(jx, jw, 4, backend="pallas")
        jy = jsep.iswt1d(jc, jw, backend="pallas")
    tol_tier = "exact" if tier == "mixed" else tier
    _close(swt1d(tx, w, 4, precision=tier), jc, tol_tier)
    _close(iswt1d(_to_port_1d(jc), w, precision=tier), jy, tol_tier)


def _spy(monkeypatch, module, names):
    """Count the calls of ``module.<name>`` that returned a result."""
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(module, n)

        def wrapped(*a, _fn=fn, _n=n, **k):
            out = _fn(*a, **k)
            calls[_n] += out is not None
            return out
        monkeypatch.setattr(module, n, wrapped)
    return calls


ROUTE_2D = ("fwd_level_2d_mxu_ad", "inv_level_2d_mxu_ad", "fwd_level_2d_ad", "inv_level_2d_ad",
            "fwd_tail_2d_ad", "inv_tail_2d_ad")
ROUTE_1D = ("fwd_level_1d_mxu_ad", "inv_level_1d_mxu_ad", "swt_fwd_level_1d_mxu_ad",
            "swt_inv_level_1d_mxu_ad", "fwd_level_1d_ad", "inv_level_1d_ad",
            "swt_fwd_level_1d_ad", "swt_inv_level_1d_ad")


@pytest.mark.parametrize("tier", ["mixed", "bf16-fast"])
def test_route_rule_picks_the_levels_jax_picks(monkeypatch, tier):
    """The banded-product kernels run on the same levels on both sides:
    where the TPU tiles fit, never on ``mixed`` stationary levels.  The
    port's exact kernels (or tail) take the other levels, where some JAX
    exact kernels fall back to their fma formulation."""
    jw, w = _pair("db7")
    jcalls = _spy(monkeypatch, jk, ROUTE_2D + ROUTE_1D)
    calls = _spy(monkeypatch, kernels, ROUTE_2D + ROUTE_1D)
    jx, tx = _inputs(_rand(256, 256, seed=4), tier)
    js, ts = _inputs(_rand(32, 512, seed=5), tier)
    with jprec.precision_scope(tier):
        jsep.idwt2d(jsep.dwt2d(jx, jw, 3, backend="pallas"), jw, (256, 256), backend="pallas")
        jsep.idwt1d(jsep.dwt1d(js, jw, 3, backend="pallas"), jw, 512, backend="pallas")
        jsep.iswt1d(jsep.swt1d(js, jw, 2, backend="pallas"), jw, backend="pallas")
    with precision_scope(tier):
        idwt2d(dwt2d(tx, w, 3), w, (256, 256))
        idwt1d(dwt1d(ts, w, 3), w, 512)
        iswt1d(swt1d(ts, w, 2), w)
    mxu = [n for n in calls if n.endswith("_mxu_ad")]
    assert {n: calls[n] for n in mxu} == {n: jcalls[n] for n in mxu}
    assert calls["fwd_level_2d_mxu_ad"] == calls["inv_level_2d_mxu_ad"] == 1
    assert calls["fwd_tail_2d_ad"] == calls["inv_tail_2d_ad"] == 1
    assert calls["fwd_level_1d_mxu_ad"] == calls["inv_level_1d_mxu_ad"] == 2
    assert calls["swt_fwd_level_1d_mxu_ad"] == (0 if tier == "mixed" else 2)


@pytest.mark.parametrize("tier", TIERED)
def test_dtype_contract(tier):
    """bf16 tiers: float32 approximation, bf16 details, bf16 image; mixed:
    float32 throughout.  Also where the exact tail covers every level."""
    w = _pair("db4")[1]
    bf16 = tier.startswith("bf16-")
    det, out = (BF16, BF16) if bf16 else (F32, F32)
    for shape, levels in [((256, 256), 2), ((96, 96), 1), ((3, 95, 187), 2)]:
        x = _inputs(_rand(*shape, seed=6), tier)[1]
        c = dwt2d(x, w, levels, precision=tier)
        assert c.approx.dtype == F32
        assert all(t.dtype == det for band in c.details for t in band)
        y = idwt2d(c, w, shape[-2:], precision=tier)
        assert y.dtype == out and y.shape == x.shape
        assert float((y.float() - x.float()).abs().max()) < (3.0 if bf16 else 0.05)
    s = _inputs(_rand(16, 256, seed=7), tier)[1]
    for fwd, inv in ((dwt1d, lambda c: idwt1d(c, w, 256)), (swt1d, lambda c: iswt1d(c, w))):
        c = fwd(s, w, 2, precision=tier)
        assert c.approx.dtype == F32 and all(d.dtype == det for d in c.details)
        assert inv(c).dtype == out


def test_mixed_runs_the_2d_stationary_transform_exact():
    jw, w = _pair("db3")
    x = _rand(64, 96, seed=8)
    with jprec.precision_scope("mixed"):
        jc = jsep.swt2d(jnp.asarray(x), jw, 2, backend="pallas")
        jy = jsep.iswt2d(jc, jw, backend="pallas")
    c = swt2d(torch.from_numpy(x), w, 2, precision="mixed")
    _close(c, jc, "exact")
    _close(iswt2d(c, w, precision="mixed"), jy, "exact")


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", TIERED)
def test_facade_with_a_tier_matches_jax(tier):
    """forward, soft_threshold, norm1, inverse on both facades; JAX on its
    Pallas path in interpret mode."""
    img = _rand(256, 256, seed=9)
    J = JWavelets(img, wname="db7", levels=3, backend="pallas", precision=tier)
    W = Wavelets(img, wname="db7", levels=3, precision=tier, device="cpu")
    assert W.spec.precision == J.spec.precision == tier
    assert str(W.spec.dtype).split(".")[-1] == jnp.dtype(J.spec.dtype).name
    _close(W.forward(), J.forward(), tier)
    W.soft_threshold(10.0)
    J.soft_threshold(10.0)
    n1, jn1 = W.norm1(), J.norm1()
    assert abs(n1 - jn1) <= 1e-4 * abs(jn1)
    _close(W.inverse(), J.inverse(), tier)
    assert W.get_image().dtype == np.float32


def test_facade_precision_defaults_and_errors():
    img = _rand(32, 32)
    assert Wavelets(img, wname="db2", device="cpu").spec.precision == "auto"
    W = Wavelets(img, wname="db2", precision="bf16-balanced", device="cpu")
    assert W.spec.dtype == BF16 and W.d_image.dtype == BF16 and W.coeffs.approx.dtype == F32
    assert "precision=bf16-balanced" in repr(W)
    for kw in ({"precision": "mixed", "dtype": BF16}, {"precision": "bf16-fast", "dtype": F32},
               {"precision": "mixed", "dtype": torch.float64}):
        with pytest.raises(ValueError, match="precision"):
            Wavelets(img, wname="db2", device="cpu", **kw)
    T = Wavelets(img, wname="db2", levels=2, do_swt=True, precision="mixed", device="cpu")
    T.forward()
    assert float((T.inverse() - torch.from_numpy(img)).abs().max()) < 1e-3
    S = Wavelets(_rand(16, 256), wname="sym8", levels=2, ndim=1, precision="bf16-fast",
                 device="cpu")
    out, n1 = S.run_denoise(1.0)
    assert out.dtype == BF16 and out.shape == (16, 256) and np.isfinite(float(n1))


def test_facade_scope_does_not_leak(monkeypatch):
    """The facade's tier is active only while it transforms."""
    monkeypatch.setenv("PDWT_TPU_PRECISION", "mixed")
    W = Wavelets(_rand(256, 256), wname="db7", levels=1, precision="exact", device="cpu")
    calls = _spy(monkeypatch, kernels, ("fwd_level_2d_mxu_ad",))
    W.forward()
    assert calls["fwd_level_2d_mxu_ad"] == 0
    dwt2d(torch.from_numpy(_rand(256, 256)), W._wavelet, 1)
    assert calls["fwd_level_2d_mxu_ad"] == 1


# ---------------------------------------------------------------------------
# bf16 crossing and ops on trees of mixed dtype
# ---------------------------------------------------------------------------

def test_bf16_crosses_between_the_packages_bit_for_bit():
    jx = jnp.asarray(_rand(5, 7, seed=10, lo=-300, hi=300)).astype(jnp.bfloat16)
    arr = np.asarray(jx)
    assert arr.dtype.name == "bfloat16"
    t = tensor_from_numpy(arr)
    assert t.dtype == BF16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), arr.view(np.uint16))
    back = tensor_to_numpy(t)
    assert back.dtype == np.float32 and np.array_equal(back, np.asarray(jx.astype(jnp.float32)))
    jw = jget_wavelet("db2")
    jc = jsep.dwt2d(jnp.asarray(_rand(32, 32)).astype(jnp.bfloat16), jw, 2, backend="fma")
    c = _to_port_2d(jc)
    assert [str(t.dtype) for t in _flat(c)] == [f"torch.{jnp.dtype(t.dtype).name}"
                                               for t in _flat(jc)]
    j1 = jsep.dwt1d(jnp.asarray(_rand(4, 64)).astype(jnp.bfloat16), jw, 2, backend="fma")
    assert _to_port_1d(j1).details[0].dtype == BF16
    assert tensor_from_numpy(np.zeros(3, np.float64), dtype=F32).dtype == F32


def _mixed_trees(ndim):
    """A JAX tree of a float32 approximation with bf16 details (the bf16
    tiers' forward), and the port's copy of it."""
    if ndim == 2:
        jc = jsep.dwt2d(jnp.asarray(_rand(64, 64, seed=11)).astype(jnp.bfloat16),
                        jget_wavelet("db3"), 2, backend="fma")
        jc = type(jc)(jc.approx.astype(jnp.float32), jc.details)
        return jc, _to_port_2d(jc)
    jc = jsep.dwt1d(jnp.asarray(_rand(4, 128, seed=12, lo=-5, hi=5)).astype(jnp.bfloat16),
                    jget_wavelet("db3"), 3, backend="fma")
    jc = type(jc)(jc.approx.astype(jnp.float32), jc.details)
    return jc, _to_port_1d(jc)


@pytest.mark.parametrize("ndim", [2, 1])
@pytest.mark.parametrize("op,kw", [("soft_threshold", {}),
                                   ("soft_threshold", {"normalize": True,
                                                       "do_thresh_appcoeffs": True}),
                                   ("hard_threshold", {"do_thresh_appcoeffs": True}),
                                   ("garrote_threshold", {"normalize": True})])
def test_ops_on_mixed_dtype_trees_match_jax(ndim, op, kw):
    """beta is rounded to each band's dtype; norms accumulate bf16 in
    float32."""
    jc, c = _mixed_trees(ndim)
    beta = 7.3 if ndim == 2 else 1.3
    got, want = getattr(ops, op)(c, beta, **kw), getattr(jops, op)(jc, beta, **kw)
    _close(got, want, "exact")
    for norm in ("norm1", "norm2sq"):
        g, j = float(getattr(ops, norm)(got)), float(getattr(jops, norm)(want))
        assert abs(g - j) <= NORM_RTOL * abs(j), (norm, g, j)
    mode = op.split("_")[0]
    g = float(ops.thresholded_norm1(c, beta, mode=mode, **kw))
    j = float(jops.thresholded_norm1(jc, beta, mode=mode, **kw))
    assert abs(g - j) <= NORM_RTOL * abs(j)
