"""The bf16 2D stationary transform of the port (kernels 13-14,
``kernels/swt_matmul.py``) against the JAX package on the CPU: the plain
versions against the Pallas kernels in interpret mode, scheme by scheme and
threshold by threshold; a ladder that shows the tolerances tell
neighbouring schemes apart; the autograd Functions against ``jax.vjp`` of
the JAX ``*_ad`` wrappers (beta included); the route rule against JAX's
gate over a sweep; and ``swt2d``/``iswt2d``/``iswt2d_denoise`` in bf16
under each rung against JAX ``backend="pallas"``.

The JAX side picks a scheme with ``PDWT_TPU_SWT_BF16_SCHEME`` (it overrides
the a-trous scheme both ways) or with the rung; the port is handed it.
Images are 64 x 256 (TR = 64, TC = 256 on the TPU: level 4 of db7 is the
deepest on the route) and 128 x 256; inputs are made with numpy from a seed.

Tolerances, max|port - jax| relative to max|jax| over one output, as in
``tests/test_torch_mxu_kernels.py``: float32-stored outputs 2e-3 for b1 and
b2f (the float32 row-pass result is rounded to bf16 before the column pass;
a sum in another order can flip one such rounding), 1e-4 for b2d and b3,
1e-5 for fd; bf16-stored outputs 2^-7 (one rounding flipped).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import kernels as jk
from pdwt_tpu.core import precision as jprec
from pdwt_tpu.core import separable as jsep
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu.kernels.swt_matmul_pallas import _swt_mxu_tiles
from pdwt_tpu_torch import iswt2d, iswt2d_denoise, swt2d
from pdwt_tpu_torch.core.separable import Coeffs2D
from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from pdwt_tpu_torch.kernels import matmul as M
from pdwt_tpu_torch.kernels import swt_matmul as SM
from pdwt_tpu_torch.utils import tensor_from_numpy, tensor_to_numpy, wavelet_from_arrays

TOL_F32 = {"b1": 2e-3, "b2f": 2e-3, "b2d": 1e-4, "b3": 1e-4, "fd": 1e-5}
TOL_BF16 = 2.0 ** -7
SCHEMES = ("b1", "fd", "b2f", "b2d", "b3")
THRESHOLDS = (None, "soft", "hard", "garrote")
R, C = 64, 256
F32, BF16 = torch.float32, torch.bfloat16
RUNGS = ("fast", "balanced", "accurate")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")
    for knob in ("PDWT_TPU_BF16_L1FWD", "PDWT_TPU_BF16_L1INV", "PDWT_TPU_BF16_ACCURACY",
                 "PDWT_TPU_SWT_BF16_SCHEME", "PDWT_TPU_PRECISION", "PDWT_TPU_MXU_TILES",
                 "PDWT_TPU_INKERNEL_HALO"):
        monkeypatch.delenv(knob, raising=False)


def _pair(wname):
    jw = jget_wavelet(wname)
    return jw, wavelet_from_arrays(jw)


def _np(t):
    if isinstance(t, torch.Tensor):
        return tensor_to_numpy(t), str(t.dtype).split(".")[-1]
    return np.asarray(jnp.asarray(t).astype(jnp.float32)), jnp.dtype(t.dtype).name


def _err(got, want):
    (g, gd), (w, wd) = _np(got), _np(want)
    assert g.shape == w.shape and gd == wd, (g.shape, gd, w.shape, wd)
    return float(np.abs(g - w).max()) / float(np.abs(w).max())


def _close(got, want, scheme):
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        tol = TOL_BF16 if _np(w)[1] == "bfloat16" else TOL_F32[scheme]
        err = _err(g, w)
        assert err <= tol, (scheme, err, tol)


def _rand(*shape, seed=0, lo=0.0, hi=255.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _both(arr, bf16):
    j = jnp.asarray(arr)
    if bf16:
        j = j.astype(jnp.bfloat16)
    return j, tensor_from_numpy(arr, dtype=BF16 if bf16 else F32)


def _bands(seed, det_bf16, level=1, shape=(1, R, C)):
    """(a, h, v, d) of one exact a-trous level of a [0, 255] image, as JAX
    arrays and tensors: a float32, the details bf16 or float32."""
    jw = jget_wavelet("db7")
    x = jnp.asarray(_rand(*shape, seed=seed))
    a, h, v, d = jk.swt_fwd_level_2d(x, jw.dec_lo, jw.dec_hi, level)
    js = [a] + [t.astype(jnp.bfloat16) if det_bf16 else t for t in (h, v, d)]
    return js, [tensor_from_numpy(np.asarray(t.astype(jnp.float32)),
                                  dtype=BF16 if t.dtype == jnp.bfloat16 else F32) for t in js]


# ---------------------------------------------------------------------------
# kernel 13: the a-trous analysis level, scheme by scheme
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("in_bf16,level", [(True, 1), (False, 2)], ids=["bf16-L1", "f32-L2"])
def test_swt_fwd_level_2d_mxu_ref_matches_pallas(monkeypatch, scheme, in_bf16, level):
    """bf16 input (level 1 of the bf16 tiers) and the float32 chain."""
    jw, w = _pair("db7")
    jx, tx = _both(_rand(1, R, C, seed=level), in_bf16)
    monkeypatch.setenv("PDWT_TPU_SWT_BF16_SCHEME", scheme)
    want = jk.swt_fwd_level_2d_mxu(jx, jw.dec_lo, jw.dec_hi, level, "bf16")
    _close(SM.swt_fwd_level_2d_mxu_ref(tx, w.dec_lo, w.dec_hi, level, scheme, (F32, BF16)),
           want, scheme)


@pytest.mark.parametrize("wname,shape,level", [("db7", (1, R, C), 4), ("db4", (2, 128, 256), 3),
                                               ("haar", (1, R, C), 6)])
def test_swt_fwd_level_2d_mxu_ref_matches_pallas_mixed_and_deep(wname, shape, level):
    """``mixed`` (b3, all float32) at the deepest routed levels, a batch of 2."""
    jw, w = _pair(wname)
    jx, tx = _both(_rand(*shape, seed=5), False)
    assert SM.mxu_route_swt_2d(shape[1], shape[2], w.hlen, level)
    want = jk.swt_fwd_level_2d_mxu(jx, jw.dec_lo, jw.dec_hi, level, "mixed")
    _close(SM.swt_fwd_level_2d_mxu_ref(tx, w.dec_lo, w.dec_hi, level, "b3"), want, "b3")


# ---------------------------------------------------------------------------
# kernel 14: the a-trous synthesis level with the fused threshold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_swt_inv_level_2d_mxu_ref_matches_pallas(monkeypatch, scheme, thr):
    """The bf16 tiers' last inverse level: float32 a, bf16 details, bf16 out,
    every threshold (beta 10 on [0, 255] data)."""
    jw, w = _pair("db7")
    js, ts = _bands(2, det_bf16=True)
    monkeypatch.setenv("PDWT_TPU_SWT_BF16_SCHEME", scheme)
    threshold = None if thr is None else (thr, 10.0)
    want = jk.swt_inv_level_2d_mxu(*js, jw.rec_lo, jw.rec_hi, 1, "bf16",
                                   out_dtype=jnp.bfloat16, threshold=threshold)
    _close(SM.swt_inv_level_2d_mxu_ref(*ts, w.rec_lo, w.rec_hi, 1, scheme, BF16, threshold),
           want, scheme)


@pytest.mark.parametrize("mode,scheme", [("bf16", "fd"), ("bf16", "b2f"), ("mixed", "b3")])
@pytest.mark.parametrize("thr", ["soft", "garrote"])
def test_swt_inv_level_2d_mxu_ref_matches_pallas_f32_out(monkeypatch, mode, scheme, thr):
    """Deep inverse levels: float32 out (bf16 details under ``bf16``, all
    float32 under ``mixed``), a tensor beta."""
    jw, w = _pair("db7")
    js, ts = _bands(3, det_bf16=mode == "bf16", level=3)
    if scheme == "b2f":
        monkeypatch.setenv("PDWT_TPU_BF16_ACCURACY", "balanced")
    assert SM.swt2d_inv_plan(mode, F32) == (scheme, F32)
    want = jk.swt_inv_level_2d_mxu(*js, jw.rec_lo, jw.rec_hi, 3, mode, out_dtype=jnp.float32,
                                   threshold=(thr, jnp.asarray(7.5, jnp.float32)))
    got = SM.swt_inv_level_2d_mxu_ref(*ts, w.rec_lo, w.rec_hi, 3, scheme, F32,
                                      (thr, torch.tensor(7.5)))
    _close(got, want, scheme)


# ---------------------------------------------------------------------------
# the ladder: each tolerance is tighter than the gap to the next scheme
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,lower,upper", [
    ("fwd", "b1", "b2f"), ("fwd", "b2f", "b3"), ("fwd", "b2d", "b3"), ("fwd", "b1", "fd"),
    ("inv", "b1", "b2f"), ("inv", "b2f", "b3"), ("inv", "fd", "b2f")])
def test_tolerances_tell_neighbouring_schemes_apart(monkeypatch, kernel, lower, upper):
    """The port run with ``upper`` passes the comparison with JAX run with
    ``upper``; run with ``lower`` it fails it by a factor of at least 1.2.
    Forward: the float32 approximation of a bf16 image at level 1 (``b1``
    against ``fd`` on the float32 chain at level 2, where the fast rung
    switches); inverse: the float32 output of level 3 with a soft threshold
    (at level 1 the output's bf16 rounding hides the scheme).
    ``fd`` is a float32 sum here, as in JAX on the CPU, so it sits beside
    ``b3``, not below it, and is not laddered against it."""
    jw, w = _pair("db7")
    monkeypatch.setenv("PDWT_TPU_SWT_BF16_SCHEME", upper)

    def run(port_scheme):
        if kernel == "fwd":
            level = 2 if upper == "fd" else 1
            jx, tx = _both(_rand(1, R, C, seed=11), bf16=level == 1)
            want = jk.swt_fwd_level_2d_mxu(jx, jw.dec_lo, jw.dec_hi, level, "bf16")[0]
            return SM.swt_fwd_level_2d_mxu_ref(tx, w.dec_lo, w.dec_hi, level, port_scheme)[0], \
                want
        js, ts = _bands(12, det_bf16=True, level=3)
        want = jk.swt_inv_level_2d_mxu(*js, jw.rec_lo, jw.rec_hi, 3, "bf16",
                                       out_dtype=jnp.float32, threshold=("soft", 10.0))
        return SM.swt_inv_level_2d_mxu_ref(*ts, w.rec_lo, w.rec_hi, 3, port_scheme, F32,
                                           ("soft", 10.0)), want

    got, want = run(upper)
    tol = TOL_BF16 if _np(want)[1] == "bfloat16" else TOL_F32[upper]
    assert _err(got, want) <= tol
    got, want = run(lower)
    assert _err(got, want) > 1.2 * tol, (lower, upper, _err(got, want), tol)


# ---------------------------------------------------------------------------
# autograd against jax.vjp
# ---------------------------------------------------------------------------

def _grads(outs, cts, inputs):
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    loss = sum((o.float() * c.float()).sum() for o, c in zip(outs, cts))
    return torch.autograd.grad(loss, inputs)


def _leaf(t):
    return t.clone().requires_grad_(True)


def _cts(specs, seed):
    js, ts = [], []
    for i, (shape, bf16) in enumerate(specs):
        j, t = _both(_rand(*shape, seed=seed + i, lo=-1, hi=1), bf16)
        js.append(j)
        ts.append(t)
    return js, ts


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
def test_swt_fwd_level_2d_mxu_ad_matches_jax_vjp(mode):
    """The backward is the inverse kernel with 2 * reversed taps, in the
    same mode, into the input's dtype."""
    jw, w = _pair("db4")
    jx, tx = _both(_rand(1, R, C, seed=20), bf16=mode == "bf16")
    jcts, tcts = _cts([((1, R, C), False)] + [((1, R, C), mode == "bf16")] * 3, 21)
    _, vjp = jax.vjp(lambda t: jk.swt_fwd_level_2d_mxu_ad(t, tuple(jw.dec_lo), tuple(jw.dec_hi),
                                                          2, mode), jx)
    want = vjp(tuple(jcts))
    xt = _leaf(tx)
    got = _grads(SM.swt_fwd_level_2d_mxu_ad(xt, w.dec_lo, w.dec_hi, 2, mode), tcts, [xt])
    _close(got, want, SM.swt2d_inv_plan(mode, tx.dtype)[0])


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
def test_swt_inv_level_2d_mxu_ad_matches_jax_vjp(mode):
    """The backward is the forward kernel with 0.5 * reversed taps, each
    gradient in its input's dtype."""
    jw, w = _pair("db7")
    js, ts = _bands(22, det_bf16=mode == "bf16")
    out_j, out_t = (jnp.bfloat16, BF16) if mode == "bf16" else (jnp.float32, F32)
    jcts, tcts = _cts([((1, R, C), mode == "bf16")], 23)
    _, vjp = jax.vjp(lambda *b: jk.swt_inv_level_2d_mxu_ad(*b, tuple(jw.rec_lo),
                                                           tuple(jw.rec_hi), 1, mode, out_j), *js)
    want = vjp(jcts[0])
    leaves = [_leaf(t) for t in ts]
    got = _grads(SM.swt_inv_level_2d_mxu_ad(*leaves, w.rec_lo, w.rec_hi, 1, mode, out_t), tcts,
                 leaves)
    _close(got, want, M.swt_scheme(mode, out_t))


@pytest.mark.parametrize("thr", ["soft", "hard", "garrote"])
def test_swt_inv_level_2d_mxu_denoise_ad_matches_jax_vjp(thr):
    """The fused denoise's backward: the forward kernel on the cotangent,
    masked by the un-thresholded details, and the gradient of beta."""
    jw, w = _pair("db7")
    js, ts = _bands(24, det_bf16=True)
    jcts, tcts = _cts([((1, R, C), True)], 25)
    jbeta = jnp.asarray(10.0, jnp.float32)
    _, vjp = jax.vjp(lambda a, h, v, d, b: jk.swt_inv_level_2d_mxu_denoise_ad(
        a, h, v, d, b, tuple(jw.rec_lo), tuple(jw.rec_hi), 1, "bf16", thr, jnp.bfloat16),
        *js, jbeta)
    want = vjp(jcts[0])
    leaves = [_leaf(t) for t in ts] + [torch.tensor(10.0, requires_grad=True)]
    out = SM.swt_inv_level_2d_mxu_denoise_ad(*leaves[:4], leaves[4], w.rec_lo, w.rec_hi, 1,
                                             "bf16", thr, BF16)
    got = _grads(out, tcts, leaves)
    scheme = M.swt_scheme("bf16", BF16)
    _close(got[:4], want[:4], scheme)
    gb, wb = float(got[4]), float(want[4])
    assert abs(gb - wb) <= 1e-3 * max(abs(wb), 1.0), (gb, wb)


# ---------------------------------------------------------------------------
# the route rule against JAX's gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hlen", [2, 4, 8, 14, 16, 20, 32, 40, 41, 42])
def test_route_rule_matches_the_tpu_gate(hlen):
    """Over sizes, levels and schemes, the port's rule (which has no VMEM
    estimate) agrees with ``_swt_mxu_tiles`` (which has one): the estimate
    never binds for 40 taps or fewer."""
    sizes = [32, 48, 64, 96, 128, 192, 256, 384, 512, 1024]
    for r in sizes:
        for c in (128, 192, 256, 384, 512, 2048):
            for level in range(1, 10):
                want = {s: _swt_mxu_tiles(r, c, hlen, 1 << (level - 1), s) is not None
                        for s in SCHEMES}
                assert len(set(want.values())) == 1, (r, c, hlen, level, want)
                assert SM.mxu_route_swt_2d(r, c, hlen, level) == want["b1"], (r, c, hlen, level)


def test_route_covers_the_ti_step_and_refuses_deep_levels():
    """db7 at 1024^2: levels 1-5 on the route (span 13 * 2^(L-1) <= 256), 6
    not; odd sizes never."""
    assert all(SM.mxu_route_swt_2d(1024, 1024, 14, lv) for lv in range(1, 6))
    assert not SM.mxu_route_swt_2d(1024, 1024, 14, 6)
    assert not SM.mxu_route_swt_2d(37, 53, 14, 1)
    assert not SM.mxu_route_swt_2d(1024, 1024, 15, 1)


# ---------------------------------------------------------------------------
# the entry points in bf16 under each rung against JAX's Pallas path
# ---------------------------------------------------------------------------

def _coeffs_np(c):
    return [_np(c.approx)] + [_np(t) for band in c.details for t in band]


def _assert_tree(got, want, scheme_f32):
    g, w = _coeffs_np(got), _coeffs_np(want)
    for (ga, gd), (wa, wd) in zip(g, w):
        assert gd == wd and ga.shape == wa.shape
        tol = TOL_BF16 if wd == "bfloat16" else TOL_F32[scheme_f32]
        assert np.abs(ga - wa).max() <= tol * np.abs(wa).max()


def _jcoeffs(c):
    """A port Coeffs2D from JAX's, dtypes kept."""
    t = lambda a: tensor_from_numpy(np.asarray(a.astype(jnp.float32)),
                                    dtype=BF16 if a.dtype == jnp.bfloat16 else F32)
    return Coeffs2D(t(c.approx), tuple(tuple(t(u) for u in band) for band in c.details))


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("shape,levels", [((R, C), 5), ((37, 53), 2)], ids=["64x256", "odd"])
def test_swt2d_iswt2d_bf16_match_jax(rung, shape, levels):
    """Forward from the same bf16 image (64 x 256: levels 1-4 routed, 5 on
    the exact kernel; 37 x 53 off the route); inverse from JAX's
    coefficients, bf16 out."""
    jw, w = _pair("db7")
    tier = "bf16-" + rung
    jx, tx = _both(_rand(*shape, seed=30), bf16=True)
    with jprec.precision_scope(tier):
        jc = jsep.swt2d(jx, jw, levels, backend="pallas")
        jy = jsep.iswt2d(jc, jw, backend="pallas")
    tc = swt2d(tx, w, levels, precision=tier)
    # a b2f/b1 row pass rounds to bf16: as the level kernels' f32 tolerance
    _assert_tree(tc, jc, "b2f")
    ty = iswt2d(_jcoeffs(jc), w, precision=tier)
    assert ty.dtype == BF16 and _err(ty, jy) <= TOL_BF16


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("mode,normalize,app", [("soft", False, False), ("garrote", True, True)])
def test_iswt2d_denoise_bf16_matches_jax(rung, mode, normalize, app):
    """The fused threshold inside kernel 14 at every routed level."""
    jw, w = _pair("db7")
    tier = "bf16-" + rung
    jx, _ = _both(_rand(R, C, seed=31), bf16=True)
    with jprec.precision_scope(tier):
        jc = jsep.swt2d(jx, jw, 3, backend="pallas")
        jy = jsep.iswt2d_denoise(jc, jw, 10.0, mode=mode, normalize=normalize,
                                 do_thresh_appcoeffs=app, backend="pallas")
    reset_launch_counts()
    ty = iswt2d_denoise(_jcoeffs(jc), w, 10.0, mode=mode, normalize=normalize,
                        do_thresh_appcoeffs=app, precision=tier)
    assert ty.dtype == BF16 and _err(ty, jy) <= TOL_BF16
    assert set(LAUNCHES.values()) == {0}  # the CPU runs the plain versions


def test_mixed_swt2d_stays_exact():
    """``mixed`` runs the 2D stationary transform on the exact kernels."""
    jw, w = _pair("db4")
    jx, tx = _both(_rand(R, C, seed=32), bf16=False)
    with jprec.precision_scope("mixed"):
        jc = jsep.swt2d(jx, jw, 2, backend="pallas")
    tc = swt2d(tx, w, 2, precision="mixed")
    _assert_tree(tc, jc, "fd")
    assert tc.details[0][0].dtype == F32


# ---------------------------------------------------------------------------
# port-only properties
# ---------------------------------------------------------------------------

def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    w = _pair("db2")[1]
    x = tensor_from_numpy(_rand(1, 32, 128), dtype=BF16)
    reset_launch_counts()
    got = SM.swt_fwd_level_2d_mxu(x, w.dec_lo, w.dec_hi, 2, "b1", (F32, BF16))
    want = SM.swt_fwd_level_2d_mxu_ref(x, w.dec_lo, w.dec_hi, 2, "b1", (F32, BF16))
    assert all(torch.equal(g, t) for g, t in zip(got, want))
    assert torch.equal(SM.swt_inv_level_2d_mxu(*got, w.rec_lo, w.rec_hi, 2, "fd", BF16,
                                               ("hard", 1.0)),
                       SM.swt_inv_level_2d_mxu_ref(*got, w.rec_lo, w.rec_hi, 2, "fd", BF16,
                                                   ("hard", 1.0)))
    assert set(LAUNCHES.values()) == {0}


def test_swt_mxu_wrappers_refuse_what_they_do_not_take():
    w = _pair("db2")[1]
    meta = torch.empty(1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        SM.swt_fwd_level_2d_mxu(meta, w.dec_lo, w.dec_hi, 1, "b1")
    x = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="threshold mode"):
        SM.swt_inv_level_2d_mxu(x, x, x, x, w.rec_lo, w.rec_hi, 1, "fd", threshold=("firm", 1))
    with pytest.raises(ValueError, match="unknown compute scheme"):
        SM.swt_fwd_level_2d_mxu_ref(x, w.dec_lo, w.dec_hi, 1, "b4")
    with pytest.raises(ValueError, match="unknown MXU mode"):
        SM.swt2d_inv_plan("exact", None)
