"""The port's 3D transforms against the JAX package's: ``dwt3d``/``idwt3d``,
``swt3d``/``iswt3d`` (``keep_approx``), ``iswt3d_denoise``, the periodic
depth pass of ``core/depth_matmul.py``, the boundary modes and the
gradients.

JAX runs its ``backend="fma"`` path (the conv passes along columns, rows,
then depth); the port runs its 2D level kernels' plain versions with depth
as the batch and the depth pass as one matrix product.  Inputs come from
``default_rng`` and cross as numpy arrays.  Tolerances, relative to the
largest magnitude of the compared coefficient tree (a depth of 1 or 2 at a
deep level makes the depth high-pass bands roundoff): 1e-5 in float32 (the
product sums in another order than the conv passes), 1e-12 in float64;
bf16 outputs of the boundary modes 2^-7 (one bf16 rounding apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import ops as jops
from pdwt_tpu.core import separable3d as jsep3
from pdwt_tpu.core.depth_matmul import _analysis_matrix, _synthesis_matrix
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu.filters import make_custom_wavelet as jmake_custom
from pdwt_tpu_torch import (DETAIL_KEYS_3D, Coeffs3D, dwt3d, idwt3d, iswt3d, iswt3d_denoise,
                            ops, swt3d)
from pdwt_tpu_torch.core import conv, depth_matmul
from pdwt_tpu_torch.core.shapes import coeff_shapes_3d
from pdwt_tpu_torch.ops.threshold import THRESHOLD_OPS
from pdwt_tpu_torch.utils import (coeffs3d_from_numpy, coeffs3d_to_numpy, tensor_from_numpy,
                                  tensor_to_numpy, wavelet_from_arrays)

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
BF16_RTOL = 2.0 ** -7


def _leaves(tree):
    if not hasattr(tree, "details"):
        return [tensor_to_numpy(tree) if isinstance(tree, torch.Tensor) else np.asarray(tree)]
    a, dets = coeffs3d_to_numpy(tree)
    return [a, *[t for band in dets for t in band]]


def _close(got, want, dt, rtol=None):
    """max|got - want| <= rtol * max|want| over the whole tree, leaf by leaf
    of one shape and dtype."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == dt, (g.shape, w.shape, g.dtype)
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= (RTOL[dt] if rtol is None else rtol) * scale, err


def _pair(wname):
    if wname == "odd5":
        jw = jmake_custom("odd5", *np.random.default_rng(5).standard_normal((4, 5)))
    else:
        jw = jget_wavelet(wname)
    return jw, wavelet_from_arrays(jw)


def _vol(shape, dt=np.float32, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(dt)


CASES = [("db2", (5, 19, 23), 2), ("db4", (2, 8, 16, 16), 2), ("db7", (16, 16, 17), 1),
         ("haar", (7, 9, 11), 3), ("odd5", (9, 12, 10), 2), ("db2", (3, 2, 4, 6, 8), 1)]
#: float32 on every case, float64 on three (JAX's side compiles per shape)
DT_CASES = ([(np.float32, *c) for c in CASES]
            + [(np.float64, *CASES[k]) for k in (0, 1, 4)])


@pytest.mark.parametrize("dt,wname,shape,levels", DT_CASES)
def test_dwt3d_and_inverse_match_jax(dt, wname, shape, levels):
    jw, w = _pair(wname)
    x = _vol(shape, dt, seed=levels)
    shape3 = shape[-3:]
    got = dwt3d(torch.from_numpy(x), w, levels)
    want, jy = jax.jit(lambda v: (lambda c: (c, jsep3.idwt3d(c, jw, shape3, backend="fma")))(
        jsep3.dwt3d(v, jw, levels, backend="fma")))(jnp.asarray(x))
    assert isinstance(got, Coeffs3D) and got.levels == levels
    _close(got, want, dt)
    _close(idwt3d(got, w, shape3), jy, dt)
    # the inverse on JAX's coefficients carried across
    c = coeffs3d_from_numpy(*coeffs3d_to_numpy(want))
    _close(idwt3d(c, w, shape3), jy, dt)
    if wname != "odd5":
        err = float((idwt3d(got, w, shape3) - torch.from_numpy(x)).abs().max())
        assert err <= (1e-3 if dt == np.float32 else 1e-9)


@pytest.mark.parametrize("dt,wname,shape,levels", [c for c in DT_CASES if len(c[2]) == 3])
def test_swt3d_and_inverse_match_jax(dt, wname, shape, levels):
    jw, w = _pair(wname)
    x = _vol(shape, dt, seed=10 + levels)
    got, apps = swt3d(torch.from_numpy(x), w, levels, keep_approx=True)

    def jfn(v):
        c, a = jsep3.swt3d(v, jw, levels, backend="fma", keep_approx=True)
        return c, a, jsep3.iswt3d(c, jw, backend="fma")

    want, japps, jy = jax.jit(jfn)(jnp.asarray(x))
    _close(got, want, dt)
    assert len(apps) == len(japps) == levels
    for a, ja in zip(apps, japps):
        _close(a.numpy(), np.asarray(ja), dt)
    _close(iswt3d(got, w), jy, dt)


DENOISE = [("soft", {}), ("hard", {"normalize": True}), ("garrote", {}),
           ("soft", {"do_thresh_appcoeffs": True, "normalize": True}),
           ("hard", {"per_level": True}), ("soft", {"tensor_beta": True})]


@pytest.mark.parametrize("dt,mode,kw", [(np.float32, *c) for c in DENOISE]
                         + [(np.float64, *DENOISE[k]) for k in (2, 3)])
def test_iswt3d_denoise_matches_jax(dt, mode, kw):
    jw, w = _pair("db2")
    kw = dict(kw)
    x = _vol((6, 10, 14), dt, seed=3)
    beta = 40.0
    if kw.pop("per_level", False):
        beta = [60.0, 30.0]
    jbeta = beta
    if kw.pop("tensor_beta", False):
        beta, jbeta = torch.tensor(beta, dtype=torch.float32), jnp.float32(beta)
    c = swt3d(torch.from_numpy(x), w, 2)
    want = jax.jit(lambda v: jsep3.iswt3d_denoise(jsep3.swt3d(v, jw, 2, backend="fma"), jw,
                                                  jbeta, mode=mode, backend="fma", **kw)
                   )(jnp.asarray(x))
    got = iswt3d_denoise(c, w, beta, mode=mode, **kw)
    _close(got, want, dt)
    # the fused route equals the threshold op followed by the inverse
    unfused = iswt3d(THRESHOLD_OPS[mode](c, beta, **kw), w)
    _close(got, unfused.numpy(), dt)


def test_iswt3d_denoise_refuses_the_group_mode():
    _, w = _pair("db2")
    c = swt3d(torch.from_numpy(_vol((4, 8, 8))), w, 1)
    with pytest.raises(ValueError, match="fused denoise"):
        iswt3d_denoise(c, w, 1.0, mode="group")


def test_coefficient_layout_and_shapes():
    jw, w = _pair("db2")
    x = torch.from_numpy(_vol((9, 12, 17)))
    c = dwt3d(x, w, 2)
    a_shape, det_shapes = coeff_shapes_3d(9, 12, 17, 2)
    assert tuple(c.approx.shape) == a_shape
    assert [tuple(b[0].shape) for b in c.details] == det_shapes == [(5, 6, 9), (3, 3, 5)]
    assert all(len(b) == 7 for b in c.details) and len(DETAIL_KEYS_3D) == 7
    assert DETAIL_KEYS_3D[0] == "daa" and DETAIL_KEYS_3D[-1] == "ddd"
    # daa is high-pass along depth only: a volume constant in depth has none
    flat = torch.from_numpy(np.repeat(_vol((1, 12, 16)), 8, axis=0))
    c = dwt3d(flat, w, 1)
    assert float(c.details[0][0].abs().max()) < 1e-3
    assert float(c.details[0][1].abs().max()) > 1.0
    assert coeff_shapes_3d(9, 12, 17, 2, do_swt=True)[1] == [(9, 12, 17)] * 2
    assert coeff_shapes_3d(9, 12, 17, 1, mode=("zero", "periodization", "symmetric"),
                           hlen=4)[1] == [(6, 6, 10)]


# ---------------------------------------------------------------------------
# the depth pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 17, 5])
@pytest.mark.parametrize("dilation,decimate", [(1, True), (1, False), (2, False), (4, False)])
def test_depth_matmul_matches_the_conv_passes(d, dilation, decimate):
    w = _pair("db7")[1]
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((2, d, 4, 8)))
    got = depth_matmul.depth_analysis_mm(x, (w.dec_lo, w.dec_hi), dilation=dilation,
                                         decimate=decimate)
    want = conv.analysis_pass(x[:, None], (w.dec_lo, w.dec_hi), axis=-3, dilation=dilation,
                              decimate=decimate)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12
    m = got.shape[2]
    rec = (w.rec_lo * 0.5, w.rec_hi * 0.5) if not decimate else (w.rec_lo, w.rec_hi)
    bands = [torch.from_numpy(rng.standard_normal((2, m, 4, 8))) for _ in range(2)]
    got = depth_matmul.depth_synthesis_mm(bands, rec, out_len=d, dilation=dilation,
                                          decimated=decimate)
    want = conv.synthesis_pass(torch.stack(bands, 1), rec, axis=-3, out_len=d,
                               dilation=dilation, decimated=decimate)[:, 0]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12


@pytest.mark.parametrize("wname", ["db2", "db7", "odd5"])
@pytest.mark.parametrize("n,dilation,decimate", [(16, 1, True), (17, 1, True), (9, 1, False),
                                                 (12, 4, False)])
def test_depth_matrices_equal_jax(wname, n, dilation, decimate):
    jw, w = _pair(wname)
    taps = tuple(tuple(float(v) for v in f) for f in (w.dec_lo, w.dec_hi))
    np.testing.assert_array_equal(depth_matmul.analysis_matrix(taps, n, dilation, decimate),
                                  _analysis_matrix(taps, n, dilation, decimate))
    m = (n + 1) // 2 if decimate else n
    out = n if decimate else m
    np.testing.assert_array_equal(depth_matmul.synthesis_matrix(taps, m, dilation, decimate, out),
                                  _synthesis_matrix(taps, m, dilation, decimate, out))


def test_depth_product_stays_fp32_and_rounds_bf16_once():
    """The float32 product runs at "highest" whatever the caller set, and
    restores the setting; bf16 data is multiplied in float32 and rounded
    once."""
    w = _pair("db4")[1]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 8, 3, 5)).astype(np.float32))
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        got = depth_matmul.depth_analysis_mm(x, (w.dec_lo, w.dec_hi))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    want = depth_matmul.depth_analysis_mm(x.double(), (w.dec_lo, w.dec_hi))
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    xb = x.to(torch.bfloat16)
    gb = depth_matmul.depth_analysis_mm(xb, (w.dec_lo, w.dec_hi))
    wb = depth_matmul.depth_analysis_mm(xb.float(), (w.dec_lo, w.dec_hi)).to(torch.bfloat16)
    assert gb.dtype == torch.bfloat16 and torch.equal(gb, wb)


# ---------------------------------------------------------------------------
# boundary modes: the conv passes, JAX's fma formulation
# ---------------------------------------------------------------------------

MODES = ["symmetric", "zero", ("zero", "periodization", "symmetric"),
         ("periodization", "reflect", "periodization")]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_boundary_modes_match_jax(mode, dt):
    jw, w = _pair("db2")
    x = _vol((7, 10, 13), seed=4)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dt]
    got = dwt3d(tensor_from_numpy(x).to(tdt), w, 2, mode=mode)
    want, jy = jax.jit(lambda v: (lambda c: (c, jsep3.idwt3d(c, jw, (7, 10, 13), backend="fma",
                                                             mode=mode)))(
        jsep3.dwt3d(v, jw, 2, backend="fma", mode=mode)))(jnp.asarray(x).astype(jdt))
    assert all(t.dtype == tdt for t in [got.approx, *[b for d in got.details for b in d]])
    rtol = RTOL[np.float32] if dt == "float32" else BF16_RTOL
    conv_np = lambda t: (tensor_to_numpy(t) if isinstance(t, torch.Tensor)
                         else np.asarray(jnp.asarray(t).astype(jnp.float32)))
    g = [conv_np(t) for t in [got.approx, *[b for d in got.details for b in d]]]
    wv = [conv_np(t) for t in [want.approx, *[b for d in want.details for b in d]]]
    _close(Coeffs3D(g[0], (tuple(g[1:8]), tuple(g[8:]))),
           Coeffs3D(wv[0], (tuple(wv[1:8]), tuple(wv[8:]))), np.float32, rtol)
    y = idwt3d(got, w, (7, 10, 13), mode=mode)
    assert y.dtype == tdt
    _close(conv_np(y), conv_np(jy), np.float32, rtol)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def test_gradients_match_jax():
    jw, w = _pair("db2")
    x = _vol((4, 8, 16), seed=6) / 255.0

    def port_dwt(t):
        return ops.norm2sq(dwt3d(t, w, 2))

    def port_den(t):
        return (iswt3d_denoise(swt3d(t, w, 2), w, 0.3) ** 2).sum()

    jdwt = lambda t: jops.norm2sq(jsep3.dwt3d(t, jw, 2, backend="fma"))
    jden = lambda t: jnp.sum(jsep3.iswt3d_denoise(jsep3.swt3d(t, jw, 2, backend="fma"), jw,
                                                  0.3, backend="fma") ** 2)
    for pf, jf in ((port_dwt, jdwt), (port_den, jden)):
        t = torch.from_numpy(x).requires_grad_(True)
        (g,) = torch.autograd.grad(pf(t), t)
        jg = jax.jit(jax.grad(jf))(jnp.asarray(x))
        _close(g.numpy(), np.asarray(jg), np.float32)
