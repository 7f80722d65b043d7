"""The non-separable engine of the port (``core/nonseparable.py``, kernels
17-18 in ``kernels/ns_matmul.py``, ``quad_filters``/``factor_quads``, the
facade's ``do_separable=False``) against the JAX package on the CPU.

* the plain versions of kernels 17 and 18 against the Pallas kernels in
  interpret mode, scheme by scheme (picked on the JAX side with
  ``PDWT_TPU_BF16_L1FWD`` / ``_L1INV`` / ``PDWT_TPU_SWT_BF16_SCHEME``), at
  both strides, and a ladder of their tolerances;
* the autograd Functions against ``jax.vjp``;
* the two route rules against JAX's gates over a sweep (the JAX wrappers
  run with their launches stubbed out, so only their gates decide);
* the four ``_ns`` entry points: exact against JAX's default path (float64
  to 1e-10, float32 to roundoff), ``mixed`` and the bf16 tiers against
  JAX's Pallas path, for genuinely 2D, anisotropic and named quads;
* ``Wavelets(do_separable=False)`` with a named and a custom quad set.

Custom quads are made from a seed with numpy: the rank-3 8 x 8 set of
``tests/test_mxu_kernels.py:301-306`` (``_rank3``), and a rank-3 set with
perfect reconstruction (``pr_quads``: db2's quads, padded to 8 taps, the
HH column filter delayed by one subband sample, mixed by an orthogonal
4 x 4 matrix).  Tolerances as in ``tests/test_torch_swt_mxu_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import Wavelets as JWavelets
from pdwt_tpu import kernels as jk
from pdwt_tpu.core import conv as jconv
from pdwt_tpu.core import nonseparable as jns
from pdwt_tpu.core import precision as jprec
from pdwt_tpu.filters import bank as jbank
from pdwt_tpu.kernels import ns_matmul_pallas as nsm
from pdwt_tpu_torch import Wavelets
from pdwt_tpu_torch.core import nonseparable as ns
from pdwt_tpu_torch.core.separable import Coeffs2D
from pdwt_tpu_torch.filters import factor_quads, get_wavelet, quad_filters
from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from pdwt_tpu_torch.kernels import matmul as M
from pdwt_tpu_torch.kernels import ns_matmul as NM
from pdwt_tpu_torch.utils import tensor_from_numpy, tensor_to_numpy

TOL_F32 = {"b1": 2e-3, "b2f": 2e-3, "b2d": 1e-4, "b3": 1e-4, "fd": 1e-5}
TOL_BF16 = 2.0 ** -7
SCHEMES = ("b1", "fd", "b2f", "b2d", "b3")
R, C = 64, 256
F32, BF16 = torch.float32, torch.bfloat16
TIERS = ("mixed", "bf16-fast", "bf16-balanced", "bf16-accurate")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")
    for knob in ("PDWT_TPU_BF16_L1FWD", "PDWT_TPU_BF16_L1INV", "PDWT_TPU_BF16_ACCURACY",
                 "PDWT_TPU_SWT_BF16_SCHEME", "PDWT_TPU_PRECISION", "PDWT_TPU_MXU_TILES",
                 "PDWT_TPU_BACKEND"):
        monkeypatch.delenv(knob, raising=False)


def _rank3(seed=7, hlen=8):
    q = np.zeros((4, hlen, hlen))
    g = np.random.default_rng(seed)
    for _ in range(3):
        q += np.einsum("si,j->sij", g.standard_normal((4, hlen)), g.standard_normal(hlen))
    return q / np.abs(q).sum(axis=(1, 2), keepdims=True)


def pr_quads(seed=3):
    """(forward, inverse) rank-3 8 x 8 quads that reconstruct perfectly."""
    w = get_wavelet("db2")
    pad = lambda f, lo, hi: np.concatenate([np.zeros(lo), f, np.zeros(hi)])
    c = lambda f: pad(f, 2, 2)

    def quads(lo, hi, hh_col):
        return np.stack([np.outer(c(lo), c(lo)), np.outer(c(hi), c(lo)), np.outer(c(lo), c(hi)),
                         np.outer(c(hi), hh_col)])

    U = np.linalg.qr(np.random.default_rng(seed).standard_normal((4, 4)))[0]
    fwd = quads(w.dec_lo, w.dec_hi, pad(w.dec_hi, 0, 4))
    inv = quads(w.rec_lo, w.rec_hi, pad(w.rec_hi, 4, 0))
    return np.einsum("st,tij->sij", U, fwd), np.einsum("st,tij->sij", U, inv)


def _aniso(rows="db4", cols="sym4", kind="dec"):
    """Jointly separable quads with other filters along the columns."""
    r, c = get_wavelet(rows), get_wavelet(cols)
    lo_r, hi_r = getattr(r, kind + "_lo"), getattr(r, kind + "_hi")
    lo_c, hi_c = getattr(c, kind + "_lo"), getattr(c, kind + "_hi")
    return np.stack([np.outer(lo_r, lo_c), np.outer(hi_r, lo_c), np.outer(lo_r, hi_c),
                     np.outer(hi_r, hi_c)])


def _np(t):
    if isinstance(t, torch.Tensor):
        return tensor_to_numpy(t), str(t.dtype).split(".")[-1]
    return np.asarray(jnp.asarray(t).astype(jnp.float64)), jnp.dtype(t.dtype).name


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


def _rand(*shape, seed=0, lo=0.0, hi=255.0, dtype=np.float32):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(dtype)


def _both(arr, bf16):
    j = jnp.asarray(arr)
    if bf16:
        j = j.astype(jnp.bfloat16)
    return j, tensor_from_numpy(arr, dtype=BF16 if bf16 else None)


def _rank(q=None):
    return ns._rank_decomp(_rank3() if q is None else q)


def _bands(seed, det_bf16, A, Bc, level=None, shape=(1, R, C)):
    """(a, h, v, d) of one exact rank-r level of a [0, 255] image."""
    x = jnp.asarray(_rand(*shape, seed=seed))
    if level is None:
        z = jns._rank_fwd_level(x[:, None], A, Bc)
    else:
        z = jk.ns_swt_fwd_level_2d_mxu(x, A, Bc, level, "mixed")
        z = jnp.stack(z, axis=1)
    js = [z[:, 0]] + [z[:, k].astype(jnp.bfloat16) if det_bf16 else z[:, k] for k in (1, 2, 3)]
    return js, [tensor_from_numpy(np.asarray(t.astype(jnp.float32)),
                                  dtype=BF16 if t.dtype == jnp.bfloat16 else F32) for t in js]


# ---------------------------------------------------------------------------
# the filter bank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wname", ["haar", "db4", "sym8", "bior2.2", "coif3"])
def test_quad_filters_and_factor_quads_match_jax(wname):
    w = get_wavelet(wname)
    for transpose in (False, True):
        q = quad_filters(w.dec_lo, w.dec_hi, transpose)
        np.testing.assert_array_equal(q, jbank.quad_filters(w.dec_lo, w.dec_hi, transpose))
        got, want = factor_quads(q), jbank.factor_quads(q)
        assert (got is None) == (want is None)
        if got is not None:
            for g, t in zip(got, want):
                np.testing.assert_array_equal(g, t)


def test_factor_quads_refuses_genuinely_2d_quads():
    for q in (_rank3(), pr_quads()[0], np.zeros((4, 4, 4)), np.ones((3, 4, 4))):
        assert factor_quads(q) is None and jbank.factor_quads(q) is None
    lo_r, hi_r, lo_c, hi_c = factor_quads(_aniso())
    assert not np.allclose(lo_r, lo_c)


def test_rank_decomposition_matches_jax():
    for q in (_rank3(), pr_quads()[0], pr_quads()[1], _rank3(seed=1, hlen=4)):
        A, Bc = ns._rank_decomp(q)
        jA, jB = jns._rank_decomp(q)
        np.testing.assert_array_equal(A, jA)
        np.testing.assert_array_equal(Bc, jB)
        np.testing.assert_allclose(np.einsum("skh,kw->shw", A, Bc), q, atol=1e-12)
    assert _rank()[1].shape[0] == 3 and ns._rank_decomp(pr_quads()[0])[1].shape[0] == 3


# ---------------------------------------------------------------------------
# kernel 17: the rank-r analysis, stride 2 and stride 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_ns_fwd_level_2d_mxu_ref_matches_pallas(monkeypatch, scheme):
    """Decimated, bf16 input: a float32, details bf16."""
    A, Bc = _rank()
    jx, tx = _both(_rand(1, R, C, seed=1), bf16=True)
    monkeypatch.setenv("PDWT_TPU_BF16_L1FWD", scheme)
    want = jk.ns_fwd_level_2d_mxu(jx, A, Bc, "bf16")
    _close(NM.ns_fwd_level_2d_mxu_ref(tx, A, Bc, scheme, (F32, BF16)), want, scheme)


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
def test_ns_fwd_level_2d_mxu_ref_matches_pallas_f32(mode):
    """Decimated, float32 input: b3 (``mixed``, and the bf16 tiers' chain)."""
    A, Bc = _rank()
    jx, tx = _both(_rand(2, R, C, seed=2), bf16=False)
    want = jk.ns_fwd_level_2d_mxu(jx, A, Bc, mode)
    _close(NM.ns_fwd_level_2d_mxu_ref(tx, A, Bc, "b3", M.mode_out_dtypes(mode)), want, "b3")


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("in_bf16,level", [(True, 1), (False, 3)], ids=["bf16-L1", "f32-L3"])
def test_ns_swt_fwd_level_2d_mxu_ref_matches_pallas(monkeypatch, scheme, in_bf16, level):
    """A-trous: one forward body at stride 1, dilated bands."""
    A, Bc = _rank()
    jx, tx = _both(_rand(1, R, C, seed=3), bf16=in_bf16)
    monkeypatch.setenv("PDWT_TPU_SWT_BF16_SCHEME", scheme)
    want = jk.ns_swt_fwd_level_2d_mxu(jx, A, Bc, level, "bf16")
    _close(NM.ns_swt_fwd_level_2d_mxu_ref(tx, A, Bc, level, scheme, (F32, BF16)), want, scheme)


# ---------------------------------------------------------------------------
# kernel 18: the rank-r synthesis, polyphase and a-trous
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_ns_inv_level_2d_mxu_ref_matches_pallas(monkeypatch, scheme):
    """Polyphase, the bf16 tiers' last level: bf16 details, bf16 out."""
    A, Bc = _rank()
    js, ts = _bands(4, True, A, Bc)
    monkeypatch.setenv("PDWT_TPU_BF16_L1INV", scheme)
    want = jk.ns_inv_level_2d_mxu(*js, A, Bc, "bf16", out_dtype=jnp.bfloat16)
    _close(NM.ns_inv_level_2d_mxu_ref(*ts, A, Bc, scheme, BF16), want, scheme)


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
def test_ns_inv_level_2d_mxu_ref_matches_pallas_f32_out(mode):
    """Polyphase into float32: b3 (deep bf16 levels, ``mixed``)."""
    A, Bc = _rank()
    js, ts = _bands(5, mode == "bf16", A, Bc)
    assert M.inv_plan(mode, F32) == ("b3", F32)
    want = jk.ns_inv_level_2d_mxu(*js, A, Bc, mode, out_dtype=jnp.float32)
    _close(NM.ns_inv_level_2d_mxu_ref(*ts, A, Bc, "b3", F32), want, "b3")


@pytest.mark.parametrize("mode,out", [("bf16", "bf16"), ("bf16", "f32"), ("mixed", "f32")])
@pytest.mark.parametrize("level", [1, 3])
def test_ns_swt_inv_level_2d_mxu_ref_matches_pallas(monkeypatch, mode, out, level):
    """A-trous: fd at every level in bf16 whatever the rung, b3 under
    ``mixed``; the 1/4 on the column filters."""
    A, Bc = _rank()
    js, ts = _bands(6, mode == "bf16", A, Bc, level=level)
    monkeypatch.setenv("PDWT_TPU_BF16_ACCURACY", "accurate")  # ignored by this inverse
    out_j, out_t = (jnp.bfloat16, BF16) if out == "bf16" else (jnp.float32, F32)
    scheme = NM.ns_swt_inv_plan(mode, out_t)[0]
    assert scheme == ("fd" if mode == "bf16" else "b3")
    want = jk.ns_swt_inv_level_2d_mxu(*js, A, Bc, level, mode, out_dtype=out_j)
    _close(NM.ns_swt_inv_level_2d_mxu_ref(*ts, A, Bc, level, scheme, out_t), want, scheme)


@pytest.mark.parametrize("kernel,lower,upper", [("fwd", "b1", "b2f"), ("fwd", "b2f", "b3"),
                                                ("swt_fwd", "b1", "b2f"), ("swt_fwd", "b2d", "b3")])
def test_ns_tolerances_tell_neighbouring_schemes_apart(monkeypatch, kernel, lower, upper):
    """As for the separable kernels: the port with ``upper`` passes against
    JAX with ``upper``, with ``lower`` it fails by a factor of at least 1.2,
    on the float32 approximation of a bf16 image.  The inverses are not
    laddered: JAX picks their scheme only where the output is bf16, whose
    rounding is then the larger error."""
    A, Bc = _rank()

    def run(port_scheme):
        jx, tx = _both(_rand(1, R, C, seed=11), bf16=True)
        if kernel == "fwd":
            monkeypatch.setenv("PDWT_TPU_BF16_L1FWD", upper)
            want = jk.ns_fwd_level_2d_mxu(jx, A, Bc, "bf16")[0]
            return NM.ns_fwd_level_2d_mxu_ref(tx, A, Bc, port_scheme)[0], want
        monkeypatch.setenv("PDWT_TPU_SWT_BF16_SCHEME", upper)
        want = jk.ns_swt_fwd_level_2d_mxu(jx, A, Bc, 1, "bf16")[0]
        return NM.ns_swt_fwd_level_2d_mxu_ref(tx, A, Bc, 1, port_scheme)[0], want

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
@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_ns_fwd_ad_matches_jax_vjp(mode, swt):
    """The analysis's backward: the synthesis with every filter reversed
    (a-trous: 4 b_k, cancelling the inverse's 1/4)."""
    A, Bc = _rank()
    jx, tx = _both(_rand(1, R, C, seed=20), bf16=mode == "bf16")
    m = (R, C) if swt else (R // 2, C // 2)
    jcts, tcts = _cts([((1, *m), False)] + [((1, *m), mode == "bf16")] * 3, 21)
    At, Bt = jk.ns_tup3(A), jk.ns_tup2(Bc)
    if swt:
        fj = lambda t: jk.ns_swt_fwd_level_2d_mxu_ad(t, At, Bt, 2, mode)
        fp = lambda t: NM.ns_swt_fwd_level_2d_mxu_ad(t, A, Bc, 2, mode)
        scheme = NM.ns_swt_inv_plan(mode, tx.dtype)[0]
    else:
        fj = lambda t: jk.ns_fwd_level_2d_mxu_ad(t, At, Bt, mode)
        fp = lambda t: NM.ns_fwd_level_2d_mxu_ad(t, A, Bc, mode)
        scheme = M.inv_plan(mode, tx.dtype)[0]
    _, vjp = jax.vjp(fj, jx)
    want = vjp(tuple(jcts))
    xt = _leaf(tx)
    _close(_grads(fp(xt), tcts, [xt]), want, scheme)


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_ns_inv_ad_matches_jax_vjp(mode, swt):
    """The synthesis's backward: the analysis with every filter reversed
    (a-trous: b_k / 4), each gradient in its input's dtype."""
    A, Bc = _rank()
    js, ts = _bands(22, mode == "bf16", A, Bc, level=2 if swt else None)
    out_j, out_t = (jnp.bfloat16, BF16) if mode == "bf16" else (jnp.float32, F32)
    n = (R, C)
    jcts, tcts = _cts([((1, *n), mode == "bf16")], 23)
    At, Bt = jk.ns_tup3(A), jk.ns_tup2(Bc)
    if swt:
        fj = lambda *b: jk.ns_swt_inv_level_2d_mxu_ad(*b, At, Bt, 2, mode, out_j)
        fp = lambda *b: NM.ns_swt_inv_level_2d_mxu_ad(*b, A, Bc, 2, mode, out_t)
        scheme = M.swt_scheme(mode, out_t)
    else:
        fj = lambda *b: jk.ns_inv_level_2d_mxu_ad(*b, At, Bt, mode, out_j)
        fp = lambda *b: NM.ns_inv_level_2d_mxu_ad(*b, A, Bc, mode, out_t)
        scheme = M.mode_scheme(mode, out_t)
    _, vjp = jax.vjp(fj, *js)
    want = vjp(jcts[0])
    leaves = [_leaf(t) for t in ts]
    _close(_grads(fp(*leaves), tcts, leaves), want, scheme)


# ---------------------------------------------------------------------------
# the route rules against JAX's gates
# ---------------------------------------------------------------------------

class _Shape:
    """Stands in for an array in the JAX wrappers' gates: shape and dtype."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = shape, dtype

    def astype(self, dtype):
        return _Shape(self.shape, dtype)


def _stub_launches(monkeypatch):
    """Run the JAX wrappers' gates only: their matrices, pads and launches
    stubbed, so a wrapper returns "kernel" where it would launch."""
    kernel = lambda *a, **k: "kernel"
    for name in ("_ns_fwd_call", "_ns_inv_call", "_ns_swt_fwd_call", "_ns_swt_inv_call"):
        monkeypatch.setattr(nsm, name, kernel)
    z = np.zeros((1, 1), np.float32)
    monkeypatch.setattr(nsm, "_ns_fwd_mats", lambda *a: (z, z))
    monkeypatch.setattr(nsm, "_ns_swt_fwd_mats", lambda *a: (z, z))
    monkeypatch.setattr(nsm, "_ns_inv_mats", lambda A, *a: ([z] * A.shape[1], z))
    monkeypatch.setattr(nsm, "_ns_swt_inv_mats", lambda A, *a: ([z] * A.shape[1], z))
    monkeypatch.setattr(jconv, "wrap_pad", lambda x, *a: x)


@pytest.mark.parametrize("hlen", [2, 4, 8, 14, 20, 40, 42, 7])
def test_ns_route_rules_match_the_tpu_gates(monkeypatch, hlen):
    """Decimated (by subband size) and a-trous (by image size, level and
    scheme: the first tile of the scheme's order decides) over a sweep of
    sizes and ranks 1-5; the ports' rules have no VMEM estimate, the gates
    do, so agreement shows that the estimates never bind for 40 taps or
    fewer."""
    _stub_launches(monkeypatch)
    sizes = [32, 64, 96, 128, 256, 2048]
    for rank in range(1, 6):
        A, Bc = np.zeros((4, rank, hlen)), np.zeros((rank, hlen))
        for r in sizes:
            for c in (128, 192, 256, 2048):
                for bf in (True, False):
                    dt = jnp.bfloat16 if bf else jnp.float32
                    x = _Shape((1, 2 * r, 2 * c), dt)
                    got = NM.mxu_route_ns_2d(r, c, hlen, rank)
                    assert (nsm.ns_fwd_level_2d_mxu(x, A, Bc, "bf16") == "kernel") == got
                    m = _Shape((1, r, c), jnp.float32)
                    assert (nsm.ns_inv_level_2d_mxu(m, m, m, m, A, Bc, "bf16",
                                                    jnp.dtype(dt)) == "kernel") == got
                for level in range(1, 9):
                    for scheme in SCHEMES:
                        monkeypatch.setenv("PDWT_TPU_SWT_BF16_SCHEME", scheme)
                        x = _Shape((1, r, c), jnp.bfloat16)
                        want = nsm.ns_swt_fwd_level_2d_mxu(x, A, Bc, level, "bf16") == "kernel"
                        assert NM.mxu_route_ns_swt_2d(r, c, hlen, rank, level, scheme) == want
                    m = _Shape((1, r, c), jnp.float32)
                    want = nsm.ns_swt_inv_level_2d_mxu(m, m, m, m, A, Bc, level,
                                                       "bf16") == "kernel"
                    assert NM.mxu_route_ns_swt_2d(r, c, hlen, rank, level, "fd") == want
                    want = nsm.ns_swt_fwd_level_2d_mxu(m, A, Bc, level, "mixed") == "kernel"
                    assert NM.mxu_route_ns_swt_2d(r, c, hlen, rank, level, "b3") == want


def test_ns_swt_route_takes_only_the_first_tile():
    """At 128 x 256, b3 tries (64, 128) first: at level 6 the span 224 > 2 * 64
    is refused although (128, 256) would fit; the other schemes take it."""
    assert not NM.mxu_route_ns_swt_2d(128, 256, 8, 3, 6, "b3")
    assert NM.mxu_route_ns_swt_2d(128, 256, 8, 3, 6, "b1")
    assert not NM.mxu_route_ns_2d(32, 128, 8, 5)


# ---------------------------------------------------------------------------
# the four entry points
# ---------------------------------------------------------------------------

QUADS = {"rank3": lambda: pr_quads(), "aniso": lambda: (_aniso(), _aniso(kind="rec")),
         "db4": lambda: (quad_filters(get_wavelet("db4").dec_lo, get_wavelet("db4").dec_hi),
                         quad_filters(get_wavelet("db4").rec_lo, get_wavelet("db4").rec_hi))}


def _jcoeffs(c):
    t = lambda a: tensor_from_numpy(np.asarray(a), dtype=BF16 if a.dtype == jnp.bfloat16
                                    else None)
    return Coeffs2D(t(c.approx), tuple(tuple(t(u) for u in band) for band in c.details))


def _tree_err(got, want):
    g = [got.approx] + [t for band in got.details for t in band]
    w = [want.approx] + [t for band in want.details for t in band]
    return max(_err(a, b) for a, b in zip(g, w))


@pytest.mark.parametrize("quads,dtype,tol", [
    ("rank3", "float64", 1e-10), ("rank3", "float32", 1e-5), ("aniso", "float64", 1e-10),
    ("db4", "float32", 1e-5)])
@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_ns_entry_points_exact_match_jax(quads, dtype, tol, swt):
    """Exact tier against JAX's default path, the inverse from JAX's
    coefficients; odd sizes for the decimated pair."""
    qf, qi = QUADS[quads]()
    shape = (24, 20) if swt else (21, 34)
    x = _rand(*shape, seed=40, dtype=np.dtype(dtype))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if swt:
        jc, tc = jns.swt2d_ns(jx, qf, 2), ns.swt2d_ns(tx, qf, 2)
        jy, ty = jns.iswt2d_ns(jc, qi), ns.iswt2d_ns(_jcoeffs(jc), qi)
    else:
        jc, tc = jns.dwt2d_ns(jx, qf, 2), ns.dwt2d_ns(tx, qf, 2)
        jy, ty = jns.idwt2d_ns(jc, qi, shape), ns.idwt2d_ns(_jcoeffs(jc), qi, shape)
    assert _tree_err(tc, jc) <= tol and _err(ty, jy) <= tol
    if quads != "aniso":  # the anisotropic quads do not reconstruct
        assert float((ty - tx).abs().max()) <= 1e3 * tol


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_ns_entry_points_under_tiers_match_jax_pallas(tier, swt):
    """Genuinely 2D quads under ``mixed`` and the bf16 tiers against JAX's
    Pallas path: levels 1-2 on kernels 17-18 (1-3 a-trous), the rest on the
    conv passes; the inverse from JAX's coefficients."""
    qf, qi = pr_quads()
    bf16 = tier.startswith("bf16")
    jx, tx = _both(_rand(R, C, seed=41), bf16)
    levels = 3
    with jprec.precision_scope(tier):
        if swt:
            jc = jns.swt2d_ns(jx, qf, levels, backend="pallas")
            jy = jns.iswt2d_ns(jc, qi, backend="pallas")
        else:
            jc = jns.dwt2d_ns(jx, qf, levels, backend="pallas")
            jy = jns.idwt2d_ns(jc, qi, (R, C), backend="pallas")
    if swt:
        tc = ns.swt2d_ns(tx, qf, levels, precision=tier)
        ty = ns.iswt2d_ns(_jcoeffs(jc), qi, precision=tier)
    else:
        tc = ns.dwt2d_ns(tx, qf, levels, precision=tier)
        ty = ns.idwt2d_ns(_jcoeffs(jc), qi, (R, C), precision=tier)
    for g, w in zip([tc.approx] + [t for b in tc.details for t in b],
                    [jc.approx] + [t for b in jc.details for t in b]):
        _close([g], [w], "b2f" if bf16 else "b3")
    _close([ty], [jy], "b3")
    assert ty.dtype == (BF16 if bf16 else F32)


def test_ns_anisotropic_bf16_runs_in_the_input_dtype():
    """JAX runs jointly separable anisotropic quads as conv passes in the
    input dtype, the approximation included; the port rounds each pass's
    float32 result to bf16 as JAX's conv does."""
    qf, qi = _aniso(), _aniso(kind="rec")
    jx, tx = _both(_rand(32, 48, seed=42), bf16=True)
    with jprec.precision_scope("bf16-fast"):
        jc = jns.dwt2d_ns(jx, qf, 1, backend="pallas")
        jy = jns.idwt2d_ns(jc, qi, (32, 48), backend="pallas")
    tc = ns.dwt2d_ns(tx, qf, 1, precision="bf16-fast")
    ty = ns.idwt2d_ns(_jcoeffs(jc), qi, (32, 48), precision="bf16-fast")
    assert tc.approx.dtype == BF16
    assert _tree_err(tc, jc) <= TOL_BF16 and _err(ty, jy) <= TOL_BF16


def test_ns_named_quads_take_the_separable_kernels():
    """db4's quads factor isotropically: the separable path, whose launch
    counters stay at zero on the CPU, and the same values as dwt2d."""
    from pdwt_tpu_torch import dwt2d

    w = get_wavelet("db4")
    x = torch.from_numpy(_rand(R, C, seed=43))
    reset_launch_counts()
    c = ns.dwt2d_ns(x, quad_filters(w.dec_lo, w.dec_hi), 2)
    ref = dwt2d(x, w, 2)
    assert _tree_err(c, ref) <= 1e-5 and set(LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

def _facade_pair(img, **kw):
    return JWavelets(img, **kw), Wavelets(img, device="cpu", **kw)


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_facade_non_separable_named_matches_jax(swt):
    img = _rand(64, 64, seed=50)
    J, T = _facade_pair(img, wname="db4", levels=2, do_separable=False, do_swt=swt)
    jc, tc = J.forward(), T.forward()
    assert _tree_err(tc, jc) <= 1e-5
    assert _err(T.inverse(), J.inverse()) <= 1e-5


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_facade_custom_quads_and_cycle_spinning_match_jax(swt):
    """Custom quads through ``set_filters_forward``/``set_filters_inverse``,
    seeded cycle spinning, a soft threshold and the inverse."""
    qf, qi = pr_quads()
    img = _rand(64, 64, seed=51)
    J, T = _facade_pair(img, wname="db2", levels=2, do_separable=False, do_swt=swt,
                        do_cycle_spinning=True, seed=5)
    for W in (J, T):
        assert W.set_filters_forward("pr3", *qf) == 0 and W.set_filters_inverse(*qi) == 0
    jc, tc = J.forward(), T.forward()
    assert (T.current_shift_r, T.current_shift_c) == (J.current_shift_r, J.current_shift_c)
    assert T.spec.wname == "pr3" and T.spec.hlen == 8
    assert _tree_err(tc, jc) <= 1e-5
    J.soft_threshold(5.0)
    T.soft_threshold(5.0)
    assert _err(T.inverse(), J.inverse()) <= 1e-5
    T2 = Wavelets(img, wname="db2", levels=2, do_separable=False, do_swt=swt, device="cpu")
    T2.set_filters_forward("pr3", *qf)
    T2.set_filters_inverse(*qi)
    T2.forward()
    assert float((T2.inverse() - torch.from_numpy(img)).abs().max()) <= 1e-3


def test_facade_non_separable_rules():
    img = _rand(32, 32, seed=52)
    J, T = _facade_pair(img, wname="db2", levels=1, do_separable=False)
    for W in (J, T):
        with pytest.raises(ValueError, match="separable specs only"):
            W.run_denoise(1.0)
        with pytest.raises(ValueError, match="expected 4 filters"):
            W.set_filters_forward("x", np.ones(4), np.ones(4))
        with pytest.raises(ValueError, match="expected 4 filters"):
            W.set_filters_inverse(np.ones(4), np.ones(4))
    assert "separable=False" in repr(T)


def test_facade_separable_set_filters_matches_jax():
    """Two filters on the separable facade: the synthesis filters kept when
    the length matches, zeros otherwise, as JAX does."""
    img = _rand(32, 32, seed=53)
    w = get_wavelet("db2")
    J, T = _facade_pair(img, wname="db2", levels=2)
    for W in (J, T):
        W.set_filters_forward("mine", 2 * w.dec_lo, 2 * w.dec_hi)
    assert _tree_err(T.forward(), J.forward()) <= 1e-5
    assert _err(T.inverse(), J.inverse()) <= 1e-5
    for W in (J, T):
        W.set_filters_forward("longer", np.ones(6) / 6, np.ones(6) / 6)
        W.set_filters_inverse(np.ones(6), np.ones(6))
    assert T.spec.hlen == 6 and np.array_equal(T._wavelet.rec_lo, np.ones(6))
    assert _tree_err(T.forward(), J.forward()) <= 1e-5


def test_ns_wrappers_refuse_and_count_nothing_on_the_cpu():
    A, Bc = _rank()
    x = torch.from_numpy(_rand(1, 64, 128))
    reset_launch_counts()
    got = NM.ns_fwd_level_2d_mxu(x, A, Bc, "b1")
    want = NM.ns_fwd_level_2d_mxu_ref(x, A, Bc, "b1")
    assert all(torch.equal(g, t) for g, t in zip(got, want))
    assert set(LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match="row filters"):
        NM.ns_fwd_level_2d_mxu_ref(x, A[:, :2], Bc, "b1")
    with pytest.raises(ValueError, match="unknown MXU mode"):
        NM.ns_swt_inv_plan("exact", None)
    with pytest.raises(ValueError, match="quads must have shape"):
        ns.dwt2d_ns(x[0], np.ones((4, 4, 5)), 1)
