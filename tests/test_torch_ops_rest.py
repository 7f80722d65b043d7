"""The port's group, firm, L-infinity and L2-shrink operators, its L2,1
norms, the coefficient axpy, the 1D shift and the threshold estimators
against the JAX package's, on the same coefficient trees.

The trees are made from ``default_rng``: odd and prime band sizes, 2D
decimated and stationary shapes and batched 1D, float32 throughout or
(the bf16 tiers' layout) a float32 approximation with bf16 details.  The
estimators run on the port's transforms of noisy images, the same
coefficients handed to both packages.

Tolerances: elementwise ops on float32 within 2 ulps of the largest output
(2.4e-7 max|ref|); on bf16 within 1 bf16 ulp of each output, the output
dtypes equal leaf by leaf; norms 1e-5 relative (float32 sums in another
order); ``noise_sigma`` and ``universal_threshold`` within 1 float32 ulp;
``bayes_thresholds`` 1e-6 relative; ``sure_thresholds`` 1e-5 relative and
its risk curve within 1e-5 of its largest value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import ops as jops
from pdwt_tpu.core.separable import Coeffs1D as JC1
from pdwt_tpu.core.separable import Coeffs2D as JC2
from pdwt_tpu_torch import dwt1d, dwt2d, get_wavelet, ops, precision_scope, swt1d, swt2d
from pdwt_tpu_torch.core.separable import Coeffs1D, Coeffs2D
from pdwt_tpu_torch.core.shapes import coeff_shapes_1d, coeff_shapes_2d
from pdwt_tpu_torch.ops.estimate import sure_risk
from pdwt_tpu_torch.utils import tensor_from_numpy, tensor_to_numpy

ELEM_RTOL, NORM_RTOL, BAYES_RTOL, SURE_RTOL = 2.4e-7, 1e-5, 1e-6, 1e-5

# (kind, shape, levels, stationary, bf16 details)
TREES = {
    "2d odd": ("2d", (17, 23), 3, False, False),
    "2d prime swt": ("2d", (29, 31), 2, True, False),
    "2d wide": ("2d", (16, 70), 2, False, False),
    "1d odd": ("1d", (3, 97), 3, False, False),
    "1d swt": ("1d", (2, 61), 2, True, False),
    "2d bf16": ("2d", (40, 27), 2, False, True),
    "1d bf16": ("1d", (2, 64), 3, False, True),
}


def _tree(name, seed=0, scale=20.0):
    """(port tree, JAX tree) holding the same values."""
    kind, shape, levels, swt, bf16 = TREES[name]
    rng = np.random.default_rng(seed)
    mk = lambda s, low: jnp.asarray((rng.standard_normal(s) * scale).astype(np.float32)
                                    ).astype(jnp.bfloat16 if low else jnp.float32)
    if kind == "2d":
        a_s, d_s = coeff_shapes_2d(*shape, levels, swt)
        j = JC2(mk(a_s, False), tuple(tuple(mk(s, bf16) for _ in range(3)) for s in d_s))
    else:
        a_len, d_lens = coeff_shapes_1d(shape[1], levels, swt)
        j = JC1(mk((shape[0], a_len), False), tuple(mk((shape[0], n), bf16) for n in d_lens))
    return _port(j), j


def _port(j):
    t = lambda x: tensor_from_numpy(np.asarray(x))
    if isinstance(j, JC2):
        return Coeffs2D(t(j.approx), tuple(tuple(t(x) for x in b) for b in j.details))
    return Coeffs1D(t(j.approx), tuple(t(x) for x in j.details))


def _jax(c):
    """A JAX tree of a port tree's values and dtypes."""
    t = lambda x: jnp.asarray(tensor_to_numpy(x)).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    if isinstance(c, Coeffs2D):
        return JC2(t(c.approx), tuple(tuple(t(x) for x in b) for b in c.details))
    return JC1(t(c.approx), tuple(t(x) for x in c.details))


def _leaves(c):
    out = [c.approx]
    for d in c.details:
        out.extend(d if isinstance(d, tuple) else (d,))
    return out


def _bf16_ulp(v):
    v = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(v)) - 7)


def close_elementwise(got, want, bf16_input=False, slack=None):
    """Leaf by leaf: equal dtypes; float32 within 2 ulps of the largest
    output, bf16 within 1 bf16 ulp of each output.  ``bf16_input``: the op
    read bf16 bands, so a float32 output that depends on a bf16 value (the
    group factor of a float32 approximation joining bf16 details) is held
    to 1 bf16 ulp too.  ``slack``: a list, per leaf, of an absolute amount
    the two outputs may further differ by."""
    gl, wl = _leaves(got), _leaves(want)
    assert len(gl) == len(wl)
    for k, (g, w) in enumerate(zip(gl, wl)):
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name
        gv, wv = tensor_to_numpy(g), np.asarray(w.astype(jnp.float32))
        assert gv.shape == wv.shape
        err = np.abs(gv - wv) - (0.0 if slack is None else slack[k])
        if g.dtype == torch.bfloat16 or bf16_input:
            assert (err <= _bf16_ulp(np.maximum(np.abs(gv), np.abs(wv)))).all(), err.max()
        else:
            assert err.max() <= ELEM_RTOL * np.abs(wv).max(), err.max()


def _norm_close(got, want, rtol=NORM_RTOL):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= rtol * abs(float(want))


def _levels(name):
    return TREES[name][2]


def _per_level(name, base):
    return [base * (1.0 + 0.3 * i) for i in range(_levels(name))]


def _per_band(name, base):
    bands = 3 if TREES[name][0] == "2d" else 1
    return [tuple(base * (1.0 + 0.3 * i + 0.1 * j) for j in range(bands))
            for i in range(_levels(name))]


# ---------------------------------------------------------------------------
# the elementwise and group operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("kw", [{}, {"normalize": True}, {"do_thresh_appcoeffs": True},
                                {"normalize": True, "do_thresh_appcoeffs": True}],
                         ids=["plain", "normalize", "app", "normalize-app"])
def test_group_soft_threshold_matches_jax(tree, kw):
    """A float32 approximation joining bf16 details makes them float32, in
    both packages."""
    c, j = _tree(tree)
    close_elementwise(ops.group_soft_threshold(c, 25.0, **kw),
                      jops.group_soft_threshold(j, 25.0, **kw), TREES[tree][4])


def test_group_soft_threshold_takes_a_device_beta():
    c, j = _tree("2d odd", seed=1)
    close_elementwise(ops.group_soft_threshold(c, torch.tensor(25.0)),
                      jops.group_soft_threshold(j, jnp.float32(25.0)))


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("betas", ["scalar", "per-level", "per-band", "app-normalize"])
def test_firm_threshold_matches_jax(tree, betas):
    c, j = _tree(tree, seed=2)
    kw = {}
    if betas == "scalar":
        b1, b2 = 12.0, 31.0
    elif betas == "per-level":
        b1, b2 = _per_level(tree, 12.0), _per_level(tree, 31.0)
    elif betas == "per-band":
        b1, b2 = _per_band(tree, 12.0), _per_band(tree, 31.0)
    else:
        b1, b2, kw = 12.0, 31.0, {"do_thresh_appcoeffs": True, "normalize": True}
    close_elementwise(ops.firm_threshold(c, b1, b2, **kw), jops.firm_threshold(j, b1, b2, **kw))


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("app", [True, False])
def test_proj_linf_and_shrink_match_jax(tree, app):
    c, j = _tree(tree, seed=3)
    close_elementwise(ops.proj_linf(c, 17.5, do_thresh_appcoeffs=app),
                      jops.proj_linf(j, 17.5, do_thresh_appcoeffs=app))
    close_elementwise(ops.shrink(c, 0.37, do_thresh_appcoeffs=app),
                      jops.shrink(j, 0.37, do_thresh_appcoeffs=app))


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("alpha", [1.0, -0.37])
def test_add_coeffs_matches_jax(tree, alpha):
    c, j = _tree(tree, seed=4)
    c2, j2 = _tree(tree, seed=5)
    close_elementwise(ops.add_coeffs(c, c2, alpha), jops.add_coeffs(j, j2, alpha))


def test_add_coeffs_promotes_mixed_operands_as_jax():
    """float32 and bf16 bands add to float32, either way round."""
    lo, jlo = _tree("2d bf16", seed=6)
    hi, _ = _tree("2d bf16", seed=7)
    hi = Coeffs2D(hi.approx, tuple(tuple(x.float() for x in b) for b in hi.details))
    close_elementwise(ops.add_coeffs(hi, lo, 0.5), jops.add_coeffs(_jax(hi), jlo, 0.5))
    close_elementwise(ops.add_coeffs(lo, hi, 0.5), jops.add_coeffs(jlo, _jax(hi), 0.5))


@pytest.mark.parametrize("mode", ["soft", "hard", "garrote", "group"])
def test_threshold_ops_table_has_every_mode(mode):
    from pdwt_tpu_torch.ops.threshold import THRESHOLD_OPS

    c, j = _tree("2d odd", seed=8)
    jfn = {"soft": jops.soft_threshold, "hard": jops.hard_threshold,
           "garrote": jops.garrote_threshold, "group": jops.group_soft_threshold}[mode]
    close_elementwise(THRESHOLD_OPS[mode](c, 14.0, normalize=True), jfn(j, 14.0, normalize=True))


# ---------------------------------------------------------------------------
# the L2,1 norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("app", [False, True])
def test_norm_l21_matches_jax(tree, app):
    c, j = _tree(tree, seed=9)
    _norm_close(ops.norm_l21(c, do_thresh_appcoeffs=app), jops.norm_l21(j, do_thresh_appcoeffs=app))


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("kw", [{}, {"normalize": True, "do_thresh_appcoeffs": True}],
                         ids=["plain", "normalize-app"])
def test_thresholded_norm_l21_matches_jax_and_the_thresholded_tree(tree, kw):
    c, j = _tree(tree, seed=10)
    got = ops.thresholded_norm_l21(c, 25.0, **kw)
    _norm_close(got, jops.thresholded_norm_l21(j, 25.0, **kw))
    if not TREES[tree][4]:  # the bf16 threshold rounds its output
        app = kw.get("do_thresh_appcoeffs", False)
        _norm_close(got, ops.norm_l21(ops.group_soft_threshold(c, 25.0, **kw),
                                      do_thresh_appcoeffs=app))


# ---------------------------------------------------------------------------
# shifts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sc", [0, 5, -3, 200])
def test_circshift1d_matches_jax(sc):
    x = np.random.default_rng(11).standard_normal((3, 37)).astype(np.float32)
    got = ops.circshift1d(torch.from_numpy(x), sc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.circshift1d(jnp.asarray(x), sc)))


def test_random_shift_draws_the_row_then_the_column():
    g = torch.Generator().manual_seed(5)
    got = [ops.random_shift(g, (13, 7)) for _ in range(4)]
    g = torch.Generator().manual_seed(5)
    want = [(int(torch.randint(0, 13, (), generator=g)), int(torch.randint(0, 7, (), generator=g)))
            for _ in range(4)]
    assert got == want
    assert all(0 <= r < 13 and 0 <= c < 7 for r, c in got)


# ---------------------------------------------------------------------------
# the estimators, on the port's transforms of noisy images
# ---------------------------------------------------------------------------

def _noisy(shape, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(*(np.linspace(0, 3, n) for n in shape[-2:]), indexing="ij")
    clean = 100 * np.sin(yy) * np.cos(2 * xx) + 120
    return torch.from_numpy((clean + rng.normal(0, 12, shape)).astype(np.float32))


# (label, transform): the finest diagonal band's size odd or even
ESTIMATED = {
    "dwt2d odd count": lambda: dwt2d(_noisy((34, 38), 12), get_wavelet("db2"), 3),
    "dwt2d even count": lambda: dwt2d(_noisy((64, 48), 13), get_wavelet("db7"), 2),
    "swt2d odd count": lambda: swt2d(_noisy((31, 29), 14), get_wavelet("haar"), 2),
    "dwt1d odd count": lambda: dwt1d(_noisy((3, 101), 15), get_wavelet("sym4"), 3),
    "swt1d even count": lambda: swt1d(_noisy((2, 64), 16), get_wavelet("db2"), 3),
    "dwt2d bf16": lambda: dwt2d(_noisy((64, 64), 17).bfloat16(), get_wavelet("db2"), 2,
                                precision="bf16-fast"),
}


def _f32_ulp(v):
    return float(np.spacing(np.float32(abs(float(v)))))


@pytest.mark.parametrize("case", list(ESTIMATED))
def test_noise_sigma_and_universal_threshold_match_jax(case):
    c = ESTIMATED[case]()
    j = _jax(c)
    for got, want in ((ops.noise_sigma(c), jops.noise_sigma(j)),
                      (ops.universal_threshold(c), jops.universal_threshold(j))):
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - float(want)) <= _f32_ulp(want)


def test_median_matches_jnp_median_and_keeps_nan():
    from pdwt_tpu_torch.ops.estimate import median

    rng = np.random.default_rng(18)
    for n in (1, 2, 7, 10, 1001):
        x = rng.standard_normal(n).astype(np.float32)
        assert float(median(torch.from_numpy(x))) == float(jnp.median(jnp.asarray(x)))
    x = np.array([1.0, np.nan, 3.0, 2.0], np.float32)
    assert np.isnan(float(median(torch.from_numpy(x)))) and np.isnan(float(jnp.median(x)))


def _band_pairs(got, want):
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            yield from zip(g, w)
        else:
            yield g, w


def _bayes64(d, sigma):
    """(BayesShrink threshold of one band in float64 with the float32
    sigma, its condition number in the band's mean energy m: t = s2 /
    sqrt(m - s2) moves by 1/2 m / (m - s2) times m's relative error)."""
    d = tensor_to_numpy(d).astype(np.float64).ravel()
    s2 = float(sigma) ** 2
    m = float(np.mean(d * d))
    if m <= s2:
        return float(np.abs(d).max()), 1.0
    return s2 / np.sqrt(m - s2), max(1.0, 0.5 * m / (m - s2))


@pytest.mark.parametrize("case", list(ESTIMATED))
def test_bayes_thresholds_match_jax(case):
    """1e-6 relative in each band's mean energy, carried through the
    formula's condition number (a band of mostly noise has m near s2): the
    port against the float64 evaluation of the same formula, and against
    JAX within that plus JAX's own distance from it (its float32 sum of
    d^2 on the CPU errs by up to 2e-6 relative on 1024 values)."""
    c = ESTIMATED[case]()
    got, want = ops.bayes_thresholds(c), jops.bayes_thresholds(_jax(c))
    sigma = ops.noise_sigma(c)
    assert len(got) == len(want) == c.levels
    for (g, w), (band, _) in zip(_band_pairs(got, want), _band_pairs(c.details, c.details)):
        assert g.dtype == torch.float32 and g.device == c.approx.device
        t64, cond = _bayes64(band, sigma)
        g, w = float(g), float(w)
        assert abs(g - t64) <= BAYES_RTOL * cond * abs(t64)
        assert abs(g - w) <= BAYES_RTOL * cond * abs(w) + abs(w - t64)


def _jax_risk(d, sigma):
    """The risk curve of ``pdwt_tpu/ops/estimate.py:sure_thresholds``."""
    s2 = sigma * sigma
    d = jnp.asarray(d).astype(jnp.float32).ravel()
    n = d.size
    a = jnp.sort(d * d)
    ks = jnp.arange(1, n + 1, dtype=jnp.float32)
    return n * s2 - 2.0 * s2 * ks + jnp.cumsum(a) + (n - ks) * a


@pytest.mark.parametrize("case", list(ESTIMATED))
@pytest.mark.parametrize("hybrid", [True, False])
def test_sure_thresholds_and_risk_curves_match_jax(case, hybrid):
    c = ESTIMATED[case]()
    j = _jax(c)
    got = ops.sure_thresholds(c, hybrid=hybrid)
    want = jops.sure_thresholds(j, hybrid=hybrid)
    for g, w in _band_pairs(got, want):
        assert g.dtype == torch.float32
        assert abs(float(g) - float(w)) <= SURE_RTOL * abs(float(w))
    sigma, jsigma = ops.noise_sigma(c), jops.noise_sigma(j)
    for (b, jb) in _band_pairs(c.details, j.details):
        risk = sure_risk(b, sigma)[2].numpy()
        jrisk = np.asarray(_jax_risk(jb, jsigma))
        assert np.abs(risk - jrisk).max() <= SURE_RTOL * np.abs(jrisk).max()


def test_per_band_thresholds_feed_the_threshold_ops():
    """Per-level, per-band thresholds as 0-dim tensors go straight in as
    beta, on a float32 and on a mixed bf16 tree (JAX's values on both
    sides)."""
    for case in ("dwt2d even count", "dwt2d bf16", "dwt1d odd count"):
        c = ESTIMATED[case]()
        j = _jax(c)
        jb = list(jops.bayes_thresholds(j))
        tb = [tuple(torch.tensor(float(x)) for x in b) if isinstance(b, tuple)
              else torch.tensor(float(b)) for b in jb]
        close_elementwise(ops.soft_threshold(c, tb, do_thresh_appcoeffs=True),
                          jops.soft_threshold(j, jb, do_thresh_appcoeffs=True))
        twice = lambda bs: [tuple(2 * x for x in b) if isinstance(b, tuple) else 2 * b
                            for b in bs]
        close_elementwise(ops.firm_threshold(c, tb, twice(tb)),
                          jops.firm_threshold(j, jb, twice(jb)))
