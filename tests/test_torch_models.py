"""The port's models against the JAX package's: the group-threshold
denoising step, ``auto_denoise`` with each estimator, ``cycle_spin_denoise``
and the (F)ISTA solver.

Images come from ``default_rng`` (16 to 70 pixels a side, odd sizes too)
and run on the CPU, JAX on its fma path.  Tolerances, relative to the
largest reference value: 4e-6 for images (the same taps in the same order;
either side may contract a multiply-add, and the estimated thresholds
differ by float32 sums in another order), 1e-5 for norms, 1e-4 for (F)ISTA
after 25 iterations (its result and every objective value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pdwt_tpu.models import auto_denoise as jauto_denoise
from pdwt_tpu.models import denoise_step as jdenoise_step
from pdwt_tpu.models import ista as jista
from pdwt_tpu_torch import get_wavelet, models, ops
from pdwt_tpu_torch.models import auto_denoise, cycle_spin_denoise, denoise_step, ista

RTOL, NORM_RTOL, ISTA_RTOL = 4e-6, 1e-5, 1e-4


def _img(shape, seed=0, noise=15.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(*(np.linspace(0, 4, n) for n in shape), indexing="ij")
    clean = 90 * np.sin(yy) * np.cos(1.5 * xx) + 120
    return (clean + rng.normal(0, noise, shape)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    g, w = got.detach().numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    assert np.abs(g - w).max() <= rtol * np.abs(w).max(), np.abs(g - w).max()


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("wname,shape,levels", [("db2", (40, 56), 2), ("haar", (33, 27), 3),
                                                ("db7", (64, 64), 2)])
def test_denoise_step_group_matches_jax(swt, normalize, wname, shape, levels):
    """mode="group" is not fused: threshold, norm1, inverse, as in JAX."""
    img = _img(shape, seed=1)
    jout, jn1 = jax.jit(lambda x: jdenoise_step(x, None, wname, levels, 20.0, swt=swt,
                                                mode="group", normalize=normalize,
                                                backend="fma"))(img)
    out, n1 = denoise_step(torch.from_numpy(img), None, wname, levels, 20.0, swt=swt,
                           mode="group", normalize=normalize)
    _close(out, jout)
    assert abs(float(n1) - float(jn1)) <= NORM_RTOL * abs(float(jn1))


@pytest.mark.parametrize("method", ["bayes", "sure", "universal"])
@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_auto_denoise_matches_jax(method, swt, mode):
    """On the SWT, universal with an elementwise mode runs the fused
    inverse; bayes and sure thresholds go per band through the ops."""
    img = _img((48, 37), seed=2)
    want = jax.jit(lambda x: jauto_denoise(x, "db3", 3, method=method, mode=mode, swt=swt,
                                           backend="fma"))(img)
    _close(auto_denoise(torch.from_numpy(img), "db3", 3, method=method, mode=mode, swt=swt),
           want)


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_auto_denoise_group_universal_matches_jax(swt):
    img = _img((40, 40), seed=3)
    want = jax.jit(lambda x: jauto_denoise(x, "sym4", 2, method="universal", mode="group",
                                           swt=swt, backend="fma"))(img)
    _close(auto_denoise(torch.from_numpy(img), "sym4", 2, method="universal", mode="group",
                        swt=swt), want)


def test_auto_denoise_refuses_what_jax_refuses_and_what_waits():
    x = torch.from_numpy(_img((16, 16)))
    with pytest.raises(ValueError, match="unknown method"):
        auto_denoise(x, "db2", 1, method="minimax")
    with pytest.raises(ValueError, match="decimated DWT only"):
        auto_denoise(x, "db2", 1, boundary="symmetric", swt=True)
    with pytest.raises(ValueError, match="decimated DWT only"):
        jauto_denoise(jnp.asarray(x.numpy()), "db2", 1, boundary="symmetric", swt=True)
    # a boundary mode on the DWT is ported: it matches JAX's
    want = jax.jit(lambda v: jauto_denoise(v, "db2", 1, boundary="symmetric",
                                           backend="fma"))(x.numpy())
    _close(auto_denoise(x, "db2", 1, boundary="symmetric"), want)


@pytest.mark.parametrize("spins,shape", [(3, (24, 40)), (8, (31, 17))])
def test_cycle_spin_denoise_is_the_mean_of_the_steps(spins, shape):
    """Equal to the mean of ``denoise_step``s drawing from the same
    generator (summed in order, one division); each step against JAX's at
    the same shifts (the image rolled first, ``key=None``)."""
    img = torch.from_numpy(_img(shape, seed=4))
    w = get_wavelet("db2")
    got = cycle_spin_denoise(img, torch.Generator().manual_seed(9), w, 2, 12.0, spins=spins)
    g = torch.Generator().manual_seed(9)
    acc = torch.zeros_like(img)
    for _ in range(spins):
        peek = torch.Generator()
        peek.set_state(g.get_state())
        shifts = ops.random_shift(peek, shape)  # the draws the step is about to make
        out, _ = denoise_step(img, g, w, 2, 12.0)
        rolled = np.roll(img.numpy(), shifts, axis=(0, 1))
        jout, _ = jax.jit(lambda x: jdenoise_step(x, None, "db2", 2, 12.0, backend="fma"))(rolled)
        _close(out, np.roll(np.asarray(jout), (-shifts[0], -shifts[1]), axis=(0, 1)))
        acc = acc + out
    assert torch.equal(got, acc / torch.full((), spins, dtype=acc.dtype))


# -- (F)ISTA, on the operators of tests/test_solver.py ----------------------

def _kernel(asym):
    k = np.outer(np.hanning(7), np.hanning(7))
    if asym:
        k = k * np.linspace(0.5, 1.5, 7)[None, :]
    return (k / k.sum()).astype(np.float32)


def _jblur(k):
    kj = jnp.asarray(k)
    return lambda v: jax.scipy.signal.convolve2d(v, kj, mode="same")


def _tblur(k):
    """scipy's "same" convolution: the flipped kernel, correlated, zeros
    around."""
    kt = torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1]))[None, None]
    return lambda v: F.conv2d(v[None, None], kt, padding=3)[0, 0]


def _problem(case):
    """(y, port kwargs, JAX kwargs) of one solver case."""
    rng = np.random.default_rng(5)
    clean = np.zeros((64, 64), np.float32)
    clean[20:45, 15:50] = 100.0
    noise = rng.standard_normal((64, 64)).astype(np.float32)
    if case in ("identity", "group"):
        y = clean + 20 * noise
        kw = dict(wav="db4", levels=3, lam=25.0 if case == "identity" else 40.0,
                  reg="l1" if case == "identity" else "group")
        return y, kw, dict(kw)
    if case in ("blur", "asymmetric blur"):
        k = _kernel(case != "blur")
        y = np.asarray(_jblur(k)(jnp.asarray(clean))) + 2.0 * noise
        kw = dict(wav="db2", levels=2, lam=1.0)
        return y, dict(kw, op=_tblur(k)), dict(kw, op=_jblur(k))
    mask = (rng.uniform(size=(64, 64)) > 0.3).astype(np.float32)
    y = clean * mask
    kw = dict(wav="db4", levels=3, lam=0.5)
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    return y, dict(kw, op=lambda x: tm * x, x0=torch.from_numpy(y)), \
        dict(kw, op=lambda x: jm * x, x0=jnp.asarray(y))


@pytest.mark.parametrize("case", ["identity", "blur", "asymmetric blur", "group", "mask"])
@pytest.mark.parametrize("fista", [True, False], ids=["fista", "ista"])
def test_ista_matches_jax(case, fista):
    """25 iterations; where op_t is not given, the port derives it with
    torch.func.vjp and JAX with jax.linear_transpose."""
    y, kw, jkw = _problem(case)
    x, trace = ista(torch.from_numpy(y), iters=25, fista=fista, **kw)
    jx, jtrace = jax.jit(lambda yy: jista(yy, iters=25, fista=fista, backend="fma",
                                          **jkw))(jnp.asarray(y))
    _close(x, jx, ISTA_RTOL)
    jt = np.asarray(jtrace)
    assert trace.shape == (25,) and trace.dtype == torch.float32
    assert (np.abs(trace.numpy() - jt) <= ISTA_RTOL * np.abs(jt)).all()


def test_ista_refuses_an_unknown_regulariser():
    with pytest.raises(ValueError, match="reg must be"):
        ista(torch.zeros(16, 16), reg="tv")


@pytest.mark.parametrize("name,item", [("packet_denoise", 14), ("starlet_auto_denoise", 14)])
def test_deferred_models_name_their_roadmap_item(name, item):
    """The models once deferred to ROADMAP item 14 are exported now (their
    parity with JAX: tests/test_torch_packets.py, test_torch_starlet.py)."""
    assert name in models.__all__ and callable(getattr(models, name))
    assert not hasattr(models, "DEFERRED")
