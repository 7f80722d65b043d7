"""The boundary modes through the port's higher layers against the JAX
package's: ``Wavelets(mode=)``, ``denoise_step(boundary=)``,
``auto_denoise(boundary=)`` and the demo's ``--mode``, with JAX's errors
and warning.

JAX runs its ``backend="fma"`` route (its CPU route), on the same numpy
inputs; float32 on both sides.  Tolerances: images and coefficients within
4e-6 of the largest value (the same sums in the same order), norms 1e-5
(float32 sums in another order), the demo's files 1e-5.  JAX's denoiser
guards the boundary with a string comparison (``ROADMAP.md``, "Open faults
of the reference"); the port tests ``all_periodization``, so the per-axis
tuple of periodizations is held on the port's side only.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from pdwt_tpu import Wavelets as JWavelets
from pdwt_tpu import demo as jdemo
from pdwt_tpu.core import modes as jmodes
from pdwt_tpu.models import auto_denoise as jauto_denoise
from pdwt_tpu.models import denoise_step as jdenoise_step
from pdwt_tpu_torch import Wavelets, demo, get_wavelet
from pdwt_tpu_torch.models import auto_denoise, denoise_step

RTOL, NORM_RTOL = 4e-6, 1e-5


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _leaves(c):
    if isinstance(c.details[0], tuple):
        return [c.approx, *[t for band in c.details for t in band]]
    return [c.approx, *c.details]


def _close(got, want, rtol=RTOL):
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    scale = max(float(np.abs(_np(w)).max()) for w in want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        assert float(np.abs(g - w).max()) <= rtol * scale


@pytest.mark.parametrize("shape,ndim,wname,levels,mode", [
    ((37, 29), 2, "db4", 2, "symmetric"),
    ((24, 20), 2, "db2", 2, ("reflect", "zero")),
    ((61, 52), 2, "sym4", 2, ("periodization", "smooth")),
    ((3, 45), 1, "db3", 2, "antisymmetric"),   # batched 1D
    ((45,), 1, "haar", 3, "antireflect")])     # one signal
def test_facade_modes_match_jax(shape, ndim, wname, levels, mode):
    """forward (the pywt sizes, per axis), get_coeff, soft_threshold, norm1,
    inverse and run_denoise against JAX's facade; info() and the zero
    coefficients' geometry."""
    img = _img(shape, seed=levels)
    W = Wavelets(img, wname=wname, levels=levels, ndim=ndim, mode=mode, device="cpu")
    J = JWavelets(img, wname=wname, levels=levels, ndim=ndim, mode=mode, backend="fma")
    assert W.spec.mode == J.spec.mode and W.info()["mode"] == mode
    _close(_leaves(W.forward()), _leaves(J.forward()))
    for num in (0, 1):
        assert W.get_coeff(num).shape == np.asarray(J.get_coeff(num)).shape
    zeros = Wavelets(nr=img.shape[0] if img.ndim == 2 else 1, nc=img.shape[-1], wname=wname,
                     levels=levels, ndim=ndim, mode=mode, device="cpu")
    assert [t.shape for t in _leaves(zeros.coeffs)] == [t.shape for t in _leaves(W.coeffs)]
    W.soft_threshold(10.0)
    J.soft_threshold(10.0)
    assert np.isclose(W.norm1(), J.norm1(), rtol=NORM_RTOL, atol=0)
    _close(W.inverse(), J.inverse())
    W2 = Wavelets(img, wname=wname, levels=levels, ndim=ndim, mode=mode, device="cpu")
    J2 = JWavelets(img, wname=wname, levels=levels, ndim=ndim, mode=mode, backend="fma")
    (out, n1), (jout, jn1) = W2.run_denoise(12.0), J2.run_denoise(12.0)
    _close(out, jout)
    assert np.isclose(float(n1), float(jn1), rtol=NORM_RTOL, atol=0)


def test_facade_mode_errors_and_warning_match_jax():
    for kwargs, match in (({"do_swt": True}, "periodic by definition"),
                          ({"do_separable": False}, "mode='periodization' only"),
                          ({"mode": "symmetrical"}, "unknown boundary mode"),
                          ({"mode": ("reflect",)}, "expected 2 boundary modes")):
        kw = {"mode": "symmetric", **kwargs}
        for cls, extra in ((Wavelets, {"device": "cpu"}), (JWavelets, {})):
            with pytest.raises(ValueError, match=match):
                cls(nr=16, nc=16, wname="db2", **kw, **extra)
    for cls, extra in ((Wavelets, {"device": "cpu"}), (JWavelets, {})):
        with pytest.warns(UserWarning, match="cycle spinning shifts circularly"):
            cls(nr=16, nc=16, wname="db2", mode="zero", do_cycle_spinning=True, **extra)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Wavelets(nr=16, nc=16, wname="db2", mode=("periodization", "periodization"),
                 do_swt=True, device="cpu")


def test_custom_filters_resize_the_coefficients_under_a_mode():
    """A new filter length changes the pywt sizes: the zero coefficients
    are rebuilt, as JAX rebuilds them."""
    W = Wavelets(nr=20, nc=20, wname="db2", levels=2, mode="symmetric", device="cpu")
    J = JWavelets(nr=20, nc=20, wname="db2", levels=2, mode="symmetric", backend="fma")
    w8 = get_wavelet("db8")
    for F in (W, J):
        F.set_filters_forward("db8", w8.dec_lo, w8.dec_hi)
        F.set_filters_inverse(w8.rec_lo, w8.rec_hi)
    assert tuple(W.coeffs.approx.shape) == tuple(J.coeffs.approx.shape) != (5, 5)
    img = _img((20, 20), seed=4)
    W.set_image(img)
    J.set_image(img)
    _close(_leaves(W.forward()), _leaves(J.forward()))
    _close(W.inverse(), J.inverse())


@pytest.mark.parametrize("boundary", ["symmetric", ("reflect", "periodization")])
def test_denoisers_take_the_boundary_as_jax(boundary):
    img = _img((30, 23), seed=5)
    x = torch.from_numpy(img)
    for mode, beta in (("soft", 15.0), ("hard", [20.0, 10.0])):
        out, n1 = denoise_step(x, None, "db3", 2, beta, mode=mode, boundary=boundary)
        jout, jn1 = jax.jit(lambda v: jdenoise_step(v, None, "db3", 2, beta, mode=mode,
                                                    boundary=boundary, backend="fma"))(img)
        _close(out, jout)
        assert np.isclose(float(n1), float(jn1), rtol=NORM_RTOL, atol=0)
    for method in ("bayes", "sure", "universal"):
        want = jax.jit(lambda v: jauto_denoise(v, "db3", 2, method=method, boundary=boundary,
                                               backend="fma"))(img)
        _close(auto_denoise(x, "db3", 2, method=method, boundary=boundary), want)


def test_denoisers_refuse_a_boundary_where_jax_does():
    x = torch.from_numpy(_img((16, 16)))
    gen = torch.Generator().manual_seed(1)
    for kwargs in ({"swt": True}, {"generator": gen}):
        kw = dict(kwargs)
        g = kw.pop("generator", None)
        with pytest.raises(ValueError, match="without cycle spinning"):
            denoise_step(x, g, "db2", 1, 1.0, boundary="zero", **kw)
        with pytest.raises(ValueError, match="without cycle spinning"):
            jdenoise_step(x.numpy(), jax.random.PRNGKey(0) if g is not None else None, "db2",
                          1, 1.0, boundary="zero", **kw)
    with pytest.raises(ValueError, match="decimated DWT only"):
        auto_denoise(x, "db2", 1, swt=True, boundary=("zero", "zero"))
    # every axis periodization is periodization (JAX's guard compares strings)
    out, _ = denoise_step(x, None, "db2", 1, 1.0, swt=True,
                          boundary=("periodization", "periodization"))
    _close(out, denoise_step(x, None, "db2", 1, 1.0, swt=True)[0], 0.0)


@pytest.mark.parametrize("scenario,mode", [("2", "smooth"), ("3", "periodic")])
def test_demo_mode_matches_jax(scenario, mode, tmp_path, capsys):
    img = _img((40, 36), seed=8)
    img.tofile(tmp_path / "img.dat")
    args = [str(tmp_path / "img.dat"), "--nr", "40", "--nc", "36", "--scenario", scenario,
            "--wavelet", "db3", "--levels", "2", "--mode", mode]
    assert demo.main(args + ["--out", str(tmp_path / "p.dat"), "--device", "cpu"]) == 0
    assert f"Boundary mode : {mode}" in capsys.readouterr().out
    assert jdemo.main(args + ["--out", str(tmp_path / "j.dat")]) == 0
    mine, theirs = (np.fromfile(tmp_path / f, np.float32) for f in ("p.dat", "j.dat"))
    _close(mine, theirs, 1e-5)
    with pytest.raises(SystemExit) as err:
        demo.main(args + ["--nonseparable", "--device", "cpu"])
    assert err.value.code == 2 and "periodization-only" in capsys.readouterr().err
    assert jmodes.MODES == tuple(__import__("pdwt_tpu_torch").MODES)
