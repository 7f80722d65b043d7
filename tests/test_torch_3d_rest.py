"""What the port builds on its 3D transforms, against the JAX package: the
operators on ``Coeffs3D`` trees (the thresholds and projections, the group
threshold over 7-band groups, the norms, the estimators, which read the
finest ``ddd`` band, and ``circshift3d``), the volume models
(``denoise_step_3d``, ``auto_denoise_3d``), ``Wavelets`` on a volume, 3D
checkpoints both ways and the demo's ``--nd``.

Volumes come from ``default_rng`` (odd sides too) and run on the CPU, JAX
on its fma path.  Tolerances, relative to the largest reference value:
2.4e-7 for the elementwise operators (2 float32 ulps), 6e-7 for the group
threshold (5 ulps: its factor 1 - beta / norm cancels, ``ROADMAP.md`` §3),
1e-5 for transforms (the depth product sums in another order), norms and
estimated thresholds (float32 sums in another order).
"""
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import Wavelets as JWavelets
from pdwt_tpu import demo as jdemo
from pdwt_tpu import ops as jops
from pdwt_tpu.core import separable3d as jsep3
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu.models import auto_denoise_3d as jauto_denoise_3d
from pdwt_tpu.models import denoise_step_3d as jdenoise_step_3d
from pdwt_tpu.utils import checkpoint as jckpt
from pdwt_tpu_torch import Coeffs2D, Coeffs3D, Wavelets, demo, dwt2d, dwt3d, ops
from pdwt_tpu_torch.models import auto_denoise_3d, denoise_step_3d
from pdwt_tpu_torch.utils import (coeffs3d_from_numpy, load_coeffs, save_coeffs, tensor_to_numpy,
                                  wavelet_from_arrays, write_dat)

ELEM_RTOL, GROUP_RTOL, RTOL = 2.4e-7, 6e-7, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vol(shape, seed=0, noise=15.0):
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*(np.linspace(0, 3, n) for n in shape), indexing="ij")
    clean = 90 * np.sin(yy) * np.cos(1.5 * xx) * np.cos(zz) + 120
    return (clean + rng.normal(0, noise, shape)).astype(np.float32)


def _leaves(c):
    if not hasattr(c, "details"):
        return [c]
    return [c.approx] + [b for d in c.details for b in d]


def _np(t):
    if isinstance(t, torch.Tensor):
        return tensor_to_numpy(t)
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, rtol=RTOL):
    gl, wl = [_np(t) for t in _leaves(got)], [_np(t) for t in _leaves(want)]
    assert len(gl) == len(wl)
    scale = max(float(np.abs(w).max()) for w in wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= rtol * scale, float(np.abs(g - w).max())


def _value(got, want, rtol=RTOL):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), (float(got), float(want))


def _trees(shape=(7, 12, 17), levels=2, swt=False, seed=0):
    """(port tree, JAX tree) of the same values: JAX's transform carried
    across."""
    x = jnp.asarray(_vol(shape, seed))
    fwd = jsep3.swt3d if swt else jsep3.dwt3d
    j = jax.jit(lambda v: fwd(v, jget_wavelet("db2"), levels, backend="fma"))(x)
    return coeffs3d_from_numpy(np.asarray(j.approx),
                               [[np.asarray(b) for b in d] for d in j.details]), j


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

ELEMENTWISE = {
    "soft": (lambda o, c, **k: o.soft_threshold(c, 20.0, **k)),
    "hard": (lambda o, c, **k: o.hard_threshold(c, 20.0, **k)),
    "garrote": (lambda o, c, **k: o.garrote_threshold(c, 20.0, **k)),
    "firm": (lambda o, c, **k: o.firm_threshold(c, 10.0, 30.0, **k)),
    "soft per band": (lambda o, c, **k: o.soft_threshold(
        c, [tuple(10.0 + j for j in range(7)), tuple(20.0 + j for j in range(7))], **k)),
}


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
@pytest.mark.parametrize("op", list(ELEMENTWISE))
@pytest.mark.parametrize("kw", [{}, {"normalize": True, "do_thresh_appcoeffs": True}],
                         ids=["plain", "normalize-app"])
def test_thresholds_match_jax(op, kw, swt):
    c, j = _trees(swt=swt, seed=1)
    _close(ELEMENTWISE[op](ops, c, **kw), ELEMENTWISE[op](jops, j, **kw), ELEM_RTOL)


@pytest.mark.parametrize("app", [False, True])
def test_projection_and_shrink_match_jax(app):
    c, j = _trees(seed=2)
    _close(ops.proj_linf(c, 40.0, do_thresh_appcoeffs=app),
           jops.proj_linf(j, 40.0, do_thresh_appcoeffs=app), ELEM_RTOL)
    _close(ops.shrink(c, 0.7, do_thresh_appcoeffs=app),
           jops.shrink(j, 0.7, do_thresh_appcoeffs=app), ELEM_RTOL)


@pytest.mark.parametrize("kw", [{}, {"normalize": True, "do_thresh_appcoeffs": True}],
                         ids=["plain", "normalize-app"])
def test_group_threshold_over_seven_bands_matches_jax(kw):
    c, j = _trees(seed=3)
    got = ops.group_soft_threshold(c, 25.0, **kw)
    assert isinstance(got, Coeffs3D) and all(len(d) == 7 for d in got.details)
    _close(got, jops.group_soft_threshold(j, 25.0, **kw), GROUP_RTOL)
    app = kw.get("do_thresh_appcoeffs", False)
    _value(ops.norm_l21(c, do_thresh_appcoeffs=app), jops.norm_l21(j, do_thresh_appcoeffs=app))
    _value(ops.thresholded_norm_l21(c, 25.0, **kw), jops.thresholded_norm_l21(j, 25.0, **kw))


@pytest.mark.parametrize("beta", [[20.0, 10.0], (20.0, 10.0), [(20.0,) * 3] * 2])
@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_group_threshold_refuses_a_sequence_beta(kind, beta):
    """A per-level (per-band) beta raises a ValueError naming the scalar
    contract, not torch.full's TypeError."""
    x = torch.from_numpy(_vol((8, 12, 16), seed=4))
    w = wavelet_from_arrays(jget_wavelet("db2"))
    c = dwt3d(x, w, 2) if kind == "3d" else dwt2d(x[0], w, 2)
    with pytest.raises(ValueError, match="scalar beta"):
        ops.group_soft_threshold(c, beta)
    assert isinstance(ops.group_soft_threshold(c, 20.0), Coeffs3D if kind == "3d" else Coeffs2D)


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_norms_and_estimators_match_jax(swt):
    c, j = _trees(shape=(8, 20, 24), swt=swt, seed=5)
    for name in ("norm1", "norm2sq", "noise_sigma", "universal_threshold"):
        _value(getattr(ops, name)(c), getattr(jops, name)(j))
    _value(ops.thresholded_norm1(c, 20.0, mode="garrote"),
           jops.thresholded_norm1(j, 20.0, mode="garrote"))
    # the finest all-high-pass band, ddd of level 1
    d = tensor_to_numpy(c.details[0][6]).ravel()
    _value(ops.noise_sigma(c), np.median(np.abs(d)) / 0.6744897501960817)
    s2 = float(ops.noise_sigma(c)) ** 2
    got, want = ops.bayes_thresholds(c), jops.bayes_thresholds(j)
    assert len(got) == len(want) == 2 and all(len(g) == 7 for g in got)
    for g, w, bands in zip(got, want, c.details):
        for t, jt, band in zip(g, w, bands):
            # sigma^2 / sqrt(m - sigma^2) in the band's mean square m: a
            # float32 sum in another order moves it by its condition number
            m = float(np.mean(tensor_to_numpy(band).astype(np.float64) ** 2))
            cond = 1.0 + m / (m - s2) if m > s2 else 1.0
            _value(t, jt, RTOL * cond)
    for g, w, bands in zip(ops.sure_thresholds(c), jops.sure_thresholds(j), c.details):
        for t, jt, band in zip(g, w, bands):
            _sure_close(float(t), float(jt), tensor_to_numpy(band).astype(np.float64), s2)


def _sure_close(t, jt, d, s2):
    """SURE's threshold is the argmin of a float32 risk curve over the
    sorted squares, so a sum in another order can pick a neighbouring
    square: equal within 1e-5, or at a risk (float64) within 1e-5 of the
    minimum, relative to n sigma^2 + sum d^2."""
    if abs(t - jt) <= RTOL * abs(jt):
        return
    a = np.sort(d.ravel() ** 2)
    n = a.size
    k = np.arange(1, n + 1)
    risk = n * s2 - 2.0 * s2 * k + np.cumsum(a) + (n - k) * a
    at = risk[int(np.argmin(np.abs(a - t * t)))]
    assert at - min(n * s2, risk.min()) <= RTOL * (n * s2 + a.sum()), (t, jt)


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 5, -3), (9, -20, 40)])
def test_circshift3d_matches_jax(shift):
    x = _vol((5, 7, 9), seed=6)
    got = ops.circshift3d(torch.from_numpy(x), *shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.circshift3d(jnp.asarray(x),
                                                                           *shift)))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

STEP = [(False, "soft"), (True, "soft"), (True, "garrote"), (True, "group"), (False, "hard")]


@pytest.mark.parametrize("swt,mode", STEP)
def test_denoise_step_3d_matches_jax_without_a_shift(swt, mode):
    x = _vol((6, 14, 18), seed=7)
    out, n1 = denoise_step_3d(torch.from_numpy(x), None, "db2", 2, 15.0, swt=swt, mode=mode,
                              normalize=True)
    jout, jn1 = jax.jit(lambda v: jdenoise_step_3d(v, None, "db2", 2, 15.0, swt=swt, mode=mode,
                                                   normalize=True, backend="fma"))(x)
    _close(out, jout)
    _value(n1, jn1)


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_denoise_step_3d_shifts_depth_row_column_in_order(swt):
    """The generator's three draws are the depth, row and column shifts:
    JAX's step on the volume rolled by them, rolled back, is the same."""
    x = _vol((5, 12, 16), seed=8)
    out, n1 = denoise_step_3d(torch.from_numpy(x), torch.Generator().manual_seed(3), "db2", 2,
                              15.0, swt=swt)
    g = torch.Generator().manual_seed(3)
    sd, sr, sc = (int(torch.randint(0, n, (), generator=g)) for n in x.shape)
    assert (sd, sr, sc) != (0, 0, 0)
    rolled = np.roll(x, (sd, sr, sc), axis=(0, 1, 2))
    jout, jn1 = jax.jit(lambda v: jdenoise_step_3d(v, None, "db2", 2, 15.0, swt=swt,
                                                   backend="fma"))(rolled)
    _close(out, np.roll(np.asarray(jout), (-sd, -sr, -sc), axis=(0, 1, 2)))
    _value(n1, jn1)


@pytest.mark.parametrize("method", ["bayes", "sure", "universal"])
@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_auto_denoise_3d_matches_jax(method, swt):
    x = _vol((8, 16, 20), seed=9)
    got = auto_denoise_3d(torch.from_numpy(x), "db2", 2, method=method, swt=swt)
    want = jax.jit(lambda v: jauto_denoise_3d(v, "db2", 2, method=method, swt=swt,
                                              backend="fma"))(x)
    _close(got, want)
    with pytest.raises(ValueError):
        auto_denoise_3d(torch.from_numpy(x), "db2", 2, method="nope")


# ---------------------------------------------------------------------------
# the facade on a volume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"do_swt": True}, {"do_cycle_spinning": True, "seed": 4},
                                {"mode": ("symmetric", "periodization", "zero")}],
                         ids=["dwt", "swt", "cycle", "modes"])
def test_facade_on_a_volume_matches_jax(kw):
    x = _vol((7, 12, 18), seed=10)
    W = Wavelets(x, wname="db2", levels=2, device="cpu", **kw)
    J = JWavelets(x, wname="db2", levels=2, backend="fma", **kw)
    assert W.spec.ndim == J.spec.ndim == 3 and W.spec.nd == 7
    assert W.info()["dims"] == J.info()["dims"] == (7, 12, 18)
    _close(W.forward(), J.forward())
    assert (W.current_shift_d, W.current_shift_r, W.current_shift_c) == \
        (J.current_shift_d, J.current_shift_r, J.current_shift_c)
    W.soft_threshold(20.0)
    J.soft_threshold(20.0)
    _value(W.norm1(), J.norm1())
    _close(W.inverse(), J.inverse())
    if "mode" not in kw:
        W2 = Wavelets(x, wname="db2", levels=2, device="cpu", **kw)
        J2 = JWavelets(x, wname="db2", levels=2, backend="fma", **kw)
        (out, n1), (jout, jn1) = W2.run_denoise(15.0), J2.run_denoise(15.0)
        _close(out, jout)
        _value(n1, jn1)


def test_facade_flat_numbering_and_state():
    x = _vol((16, 16, 16), seed=11)
    W = Wavelets(x, wname="db2", levels=2, device="cpu")
    J = JWavelets(x, wname="db2", levels=2, backend="fma")
    W.forward()
    J.forward()
    for num in (0, 1, 7, 8, 14):
        _close(W.get_coeff(num), J.get_coeff(num))
    assert W.get_coeff(14).shape == tuple(W.coeffs.details[1][6].shape)
    for num in (15, 30):
        with pytest.raises(IndexError):
            W.get_coeff(num)
    band = np.full(W.get_coeff(9).shape, 3.0, np.float32)
    W.set_coeff(band, 9)
    J.set_coeff(band, 9)
    assert float(W.coeffs.details[1][1].abs().max()) == 3.0
    _close(W.inverse(), J.inverse())
    # circshift with sd, in place and not
    W.set_image(x)
    J.set_image(x)
    got = W.circshift(3, 5, inplace=False, sd=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.circshift(3, 5, inplace=False, sd=2)))
    np.testing.assert_array_equal(W.get_image(), x)
    W.circshift(1, 2, sd=-1)
    np.testing.assert_array_equal(W.get_image(), np.roll(x, (-1, 1, 2), axis=(0, 1, 2)))
    assert "shape=(16, 16, 16)" in repr(W)


def test_facade_volume_checks():
    x = _vol((6, 10, 12), seed=12)
    W = Wavelets(x, wname="db2", levels=1, device="cpu")
    other = Wavelets(_vol((5, 10, 12)), wname="db2", levels=1, device="cpu")
    W.forward()
    other.forward()
    with pytest.raises(ValueError, match="geometry"):
        W.add_wavelet(other)
    with pytest.warns(UserWarning, match="non-separable"):
        assert Wavelets(x, wname="db2", levels=1, device="cpu",
                        do_separable=False).spec.do_separable
    with pytest.warns(UserWarning, match="maximum possible level"):
        assert Wavelets(x, wname="db2", levels=5, device="cpu").spec.nlevels == 1
    with pytest.raises(ValueError, match="3D volume"):
        Wavelets(x[0], wname="db2", levels=1, device="cpu", ndim=3)
    Z = Wavelets(nr=10, nc=12, wname="db2", levels=1, ndim=3, device="cpu")
    assert tuple(Z.get_image(copy=False).shape) == (1, 10, 12) and Z.spec.shape == (1, 10, 12)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        B = Wavelets(x, wname="db2", levels=1, device="cpu", precision="bf16-fast")
    c = B.forward()
    assert c.approx.dtype == torch.float32 and c.details[0][0].dtype == torch.bfloat16
    assert B.inverse().dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_3d_checkpoints_cross_packages(dt, tmp_path):
    c, j = _trees(seed=13)
    if dt == "bfloat16":
        c = Coeffs3D(c.approx, tuple(tuple(b.to(torch.bfloat16) for b in d) for d in c.details))
        j = type(j)(j.approx, tuple(tuple(b.astype(jnp.bfloat16) for b in d)
                                    for d in j.details))
    save_coeffs(str(tmp_path / "port.npz"), c)
    jc = jckpt.load_coeffs(str(tmp_path / "port.npz"))
    jckpt.save_coeffs(str(tmp_path / "jax.npz"), j)
    pc = load_coeffs(str(tmp_path / "jax.npz"), device="cpu")
    assert isinstance(pc, Coeffs3D) and isinstance(jc, jsep3.Coeffs3D)
    for a, b, ja in zip(_leaves(c), _leaves(pc), _leaves(jc)):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert jnp.dtype(ja.dtype).name == str(a.dtype).split(".")[-1]
        np.testing.assert_array_equal(np.asarray(ja).astype(np.float32), tensor_to_numpy(a))


# ---------------------------------------------------------------------------
# the demo's --nd
# ---------------------------------------------------------------------------

@pytest.fixture
def dat_volume(tmp_path):
    vol = _vol((6, 16, 12), seed=14)
    path = str(tmp_path / "v.dat")
    write_dat(path, vol)
    return path, vol


@pytest.mark.parametrize("scenario", ["1", "2", "3"])
def test_demo_nd_runs_scenarios_1_to_3(scenario, dat_volume, tmp_path, capsys):
    path, vol = dat_volume
    out = tmp_path / "o.dat"
    assert demo.main([path, "--nd", "6", "--nr", "16", "--nc", "12", "--scenario", scenario,
                      "--wavelet", "db2", "--levels", "2", "--swt", "--device", "cpu",
                      "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "Data dimensions : (6, 16, 12)" in text
    got = np.fromfile(out, np.float32)
    if scenario == "1":
        assert got.size == vol.size  # the SWT approximation keeps the volume's size
    else:
        err = np.abs(got.reshape(vol.shape) - vol).max()
        assert err < 1e-3 if scenario == "2" else err > 1e-3


@pytest.mark.parametrize("scenario", ["4", "6"])
def test_demo_nd_refuses_scenarios_4_and_6(scenario, dat_volume, capsys):
    """The 2D-only denoisers refuse a volume with JAX's message."""
    args = [dat_volume[0], "--nd", "6", "--nr", "16", "--nc", "12", "--scenario", scenario]
    errs = []
    for main, extra in ((demo.main, ["--device", "cpu"]), (jdemo.main, [])):
        with pytest.raises(SystemExit) as err:
            main(args + extra)
        assert err.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1] and "needs the 2D" in errs[0]


def test_demo_nd_runs_scenario_5(dat_volume, tmp_path, capsys):
    """The starlet denoise of a volume (ndim=3), JAX's lines and result."""
    path, vol = dat_volume
    args = [path, "--nd", "6", "--nr", "16", "--nc", "12", "--scenario", "5", "--levels", "2"]
    assert demo.main(args + ["--device", "cpu", "--out", str(tmp_path / "p.dat")]) == 0
    mine = capsys.readouterr().out
    assert jdemo.main(args + ["--out", str(tmp_path / "j.dat")]) == 0
    theirs = capsys.readouterr().out
    assert mine.splitlines()[0] == theirs.splitlines()[0] == (
        "starlet k-sigma auto denoise applied (2 isotropic scales)")
    got, want = (np.fromfile(tmp_path / f, np.float32) for f in ("p.dat", "j.dat"))
    assert got.shape == want.shape == (vol.size,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_demo_nd_runs_as_a_module(dat_volume, tmp_path):
    path, vol = dat_volume
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "pdwt_tpu_torch.demo", path, "--nd", "6",
                           "--nr", "16", "--nc", "12", "--scenario", "2", "--wavelet", "db4",
                           "--levels", "1", "--device", "cpu", "--out", str(tmp_path / "m.dat")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = np.fromfile(tmp_path / "m.dat", np.float32).reshape(vol.shape)
    assert np.abs(got - vol).max() < 1e-3
