"""The port's ``Wavelets`` facade and ``denoise_step`` against the JAX
package's, plus the port's import hygiene.

Images come from ``default_rng``.  Tolerances, relative to max|ref|:
4e-6 for coefficients and images in float32 (the same taps in the same
order; either side may contract a multiply-add), 1e-5 for the norms,
which sum thousands of float32 terms in another order.
"""
import os
import re
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from pdwt_tpu import Wavelets as JWavelets
from pdwt_tpu.filters import make_custom_wavelet as jmake_custom_wavelet
from pdwt_tpu.models.denoiser import denoise_step as jdenoise_step
from pdwt_tpu_torch import Wavelets, dwt2d, get_wavelet
from pdwt_tpu_torch.models import denoise_step
from pdwt_tpu_torch.ops import circshift2d, norm1, soft_threshold
from pdwt_tpu_torch.utils import coeffs2d_to_numpy, wavelet_from_arrays

RTOL, NORM_RTOL = 4e-6, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(c):
    a, dets = coeffs2d_to_numpy(c)
    return [a, *[t for band in dets for t in band]]


def _close(got, want, rtol=RTOL):
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        err = float(np.abs(g - w).max())
        assert err <= rtol * float(np.abs(w).max()), err


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


@pytest.mark.parametrize("wname,shape,levels,beta", [("db7", (120, 136), 3, 10.0),
                                                     ("haar", (45, 51), 3, 20.0),
                                                     ("bior4.4", (37, 41), 2, 5.0)])
def test_facade_matches_jax(wname, shape, levels, beta):
    """forward, soft_threshold, norm1, norm2sq, inverse.  haar runs the
    separable kernels' plain versions here, the butterfly path in JAX."""
    img = _img(shape)
    W, J = Wavelets(img, wname=wname, levels=levels), JWavelets(img, wname=wname,
                                                                levels=levels, backend="fma")
    assert W.spec.nlevels == J.spec.nlevels == levels
    _close(_leaves(W.forward()), _leaves(J.forward()))
    assert np.isclose(W.norm2sq(), J.norm2sq(), rtol=NORM_RTOL, atol=0)
    W.soft_threshold(beta)
    J.soft_threshold(beta)
    _close(_leaves(W.coeffs), _leaves(J.coeffs))
    assert np.isclose(W.norm1(), J.norm1(), rtol=NORM_RTOL, atol=0)
    _close(W.inverse(), J.inverse())
    _close(W.get_image(), J.get_image())


def test_cycle_spinning_matches_jax():
    """The same seed draws the same shifts from numpy's default_rng."""
    img = _img((40, 56), seed=1)
    W = Wavelets(img, wname="db3", levels=2, do_cycle_spinning=True, seed=7)
    J = JWavelets(img, wname="db3", levels=2, do_cycle_spinning=True, seed=7, backend="fma")
    for _ in range(3):
        _close(_leaves(W.forward()), _leaves(J.forward()))
        assert (W.current_shift_r, W.current_shift_c) == (J.current_shift_r,
                                                          J.current_shift_c)
        W.soft_threshold(8.0)
        J.soft_threshold(8.0)
        _close(W.inverse(), J.inverse())


@pytest.mark.parametrize("beta", [12.0, [30.0, 20.0, 10.0], [[30.0, 25.0, 20.0]] * 3])
def test_hard_threshold_options_match_jax(beta):
    img = _img((122, 128), seed=2)
    W = Wavelets(img, wname="sym8", levels=3)
    J = JWavelets(img, wname="sym8", levels=3, backend="fma")
    W.forward()
    J.forward()
    W.hard_threshold(beta, do_thresh_appcoeffs=True, normalize=True)
    J.hard_threshold(beta, do_thresh_appcoeffs=True, normalize=True)
    _close(_leaves(W.coeffs), _leaves(J.coeffs))
    W.soft_threshold(beta, normalize=True)
    J.soft_threshold(beta, normalize=True)
    _close(_leaves(W.coeffs), _leaves(J.coeffs))


@pytest.mark.parametrize("shape,levels", [((40, 40), 10), ((5, 9), 3), ((32, 32), 0)])
def test_level_clamping_matches_jax(shape, levels):
    with warnings.catch_warnings(record=True) as ours:
        warnings.simplefilter("always")
        W = Wavelets(nr=shape[0], nc=shape[1], wname="db7", levels=levels)
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        J = JWavelets(nr=shape[0], nc=shape[1], wname="db7", levels=levels)
    assert W.spec.nlevels == J.spec.nlevels
    assert [str(w.message) for w in ours] == [str(w.message) for w in theirs]
    assert tuple(W.coeffs.approx.shape) == J.coeffs.approx.shape


def test_get_set_image_and_state():
    img = _img((32, 32))
    W = Wavelets(img, wname="db2", levels=2)
    W.set_image(img[::-1].copy())
    np.testing.assert_array_equal(W.get_image(), img[::-1])
    assert W.get_image(copy=False).device == W.device
    W.forward()
    W.inverse()
    with pytest.warns(UserWarning, match="cannot threshold"):
        W.soft_threshold(1.0)
    with pytest.warns(UserWarning, match="already been run"):
        assert W.inverse() is W.d_image
    _close(W.get_image(), img[::-1])


def test_facade_never_moves_data_between_devices():
    img = torch.from_numpy(_img((16, 16)))
    with pytest.raises(ValueError, match="move it first"):
        Wavelets(img, wname="db2", levels=1, device="meta")
    W = Wavelets(img, wname="db2", levels=1, device="cpu")
    assert W.device.type == "cpu"
    with pytest.raises(ValueError, match="move it first"):
        W.set_image(torch.zeros(16, 16, device="meta"))


@pytest.mark.parametrize("mode,normalize", [("soft", False), ("hard", True)])
def test_denoise_step_matches_jax(mode, normalize):
    img = _img((50, 64), seed=3)
    jw_out, jw_n1 = jax.jit(lambda x: jdenoise_step(x, None, "db4", 3, 15.0, mode=mode,
                                                    normalize=normalize, backend="fma",
                                                    boundary="periodization"))(img)
    out, n1 = denoise_step(torch.from_numpy(img), None, "db4", 3, 15.0, mode=mode,
                           normalize=normalize)
    _close(out, jw_out)
    assert np.isclose(float(n1), float(jw_n1), rtol=NORM_RTOL, atol=0)


def test_denoise_step_cycle_spins_with_the_generator():
    """Shifts come from the generator (row, then column); the step is the
    unshifted roundtrip of the shifted image."""
    img = torch.from_numpy(_img((24, 40), seed=4))
    w = get_wavelet("db2")
    out, n1 = denoise_step(img, torch.Generator().manual_seed(11), w, 2, 9.0)
    g = torch.Generator().manual_seed(11)
    sr = int(torch.randint(0, 24, (), generator=g))
    sc = int(torch.randint(0, 40, (), generator=g))
    ref, ref_n1 = denoise_step(circshift2d(img, sr, sc), None, w, 2, 9.0)
    assert torch.equal(out, circshift2d(ref, -sr, -sc))
    assert float(n1) == float(ref_n1)
    assert float(n1) == float(norm1(soft_threshold(dwt2d(circshift2d(img, sr, sc), w, 2),
                                                   9.0)))


def test_unsupported_flags_name_their_roadmap_item():
    img = _img((16, 16))
    for kwargs, item in [({"do_swt": True}, 6), ({"do_separable": False}, 11),
                         ({"ndim": 1}, 7), ({"ndim": 3}, 12), ({"mode": "symmetric"}, 10),
                         ({"precision": "mixed"}, 9), ({"precision": "bf16-fast"}, 9)]:
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            Wavelets(img, wname="db2", levels=1, **kwargs)
    with pytest.raises(NotImplementedError, match="item 7"):
        Wavelets(img[0], wname="db2", levels=1)
    with pytest.raises(NotImplementedError, match="item 12"):
        Wavelets(np.zeros((4, 16, 16), np.float32), wname="db2", levels=1)
    with pytest.raises(ValueError, match="unknown precision tier"):
        Wavelets(img, wname="db2", levels=1, precision="fast")
    x = torch.from_numpy(img)
    with pytest.raises(NotImplementedError, match="item 6"):
        denoise_step(x, None, "db2", 1, 1.0, swt=True)
    with pytest.raises(NotImplementedError, match="item 4"):
        denoise_step(x, None, "db2", 1, 1.0, mode="garrote")
    with pytest.raises(NotImplementedError, match="item 10"):
        denoise_step(x, None, "db2", 1, 1.0, boundary="symmetric")


def test_wavelet_from_arrays_carries_a_jax_bank():
    f = np.random.default_rng(6).standard_normal((4, 6))
    jw = jmake_custom_wavelet("Mine", *f)
    w = wavelet_from_arrays(jw)
    assert w.name == jw.name == "mine"
    for name in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        np.testing.assert_array_equal(getattr(w, name), getattr(jw, name))
    assert wavelet_from_arrays("Mine", *f) == w
    with pytest.raises(ValueError, match="all four filters"):
        wavelet_from_arrays("mine", f[0])


def test_import_needs_no_jax_and_builds_nothing():
    code = (
        "import os, sys\n"
        "import pdwt_tpu_torch\n"
        "from pdwt_tpu_torch.kernels import _build\n"
        "before = set(os.listdir(_build.BUILD_DIR)) if os.path.isdir(_build.BUILD_DIR) else set()\n"
        "import numpy as np, torch\n"
        "w = pdwt_tpu_torch.get_wavelet('db7')\n"
        "x = torch.rand(2, 40, 40)\n"
        "y = pdwt_tpu_torch.idwt2d(pdwt_tpu_torch.dwt2d(x, w, 2), w, (40, 40))\n"
        "assert float((y - x).abs().max()) < 1e-4\n"
        "after = set(os.listdir(_build.BUILD_DIR)) if os.path.isdir(_build.BUILD_DIR) else set()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pdwt_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert _build.load.cache_info().currsize == 0 and before == after\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_package_source_imports_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|pdwt_tpu)(\.|\s|$)", re.M)
    root = os.path.join(REPO, "pdwt_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]
    assert len(files) >= 15
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path
