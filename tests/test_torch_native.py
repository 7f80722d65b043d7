"""The port's binding of the C++ engine (``pdwt_tpu_torch.native``) against
the JAX package's (``pdwt_tpu.native``): the nine cases of
``tests/test_native.py``.  Both call the same C engine, built from the same
source with the same flags, on the same inputs, so the results are equal
bit for bit.  Then the port's own float64 transforms against the engine
within 1e-10, the CUDA-tensor refusal, and the hash-named build raced by
two processes at once."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pdwt_tpu import native as jnative
from pdwt_tpu.native import lib as jlib
from pdwt_tpu_torch import core, native
from pdwt_tpu_torch.filters import get_wavelet, quad_filters
from pdwt_tpu_torch.native import lib
from pdwt_tpu_torch.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(not native.is_available(), reason="no C++ compiler")


@pytest.fixture
def f64():
    lib.set_dtype(np.float64)
    jlib.set_dtype(np.float64)
    try:
        yield
    finally:
        lib.set_dtype(np.float32)
        jlib.set_dtype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(mine, theirs):
    a, b = jax.tree.leaves(mine), jax.tree.leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("wname", ["haar", "db7", "bior4.4"])
@pytest.mark.parametrize("shape", [(64, 64), (67, 93)])
def test_native_2d_matches_jax(wname, shape):
    w = get_wavelet(wname)
    x = _rng(1).standard_normal(shape).astype(np.float32)
    cn = native.dwt2d(x, w, 2)
    _same(cn, jnative.dwt2d(x, w, 2))
    yn = native.idwt2d(cn, w, shape)
    _same(yn, jnative.idwt2d(jnative.dwt2d(x, w, 2), w, shape))
    assert float(np.abs(yn.numpy() - x).max()) < 1e-5


@pytest.mark.parametrize("wname", ["db3", "sym8"])
def test_native_swt_matches_jax(wname):
    w = get_wavelet(wname)
    x = _rng(2).standard_normal((48, 80)).astype(np.float32)
    cn = native.dwt2d(x, w, 3, swt=True)
    _same(cn, jnative.dwt2d(x, w, 3, swt=True))
    _same(native.idwt2d(cn, w, (48, 80), swt=True),
          jnative.idwt2d(jnative.dwt2d(x, w, 3, swt=True), w, (48, 80), swt=True))


@pytest.mark.parametrize("swt", [False, True])
def test_native_1d_matches_jax(swt):
    w = get_wavelet("sym8")
    x = _rng(3).standard_normal((4, 255)).astype(np.float32)
    cn = native.dwt1d(torch.from_numpy(x), w, 2, swt=swt)
    _same(cn, jnative.dwt1d(x, w, 2, swt=swt))
    yn = native.idwt1d(cn, w, 255, swt=swt)
    _same(yn, jnative.idwt1d(jnative.dwt1d(x, w, 2, swt=swt), w, 255, swt=swt))
    assert float(np.abs(yn.numpy() - x).max()) < 1e-5


def test_native_ops():
    x = _rng(4).standard_normal(1000).astype(np.float32)
    _same(native.soft_threshold(x, 0.5), jnative.soft_threshold(x, 0.5))
    assert native.norm1(x) == jnative.norm1(x)
    assert native.norm2sq(torch.from_numpy(x)) == jnative.norm2sq(x)


def test_native_nonseparable_matches_jax():
    w = get_wavelet("db4")
    qf, qi = quad_filters(w.dec_lo, w.dec_hi), quad_filters(w.rec_lo, w.rec_hi)
    x = _rng(5).standard_normal((47, 61)).astype(np.float32)
    for swt in (False, True):
        cn = native.dwt2d_ns(x, qf, 2, swt=swt)
        _same(cn, jnative.dwt2d_ns(x, qf, 2, swt=swt))
        y = native.idwt2d_ns(cn, qi, (47, 61), swt=swt)
        _same(y, jnative.idwt2d_ns(jnative.dwt2d_ns(x, qf, 2, swt=swt), qi, (47, 61), swt=swt))
        assert float(np.abs(y.numpy() - x).max()) < 1e-5


def test_native_extra_ops():
    h, v, d = _rng(6).standard_normal((3, 256)).astype(np.float32)
    _same(native.group_soft_threshold(h, v, d, 0.5), jnative.group_soft_threshold(h, v, d, 0.5))
    _same(native.group_soft_threshold(h, v, d, 0.5, a=v),
          jnative.group_soft_threshold(h, v, d, 0.5, a=v))
    _same(native.shrink(h, 2.0), jnative.shrink(h, 2.0))
    _same(native.axpy(h, v, 1.5), jnative.axpy(h, v, 1.5))
    assert native.norm_l21(h, v, d) == jnative.norm_l21(h, v, d)
    assert native.norm_l21(h, v, d, a=h) == jnative.norm_l21(h, v, d, a=h)


def test_native_double_precision_build(f64):
    w = get_wavelet("db7")
    x = _rng(7).standard_normal((96, 96))
    c = native.dwt2d(x, w, 3)
    assert c.approx.dtype == torch.float64
    _same(c, jnative.dwt2d(x, w, 3))
    y = native.idwt2d(c, w, (96, 96))
    assert float(np.abs(y.numpy() - x).max()) < 1e-10


def test_native_3d_matches_jax(f64):
    w = get_wavelet("db4")
    x = _rng(8).standard_normal((15, 21, 33))
    for swt in (False, True):
        cn = native.dwt3d(x, w, 2, swt=swt)
        _same(cn, jlib.dwt3d(x, w, 2, swt=swt))
        y = native.idwt3d(cn, w, (15, 21, 33), swt=swt)
        assert float(np.abs(y.numpy() - x).max()) < 1e-10


def test_native_garrote_and_firm_match_jax(f64):
    x = _rng(3).standard_normal(1000) * 3
    _same(native.garrote_threshold(x, 1.2), jnative.garrote_threshold(x, 1.2))
    _same(native.firm_threshold(x, 0.8, 2.4), jnative.firm_threshold(x, 0.8, 2.4))


# ---------------------------------------------------------------------------
# the port's own transforms, the refusal, the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dwt2d", "swt2d", "dwt1d", "swt1d", "dwt3d", "swt3d"])
def test_port_float64_transforms_match_the_engine(kind, f64):
    w = get_wavelet("sym4")
    shape = {"2": (23, 30), "1": (3, 41), "3": (9, 10, 13)}[kind[3]]
    x = _rng(9).standard_normal(shape)
    swt = kind.startswith("swt")
    want = getattr(native, "dwt" + kind[3:])(x, w, 2, swt=swt)
    got = getattr(core, kind)(torch.from_numpy(x), w, 2)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert float((a - b).abs().max()) < 1e-10


def test_a_card_tensor_is_refused():
    x = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match=r"\.cpu\(\)"):
        native.dwt2d(x, get_wavelet("db2"), 1)
    with pytest.raises(ValueError, match=r"\.cpu\(\)"):
        native.norm1(torch.empty(3, device="meta"))


def test_hash_named_build_under_two_processes(tmp_path):
    """Two processes build the same library into one empty directory at
    once: each compiles into a file of its own and renames it into place,
    so both load a whole library and leave exactly one file."""
    code = ("import numpy as np, sys\n"
            "from pdwt_tpu_torch.utils import enable_compile_cache\n"
            "from pdwt_tpu_torch import native\n"
            "from pdwt_tpu_torch.filters import get_wavelet\n"
            "enable_compile_cache(sys.argv[1], min_compile_secs=0.0)\n"
            "c = native.dwt2d(np.ones((8, 8), np.float32), get_wavelet('db2'), 1)\n"
            "print(native.lib.library_path(), float(c.approx.sum()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    lines = [o[0].split() for o in outs]
    assert lines[0] == lines[1]
    assert os.listdir(tmp_path) == [os.path.basename(lines[0][0])]
    assert os.path.dirname(lines[0][0]) == str(tmp_path)
    assert cache.build_dir() != str(tmp_path)  # this process's setting did not move


@pytest.mark.parametrize("scenario", [1, 3])
def test_demo_native_matches_jax_demo(scenario, tmp_path, capsys):
    """``demo.py --native`` runs the engine as JAX's demo does: the same
    lines and the same output file, bit for bit."""
    from pdwt_tpu import demo as jdemo
    from pdwt_tpu_torch import demo

    img = _rng(10).uniform(0, 255, (40, 36)).astype(np.float32)
    path = tmp_path / "img.dat"
    img.tofile(path)
    out = {}
    for name, main in (("p", demo.main), ("j", jdemo.main)):
        assert main([str(path), "--nr", "40", "--nc", "36", "--native", "--scenario",
                     str(scenario), "--wavelet", "db3", "--levels", "2", "--beta", "20",
                     "--out", str(tmp_path / f"{name}.dat")]) == 0
        out[name] = capsys.readouterr().out.replace(f"{name}.dat", "x.dat")
    assert out["p"] == out["j"]
    got, want = (np.fromfile(tmp_path / f"{n}.dat", np.float32) for n in ("p", "j"))
    assert np.array_equal(got, want)
