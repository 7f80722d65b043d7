"""``backend=`` and ``pad_fn=`` as JAX resolves them: the six cases of
``tests/test_backend_select.py`` ported (the override reaching the
transforms, the environment variable, the ``"pallas"`` override, unknown
names, the explicit keyword winning, the bf16 and ``mixed`` kernel
routes), the ``"pallas"`` errors and ``pad_fn`` leaving the kernel route,
then every core transform, model, facade and pywt drop-in under each conv
formulation against JAX's under the same one (float64, 1e-10 of the
largest output), and a float32 gradient through the "xla" and "gather"
passes against ``jax.grad``."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdwt_tpu
import pdwt_tpu.core as jcore
import pdwt_tpu.models as jmodels
import pdwt_tpu.utils.interop as jpywt
import pdwt_tpu_torch as P
from pdwt_tpu_torch import kernels
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.core import separable as sep
from pdwt_tpu_torch.filters import get_wavelet
from pdwt_tpu_torch.utils import interop as pywt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ("fma", "xla", "gather")


@pytest.fixture(autouse=True)
def _restore_default_backend():
    prev = conv._default_backend
    yield
    conv.set_default_backend(prev)


# ---------------------------------------------------------------------------
# the six cases of tests/test_backend_select.py
# ---------------------------------------------------------------------------

def test_default_backend_override_reaches_transforms(monkeypatch):
    calls = []
    orig = conv.analysis_pass

    def spy(*a, **k):
        calls.append(k.get("backend"))
        return orig(*a, **k)

    monkeypatch.setattr(conv, "analysis_pass", spy)
    conv.set_default_backend("gather")
    w = get_wavelet("db2")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 16)))
    sep.dwt2d(x, w, 1)  # backend=None resolves to the override
    assert calls and all(b == "gather" for b in calls)


def test_env_var_seeds_default_backend():
    conv.set_default_backend("fma")
    assert sep.auto_backend(None, None) == "fma"
    conv.set_default_backend(None)
    code = ("from pdwt_tpu_torch.core import conv, separable as s\n"
            "assert conv.get_default_backend() == 'xla'\n"
            "assert s.auto_backend(None, None) == 'xla'\n"
            "print('ok')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PDWT_TPU_BACKEND"] = "xla"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_pallas_override_accepted_and_mapped():
    conv.set_default_backend("pallas")
    assert sep.auto_backend(None, None) == "pallas"
    assert conv.get_default_backend() in BACKENDS
    assert sep.auto_backend(None, object()) is None


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        conv.set_default_backend("cuda")


def test_explicit_kwarg_beats_override():
    conv.set_default_backend("gather")
    assert sep.auto_backend("fma", None) == "fma"


def test_mxu_modes_on_the_kernel_route():
    """bf16 and ``mixed`` on ``backend="pallas"`` (the kernels' plain
    versions here): the dtype contract and the error against "gather"."""
    w = get_wavelet("db7")
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (128, 128))).float()
    cg = sep.dwt2d(x, w, 1, backend="gather")
    leaves = lambda c: [c.approx] + list(c.details[0])
    peak = float(cg.approx.abs().max())
    cb = sep.dwt2d(x.bfloat16(), w, 1, backend="pallas")
    assert cb.approx.dtype == torch.float32 and cb.details[0][0].dtype == torch.bfloat16
    rel = max(float((a.float() - b).abs().max()) for a, b in zip(leaves(cb), leaves(cg)))
    assert rel / peak < 1e-2
    yb = sep.idwt2d(cb, w, (128, 128), backend="pallas")
    assert yb.dtype == torch.bfloat16 and float((yb.float() - x).abs().max()) < 3.0
    with P.precision_scope("mixed"):
        cm = sep.dwt2d(x, w, 1, backend="pallas")
        ym = sep.idwt2d(cm, w, (128, 128), backend="pallas")
    assert cm.approx.dtype == torch.float32
    rel = max(float((a - b).abs().max()) for a, b in zip(leaves(cm), leaves(cg)))
    assert rel / peak < 1e-4 and float((ym - x).abs().max()) < 1e-2 * 255


# ---------------------------------------------------------------------------
# the "pallas" errors and pad_fn
# ---------------------------------------------------------------------------

def test_pallas_errors_match_jax():
    w, jw = get_wavelet("db2"), pdwt_tpu.get_wavelet("db2")
    x = np.random.default_rng(2).standard_normal((8, 8))
    pad = lambda t, axis, lo, hi: t
    for fn, arr, ww in ((sep.dwt2d, torch.from_numpy(x), w),
                        (jcore.dwt2d, jnp.asarray(x), jw)):
        with pytest.raises(ValueError, match="does not support pad_fn"):
            fn(arr, ww, 1, backend="pallas", pad_fn=pad)
        with pytest.raises(ValueError, match="mode='periodization' only"):
            fn(arr, ww, 1, backend="pallas", mode="symmetric")
    with pytest.raises(ValueError, match="does not support pad_fn"):
        sep.swt1d(torch.from_numpy(x), w, 1, backend="pallas", pad_fn=pad)


def test_pad_fn_takes_the_conv_passes(monkeypatch):
    """With ``backend=None`` a ``pad_fn`` runs the conv passes (no kernel
    wrapper is called), its pad in place of the wrap: the periodic pad
    gives the kernel route's values."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper ran")

    w = get_wavelet("sym4")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 12, 20)))
    want = sep.dwt2d(x, w, 2)
    wi = sep.idwt2d(want, w, (12, 20))
    for name in ("fwd_level_2d_ad", "fwd_tail_2d_ad", "inv_level_2d_ad", "inv_tail_2d_ad"):
        monkeypatch.setattr(kernels, name, refuse)
    seen = []

    def pad(t, axis, lo, hi):
        seen.append((axis, lo, hi))
        return conv.wrap_pad(t, axis, lo, hi)

    got = sep.dwt2d(x, w, 2, pad_fn=pad)
    assert seen
    for a, b in zip([got.approx, *got.details[0], *got.details[1]],
                    [want.approx, *want.details[0], *want.details[1]]):
        assert float((a - b).abs().max()) < 1e-12
    assert float((sep.idwt2d(got, w, (12, 20), pad_fn=pad) - wi).abs().max()) < 1e-12


# ---------------------------------------------------------------------------
# every entry point under each conv formulation against JAX's
# ---------------------------------------------------------------------------

def _np(t):
    if isinstance(t, torch.Tensor):
        return (t.resolve_conj() if t.is_complex() else t).detach().numpy()
    return np.asarray(t)


def _leaves(tree):
    if isinstance(tree, (torch.Tensor, np.ndarray, jax.Array)):
        return [_np(tree)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if hasattr(tree, "_fields"):
        return [leaf for t in tree for leaf in _leaves(t)]
    if hasattr(tree, "nodes"):
        return _leaves(tree.nodes)
    return [np.asarray(tree)]


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape)


X2, X1, X3 = _img((16, 20), 1), _img((3, 40), 2), _img((8, 12, 16), 3)
Q = np.random.default_rng(4).standard_normal((4, 4, 4))
T = torch.from_numpy


def _wav(jax_side, name="db2"):
    return pdwt_tpu.get_wavelet(name) if jax_side else get_wavelet(name)


def _core_2d(be, j, x, x1, v):
    lib, w = (jcore, _wav(1)) if j else (P.core, _wav(0))
    c = lib.dwt2d(x, w, 2, backend=be)
    s = lib.swt2d(x, w, 2, backend=be)
    return [c, lib.idwt2d(c, w, (16, 20), backend=be), s, lib.iswt2d(s, w, backend=be),
            lib.iswt2d_denoise(s, w, 30.0, backend=be),
            lib.dwt2d(x, w, 2, backend=be, mode="symmetric")]


def _core_1d(be, j, x2, x, v):
    lib, w = (jcore, _wav(1, "sym4")) if j else (P.core, _wav(0, "sym4"))
    c = lib.dwt1d(x, w, 2, backend=be)
    s = lib.swt1d(x, w, 2, backend=be)
    return [c, lib.idwt1d(c, w, 40, backend=be), s, lib.iswt1d(s, w, backend=be)]


def _core_3d(be, j, x2, x1, x):
    lib, w = (jcore, _wav(1)) if j else (P.core, _wav(0))
    c = lib.dwt3d(x, w, 1, backend=be)
    s = lib.swt3d(x, w, 1, backend=be)
    return [c, lib.idwt3d(c, w, X3.shape, backend=be), s, lib.iswt3d(s, w, backend=be),
            lib.iswt3d_denoise(s, w, 30.0, backend=be)]


def _core_ns(be, j, x, x1, v):
    lib = jcore if j else P.core
    c = lib.dwt2d_ns(x, Q, 1, backend=be)
    s = lib.swt2d_ns(x, Q, 1, backend=be)
    return [c, lib.idwt2d_ns(c, Q, (16, 20), backend=be), s, lib.iswt2d_ns(s, Q, backend=be)]


def _core_packets(be, j, x2, x1, x3):
    lib, w = (jcore, _wav(1)) if j else (P.core, _wav(0))
    p2 = lib.wp2d(x2, w, 2, backend=be)
    leaves = ((1, 0), (1, 1), (2, 8), (2, 9), (2, 10), (2, 11), (1, 3))
    return [p2, lib.iwp2d(p2.nodes[-1], w, (16, 20), backend=be),
            lib.wp_reconstruct(p2, leaves, w, backend=be),
            lib.iwp1d(lib.wp1d(x1, w, 2, backend=be).nodes[-1], w, 40, backend=be),
            lib.iwp3d(lib.wp3d(x3, w, 1, backend=be).nodes[-1], w, X3.shape, backend=be)]


def _core_starlet_dt(be, j, x2, x1, v):
    lib, x = (jcore if j else P.core), x2[:, :16]
    c = lib.starlet(x, 2, backend=be)
    d = lib.dtcwt2d(x, 2, backend=be)
    d1 = lib.dtcwt1d(x[0], 2, backend=be)
    return [c, lib.istarlet(c, backend=be), lib.starlet_denoise(x, 2, 5.0, backend=be),
            d, lib.idtcwt2d(d, (16, 16), backend=be), d1, lib.idtcwt1d(d1, 16, backend=be),
            lib.dtcwt_denoise(x, 2, 5.0, backend=be)]


def _core_fs(be, j, x, x1, v):
    lib, w = (jcore, _wav(1)) if j else (P.core, _wav(0))
    y = lib.fs_dwt(x, w, (1, 2), backend=be)
    return [y, lib.fs_idwt(y, w, (16, 20), (1, 2), backend=be)]


def _models(be, j, x, x1, v):
    lib = jmodels if j else P.models
    out = [lib.denoise_step(x, None, "db2", 2, 30.0, backend=be),
           lib.denoise_step(x, None, "db2", 2, 30.0, swt=True, backend=be),
           lib.auto_denoise(x, "db2", 2, backend=be),
           lib.auto_denoise(x, "db2", 2, swt=True, method="universal", backend=be),
           lib.denoise_step_3d(v, None, "db2", 1, 30.0, backend=be),
           lib.denoise_step_3d(v, None, "db2", 1, 30.0, swt=True, backend=be),
           lib.auto_denoise_3d(v, "db2", 1, backend=be),
           lib.starlet_auto_denoise(x[:, :16], 2, backend=be),
           lib.ista(x, wav="db2", levels=2, lam=5.0, iters=3, backend=be)]
    return out


def _facades(be, j, x2, x1, v):
    """The facades (JAX's jit inside) and the packet denoise (its best
    basis needs concrete coefficients), run eagerly."""
    kw = {} if j else {"device": "cpu"}
    lib, x = (pdwt_tpu, X2) if j else (P, X2.copy())
    f64 = np.float64 if j else torch.float64
    out = [(jmodels if j else P.models).packet_denoise(x2, "db2", 2, backend=be)]
    W = lib.Wavelets(x, wname="db2", levels=2, dtype=f64, backend=be, **kw)
    W.forward()
    W.soft_threshold(20.0)
    out += [W.coeffs, W.inverse()]
    W = lib.Wavelets(x, wname="db2", levels=2, do_swt=True, dtype=f64, backend=be, **kw)
    out.append(W.run_denoise(20.0))
    WP = lib.WaveletPackets(x, wname="db2", levels=2, backend=be, **kw)
    WP.forward()
    WP.best_basis()
    out.append(WP.reconstruct(beta=20.0))
    S = lib.Starlet(x[:, :16], levels=2, backend=be, **kw)
    out += [S.forward(), S.inverse(), S.denoise()]
    D = lib.DualTree(x[:, :16], levels=2, backend=be, **kw)
    out += [D.forward(), D.inverse(), D.denoise()]  # denoise(): core.dtcwt_auto_denoise
    return out


def _drop_ins(be, j, x2, x1, x3):
    lib = jpywt if j else pywt
    kw = {"backend": be}
    c1 = lib.wavedec(x1, "db2", level=2, **kw)
    c2 = lib.wavedec2(x2, "db2", level=2, **kw)
    c3 = lib.wavedecn(x3, "db2", level=1, **kw)
    d1, d2 = lib.dwt(x1, "db2", **kw), lib.dwt2(x2, "db2", **kw)
    s1, s2 = lib.swt(x1, "db2", 2, **kw), lib.swt2(x2, "db2", 2, **kw)
    return [c1, lib.waverec(c1, "db2", **kw), c2, lib.waverec2(c2, "db2", **kw), c3,
            lib.waverecn(c3, "db2", **kw), d1, lib.idwt(*d1, "db2", **kw), d2,
            lib.idwt2(d2, "db2", **kw), s1, lib.iswt(s1, "db2", **kw), s2,
            lib.iswt2(s2, "db2", **kw)]


GROUPS = {"core_2d": _core_2d, "core_1d": _core_1d, "core_3d": _core_3d, "core_ns": _core_ns,
          "core_packets": _core_packets, "core_starlet_dualtree": _core_starlet_dt,
          "core_fs": _core_fs, "models": _models, "facades": _facades,
          "drop_ins": _drop_ins}


#: the groups JAX runs eagerly (stateful or data-dependent); the others jitted
EAGER = {"facades"}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("group", list(GROUPS))
def test_entry_points_match_jax_under_each_backend(group, backend):
    fn = GROUPS[group]
    xs = (X2, X1, X3)
    got = _leaves(fn(backend, False, *(T(x.copy()) for x in xs)))
    jfn = (lambda *a: fn(backend, True, *a))
    if group not in EAGER:
        jfn = jax.jit(jfn)
    want = _leaves(jfn(*(jnp.asarray(x) for x in xs)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        peak = float(np.abs(w).max()) or 1.0
        assert float(np.abs(g - w).max()) <= 1e-10 * peak


@pytest.mark.parametrize("backend", ["xla", "gather"])
def test_float32_gradient_through_the_passes_matches_jax(backend):
    w, jw = get_wavelet("sym4"), pdwt_tpu.get_wavelet("sym4")
    x = np.random.default_rng(6).standard_normal((12, 16)).astype(np.float32)
    ct = np.random.default_rng(7).standard_normal((12, 16)).astype(np.float32)

    def jloss(t):
        c = jcore.dwt2d(t, jw, 2, backend=backend)
        y = jcore.idwt2d(pdwt_tpu.ops.soft_threshold(c, 0.3), jw, (12, 16), backend=backend)
        return jnp.sum(y * ct)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    xt = T(x).requires_grad_(True)
    c = P.ops.soft_threshold(sep.dwt2d(xt, w, 2, backend=backend), 0.3)
    (got,) = torch.autograd.grad((sep.idwt2d(c, w, (12, 16), backend=backend) * T(ct)).sum(),
                                 xt)
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())
