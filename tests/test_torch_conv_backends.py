"""The port's conv passes in JAX's three formulations (``core/conv.py``,
``backend="fma" | "xla" | "gather"``) against JAX's passes in the same
formulation, on the same inputs made with numpy from a seed: decimated,
a-trous with a dilation, every pywt mode and a custom ``pad_fn``, both
passes and both axes.  float32 within 1e-5 of the largest output, float64
within 1e-12, bfloat16 within one bf16 ulp of the largest output (XLA's
CPU keeps excess precision in bf16 arithmetic)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu.core import conv as jconv
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.core.modes import MODES
from pdwt_tpu_torch.filters import get_wavelet

BACKENDS = ("fma", "xla", "gather")
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "float64": (np.float64, torch.float64, jnp.float64),
          "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16)}
WAVS = ("db2", "sym4", "bior3.1", "db7")


def _edge_pad_torch(x, axis, lo, hi):
    ax = axis % x.ndim
    n = x.shape[ax]
    parts = [x.narrow(ax, 0, 1)] * lo + [x] + [x.narrow(ax, n - 1, 1)] * hi
    return torch.cat(parts, dim=ax)


def _edge_pad_jax(x, axis, lo, hi):
    ax = axis % x.ndim
    n = x.shape[ax]
    first = jnp.take(x, jnp.arange(0, 1), axis=ax)
    last = jnp.take(x, jnp.arange(n - 1, n), axis=ax)
    return jnp.concatenate([first] * lo + [x] + [last] * hi, axis=ax)


def _inputs(dtype, shape, seed):
    npd, td, jd = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal(shape).astype(npd)
    return torch.from_numpy(x).to(td), jnp.asarray(x).astype(jd)


def _f64(t):
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64).numpy()
    return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t, np.float64)


def _close(got, want, dtype):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max()) or 1.0
    if dtype == "bfloat16":
        tol = 2.0 ** (np.floor(np.log2(peak)) - 7)
    else:
        tol = (1e-5 if dtype == "float32" else 1e-12) * peak
    assert float(np.abs(got - want).max()) <= tol


SHAPES = ((9, 14), (16, 11), (7, 21), (20, 20))
#: every formulation on the periodic passes; the pywt modes in turn
KINDS = [(k, be) for be in BACKENDS for k in ("decimated", "atrous2", "atrous4", "pad_fn")] + [
    (f"mode:{m}", BACKENDS[i % 3]) for i, m in enumerate(m for m in MODES
                                                         if m != "periodization")]
CASES = [(k, be, WAVS[i % 4], SHAPES[i % 4], (-1, -2)[i % 2]) for i, (k, be) in enumerate(KINDS)]


def _kw(kind, jax_side):
    if kind == "decimated":
        return {}, {}
    if kind.startswith("atrous"):
        f = int(kind[len("atrous"):])
        return {"decimate": False, "dilation": f}, {"decimated": False, "dilation": f}
    if kind == "pad_fn":
        pad = _edge_pad_jax if jax_side else _edge_pad_torch
        return {"pad_fn": pad}, {"pad_fn": pad}
    m = kind.split(":")[1]
    return {"mode": m}, {"mode": m}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,backend,wname,shape,axis", CASES)
def test_passes_match_jax_in_each_formulation(kind, backend, wname, shape, axis, dtype):
    w = get_wavelet(wname)
    x, jx = _inputs(dtype, (2, 3) + shape, seed=len(kind) + abs(axis))
    akw, skw = _kw(kind, False)
    jakw, jskw = _kw(kind, True)
    dec, rec = (w.dec_lo, w.dec_hi), (w.rec_lo, w.rec_hi)
    got = conv.analysis_pass(x, dec, axis, backend=backend, **akw)
    want = jax.jit(lambda t: jconv.analysis_pass(t, dec, axis, backend=backend, **jakw))(jx)
    assert got.dtype == x.dtype
    _close(got, want, dtype)
    if kind.startswith("mode") and w.hlen % 2:
        return  # pywt's inverse takes an even filter length
    z = got[:, :4].contiguous()
    jz = jnp.asarray(_f64(z)).astype(jx.dtype)
    n = shape[axis]
    y = conv.synthesis_pass(z, rec, axis, out_len=n, backend=backend, **skw)
    jy = jax.jit(lambda t: jconv.synthesis_pass(t, rec, axis, out_len=n, backend=backend,
                                                **jskw))(jz)
    assert y.dtype == x.dtype
    _close(y, jy, dtype)


@pytest.mark.parametrize("backend", BACKENDS)
def test_formulations_agree_in_float64(backend):
    """Each formulation against the others and the float64 roundtrip."""
    w = get_wavelet("db7")
    x, _ = _inputs("float64", (1, 1, 19, 24), seed=5)
    dec, rec = (w.dec_lo, w.dec_hi), (w.rec_lo, w.rec_hi)
    z = conv.analysis_pass(x, dec, -1, backend=backend)
    ref = conv.analysis_pass(x, dec, -1, backend="fma")
    assert float((z - ref).abs().max()) < 1e-12
    y = conv.synthesis_pass(z, rec, -1, out_len=24, backend=backend)
    assert float((y - x).abs().max()) < 1e-10


def test_default_backend_is_fma_and_unknown_names_raise():
    assert conv.get_default_backend() == "fma" or conv._default_backend in conv.BACKENDS
    x = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="unknown backend"):
        conv.analysis_pass(x, (np.ones(2),), -1, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        conv.set_default_backend("cuda")


def test_xla_pass_gradient_matches_fma():
    """The "xla" pass's own backward (the input gradient of the grouped
    convolution) equals the fma pass's autograd."""
    w = get_wavelet("sym4")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 1, 12, 10)))
    ct = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 2, 12, 5)))
    grads = []
    for be in ("fma", "xla", "gather"):
        xr = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(conv.analysis_pass(xr, (w.dec_lo, w.dec_hi), -1, backend=be),
                                   xr, ct)
        grads.append(g)
    for g in grads[1:]:
        assert float((g - grads[0]).abs().max()) < 1e-12
