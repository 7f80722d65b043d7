"""The 3D transforms of the port under the precision tiers against the JAX
package's: ``dwt3d``/``idwt3d``, ``swt3d``/``iswt3d`` and
``iswt3d_denoise`` under ``mixed`` and the three ``bf16-*`` tiers, the JAX
side with ``backend="pallas"`` in interpret mode inside
``precision_scope``, as ``tests/test_torch_precision.py`` runs it.

A (2, 64, 256) db4 volume puts level 1 on the banded-product kernels
(subbands of 32 x 128, which the route rule accepts) and level 2 on the
exact ones; a (4, 16, 16) volume stays exact throughout.  The route is read
level by level from the kernel wrappers the transforms call, and the dtype
contract from the outputs: a float32 approximation chain and bf16 details
under bf16, a bf16 image out of the inverse.

Tolerances are those of ``tests/test_torch_precision.py``, relative to the
largest magnitude of the call's outputs (a depth of 1 at level 2 makes its
depth high-pass bands roundoff): 2^-7 for bf16 outputs, 2e-3 for float32
outputs under ``bf16-fast`` and ``bf16-balanced``, 1e-4 under ``mixed`` and
``bf16-accurate``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu.core import precision as jprec
from pdwt_tpu.core import separable3d as jsep3
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu_torch import dwt3d, idwt3d, iswt3d, iswt3d_denoise, kernels, swt3d
from pdwt_tpu_torch.utils import tensor_from_numpy, tensor_to_numpy, wavelet_from_arrays

TIERS = ("mixed", "bf16-fast", "bf16-balanced", "bf16-accurate")
TOL_BF16 = 2.0 ** -7
TOL_F32 = {"mixed": 1e-4, "bf16-fast": 2e-3, "bf16-balanced": 2e-3, "bf16-accurate": 1e-4}
WRAPPERS = ("fwd_level_2d_ad", "fwd_level_2d_mxu_ad", "inv_level_2d_ad", "inv_level_2d_mxu_ad",
            "swt_fwd_level_2d_ad", "swt_fwd_level_2d_mxu_ad", "swt_inv_level_2d_ad",
            "swt_inv_level_2d_mxu_ad", "swt_inv_level_2d_denoise_ad",
            "swt_inv_level_2d_mxu_denoise_ad")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")
    for knob in ("PDWT_TPU_PRECISION", "PDWT_TPU_BF16_ACCURACY", "PDWT_TPU_BF16_L1FWD",
                 "PDWT_TPU_BF16_L1INV", "PDWT_TPU_SWT_BF16_SCHEME"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture
def calls(monkeypatch):
    """The kernel wrappers the transforms call, in order, by name."""
    seen = []
    for name in WRAPPERS:
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _f=fn, _n=name, **k: (seen.append(_n),
                                                                              _f(*a, **k))[1])
    return seen


def _leaves(t):
    return [t] if not hasattr(t, "details") else [t.approx] + [b for d in t.details for b in d]


def _np(t):
    if isinstance(t, torch.Tensor):
        return tensor_to_numpy(t), str(t.dtype).split(".")[-1]
    return np.asarray(jnp.asarray(t).astype(jnp.float32)), jnp.dtype(t.dtype).name


def _close(got, want, tier):
    got, want = [_np(t) for t in _leaves(got)], [_np(t) for t in _leaves(want)]
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w, _ in want)
    for (g, gdt), (w, wdt) in zip(got, want):
        assert g.shape == w.shape and gdt == wdt, (g.shape, w.shape, gdt, wdt)
        tol = TOL_BF16 if gdt == "bfloat16" else TOL_F32[tier]
        assert float(np.abs(g - w).max()) <= tol * scale


def _dtypes(tree):
    return [str(t.dtype).split(".")[-1] for t in _leaves(tree)]


#: the kernel wrappers each call runs under the bf16 tiers, in order ("-"
#: an exact kernel, "m" a banded-product one): one a forward level, one an
#: exact inverse level, two a regrouped inverse level (an MXU level, and
#: every level of the fused denoise)
SHAPES = {(2, 64, 256): {"dwt": "m-", "idwt": "-mm", "swt": "mm", "iswt": "mmmm",
                         "den": "mmmm"},
          (4, 16, 16): {"dwt": "--", "idwt": "--", "swt": "--", "iswt": "--", "den": "----"}}
#: mixed runs the stationary transforms exact, as JAX does
MIXED_SWT = {"swt": "--", "iswt": "--", "den": "----"}


def _route(calls):
    return "".join("m" if "_mxu_" in n else "-" for n in calls)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("tier", TIERS)
def test_tiers_match_jax_on_their_route(tier, shape, calls):
    jw = jget_wavelet("db4")
    w = wavelet_from_arrays(jw)
    x = np.random.default_rng(7).uniform(0, 255, shape).astype(np.float32)
    bf16 = tier != "mixed"
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    px, jx = tensor_from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)

    def jax_side(v):
        c = jsep3.dwt3d(v, jw, 2, backend="pallas")
        s = jsep3.swt3d(v, jw, 2, backend="pallas")
        return (c, jsep3.idwt3d(c, jw, shape, backend="pallas"), s,
                jsep3.iswt3d(s, jw, backend="pallas"),
                jsep3.iswt3d_denoise(s, jw, 10.0, backend="pallas", mode="garrote"))

    with jprec.precision_scope(tier):  # active while jit traces
        jc, jy, js, jys, jd = jax.jit(jax_side)(jx)
    route = dict(SHAPES[shape], **({} if bf16 else MIXED_SWT))
    steps = [("dwt", lambda: dwt3d(px, w, 2, precision=tier), jc),
             ("idwt", lambda: idwt3d(pc, w, shape, precision=tier), jy),
             ("swt", lambda: swt3d(px, w, 2, precision=tier), js),
             ("iswt", lambda: iswt3d(ps, w, precision=tier), jys),
             ("den", lambda: iswt3d_denoise(ps, w, 10.0, mode="garrote", precision=tier), jd)]
    for name, fn, want in steps:
        calls.clear()
        got = fn()
        assert _route(calls) == route[name], (name, calls)
        _close(got, want, tier)
        if name == "dwt":
            pc = got
        if name == "swt":
            ps = got
        det = "bfloat16" if bf16 else "float32"
        if name in ("dwt", "swt"):
            assert _dtypes(got) == ["float32"] + [det] * 14
        else:
            assert _dtypes(got) == [det]
