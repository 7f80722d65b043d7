"""The port's fully separable transform (``core/anisotropic.py``) against the
JAX package's ``fs_dwt``/``fs_idwt``/``fs_slices`` on the CPU.

Inputs are made from a seed with numpy; JAX runs its default CPU route,
jitted.  1D, 2D and 3D, per-axis levels including 0, odd and prime sides,
every boundary mode and a per-axis mode tuple, float32 and float64.
Tolerances: max|port - jax| <= 1e-5 * max|jax| in float32 (the port's
kernels' plain versions and JAX's conv passes sum in another order) and
1e-12 * max|jax| in float64; the roundtrip to 1e-4 of the input's largest
value in float32 (1e-10 in float64).  One ``bf16-fast`` case, a bf16 image
whose first pass reaches kernels 15 and 16, is held to JAX's Pallas route
in interpret mode at ``tests/test_torch_precision.py``'s tolerances (2^-7
for bf16 outputs, 2e-3 for float32 ones).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu.core import anisotropic as jA
from pdwt_tpu.core import precision as jprec
from pdwt_tpu.filters import get_wavelet as jget
from pdwt_tpu_torch import precision_scope
from pdwt_tpu_torch.core import anisotropic as A
from pdwt_tpu_torch.core.modes import MODES
from pdwt_tpu_torch.filters import get_wavelet

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
RT_TOL = {np.float32: 1e-4, np.float64: 1e-10}
TOL_BF16, TOL_F32_FAST = 2.0 ** -7, 2e-3


def _rand(shape, dtype=np.float32, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


CASES = [
    # 1D: prime lengths, a batch
    ((3, 97), (3,), "periodization"),
    ((2, 101), (2,), "symmetric"),
    # 2D: even, odd and prime sides, asymmetric depths, a level of 0
    ((64, 64), (2, 3), "periodization"),
    ((37, 53), (3, 1), "periodization"),
    ((37, 53), (2, 0), "periodization"),
    ((2, 31, 40), (2, 2), ("zero", "periodization")),
    # 3D: anisotropic volume, depth untransformed, odd sides under a mode
    ((8, 48, 64), (1, 2, 3), "periodization"),
    ((5, 32, 32), (0, 2, 2), "periodization"),
    ((7, 11, 13), (1, 1, 2), ("reflect", "periodization", "smooth")),
]


def _ids(c):
    return f"{'x'.join(map(str, c[0]))}-L{''.join(map(str, c[1]))}-" + (
        c[2] if isinstance(c[2], str) else "+".join(m[:4] for m in c[2]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape,levels,mode", CASES, ids=[_ids(c) for c in CASES])
def test_fs_dwt_and_fs_idwt_match_jax(shape, levels, mode, dtype):
    x = _rand(shape, dtype)
    jw, w = jget("db3"), get_wavelet("db3")
    nd = len(levels)
    want = jax.jit(lambda v: jA.fs_dwt(v, jw, levels, mode=mode))(jnp.asarray(x))
    got = A.fs_dwt(torch.from_numpy(x), w, levels, mode=mode)
    want = np.array(want)
    assert got.dtype == torch.from_numpy(want).dtype and tuple(got.shape) == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= RTOL[dtype] * scale
    back = A.fs_idwt(torch.from_numpy(want), w, shape[-nd:], levels, mode=mode)
    jback = np.asarray(jax.jit(lambda c: jA.fs_idwt(c, jw, shape[-nd:], levels, mode=mode))(
        jnp.asarray(want)))
    assert back.dtype == got.dtype and tuple(back.shape) == jback.shape == x.shape
    assert float(np.abs(back.numpy() - jback).max()) <= RTOL[dtype] * float(np.abs(jback).max())
    assert float(np.abs(back.numpy() - x).max()) <= RT_TOL[dtype] * float(np.abs(x).max())


@pytest.mark.parametrize("mode", MODES)
def test_every_mode_matches_jax(mode):
    """A 2D odd image, levels (2, 1), db4, under each boundary mode."""
    x = _rand((29, 34), seed=1)
    jw, w = jget("db4"), get_wavelet("db4")
    want = np.asarray(jax.jit(lambda v: jA.fs_dwt(v, jw, (2, 1), mode=mode))(jnp.asarray(x)))
    got = A.fs_dwt(torch.from_numpy(x), w, (2, 1), mode=mode).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())
    back = A.fs_idwt(torch.from_numpy(got), w, (29, 34), (2, 1), mode=mode).numpy()
    assert float(np.abs(back - x).max()) <= 1e-4 * float(np.abs(x).max())


def test_scalar_levels_with_ndim_spatial_match_jax():
    x = _rand((2, 40, 24), seed=2)
    jw, w = jget("sym4"), get_wavelet("sym4")
    want = np.asarray(jax.jit(lambda v: jA.fs_dwt(v, jw, 2, ndim_spatial=2))(jnp.asarray(x)))
    got = A.fs_dwt(torch.from_numpy(x), w, 2, ndim_spatial=2).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("shape,levels,mode,hlen", [
    ((37, 53), (3, 2), "periodization", None),
    ((64, 96), (1, 1), "periodization", None),
    ((29, 34, 8), (2, 1, 0), "symmetric", 8),
    ((29, 34), (2, 3), ("zero", "periodization"), 6),
])
def test_fs_slices_match_jax(shape, levels, mode, hlen):
    assert A.fs_slices(shape, levels, mode=mode, hlen=hlen) == jA.fs_slices(
        shape, levels, mode=mode, hlen=hlen)


def test_one_level_blocks_are_the_2d_subbands():
    """At one level per axis the four packed blocks are the 2D DWT's (A, V,
    H, D), H high-pass along the rows (the detail block of axis 0)."""
    from pdwt_tpu_torch import dwt2d

    w, x = get_wavelet("db4"), torch.from_numpy(_rand((64, 96), seed=3))
    y, sl = A.fs_dwt(x, w, (1, 1)), A.fs_slices((64, 96), (1, 1))
    c = dwt2d(x, w, 1)
    h, v, d = c.details[0]
    for blk, want in (((sl[0]["a"], sl[1]["a"]), c.approx), ((sl[0]["d1"], sl[1]["a"]), h),
                      ((sl[0]["a"], sl[1]["d1"]), v), ((sl[0]["d1"], sl[1]["d1"]), d)):
        assert torch.allclose(y[blk], want, atol=1e-4)


def _msg(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


@pytest.mark.parametrize("call", [
    lambda m, w, z: m.fs_dwt(z((8, 8)), w, 1),
    lambda m, w, z: m.fs_dwt(z((8,)), w, (1, 1)),
    lambda m, w, z: m.fs_slices((37, 53), (1, 1), mode="symmetric"),
    lambda m, w, z: m.fs_dwt(z((8, 8)), w, 1, ndim_spatial=3),
    lambda m, w, z: m.fs_dwt(z((8, 8)), w, (1, 1), mode=("zero",)),
    lambda m, w, z: m.fs_dwt(z((8, 8)), w, (1, 1), mode="wrap"),
], ids=["scalar_levels", "too_many_axes", "slices_need_hlen", "ndim_spatial_too_large",
        "mode_count", "unknown_mode"])
def test_errors_are_jaxs(call):
    want = _msg(lambda: call(jA, jget("db2"), lambda s: jnp.zeros(s, jnp.float32)))
    got = _msg(lambda: call(A, get_wavelet("db2"), lambda s: torch.zeros(s)))
    assert got == want != "no error"


def test_bf16_fast_matches_jax_pallas_in_interpret_mode(monkeypatch):
    """A bf16 (512, 32) image, levels (3, 1), sym8, under bf16-fast: the
    first pass runs 32 signals of 512 samples (levels 1-2 on kernel 15,
    level 3 exact), the packed result is float32 (JAX's promotion); the
    inverse of its bf16 cast runs kernel 16 on the same levels."""
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")
    for knob in ("PDWT_TPU_PRECISION", "PDWT_TPU_BF16_ACCURACY", "PDWT_TPU_BF16_L1FWD",
                 "PDWT_TPU_BF16_L1INV"):
        monkeypatch.delenv(knob, raising=False)
    x = np.random.default_rng(4).uniform(-3, 3, (512, 32)).astype(np.float32)
    jw, w = jget("sym8"), get_wavelet("sym8")
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    with jprec.precision_scope("bf16-fast"):
        jy = jA.fs_dwt(jx, jw, (3, 1), backend="pallas")
        jb = jA.fs_idwt(jy.astype(jnp.bfloat16), jw, (512, 32), (3, 1), backend="pallas")
    with precision_scope("bf16-fast"):
        ty = A.fs_dwt(tx, w, (3, 1))
        tb = A.fs_idwt(ty.to(torch.bfloat16), w, (512, 32), (3, 1))
    for got, want, tol in ((ty, jy, TOL_F32_FAST), (tb, jb, TOL_BF16)):
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        w_np = np.asarray(want.astype(jnp.float32))
        assert tuple(got.shape) == w_np.shape
        err = float(np.abs(got.float().numpy() - w_np).max())
        assert err <= tol * float(np.abs(w_np).max()), err
