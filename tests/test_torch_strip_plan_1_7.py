"""Launch plans and tilings of kernels 1 and 7, moved for Hopper's CUDA
cores onto the strip bodies that already computed their functions,
checked on the CPU:

* kernel 1, the exact decimated 2D analysis (``separable.fwd_level_2d``),
  runs kernel 13's body at output step 2 in ``fd`` on float32 data, on
  ``matmul.fwd_launch_plan`` in ``fd`` (kernel 11's plan): the
  plan covers every subband output once and fits shared memory for 2 to
  128 taps (3, 5 and 127 included) on 2 x 2, odd-half (74 x 106) and
  2048^2 images and batches of 1, 3 and 70000; the DWT cell's levels get
  their block target; and kernel 13's tiling model at step 2 (rows first)
  equals kernel 1's plain version (columns first) within 1e-5 of its
  largest output;
* kernel 7, the exact decimated 1D analysis (``batched1d.fwd_level_1d``),
  runs kernel 15's decimated body in ``fd`` on a float32 input and high
  band, on ``mxu1d.fwd1d_launch_plan(..., "fd", True)``: the plan covers
  every output once and fits for 2 to 128 taps, signals of 2, 14 and 4096
  samples and 1, 33, 1024 and 70000 signals; the batched 1D cell's levels
  get their block target; and kernel 15's decimated tiling model equals
  kernel 7's plain version within 1e-5 of its largest output.

Each model is also held against the JAX package's Pallas kernel (kernel
1: ``separable_pallas.py:234``; kernel 7: ``swt_pallas.py:395``) in
interpret mode on one shape the Pallas tiles take, within
``test_torch_separable_kernels.py``'s 4e-6 of the largest output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import kernels as jk
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu_torch.kernels import _launch as L
from pdwt_tpu_torch.kernels import batched1d as K1
from pdwt_tpu_torch.kernels import matmul as M
from pdwt_tpu_torch.kernels import mxu1d as M1
from pdwt_tpu_torch.kernels import separable as K
from test_torch_inv_launch_plan import _coverage
from test_torch_strip_plan_10_12 import _blocks, _wavelet
from test_torch_strip_plan_13_15 import _check_13, _check_15, _model_fwd1d
from test_torch_strip_plan_16_17 import _coverage_1d
from test_torch_strip_plan_9_11 import _c_fwd_smem, _model_fwd_level

F32 = torch.float32
#: the model against the Pallas kernel (test_torch_separable_kernels.py: RTOL)
JAX_RTOL = 4e-6


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")


def _within(got, want, rtol):
    """max|got - want| over every output <= rtol * the largest |want|."""
    want = [np.asarray(w, dtype=np.float64) for w in want]
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        g = np.asarray(g, dtype=np.float64)
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= rtol * scale


# -- kernel 1: fwd_launch_plan in fd, kernel 13 at step 2 ---------------------

# (B, R, C) images: 2 x 2, odd subband sizes (37 x 53, 35 x 67), the DWT
# cell's first and last levels, batches of 3
COVER_1 = [(1, 2, 2), (3, 2, 2), (1, 74, 106), (3, 70, 134), (2, 16, 16), (1, 256, 256),
           (1, 2048, 2048)]


@pytest.mark.parametrize("B,R,C", COVER_1)
@pytest.mark.parametrize("hlen", [2, 3, 5, 14, 127, 128])
def test_kernel_1_plan_covers_every_subband_output_once(B, R, C, hlen):
    plan = M.fwd_launch_plan(B, R, C, hlen, "fd")
    _check_13(plan, "fd", 1)
    assert plan.gc == 1 and hlen <= plan.nt <= L.MAX_HLEN  # swt_matmul.cu: launch_fwd
    assert plan.smem == _c_fwd_smem("fd", 2, plan.lr, plan.lc, 1, plan.nt, plan.nph)
    assert (_coverage(plan, R // 2, C // 2, 1, 1, B) == 1).all(), plan


@pytest.mark.parametrize("shape", [(1, 2048, 2048), (1, 1024, 1024), (1, 512, 512),
                                   (1, 256, 256), (1, 2, 2), (3, 74, 106), (70000, 2, 2)])
def test_kernel_1_plan_fits_for_every_filter_length(shape):
    """2 to 128 taps, odd ones too (custom banks), on images smaller than
    the support and a batch past gridDim.z (the body loops over the rest):
    no size, tap count or batch kernel 1 took before is refused.  The plan
    is kernel 11's in fd, so kernel 11's tiling model is kernel 1's."""
    for hlen in range(2, L.MAX_HLEN + 1):
        plan = M.fwd_launch_plan(*shape, hlen, "fd")
        _check_13(plan, "fd", 1)
        assert plan.nt >= hlen and plan.nt <= L.MAX_HLEN and plan.gc == 1
        assert plan.smem == L.fwd_smem("fd", plan.lr, plan.lc, 1, plan.nt, plan.nph, 2)
        assert plan.grid[2] == min(shape[0], 65535) and plan.grid[1] <= 65535
        assert plan == M.fwd_launch_plan(*shape, hlen, "fd")


@pytest.mark.parametrize("r,blocks", [(2048, 512), (1024, 256), (512, 256), (256, 128)])
def test_kernel_1_cell_levels_get_their_block_target(r, blocks):
    """The DWT cell's analysis levels (db7, 2048^2 images down to 256^2):
    the block target of the level's four subbands together, at most the
    shared memory that lets two blocks share an SM (the fixed 32 x 32
    subband tiles of the body before gave 1024, 256, 64 and 16 blocks)."""
    plan = M.fwd_launch_plan(1, r, r, 14, "fd")
    assert _blocks(plan) >= L.block_target(1, r, r)
    assert _blocks(plan) == blocks
    assert plan.smem <= L.SMEM_TWO_BLOCKS


@pytest.mark.parametrize("wname,shape", [
    ("haar", (1, 2, 2)), ("db7", (2, 74, 106)), ("db7", (1, 16, 16)), ("odd5", (1, 70, 134)),
    ("w3", (3, 6, 10)), ("db2", (3, 18, 26)), ("w40", (1, 140, 76)), ("w128", (1, 20, 34)),
    ("db7", (3, 2, 2))])
def test_model_of_kernel_13_at_step_2_matches_kernel_1_plain_version(wname, shape):
    """Kernel 13's tiling at output step 2 in fd (its float32 model, rows
    first) against kernel 1's plain version (columns first): 2 x 2 images,
    odd subband sizes, 2, 3 and 5 taps (odd), 40 and 128, batches of 3."""
    w = _wavelet(wname)
    x = torch.from_numpy(np.random.default_rng(sum(shape)).uniform(0, 255, shape)
                         .astype(np.float32))
    want = K.fwd_level_2d_ref(x, w.dec_lo, w.dec_hi)
    got = _model_fwd_level(x, w.dec_lo, w.dec_hi, "fd", (F32, F32))
    assert all(g.dtype == F32 for g in got)
    _within(got, want, 1e-5)


@pytest.mark.parametrize("wname", ["db7", "sym8"])
def test_model_of_kernel_1_matches_the_pallas_kernel(_interpret, wname):
    """The model against JAX's kernel 1 (rows first too) on a 16 x 256
    image, a shape the Pallas tiles take."""
    jw, w = jget_wavelet(wname), _wavelet(wname)
    x = np.random.default_rng(16).uniform(0, 255, (1, 16, 256)).astype(np.float32)
    want = jk.fwd_level_2d(jnp.asarray(x), jw.dec_lo, jw.dec_hi)
    assert want is not None
    got = _model_fwd_level(torch.from_numpy(x), w.dec_lo, w.dec_hi, "fd", (F32, F32))
    _within(got, want, JAX_RTOL)


# -- kernel 7: fwd1d_launch_plan in fd, decimated, on a float32 input ---------

PLAN_7 = [(1, 2), (1, 14), (33, 2), (33, 14), (1, 4096), (3, 4096), (1024, 512), (70000, 2)]


@pytest.mark.parametrize("B,N", PLAN_7)
@pytest.mark.parametrize("hlen", [2, 3, 5, 16, 127, 128])
def test_kernel_7_plan_covers_every_output_once(B, N, hlen):
    plan = M1.fwd1d_launch_plan(B, N, hlen, 1, "fd", True)
    _check_15(plan, "fd", 1)
    assert plan.gc == 1 and hlen <= plan.nt <= L.MAX_HLEN  # mxu1d.cu: launch_fwd
    assert plan.smem == M1._fwd1d_smem("fd", 2, plan.lc, 1, plan.nt)
    assert (_coverage_1d(plan, B, N // 2, 1, False) == 1).all(), plan


@pytest.mark.parametrize("B,N", [(1024, 4096), (1024, 512), (1, 2), (33, 14), (70000, 2),
                                 (1, 1 << 21), (3, 1002)])
def test_kernel_7_plan_fits_for_every_filter_length(B, N):
    """2 to 128 taps, odd ones too (custom banks), on signals shorter than
    the support, a batch past gridDim.y and one long signal: no length, tap
    count or batch kernel 7 took before is refused."""
    for hlen in range(2, L.MAX_HLEN + 1):
        plan = M1.fwd1d_launch_plan(B, N, hlen, 1, "fd", True)
        _check_15(plan, "fd", 1)
        assert plan.nt >= hlen and plan.nt <= L.MAX_HLEN and plan.gc == 1
        assert plan.grid[1] == min(-(-B // 32), 65535) and plan.grid[2] == 1


@pytest.mark.parametrize("n,blocks", [(4096, 512), (2048, 256), (1024, 256), (512, 256)])
def test_kernel_7_cell_levels_get_their_block_target(n, blocks):
    """The batched 1D cell's analysis levels (sym8, 1024 signals of 4096
    down to 512 samples in): the block target of the level's output, at
    most the shared memory that lets three blocks share an SM."""
    plan = M1.fwd1d_launch_plan(1024, n, 16, 1, "fd", True)
    assert _blocks(plan) >= L.block_target(1, 1024, n // 2)
    assert _blocks(plan) == blocks
    assert plan.smem <= M1.SMEM_THREE_BLOCKS


@pytest.mark.parametrize("wname,B,N", [
    ("sym8", 33, 300), ("sym8", 2, 78), ("sym8", 1, 14), ("w3", 3, 50), ("w3", 33, 2),
    ("odd5", 2, 42), ("w64", 2, 150), ("w128", 3, 90), ("w128", 1, 14), ("db2", 33, 2),
    ("haar", 5, 2), ("db7", 40, 130)])
def test_model_of_kernel_15_decimated_tiling_matches_kernel_7_plain_version(wname, B, N):
    """Kernel 15's decimated tiling in fd (its float64 model) against
    kernel 7's plain version: 2, 3 and 5 taps (odd), 64 and 128, signals of
    2 and 14 samples, batches of 33 and 40."""
    w = _wavelet(wname)
    x = torch.from_numpy(np.random.default_rng(N + B).standard_normal((B, N))
                         .astype(np.float32))
    want = K1.fwd_level_1d_ref(x, w.dec_lo, w.dec_hi)
    got = _model_fwd1d(x, w.dec_lo, w.dec_hi, 1, True)
    _within(got, [t.numpy() for t in want], 1e-5)


@pytest.mark.parametrize("wname", ["db7", "sym8"])
def test_model_of_kernel_7_matches_the_pallas_kernel(_interpret, wname):
    """The model against JAX's kernel 7 on 8 signals of 256 samples, a
    shape the Pallas tiles take."""
    jw, w = jget_wavelet(wname), _wavelet(wname)
    x = np.random.default_rng(8).uniform(0, 255, (8, 256)).astype(np.float32)
    want = jk.fwd_level_1d(jnp.asarray(x), jw.dec_lo, jw.dec_hi)
    assert want is not None
    got = _model_fwd1d(torch.from_numpy(x), w.dec_lo, w.dec_hi, 1, True)
    _within(got, want, JAX_RTOL)
