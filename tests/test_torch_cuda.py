"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  On a machine
with a card (which need not have JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerance: max|kernel - plain| <= 1e-5 * max|plain| in float32, because
nvcc contracts each multiply-add into one FMA where the plain version
rounds twice.  For the stationary kernels max|plain| is taken over the
subbands of a call together: at a dilation as large as the image (or the
signal) the high-pass sums its taps over one period, and is roundoff.
The banded-product kernels of the precision tiers: float32-stored outputs
within 1e-5, bf16-stored outputs within 2^-7 (a float32 sum one ulp apart
flips one bf16 rounding); a tier's whole path against the CPU's within
1e-4 on float32 outputs (an exact level's FMAs move a value by an ulp,
and the next b3 level's split of it then differs by up to 2^-17 per pass)
and 2^-6 on bf16 outputs (such a flip inside a level moves its output by
up to one more bf16 ulp).
"""
import math

import numpy as np
import pytest
import torch

from pdwt_tpu_torch import (Wavelets, dwt1d, dwt2d, get_wavelet, idwt1d, idwt2d, iswt1d,
                            iswt2d, iswt2d_denoise, ops, swt1d, swt2d)
from pdwt_tpu_torch.filters import make_custom_wavelet
from pdwt_tpu_torch.kernels import batched1d as K1
from pdwt_tpu_torch.kernels import matmul as M
from pdwt_tpu_torch.kernels import mxu1d as M1
from pdwt_tpu_torch.kernels import ns_matmul as NM
from pdwt_tpu_torch.kernels import separable as K
from pdwt_tpu_torch.kernels import swt as S
from pdwt_tpu_torch.kernels import swt_matmul as SM

pytestmark = pytest.mark.cuda

RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _wavelet(name):
    if name == "odd5":  # an odd-length custom bank
        f = np.random.default_rng(5).standard_normal((4, 5))
        return make_custom_wavelet("odd5", *f)
    return get_wavelet(name)


def _close(got, want):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = float((g - w).abs().max().detach())
        assert err <= RTOL * float(w.abs().max().detach()), err


def _close_joint(got, want):
    """The stationary kernels' bound: relative to the largest plain output."""
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = float((g - w).abs().max().detach())
        assert err <= RTOL * scale, err


def _rand(dev, *shape, seed=0):
    x = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return torch.from_numpy(x).to(dev)


LEVEL_CASES = [("db7", (2, 96, 160)), ("haar", (1, 64, 64)), ("db20", (3, 70, 38)),
               ("odd5", (1, 34, 50)), ("bior6.8", (2, 6, 8)), ("sym8", (1, 2, 130))]


@pytest.mark.parametrize("wname,shape", LEVEL_CASES)
def test_level_kernels_match_plain(dev, wname, shape):
    w = _wavelet(wname)
    x = _rand(dev, *shape)
    got = K.fwd_level_2d(x, w.dec_lo, w.dec_hi)
    _close(got, K.fwd_level_2d_ref(x, w.dec_lo, w.dec_hi))
    bands = [_rand(dev, *got[0].shape, seed=s) for s in range(4)]
    _close(K.inv_level_2d(*bands, w.rec_lo, w.rec_hi),
           K.inv_level_2d_ref(*bands, w.rec_lo, w.rec_hi))


TAIL_CASES = [("db7", (1, 128, 128), 1), ("db7", (3, 32, 64), 3),
              ("db18", (1, 64, 128), 3), ("haar", (2, 16, 16), 4), ("odd5", (1, 24, 40), 3)]


@pytest.mark.parametrize("wname,shape,levels", TAIL_CASES)
def test_tail_kernels_match_plain(dev, wname, shape, levels):
    """db18 at 64x128, 3 levels: the 17-sample wrap is wider than the
    8-row deepest level."""
    w = _wavelet(wname)
    x = _rand(dev, *shape)
    a, dets = K.fwd_tail_2d(x, w.dec_lo, w.dec_hi, levels)
    ra, rdets = K.fwd_tail_2d_ref(x, w.dec_lo, w.dec_hi, levels)
    _close([a, *sum(dets, ())], [ra, *sum(rdets, ())])
    back = dets[::-1]
    _close(K.inv_tail_2d(a, back, w.rec_lo, w.rec_hi),
           K.inv_tail_2d_ref(a, back, w.rec_lo, w.rec_hi))


@pytest.mark.parametrize("wname,shape,levels", [("db7", (2, 3, 75, 131), 4),
                                                ("db3", (256, 256), 5),
                                                ("odd5", (1, 61, 67), 3)])
def test_dwt2d_matches_cpu(dev, wname, shape, levels):
    """The CUDA main path (kernels) against the CPU one (plain versions),
    forward, inverse and the gradient of a linear loss."""
    w = _wavelet(wname)
    x = _rand(dev, *shape).requires_grad_(True)
    xc = x.detach().cpu().requires_grad_(True)
    c, cc = dwt2d(x, w, levels), dwt2d(xc, w, levels)
    leaves = lambda c: [c.approx, *sum(c.details, ())]
    _close([t.cpu() for t in leaves(c)], leaves(cc))
    y, yc = idwt2d(c, w, shape[-2:]), idwt2d(cc, w, shape[-2:])
    _close(y.cpu(), yc)
    if wname != "odd5":  # a random bank does not reconstruct
        assert float((y - x).abs().max().detach()) < 1e-4
    wt = _rand(dev, *shape, seed=7)
    (y * wt).sum().backward()
    (yc * wt.cpu()).sum().backward()
    _close(x.grad.cpu(), xc.grad)


def test_launch_counters(dev):
    w = get_wavelet("db7")
    K.reset_launch_counts()
    c = dwt2d(_rand(dev, 512, 512), w, 3)
    idwt2d(c, w, (512, 512))
    assert K.LAUNCHES == {"fwd_level_2d": 2, "inv_level_2d": 2,
                          "fwd_tail_2d": 1, "inv_tail_2d": 1,
                          "swt_fwd_level_2d": 0, "swt_inv_level_2d": 0,
                          "swt_norm_sum_2d": 0,
                          "fwd_level_1d": 0, "fwd_level_1d_norm": 0, "inv_level_1d": 0,
                          "swt_fwd_level_1d": 0, "swt_inv_level_1d": 0,
                          "fwd_level_2d_mxu": 0, "inv_level_2d_mxu": 0,
                          "fwd_level_1d_mxu": 0, "inv_level_1d_mxu": 0,
                          "swt_fwd_level_1d_mxu": 0, "swt_inv_level_1d_mxu": 0,
                          "swt_fwd_level_2d_mxu": 0, "swt_inv_level_2d_mxu": 0,
                          "ns_fwd_level_2d_mxu": 0, "ns_inv_level_2d_mxu": 0,
                          "ns_swt_fwd_level_2d_mxu": 0, "ns_swt_inv_level_2d_mxu": 0,
                          "fwd_level_2d_padded": 0, "inv_level_2d_padded": 0,
                          "fwd_level_1d_padded": 0, "inv_level_1d_padded": 0,
                          "swt_fwd_level_2d_padded": 0, "swt_inv_level_2d_padded": 0,
                          "swt_fwd_level_1d_padded": 0, "swt_inv_level_1d_padded": 0,
                          "fwd_level_2d_mxu_padded": 0, "inv_level_2d_mxu_padded": 0,
                          "swt_fwd_level_2d_mxu_padded": 0, "swt_inv_level_2d_mxu_padded": 0,
                          "fwd_level_1d_mxu_padded": 0, "inv_level_1d_mxu_padded": 0,
                          "swt_fwd_level_1d_mxu_padded": 0, "swt_inv_level_1d_mxu_padded": 0}


def test_cuda_rejects_what_the_kernels_do_not_take(dev):
    w = get_wavelet("db2")
    with pytest.raises(NotImplementedError, match="float64"):
        K.fwd_level_2d(_rand(dev, 1, 8, 8).double(), w.dec_lo, w.dec_hi)
    with pytest.raises(NotImplementedError, match="float64"):
        dwt2d(_rand(dev, 8, 8).double(), w, 1)
    with pytest.raises(ValueError, match="contiguous"):
        K.fwd_level_2d(_rand(dev, 1, 8, 16)[:, :, ::2], w.dec_lo, w.dec_hi)
    with pytest.raises(ValueError, match="even"):
        K.fwd_level_2d(_rand(dev, 1, 7, 8), w.dec_lo, w.dec_hi)
    long = np.ones(K.MAX_HLEN + 2)
    with pytest.raises(ValueError, match="taps"):
        K.fwd_level_2d(_rand(dev, 1, 8, 8), long, long)
    with pytest.raises(ValueError, match="tail_supported"):
        K.fwd_tail_2d(_rand(dev, 1, 256, 256), w.dec_lo, w.dec_hi, 1)


# ---------------------------------------------------------------------------
# stationary (a-trous) kernels, the TI-denoise path
# ---------------------------------------------------------------------------

SWT_CASES = [("db7", (1, 1024, 1024), 1), ("db7", (1, 1024, 1024), 2),
             ("db7", (1, 1024, 1024), 3), ("db7", (1, 1024, 1024), 6),
             ("db2", (1, 8, 16), 1), ("db2", (1, 8, 16), 4),
             ("db7", (1, 37, 53), 2), ("db7", (3, 64, 96), 2), ("odd5", (1, 23, 29), 3),
             ("db20", (1, 40, 50), 3)]
THRESHOLDS = [None, ("soft", 10.0), ("hard", 10.0), ("garrote", 10.0)]


@pytest.mark.parametrize("wname,shape,level", SWT_CASES)
def test_swt_kernels_match_plain(dev, wname, shape, level):
    """The inverse runs on the plain forward's subbands, so the hard and
    garrote masks see the same values in both versions."""
    w = _wavelet(wname)
    x = _rand(dev, *shape) * 255
    want = S.swt_fwd_level_2d_ref(x, w.dec_lo, w.dec_hi, level)
    _close_joint(S.swt_fwd_level_2d(x, w.dec_lo, w.dec_hi, level), want)
    for thr in THRESHOLDS:
        _close(S.swt_inv_level_2d(*want, w.rec_lo, w.rec_hi, level, threshold=thr),
               S.swt_inv_level_2d_ref(*want, w.rec_lo, w.rec_hi, level, threshold=thr))
    beta = torch.tensor([10.0], device=dev)  # beta on the device, no host round trip
    _close(S.swt_inv_level_2d(*want, w.rec_lo, w.rec_hi, level, threshold=("soft", beta)),
           S.swt_inv_level_2d_ref(*want, w.rec_lo, w.rec_hi, level, threshold=("soft", 10.0)))


@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
def test_swt_gradients_match_autograd_through_plain(dev, mode):
    """torch.autograd.grad through each kernel's Function against autograd
    through the plain versions on the card, beta included."""
    w = _wavelet("db7")
    x = (_rand(dev, 2, 64, 96) * 255).requires_grad_(True)
    cts = [_rand(dev, 2, 64, 96, seed=s) for s in range(1, 5)]
    lin = lambda outs: sum((o * c).sum() for o, c in zip(outs, cts))
    _close(torch.autograd.grad(lin(S.swt_fwd_level_2d_ad(x, w.dec_lo, w.dec_hi, 2)), x),
           torch.autograd.grad(lin(S.swt_fwd_level_2d_ref(x, w.dec_lo, w.dec_hi, 2)), x))
    bands = [t.detach().requires_grad_(True)
             for t in S.swt_fwd_level_2d_ref(x.detach(), w.dec_lo, w.dec_hi, 2)]
    beta = torch.tensor(60.0, device=dev, requires_grad=True)
    got = torch.autograd.grad(
        lin([S.swt_inv_level_2d_denoise_ad(*bands, beta, w.rec_lo, w.rec_hi, 2, mode)]),
        bands + [beta])
    want = torch.autograd.grad(
        lin([S.swt_inv_level_2d_ref(*bands, w.rec_lo, w.rec_hi, 2, threshold=(mode, beta))]),
        bands + [beta], allow_unused=True)
    _close(list(got[:4]), list(want[:4]))
    if mode == "hard":
        assert want[4] is None and float(got[4]) == 0.0
    else:  # a sum over 36864 terms: 1e-4 relative
        assert abs(float(got[4]) - float(want[4])) <= 1e-4 * abs(float(want[4]))
    y = iswt2d(swt2d(x, w, 3), w)
    (g,) = torch.autograd.grad((y * cts[0]).sum(), x)
    assert float((g - cts[0]).abs().max()) < 1e-4  # iswt2d o swt2d is the identity


def test_ti_path_launches_the_kernels_and_no_plain_version(dev, monkeypatch):
    """On a CUDA tensor the TI step runs on the kernels: one forward launch
    and one fused inverse launch per level, and no plain version."""
    def boom(*args, **kwargs):
        raise AssertionError("a plain version ran on the CUDA path")

    for name in ("swt_fwd_level_2d_ref", "swt_inv_level_2d_ref"):
        monkeypatch.setattr(S, name, boom)
    w = get_wavelet("db7")
    x = _rand(dev, 256, 256) * 255
    K.reset_launch_counts()
    c = swt2d(x, w, 3)
    y = iswt2d_denoise(c, w, 10.0, mode="garrote", normalize=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES["swt_fwd_level_2d"] == 3 and K.LAUNCHES["swt_inv_level_2d"] == 3
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


def test_swt_cuda_rejects_what_the_kernels_do_not_take(dev):
    w = get_wavelet("db2")
    with pytest.raises(NotImplementedError, match="float64"):
        S.swt_fwd_level_2d(_rand(dev, 1, 8, 8).double(), w.dec_lo, w.dec_hi, 1)
    with pytest.raises(NotImplementedError, match="float64"):
        swt2d(_rand(dev, 8, 8).double(), w, 1)
    bands = [_rand(dev, 1, 8, 8) for _ in range(4)]
    with pytest.raises(ValueError, match="threshold mode"):
        S.swt_inv_level_2d(*bands, w.rec_lo, w.rec_hi, 1, threshold=("firm", 1.0))
    with pytest.raises(ValueError, match="one beta"):
        S.swt_inv_level_2d(*bands, w.rec_lo, w.rec_hi, 1,
                           threshold=("soft", torch.ones(2, device=dev)))


# ---------------------------------------------------------------------------
# batched 1D kernels, the batched 1D path
# ---------------------------------------------------------------------------

# (wavelet, batch, length): the path's own shape (sym8, 1024 x 4096), an
# odd length, signals shorter than the support, one long signal, more
# signals than a grid dimension holds, Haar and an odd-length bank
CASES_1D = [("sym8", 1024, 4096), ("sym8", 3, 1023), ("sym8", 2, 10), ("db2", 4, 8),
            ("sym8", 1, 1 << 22), ("sym8", 70000, 64), ("haar", 5, 64), ("odd5", 3, 29)]


@pytest.mark.parametrize("wname,batch,n", CASES_1D)
def test_batched1d_kernels_match_plain(dev, wname, batch, n):
    """Levels 1-4 of the stationary pair (db2 on 8 samples: a dilation of 8
    at level 4); the decimated pair on the odd-extended length."""
    w = _wavelet(wname)
    x = _rand(dev, batch, n) * 255
    xe = x if n % 2 == 0 else torch.cat([x, x[:, -1:]], dim=1)
    _close(K1.fwd_level_1d(xe, w.dec_lo, w.dec_hi), K1.fwd_level_1d_ref(xe, w.dec_lo, w.dec_hi))
    m = xe.shape[1] // 2
    lo, hi = _rand(dev, batch, m, seed=1), _rand(dev, batch, m, seed=2)
    _close(K1.inv_level_1d(lo, hi, w.rec_lo, w.rec_hi),
           K1.inv_level_1d_ref(lo, hi, w.rec_lo, w.rec_hi))
    for level in range(1, 5):
        want = K1.swt_fwd_level_1d_ref(x, w.dec_lo, w.dec_hi, level)
        _close_joint(K1.swt_fwd_level_1d(x, w.dec_lo, w.dec_hi, level), want)
        _close(K1.swt_inv_level_1d(*want, w.rec_lo, w.rec_hi, level),
               K1.swt_inv_level_1d_ref(*want, w.rec_lo, w.rec_hi, level))


@pytest.mark.parametrize("wname,shape,levels", [("sym8", (2, 3, 301), 4), ("db2", (4, 8), 3),
                                                ("odd5", (29,), 2)])
@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_1d_transforms_match_cpu(dev, wname, shape, levels, swt):
    """The CUDA path (kernels) against the CPU one (plain versions),
    forward, inverse and the gradient of a linear loss."""
    w = _wavelet(wname)
    x = (_rand(dev, *shape) * 255).requires_grad_(True)
    xc = x.detach().cpu().requires_grad_(True)
    fwd = (lambda t: swt1d(t, w, levels)) if swt else (lambda t: dwt1d(t, w, levels))
    inv = (lambda c: iswt1d(c, w)) if swt else (lambda c: idwt1d(c, w, shape[-1]))
    c, cc = fwd(x), fwd(xc)
    leaves = lambda c: [c.approx, *c.details]
    (_close_joint if swt else _close)([t.cpu() for t in leaves(c)], leaves(cc))
    y, yc = inv(c), inv(cc)
    _close(y.cpu(), yc)
    if wname != "odd5":  # a random bank does not reconstruct
        assert float((y - x).abs().max().detach()) < 1e-3
    wt = _rand(dev, *shape, seed=7)
    (y * wt).sum().backward()
    (yc * wt.cpu()).sum().backward()
    _close(x.grad.cpu(), xc.grad)


def test_1d_path_launches_the_kernels_and_no_plain_version(dev, monkeypatch):
    """On a CUDA tensor the facade's 1D steps run on the kernels, one launch
    per level each way (the DWT's analysis in kernel 7's norm launches, and
    one sum of their partials), and no plain version."""
    def boom(*args, **kwargs):
        raise AssertionError("a plain version ran on the CUDA path")

    for name in ("fwd_level_1d_ref", "inv_level_1d_ref", "swt_fwd_level_1d_ref",
                 "swt_inv_level_1d_ref"):
        monkeypatch.setattr(K1, name, boom)
    sig = _rand(dev, 64, 1000) * 255
    K.reset_launch_counts()
    for swt in (False, True):
        out, n1 = Wavelets(sig, wname="sym8", levels=4, ndim=1, do_swt=swt,
                           device=dev).run_denoise(25.0)
        assert out.shape == sig.shape and bool(torch.isfinite(out).all())
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        "fwd_level_1d_norm": 4, "swt_norm_sum_2d": 1, "inv_level_1d": 4, "swt_fwd_level_1d": 4,
        "swt_inv_level_1d": 4}


def test_1d_facade_matches_cpu(dev):
    sig = _rand(dev, 3, 777) * 255
    for swt in (False, True):
        got = Wavelets(sig, wname="sym8", levels=4, ndim=1, do_swt=swt).run_denoise(25.0)
        want = Wavelets(sig.cpu(), wname="sym8", levels=4, ndim=1, do_swt=swt).run_denoise(25.0)
        _close(got[0].cpu(), want[0])
        assert abs(float(got[1]) - float(want[1])) <= 1e-5 * float(want[1])
        W = Wavelets(sig, wname="sym8", levels=4, ndim=1, do_swt=swt)
        W.forward()
        W.soft_threshold(25.0)
        assert abs(W.norm1() - float(want[1])) <= 1e-5 * float(want[1])
        _close(W.inverse().cpu(), want[0])
        assert isinstance(ops.norm2sq(W.coeffs), torch.Tensor)


def test_1d_cuda_rejects_what_the_kernels_do_not_take(dev):
    w = get_wavelet("db2")
    with pytest.raises(NotImplementedError, match="float64"):
        K1.fwd_level_1d(_rand(dev, 2, 8).double(), w.dec_lo, w.dec_hi)
    with pytest.raises(NotImplementedError, match="float64"):
        swt1d(_rand(dev, 8).double(), w, 1)
    with pytest.raises(ValueError, match="even length"):
        K1.fwd_level_1d(_rand(dev, 2, 7), w.dec_lo, w.dec_hi)
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        K1.swt_fwd_level_1d(_rand(dev, 1, 2, 8), w.dec_lo, w.dec_hi, 1)
    with pytest.raises(ValueError, match="one shape"):
        K1.inv_level_1d(_rand(dev, 2, 8), _rand(dev, 2, 4), w.rec_lo, w.rec_hi)


# ---------------------------------------------------------------------------
# banded-product kernels, the precision tiers
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def _close_tier(got, want, bf16_rtol=2.0 ** -7, rtol=RTOL):
    """float32 outputs within ``rtol``, bf16 ones within ``bf16_rtol``, of
    the output's largest plain value."""
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = float((g.float() - w.float().to(g.device)).abs().max())
        tol = bf16_rtol if w.dtype == BF16 else rtol
        assert err <= tol * float(w.float().abs().max()), (err, w.dtype)


MXU_2D_CASES = [("db7", (1, 256, 256), BF16), ("db7", (3, 70, 134), torch.float32),
                ("db4", (2, 64, 258), BF16), ("db20", (1, 96, 160), torch.float32)]


@pytest.mark.parametrize("scheme", ["b1", "fd", "b2f", "b2d", "b3"])
@pytest.mark.parametrize("wname,shape,in_dtype", MXU_2D_CASES)
def test_mxu_2d_kernels_match_plain(dev, wname, shape, in_dtype, scheme):
    """Kernels 11 and 12 in every scheme, float32 or bf16 in, float32 or
    bf16 details and outputs, on shapes on and off the route rule."""
    w = _wavelet(wname)
    x = (_rand(dev, *shape) * 255).to(in_dtype)
    for det in (torch.float32, BF16):
        _close_tier(M.fwd_level_2d_mxu(x, w.dec_lo, w.dec_hi, scheme, (torch.float32, det)),
                    M.fwd_level_2d_mxu_ref(x, w.dec_lo, w.dec_hi, scheme, (torch.float32, det)))
    m = (shape[0], shape[1] // 2, shape[2] // 2)
    a = _rand(dev, *m) * 255
    for det in (torch.float32, BF16):
        h, v, d = ((_rand(dev, *m, seed=s) * 127).to(det) for s in (1, 2, 3))
        for out in (torch.float32, BF16):
            _close_tier(M.inv_level_2d_mxu(a, h, v, d, w.rec_lo, w.rec_hi, scheme, out),
                        M.inv_level_2d_mxu_ref(a, h, v, d, w.rec_lo, w.rec_hi, scheme, out))


MXU_1D_CASES = [("sym8", 32, 512), ("sym8", 3, 202), ("db2", 2, 6), ("db20", 5, 1000)]


@pytest.mark.parametrize("scheme", ["b1", "fd", "b2f", "b2d", "b3"])
@pytest.mark.parametrize("wname,batch,n", MXU_1D_CASES)
def test_mxu_1d_kernels_match_plain(dev, wname, batch, n, scheme):
    """Kernels 15 and 16, decimated and a-trous (levels 1-4: db2 on 6
    samples reaches a dilation of 8), bf16 and float32 in and out."""
    w = _wavelet(wname)
    for in_dt in (torch.float32, BF16):
        x = (_rand(dev, batch, n) * 255).to(in_dt)
        _close_tier(M1.fwd_level_1d_mxu(x, w.dec_lo, w.dec_hi, scheme, BF16),
                    M1.fwd_level_1d_mxu_ref(x, w.dec_lo, w.dec_hi, scheme, BF16))
        for level in range(1, 5):
            _close_tier(M1.swt_fwd_level_1d_mxu(x, w.dec_lo, w.dec_hi, level, scheme),
                        M1.swt_fwd_level_1d_mxu_ref(x, w.dec_lo, w.dec_hi, level, scheme))
    lo = _rand(dev, batch, n // 2) * 255
    hi = (_rand(dev, batch, n // 2, seed=1) * 127).to(BF16)
    for out in (torch.float32, BF16):
        _close_tier(M1.inv_level_1d_mxu(lo, hi, w.rec_lo, w.rec_hi, scheme, out),
                    M1.inv_level_1d_mxu_ref(lo, hi, w.rec_lo, w.rec_hi, scheme, out))
    slo, shi = _rand(dev, batch, n) * 255, _rand(dev, batch, n, seed=2) * 127
    for level in (1, 3):
        _close_tier(M1.swt_inv_level_1d_mxu(slo, shi, w.rec_lo, w.rec_hi, level, scheme, BF16),
                    M1.swt_inv_level_1d_mxu_ref(slo, shi, w.rec_lo, w.rec_hi, level, scheme,
                                                BF16))


@pytest.mark.parametrize("scheme", ["fd", "b3"])
def test_mxu_1d_kernels_past_shared_memory(dev, scheme):
    """sym8 at level 12 (dilation 2048): the a-trous analysis and
    synthesis, whose consecutive windows would pass the card's shared
    memory, take one residue class."""
    w = get_wavelet("sym8")
    x = _rand(dev, 2, 5000) * 255
    _close_tier(M1.swt_fwd_level_1d_mxu(x, w.dec_lo, w.dec_hi, 12, scheme),
                M1.swt_fwd_level_1d_mxu_ref(x, w.dec_lo, w.dec_hi, 12, scheme))
    lo, hi = _rand(dev, 2, 5000, seed=1), _rand(dev, 2, 5000, seed=2)
    _close_tier(M1.swt_inv_level_1d_mxu(lo, hi, w.rec_lo, w.rec_hi, 12, scheme),
                M1.swt_inv_level_1d_mxu_ref(lo, hi, w.rec_lo, w.rec_hi, 12, scheme))


@pytest.mark.parametrize("tier", ["mixed", "bf16-fast", "bf16-balanced", "bf16-accurate"])
def test_tier_paths_match_cpu(dev, tier):
    """The six entry points under a tier on the card (banded-product kernels
    on the levels the route rule takes) against the CPU (plain versions),
    with the dtype contract and a roundtrip."""
    w7, w8 = get_wavelet("db7"), get_wavelet("sym8")
    dt = BF16 if tier.startswith("bf16-") else torch.float32
    x = (_rand(dev, 512, 512) * 127).to(dt)
    s = (_rand(dev, 32, 1024, seed=1) * 127).to(dt)
    leaves = lambda c: [c.approx, *(sum(c.details, ()) if isinstance(c.details[0], tuple)
                                    else c.details)]
    K.reset_launch_counts()
    for fwd, inv, inp in ((lambda t: dwt2d(t, w7, 3, precision=tier),
                           lambda c: idwt2d(c, w7, (512, 512), precision=tier), x),
                          (lambda t: dwt1d(t, w8, 3, precision=tier),
                           lambda c: idwt1d(c, w8, 1024, precision=tier), s),
                          (lambda t: swt1d(t, w8, 3, precision=tier),
                           lambda c: iswt1d(c, w8, precision=tier), s)):
        c, cc = fwd(inp), fwd(inp.cpu())
        assert c.approx.dtype == torch.float32
        assert all(t.dtype == dt for t in leaves(c)[1:])
        _close_tier([t.cpu() for t in leaves(c)], leaves(cc), 2.0 ** -6, 1e-4)
        y = inv(c)
        assert y.dtype == dt and y.shape == inp.shape
        _close_tier(y.cpu(), inv(cc), 2.0 ** -6, 1e-4)
        assert float((y.float() - inp.float()).abs().max()) < (3.0 if dt == BF16 else 0.05)
    torch.cuda.synchronize()
    launched = {k for k, v in K.LAUNCHES.items() if v}
    assert {"fwd_level_2d_mxu", "inv_level_2d_mxu", "fwd_level_1d_mxu",
            "inv_level_1d_mxu"} <= launched
    assert ("swt_fwd_level_1d_mxu" in launched) == (tier != "mixed")


def test_tier_gradients_match_cpu(dev):
    """Autograd through the banded-product kernels (each backward the paired
    kernel) against the CPU's plain versions."""
    w = get_wavelet("db4")
    x = (_rand(dev, 256, 256) * 10).requires_grad_(True)
    xc = x.detach().cpu().requires_grad_(True)
    wt = _rand(dev, 256, 256, seed=3)
    for t, weight in ((x, wt), (xc, wt.cpu())):
        y = idwt2d(dwt2d(t, w, 2, precision="mixed"), w, (256, 256), precision="mixed")
        (y * weight).sum().backward()
    _close_tier(x.grad.cpu(), xc.grad, rtol=1e-4)
    s = (_rand(dev, 16, 512) * 10).requires_grad_(True)
    sc = s.detach().cpu().requires_grad_(True)
    for t in (s, sc):
        c = swt1d(t.to(BF16), w, 2, precision="bf16-balanced")
        iswt1d(c, w, precision="bf16-balanced").float().sum().backward()
    # the gradient passes through bf16 bands: a tier path's bf16 tolerance
    err = float((s.grad.cpu() - sc.grad).abs().max())
    assert err <= 2.0 ** -6 * float(sc.grad.abs().max()), err


def test_mxu_cuda_rejects_what_the_kernels_do_not_take(dev):
    w = get_wavelet("db2")
    with pytest.raises(NotImplementedError, match="float64"):
        M.fwd_level_2d_mxu(_rand(dev, 1, 8, 8).double(), w.dec_lo, w.dec_hi, "b1")
    with pytest.raises(ValueError, match="even sizes"):
        M.fwd_level_2d_mxu(_rand(dev, 1, 7, 8), w.dec_lo, w.dec_hi, "b1")
    bands = [_rand(dev, 1, 8, 8) for _ in range(4)]
    with pytest.raises(ValueError, match="one dtype"):
        M.inv_level_2d_mxu(bands[0], bands[1].to(BF16), bands[2], bands[3], w.rec_lo, w.rec_hi,
                           "b3")
    with pytest.raises(ValueError, match="float32 low band"):
        M1.inv_level_1d_mxu(_rand(dev, 2, 8).to(BF16), _rand(dev, 2, 8), w.rec_lo, w.rec_hi, "fd")
    with pytest.raises(ValueError, match="even length"):
        M1.fwd_level_1d_mxu(_rand(dev, 2, 7), w.dec_lo, w.dec_hi, "b1")
    with pytest.raises(ValueError, match="one dtype"):
        SM.swt_inv_level_2d_mxu(bands[0], bands[1].to(BF16), bands[2], bands[3], w.rec_lo,
                                w.rec_hi, 1, "fd")
    A, Bc = np.ones((4, 5, 4)), np.ones((5, 4))
    with pytest.raises(ValueError, match="ranks up to 4"):
        NM.ns_fwd_level_2d_mxu(_rand(dev, 1, 8, 8), A, Bc, "b1")


# ---------------------------------------------------------------------------
# kernels 13-14 (a-trous banded products) and 17-18 (rank-r non-separable)
# ---------------------------------------------------------------------------

def _rank3(seed=7, hlen=8):
    """Rank-3 quads from a seed (tests/test_mxu_kernels.py:301-306)."""
    q = np.zeros((4, hlen, hlen))
    g = np.random.default_rng(seed)
    for _ in range(3):
        q += np.einsum("si,j->sij", g.standard_normal((4, hlen)), g.standard_normal(hlen))
    return q / np.abs(q).sum(axis=(1, 2), keepdims=True)


def _pr_quads(seed=3):
    """Rank-3 8 x 8 quads that reconstruct perfectly (as in
    tests/test_torch_nonseparable.py)."""
    w = get_wavelet("db2")
    pad = lambda f, lo, hi: np.concatenate([np.zeros(lo), f, np.zeros(hi)])
    c = lambda f: pad(f, 2, 2)
    quads = lambda lo, hi, hh: np.stack([np.outer(c(lo), c(lo)), np.outer(c(hi), c(lo)),
                                         np.outer(c(lo), c(hi)), np.outer(c(hi), hh)])
    U = np.linalg.qr(np.random.default_rng(seed).standard_normal((4, 4)))[0]
    return (np.einsum("st,tij->sij", U, quads(w.dec_lo, w.dec_hi, pad(w.dec_hi, 0, 4))),
            np.einsum("st,tij->sij", U, quads(w.rec_lo, w.rec_hi, pad(w.rec_hi, 4, 0))))


SWT_MXU_CASES = [("db7", (1, 256, 256), BF16, (1, 2, 3)),
                 ("db7", (2, 37, 53), torch.float32, (1, 6)),
                 ("db20", (1, 64, 128), BF16, (2,)), ("odd5", (1, 23, 29), torch.float32, (3,))]


@pytest.mark.parametrize("scheme", ["b1", "fd", "b2f", "b2d", "b3"])
@pytest.mark.parametrize("wname,shape,in_dtype,levels", SWT_MXU_CASES)
def test_swt_mxu_2d_kernels_match_plain(dev, wname, shape, in_dtype, levels, scheme):
    """Kernels 13 and 14 in every scheme, on and off the route rule (odd
    sizes, a dilation past the image, an odd filter), every threshold."""
    w = _wavelet(wname)
    x = (_rand(dev, *shape) * 255).to(in_dtype)
    a = _rand(dev, *shape, seed=4) * 255
    for level in levels:
        for det in (torch.float32, BF16):
            _close_tier(SM.swt_fwd_level_2d_mxu(x, w.dec_lo, w.dec_hi, level, scheme,
                                                (torch.float32, det)),
                        SM.swt_fwd_level_2d_mxu_ref(x, w.dec_lo, w.dec_hi, level, scheme,
                                                    (torch.float32, det)))
            h, v, d = ((_rand(dev, *shape, seed=s) * 127).to(det) for s in (1, 2, 3))
            for out in (torch.float32, BF16):
                for thr in (None, ("soft", 20.0), ("hard", 20.0), ("garrote", 20.0)):
                    _close_tier(SM.swt_inv_level_2d_mxu(a, h, v, d, w.rec_lo, w.rec_hi, level,
                                                        scheme, out, thr),
                                SM.swt_inv_level_2d_mxu_ref(a, h, v, d, w.rec_lo, w.rec_hi,
                                                            level, scheme, out, thr))


@pytest.mark.parametrize("scheme", ["b1", "fd", "b2f", "b2d", "b3"])
@pytest.mark.parametrize("quads,shape,in_dtype", [("rank3", (1, 128, 256), BF16),
                                                  ("pr", (2, 70, 134), torch.float32)])
def test_ns_mxu_kernels_match_plain(dev, quads, shape, in_dtype, scheme):
    """Kernels 17 and 18 at both strides, in every scheme, on and off the
    route rule."""
    from pdwt_tpu_torch.core.nonseparable import _rank_decomp

    A, Bc = _rank_decomp(_rank3() if quads == "rank3" else _pr_quads()[0])
    x = (_rand(dev, *shape) * 255).to(in_dtype)
    m = (shape[0], shape[1] // 2, shape[2] // 2)
    for det in (torch.float32, BF16):
        _close_tier(NM.ns_fwd_level_2d_mxu(x, A, Bc, scheme, (torch.float32, det)),
                    NM.ns_fwd_level_2d_mxu_ref(x, A, Bc, scheme, (torch.float32, det)))
        for level in (1, 3):
            _close_tier(NM.ns_swt_fwd_level_2d_mxu(x, A, Bc, level, scheme, (torch.float32, det)),
                        NM.ns_swt_fwd_level_2d_mxu_ref(x, A, Bc, level, scheme,
                                                       (torch.float32, det)))
        for out in (torch.float32, BF16):
            bands = [_rand(dev, *m) * 255] + [(_rand(dev, *m, seed=s) * 127).to(det)
                                              for s in (1, 2, 3)]
            _close_tier(NM.ns_inv_level_2d_mxu(*bands, A, Bc, scheme, out),
                        NM.ns_inv_level_2d_mxu_ref(*bands, A, Bc, scheme, out))
            bands = [_rand(dev, *shape) * 255] + [(_rand(dev, *shape, seed=s) * 127).to(det)
                                                  for s in (1, 2, 3)]
            for level in (1, 3):
                _close_tier(NM.ns_swt_inv_level_2d_mxu(*bands, A, Bc, level, scheme, out),
                            NM.ns_swt_inv_level_2d_mxu_ref(*bands, A, Bc, level, scheme, out))


def _exact_or_tier(got, want, scheme):
    """Kernels 14 and 18 keep every output's sums in the plain version's
    order: the b-schemes agree bit for bit, fd within _close_tier."""
    if scheme == "fd":
        _close_tier(got, want)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert float((got.float() - want.float()).abs().max()) == 0.0


INV14_CASES = [("db7", (1, 301, 203), 2, "b1"), ("db7", (1, 301, 203), 3, "b2f"),
               ("db7", (1, 301, 203), 4, "b3"), ("db7", (1, 301, 203), 5, "b2d"),
               ("db7", (1, 301, 203), 3, "fd"), ("db7", (3, 70, 134), 2, "b2f"),
               ("haar", (1, 64, 96), 3, "b1"), ("w42", (1, 200, 150), 1, "b3"),
               ("w42", (1, 200, 150), 2, "fd"), ("db7", (1, 1024, 1024), 3, "b2f")]


@pytest.mark.parametrize("thr", [None, "soft", "hard", "garrote"])
@pytest.mark.parametrize("wname,shape,level,scheme", INV14_CASES)
def test_swt_inv_mxu_redesign_matches_plain(dev, wname, shape, level, scheme, thr):
    """Kernel 14's launch plans: dilations 2-16 on sizes no tile divides
    (consecutive columns and residue classes), a batch of 3, 2 and 42 taps,
    every threshold; the b-schemes bit for bit."""
    w = (make_custom_wavelet("w42", *np.random.default_rng(42).standard_normal((4, 42)))
         if wname == "w42" else _wavelet(wname))
    a = _rand(dev, *shape, seed=4) * 255
    h, v, d = ((_rand(dev, *shape, seed=s) * 127).to(BF16) for s in (1, 2, 3))
    th = None if thr is None else (thr, 20.0)
    for out in (torch.float32, BF16):
        _exact_or_tier(SM.swt_inv_level_2d_mxu(a, h, v, d, w.rec_lo, w.rec_hi, level, scheme,
                                               out, th),
                       SM.swt_inv_level_2d_mxu_ref(a, h, v, d, w.rec_lo, w.rec_hi, level,
                                                   scheme, out, th), scheme)


def _seeded_quads(rank, hlen, seed):
    g = np.random.default_rng(seed)
    return g.standard_normal((4, rank, hlen)) / hlen, g.standard_normal((rank, hlen)) / hlen


INV18_CASES = [((3, 8), (1, 128, 128), None, "b3"), ((3, 8), (1, 64, 64), None, "b2f"),
               ((3, 8), (3, 37, 53), 2, "b3"), ((3, 8), (1, 45, 61), 4, "b1"),
               ((3, 8), (1, 101, 77), 8, "b2d"), ((3, 8), (1, 101, 77), 16, "fd"),
               ((1, 2), (1, 64, 80), None, "b3"), ((4, 40), (1, 100, 70), None, "b2f"),
               ((4, 40), (2, 66, 90), 2, "fd"), ((1, 2), (1, 33, 47), 4, "b1"),
               ((3, 8), (3, 35, 67), None, "b2d"), ((3, 8), (1, 512, 512), None, "b3")]


@pytest.mark.parametrize("rank_hlen,shape,f,scheme", INV18_CASES)
def test_ns_inv_mxu_redesign_matches_plain(dev, rank_hlen, shape, f, scheme):
    """Kernel 18's launch plans: the deep levels' small tiles, dilations
    2-16 on sizes no tile divides, a batch of 3, ranks 1 and 4, 2 and 40
    taps; the b-schemes bit for bit."""
    A, Bc = _seeded_quads(*rank_hlen, seed=sum(shape))
    bands = [_rand(dev, *shape) * 255] + [(_rand(dev, *shape, seed=s) * 127).to(BF16)
                                          for s in (1, 2, 3)]
    for out in (torch.float32, BF16):
        if f is None:
            got = NM.ns_inv_level_2d_mxu(*bands, A, Bc, scheme, out)
            want = NM.ns_inv_level_2d_mxu_ref(*bands, A, Bc, scheme, out)
        else:
            lv = f.bit_length()
            got = NM.ns_swt_inv_level_2d_mxu(*bands, A, Bc, lv, scheme, out)
            want = NM.ns_swt_inv_level_2d_mxu_ref(*bands, A, Bc, lv, scheme, out)
        _exact_or_tier(got, want, scheme)


def test_inverse_refuses_a_bad_launch_plan(dev):
    """The entry points check the plan they are given."""
    from pdwt_tpu_torch.kernels import _launch as L

    w = get_wavelet("db7")
    bands = [_rand(dev, 1, 64, 64) * 255] + [_rand(dev, 1, 64, 64, seed=s) for s in (1, 2, 3)]
    good = SM.swt_inv_launch_plan(1, 64, 64, 14, 1, "b3")
    for bad in (good._replace(smem=good.smem + 16), good._replace(lr=good.lr + 1),
                good._replace(grid=(good.grid[0] + 1, *good.grid[1:])),
                good._replace(threads=48), good._replace(nt=8)):
        keep = SM.swt_inv_launch_plan
        SM.swt_inv_launch_plan = lambda *a, bad=bad: bad
        try:
            with pytest.raises(RuntimeError, match="launch failed"):
                SM.swt_inv_level_2d_mxu(*bands, w.rec_lo, w.rec_hi, 1, "b3")
        finally:
            SM.swt_inv_launch_plan = keep
    assert L.SMEM_LIMIT == 232448


@pytest.mark.parametrize("tier", ["bf16-fast", "bf16-balanced", "bf16-accurate"])
def test_bf16_swt2d_path_matches_cpu(dev, tier):
    """swt2d, iswt2d and the fused iswt2d_denoise in bf16 on the card against
    the CPU: levels 1-3 of 512^2 on kernels 13-14, the dtype contract."""
    w = get_wavelet("db7")
    x = (_rand(dev, 512, 512) * 127).to(BF16)
    K.reset_launch_counts()
    c, cc = swt2d(x, w, 3, precision=tier), swt2d(x.cpu(), w, 3, precision=tier)
    assert c.approx.dtype == torch.float32 and c.details[0][0].dtype == BF16
    _close_tier([c.approx.cpu(), *(t.cpu() for b in c.details for t in b)],
                [cc.approx, *(t for b in cc.details for t in b)], 2.0 ** -6, 1e-4)
    for y, yc in ((iswt2d(c, w, precision=tier), iswt2d(cc, w, precision=tier)),
                  (iswt2d_denoise(c, w, 10.0, precision=tier),
                   iswt2d_denoise(cc, w, 10.0, precision=tier))):
        assert y.dtype == BF16
        _close_tier(y.cpu(), yc, 2.0 ** -6, 1e-4)
    torch.cuda.synchronize()
    assert K.LAUNCHES["swt_fwd_level_2d_mxu"] == 3 and K.LAUNCHES["swt_inv_level_2d_mxu"] == 6


@pytest.mark.parametrize("tier", ["exact", "mixed", "bf16-fast", "bf16-balanced"])
def test_ns_paths_match_cpu(dev, tier):
    """The four non-separable entry points with rank-3 quads on the card
    against the CPU; exact launches no kernel, the tiers launch 17-18 on
    the routed levels; roundtrip."""
    from pdwt_tpu_torch.core import nonseparable as ns

    qf, qi = _pr_quads()
    dt = BF16 if tier.startswith("bf16-") else torch.float32
    x = (_rand(dev, 256, 256) * 127 + 127).to(dt)
    K.reset_launch_counts()
    for fwd, inv in ((lambda t: ns.dwt2d_ns(t, qf, 3, precision=tier),
                      lambda c: ns.idwt2d_ns(c, qi, (256, 256), precision=tier)),
                     (lambda t: ns.swt2d_ns(t, qf, 2, precision=tier),
                      lambda c: ns.iswt2d_ns(c, qi, precision=tier))):
        c, cc = fwd(x), fwd(x.cpu())
        _close_tier([c.approx.cpu(), *(t.cpu() for b in c.details for t in b)],
                    [cc.approx, *(t for b in cc.details for t in b)], 2.0 ** -6, 1e-4)
        y = inv(c)
        assert y.dtype == dt
        _close_tier(y.cpu(), inv(cc), 2.0 ** -6, 1e-4)
        assert float((y.float() - x.float()).abs().max()) < (4.0 if dt == BF16 else 1e-2)
    torch.cuda.synchronize()
    launched = {k for k, v in K.LAUNCHES.items() if v}
    if tier == "exact":
        assert not launched
    elif tier == "mixed":  # the a-trous pair runs exact under mixed
        assert launched == {"ns_fwd_level_2d_mxu", "ns_inv_level_2d_mxu"}
    else:
        assert launched == {"ns_fwd_level_2d_mxu", "ns_inv_level_2d_mxu",
                            "ns_swt_fwd_level_2d_mxu", "ns_swt_inv_level_2d_mxu"}


def test_new_mxu_gradients_match_cpu(dev):
    """The backward passes of kernels 13-14 and 17-18 on the card against
    the CPU's."""
    from pdwt_tpu_torch.core.nonseparable import _rank_decomp

    w = get_wavelet("db4")
    A, Bc = _rank_decomp(_rank3())
    x = (_rand(dev, 1, 128, 256) * 127).to(BF16)
    for f in (lambda t: SM.swt_fwd_level_2d_mxu_ad(t, w.dec_lo, w.dec_hi, 2, "bf16"),
              lambda t: NM.ns_fwd_level_2d_mxu_ad(t, A, Bc, "bf16"),
              lambda t: NM.ns_swt_fwd_level_2d_mxu_ad(t, A, Bc, 1, "bf16")):
        grads = []
        for t in (x, x.cpu()):
            s = t.clone().requires_grad_(True)
            sum(o.float().square().sum() for o in f(s)).backward()
            grads.append(s.grad)
        _close_tier(grads[0].cpu(), grads[1], 2.0 ** -6, 1e-4)


# ---------------------------------------------------------------------------
# kernels 2 and 6, the exact-path inverses redesigned for Hopper's CUDA cores
# ---------------------------------------------------------------------------

def _long_wavelet(name):
    """odd5, haar and named wavelets as _wavelet gives them; "w40" and
    "w128" custom banks of 40 and 128 seeded taps."""
    if name in ("w40", "w128"):
        n = int(name[1:])
        return make_custom_wavelet(name, *np.random.default_rng(n).standard_normal((4, n)))
    return _wavelet(name)


# hlen 2, odd, 14, 40 and 128; 8 x 8 subbands; sizes no tile divides; a
# batch of 3; the main path's two deepest levels
INV2_CASES = [("haar", (1, 8, 8)), ("db7", (1, 8, 8)), ("w128", (3, 8, 8)),
              ("db7", (3, 37, 53)), ("odd5", (2, 35, 67)), ("w40", (1, 70, 38)),
              ("w128", (1, 40, 70)), ("db7", (1, 128, 128)), ("db7", (1, 256, 256))]


@pytest.mark.parametrize("wname,shape", INV2_CASES)
def test_inv_level_redesign_matches_plain(dev, wname, shape):
    """Kernel 2's launch plans: every tile size, filters of 2 to 128 taps
    (odd too), subbands smaller than a tile, a batch of 3."""
    w = _long_wavelet(wname)
    bands = [_rand(dev, *shape, seed=s) * 255 for s in range(4)]
    _close(K.inv_level_2d(*bands, w.rec_lo, w.rec_hi), K.inv_level_2d_ref(*bands, w.rec_lo,
                                                                           w.rec_hi))


# dilations 2-16 on sizes no tile divides (consecutive columns and residue
# classes), a batch of 3, filters of 2, 5, 40 and 128 taps (two band phases)
INV6_CASES = [("db7", (1, 301, 203), 2), ("db7", (1, 301, 203), 3), ("db7", (1, 301, 203), 4),
              ("db7", (1, 301, 203), 5), ("db7", (3, 70, 134), 2), ("haar", (1, 64, 96), 3),
              ("odd5", (1, 23, 29), 3), ("w40", (1, 200, 150), 1), ("w40", (1, 200, 150), 2),
              ("w128", (1, 64, 96), 1)]


@pytest.mark.parametrize("thr", [None, "soft", "hard", "garrote"])
@pytest.mark.parametrize("wname,shape,level", INV6_CASES)
def test_swt_inv_level_redesign_matches_plain(dev, wname, shape, level, thr):
    """Kernel 6 on kernel 14's plans in fd, on float32 subbands, every
    threshold, beta on the host and on the device."""
    w = _long_wavelet(wname)
    a = _rand(dev, *shape, seed=4) * 255
    h, v, d = (_rand(dev, *shape, seed=s) * 127 for s in (1, 2, 3))
    for beta in (20.0, torch.tensor([20.0], device=dev)):
        th = None if thr is None else (thr, beta)
        want = S.swt_inv_level_2d_ref(a, h, v, d, w.rec_lo, w.rec_hi, level,
                                      None if thr is None else (thr, 20.0))
        _close(S.swt_inv_level_2d(a, h, v, d, w.rec_lo, w.rec_hi, level, th), want)


@pytest.mark.parametrize("wname", ["db7", "odd5", "haar"])
def test_redesigned_inverses_as_backwards_match_autograd_through_plain(dev, wname):
    """Kernel 2 is kernel 1's backward with rev(g), kernel 6 kernel 5's with
    2 rev(g), odd filter lengths included."""
    w = _wavelet(wname)
    lin = lambda outs, cts: sum((o * c).sum() for o, c in zip(outs, cts))
    x = (_rand(dev, 2, 38, 54) * 255).requires_grad_(True)
    cts = [_rand(dev, 2, 19, 27, seed=s) for s in range(1, 5)]
    _close(torch.autograd.grad(lin(K.fwd_level_2d_ad(x, w.dec_lo, w.dec_hi), cts), x),
           torch.autograd.grad(lin(K.fwd_level_2d_ref(x, w.dec_lo, w.dec_hi), cts), x))
    cts = [_rand(dev, 2, 38, 54, seed=s) for s in range(1, 5)]
    for level in (1, 3):
        _close(torch.autograd.grad(lin(S.swt_fwd_level_2d_ad(x, w.dec_lo, w.dec_hi, level),
                                       cts), x),
               torch.autograd.grad(lin(S.swt_fwd_level_2d_ref(x, w.dec_lo, w.dec_hi, level),
                                       cts), x))


def test_exact_inverses_refuse_a_bad_launch_plan(dev, monkeypatch):
    """The entry points of kernels 2 and 6 check the plan they are given."""
    w = get_wavelet("db7")
    bands = [_rand(dev, 1, 64, 64, seed=s) for s in range(4)]
    good = K.inv_level_launch_plan(1, 64, 64, 14)
    for bad in (good._replace(smem=good.smem + 16), good._replace(lr=good.lr + 1),
                good._replace(grid=(good.grid[0] + 1, *good.grid[1:])),
                good._replace(threads=48), good._replace(nt=2)):
        monkeypatch.setattr(M, "inv_level_launch_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            K.inv_level_2d(*bands, w.rec_lo, w.rec_hi)
    good = SM.swt_inv_launch_plan(1, 64, 64, 14, 2, "fd")
    for bad in (good._replace(smem=good.smem + 16), good._replace(nt=8),
                good._replace(grid=(good.grid[0], good.grid[1] + 1, 1))):
        monkeypatch.setattr(SM, "swt_inv_launch_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            S.swt_inv_level_2d(*bands, w.rec_lo, w.rec_hi, 2, ("soft", 1.0))


# ---------------------------------------------------------------------------
# kernels 16 and 17, redesigned for Hopper's CUDA cores on band_strip.cuh
# ---------------------------------------------------------------------------

SCHEMES5 = ["b1", "fd", "b2f", "b2d", "b3"]

# the cells' deep levels (short tiles), dilations 2-16 on lengths no tile
# divides, one of thousands (one residue class), a batch of 3, 2 and 128 taps
INV16_CASES = [("sym8", (1024, 256), None), ("sym8", (64, 128), None), ("sym8", (3, 101), 2),
               ("sym8", (3, 101), 4), ("sym8", (35, 777), 8), ("sym8", (35, 777), 16),
               ("haar", (3, 77), None), ("haar", (40, 300), 8), ("w128", (3, 90), None),
               ("w128", (2, 300), 2), ("sym8", (2, 5000), 2048), ("db2", (2, 3), None)]


@pytest.mark.parametrize("scheme", SCHEMES5)
@pytest.mark.parametrize("wname,shape,f", INV16_CASES)
def test_inv1d_mxu_redesign_matches_plain(dev, wname, shape, f, scheme):
    """Kernel 16's launch plans, polyphase (f None) and a-trous, float32 or
    bf16 high band and output; the b-schemes bit for bit."""
    w = _long_wavelet(wname)
    lo = _rand(dev, *shape, seed=4) * 255
    for hdt in (torch.float32, BF16):
        hi = (_rand(dev, *shape, seed=1) * 127).to(hdt)
        for out in (torch.float32, BF16):
            if f is None:
                got = M1.inv_level_1d_mxu(lo, hi, w.rec_lo, w.rec_hi, scheme, out)
                want = M1.inv_level_1d_mxu_ref(lo, hi, w.rec_lo, w.rec_hi, scheme, out)
            else:
                lv = f.bit_length()
                got = M1.swt_inv_level_1d_mxu(lo, hi, w.rec_lo, w.rec_hi, lv, scheme, out)
                want = M1.swt_inv_level_1d_mxu_ref(lo, hi, w.rec_lo, w.rec_hi, lv, scheme, out)
            _exact_or_tier(got, want, scheme)


# stride 2 (f None) at the deep levels' small tiles and off the route;
# stride 1 at dilations 2-16 on sizes no tile divides and one past the image;
# a batch of 3; ranks 1 and 4, 2 and 40 taps
FWD17_CASES = [((3, 8), (1, 256, 256), None), ((3, 8), (1, 128, 128), None),
               ((3, 8), (3, 37, 53), 2), ((3, 8), (1, 45, 61), 4), ((3, 8), (1, 101, 77), 8),
               ((3, 8), (1, 101, 77), 16), ((3, 8), (1, 30, 41), 64),
               ((1, 2), (1, 64, 80), None), ((4, 40), (1, 100, 70), None),
               ((4, 40), (2, 66, 90), 2), ((1, 2), (1, 33, 47), 4), ((3, 8), (3, 70, 134), None),
               ((3, 8), (1, 512, 512), None)]


@pytest.mark.parametrize("scheme", SCHEMES5)
@pytest.mark.parametrize("rank_hlen,shape,f", FWD17_CASES)
def test_ns_fwd_mxu_redesign_matches_plain(dev, rank_hlen, shape, f, scheme):
    """Kernel 17's launch plans at both strides, float32 or bf16 in and
    details; the b-schemes bit for bit."""
    A, Bc = _seeded_quads(*rank_hlen, seed=sum(shape))
    for in_dt in (torch.float32, BF16):
        x = (_rand(dev, *shape) * 255).to(in_dt)
        for det in (torch.float32, BF16):
            if f is None:
                got = NM.ns_fwd_level_2d_mxu(x, A, Bc, scheme, (torch.float32, det))
                want = NM.ns_fwd_level_2d_mxu_ref(x, A, Bc, scheme, (torch.float32, det))
            else:
                lv = f.bit_length()
                got = NM.ns_swt_fwd_level_2d_mxu(x, A, Bc, lv, scheme, (torch.float32, det))
                want = NM.ns_swt_fwd_level_2d_mxu_ref(x, A, Bc, lv, scheme,
                                                      (torch.float32, det))
            for g, wt in zip(got, want):
                _exact_or_tier(g, wt, scheme)


def test_redesigned_16_17_refuse_a_bad_launch_plan(dev, monkeypatch):
    """The entry points of kernels 16 and 17 check the plan they are given."""
    from pdwt_tpu_torch.core.nonseparable import _rank_decomp

    w = get_wavelet("sym8")
    lo, hi = _rand(dev, 32, 256), _rand(dev, 32, 256, seed=1)
    for f, dec in ((1, True), (2, False)):
        good = M1.inv1d_launch_plan(32, 256, 16, f, "b3", dec)
        for bad in (good._replace(smem=good.smem + 16), good._replace(lc=good.lc + 1),
                    good._replace(grid=(good.grid[0] + 1, *good.grid[1:])),
                    good._replace(threads=48), good._replace(nt=4),
                    good._replace(grid=(*good.grid[:2], 2))):
            monkeypatch.setattr(M1, "inv1d_launch_plan", lambda *a, bad=bad: bad)
            with pytest.raises(RuntimeError, match="launch failed"):
                if dec:
                    M1.inv_level_1d_mxu(lo, hi, w.rec_lo, w.rec_hi, "b3")
                else:
                    M1.swt_inv_level_1d_mxu(lo, hi, w.rec_lo, w.rec_hi, 2, "b3")
    A, Bc = _rank_decomp(_rank3())
    x = _rand(dev, 1, 64, 64)
    for stride, f in ((2, 1), (1, 2)):
        good = NM.ns_fwd_launch_plan(1, 64, 64, 8, 3, stride, f, "b3")
        for bad in (good._replace(smem=good.smem + 16), good._replace(lr=good.lr + 1),
                    good._replace(grid=(good.grid[0] + 1, *good.grid[1:])),
                    good._replace(threads=48), good._replace(nt=4),
                    good._replace(gc=3)):
            monkeypatch.setattr(NM, "ns_fwd_launch_plan", lambda *a, bad=bad: bad)
            with pytest.raises(RuntimeError, match="launch failed"):
                if stride == 2:
                    NM.ns_fwd_level_2d_mxu(x, A, Bc, "b3")
                else:
                    NM.ns_swt_fwd_level_2d_mxu(x, A, Bc, 2, "b3")


def _grads_and_launches(fn, inputs, name):
    """Gradients of sum(outputs^2) on the card and the CPU, and the launches
    of kernel ``name`` during the card's backward pass."""
    grads = []
    for dv in ("cuda", "cpu"):
        ins = [t.detach().to(dv).requires_grad_(True) for t in inputs]
        outs = fn(*ins)
        loss = sum(o.float().square().sum() for o in (outs if isinstance(outs, tuple)
                                                       else (outs,)))
        if dv == "cuda":
            K.reset_launch_counts()
        loss.backward()
        if dv == "cuda":
            torch.cuda.synchronize()
            launched = K.LAUNCHES[name]
        grads.append([t.grad for t in ins])
    return grads, launched


def test_gradients_flow_through_kernels_15_to_18(dev):
    """Each backward of the 1D and rank-r banded-product pairs is the
    paired kernel: 15 <-> 16 (decimated and a-trous), 17 <-> 18 (both
    strides); gradients on the card against the CPU's."""
    from pdwt_tpu_torch.core.nonseparable import _rank_decomp

    w = get_wavelet("sym8")
    A, Bc = _rank_decomp(_rank3())
    s = _rand(dev, 32, 512) * 10
    b1 = [_rand(dev, 32, 256) * 10, _rand(dev, 32, 256, seed=1) * 10]
    b2 = [_rand(dev, 32, 512) * 10, _rand(dev, 32, 512, seed=1) * 10]
    x = _rand(dev, 1, 64, 128) * 10
    q = [_rand(dev, 1, 32, 64, seed=k) * 10 for k in range(4)]
    q1 = [_rand(dev, 1, 64, 128, seed=k) * 10 for k in range(4)]
    cases = [
        (lambda t: M1.fwd_level_1d_mxu_ad(t, w.dec_lo, w.dec_hi, "mixed"), [s],
         "inv_level_1d_mxu"),
        (lambda a, b: M1.inv_level_1d_mxu_ad(a, b, w.rec_lo, w.rec_hi, "mixed"), b1,
         "fwd_level_1d_mxu"),
        (lambda t: M1.swt_fwd_level_1d_mxu_ad(t, w.dec_lo, w.dec_hi, 2, "mixed"), [s],
         "swt_inv_level_1d_mxu"),
        (lambda a, b: M1.swt_inv_level_1d_mxu_ad(a, b, w.rec_lo, w.rec_hi, 2, "mixed"), b2,
         "swt_fwd_level_1d_mxu"),
        (lambda t: NM.ns_fwd_level_2d_mxu_ad(t, A, Bc, "mixed"), [x], "ns_inv_level_2d_mxu"),
        (lambda *b: NM.ns_inv_level_2d_mxu_ad(*b, A, Bc, "mixed"), q, "ns_fwd_level_2d_mxu"),
        (lambda t: NM.ns_swt_fwd_level_2d_mxu_ad(t, A, Bc, 2, "mixed"), [x],
         "ns_swt_inv_level_2d_mxu"),
        (lambda *b: NM.ns_swt_inv_level_2d_mxu_ad(*b, A, Bc, 2, "mixed"), q1,
         "ns_swt_fwd_level_2d_mxu")]
    for fn, inputs, name in cases:
        (gd, gc), launched = _grads_and_launches(fn, inputs, name)
        assert launched >= 1, name
        for g, gcpu in zip(gd, gc):
            _close_tier(g.cpu(), gcpu, 2.0 ** -6, 1e-4)


# ---------------------------------------------------------------------------
# kernels 13 and 15, redesigned for Hopper's CUDA cores on band_strip.cuh
# ---------------------------------------------------------------------------

# the TI tier cell's levels, the small tiles of small images, dilations
# 2-16 on odd sizes no tile divides and one past the image, a batch of 3,
# 2 and 40 taps
FWD13_CASES = [("db7", (1, 1024, 1024), 1), ("db7", (1, 1024, 1024), 3),
               ("db7", (1, 128, 128), 1), ("db7", (1, 64, 64), 3), ("db7", (1, 301, 203), 2),
               ("db7", (1, 301, 203), 4), ("db7", (1, 45, 61), 5), ("db7", (1, 37, 53), 7),
               ("db7", (3, 70, 134), 2), ("haar", (1, 64, 96), 3), ("w40", (1, 200, 150), 1),
               ("w40", (2, 66, 90), 2)]


@pytest.mark.parametrize("scheme", SCHEMES5)
@pytest.mark.parametrize("wname,shape,level", FWD13_CASES)
def test_swt_fwd_mxu_redesign_matches_plain(dev, wname, shape, level, scheme):
    """Kernel 13's launch plans, float32 or bf16 in and details; the
    b-schemes bit for bit."""
    w = _long_wavelet(wname)
    for in_dt in (torch.float32, BF16):
        x = (_rand(dev, *shape) * 255).to(in_dt)
        for det in (torch.float32, BF16):
            got = SM.swt_fwd_level_2d_mxu(x, w.dec_lo, w.dec_hi, level, scheme,
                                          (torch.float32, det))
            want = SM.swt_fwd_level_2d_mxu_ref(x, w.dec_lo, w.dec_hi, level, scheme,
                                               (torch.float32, det))
            for g, wt in zip(got, want):
                _exact_or_tier(g, wt, scheme)


# the cells' levels (decimated 4096 down to 512 samples, a-trous levels 1-4
# of 4096), the deep levels' short tiles, dilations 2-16 on lengths no tile
# divides, one of thousands (one residue class), a batch of 3, 2 and 40 taps
FWD15_CASES = [("sym8", (1024, 4096), None), ("sym8", (1024, 512), None),
               ("sym8", (1024, 4096), 1), ("sym8", (1024, 4096), 8), ("sym8", (64, 256), None),
               ("sym8", (3, 101), 2), ("sym8", (3, 101), 4), ("sym8", (35, 777), 16),
               ("sym8", (2, 5000), 2048), ("haar", (3, 78), None), ("haar", (40, 300), 8),
               ("w40", (3, 90), None), ("w40", (2, 301), 2), ("db2", (2, 6), 8)]


@pytest.mark.parametrize("scheme", SCHEMES5)
@pytest.mark.parametrize("wname,shape,f", FWD15_CASES)
def test_fwd1d_mxu_redesign_matches_plain(dev, wname, shape, f, scheme):
    """Kernel 15's launch plans, decimated (f None) and a-trous, float32 or
    bf16 in and high band; the b-schemes bit for bit."""
    w = _long_wavelet(wname)
    for in_dt in (torch.float32, BF16):
        x = (_rand(dev, *shape) * 255).to(in_dt)
        for hdt in (torch.float32, BF16):
            if f is None:
                got = M1.fwd_level_1d_mxu(x, w.dec_lo, w.dec_hi, scheme, hdt)
                want = M1.fwd_level_1d_mxu_ref(x, w.dec_lo, w.dec_hi, scheme, hdt)
            else:
                lv = f.bit_length()
                got = M1.swt_fwd_level_1d_mxu(x, w.dec_lo, w.dec_hi, lv, scheme, hdt)
                want = M1.swt_fwd_level_1d_mxu_ref(x, w.dec_lo, w.dec_hi, lv, scheme, hdt)
            for g, wt in zip(got, want):
                _exact_or_tier(g, wt, scheme)


def test_redesigned_13_15_refuse_a_bad_launch_plan(dev, monkeypatch):
    """The entry points of kernels 13 and 15 check the plan they are given."""
    w7, w8 = get_wavelet("db7"), get_wavelet("sym8")
    x = _rand(dev, 1, 64, 64)
    for f in (1, 4):
        good = SM.swt_fwd_launch_plan(1, 64, 64, 14, f, "b3")
        for bad in (good._replace(smem=good.smem + 16), good._replace(lr=good.lr + 1),
                    good._replace(grid=(good.grid[0] + 1, *good.grid[1:])),
                    good._replace(threads=48), good._replace(nt=4), good._replace(gc=3),
                    good._replace(lc=good.lc + 8)):
            monkeypatch.setattr(SM, "swt_fwd_launch_plan", lambda *a, bad=bad: bad)
            with pytest.raises(RuntimeError, match="launch failed"):
                SM.swt_fwd_level_2d_mxu(x, w7.dec_lo, w7.dec_hi, f.bit_length(), "b3")
    s = _rand(dev, 32, 512)
    for f, dec in ((1, True), (2, False)):
        good = M1.fwd1d_launch_plan(32, 512, 16, f, "b3", dec)
        for bad in (good._replace(smem=good.smem + 16), good._replace(lc=good.lc + 1),
                    good._replace(grid=(good.grid[0] + 1, *good.grid[1:])),
                    good._replace(threads=48), good._replace(nt=12),
                    good._replace(grid=(*good.grid[:2], 2))):
            monkeypatch.setattr(M1, "fwd1d_launch_plan", lambda *a, bad=bad: bad)
            with pytest.raises(RuntimeError, match="launch failed"):
                if dec:
                    M1.fwd_level_1d_mxu(s, w8.dec_lo, w8.dec_hi, "b3")
                else:
                    M1.swt_fwd_level_1d_mxu(s, w8.dec_lo, w8.dec_hi, 2, "b3")


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
def test_gradients_flow_through_kernels_13_and_15(dev, mode):
    """Under both MXU modes: the forwards 13 and 15 and, in the backwards
    of their partners 14 and 16 (decimated and a-trous, the fused denoise
    too), the new kernels themselves; gradients on the card against the
    CPU's, and the launches of each backward's kernel.  Under ``bf16`` a
    float32 gradient is held to 2^-6 too: an fd pass's FMA can flip one
    bf16 rounding of a forward output, and the gradient carries it."""
    w7, w8 = get_wavelet("db7"), get_wavelet("sym8")
    dt = BF16 if mode == "bf16" else torch.float32
    x = (_rand(dev, 1, 64, 96) * 10).to(dt)
    q = [_rand(dev, 1, 64, 96, seed=k) * 10 for k in range(4)]
    s = (_rand(dev, 32, 512) * 10).to(dt)
    b1 = [_rand(dev, 32, 256) * 10, _rand(dev, 32, 256, seed=1) * 10]
    b2 = [_rand(dev, 32, 512) * 10, _rand(dev, 32, 512, seed=1) * 10]
    cases = [
        (lambda t: SM.swt_fwd_level_2d_mxu_ad(t, w7.dec_lo, w7.dec_hi, 2, mode), [x],
         "swt_inv_level_2d_mxu"),
        (lambda *b: SM.swt_inv_level_2d_mxu_ad(*b, w7.rec_lo, w7.rec_hi, 2, mode), q,
         "swt_fwd_level_2d_mxu"),
        (lambda *b: SM.swt_inv_level_2d_mxu_denoise_ad(*b, 3.0, w7.rec_lo, w7.rec_hi, 1, mode,
                                                       "soft"), q, "swt_fwd_level_2d_mxu"),
        (lambda t: M1.fwd_level_1d_mxu_ad(t, w8.dec_lo, w8.dec_hi, mode), [s],
         "inv_level_1d_mxu"),
        (lambda a, b: M1.inv_level_1d_mxu_ad(a, b, w8.rec_lo, w8.rec_hi, mode), b1,
         "fwd_level_1d_mxu"),
        (lambda t: M1.swt_fwd_level_1d_mxu_ad(t, w8.dec_lo, w8.dec_hi, 3, mode), [s],
         "swt_inv_level_1d_mxu"),
        (lambda a, b: M1.swt_inv_level_1d_mxu_ad(a, b, w8.rec_lo, w8.rec_hi, 3, mode), b2,
         "swt_fwd_level_1d_mxu")]
    for fn, inputs, name in cases:
        (gd, gc), launched = _grads_and_launches(fn, inputs, name)
        assert launched >= 1, name
        for g, gcpu in zip(gd, gc):
            _close_tier(g.cpu(), gcpu, 2.0 ** -6, 2.0 ** -6 if mode == "bf16" else 1e-4)


# ---------------------------------------------------------------------------
# kernels 12 and 10, moved onto kernel 2's and kernel 16's strip bodies
# ---------------------------------------------------------------------------

# 37 x 53 and 1 x 1 subbands, a batch of 3, 2, 4, 14 and 40 taps, the tier
# path's deepest level
INV12_CASES = [("db7", (1, 128, 128)), ("db7", (3, 37, 53)), ("haar", (3, 1, 1)),
               ("w40", (1, 37, 53)), ("db2", (2, 70, 134)), ("w40", (1, 1, 1))]


@pytest.mark.parametrize("det,out", [(torch.float32, torch.float32), (BF16, BF16),
                                     (torch.float32, BF16), (BF16, torch.float32)])
@pytest.mark.parametrize("scheme", SCHEMES5)
@pytest.mark.parametrize("wname,shape", INV12_CASES)
def test_inv_level_2d_mxu_redesign_matches_plain(dev, wname, shape, scheme, det, out):
    """Kernel 12 on kernel 2's body: b-schemes bit for bit, fd within
    _close_tier, float32 and bf16 details and outputs."""
    w = _long_wavelet(wname)
    a = _rand(dev, *shape, seed=4) * 255
    h, v, d = ((_rand(dev, *shape, seed=s) * 127).to(det) for s in (1, 2, 3))
    _exact_or_tier(M.inv_level_2d_mxu(a, h, v, d, w.rec_lo, w.rec_hi, scheme, out),
                   M.inv_level_2d_mxu_ref(a, h, v, d, w.rec_lo, w.rec_hi, scheme, out), scheme)


# 3 (odd), 16, 64 and 128 taps; dilations past the signal; 1 and 7 samples;
# a batch of 33
INV10_CASES = [("odd3", (33, 7), 1), ("odd3", (33, 7), 4), ("w64", (2, 300), 3),
               ("w128", (3, 90), 2), ("w128", (1, 7), 13), ("db2", (33, 1), 3),
               ("sym8", (1024, 4096), 4), ("sym8", (35, 777), 5)]


@pytest.mark.parametrize("wname,shape,level", INV10_CASES)
def test_swt_inv_level_1d_redesign_matches_plain(dev, wname, shape, level):
    """Kernel 10 on kernel 16's a-trous body in fd, on float32 bands."""
    if wname in ("odd3", "w64"):
        n = 3 if wname == "odd3" else 64
        w = make_custom_wavelet(wname, *np.random.default_rng(n).standard_normal((4, n)))
    else:
        w = _long_wavelet(wname)
    lo, hi = _rand(dev, *shape), _rand(dev, *shape, seed=1)
    _close_joint([K1.swt_inv_level_1d(lo, hi, w.rec_lo, w.rec_hi, level)],
                 [K1.swt_inv_level_1d_ref(lo, hi, w.rec_lo, w.rec_hi, level)])


def test_redesigned_12_10_refuse_a_bad_launch_plan(dev, monkeypatch):
    """The entry points of kernels 12 and 10 check the plan they are given."""
    w7, w8 = get_wavelet("db7"), get_wavelet("sym8")
    bands = [_rand(dev, 1, 64, 64, seed=s) for s in range(4)]
    good = K.inv_level_launch_plan(1, 64, 64, 14, "b3")
    for bad in (good._replace(smem=good.smem + 16), good._replace(lr=good.lr + 2),
                good._replace(grid=(good.grid[0] + 1, *good.grid[1:])),
                good._replace(threads=48), good._replace(nt=2),
                K.inv_level_launch_plan(1, 64, 64, 14, "fd")):
        monkeypatch.setattr(M, "inv_level_launch_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            M.inv_level_2d_mxu(*bands, w7.rec_lo, w7.rec_hi, "b3")
    lo, hi = _rand(dev, 32, 256), _rand(dev, 32, 256, seed=1)
    good = M1.inv1d_launch_plan(32, 256, 16, 2, "fd", False)
    for bad in (good._replace(smem=good.smem + 16), good._replace(lc=good.lc + 1),
                good._replace(grid=(good.grid[0] + 1, *good.grid[1:])),
                good._replace(threads=48), good._replace(nt=4), good._replace(gc=3)):
        monkeypatch.setattr(M1, "inv1d_launch_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            K1.swt_inv_level_1d(lo, hi, w8.rec_lo, w8.rec_hi, 2)


# ---------------------------------------------------------------------------
# kernels 11 and 9, moved onto kernel 13's and kernel 15's strip bodies
# ---------------------------------------------------------------------------

# the tier DWT's first and last levels (2048^2 and 256^2 images), odd
# subband sizes, 1 x 1 subbands, a batch of 3, 2, 4, 5 (odd), 14, 40 and
# 128 taps
FWD11_CASES = [("db7", (1, 2048, 2048)), ("db7", (1, 256, 256)), ("db7", (3, 74, 106)),
               ("haar", (3, 2, 2)), ("db2", (2, 70, 134)), ("odd5", (1, 202, 154)),
               ("w40", (1, 140, 76)), ("w128", (1, 40, 70))]


@pytest.mark.parametrize("scheme", SCHEMES5)
@pytest.mark.parametrize("wname,shape", FWD11_CASES)
def test_fwd_level_2d_mxu_redesign_matches_plain(dev, wname, shape, scheme):
    """Kernel 11 on kernel 13's body at output step 2: b-schemes bit for
    bit, fd within _close_tier, float32 and bf16 input and details."""
    w = _long_wavelet(wname)
    for in_dt in (torch.float32, BF16):
        x = (_rand(dev, *shape) * 255).to(in_dt)
        for det in (torch.float32, BF16):
            got = M.fwd_level_2d_mxu(x, w.dec_lo, w.dec_hi, scheme, (torch.float32, det))
            want = M.fwd_level_2d_mxu_ref(x, w.dec_lo, w.dec_hi, scheme, (torch.float32, det))
            for g, wt in zip(got, want):
                _exact_or_tier(g, wt, scheme)


# 3 (odd), 16, 64 and 128 taps; dilations past the signal; 1 and 7 samples;
# a batch of 33; the exact 1D SWT cell's levels
FWD9_CASES = [("odd3", (33, 7), 1), ("odd3", (33, 7), 4), ("w64", (2, 300), 3),
              ("w128", (3, 90), 2), ("w128", (1, 7), 13), ("db2", (33, 1), 3),
              ("sym8", (1024, 4096), 1), ("sym8", (1024, 4096), 4), ("sym8", (35, 777), 5),
              ("sym8", (2, 5000), 12)]


@pytest.mark.parametrize("wname,shape,level", FWD9_CASES)
def test_swt_fwd_level_1d_redesign_matches_plain(dev, wname, shape, level):
    """Kernel 9 on kernel 15's a-trous body in fd, on a float32 input."""
    if wname in ("odd3", "w64"):
        n = 3 if wname == "odd3" else 64
        w = make_custom_wavelet(wname, *np.random.default_rng(n).standard_normal((4, n)))
    else:
        w = _long_wavelet(wname)
    x = _rand(dev, *shape)
    _close_joint(K1.swt_fwd_level_1d(x, w.dec_lo, w.dec_hi, level),
                 K1.swt_fwd_level_1d_ref(x, w.dec_lo, w.dec_hi, level))


def test_redesigned_11_9_refuse_a_bad_launch_plan(dev, monkeypatch):
    """The entry points of kernels 11 and 9 check the plan they are given
    (kernel 13's plan at step 1 is not one of 11's)."""
    w7, w8 = get_wavelet("db7"), get_wavelet("sym8")
    x = _rand(dev, 1, 128, 128)
    good = M.fwd_launch_plan(1, 128, 128, 14, "b3")
    for bad in (good._replace(smem=good.smem + 16), good._replace(lr=good.lr + 1),
                good._replace(grid=(good.grid[0] + 1, *good.grid[1:])),
                good._replace(threads=48), good._replace(nt=4), good._replace(gc=2),
                good._replace(lc=good.lc + 8), SM.swt_fwd_launch_plan(1, 128, 128, 14, 1, "b3")):
        monkeypatch.setattr(M, "fwd_launch_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            M.fwd_level_2d_mxu(x, w7.dec_lo, w7.dec_hi, "b3")
    s = _rand(dev, 32, 512)
    good = M1.fwd1d_launch_plan(32, 512, 16, 2, "fd", False)
    for bad in (good._replace(smem=good.smem + 16), good._replace(lc=good.lc + 1),
                good._replace(grid=(good.grid[0] + 1, *good.grid[1:])),
                good._replace(threads=48), good._replace(nt=12), good._replace(gc=3)):
        monkeypatch.setattr(M1, "fwd1d_launch_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            K1.swt_fwd_level_1d(s, w8.dec_lo, w8.dec_hi, 2)


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
def test_gradients_flow_through_kernels_11_and_9(dev, mode):
    """11 forward and as the backward of 12 in both MXU modes, 9 forward
    and as the backward of 10 (exact, float32): gradients on the card
    against the CPU's, and the launches of each backward's kernel.  Under
    ``bf16`` a float32 gradient of 11 and 12 is held to 2^-6 too (an fd
    pass's FMA can flip one bf16 rounding of a forward output)."""
    w7, w8 = get_wavelet("db7"), get_wavelet("sym8")
    dt = BF16 if mode == "bf16" else torch.float32
    x = (_rand(dev, 1, 64, 256) * 10).to(dt)
    q = [_rand(dev, 1, 32, 128, seed=k) * 10 for k in range(4)]
    s = _rand(dev, 32, 512) * 10
    b = [_rand(dev, 32, 512) * 10, _rand(dev, 32, 512, seed=1) * 10]
    cases = [
        (lambda t: M.fwd_level_2d_mxu_ad(t, w7.dec_lo, w7.dec_hi, mode), [x],
         "inv_level_2d_mxu"),
        (lambda *u: M.inv_level_2d_mxu_ad(*u, w7.rec_lo, w7.rec_hi, mode), q,
         "fwd_level_2d_mxu"),
        (lambda t: K1.swt_fwd_level_1d_ad(t, w8.dec_lo, w8.dec_hi, 3), [s], "swt_inv_level_1d"),
        (lambda lo, hi: K1.swt_inv_level_1d_ad(lo, hi, w8.rec_lo, w8.rec_hi, 3), b,
         "swt_fwd_level_1d")]
    for i, (fn, inputs, name) in enumerate(cases):
        (gd, gc), launched = _grads_and_launches(fn, inputs, name)
        assert launched >= 1, name
        for g, gcpu in zip(gd, gc):
            _close_tier(g.cpu(), gcpu, 2.0 ** -6, 2.0 ** -6 if mode == "bf16" and i < 2 else 1e-4)


# ---------------------------------------------------------------------------
# kernels 8 and 5, moved onto kernel 16's polyphase body and kernel 13's body
# ---------------------------------------------------------------------------

def _bank(name):
    """_long_wavelet's banks, and custom banks of 3 and 64 seeded taps."""
    if name in ("odd3", "w64"):
        n = 3 if name == "odd3" else 64
        return make_custom_wavelet(name, *np.random.default_rng(n).standard_normal((4, n)))
    return _long_wavelet(name)


# 2, 3 (odd), 5 (odd), 16, 64 and 128 taps; bands of 1 and 7 samples; a batch
# of 33 and one past gridDim.y; the batched 1D cell's first and last levels
INV8_CASES = [("odd3", (33, 7)), ("w64", (2, 300)), ("w128", (3, 90)), ("w128", (1, 7)),
              ("db2", (33, 1)), ("haar", (5, 1)), ("odd5", (3, 15)), ("sym8", (1024, 2048)),
              ("sym8", (1024, 256)), ("sym8", (70000, 32)), ("sym8", (1, 1 << 21))]


@pytest.mark.parametrize("wname,shape", INV8_CASES)
def test_inv_level_1d_redesign_matches_plain(dev, wname, shape):
    """Kernel 8 on kernel 16's polyphase body in fd, on float32 bands."""
    w = _bank(wname)
    lo, hi = _rand(dev, *shape), _rand(dev, *shape, seed=1)
    _close(K1.inv_level_1d(lo, hi, w.rec_lo, w.rec_hi), K1.inv_level_1d_ref(lo, hi, w.rec_lo,
                                                                             w.rec_hi))


# 1 x 1, 8 x 8, odd and prime sizes, a batch of 3, 2, 3, 5, 14, 40 and 128
# taps, dilations past the image (up to 4096), the TI cell's levels
FWD5_CASES = [("haar", (1, 1, 1), 1), ("db7", (1, 8, 8), 6), ("w128", (3, 8, 8), 1),
              ("w40", (1, 200, 150), 2), ("odd3", (1, 37, 53), 4), ("odd5", (3, 31, 17), 3),
              ("db7", (1, 301, 203), 5), ("w128", (1, 7, 13), 13), ("db2", (2, 31, 17), 12),
              ("db7", (1, 1024, 1024), 1), ("db7", (1, 1024, 1024), 3)]


@pytest.mark.parametrize("wname,shape,level", FWD5_CASES)
def test_swt_fwd_level_2d_redesign_matches_plain(dev, wname, shape, level):
    """Kernel 5 on kernel 13's body in fd (rows first) against its plain
    version (columns first), relative to the call's largest output."""
    w = _bank(wname)
    x = _rand(dev, *shape) * 255
    _close_joint(S.swt_fwd_level_2d(x, w.dec_lo, w.dec_hi, level),
                 S.swt_fwd_level_2d_ref(x, w.dec_lo, w.dec_hi, level))


def test_redesigned_8_5_refuse_a_bad_launch_plan(dev, monkeypatch):
    """The entry points of kernels 8 and 5 check the plan they are given (an
    a-trous plan is not one of 8's, a b3 plan not one of 5's)."""
    w7, w8 = get_wavelet("db7"), get_wavelet("sym8")
    lo, hi = _rand(dev, 32, 256), _rand(dev, 32, 256, seed=1)
    good = M1.inv1d_launch_plan(32, 256, 16, 1, "fd", True)
    for bad in (good._replace(smem=good.smem + 16), good._replace(lc=good.lc + 1),
                good._replace(grid=(good.grid[0] + 1, *good.grid[1:])),
                good._replace(threads=48), good._replace(nt=4),
                M1.inv1d_launch_plan(32, 256, 16, 1, "fd", False)):
        monkeypatch.setattr(M1, "inv1d_launch_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            K1.inv_level_1d(lo, hi, w8.rec_lo, w8.rec_hi)
    x = _rand(dev, 1, 128, 128)
    good = SM.swt_fwd_launch_plan(1, 128, 128, 14, 2, "fd")
    for bad in (good._replace(smem=good.smem + 16), good._replace(lr=good.lr + 1),
                good._replace(grid=(good.grid[0], good.grid[1] + 1, 1)),
                good._replace(threads=48), good._replace(nt=8), good._replace(gc=3),
                SM.swt_fwd_launch_plan(1, 128, 128, 14, 2, "b3")):
        monkeypatch.setattr(SM, "swt_fwd_launch_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            S.swt_fwd_level_2d(x, w7.dec_lo, w7.dec_hi, 2)


@pytest.mark.parametrize("wname", ["db7", "odd5"])
def test_gradients_flow_through_kernels_8_and_5(dev, wname):
    """8 forward and as the backward of 7; 5 forward and as the backward of
    6 and of the fused denoise (soft, beta a tensor): gradients on the card
    against the CPU's, and the launches of each backward's kernel."""
    w = _wavelet(wname)
    s = _rand(dev, 33, 130) * 10
    b = [_rand(dev, 33, 65, seed=k) * 10 for k in range(2)]
    x = _rand(dev, 2, 37, 53) * 10
    q = [_rand(dev, 2, 37, 53, seed=k) * 10 for k in range(4)]
    beta = torch.tensor(3.0)
    cases = [
        (lambda t: K1.fwd_level_1d_ad(t, w.dec_lo, w.dec_hi), [s], "inv_level_1d"),
        (lambda lo, hi: K1.inv_level_1d_ad(lo, hi, w.rec_lo, w.rec_hi), b, "fwd_level_1d"),
        (lambda t: S.swt_fwd_level_2d_ad(t, w.dec_lo, w.dec_hi, 2), [x], "swt_inv_level_2d"),
        (lambda *u: S.swt_inv_level_2d_ad(*u, w.rec_lo, w.rec_hi, 2), q, "swt_fwd_level_2d"),
        (lambda *u: S.swt_inv_level_2d_denoise_ad(*u, beta.to(u[0].device), w.rec_lo,
                                                  w.rec_hi, 3, "soft"), q, "swt_fwd_level_2d")]
    for fn, inputs, name in cases:
        (gd, gc), launched = _grads_and_launches(fn, inputs, name)
        assert launched == 1, name
        for g, gcpu in zip(gd, gc):
            _close_tier(g.cpu(), gcpu, rtol=1e-4)


def test_nonfinite_inputs_of_kernels_8_and_5_never_turn_finite(dev):
    """An inf sample: every output the plain version gives as inf or NaN is
    inf or NaN from the kernel too, and every output the kernel gives as
    finite equals the plain one.  (The zero taps that pad a parity's table
    or a chunk multiply real samples, so the kernels may give NaN where the
    plain version is finite: ROADMAP, section 3.)  Kernels 1 and 7, which
    run the bodies of 13 and 15 on zero-padded taps too, likewise, and the
    tails 3 and 4, which run the bodies of 1 and 2 (two levels each)."""
    w7, w8 = get_wavelet("db7"), get_wavelet("sym8")
    lo, hi = _rand(dev, 33, 200), _rand(dev, 33, 200, seed=1)
    hi[3, 100] = float("inf")
    x = _rand(dev, 1, 64, 96) * 255
    x[0, 30, 40] = float("inf")
    s = _rand(dev, 33, 400)
    s[3, 200] = float("inf")
    ta, tdets = K.fwd_tail_2d(x, w7.dec_lo, w7.dec_hi, 2)
    ra, rdets = K.fwd_tail_2d_ref(x, w7.dec_lo, w7.dec_hi, 2)
    ia = _rand(dev, 1, 16, 24) * 255
    ibands = [tuple(_rand(dev, 1, 16 << k, 24 << k, seed=3 * k + j) * 255 for j in range(3))
              for k in range(2)]
    ibands[0][0][0, 5, 7] = float("inf")
    for got, want in ((K1.inv_level_1d(lo, hi, w8.rec_lo, w8.rec_hi),
                       K1.inv_level_1d_ref(lo, hi, w8.rec_lo, w8.rec_hi)),
                      *zip([ta, *sum(tdets, ())], [ra, *sum(rdets, ())]),
                      (K.inv_tail_2d(ia, ibands, w7.rec_lo, w7.rec_hi),
                       K.inv_tail_2d_ref(ia, ibands, w7.rec_lo, w7.rec_hi)),
                      *zip(S.swt_fwd_level_2d(x, w7.dec_lo, w7.dec_hi, 2),
                           S.swt_fwd_level_2d_ref(x, w7.dec_lo, w7.dec_hi, 2)),
                      *zip(K.fwd_level_2d(x, w7.dec_lo, w7.dec_hi),
                           K.fwd_level_2d_ref(x, w7.dec_lo, w7.dec_hi)),
                      *zip(K1.fwd_level_1d(s, w8.dec_lo, w8.dec_hi),
                           K1.fwd_level_1d_ref(s, w8.dec_lo, w8.dec_hi))):
        fin = torch.isfinite(got)
        assert not bool((fin & ~torch.isfinite(want)).any())
        assert bool(fin.any())
        err = float((got[fin] - want[fin]).abs().max())
        assert err <= RTOL * float(want[torch.isfinite(want)].abs().max()), err


# ---------------------------------------------------------------------------
# kernels 1 and 7, moved onto kernel 13's body at step 2 and kernel 15's
# decimated body
# ---------------------------------------------------------------------------

# 2, 3 (odd), 5 (odd), 14, 40 and 128 taps; 2 x 2 images and odd subband
# sizes; a batch of 3 and one past gridDim.z; the DWT cell's first and last
# levels
FWD1_CASES = [("haar", (1, 2, 2)), ("db7", (1, 2, 2)), ("w128", (3, 16, 16)),
              ("odd3", (1, 6, 10)), ("odd5", (2, 70, 134)), ("w40", (1, 140, 76)),
              ("db7", (3, 74, 106)), ("w128", (1, 80, 140)), ("db2", (70000, 2, 2)),
              ("db7", (1, 2048, 2048)), ("db7", (1, 256, 256))]


@pytest.mark.parametrize("wname,shape", FWD1_CASES)
def test_fwd_level_2d_redesign_matches_plain(dev, wname, shape):
    """Kernel 1 on kernel 13's body at step 2 in fd (rows first) against its
    plain version (columns first), relative to the call's largest output."""
    w = _bank(wname)
    x = _rand(dev, *shape) * 255
    _close_joint(K.fwd_level_2d(x, w.dec_lo, w.dec_hi), K.fwd_level_2d_ref(x, w.dec_lo,
                                                                            w.dec_hi))


# 2, 3, 5, 16, 64 and 128 taps; signals of 2 and 14 samples; a batch of 33
# and one past gridDim.y; the batched 1D cell's first and last levels; one
# long signal
FWD7_CASES = [("odd3", (33, 14)), ("w64", (2, 300)), ("w128", (3, 90)), ("w128", (1, 14)),
              ("db2", (33, 2)), ("haar", (5, 2)), ("odd5", (3, 30)), ("sym8", (1024, 4096)),
              ("sym8", (1024, 512)), ("sym8", (70000, 32)), ("sym8", (1, 1 << 21))]


@pytest.mark.parametrize("wname,shape", FWD7_CASES)
def test_fwd_level_1d_redesign_matches_plain(dev, wname, shape):
    """Kernel 7 on kernel 15's decimated body in fd, on a float32 input."""
    w = _bank(wname)
    x = _rand(dev, *shape)
    _close(K1.fwd_level_1d(x, w.dec_lo, w.dec_hi), K1.fwd_level_1d_ref(x, w.dec_lo, w.dec_hi))


def test_redesigned_1_7_refuse_a_bad_launch_plan(dev, monkeypatch):
    """The entry points of kernels 1 and 7 check the plan they are given (an
    a-trous plan is not one of 7's, a b3 plan not one of 1's)."""
    w7, w8 = get_wavelet("db7"), get_wavelet("sym8")
    x = _rand(dev, 1, 256, 256)
    good = M.fwd_launch_plan(1, 256, 256, 14, "fd")
    for bad in (good._replace(smem=good.smem + 16), good._replace(lr=good.lr + 1),
                good._replace(grid=(good.grid[0], good.grid[1] + 1, 1)),
                good._replace(threads=48), good._replace(nt=8), good._replace(gc=3),
                M.fwd_launch_plan(1, 256, 256, 14, "b3")):
        monkeypatch.setattr(M, "fwd_launch_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            K.fwd_level_2d(x, w7.dec_lo, w7.dec_hi)
    s = _rand(dev, 64, 512)
    good = M1.fwd1d_launch_plan(64, 512, 16, 1, "fd", True)
    for bad in (good._replace(smem=good.smem + 16), good._replace(lc=good.lc + 1),
                good._replace(grid=(good.grid[0] + 1, *good.grid[1:])),
                good._replace(threads=48), good._replace(nt=8),
                M1.fwd1d_launch_plan(64, 512, 16, 2, "fd", False)):
        monkeypatch.setattr(M1, "fwd1d_launch_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            K1.fwd_level_1d(s, w8.dec_lo, w8.dec_hi)


@pytest.mark.parametrize("wname", ["db7", "odd5"])
def test_gradients_flow_through_kernels_1_and_7(dev, wname):
    """1 forward and as the backward of 2; 7 forward and as the backward of
    8: gradients on the card against the CPU's, and the launches of each
    backward's kernel."""
    w = _wavelet(wname)
    x = _rand(dev, 2, 38, 54) * 10
    q = [_rand(dev, 2, 19, 27, seed=k) * 10 for k in range(4)]
    s = _rand(dev, 33, 130) * 10
    b = [_rand(dev, 33, 65, seed=k) * 10 for k in range(2)]
    cases = [
        (lambda t: K.fwd_level_2d_ad(t, w.dec_lo, w.dec_hi), [x], "inv_level_2d"),
        (lambda *u: K.inv_level_2d_ad(*u, w.rec_lo, w.rec_hi), q, "fwd_level_2d"),
        (lambda t: K1.fwd_level_1d_ad(t, w.dec_lo, w.dec_hi), [s], "inv_level_1d"),
        (lambda lo, hi: K1.inv_level_1d_ad(lo, hi, w.rec_lo, w.rec_hi), b, "fwd_level_1d")]
    for fn, inputs, name in cases:
        (gd, gc), launched = _grads_and_launches(fn, inputs, name)
        assert launched == 1, name
        for g, gcpu in zip(gd, gc):
            _close_tier(g.cpu(), gcpu, rtol=1e-4)


# ---------------------------------------------------------------------------
# kernels 3 and 4, the tails, on the level bodies of kernels 1 and 2 in one
# launch spread over a thread-block cluster
# ---------------------------------------------------------------------------

# TAIL_CASES, then 128 taps on 16 x 16, a batch of 70000 4 x 4 images, 160 x
# 160 to 5 x 5, and the DWT cell's tail at 4 levels
TAIL34_CASES = TAIL_CASES + [("w128", (1, 16, 16), 2), ("db2", (70000, 4, 4), 2),
                             ("db7", (1, 160, 160), 5), ("db7", (1, 128, 128), 4)]


def _tail_inputs(dev, w, shape, levels):
    """An image, and subbands of its size (deepest first) for the inverse."""
    B, R, C = shape
    x = _rand(dev, *shape) * 255
    a = _rand(dev, B, R >> levels, C >> levels, seed=1) * 255
    bands = [tuple(_rand(dev, B, R >> k, C >> k, seed=10 * k + j) * 255 for j in range(3))
             for k in range(levels, 0, -1)]
    return x, a, bands


@pytest.mark.parametrize("wname,shape,levels", TAIL34_CASES)
def test_tail_redesign_matches_plain(dev, wname, shape, levels):
    """Both tails against their plain versions, relative to the call's
    largest output (the forward runs the rows first, its plain version the
    columns first)."""
    w = _long_wavelet(wname)
    x, a, bands = _tail_inputs(dev, w, shape, levels)
    ta, tdets = K.fwd_tail_2d(x, w.dec_lo, w.dec_hi, levels)
    ra, rdets = K.fwd_tail_2d_ref(x, w.dec_lo, w.dec_hi, levels)
    _close_joint([ta, *sum(tdets, ())], [ra, *sum(rdets, ())])
    _close_joint([K.inv_tail_2d(a, bands, w.rec_lo, w.rec_hi)],
                 [K.inv_tail_2d_ref(a, bands, w.rec_lo, w.rec_hi)])


@pytest.mark.parametrize("wname,shape,levels", TAIL34_CASES)
def test_tails_equal_the_level_kernels_level_by_level(dev, wname, shape, levels):
    """Each tail level is the level kernel's function in the same sum order:
    the tails equal the chain of kernel 1 (forward) and of kernel 2
    (inverse) on finite data, whatever the tiles."""
    w = _long_wavelet(wname)
    x, a, bands = _tail_inputs(dev, w, shape, levels)
    ta, tdets = K.fwd_tail_2d(x, w.dec_lo, w.dec_hi, levels)
    ca, cdets = x, []
    for _ in range(levels):
        ca, h, v, d = K.fwd_level_2d(ca, w.dec_lo, w.dec_hi)
        cdets.append((h, v, d))
    for got, want in zip([ta, *sum(tdets, ())], [ca, *sum(cdets, ())]):
        assert torch.equal(got, want)
    y = a
    for band in bands:
        y = K.inv_level_2d(y, *band, w.rec_lo, w.rec_hi)
    assert torch.equal(K.inv_tail_2d(a, bands, w.rec_lo, w.rec_hi), y)


@pytest.mark.parametrize("wname,shape,levels", [c for c in TAIL34_CASES if c[2] > 1])
def test_multilevel_tails_give_one_result_50_times(dev, wname, shape, levels):
    """A level stages what the one before wrote in the same launch (after a
    cluster barrier, with coherent loads): a stale read would show now and
    then, so each multi-level case runs 50 times against its first."""
    w = _long_wavelet(wname)
    x, a, bands = _tail_inputs(dev, w, shape, levels)
    first = K.fwd_tail_2d(x, w.dec_lo, w.dec_hi, levels)
    first_y = K.inv_tail_2d(a, bands, w.rec_lo, w.rec_hi)
    for _ in range(50):
        ta, tdets = K.fwd_tail_2d(x, w.dec_lo, w.dec_hi, levels)
        assert all(torch.equal(g, f) for g, f in zip([ta, *sum(tdets, ())],
                                                      [first[0], *sum(first[1], ())]))
        assert torch.equal(K.inv_tail_2d(a, bands, w.rec_lo, w.rec_hi), first_y)


def test_redesigned_3_4_refuse_a_bad_launch_plan(dev, monkeypatch):
    """The tails' entry points check the plan they are given (shared memory
    not the largest level's, a cluster size the card does not take, blocks
    of one item in more than one cluster, tiles off the strips, the
    forward's nph on the inverse); nothing falls back."""
    w = get_wavelet("db7")
    x, a, bands = _tail_inputs(dev, w, (1, 128, 128), 4)
    real = K.tail_launch_plan
    for inverse in (False, True):
        good = real(1, 128, 128, 14, 4, inverse)
        lv = good.levels
        bad_plans = [good._replace(smem=good.smem + 16), good._replace(cs=3, nb=3),
                     good._replace(cs=8), good._replace(threads=48),
                     good._replace(levels=(lv[0]._replace(lr=4),) + lv[1:]),
                     good._replace(levels=(lv[0]._replace(lc=12),) + lv[1:]),
                     good._replace(levels=(lv[0]._replace(nph=2 if inverse else 3),) + lv[1:])]
        for bad in bad_plans:
            monkeypatch.setattr(K, "tail_launch_plan", lambda *args, bad=bad, **kw: bad)
            with pytest.raises(RuntimeError, match="launch failed"):
                if inverse:
                    K.inv_tail_2d(a, bands, w.rec_lo, w.rec_hi)
                else:
                    K.fwd_tail_2d(x, w.dec_lo, w.dec_hi, 4)
        monkeypatch.setattr(K, "tail_launch_plan", real)


@pytest.mark.parametrize("wname", ["db7", "odd5"])
def test_gradients_flow_through_kernels_3_and_4(dev, wname):
    """3 forward and as the backward of 4, and the reverse, at 3 levels:
    gradients on the card against the CPU's, and the launches of each
    backward's kernel."""
    w = _wavelet(wname)
    x = _rand(dev, 2, 32, 64) * 10
    a = _rand(dev, 2, 4, 8) * 10
    flat = [_rand(dev, 2, 4 << k, 8 << k, seed=3 * k + j) * 10 for k in range(3)
            for j in range(3)]
    cases = [
        (lambda t: K.fwd_tail_2d_ad(t, w.dec_lo, w.dec_hi, 3)[0], [x], "inv_tail_2d"),
        (lambda t, *u: K.inv_tail_2d_ad(t, [tuple(u[3 * k:3 * k + 3]) for k in range(3)],
                                        w.rec_lo, w.rec_hi), [a, *flat], "fwd_tail_2d")]
    for fn, inputs, name in cases:
        (gd, gc), launched = _grads_and_launches(fn, inputs, name)
        assert launched == 1, name
        for g, gcpu in zip(gd, gc):
            _close_tier(g.cpu(), gcpu, rtol=1e-4)


# ---------------------------------------------------------------------------
# the padded entry points of kernels 1, 2, 7 and 8 (the boundary modes)
# ---------------------------------------------------------------------------

def _leaves(c):
    return [c.approx, *[t for band in c.details for t in band]]


MODE_CASES = [("db7", "symmetric", (1, 61, 40)), ("haar", "zero", (2, 1, 5)),
              ("sym8", ("periodization", "smooth"), (3, 9, 33)),
              ("db2", ("reflect", "periodization"), (1, 37, 2)),
              ("db10", "antireflect", (1, 70, 18))]


@pytest.mark.parametrize("wname,mode,shape", MODE_CASES)
def test_padded_kernels_1_and_2_match_their_plain_versions(dev, wname, mode, shape):
    """One level of the mode route: kernel 1's padded entry point on the
    extended image and kernel 2's on the padded subbands, against their
    plain versions on the card (relative to the largest plain output)."""
    from pdwt_tpu_torch.core import separable as sep

    w = _wavelet(wname)
    m = (mode, mode) if isinstance(mode, str) else mode
    x = _rand(dev, *shape) * 10
    xp = sep.fwd_mode_pad(sep.fwd_mode_pad(x, -1, w.hlen, m[1]), -2, w.hlen, m[0])
    bands = K.fwd_level_2d_padded(xp, w.dec_lo, w.dec_hi)
    _close_joint(bands, K.fwd_level_2d_padded_ref(xp, w.dec_lo, w.dec_hi))
    padded, c0 = [], [0, 0]
    for t in bands:
        t, c0[0] = sep.inv_mode_pad(t, -2, w.hlen, m[0], shape[1])
        t, c0[1] = sep.inv_mode_pad(t, -1, w.hlen, m[1], shape[2])
        padded.append(t.contiguous())
    args = (*padded, w.rec_lo, w.rec_hi, tuple(c0), shape[1:])
    _close(K.inv_level_2d_padded(*args), K.inv_level_2d_padded_ref(*args))


@pytest.mark.parametrize("wname,mode,shape", [("sym8", "symmetric", (33, 100)),
                                              ("haar", "smooth", (5, 1)),
                                              ("db10", "periodic", (2, 7))])
def test_padded_kernels_7_and_8_match_their_plain_versions(dev, wname, mode, shape):
    from pdwt_tpu_torch.core import separable as sep

    w = _wavelet(wname)
    xp = sep.fwd_mode_pad(_rand(dev, *shape), -1, w.hlen, mode)
    lo, hi = K1.fwd_level_1d_padded(xp, w.dec_lo, w.dec_hi)
    _close_joint((lo, hi), K1.fwd_level_1d_padded_ref(xp, w.dec_lo, w.dec_hi))
    args = (lo, hi, w.rec_lo, w.rec_hi, -1, shape[1])
    _close(K1.inv_level_1d_padded(*args), K1.inv_level_1d_padded_ref(*args))


@pytest.mark.parametrize("mode", ["symmetric", ("zero", "periodization")])
def test_mode_route_runs_every_level_on_the_padded_kernels(dev, mode):
    """dwt2d/idwt2d and dwt1d/idwt1d with a mode: one padded launch per
    level and direction, nothing else; the result against the CPU's route
    (relative to the largest coefficient: the two routes extend and filter
    in another order), gradients through the padded Functions too."""
    from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    w = get_wavelet("db4")
    x = _rand(dev, 2, 45, 38) * 100
    reset_launch_counts()
    c = dwt2d(x, w, 3, mode=mode)
    y = idwt2d(c, w, (45, 38), mode=mode)
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {"fwd_level_2d_padded": 3,
                                                        "inv_level_2d_padded": 3}
    cc = dwt2d(x.cpu(), w, 3, mode=mode)
    _close_joint([t.cpu() for t in _leaves(c)], _leaves(cc))
    _close(y.cpu(), idwt2d(cc, w, (45, 38), mode=mode))
    s = _rand(dev, 3, 77) * 100
    reset_launch_counts()
    c1 = dwt1d(s, w, 2, mode=mode if isinstance(mode, str) else mode[0])
    idwt1d(c1, w, 77, mode=mode if isinstance(mode, str) else mode[0])
    assert {k: v for k, v in LAUNCHES.items() if v} == {"fwd_level_1d_padded": 2,
                                                        "inv_level_1d_padded": 2}
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(dwt2d(xg, w, 2, mode=mode).approx.sum(), xg)
    xc = x.cpu().requires_grad_(True)
    (gc,) = torch.autograd.grad(dwt2d(xc, w, 2, mode=mode).approx.sum(), xc)
    _close(g.cpu(), gc)


# the padded entry points of kernels 5, 6, 9 and 10 (the sharded SWT)

PAD_SWT_CASES = [("db7", (1, 64, 96), 1), ("db7", (2, 37, 53), 3), ("haar", (2, 5, 7), 4),
                 ("odd5", (1, 16, 24), 2), ("sym8", (1, 8, 8), 6), ("db2", (70000, 2, 2), 1)]


def _halo(t, lohi, axes):
    from pdwt_tpu_torch.core import conv

    for ax in axes:
        t = conv.wrap_pad(t, ax, *lohi)
    return t.contiguous()


@pytest.mark.parametrize("wname,shape,level", PAD_SWT_CASES)
def test_padded_kernels_5_and_6_match_their_plain_versions(dev, wname, shape, level):
    """A sharded SWT level: kernel 5's padded entry point on a shard wrapped
    by its halo and kernel 6's on subbands wrapped by theirs, against their
    plain versions and, on a periodic halo, against kernels 5 and 6."""
    from pdwt_tpu_torch import kernels as KK

    w = _wavelet(wname)
    x = _rand(dev, *shape)
    xp = _halo(x, KK.swt_fwd_halo(w.hlen, level), (-1, -2))
    got = S.swt_fwd_level_2d_padded(xp, w.dec_lo, w.dec_hi, level)
    _close_joint(got, S.swt_fwd_level_2d_padded_ref(xp, w.dec_lo, w.dec_hi, level))
    _close_joint(got, S.swt_fwd_level_2d(x, w.dec_lo, w.dec_hi, level))
    bands = [_rand(dev, *shape, seed=k) for k in range(4)]
    bp = [_halo(t, KK.swt_inv_halo(w.hlen, level), (-1, -2)) for t in bands]
    y = S.swt_inv_level_2d_padded(*bp, w.rec_lo, w.rec_hi, level)
    _close(y, S.swt_inv_level_2d_padded_ref(*bp, w.rec_lo, w.rec_hi, level))
    _close(y, S.swt_inv_level_2d(*bands, w.rec_lo, w.rec_hi, level))


@pytest.mark.parametrize("wname,shape,level", [("sym8", (33, 200), 3), ("haar", (3, 7), 4),
                                               ("odd5", (40, 64), 2), ("db7", (2, 1), 5),
                                               ("sym8", (70000, 8), 1)])
def test_padded_kernels_9_and_10_match_their_plain_versions(dev, wname, shape, level):
    from pdwt_tpu_torch import kernels as KK

    w = _wavelet(wname)
    x = _rand(dev, *shape)
    xp = _halo(x, KK.swt_fwd_halo(w.hlen, level), (-1,))
    got = K1.swt_fwd_level_1d_padded(xp, w.dec_lo, w.dec_hi, level)
    _close_joint(got, K1.swt_fwd_level_1d_padded_ref(xp, w.dec_lo, w.dec_hi, level))
    _close_joint(got, K1.swt_fwd_level_1d(x, w.dec_lo, w.dec_hi, level))
    lo, hi = (_halo(_rand(dev, *shape, seed=k), KK.swt_inv_halo(w.hlen, level), (-1,))
              for k in (1, 2))
    y = K1.swt_inv_level_1d_padded(lo, hi, w.rec_lo, w.rec_hi, level)
    _close(y, K1.swt_inv_level_1d_padded_ref(lo, hi, w.rec_lo, w.rec_hi, level))


# ---------------------------------------------------------------------------
# the padded entry points of kernels 11-16 (the sharded transforms under the
# precision tiers): each in every scheme against its plain version, the
# b-schemes bit for bit (the bodies keep the plain versions' sum order), fd
# within _close_tier; inputs wrapped by the periodic stand-in of the ring
# ---------------------------------------------------------------------------

PER = "periodization"
F32 = torch.float32


def _exact_or_tier_all(got, want, scheme):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _exact_or_tier(g, w, scheme)


def _decimated_pads(t, hlen, axes, out=None):
    """The decimated padded entry points' inputs: the forward's odd
    extension and halo (out None), or the inverse's periodic halo and c0."""
    from pdwt_tpu_torch.core import separable as sep

    if out is None:
        for ax in axes:
            t = sep.fwd_mode_pad(t, ax, hlen, PER)
        return t.contiguous()
    c0 = []
    for ax, n in zip(axes, out):
        t, c = sep.inv_mode_pad(t, ax, hlen, PER, n)
        c0.append(c)
    return t.contiguous(), tuple(c0)


# a shard of the DWT cell's level 1, sizes no tile divides (odd too), 2 and 40
# taps, a batch past the grid's limit
PAD_MXU_2D_CASES = [("db7", (1, 128, 256)), ("db4", (2, 37, 53)), ("haar", (1, 2, 6)),
                    ("w40", (1, 70, 38)), ("db2", (70000, 2, 2))]


@pytest.mark.parametrize("scheme", SCHEMES5)
@pytest.mark.parametrize("wname,shape", PAD_MXU_2D_CASES)
def test_padded_kernels_11_and_12_match_their_plain_versions(dev, wname, shape, scheme):
    w = _long_wavelet(wname)
    R, C = shape[1:]
    for in_dt in (BF16, F32):
        x = (_rand(dev, *shape) * 255).to(in_dt)
        xp = _decimated_pads(x, w.hlen, (-1, -2))
        got = M.fwd_level_2d_mxu_padded(xp, w.dec_lo, w.dec_hi, scheme, (F32, in_dt))
        _exact_or_tier_all(got, M.fwd_level_2d_mxu_padded_ref(xp, w.dec_lo, w.dec_hi, scheme,
                                                                (F32, in_dt)), scheme)
        padded = [_decimated_pads(t, w.hlen, (-2, -1), (R, C)) for t in got]
        bands = [t for t, _ in padded]
        for out in (F32, BF16):
            args = (*bands, w.rec_lo, w.rec_hi, scheme, padded[0][1], (R, C), out)
            _exact_or_tier(M.inv_level_2d_mxu_padded(*args), M.inv_level_2d_mxu_padded_ref(*args),
                           scheme)


# a shard of the TI step, sizes no tile divides, dilations past the shard,
# 2 and 40 taps, a batch past the grid's limit
PAD_MXU_SWT_CASES = [("db7", (1, 64, 128), 2), ("db7", (2, 37, 53), 3), ("haar", (2, 5, 7), 4),
                     ("w40", (1, 24, 40), 2), ("db2", (70000, 2, 2), 1)]


@pytest.mark.parametrize("scheme", SCHEMES5)
@pytest.mark.parametrize("wname,shape,level", PAD_MXU_SWT_CASES)
def test_padded_kernels_13_and_14_match_their_plain_versions(dev, wname, shape, level, scheme):
    from pdwt_tpu_torch import kernels as KK

    w = _long_wavelet(wname)
    for in_dt in (BF16, F32):
        xp = _halo((_rand(dev, *shape) * 255).to(in_dt), KK.swt_fwd_halo(w.hlen, level),
                   (-1, -2))
        args = (xp, w.dec_lo, w.dec_hi, level, scheme, (F32, BF16))
        _exact_or_tier_all(SM.swt_fwd_level_2d_mxu_padded(*args),
                           SM.swt_fwd_level_2d_mxu_padded_ref(*args), scheme)
        bands = [_rand(dev, *shape) * 255] + [(_rand(dev, *shape, seed=k) * 127).to(in_dt)
                                              for k in (1, 2, 3)]
        bp = [_halo(t, KK.swt_inv_halo(w.hlen, level), (-1, -2)) for t in bands]
        for out in (F32, BF16):
            args = (*bp, w.rec_lo, w.rec_hi, level, scheme, out)
            _exact_or_tier(SM.swt_inv_level_2d_mxu_padded(*args),
                           SM.swt_inv_level_2d_mxu_padded_ref(*args), scheme)


# the 1D cell's shard, odd and short signals, 2 and 40 taps, a batch past the
# grid's limit, a dilation past the signal
PAD_MXU_1D_CASES = [("sym8", (64, 1024), 2), ("db7", (33, 201), 3), ("haar", (3, 7), 4),
                    ("w40", (40, 300), 2), ("sym8", (70000, 8), 1), ("db2", (2, 5), 5)]


@pytest.mark.parametrize("scheme", SCHEMES5)
@pytest.mark.parametrize("wname,shape,level", PAD_MXU_1D_CASES)
def test_padded_kernels_15_and_16_match_their_plain_versions(dev, wname, shape, level, scheme):
    from pdwt_tpu_torch import kernels as KK

    w = _long_wavelet(wname)
    n = shape[1]
    for in_dt in (BF16, F32):
        x = (_rand(dev, *shape) * 4).to(in_dt)
        xp = _decimated_pads(x, w.hlen, (-1,))
        got = M1.fwd_level_1d_mxu_padded(xp, w.dec_lo, w.dec_hi, scheme, in_dt)
        _exact_or_tier_all(got, M1.fwd_level_1d_mxu_padded_ref(xp, w.dec_lo, w.dec_hi, scheme,
                                                                in_dt), scheme)
        (lo, c0), (hi, _) = (_decimated_pads(t, w.hlen, (-1,), (n,)) for t in got)
        xs = _halo(x, KK.swt_fwd_halo(w.hlen, level), (-1,))
        args = (xs, w.dec_lo, w.dec_hi, level, scheme, in_dt)
        _exact_or_tier_all(M1.swt_fwd_level_1d_mxu_padded(*args),
                           M1.swt_fwd_level_1d_mxu_padded_ref(*args), scheme)
        sl, sh = (_halo(t, KK.swt_inv_halo(w.hlen, level), (-1,))
                  for t in (_rand(dev, *shape, seed=1) * 4, (_rand(dev, *shape, seed=2) * 2)
                            .to(in_dt)))
        for out in (F32, BF16):
            args = (lo, hi, w.rec_lo, w.rec_hi, scheme, c0[0], n, out)
            _exact_or_tier(M1.inv_level_1d_mxu_padded(*args),
                           M1.inv_level_1d_mxu_padded_ref(*args), scheme)
            args = (sl, sh, w.rec_lo, w.rec_hi, level, scheme, out)
            _exact_or_tier(M1.swt_inv_level_1d_mxu_padded(*args),
                           M1.swt_inv_level_1d_mxu_padded_ref(*args), scheme)


def test_padded_mxu_kernels_refuse_reads_outside_and_bad_plans(dev, monkeypatch):
    """An input no longer than the span holds no output (the wrappers
    raise before any launch); a plan whose shared memory does not add up
    is refused by the C entry (cudaErrorInvalidValue), as the other padded
    entry points' are."""
    t8 = np.ones(8)
    band = torch.rand(1, 14, 14, device=dev)
    with pytest.raises(ValueError, match="needs more than 14 samples"):
        SM.swt_fwd_level_2d_mxu_padded(band, t8, t8, 2, "b1")
    with pytest.raises(ValueError, match="needs more than 14 samples"):
        M1.swt_inv_level_1d_mxu_padded(band[0], band[0], t8, t8, 2, "fd")
    with pytest.raises(ValueError, match="reads outside"):
        M.inv_level_2d_mxu_padded(band, band, band, band, t8, t8, "b3", (0, 0), (40, 40))
    x = torch.rand(1, 64, 64, device=dev)
    real = M.fwd_launch_plan

    def bad(*a):
        return real(*a)._replace(smem=real(*a).smem + 16)

    monkeypatch.setattr(M, "fwd_launch_plan", bad)
    with pytest.raises(RuntimeError, match="fwd_level_2d_mxu_padded kernel launch failed"):
        M.fwd_level_2d_mxu_padded(x, t8, t8, "b3")


def test_fd_float32_padded_entry_points_are_the_exact_ones(dev):
    """The tiers' padded entry points in fd on float32 run the exact padded
    instances (1p, 5p, 7p, 9p: TIER false; 2p, 6p, 8p, 10p: the same
    template instance): the same results, bit for bit."""
    from pdwt_tpu_torch import kernels as KK

    w = get_wavelet("db7")
    x = _rand(dev, 2, 48, 80) * 255
    xp = _decimated_pads(x, w.hlen, (-1, -2))
    for g, e in zip(M.fwd_level_2d_mxu_padded(xp, w.dec_lo, w.dec_hi, "fd"),
                    K.fwd_level_2d_padded(xp, w.dec_lo, w.dec_hi)):
        assert torch.equal(g, e)
    xs = _halo(x, KK.swt_fwd_halo(w.hlen, 2), (-1, -2))
    for g, e in zip(SM.swt_fwd_level_2d_mxu_padded(xs, w.dec_lo, w.dec_hi, 2, "fd"),
                    S.swt_fwd_level_2d_padded(xs, w.dec_lo, w.dec_hi, 2)):
        assert torch.equal(g, e)
    bs = [_halo(_rand(dev, 2, 48, 80, seed=k), KK.swt_inv_halo(w.hlen, 2), (-1, -2))
          for k in range(4)]
    assert torch.equal(SM.swt_inv_level_2d_mxu_padded(*bs, w.rec_lo, w.rec_hi, 2, "fd"),
                       S.swt_inv_level_2d_padded(*bs, w.rec_lo, w.rec_hi, 2))
    s = x.reshape(96, 80)
    sp = _decimated_pads(s, w.hlen, (-1,))
    for g, e in zip(M1.fwd_level_1d_mxu_padded(sp, w.dec_lo, w.dec_hi, "fd"),
                    K1.fwd_level_1d_padded(sp, w.dec_lo, w.dec_hi)):
        assert torch.equal(g, e)
    ss = _halo(s, KK.swt_fwd_halo(w.hlen, 3), (-1,))
    for g, e in zip(M1.swt_fwd_level_1d_mxu_padded(ss, w.dec_lo, w.dec_hi, 3, "fd"),
                    K1.swt_fwd_level_1d_padded(ss, w.dec_lo, w.dec_hi, 3)):
        assert torch.equal(g, e)


@pytest.mark.parametrize("tier", ["mixed", "bf16-fast", "bf16-balanced", "bf16-accurate"])
def test_sharded_tiers_on_one_rank_match_the_cpu(dev, tier, tmp_path):
    """One gloo rank on the card, mesh (1, 1, 1) (every halo the local
    wrap): the sharded 2D DWT/SWT and 1D DWT/SWT roundtrips under a tier,
    exactly the padded launches the route rule predicts per level, against
    the same route on the CPU's plain versions (``PATH`` tolerances of the
    module docstring)."""
    import torch.distributed as dist

    from pdwt_tpu_torch import kernels as KK
    from pdwt_tpu_torch import parallel as par
    from pdwt_tpu_torch import precision_scope

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        w, w8 = get_wavelet("db7"), get_wavelet("sym8")
        bf16 = tier.startswith("bf16-")
        ax = dict(data_axis=None, row_axis="row", col_axis="col")
        x = _rand(dev, 256, 512) * 255
        x = x.to(BF16) if bf16 else x
        s = (_rand(dev, 32, 1024) * 4).to(x.dtype)
        outs = {}
        for where in ("cuda", "cpu"):
            mesh = par.make_mesh((1, 1, 1), device_type=where)
            m1 = par.make_mesh((1, 1), ("data", "col"), device_type=where)
            xl, sl = x.to(where), s.to(where)
            KK.reset_launch_counts()
            with precision_scope(tier):
                res = []
                for swt in (False, True):
                    c = par.dwt2d(par.shard_image(xl, mesh, **ax), w, 3, mesh, swt=swt, **ax)
                    y = par.idwt2d(c, w, (256, 512), mesh, swt=swt, **ax)
                    c1 = par.dwt1d(sl, w8, 3, m1, swt=swt, col_axis="col")
                    y1 = par.idwt1d(c1, w8, 1024, m1, swt=swt, col_axis="col")
                    res += [t.to_local() for t in _leaves(c) + [y, c1.approx, *c1.details, y1]]
            outs[where] = (res, {k: v for k, v in KK.LAUNCHES.items() if v})
        got, launched = outs["cuda"]
        want = outs["cpu"][0]
        for g, c in zip(got, want):
            _close_tier(g, c, bf16_rtol=2.0 ** -6, rtol=1e-4)
        # 256 x 512, 3 levels: subbands 128 x 256, 64 x 128, 32 x 64 (the
        # last off the route); the SWT's levels all on it under bf16
        mxu = tier != "mixed"
        want_l = {"fwd_level_2d_mxu_padded": 2, "inv_level_2d_mxu_padded": 2,
                  "fwd_level_2d_padded": 1, "inv_level_2d_padded": 1,
                  "fwd_level_1d_mxu_padded": 3, "inv_level_1d_mxu_padded": 3}
        want_l.update({"swt_fwd_level_2d_mxu_padded": 3, "swt_inv_level_2d_mxu_padded": 3,
                       "swt_fwd_level_1d_mxu_padded": 3, "swt_inv_level_1d_mxu_padded": 3}
                      if mxu else
                      {"swt_fwd_level_2d_padded": 3, "swt_inv_level_2d_padded": 3,
                       "swt_fwd_level_1d_padded": 3, "swt_inv_level_1d_padded": 3})
        assert launched == want_l
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("backend", ["fma", "xla", "gather"])
def test_conv_formulations_on_the_card_launch_nothing_and_match(backend, dev):
    """JAX's conv formulations on the card: no kernel of the port launches,
    the 2D and 1D roundtrips match ``backend=None`` within 1e-5 of the
    largest output, and float64 runs (the conv route takes it)."""
    from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    w = get_wavelet("db7")
    x = _rand(dev, 2, 96, 80)
    want = dwt2d(x, w, 3)
    reset_launch_counts()
    got = dwt2d(x, w, 3, backend=backend)
    y = idwt2d(got, w, (96, 80), backend=backend)
    y1 = idwt1d(dwt1d(x[0], w, 2, backend=backend), w, 80, backend=backend)
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) == 0
    peak = float(want.approx.abs().max())
    for a, b in zip([got.approx, *got.details[0]], [want.approx, *want.details[0]]):
        assert float((a - b).abs().max()) <= 1e-5 * peak
    assert float((y - x).abs().max()) < 1e-3 and float((y1 - x[0]).abs().max()) < 1e-3
    y64 = idwt2d(dwt2d(x.double(), w, 3, backend=backend), w, (96, 80), backend=backend)
    assert y64.dtype == torch.float64 and float((y64 - x.double()).abs().max()) < 1e-9


@pytest.mark.parametrize("op", ["roundtrip", "ti_step"])
def test_kernel_spans_hold_the_launches_under_the_profiler(op, dev):
    """Profiled, every launch of a port kernel (its runtime call, matched to
    the kernel by the profiler's correlation id) lies inside the host range
    of a ``pdwt.kernels.*`` span, one span a launch; no ``pdwt.`` name is
    device work in the benchmark's reading (``wavebench.tracing``), and the
    operand bytes are those of the shapes."""
    import os
    import sys

    from torch.profiler import ProfilerActivity, profile

    from pdwt_tpu_torch import models
    from pdwt_tpu_torch.kernels import LAUNCHES, OPERAND_BYTES, _build
    from pdwt_tpu_torch.utils import profiling

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from wavebench import tracing

    names = tracing.port_kernels(_build.SOURCES)
    w = get_wavelet("db7")
    if op == "roundtrip":  # the benchmark's launches: four levels and a tail, each way
        x = _rand(dev, 1, 2048, 2048)
        call = lambda: idwt2d(dwt2d(x, w, 5), w, (2048, 2048))  # noqa: E731
        # levels 1-4: the image and its four bands; level 5 (the tail) likewise
        planes = 2 * (2 * (1 + 1 / 4 + 1 / 16 + 1 / 64) + 2 / 256)
    else:
        x = _rand(dev, 4, 256, 256)
        call = lambda: models.denoise_step(x, None, w, 5, 10.0, swt=True)  # noqa: E731
        planes = 5 * 5 * 2  # five planes a launch, five levels each way
    call()
    torch.cuda.synchronize()
    profiling.reset_spans()
    before = sum(LAUNCHES.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        call()
        torch.cuda.synchronize()
    launched = sum(LAUNCHES.values()) - before
    nbytes = planes * x.nbytes
    if op == "roundtrip":
        assert launched == 10
    else:  # the norm in kernel 5's epilogue: ten levels and the sum of the partials,
        # which each forward level takes and the sum takes whole; every level
        # each way takes the one beta buffer, and the sum writes one float
        assert launched == 11 and profiling.NORM_PATHS == {"fused": 1, "plain": 0}
        slots = sum(S.swt_norm_slots(4, 256, 256, w.hlen, lvl) for lvl in range(1, 6))
        nbytes += 4 * (2 * slots + 10 + 1)
    assert sum(OPERAND_BYTES.values()) == nbytes
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = p.events()
    spans = [e.time_range for e in events
             if e.device_type == cpu and e.name.startswith("pdwt.kernels.")]
    assert len(spans) == launched
    runtime = {e.id: e.time_range for e in events
               if e.device_type == cpu and e.name.startswith("cuda") and "Launch" in e.name}
    port = [e for e in events if e.device_type == cuda and tracing.is_port_kernel(e.name, names)]
    assert 0 < len(port) <= launched
    for e in port:
        rt = runtime[e.id]
        assert any(s.start <= rt.start and rt.end <= s.end for s in spans), e.name
    mirrors = [e for e in events if e.device_type == cuda and e.name.startswith("pdwt.")]
    assert all(tracing.is_annotation(e) for e in mirrors)
    dev_events = [(e.name, e.time_range.elapsed_us() / 1e3) for e in events
                  if e.device_type == cuda and not tracing.is_annotation(e)]
    assert not any(n.startswith("pdwt.") for n, _ in dev_events)
    busy = tracing.busy_per_call(dev_events, 1, launched, names)
    if busy is not None:  # None where the profiler dropped a kernel's event
        assert not any(n.startswith("pdwt.") for n in busy[1])


# ---------------------------------------------------------------------------
# the 2D TI step's norm in kernel 5's store epilogue
# ---------------------------------------------------------------------------

#: the fused norm against a float64 ``thresholded_norm1`` of the same
#: coefficients: each thread sums its terms in float32 (up to a few hundred
#: of them where a block loops over batch items), a block its threads' sums
#: in float32, and only then the partials in float64; n float32 additions in
#: a chain bound the relative error by n 2^-24, 6e-6 at n = 100, and the
#: float64 reference sums in yet another order
FUSED_NORM_RTOL = 1e-5

#: (wavelet, shape, levels): the benchmark's frame, odd and non-square sizes,
#: levels whose dilation passes the image (24 x 40 at level 5 dilates by 16,
#: 8 x 12 at level 6 by 32), and a batch past the grid's z of 65535
FUSED_NORM_CASES = [("db7", (2, 512, 512), 5), ("db7", (3, 37, 53), 4),
                    ("db4", (2, 24, 40), 5), ("db2", (1, 8, 12), 6),
                    ("haar", (70000, 8, 8), 2)]


def _norm64(c, beta, mode, normalize):
    c64 = type(c)(c.approx.double(), tuple(tuple(t.double() for t in d) for d in c.details))
    return float(ops.thresholded_norm1(c64, beta, mode=mode, normalize=normalize))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
@pytest.mark.parametrize("wname,shape,levels", FUSED_NORM_CASES)
def test_fused_norm_matches_float64_and_the_plain_coefficients(dev, wname, shape, levels,
                                                               mode, normalize):
    """Kernel 5's norm launches store the plain launches' coefficients bit
    for bit; the fused step gives the plain route's denoised image bit for
    bit and takes the thresholded L1 norm within FUSED_NORM_RTOL of a
    float64 norm of the coefficients; two calls give the same bits."""
    from pdwt_tpu_torch.core.separable import _swt2d_denoise_norm1

    w = get_wavelet(wname)
    x = _rand(dev, *shape) * 255
    beta = 40.0
    a = x
    for lvl in range(1, levels + 1):
        b = beta / math.sqrt(2.0) ** lvl if normalize else beta
        p = torch.empty(S.swt_norm_slots(*a.shape, w.hlen, lvl), device=dev)
        got = S.swt_fwd_level_2d(a, w.dec_lo, w.dec_hi, lvl, norm=(mode, b, p, lvl == levels))
        for g, r in zip(got, S.swt_fwd_level_2d(a, w.dec_lo, w.dec_hi, lvl)):
            assert torch.equal(g, r)
        a = got[0]
    K.reset_launch_counts()
    out, n1 = _swt2d_denoise_norm1(x, w, levels, beta, mode, normalize)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["swt_fwd_level_2d"], K.LAUNCHES["swt_norm_sum_2d"],
            K.LAUNCHES["swt_inv_level_2d"]) == (levels, 1, levels)
    c = swt2d(x, w, levels)
    assert torch.equal(out, iswt2d_denoise(c, w, beta, mode=mode, normalize=normalize))
    assert n1.dtype == torch.float32 and n1.shape == () and n1.device == x.device
    ref = _norm64(c, beta, mode, normalize)
    assert abs(float(n1) - ref) <= FUSED_NORM_RTOL * ref, (float(n1), ref)
    _, again = _swt2d_denoise_norm1(x, w, levels, beta, mode, normalize)
    assert torch.equal(again, n1)


def test_fused_norm_takes_a_device_beta_and_the_step_uses_it(dev):
    """A 0-dim beta on the card (no host round trip) gives the number's
    norm; ``denoise_step`` takes the fused route and the plain route's
    output."""
    from pdwt_tpu_torch import models
    from pdwt_tpu_torch.core.separable import _swt2d_denoise_norm1

    w = get_wavelet("db7")
    x = _rand(dev, 4, 128, 96) * 255
    _, n_num = _swt2d_denoise_norm1(x, w, 3, 25.0, "garrote", True)
    _, n_dev = _swt2d_denoise_norm1(x, w, 3, torch.tensor(25.0, device=dev), "garrote", True)
    assert torch.equal(n_num, n_dev)
    K.reset_launch_counts()
    out, n1 = models.denoise_step(x, None, w, 3, 25.0, swt=True, mode="garrote", normalize=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES["swt_norm_sum_2d"] == 1 and K.LAUNCHES["swt_fwd_level_2d"] == 3
    c = swt2d(x, w, 3)
    _close(out, iswt2d_denoise(c, w, 25.0, mode="garrote", normalize=True))
    assert torch.equal(n1, n_num)


def test_fused_norm_launches_refuse_what_they_do_not_take(dev):
    w = get_wavelet("db2")
    x = _rand(dev, 1, 16, 16)
    n = S.swt_norm_slots(1, 16, 16, w.hlen, 1)
    with pytest.raises(ValueError, match="partials"):
        S.swt_fwd_level_2d(x, w.dec_lo, w.dec_hi, 1,
                           norm=("soft", 1.0, torch.zeros(n + 1, device=dev), False))
    with pytest.raises(ValueError, match="norm mode"):
        S.swt_fwd_level_2d(x, w.dec_lo, w.dec_hi, 1,
                           norm=("firm", 1.0, torch.zeros(n, device=dev), False))


# ---------------------------------------------------------------------------
# the batched 1D denoising step through the facade (the benchmark's
# sym8_1d.batch_step at 4096 of its 65536 signals)
# ---------------------------------------------------------------------------

def test_batched_1d_denoise_step_matches_the_float64_reference(dev):
    """``Wavelets(ndim=1).set_image`` then ``run_denoise(0.1)`` at 4096 x
    4096 sym8, 4 levels: kernel 7's norm launches and kernel 8 four times
    each and one sum of the partials; the output bit for bit that of
    ``dwt1d``, ``soft_threshold`` and ``idwt1d`` called in turn, the norm
    within FUSED_1D_NORM_RTOL of their ``norm1``; and both within the
    benchmark cell's limits (1e-4 of the largest value, 3e-5 of the norm)
    of the plain levels in float64."""
    from pdwt_tpu_torch import Coeffs1D

    w, n, levels, beta = get_wavelet("sym8"), 4096, 4, 0.1
    x = (_rand(dev, n, n, seed=28) + 1) / 2
    W = Wavelets(nr=n, nc=n, wname="sym8", levels=levels, ndim=1, device=dev)
    W.set_image(x)
    W.run_denoise(beta)
    K.reset_launch_counts()
    out, n1 = W.run_denoise(beta)
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {"fwd_level_1d_norm": levels,
                                                         "swt_norm_sum_2d": 1,
                                                         "inv_level_1d": levels}
    c = ops.soft_threshold(dwt1d(x, w, levels), beta)
    assert torch.equal(out, idwt1d(c, w, n))
    torch.testing.assert_close(n1, ops.norm1(c), rtol=FUSED_1D_NORM_RTOL, atol=0)
    a, dets = x.double(), []
    for _ in range(levels):
        a, d = K1.fwd_level_1d_ref(a, w.dec_lo, w.dec_hi)
        dets.append(d)
    c64 = ops.soft_threshold(Coeffs1D(a, tuple(dets)), beta)
    want = c64.approx
    for d in reversed(c64.details):
        want = K1.inv_level_1d_ref(want, d, w.rec_lo, w.rec_hi)
    want_n1 = float(ops.norm1(c64))
    assert float((out.double() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert abs(float(n1) - want_n1) <= 3e-5 * want_n1


# ---------------------------------------------------------------------------
# the batched 1D step's fused threshold and norm: kernel 7's norm launches
# ---------------------------------------------------------------------------

#: the fused norm against ``norm1`` of the thresholded tree, both float32
#: sums in different orders
FUSED_1D_NORM_RTOL = 2e-6

#: (wavelet, shape): batches of 1, 33 and 1000 signals; 4096 samples and
#: 1000 (level 4 is 125 long, odd); sym8, db7 and an odd-length bank
FUSED_1D_CASES = [("sym8", (1, 4096)), ("sym8", (33, 1000)), ("db7", (1000, 4096)),
                  ("db7", (1, 1000)), ("odd5", (33, 4096)), ("odd5", (1000, 1000))]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
@pytest.mark.parametrize("wname,shape", FUSED_1D_CASES)
def test_fused_1d_denoise_matches_the_plain_route(dev, wname, shape, mode, normalize):
    """``Wavelets(ndim=1).run_denoise`` on kernel 7's norm launches: the
    denoised signals bit for bit those of ``dwt1d``, the threshold ops and
    ``idwt1d``; the norm within FUSED_1D_NORM_RTOL of ``norm1`` of the
    thresholded tree; the launches of the route; two calls equal."""
    from pdwt_tpu_torch.filters.bank import register_wavelet
    from pdwt_tpu_torch.ops.threshold import THRESHOLD_OPS

    w = _wavelet(wname)
    register_wavelet(w)  # the odd bank by name, as the built-in ones (the same bank)
    x = _rand(dev, *shape, seed=29)
    levels, beta = 4, 0.3
    W = Wavelets(x, wname=wname, levels=levels, ndim=1, device=dev)
    K.reset_launch_counts()
    out, n1 = W.run_denoise(beta, mode=mode, normalize=normalize)
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {"fwd_level_1d_norm": levels,
                                                         "swt_norm_sum_2d": 1,
                                                         "inv_level_1d": levels}
    c = THRESHOLD_OPS[mode](dwt1d(x, w, levels), beta, normalize=normalize)
    assert torch.equal(out, idwt1d(c, w, shape[-1]))
    assert n1.dtype == torch.float32 and n1.shape == () and n1.device == x.device
    torch.testing.assert_close(n1, ops.norm1(c), rtol=FUSED_1D_NORM_RTOL, atol=0)
    again, n2 = W.run_denoise(beta, mode=mode, normalize=normalize)
    assert torch.equal(again, out) and torch.equal(n2, n1)


@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
@pytest.mark.parametrize("wname,shape", [("sym8", (65, 4096)), ("odd5", (70000, 64)),
                                         ("haar", (3, 2))])
def test_fused_1d_norm_launches_match_the_plain_launch(dev, monkeypatch, wname, shape, mode):
    """Kernel 7's norm launch: the low band bit for bit the plain launch's,
    the high band the plain launch's thresholded by the threshold ops bit
    for bit, one partial a block of the launch's plan, their sum within
    FUSED_1D_NORM_RTOL of a float64 norm of it.  The wrapper's outputs are
    made NaN first, so that a block's slot or a band value left unwritten
    shows."""
    import math

    from pdwt_tpu_torch.kernels.mxu1d import fwd1d_launch_plan
    from pdwt_tpu_torch.ops.threshold import THR_ELEM

    class NaNEmpty:
        """``torch``, with ``empty`` filled with NaN."""

        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def empty(*a, **k):
            return torch.empty(*a, **k).fill_(float("nan"))

    w = _wavelet(wname)
    x = _rand(dev, *shape, seed=30)
    beta = torch.tensor(0.25, device=dev)
    with monkeypatch.context() as m:
        m.setattr(M1, "torch", NaNEmpty())
        lo, hi, parts = K1.fwd_level_1d_norm(x, w.dec_lo, w.dec_hi, norm=(mode, beta))
    plo, phi = K1.fwd_level_1d(x, w.dec_lo, w.dec_hi)
    assert torch.equal(lo, plo) and torch.equal(hi, THR_ELEM[mode](phi, beta))
    hlen = M1.dual_taps((w.dec_lo, w.dec_hi), "fd", dev).shape[1]
    blocks = math.prod(fwd1d_launch_plan(*shape, hlen, 1, "fd", True).grid)
    assert parts.shape == (blocks,) and parts.dtype == torch.float32
    assert bool(torch.isfinite(parts).all())
    ref = float(ops.norms.thresholded_l1(phi.double(), 0.25, mode))
    assert abs(float(parts.double().sum()) - ref) <= FUSED_1D_NORM_RTOL * ref


def test_fused_1d_norm_launches_refuse_what_they_do_not_take(dev):
    w = get_wavelet("db2")
    with pytest.raises(ValueError, match="even length"):
        K1.fwd_level_1d_norm(_rand(dev, 4, 15), w.dec_lo, w.dec_hi, norm=("soft", 1.0))
    with pytest.raises(ValueError, match="norm mode"):
        K1.fwd_level_1d_norm(_rand(dev, 4, 16), w.dec_lo, w.dec_hi, norm=("firm", 1.0))
