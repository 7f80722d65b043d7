"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  On a machine
with a card (which need not have JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerance: max|kernel - plain| <= 1e-5 * max|plain| in float32, because
nvcc contracts each multiply-add into one FMA where the plain version
rounds twice.
"""
import numpy as np
import pytest
import torch

from pdwt_tpu_torch import dwt2d, get_wavelet, idwt2d
from pdwt_tpu_torch.filters import make_custom_wavelet
from pdwt_tpu_torch.kernels import separable as K

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
                          "fwd_tail_2d": 1, "inv_tail_2d": 1}


def test_cuda_rejects_what_the_kernels_do_not_take(dev):
    w = get_wavelet("db2")
    with pytest.raises(NotImplementedError, match="item 9"):
        K.fwd_level_2d(_rand(dev, 1, 8, 8).double(), w.dec_lo, w.dec_hi)
    with pytest.raises(NotImplementedError, match="item 9"):
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
