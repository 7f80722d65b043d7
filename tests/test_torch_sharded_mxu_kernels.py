"""The plain versions of the padded entry points of kernels 11-16 (the
sharded transforms under the precision tiers) against the ``pad_fn=`` of
the JAX package's banded-product wrappers (Pallas interpret mode), their
launch plans and the route rule on shard geometries.

Each side pads the same periodic input with its own geometry: JAX's
wrappers take ``pad_fn=conv.wrap_pad`` (the single-device stand-in of the
ring exchange) and add their Mosaic margins; the port pads with the
geometry its sharded compositions exchange (``fwd_mode_pad`` /
``inv_mode_pad``'s periodization branches for the decimated levels, the
bare support ``swt_fwd_halo`` / ``swt_inv_halo`` for the a-trous ones);
both compute the same level of the periodic signal, which is compared.
One geometry per kernel and scheme class: a bf16 input at level 1 (the
rung's scheme, picked on the JAX side with ``PDWT_TPU_BF16_L1FWD`` /
``_L1INV`` or ``PDWT_TPU_BF16_ACCURACY``), the float32 approximation chain
(``b3``), ``mixed``, and a-trous levels at 2 or 3 so that the dilation
shows.  Shapes are the smallest the TPU tiles divide (32 x 128 subbands,
16 signals of 256 samples).

Tolerances, max|port - jax| relative to max|jax| over one output, those
of ``tests/test_torch_mxu_kernels.py``: bf16-stored outputs 2^-7;
float32-stored outputs of a 2D level 2e-3 under ``b1``/``b2f`` (their
row-pass result is rounded to bf16 in between), 1e-4 under ``b3`` and
1e-5 under ``fd``; of a 1D level 1e-5.  The CUDA kernels are held to these
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import kernels as jk
from pdwt_tpu.core import conv as jconv
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu.kernels.matmul_pallas import _pick_mxu_tiles
from pdwt_tpu.kernels.mxu1d_pallas import _pick_1d_tiles
from pdwt_tpu.kernels.swt_matmul_pallas import _swt_mxu_tiles
from pdwt_tpu_torch import kernels as K
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.core.separable import fwd_mode_pad, inv_mode_pad
from pdwt_tpu_torch.kernels import _launch
from pdwt_tpu_torch.kernels import batched1d as K1
from pdwt_tpu_torch.kernels import matmul as M
from pdwt_tpu_torch.kernels import mxu1d as M1
from pdwt_tpu_torch.kernels import separable as SEP
from pdwt_tpu_torch.kernels import swt as S
from pdwt_tpu_torch.kernels import swt_matmul as SM
from pdwt_tpu_torch.utils import tensor_from_numpy, tensor_to_numpy, wavelet_from_arrays

PER = "periodization"
TOL_2D = {"b1": 2e-3, "b2f": 2e-3, "b2d": 1e-4, "b3": 1e-4, "fd": 1e-5}
TOL_1D, TOL_BF16 = 1e-5, 2.0 ** -7
F32, BF16 = torch.float32, torch.bfloat16
#: a 2D level's input and subbands, a batch of signals
R2, C2, B1, N1 = 64, 256, 16, 256


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")
    for knob in ("PDWT_TPU_BF16_L1FWD", "PDWT_TPU_BF16_L1INV", "PDWT_TPU_BF16_ACCURACY",
                 "PDWT_TPU_SWT_BF16_SCHEME", "PDWT_TPU_PRECISION", "PDWT_TPU_MXU_TILES"):
        monkeypatch.delenv(knob, raising=False)


def _pair(wname):
    jw = jget_wavelet(wname)
    return jw, wavelet_from_arrays(jw)


def _rand(*shape, seed=0, lo=0.0, hi=255.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _both(arr, bf16):
    """The same values as a JAX array and a tensor, bf16 or float32."""
    j = jnp.asarray(arr)
    return (j.astype(jnp.bfloat16) if bf16 else j,
            tensor_from_numpy(arr, dtype=BF16 if bf16 else F32))


def _np(t):
    if isinstance(t, torch.Tensor):
        return tensor_to_numpy(t), str(t.dtype).split(".")[-1]
    return np.asarray(jnp.asarray(t).astype(jnp.float32)), jnp.dtype(t.dtype).name


def _close(got, want, scheme, one_d=False):
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        (ga, gd), (wa, wd) = _np(g), _np(w)
        assert ga.shape == wa.shape and gd == wd, (ga.shape, gd, wa.shape, wd)
        tol = TOL_BF16 if wd == "bfloat16" else (TOL_1D if one_d else TOL_2D[scheme])
        err = float(np.abs(ga - wa).max()) / float(np.abs(wa).max())
        assert err <= tol, (scheme, wd, err)


def _fwd_pad(t, axes, hlen):
    for ax in axes:
        t = fwd_mode_pad(t, ax, hlen, PER)
    return t.contiguous()


def _inv_pad(t, axes, hlen, out):
    c0 = []
    for ax, n in zip(axes, out):
        t, c = inv_mode_pad(t, ax, hlen, PER, n)
        c0.append(c)
    return t.contiguous(), tuple(c0)


def _halo(t, lohi, axes):
    for ax in axes:
        t = conv.wrap_pad(t, ax, *lohi)
    return t.contiguous()


def _knobs(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)


# ---------------------------------------------------------------------------
# 11p and 12p: the decimated 2D level on its ring-padded shard
# ---------------------------------------------------------------------------

#: (mode, bf16 input, JAX knobs, port scheme)
FWD_CLASSES = [("bf16", True, {"PDWT_TPU_BF16_L1FWD": "b1"}, "b1"),
               ("bf16", True, {"PDWT_TPU_BF16_ACCURACY": "balanced"}, "b2f"),
               ("bf16", False, {}, "b3"),
               ("mixed", False, {}, "b3")]


@pytest.mark.parametrize("mode,in_bf16,env,scheme", FWD_CLASSES,
                         ids=["bf16-b1", "bf16-b2f", "f32-chain-b3", "mixed-b3"])
def test_fwd_level_2d_mxu_padded_ref_matches_pad_fn(monkeypatch, mode, in_bf16, env, scheme):
    jw, w = _pair("db7")
    _knobs(monkeypatch, **env)
    jx, tx = _both(_rand(1, R2, C2, seed=1), in_bf16)
    want = jk.fwd_level_2d_mxu(jx, jw.dec_lo, jw.dec_hi, mode, pad_fn=jconv.wrap_pad)
    got = M.fwd_level_2d_mxu_padded_ref(_fwd_pad(tx, (-1, -2), w.hlen), w.dec_lo, w.dec_hi,
                                        scheme, M.mode_out_dtypes(mode))
    _close(got, want, scheme)


#: (mode, bf16 details, output dtype, JAX knobs, port scheme)
INV_CLASSES = [("bf16", True, BF16, {"PDWT_TPU_BF16_L1INV": "fd"}, "fd"),
               ("bf16", True, BF16, {"PDWT_TPU_BF16_ACCURACY": "balanced"}, "b2f"),
               ("bf16", True, F32, {}, "b3"),
               ("mixed", False, F32, {}, "b3")]


@pytest.mark.parametrize("mode,det_bf16,out,env,scheme", INV_CLASSES,
                         ids=["bf16-out-fd", "bf16-out-b2f", "f32-out-b3", "mixed-b3"])
def test_inv_level_2d_mxu_padded_ref_matches_pad_fn(monkeypatch, mode, det_bf16, out, env,
                                                    scheme):
    jw, w = _pair("db4")
    _knobs(monkeypatch, **env)
    mr, mc = R2 // 2, C2 // 2
    bands = [_both(_rand(1, mr, mc, seed=2 + k, lo=-60, hi=60), det_bf16 and k > 0)
             for k in range(4)]
    jout = jnp.bfloat16 if out == BF16 else jnp.float32
    want = jk.inv_level_2d_mxu(*(j for j, _ in bands), jw.rec_lo, jw.rec_hi, mode,
                               out_dtype=jout, pad_fn=jconv.wrap_pad)
    assert M.inv_plan(mode, out) == (scheme, out)
    padded = [_inv_pad(t, (-2, -1), w.hlen, (2 * mr, 2 * mc)) for _, t in bands]
    got = M.inv_level_2d_mxu_padded_ref(*(t for t, _ in padded), w.rec_lo, w.rec_hi, scheme,
                                        padded[0][1], (2 * mr, 2 * mc), out)
    _close(got, want, scheme)


# ---------------------------------------------------------------------------
# 13p and 14p: the a-trous 2D level on a shard wrapped by its halo
# ---------------------------------------------------------------------------

#: (bf16 input, rung, level, port scheme)
SWT_FWD_CLASSES = [(True, "fast", 1, "b1"), (False, "fast", 2, "fd"),
                   (True, "balanced", 1, "b2f"), (False, "accurate", 3, "b2f")]


@pytest.mark.parametrize("in_bf16,rung,level,scheme", SWT_FWD_CLASSES,
                         ids=["bf16-b1-l1", "f32-fd-l2", "bf16-b2f-l1", "f32-b2f-l3"])
def test_swt_fwd_level_2d_mxu_padded_ref_matches_pad_fn(monkeypatch, in_bf16, rung, level,
                                                        scheme):
    jw, w = _pair("db4")
    _knobs(monkeypatch, PDWT_TPU_BF16_ACCURACY=rung)
    jx, tx = _both(_rand(1, R2 // 2, C2 // 2, seed=6), in_bf16)
    assert M.swt_scheme("bf16", tx.dtype) == scheme
    want = jk.swt_fwd_level_2d_mxu(jx, jw.dec_lo, jw.dec_hi, level, "bf16",
                                   pad_fn=jconv.wrap_pad)
    got = SM.swt_fwd_level_2d_mxu_padded_ref(
        _halo(tx, K.swt_fwd_halo(w.hlen, level), (-1, -2)), w.dec_lo, w.dec_hi, level, scheme,
        M.mode_out_dtypes("bf16"))
    _close(got, want, scheme)


@pytest.mark.parametrize("rung,level,out,scheme", [("fast", 1, BF16, "fd"),
                                                   ("fast", 3, F32, "fd"),
                                                   ("balanced", 2, F32, "b2f")],
                         ids=["fd-bf16-l1", "fd-f32-l3", "b2f-f32-l2"])
def test_swt_inv_level_2d_mxu_padded_ref_matches_pad_fn(monkeypatch, rung, level, out, scheme):
    jw, w = _pair("db4")
    _knobs(monkeypatch, PDWT_TPU_BF16_ACCURACY=rung)
    r, c = R2 // 2, C2 // 2
    bands = [_both(_rand(1, r, c, seed=7 + k, lo=-60, hi=60), k > 0) for k in range(4)]
    jout = jnp.bfloat16 if out == BF16 else jnp.float32
    want = jk.swt_inv_level_2d_mxu(*(j for j, _ in bands), jw.rec_lo, jw.rec_hi, level, "bf16",
                                   out_dtype=jout, pad_fn=jconv.wrap_pad)
    assert SM.swt2d_inv_plan("bf16", out) == (scheme, out)
    halo = K.swt_inv_halo(w.hlen, level)
    got = SM.swt_inv_level_2d_mxu_padded_ref(*(_halo(t, halo, (-1, -2)) for _, t in bands),
                                             w.rec_lo, w.rec_hi, level, scheme, out)
    _close(got, want, scheme)


# ---------------------------------------------------------------------------
# 15p and 16p: the batched 1D levels, decimated and a-trous
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,in_bf16,env,scheme", FWD_CLASSES[:1] + FWD_CLASSES[2:],
                         ids=["bf16-b1", "f32-chain-b3", "mixed-b3"])
def test_fwd_level_1d_mxu_padded_ref_matches_pad_fn(monkeypatch, mode, in_bf16, env, scheme):
    jw, w = _pair("sym8")
    _knobs(monkeypatch, **env)
    jx, tx = _both(_rand(B1, N1, seed=10, lo=-3, hi=3), in_bf16)
    want = jk.fwd_level_1d_mxu(jx, jw.dec_lo, jw.dec_hi, mode, pad_fn=jconv.wrap_pad)
    got = M1.fwd_level_1d_mxu_padded_ref(_fwd_pad(tx, (-1,), w.hlen), w.dec_lo, w.dec_hi,
                                         scheme, M.mode_out_dtypes(mode)[1])
    _close(got, want, scheme, one_d=True)


@pytest.mark.parametrize("mode,det_bf16,out,env,scheme", INV_CLASSES[:1] + INV_CLASSES[2:],
                         ids=["bf16-out-fd", "f32-out-b3", "mixed-b3"])
def test_inv_level_1d_mxu_padded_ref_matches_pad_fn(monkeypatch, mode, det_bf16, out, env,
                                                    scheme):
    jw, w = _pair("sym8")
    _knobs(monkeypatch, **env)
    m = N1 // 2
    (jlo, tlo), (jhi, thi) = (_both(_rand(B1, m, seed=11, lo=-4, hi=4), False),
                              _both(_rand(B1, m, seed=12, lo=-2, hi=2), det_bf16))
    jout = jnp.bfloat16 if out == BF16 else jnp.float32
    want = jk.inv_level_1d_mxu(jlo, jhi, jw.rec_lo, jw.rec_hi, mode, out_dtype=jout,
                               pad_fn=jconv.wrap_pad)
    (lo, c0), (hi, _) = (_inv_pad(t, (-1,), w.hlen, (2 * m,)) for t in (tlo, thi))
    got = M1.inv_level_1d_mxu_padded_ref(lo, hi, w.rec_lo, w.rec_hi, scheme, c0[0], 2 * m, out)
    _close(got, want, scheme, one_d=True)


@pytest.mark.parametrize("in_bf16,rung,level,scheme", SWT_FWD_CLASSES,
                         ids=["bf16-b1-l1", "f32-fd-l2", "bf16-b2f-l1", "f32-b2f-l3"])
def test_swt_fwd_level_1d_mxu_padded_ref_matches_pad_fn(monkeypatch, in_bf16, rung, level,
                                                        scheme):
    jw, w = _pair("sym8")
    _knobs(monkeypatch, PDWT_TPU_BF16_ACCURACY=rung)
    jx, tx = _both(_rand(B1, N1, seed=13, lo=-3, hi=3), in_bf16)
    want = jk.swt_fwd_level_1d_mxu(jx, jw.dec_lo, jw.dec_hi, level, "bf16",
                                   pad_fn=jconv.wrap_pad)
    got = M1.swt_fwd_level_1d_mxu_padded_ref(_halo(tx, K.swt_fwd_halo(w.hlen, level), (-1,)),
                                             w.dec_lo, w.dec_hi, level, scheme, BF16)
    _close(got, want, scheme, one_d=True)


@pytest.mark.parametrize("level,out", [(1, BF16), (3, F32)], ids=["fd-bf16-l1", "fd-f32-l3"])
def test_swt_inv_level_1d_mxu_padded_ref_matches_pad_fn(level, out):
    jw, w = _pair("db4")
    (jlo, tlo), (jhi, thi) = (_both(_rand(B1, N1, seed=14, lo=-4, hi=4), False),
                              _both(_rand(B1, N1, seed=15, lo=-2, hi=2), True))
    jout = jnp.bfloat16 if out == BF16 else jnp.float32
    want = jk.swt_inv_level_1d_mxu(jlo, jhi, jw.rec_lo, jw.rec_hi, level, "bf16",
                                   out_dtype=jout, pad_fn=jconv.wrap_pad)
    assert M1._swt_inv_plan("bf16", out) == ("fd", out)
    halo = K.swt_inv_halo(w.hlen, level)
    got = M1.swt_inv_level_1d_mxu_padded_ref(_halo(tlo, halo, (-1,)), _halo(thi, halo, (-1,)),
                                             w.rec_lo, w.rec_hi, level, "fd", out)
    _close(got, want, "fd", one_d=True)


# ---------------------------------------------------------------------------
# the wrappers on the CPU, the plans, the route rule on shards
# ---------------------------------------------------------------------------

def test_fd_float32_instances_are_the_exact_padded_plain_versions():
    """In fd on float32 the tiers' padded plain versions compute what the
    exact padded ones do (kernels 1p, 2p, 5p-10p run those instances),
    rows first where the exact 2D ones run the columns first: within
    float32 roundoff."""
    w = _pair("db7")[1]
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.uniform(0, 255, (2, 30, 44)).astype(np.float32))
    xp = _fwd_pad(x, (-1, -2), w.hlen)
    pairs = [(M.fwd_level_2d_mxu_padded_ref(xp, w.dec_lo, w.dec_hi, "fd"),
              SEP.fwd_level_2d_padded_ref(xp, w.dec_lo, w.dec_hi))]
    bands = torch.from_numpy(rng.uniform(-60, 60, (4, 2, 15, 22)).astype(np.float32))
    padded = [_inv_pad(t, (-2, -1), w.hlen, (30, 44)) for t in bands]
    args = [t for t, _ in padded] + [w.rec_lo, w.rec_hi]
    pairs.append(([M.inv_level_2d_mxu_padded_ref(*args, "fd", padded[0][1], (30, 44))],
                  [SEP.inv_level_2d_padded_ref(*args, padded[0][1], (30, 44))]))
    xs = _halo(x, K.swt_fwd_halo(w.hlen, 2), (-1, -2))
    pairs.append((SM.swt_fwd_level_2d_mxu_padded_ref(xs, w.dec_lo, w.dec_hi, 2, "fd"),
                  S.swt_fwd_level_2d_padded_ref(xs, w.dec_lo, w.dec_hi, 2)))
    xi = [_halo(t, K.swt_inv_halo(w.hlen, 2), (-1, -2)) for t in (x, x + 1, x - 1, 2 * x)]
    pairs.append(([SM.swt_inv_level_2d_mxu_padded_ref(*xi, w.rec_lo, w.rec_hi, 2, "fd")],
                  [S.swt_inv_level_2d_padded_ref(*xi, w.rec_lo, w.rec_hi, 2)]))
    s = x.reshape(4, 660)
    sp = _fwd_pad(s, (-1,), w.hlen)
    pairs.append((M1.fwd_level_1d_mxu_padded_ref(sp, w.dec_lo, w.dec_hi, "fd"),
                  K1.fwd_level_1d_padded_ref(sp, w.dec_lo, w.dec_hi)))
    (lo, c0), (hi, _) = (_inv_pad(t, (-1,), w.hlen, (660,)) for t in (s[:, :330], s[:, 330:]))
    pairs.append(([M1.inv_level_1d_mxu_padded_ref(lo, hi, w.rec_lo, w.rec_hi, "fd", c0[0], 660)],
                  [K1.inv_level_1d_padded_ref(lo, hi, w.rec_lo, w.rec_hi, c0[0], 660)]))
    ss = _halo(s, K.swt_fwd_halo(w.hlen, 3), (-1,))
    pairs.append((M1.swt_fwd_level_1d_mxu_padded_ref(ss, w.dec_lo, w.dec_hi, 3, "fd"),
                  K1.swt_fwd_level_1d_padded_ref(ss, w.dec_lo, w.dec_hi, 3)))
    pairs.append(([M1.swt_inv_level_1d_mxu_padded_ref(ss, ss + 1, w.rec_lo, w.rec_hi, 3, "fd")],
                  [K1.swt_inv_level_1d_padded_ref(ss, ss + 1, w.rec_lo, w.rec_hi, 3)]))
    for got, want in pairs:
        for g, t in zip(got, want):
            assert g.dtype == t.dtype == F32 and g.shape == t.shape
            assert float((g - t).abs().max()) <= 1e-5 * float(t.abs().max())


def test_wrappers_run_their_plain_versions_on_the_cpu():
    """On CPU tensors each wrapper returns its plain version, dtypes as
    asked, and counts no launch."""
    w = _pair("db4")[1]
    K.reset_launch_counts()
    x = torch.from_numpy(_rand(1, 32, 40, seed=21)).to(BF16)
    xp = _fwd_pad(x, (-1, -2), w.hlen)
    a, h, v, d = M.fwd_level_2d_mxu_padded(xp, w.dec_lo, w.dec_hi, "b1", (F32, BF16))
    assert a.dtype == F32 and h.dtype == v.dtype == d.dtype == BF16 and a.shape == (1, 16, 20)
    padded = [_inv_pad(t, (-2, -1), w.hlen, (32, 40)) for t in (a, h, v, d)]
    y = M.inv_level_2d_mxu_padded(*(t for t, _ in padded), w.rec_lo, w.rec_hi, "fd",
                                  padded[0][1], (32, 40), BF16)
    assert y.dtype == BF16 and y.shape == (1, 32, 40)
    ys = SM.swt_inv_level_2d_mxu_padded(
        *(_halo(t, K.swt_inv_halo(w.hlen, 2), (-1, -2)) for t in (a, h, v, d)), w.rec_lo,
        w.rec_hi, 2, "b2f", F32)
    assert ys.dtype == F32 and ys.shape == (1, 16, 20)
    lo, hi = M1.swt_fwd_level_1d_mxu_padded(_halo(x[0], K.swt_fwd_halo(w.hlen, 2), (-1,)),
                                            w.dec_lo, w.dec_hi, 2, "b1", BF16)
    assert lo.dtype == F32 and hi.dtype == BF16 and lo.shape == (32, 40)
    assert not any(_launch.LAUNCHES.values())


def _grid_fits(pl, B, R, C, f):
    """band_strip.cuh: grid_fits, the C entries' check of a 2D plan."""
    want_x = -(-C // pl.lc) if pl.gc == 1 else _launch.axis_blocks(C, f, pl.lc)
    return pl.grid == (want_x, _launch.axis_blocks(R, f, pl.lr), min(B, 65535))


def _lines_fit(pl, B, n, f):
    """mxu1d.cu: lines_fit, the C entries' check of a 1D plan."""
    want_x = -(-n // pl.lc) if pl.gc == 1 else _launch.axis_blocks(n, f, pl.lc)
    return pl.grid == (want_x, min(-(-B // 32), 65535), 1)


@pytest.mark.parametrize("scheme", M.SCHEMES)
@pytest.mark.parametrize("B,R,C,hlen,level", [(1, 512, 512, 14, 1), (1, 512, 512, 14, 3),
                                              (4, 64, 256, 16, 2), (1, 37, 53, 5, 2),
                                              (3, 8, 8, 40, 4)])
def test_padded_plans_cover_the_outputs(B, R, C, hlen, level, scheme):
    """Each padded plan is its kernel's plan for the output size (in fd the
    exact kernels' padded plan too), its grid passes the C entry's check for the outputs
    (not for the padded input), and its tile holds whole strips."""
    f = 1 << (level - 1)
    fwd = M.fwd_padded_launch_plan(B, R, C, hlen, scheme)
    assert fwd == M.fwd_launch_plan(B, 2 * R, 2 * C, hlen, scheme)
    assert _grid_fits(fwd, B, R, C, 1) and fwd.lr % _launch.ROW_STRIP[scheme] == 0
    pa = _launch.pad_axis(hlen, 2 * conv.poly_geometry(hlen).lo - conv.inv_shift(hlen), 2 * R)
    pc = _launch.pad_axis(hlen, 2 * conv.poly_geometry(hlen).lo - conv.inv_shift(hlen), 2 * C)
    inv = M.inv_padded_launch_plan(B, pa, pc, hlen, scheme)
    assert inv.grid == (-(-_launch.pad_positions(pc) // inv.lc),
                        -(-_launch.pad_positions(pa) // inv.lr), min(B, 65535))
    sf = SM.swt_fwd_padded_launch_plan(B, R, C, hlen, f, scheme)
    si = SM.swt_inv_padded_launch_plan(B, R, C, hlen, f, scheme)
    assert _grid_fits(sf, B, R, C, f) and _grid_fits(si, B, R, C, f)
    f1 = M1.swt_fwd1d_padded_launch_plan(B * R, C, hlen, f, scheme)
    i1 = M1.swt_inv1d_padded_launch_plan(B * R, C, hlen, f, scheme)
    assert _lines_fit(f1, B * R, C, f) and _lines_fit(i1, B * R, C, f)
    d1 = M1.fwd1d_padded_launch_plan(B * R, C, hlen, scheme)
    p1 = M1.inv1d_padded_launch_plan(B * R, pc, hlen, scheme)
    assert _lines_fit(d1, B * R, C, 1) and _lines_fit(p1, B * R, _launch.pad_positions(pc), 1)
    assert all(pl.lc % (8 * (f // pl.gc)) == 0 for pl in (sf, si))
    strip = _launch.ROW_STRIP[scheme]
    assert all(pl.lc % (strip * (f // pl.gc)) == 0 for pl in (f1, i1))


#: a rank's shard in the cells of ``chip_smoke.py``'s sharded phase and of
#: ``tests/test_torch_sharded.py``: (rows, columns) or (signals, samples),
#: the filter, the levels
SHARDS_2D = [((1024, 1024), 14, 5), ((512, 512), 14, 3), ((64, 256), 14, 2),
             ((32, 128), 8, 3)]
SHARDS_1D = [((1024, 1024), 16, 4), ((16, 256), 16, 4), ((8, 64), 16, 5)]


@pytest.mark.parametrize("shape,hlen,levels", SHARDS_2D)
def test_2d_route_rule_is_the_tpu_gate_on_shards(shape, hlen, levels):
    """The port's rules on a shard's levels pick what JAX's gates pick
    there (``_pick_mxu_tiles`` per scheme, ``_swt_mxu_tiles``)."""
    r, c = shape
    for lvl in range(1, levels + 1):
        mr, mc = r >> lvl, c >> lvl
        want = {s: _pick_mxu_tiles(mr, mc, hlen, s) is not None for s in M.SCHEMES}
        assert set(want.values()) == {K.mxu_route_2d(mr, mc, hlen)}, (shape, lvl)
        want = {s: _swt_mxu_tiles(r, c, hlen, 1 << (lvl - 1), s) is not None
                for s in ("b1", "fd", "b2f")}
        assert set(want.values()) == {K.mxu_route_swt_2d(r, c, hlen, lvl)}, (shape, lvl)


def test_the_dwt_cells_shard_routes_fewer_levels_than_one_card():
    """The DWT cell (2048^2, db7, 5 levels) on (2, 2): a rank's bf16
    forward runs 3 levels on 11p and 2 on 1p (level 4's subbands are 64
    wide on a 1024^2 shard, 128 on one card)."""
    shard = [K.mxu_route_2d(1024 >> lvl, 1024 >> lvl, 14) for lvl in range(1, 6)]
    card = [K.mxu_route_2d(2048 >> lvl, 2048 >> lvl, 14) for lvl in range(1, 6)]
    assert shard == [True] * 3 + [False] * 2 and card == [True] * 4 + [False]


@pytest.mark.parametrize("shape,hlen,levels", SHARDS_1D)
def test_1d_route_rule_is_the_tpu_gate_on_shards(shape, hlen, levels):
    """``mxu_route_1d`` on a shard's levels: JAX's checks of the four 1D
    wrappers (``mxu1d_pallas.py:211-331``: even filter up to 40 taps,
    ``_pick_1d_tiles`` on the outputs or bands, the a-trous span within
    twice the column tile)."""
    B, n = shape
    for lvl in range(1, levels + 1):
        m = n >> lvl  # the decimated forward's input is 2m, its inverse's bands m
        tiles = _pick_1d_tiles(B, m)
        assert K.mxu_route_1d(B, 2 * m, hlen) == (tiles is not None), (shape, lvl)
        tiles = _pick_1d_tiles(B, n)
        want = tiles is not None and (hlen - 1) * (1 << (lvl - 1)) <= 2 * tiles[1]
        assert K.mxu_route_1d(B, n, hlen, level=lvl) == want, (shape, lvl)
