"""The port's pywt containers and drop-ins (``utils/interop.py``) against the
JAX package's ``utils.interop`` and ``tests/np_oracle.py`` (the pywt C
algorithm in numpy) on the CPU.

Inputs are made from a seed with numpy and handed to the port as numpy
arrays with ``device="cpu"`` (a tensor keeps its device) and to JAX as
numpy arrays.  float64 inputs are held to JAX within 1e-12 * max|jax| and
to the oracle within 1e-10; float32 inputs to JAX within 1e-5 * max|jax|
(the same sums in another order), with the dtypes equal.  Containers,
the one-sample crop, the ``None`` rules and the errors (type and text)
are held to JAX's exactly.
"""
import jax
import numpy as np
import pytest
import torch

import np_oracle as O
from pdwt_tpu.filters import get_wavelet as jget
from pdwt_tpu.utils import interop as JI
from pdwt_tpu_torch import Coeffs1D, Coeffs2D, Coeffs3D
from pdwt_tpu_torch.core.separable3d import DETAIL_KEYS_3D
from pdwt_tpu_torch.filters import get_wavelet
from pdwt_tpu_torch.utils import interop as TI

CPU = dict(device="cpu")
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _jj(name, data, *rest, **kw):
    """JAX's ``utils.interop.<name>(data, *rest, **kw)``, jitted over
    ``data`` (an array or a coefficient list): JAX's eager path compiles
    every primitive on its own."""
    fn = getattr(JI, name)
    return jax.jit(lambda d: fn(d, *rest, **kw))(data)


def _rand(shape, dtype=np.float64, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _flat(clist):
    """The arrays of a pywt list (or a tuple pair), in order."""
    out = []
    for item in clist:
        if isinstance(item, dict):
            out += [item[k] for k in DETAIL_KEYS_3D]
        elif isinstance(item, (tuple, list)):
            out += _flat(item)
        else:
            out.append(item)
    return out


def _same(got, want, dtype=np.float64):
    """Same structure, shapes and dtypes; values within RTOL of the largest."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, (dict, list, tuple)):
                assert type(g) is type(w)
                if isinstance(w, dict):
                    assert set(g) == set(w)
    g, w = (_flat(got), _flat(want)) if isinstance(want, (list, tuple)) else ([got], [want])
    w = [np.asarray(a) for a in w]
    assert len(g) == len(w)
    scale = max(float(np.abs(a).max()) for a in w)
    for a, b in zip(g, w):
        assert isinstance(a, torch.Tensor) and tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == b.dtype.name == np.dtype(dtype).name
        assert float(np.abs(a.numpy() - b).max()) <= RTOL[dtype] * scale


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["symmetric", "periodization", "zero", "reflect"])
def test_wavedec_waverec_match_jax(mode, dtype):
    x = _rand((3, 103), dtype)
    want = _jj("wavedec", x, "db3", mode=mode, level=3)
    got = TI.wavedec(x, "db3", mode=mode, level=3, **CPU)
    _same(got, want, dtype)
    _same(TI.waverec(got, "db3", mode=mode), _jj("waverec", want, "db3", mode=mode), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["symmetric", "periodization", ("reflect", "zero")])
def test_wavedec2_waverec2_match_jax(mode, dtype):
    img = _rand((2, 45, 38), dtype, seed=1)
    want = _jj("wavedec2", img, "sym4", mode=mode, level=2)
    got = TI.wavedec2(img, "sym4", mode=mode, level=2, **CPU)
    _same(got, want, dtype)
    if isinstance(mode, str):
        _same(TI.waverec2(got, "sym4", mode=mode), _jj("waverec2", want, "sym4", mode=mode), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["zero", "symmetric", "periodization"])
def test_wavedecn_waverecn_match_jax(mode, dtype):
    vol = _rand((13, 10, 11), dtype, seed=2)
    want = _jj("wavedecn", vol, "db2", mode=mode, level=2)
    got = TI.wavedecn(vol, "db2", mode=mode, level=2, **CPU)
    assert set(got[1]) == set("daa ada dda aad dad add ddd".split())
    _same(got, want, dtype)
    _same(TI.waverecn(got, "db2", mode=mode), _jj("waverecn", want, "db2", mode=mode), dtype)


def test_symmetric_single_levels_match_the_pywt_oracle():
    """pywt's default mode against the numpy statement of pywt's C."""
    jw, w = jget("db3"), get_wavelet("db3")
    x = _rand((50,), seed=3)
    cA, cD = TI.dwt(x, "db3", **CPU)
    lo, hi = O.dwt1_level_mode(x, jw.dec_lo, jw.dec_hi, "symmetric")
    assert np.abs(cA.numpy() - lo).max() <= 1e-10 and np.abs(cD.numpy() - hi).max() <= 1e-10
    y = TI.idwt(cA, cD, w).numpy()
    assert np.abs(y - O.idwt1_level_mode(lo, hi, jw.rec_lo, jw.rec_hi, y.shape[-1])).max() <= 1e-10
    img = _rand((31, 27), seed=4)
    a, (h, v, d) = TI.dwt2(img, "db3", **CPU)
    for g, o in zip((a, h, v, d), O.dwt2_level_mode(img, jw.dec_lo, jw.dec_hi, "symmetric")):
        assert np.abs(g.numpy() - o).max() <= 1e-10
    y2 = TI.idwt2((a, (h, v, d)), w).numpy()
    o2 = O.idwt2_level_mode(a.numpy(), h.numpy(), v.numpy(), d.numpy(), jw.rec_lo, jw.rec_hi,
                            y2.shape)
    assert np.abs(y2 - o2).max() <= 1e-10


def test_single_level_drop_ins_and_none_rules_match_jax():
    x, img = _rand((50,), seed=5), _rand((31, 27), seed=6)
    jc, tc = JI.dwt(x, "db2"), TI.dwt(x, "db2", **CPU)
    _same(tc, jc)
    for args_j, args_t in (((jc[0], jc[1]), tc), ((jc[0], None), (tc[0], None)),
                           ((None, jc[1]), (None, tc[1]))):
        _same(TI.idwt(*args_t, "db2"), JI.idwt(*args_j, "db2"))
    j2, t2 = JI.dwt2(img, "sym4", mode="reflect"), TI.dwt2(img, "sym4", mode="reflect", **CPU)
    _same(t2, j2)
    _same(TI.idwt2(t2, "sym4", mode="reflect"), JI.idwt2(j2, "sym4", mode="reflect"))
    none_j = (j2[0], (None, j2[1][1], None))
    none_t = (t2[0], (None, t2[1][1], None))
    _same(TI.idwt2(none_t, "sym4", mode="reflect"), JI.idwt2(none_j, "sym4", mode="reflect"))
    _same(TI.idwt2((None, (t2[1][0], None, None)), "sym4"),
          JI.idwt2((None, (j2[1][0], None, None)), "sym4"))
    # numpy coefficients with device=
    _same(TI.idwt(np.asarray(jc[0]), None, "db2", **CPU), JI.idwt(jc[0], None, "db2"))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_swt_drop_ins_match_jax(dtype):
    x, img = _rand((2, 64), dtype, seed=7), _rand((32, 32), dtype, seed=8)
    j1, t1 = _jj("swt", x, "db2", 3), TI.swt(x, "db2", 3, **CPU)
    _same(t1, j1, dtype)
    _same(TI.iswt(t1, "db2"), _jj("iswt", j1, "db2"), dtype)
    j2, t2 = _jj("swt2", img, "sym4", 2), TI.swt2(img, "sym4", 2, **CPU)
    _same(t2, j2, dtype)
    _same(TI.iswt2(t2, "sym4"), _jj("iswt2", j2, "sym4"), dtype)
    assert float(np.abs(TI.iswt2(t2, "sym4").numpy() - img).max()) <= 1e-4


def test_default_level_and_level_zero_match_jax():
    x = _rand((64,), seed=9)
    want, got = _jj("wavedec", x, "db7", mode="periodization"), TI.wavedec(
        x, "db7", mode="periodization", **CPU)
    assert len(got) == len(want)
    _same(got, want)
    for fn in ("wavedec", "wavedec2"):
        arr = x if fn == "wavedec" else x.reshape(8, 8)
        got = getattr(TI, fn)(arr, "db7", level=0, **CPU)
        assert len(got) == 1 and np.array_equal(got[0].numpy(), arr)
        assert np.array_equal(TI.waverec(got, "db7").numpy(), arr)
    for n, f in ((103, 6), (1000, "db7"), (64, get_wavelet("sym8")), (7, 8)):
        jf = jget(f.name) if hasattr(f, "name") else f
        assert TI.dwt_max_level(n, f) == JI.dwt_max_level(n, jf)


def test_tensor_inputs_keep_their_device_and_dtype():
    x = torch.from_numpy(_rand((4, 40), np.float32, seed=10))
    cl = TI.wavedec(x, "db2", level=2)
    assert all(t.device == x.device and t.dtype == torch.float32 for t in cl)
    with pytest.raises(ValueError, match="move it first"):
        TI.wavedec(x, "db2", level=2, device="meta")


def test_container_round_trips_match_jax():
    rng = np.random.default_rng(11)
    a, d1, d2 = rng.standard_normal((4,)), rng.standard_normal((8,)), rng.standard_normal((4,))
    c1 = TI.from_pywt([a, d2, d1], **CPU)
    assert isinstance(c1, Coeffs1D) and c1.levels == 2 and np.array_equal(c1.details[0], d1)
    _same(TI.to_pywt(c1), JI.to_pywt(JI.from_pywt([a, d2, d1])))
    bands = [tuple(rng.standard_normal((n, n)) for _ in range(3)) for n in (2, 4)]
    l2 = [rng.standard_normal((2, 2))] + bands
    c2 = TI.from_pywt(l2, **CPU)
    assert isinstance(c2, Coeffs2D) and c2.levels == 2
    _same(TI.to_pywt(c2), JI.to_pywt(JI.from_pywt(l2)))
    l3 = [rng.standard_normal((2, 2, 2))] + [{k: rng.standard_normal((n,) * 3)
                                               for k in DETAIL_KEYS_3D} for n in (2, 4)]
    c3 = TI.from_pywt(l3, **CPU)
    assert isinstance(c3, Coeffs3D) and c3.levels == 2
    _same(TI.to_pywt(c3), JI.to_pywt(JI.from_pywt(l3)))


def _err(fn):
    try:
        fn()
    except (TypeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


@pytest.mark.parametrize("call", [
    lambda m: m.to_pywt([1, 2, 3]),
    lambda m: m.from_pywt(np.zeros((4, 4))),
    lambda m: m.from_pywt([]),
    lambda m: m.from_pywt([np.zeros((4, 4))]),
    lambda m: m.from_pywt([np.zeros((4, 4)), (np.zeros((4, 4)),)]),
    lambda m: m.from_pywt([np.zeros((4, 4)), {"daa": np.zeros((4, 4))}]),
    lambda m: m.wavedec(np.zeros(64), "db7", level=-1),
    lambda m: m.wavedecn(np.zeros((8, 8)), "db2"),
    lambda m: m.idwt(None, None, "db2"),
    lambda m: m.idwt2((None, (None, None, None)), "db2"),
    lambda m: m.waverec([np.zeros(20), np.zeros(17)], "db3"),
    lambda m: m.waverec2([np.zeros((9, 9)), tuple(np.zeros((5, 9)) for _ in range(3))], "db3"),
], ids=["to_pywt_type", "from_pywt_type", "from_pywt_empty", "no_details", "triples",
        "missing_key", "negative_level", "wavedecn_2d", "idwt_none", "idwt2_none",
        "corrupt_1d", "corrupt_2d"])
def test_errors_are_jaxs(call):
    """Every error with JAX's type and text (the crop's included)."""
    want = _err(lambda: call(JI))
    got = _err(lambda: call(_CpuTI))
    assert got == want != "no error"


class _CpuTI:
    """``TI`` with ``device="cpu"`` on every call that takes it."""

    def __getattr__(self, name):
        fn = getattr(TI, name)
        if name in ("to_pywt", "dwt_max_level"):
            return fn
        return lambda *a, **k: fn(*a, **{**CPU, **k})


_CpuTI = _CpuTI()


def test_crop_trims_one_sample_as_jax():
    """A reconstructed approximation one sample longer than the next
    detail is cropped, per axis (pywt's waverec alignment): odd sides,
    symmetric, three levels."""
    x = _rand((2, 37, 29), seed=12)
    want = _jj("wavedec2", x, "db2", level=3)
    got = TI.wavedec2(x, "db2", level=3, **CPU)
    assert [t.shape[-2:] for t in _flat(got)] == [w.shape[-2:] for w in _flat(want)]
    _same(TI.waverec2(got, "db2"), _jj("waverec2", want, "db2"))
