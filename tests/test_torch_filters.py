"""The port's filter bank and size bookkeeping against the JAX package's."""
import numpy as np
import pytest

from pdwt_tpu.core import shapes as jshapes
from pdwt_tpu.filters import bank as jbank
from pdwt_tpu_torch.core import shapes
from pdwt_tpu_torch.filters import bank, get_wavelet, list_wavelets, make_custom_wavelet

with np.load(jbank._DATA_PATH) as _data:
    BUILTIN = sorted(_data.files)

FILTERS = ("dec_lo", "dec_hi", "rec_lo", "rec_hi")


def _same(w, j):
    assert w.name == j.name and w.hlen == j.hlen
    for f in FILTERS:
        a, b = getattr(w, f), getattr(j, f)
        assert a.dtype == b.dtype == np.float64
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("name", BUILTIN)
def test_bank_matches_jax_bit_for_bit(name):
    _same(get_wavelet(name), jbank.get_wavelet(name))


@pytest.mark.parametrize("alias", ["db1", "bior1.1", "rbio1.1", "rbior1.1", "HAAR",
                                   "Db7", "BIOR4.4", "modwt-db4", "MODWT-sym8",
                                   "modwt-db1"])
def test_aliases_match_jax(alias):
    _same(get_wavelet(alias), jbank.get_wavelet(alias))


def test_list_wavelets():
    assert len(BUILTIN) == 72
    assert set(list_wavelets()) == set(BUILTIN) | set(jbank._HAAR_ALIASES)


def test_unknown_wavelet_raises():
    with pytest.raises(ValueError, match="unknown wavelet"):
        get_wavelet("db99")


def test_custom_wavelet_matches_jax():
    f = np.random.default_rng(3).standard_normal((4, 7))
    _same(make_custom_wavelet("MyBank", *f), jbank.make_custom_wavelet("MyBank", *f))
    with pytest.raises(ValueError, match="same length"):
        make_custom_wavelet("bad", f[0], f[1], f[2], f[3][:5])
    with pytest.raises(ValueError, match=">= 2"):
        make_custom_wavelet("bad", [1.0], [1.0], [1.0], [1.0])
    assert hash(get_wavelet("db3")) == hash(bank.get_wavelet("db3"))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 65, 127, 2047, 2048])
def test_shapes_match_jax(n):
    assert shapes.div2(n) == jshapes.div2(n)
    assert shapes.ilog2(n) == jshapes.ilog2(n)
    assert shapes.level_sizes(n, 6) == jshapes.level_sizes(n, 6)
    for hlen in (2, 14, 40):
        assert shapes.max_level(n, hlen) == jshapes.max_level(n, hlen)
    assert shapes.coeff_shapes_2d(n, n + 3, 3) == jshapes.coeff_shapes_2d(n, n + 3, 3, False)
