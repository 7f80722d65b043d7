"""Wavelet filter bank of the PyTorch port.

Counterpart of ``pdwt_tpu/filters/bank.py``.  The code is numpy only and
reads the port's own copy of the coefficient tables, ``_data.npz`` beside
this module (the same arrays as the JAX package's; the port uses nothing
of that package).

* name lookup is case-insensitive, and the haar aliases db1 / bior1.1 /
  rbio1.1 / rbior1.1 resolve to haar;
* a ``modwt-`` prefix resolves the base name and rescales it into the
  MODWT-normalised bank;
* custom filters of any length are accepted (``MAX_FILTER_WIDTH`` only
  records the reference's 40-tap bound), and ``register_wavelet`` makes one
  known by name;
* ``quad_filters`` builds the non-separable transform's outer-product
  quads, and ``factor_quads`` recognises jointly separable quads.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import numpy as np

#: the reference's custom-filter bound (a CUDA constant buffer); the port
#: takes longer filters, as the JAX package does
MAX_FILTER_WIDTH = 40

_DATA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_data.npz")

_HAAR_ALIASES = ("db1", "bior1.1", "rbio1.1", "rbior1.1")


@dataclasses.dataclass(frozen=True)
class Wavelet:
    """A 1D biorthogonal filter bank: float64 ``dec_lo``, ``dec_hi``
    (analysis) and ``rec_lo``, ``rec_hi`` (synthesis), all of length
    ``hlen`` (pywt's conventions)."""

    name: str
    dec_lo: np.ndarray
    dec_hi: np.ndarray
    rec_lo: np.ndarray
    rec_hi: np.ndarray

    def __post_init__(self):
        for f in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
            arr = np.ascontiguousarray(np.asarray(getattr(self, f), dtype=np.float64))
            if arr.ndim != 1:
                raise ValueError(f"{f} must be 1D, got shape {arr.shape}")
            object.__setattr__(self, f, arr)
        hl = len(self.dec_lo)
        if not (len(self.dec_hi) == len(self.rec_lo) == len(self.rec_hi) == hl):
            raise ValueError("all four filters must have the same length")
        if hl < 2:
            raise ValueError("filter length must be >= 2")

    @property
    def hlen(self) -> int:
        return len(self.dec_lo)

    def __hash__(self):
        return hash((self.name, self.dec_lo.tobytes(), self.dec_hi.tobytes(),
                     self.rec_lo.tobytes(), self.rec_hi.tobytes()))

    def __eq__(self, other):
        if not isinstance(other, Wavelet):
            return NotImplemented
        return (self.name == other.name
                and np.array_equal(self.dec_lo, other.dec_lo)
                and np.array_equal(self.dec_hi, other.dec_hi)
                and np.array_equal(self.rec_lo, other.rec_lo)
                and np.array_equal(self.rec_hi, other.rec_hi))


_BUILTIN: Dict[str, Wavelet] = {}
_USER: Dict[str, Wavelet] = {}


def _load_builtin() -> None:
    if _BUILTIN:
        return
    with np.load(_DATA_PATH) as data:
        for name in data.files:
            bank = data[name]
            _BUILTIN[name] = Wavelet(name, bank[0], bank[1], bank[2], bank[3])


def list_wavelets() -> Tuple[str, ...]:
    """All known wavelet names: the 72 built-in banks, the haar aliases and
    those registered with :func:`register_wavelet`."""
    _load_builtin()
    return tuple(sorted(set(_BUILTIN) | set(_HAAR_ALIASES) | set(_USER)))


def get_wavelet(name: str) -> Wavelet:
    """Case-insensitive lookup; ``modwt-<name>`` gives the MODWT bank."""
    _load_builtin()
    key = name.lower()
    if key in _USER:
        return _USER[key]
    if key.startswith("modwt-"):
        return modwt_wavelet(get_wavelet(key[len("modwt-"):]))
    if key in _HAAR_ALIASES:
        key = "haar"
    try:
        return _BUILTIN[key]
    except KeyError:
        raise ValueError(
            f"unknown wavelet {name!r}; available: {', '.join(list_wavelets())}"
        ) from None


def make_custom_wavelet(name: str, dec_lo, dec_hi, rec_lo, rec_hi) -> Wavelet:
    """A custom filter bank of any length."""
    return Wavelet(name.lower(), dec_lo, dec_hi, rec_lo, rec_hi)


def register_wavelet(w: Wavelet) -> None:
    """Make ``w`` known to :func:`get_wavelet` under its lower-cased name
    (ahead of a built-in bank of that name)."""
    _load_builtin()
    _USER[w.name.lower()] = w


def modwt_wavelet(wav) -> Wavelet:
    """The MODWT-normalised bank of ``wav`` (a :class:`Wavelet` or name):
    analysis filters scaled by 1/sqrt(2), synthesis filters by sqrt(2)."""
    if isinstance(wav, str):
        wav = get_wavelet(wav)
    s = np.sqrt(0.5)
    return Wavelet("modwt-" + wav.name, wav.dec_lo * s, wav.dec_hi * s,
                   wav.rec_lo / s, wav.rec_hi / s)


def quad_filters(lo, hi, transpose_detail_convention: bool = False) -> np.ndarray:
    """The outer-product 2D quad (LL, LH, HL, HH), shape (4, hlen, hlen),
    of the non-separable transform.  LH is H of the separable transform
    (high-pass along the rows, the first axis), HL is V;
    ``transpose_detail_convention=True`` swaps them, as the reference's
    non-separable engine lays them out."""
    ll = np.outer(lo, lo)
    lh = np.outer(hi, lo)
    hl = np.outer(lo, hi)
    hh = np.outer(hi, hi)
    if transpose_detail_convention:
        lh, hl = hl, lh
    return np.stack([ll, lh, hl, hh])


def factor_quads(quads, rtol: float = 1e-9):
    """Per-axis 1D filters ``(lo_rows, hi_rows, lo_cols, hi_cols)`` of a
    jointly separable quad set (LL = outer(lo_r, lo_c), LH = outer(hi_r,
    lo_c), HL = outer(lo_r, hi_c), HH = outer(hi_r, hi_c)), or None.  The
    only tolerance is ``rtol`` times the largest entry."""
    q = np.asarray(quads, dtype=np.float64)
    if q.ndim != 3 or q.shape[0] != 4:
        return None
    scale = float(np.abs(q).max())
    if scale == 0.0:
        return None

    def rank1(m):
        u, s, vt = np.linalg.svd(m)
        if s[0] < rtol * scale or (len(s) > 1 and s[1] > rtol * scale):
            return None
        r = np.sqrt(s[0])
        return u[:, 0] * r, vt[0] * r

    f_ll, f_hh = rank1(q[0]), rank1(q[3])
    if f_ll is None or f_hh is None:
        return None
    lo_r, lo_c = f_ll
    hi_r, hi_c = f_hh
    # left free: hi_r *= a, hi_c /= a; LH fixes a, HL must then agree
    base = np.outer(hi_r, lo_c)
    denom = float(np.vdot(base, base))
    if denom < (rtol * scale) ** 2:
        return None
    a = float(np.vdot(base, q[1])) / denom
    if abs(a) < rtol:
        return None
    if not np.allclose(q[1], a * base, rtol=0.0, atol=rtol * scale):
        return None
    if not np.allclose(q[2], np.outer(lo_r, hi_c) / a, rtol=0.0, atol=rtol * scale):
        return None
    return lo_r, a * hi_r, lo_c, hi_c / a
