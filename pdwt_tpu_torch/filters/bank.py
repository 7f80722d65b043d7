"""Wavelet filter bank of the PyTorch port.

Counterpart of ``pdwt_tpu/filters/bank.py``.  The code is numpy only and
reads the same coefficient tables, ``pdwt_tpu/filters/_data.npz``, by
path: importing ``pdwt_tpu`` would pull in JAX.

* name lookup is case-insensitive, and the haar aliases db1 / bior1.1 /
  rbio1.1 / rbior1.1 resolve to haar;
* a ``modwt-`` prefix resolves the base name and rescales it into the
  MODWT-normalised bank;
* custom filters of any length are accepted.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import numpy as np

_DATA_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "pdwt_tpu", "filters", "_data.npz")

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


def _load_builtin() -> None:
    if _BUILTIN:
        return
    with np.load(_DATA_PATH) as data:
        for name in data.files:
            bank = data[name]
            _BUILTIN[name] = Wavelet(name, bank[0], bank[1], bank[2], bank[3])


def list_wavelets() -> Tuple[str, ...]:
    """All built-in wavelet names (72 banks) and the haar aliases."""
    _load_builtin()
    return tuple(sorted(set(_BUILTIN) | set(_HAAR_ALIASES)))


def get_wavelet(name: str) -> Wavelet:
    """Case-insensitive lookup; ``modwt-<name>`` gives the MODWT bank."""
    _load_builtin()
    key = name.lower()
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


def modwt_wavelet(wav) -> Wavelet:
    """The MODWT-normalised bank of ``wav`` (a :class:`Wavelet` or name):
    analysis filters scaled by 1/sqrt(2), synthesis filters by sqrt(2)."""
    if isinstance(wav, str):
        wav = get_wavelet(wav)
    s = np.sqrt(0.5)
    return Wavelet("modwt-" + wav.name, wav.dec_lo * s, wav.dec_hi * s,
                   wav.rec_lo / s, wav.rec_hi / s)
