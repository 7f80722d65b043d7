"""The benchmark's plain reference: periodized separable wavelet transforms
over the trailing ``ndim`` axes, as dense matrix products in plain PyTorch.

It imports nothing of the program under test and takes nothing the program
made: its filters are its own frozen taps (``taps/<name>.json``), and it
works from the inputs the benchmark made.

One pass along an axis of length N is ``y = x @ M`` with M the (N, 2 n_out)
matrix of the two filters, low-pass columns first.  With ``s = hlen / 2``:

* decimated analysis   ``lo[n] = sum_k dec_lo[k] x[(2n + s - k) mod N]``
  (``hi`` with ``dec_hi``), ``n_out = N / 2``;
* stationary analysis at level L, ``f = 2^(L-1)``:
  ``lo[n] = sum_k dec_lo[k] x[(n + (s - k) f) mod N]``, ``n_out = N``.

For an orthogonal bank the decimated pass matrix is orthogonal, so the
synthesis is its transpose; the stationary pass satisfies ``M M^T = 2 I``,
so its synthesis is half its transpose.  Bands are numbered as the analysis
channel: the last axis's filter bit is the most significant (2D: a, H, V, D,
H high-pass along the rows; 3D: ``4 k_col + 2 k_row + k_dep``).

``dtype`` is float64 for the reference.  float32 under :func:`tf32` is the
control: the same products with TF32 operands on the card.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
from typing import List, Sequence, Tuple

import torch

_TAPS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "taps")

Bank = Tuple[Tuple[float, ...], Tuple[float, ...]]


@functools.lru_cache(maxsize=None)
def orthogonal_bank(name: str) -> Bank:
    """(dec_lo, dec_hi) of the orthogonal wavelet ``name`` from its frozen
    synthesis low-pass: ``dec_lo = rec_lo`` reversed, and the quadrature
    mirror ``dec_hi[k] = (-1)^(k+1) dec_lo[hlen - 1 - k]``."""
    with open(os.path.join(_TAPS_DIR, f"{name}.json")) as f:
        rec_lo = [float(v) for v in json.load(f)["rec_lo"]]
    hlen = len(rec_lo)
    if hlen % 2:
        raise ValueError(f"an orthogonal bank has an even length, {name} has {hlen}")
    dec_lo = tuple(rec_lo[::-1])
    dec_hi = tuple((-1) ** (k + 1) * dec_lo[hlen - 1 - k] for k in range(hlen))
    return dec_lo, dec_hi


@contextlib.contextmanager
def tf32():
    """Let float32 matrix products run with TF32 operands (the control)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def pass_matrix(bank: Bank, n: int, dilation: int, decimate: bool, dtype, device) -> torch.Tensor:
    """The (n, 2 n_out) matrix of one analysis pass (module docstring)."""
    if decimate and (n % 2 or dilation != 1):
        raise ValueError(f"the decimated pass takes an even length and no dilation, got {n}")
    hlen = len(bank[0])
    s = hlen // 2
    n_out = n // 2 if decimate else n
    out = torch.arange(n_out, dtype=torch.int64)
    m = torch.zeros(n, 2 * n_out, dtype=torch.float64)
    for j, g in enumerate(bank):
        for k, tap in enumerate(g):
            rows = ((2 * out if decimate else out) + (s - k) * dilation) % n
            m.index_put_((rows, out + j * n_out), torch.full((n_out,), tap, dtype=torch.float64),
                         accumulate=True)
    return m.to(device=device, dtype=dtype)


class Passes:
    """The pass matrices of one bank, built once per (axis length, dilation,
    decimation) on one device in one dtype."""

    def __init__(self, name: str, dtype, device):
        self.bank = orthogonal_bank(name)
        self.dtype, self.device = dtype, device
        self._cache = {}

    def matrix(self, n: int, dilation: int, decimate: bool) -> torch.Tensor:
        key = (n, dilation, decimate)
        if key not in self._cache:
            self._cache[key] = pass_matrix(self.bank, n, dilation, decimate, self.dtype,
                                           self.device)
        return self._cache[key]

    def analysis(self, x: torch.Tensor, axis: int, dilation: int, decimate: bool):
        m = self.matrix(x.shape[axis], dilation, decimate)
        y = torch.matmul(x.movedim(axis, -1), m)
        half = y.shape[-1] // 2
        return y[..., :half].movedim(-1, axis), y[..., half:].movedim(-1, axis)

    def synthesis(self, lo: torch.Tensor, hi: torch.Tensor, axis: int, dilation: int,
                  decimate: bool) -> torch.Tensor:
        n = lo.shape[axis] * (2 if decimate else 1)
        m = self.matrix(n, dilation, decimate)
        y = torch.matmul(torch.cat([lo.movedim(axis, -1), hi.movedim(axis, -1)], dim=-1), m.T)
        return (y if decimate else 0.5 * y).movedim(-1, axis)


def analysis_nd(p: Passes, x: torch.Tensor, ndim: int, dilation: int = 1,
                decimate: bool = True) -> List[torch.Tensor]:
    """The 2^ndim bands of one level, the last axis filtered first."""
    bands = [x]
    for axis in range(-1, -ndim - 1, -1):
        bands = [b for band in bands for b in p.analysis(band, axis, dilation, decimate)]
    return bands


def synthesis_nd(p: Passes, bands: Sequence[torch.Tensor], ndim: int, dilation: int = 1,
                 decimate: bool = True) -> torch.Tensor:
    """Inverse of :func:`analysis_nd`: the first of the trailing axes first."""
    bands = list(bands)
    for axis in range(-ndim, 0):
        bands = [p.synthesis(bands[i], bands[i + 1], axis, dilation, decimate)
                 for i in range(0, len(bands), 2)]
    return bands[0]


def dwt(p: Passes, x: torch.Tensor, levels: int, ndim: int):
    """(approx, details): ``details[i]`` holds the 2^ndim - 1 bands of
    level i + 1."""
    a, details = x.to(p.dtype), []
    for _ in range(levels):
        bands = analysis_nd(p, a, ndim)
        a = bands[0]
        details.append(tuple(bands[1:]))
    return a, tuple(details)


def idwt(p: Passes, approx: torch.Tensor, details, ndim: int) -> torch.Tensor:
    a = approx
    for bands in reversed(details):
        a = synthesis_nd(p, (a,) + tuple(bands), ndim)
    return a


def swt(p: Passes, x: torch.Tensor, levels: int, ndim: int):
    """The stationary transform: every band at the input's size, level L's
    taps 2^(L-1) apart, unnormalized."""
    a, details = x.to(p.dtype), []
    for level in range(1, levels + 1):
        bands = analysis_nd(p, a, ndim, dilation=2 ** (level - 1), decimate=False)
        a = bands[0]
        details.append(tuple(bands[1:]))
    return a, tuple(details)


def soft(x: torch.Tensor, beta: float) -> torch.Tensor:
    return torch.sign(x) * torch.clamp_min(x.abs() - beta, 0)


def iswt_soft(p: Passes, approx: torch.Tensor, details, ndim: int, beta: float) -> torch.Tensor:
    """The inverse stationary transform of the soft-thresholded details
    (the approximation kept)."""
    a = approx
    for level in range(len(details), 0, -1):
        bands = (a,) + tuple(soft(b, beta) for b in details[level - 1])
        a = synthesis_nd(p, bands, ndim, dilation=2 ** (level - 1), decimate=False)
    return a


def soft_norm1(approx: torch.Tensor, details, beta: float) -> torch.Tensor:
    """The L1 norm of the soft-thresholded tree, the approximation kept:
    ``sum max(|d| - beta, 0) + sum |a|``."""
    total = approx.abs().sum()
    for bands in details:
        for b in bands:
            total = total + torch.clamp_min(b.abs() - beta, 0).sum()
    return total


def level_sizes_even(shape: Sequence[int], levels: int) -> None:
    """Raise unless every decimated level halves an even size."""
    for n in shape:
        if n % (2 ** levels):
            raise ValueError(f"size {n} does not halve evenly over {levels} levels")
