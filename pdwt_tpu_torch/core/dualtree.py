"""Dual-tree complex wavelet transform (Kingsbury's DT-CWT), 1D and 2D
(counterpart of ``pdwt_tpu/core/dualtree.py``).

Two orthonormal DWT trees whose wavelets form an approximate Hilbert pair,
so the complex coefficients' magnitudes are nearly shift-invariant and the
2D transform resolves six orientations, at 2x (1D) or 4x (2D) redundancy.

Filter design (numpy, the JAX package's own): Selesnick's common-factor
construction.  Tree B's lowpass is tree A's times the maximally flat
Thiran allpass ``z^-L d(1/z) / d(z)`` of a half-sample delay,

    H0(z) = F(z) d(z),     G0(z) = F(z) z^-L d(1/z),

with the common factor F the spectral factor of the halfband solution that
makes each bank an orthonormal CQF.

Level 1 runs tree A's bank in both trees, tree B's input rolled by one
sample; deeper levels run the (A, B) half-delay pair, tree B's outputs
rolled back by the allpass's integer delay (:func:`_treeB_roll`).
Periodic boundaries throughout.

The uniform combos (both axes on one tree) run ``core.separable``'s
``dwt2d``/``idwt2d`` (kernels 1 and 2, in 1D 7 and 8); the mixed row/column
combos of the 2D transform run the per-axis conv passes, as JAX runs its
fma passes there.  Complex bands are complex64 from float32 (and bf16,
which ``_real`` promotes), complex128 from float64.
"""
from __future__ import annotations

import functools
import math
from math import comb
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..filters import Wavelet
from . import conv
from .separable import Coeffs1D, Coeffs2D, dwt1d, dwt2d, idwt1d, idwt2d
from .shapes import level_sizes

_SQ2 = np.sqrt(2.0)


# ---------------------------------------------------------------------------
# filter design (numpy)
# ---------------------------------------------------------------------------

def _thiran_half(L: int, tau: float = 0.54) -> np.ndarray:
    """Denominator d of the maximally flat allpass z^-L d(1/z)/d(z) whose
    phase delay is L + tau (flat at DC).  tau = 0.54 biases the nominal
    half-sample delay slightly high: maximal flatness at DC underweights
    the top of the lowpass band, where the Thiran delay sags."""
    D = L + tau
    a = np.zeros(L + 1)
    for k in range(L + 1):
        p = 1.0
        for n in range(L + 1):
            p *= (D - L + n) / (D - L + k + n)
        a[k] = (-1) ** k * comb(L, k) * p
    return a


@functools.lru_cache(maxsize=None)
def design_dtcwt_banks(L: int = 2, K: int = 4):
    """(h0, g0): the common-factor Hilbert-pair lowpass banks as float64
    arrays (orthonormal CQFs; the default gives 14 taps).  Cached."""
    d = _thiran_half(L)
    S = np.convolve(d, d[::-1])
    q = np.array([comb(K, i) for i in range(K + 1)], float)
    QK = np.convolve(q, q[::-1])
    for Nf in range(K + 2, 64):
        M = Nf - 1 - K
        ncon = (Nf - 1 + L) // 2 + 1
        if M + 1 == ncon:
            break
    else:  # pragma: no cover - only tiny L/K are used
        raise ValueError(f"no consistent degree for L={L}, K={K}")
    A = np.zeros((ncon, M + 1))
    b = np.zeros(ncon)
    b[0] = 1.0
    base = np.convolve(QK, S)
    for j in range(M + 1):
        T = np.zeros(2 * M + 1)
        T[M + j] += 1.0
        T[M - j] += 1.0
        if j == 0:
            T[M] = 1.0
        P = np.convolve(base, T)
        c = len(P) // 2
        for m in range(ncon):
            A[m, j] = P[c + 2 * m]
    t = np.linalg.solve(A, b)
    T = np.zeros(2 * M + 1)
    T[M] = t[0]
    for j in range(1, M + 1):
        T[M + j] = t[j]
        T[M - j] = t[j]
    w = np.linspace(0, np.pi, 4096)
    Tw = np.real(np.polyval(T, np.exp(1j * w)) * np.exp(-1j * w * M))
    if Tw.min() < -1e-9:  # pragma: no cover - defaults validated in tests
        raise ValueError(f"T(w) not nonnegative for L={L}, K={K}: "
                         f"{Tw.min():.2e} — pick other orders")
    rts = np.roots(T)
    f1 = np.real(np.poly(rts[np.abs(rts) < 1.0]))
    F = np.convolve(f1, q)
    h0 = np.convolve(F, d)
    h0 /= np.linalg.norm(h0)
    g0 = np.convolve(F, d[::-1])
    g0 /= np.linalg.norm(g0)
    return h0, g0


def _orth_wavelet(name: str, h0: np.ndarray) -> Wavelet:
    n = len(h0)
    h1 = np.array([(-1) ** k * h0[n - 1 - k] for k in range(n)])
    return Wavelet(name, h0, h1, h0[::-1], h1[::-1])


@functools.lru_cache(maxsize=None)
def dtcwt_wavelets(L: int = 2, K: int = 4) -> Tuple[Wavelet, Wavelet]:
    """The (tree A, tree B) orthonormal banks as :class:`Wavelet` objects
    usable with every transform of the package."""
    if L % 2:
        raise ValueError("L must be even: the transform compensates the "
                         "allpass's integer delay L by rolling tree B "
                         "L/2 samples per level")
    h0, g0 = design_dtcwt_banks(L, K)
    return (_orth_wavelet(f"dtcwt-a-{L}-{K}", h0),
            _orth_wavelet(f"dtcwt-b-{L}-{K}", g0))


def _treeB_roll(L: int) -> int:
    """Samples to roll tree-B outputs per level >= 2: the allpass delays
    by L + 1/2; its integer part L (L/2 at the decimated rate) is undone
    so the inter-tree offset stays half a sample at every level's rate."""
    return L // 2


def _real(t: torch.Tensor) -> torch.Tensor:
    """The mixing dtype: float32 for bf16 and float32, float64 stays."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _cplx(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(re + i im) / sqrt(2), complex64 from float32, complex128 from
    float64: the division is by a 0-dim tensor, as JAX divides."""
    z = torch.complex(re, im)
    return z / torch.full((), _SQ2, dtype=re.dtype, device=re.device)


def _div_sq2(t: torch.Tensor) -> torch.Tensor:
    return t / torch.full((), _SQ2, dtype=t.dtype, device=t.device)


def _mul_sq2(t: torch.Tensor) -> torch.Tensor:
    return t * torch.full((), _SQ2, dtype=t.dtype, device=t.device)


# ---------------------------------------------------------------------------
# 1D transform
# ---------------------------------------------------------------------------

class DTCoeffs1D(NamedTuple):
    """``details[j]`` is the complex detail of level j+1 (finest first),
    (d_A + i d_B)/sqrt(2); ``approx`` stacks the two trees' final lowpass
    on a leading axis (exact inversion needs both)."""
    approx: torch.Tensor                      # (2,) + batch + (n_J,)
    details: Tuple[torch.Tensor, ...]

    @property
    def levels(self) -> int:
        return len(self.details)


def dtcwt1d(x: torch.Tensor, levels: int, *, order: Tuple[int, int] = (2, 4),
            backend: Optional[str] = None) -> DTCoeffs1D:
    """Dual-tree complex 1D DWT over the trailing axis (leading axes are
    batch).  The length must be divisible by 2^levels (the two trees'
    grids must stay aligned)."""
    wa, wb = dtcwt_wavelets(*order)
    roll = -_treeB_roll(order[0])
    n = x.shape[-1]
    if n % (1 << levels):
        raise ValueError(f"size {n} not divisible by 2^{levels} "
                         "(the dual trees' grids would desynchronize)")
    ca = dwt1d(x, wa, levels, backend=backend)
    c1 = dwt1d(torch.roll(x, 1, dims=-1), wa, 1, backend=backend)
    b_details = [c1.details[0]]
    b_approx = c1.approx
    for _ in range(1, levels):
        c = dwt1d(b_approx, wb, 1, backend=backend)
        # undo the allpass's integer delay (L input samples = L/2 out)
        b_approx = torch.roll(c.approx, roll, dims=-1)
        b_details.append(torch.roll(c.details[0], roll, dims=-1))
    details = tuple(_cplx(_real(da), _real(db)) for da, db in zip(ca.details, b_details))
    return DTCoeffs1D(torch.stack([ca.approx, b_approx], dim=0), details)


def idtcwt1d(coeffs: DTCoeffs1D, length: int, *, order: Tuple[int, int] = (2, 4),
             backend: Optional[str] = None) -> torch.Tensor:
    """Inverse of :func:`dtcwt1d` (exact: each tree is PR; the two
    reconstructions are averaged)."""
    wa, wb = dtcwt_wavelets(*order)
    roll = -_treeB_roll(order[0])
    da = tuple(_mul_sq2(c.real) for c in coeffs.details)
    db = tuple(_mul_sq2(c.imag) for c in coeffs.details)
    ya = idwt1d(Coeffs1D(coeffs.approx[0], da), wa, length, backend=backend)
    lens = level_sizes(length, coeffs.levels)
    a = coeffs.approx[1]
    for j in range(coeffs.levels - 1, 0, -1):
        a = torch.roll(a, -roll, dims=-1)
        d = torch.roll(db[j], -roll, dims=-1)
        a = idwt1d(Coeffs1D(a, (d,)), wb, lens[j], backend=backend)
    yb = idwt1d(Coeffs1D(a, db[:1]), wa, length, backend=backend)
    yb = torch.roll(yb, -1, dims=-1)
    return (ya + yb) * 0.5


# ---------------------------------------------------------------------------
# 2D transform
# ---------------------------------------------------------------------------

class DTCoeffs2D(NamedTuple):
    """``details[j]``: complex ``batch + (6, r_j, c_j)``, the six oriented
    subbands of level j+1 ordered (h+, h-, v+, v-, d+, d-), h/v/d the real
    DWT's band convention and +/- the two conjugate-orientation partners.
    ``approx`` stacks the four (row-tree, column-tree) lowpass combos (AA,
    AB, BA, BB) on a leading axis."""
    approx: torch.Tensor                      # (4,) + batch + (r_J, c_J)
    details: Tuple[torch.Tensor, ...]

    @property
    def levels(self) -> int:
        return len(self.details)


_COMBOS = ((0, 0), (0, 1), (1, 0), (1, 1))    # (row tree, column tree)


def _conv_backend(backend: Optional[str]) -> Optional[str]:
    """The mixed combos' passes have no kernel form: ``"pallas"`` runs the
    default formulation."""
    return None if backend == "pallas" else backend


def _level_fwd_mixed(a: torch.Tensor, wr: Wavelet, wc: Wavelet, backend=None
                     ) -> Tuple[torch.Tensor, ...]:
    """One decimated 2D level with per-axis wavelets on (..., r, c), on the
    conv passes: (a, h, v, d) in the package's channel convention."""
    batch = tuple(a.shape[:-2])
    be = _conv_backend(backend)
    z = a.reshape((-1, 1) + tuple(a.shape[-2:]))
    z = conv.analysis_pass(z, (wc.dec_lo, wc.dec_hi), axis=-1, backend=be)
    z = conv.analysis_pass(z, (wr.dec_lo, wr.dec_hi), axis=-2, backend=be)
    return tuple(z[:, k].reshape(batch + tuple(z.shape[-2:])) for k in range(4))


def _level_inv_mixed(bands, wr: Wavelet, wc: Wavelet, out_rc, backend=None) -> torch.Tensor:
    batch = tuple(bands[0].shape[:-2])
    be = _conv_backend(backend)
    z = torch.stack([t.reshape((-1,) + tuple(t.shape[-2:])) for t in bands], dim=1)
    z = conv.synthesis_pass(z, (wr.rec_lo, wr.rec_hi), axis=-2, out_len=out_rc[0], backend=be)
    z = conv.synthesis_pass(z, (wc.rec_lo, wc.rec_hi), axis=-1, out_len=out_rc[1], backend=be)
    return z[:, 0].reshape(batch + tuple(z.shape[-2:]))


def _mix(bA, bB, bC, bD):
    """(AA, AB, BA, BB) real bands -> the two conjugate-orientation complex
    bands by the unitary sum/difference mixing."""
    return _cplx(bA - bD, bB + bC), _cplx(bA + bD, bB - bC)


def _unmix(z1, z2):
    re1, im1 = z1.real, z1.imag
    re2, im2 = z2.real, z2.imag
    return (_div_sq2(re1 + re2), _div_sq2(im1 + im2), _div_sq2(im1 - im2),
            _div_sq2(re2 - re1))


def _roll_axes(t: torch.Tensor, shift: int, rt: int, ct: int) -> torch.Tensor:
    """Roll the tree-B axes of a (row tree, column tree) combo."""
    dims = [d for d, on in ((-2, rt), (-1, ct)) if on]
    return torch.roll(t, (shift,) * len(dims), dims=dims) if dims else t


def dtcwt2d(x: torch.Tensor, levels: int, *, order: Tuple[int, int] = (2, 4),
            backend: Optional[str] = None) -> DTCoeffs2D:
    """Dual-tree complex 2D DWT over the trailing two axes: six oriented
    complex subbands per level at 4x redundancy."""
    wa, wb = dtcwt_wavelets(*order)
    nr, nc = x.shape[-2:]
    if nr % (1 << levels) or nc % (1 << levels):
        raise ValueError(f"shape {(nr, nc)} not divisible by 2^{levels}")
    # level 1: tree A's bank in all four combos, tree-B axes rolled
    approxes = []
    lvl1 = []
    for rt, ct in _COMBOS:
        c = dwt2d(_roll_axes(x, 1, rt, ct), wa, 1, backend=backend)
        approxes.append(c.approx)
        lvl1.append(c.details[0])
    details = [lvl1]
    wsel = (wa, wb)
    roll = -_treeB_roll(order[0])
    for _ in range(1, levels):
        nxt, lvl = [], []
        for (rt, ct), a in zip(_COMBOS, approxes):
            if rt == ct:
                c = dwt2d(a, wsel[rt], 1, backend=backend)
                aa, bands = c.approx, c.details[0]
            else:
                aa, h, v, d = _level_fwd_mixed(a, wsel[rt], wsel[ct], backend)
                bands = (h, v, d)
            # undo the tree-B allpass's integer delay per tree-B axis
            nxt.append(_roll_axes(aa, roll, rt, ct))
            lvl.append(tuple(_roll_axes(t, roll, rt, ct) for t in bands))
        approxes = nxt
        details.append(lvl)
    out = []
    for lvl in details:
        bands6 = []
        for k in range(3):                    # h, v, d
            bands6.extend(_mix(*[_real(lvl[i][k]) for i in range(4)]))
        out.append(torch.stack(bands6, dim=-3))
    return DTCoeffs2D(torch.stack([_real(a) for a in approxes], dim=0), tuple(out))


def idtcwt2d(coeffs: DTCoeffs2D, shape: Tuple[int, int], *, order: Tuple[int, int] = (2, 4),
             backend: Optional[str] = None) -> torch.Tensor:
    """Inverse of :func:`dtcwt2d` (exact; averages the four combos)."""
    wa, wb = dtcwt_wavelets(*order)
    rows = level_sizes(shape[0], coeffs.levels)
    cols = level_sizes(shape[1], coeffs.levels)
    wsel = (wa, wb)
    roll = -_treeB_roll(order[0])

    def quads(z):
        return [_unmix(z[..., 2 * k, :, :], z[..., 2 * k + 1, :, :]) for k in range(3)]

    approxes = [coeffs.approx[i] for i in range(4)]
    for j in range(coeffs.levels - 1, 0, -1):
        q = quads(coeffs.details[j])
        nxt = []
        for i, (rt, ct) in enumerate(_COMBOS):
            bands = tuple(_roll_axes(t, -roll, rt, ct)
                          for t in (approxes[i], q[0][i], q[1][i], q[2][i]))
            out_rc = (rows[j], cols[j])
            if rt == ct:
                y = idwt2d(Coeffs2D(bands[0], (bands[1:],)), wsel[rt], out_rc, backend=backend)
            else:
                y = _level_inv_mixed(bands, wsel[rt], wsel[ct], out_rc, backend)
            nxt.append(y)
        approxes = nxt
    # level 1: tree A's bank everywhere, then unroll the tree-B axes
    q = quads(coeffs.details[0])
    ys = [_roll_axes(idwt2d(Coeffs2D(approxes[i], ((q[0][i], q[1][i], q[2][i]),)), wa,
                            tuple(shape), backend=backend), -1, rt, ct)
          for i, (rt, ct) in enumerate(_COMBOS)]
    return (ys[0] + ys[1] + ys[2] + ys[3]) * 0.25


# ---------------------------------------------------------------------------
# denoisers
# ---------------------------------------------------------------------------

def _magnitude_threshold(z: torch.Tensor, thr, b) -> torch.Tensor:
    """thr(|z|, b) * exp(i angle(z)): the magnitude shrunk, the phase kept
    (angle(0) = 0)."""
    return thr(z.abs(), b) * torch.exp(1j * torch.angle(z))


def _dt_pair(x: torch.Tensor, order, backend):
    if x.ndim >= 2:
        return (lambda t, lv: dtcwt2d(t, lv, order=order, backend=backend),
                lambda c: idtcwt2d(c, tuple(x.shape[-2:]), order=order, backend=backend))
    return (lambda t, lv: dtcwt1d(t, lv, order=order, backend=backend),
            lambda c: idtcwt1d(c, x.shape[-1], order=order, backend=backend))


def dtcwt_denoise(x: torch.Tensor, levels: int, beta, *, mode: str = "soft",
                  order: Tuple[int, int] = (2, 4), backend: Optional[str] = None
                  ) -> torch.Tensor:
    """Magnitude thresholding in the dual-tree domain: shrink |c| and keep
    the phase.  ``beta`` is a scalar or a per-level sequence (finest
    first).  An input of two or more axes is an image (leading axes
    batch), of one a signal."""
    from ..ops.threshold import THR_ELEM

    thr = THR_ELEM[mode]
    fwd, inv = _dt_pair(x, order, backend)
    c = fwd(x, levels)
    betas = list(beta) if isinstance(beta, (list, tuple)) else [beta] * levels
    if len(betas) != levels:
        raise ValueError(f"need {levels} betas, got {len(betas)}")
    details = tuple(_magnitude_threshold(z, thr, b) for z, b in zip(c.details, betas))
    return inv(type(c)(c.approx, details))


def dtcwt_auto_denoise(x: torch.Tensor, levels: int, *, k: float = 3.0, mode: str = "soft",
                       order: Tuple[int, int] = (2, 4), backend: Optional[str] = None
                       ) -> torch.Tensor:
    """Knob-free dual-tree magnitude denoise: the white-noise sigma is the
    median of the finest complex band's magnitudes over sqrt(ln 4) (the
    median of |c| of circular complex noise is sigma sqrt(ln 4)), and every
    level is thresholded at ``k * sigma`` (the orthonormal trees give
    per-level gains of 1).  ``k`` is a scalar or a per-level sequence
    (finest first)."""
    from ..ops.estimate import median
    from ..ops.threshold import THR_ELEM

    thr = THR_ELEM[mode]
    fwd, inv = _dt_pair(x, order, backend)
    c = fwd(x, levels)
    m1 = c.details[0].abs()
    sigma = median(m1) / torch.full((), math.sqrt(math.log(4.0)), dtype=m1.dtype,
                                    device=m1.device)
    ks = list(k) if isinstance(k, (list, tuple)) else [k] * levels
    if len(ks) != levels:
        raise ValueError(f"need {levels} k values, got {len(ks)}")
    details = tuple(_magnitude_threshold(z, thr, kj * sigma) for z, kj in zip(c.details, ks))
    return inv(type(c)(c.approx, details))
