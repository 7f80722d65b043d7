"""Continuous wavelet transform (CWT): the scaleogram (counterpart of
``pdwt_tpu/core/continuous.py``).

One forward FFT of the signal, one broadcast multiply against the whole
scale bank, one batched inverse FFT over a (scales, n) block: no loop over
scales reaches the device.  The FFTs are ``torch.fft`` (cuFFT on the card),
the counterpart of JAX's XLA FFT: the JAX package has no Pallas kernel
here, so neither has the port.

Conventions are Torrence & Compo 1998 ("A Practical Guide to Wavelet
Analysis"), so the reconstruction constants are citable:

* ``morlet`` (w0 = 6): analytic, psi0_hat(s w) = pi^(-1/4) H(w)
  exp(-(s w - w0)^2 / 2), complex output; Fourier wavelength
  4 pi s / (w0 + sqrt(2 + w0^2)).
* ``ricker`` (DOG m = 2, the mexican hat): psi0_hat(s w) =
  -Gamma(2.5)^(-1/2) (s w)^2 exp(-(s w)^2 / 2), real output; wavelength
  2 pi s / sqrt(2.5).
* ``paul`` (order m = 4): analytic, psi0_hat(s w) = 2^m / sqrt(m (2m-1)!)
  (s w)^m exp(-s w) H(w), complex output; wavelength 4 pi s / (2m + 1).

Energy normalization psi_hat(s w_k) = sqrt(2 pi s / dt) psi0_hat(s w)
(T&C eq. 6).  :func:`icwt` is the delta-function reconstruction (T&C eq.
11) for log-spaced scales.  :func:`cwt2d` is the oriented 2D Morlet
scaleogram, :func:`cone_of_influence` the edge-affected region of a 1D one.

The scale banks are built in numpy float64 on the host, stored as
float32, and cached as tensors on the input's device per (mother, scales,
size, dt).  Leading axes of ``x`` are batch.  ``cwt`` returns complex64
for ``morlet`` and ``paul`` and float32 for ``ricker``; ``cwt2d`` complex64;
``icwt`` float32.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

_OMEGA0 = 6.0
_PAUL_M = 4
# T&C table 2: reconstruction factor C_delta and psi0(0) per mother wavelet
_CDELTA = {"morlet": 0.776, "ricker": 3.541, "paul": 1.132}
_PSI00 = {"morlet": math.pi ** -0.25, "ricker": 0.867, "paul": 1.079}
#: e-folding TIME of |psi(t)|^2 as a multiple of the scale (T&C table 1)
_EFOLD = {"morlet": math.sqrt(2.0), "ricker": math.sqrt(2.0), "paul": 1.0 / math.sqrt(2.0)}


def _ang_freq(n: int, dt: float) -> np.ndarray:
    """w_k = 2 pi k / (n dt) with the sign convention of T&C eq. 5."""
    return 2.0 * math.pi * np.fft.fftfreq(n, d=dt)


def _psi_hat(wavelet: str, s: np.ndarray, omega: np.ndarray, dt: float) -> np.ndarray:
    """psi_hat(s_j w_k), shape (S, n), float32 from float64 numpy."""
    so = s[:, None] * omega[None, :]
    if wavelet == "morlet":
        base = (math.pi ** -0.25) * np.exp(-0.5 * np.minimum((so - _OMEGA0) ** 2, 700.0))
        base = base * (omega[None, :] > 0)
    elif wavelet == "ricker":
        base = -(so ** 2) * np.exp(-0.5 * np.minimum(so ** 2, 700.0)) / math.sqrt(math.gamma(2.5))
    elif wavelet == "paul":
        m = _PAUL_M
        cm = 2.0 ** m / math.sqrt(m * math.factorial(2 * m - 1))
        pos = so > 0
        base = cm * np.where(pos, so, 0.0) ** m * np.exp(
            -np.minimum(np.where(pos, so, 0.0), 700.0)) * pos
    else:
        raise ValueError(f"unknown wavelet {wavelet!r}; pick from {sorted(_CDELTA)}")
    norm = np.sqrt(2.0 * math.pi * s[:, None] / dt)
    return (norm * base).astype(np.float32)


def _psi_hat_2d(s: np.ndarray, thetas: np.ndarray, nr: int, nc: int, dt: float,
                sigma: float) -> np.ndarray:
    """The 2D Morlet bank psi_hat(s R_theta k), shape (S, T, nr, nc): a
    Gaussian in the frequency plane centred at wavenumber w0 along
    orientation theta, times s 2 pi / dt (flat L2 norm across scales, the
    2D analogue of T&C eq. 6)."""
    ky = 2 * math.pi * np.fft.fftfreq(nr, d=dt)
    kx = 2 * math.pi * np.fft.fftfreq(nc, d=dt)
    KY, KX = np.meshgrid(ky, kx, indexing="ij")
    out = np.empty((len(s), len(thetas), nr, nc), np.float32)
    for j, sj in enumerate(s):
        for i, th in enumerate(thetas):
            kxr = math.cos(th) * KX + math.sin(th) * KY
            kyr = -math.sin(th) * KX + math.cos(th) * KY
            r2 = (sj * kxr - _OMEGA0) ** 2 + (sj * kyr) ** 2
            out[j, i] = (2 * math.pi * sj / dt) * np.exp(-0.5 * np.minimum(sigma ** 2 * r2, 700.0))
    return out


@functools.lru_cache(maxsize=32)
def _bank(wavelet: str, scales: tuple, n: int, dt: float, device: torch.device) -> torch.Tensor:
    s = np.asarray(scales, np.float64)
    return torch.from_numpy(_psi_hat(wavelet, s, _ang_freq(n, dt), dt)).to(device)


@functools.lru_cache(maxsize=32)
def _bank_2d(scales: tuple, thetas: tuple, nr: int, nc: int, dt: float, sigma: float,
             device: torch.device) -> torch.Tensor:
    s, th = np.asarray(scales, np.float64), np.asarray(thetas, np.float64)
    return torch.from_numpy(_psi_hat_2d(s, th, nr, nc, dt, sigma)).to(device)


def _tensor(x) -> torch.Tensor:
    """A tensor keeps its device; host data goes to the card."""
    if isinstance(x, torch.Tensor):
        return x
    from ..utils.convert import image_tensor

    return image_tensor(x)


def _scales(scales) -> tuple:
    s = np.asarray(scales, np.float64)
    if s.ndim != 1 or s.size == 0 or (s <= 0).any():
        raise ValueError("scales must be a non-empty 1D positive array")
    return tuple(float(v) for v in s)


def fourier_wavelength(wavelet: str, scales) -> np.ndarray:
    """Equivalent Fourier wavelength per scale (T&C table 1)."""
    s = np.asarray(scales, np.float64)
    if wavelet == "morlet":
        return 4.0 * math.pi * s / (_OMEGA0 + math.sqrt(2 + _OMEGA0 ** 2))
    if wavelet == "ricker":
        return 2.0 * math.pi * s / math.sqrt(2.5)
    if wavelet == "paul":
        return 4.0 * math.pi * s / (2 * _PAUL_M + 1)
    raise ValueError(f"unknown wavelet {wavelet!r}")


def log_scales(n: int, dt: float = 1.0, *, dj: float = 0.125, s0: Optional[float] = None,
               j1: Optional[int] = None) -> np.ndarray:
    """T&C eq. 9-10 log-spaced scale grid: s_j = s0 2^(j dj), default s0 =
    2 dt, up to the n dt window."""
    s0 = 2.0 * dt if s0 is None else s0
    if j1 is None:
        j1 = int(math.log2(n * dt / s0) / dj)
    return s0 * 2.0 ** (dj * np.arange(j1 + 1))


def cwt(x, scales, wavelet: str = "morlet", *, dt: float = 1.0) -> torch.Tensor:
    """CWT over the trailing axis: ``batch + (S, n)``, complex64 for the
    analytic mothers (``morlet``, ``paul``), float32 for ``ricker``.
    Periodic boundary (FFT), the DWT engines' convention.  A tensor keeps
    its device; host data goes to the card."""
    x = _tensor(x)
    s = _scales(scales)
    psi = _bank(wavelet, s, x.shape[-1], float(dt), x.device)
    X = torch.fft.fft(x.float(), dim=-1)
    # T&C eq. 4: W(s) = ifft(X psi_hat(s w)); psi_hat is real, no conjugate
    W = torch.fft.ifft(X[..., None, :] * psi, dim=-1)
    if wavelet == "ricker":
        return W.real.contiguous()
    return W


def icwt(W: torch.Tensor, scales, wavelet: str = "morlet", *, dt: float = 1.0,
         dj: float = 0.125) -> torch.Tensor:
    """Approximate inverse (T&C eq. 11) for log-spaced scales with spacing
    ``dj`` (e.g. from :func:`log_scales`): x_n = dj sqrt(dt) / (C_delta
    psi0(0)) sum_j Re(W_j) / sqrt(s_j), float32."""
    s = torch.tensor(np.asarray(scales, np.float64), dtype=torch.float32, device=W.device)
    fac = dj * math.sqrt(dt) / (_CDELTA[wavelet] * _PSI00[wavelet])
    return fac * torch.sum(torch.real(W) / torch.sqrt(s)[..., :, None], dim=-2)


def cone_of_influence(n: int, dt: float = 1.0, wavelet: str = "morlet") -> np.ndarray:
    """Cone of influence in scale units, length ``n``: at sample t the
    coefficients with scale s > coi[t] are contaminated by the periodic
    boundary (T&C §3g, table 1).  Mask a scaleogram with
    ``np.asarray(scales)[:, None] <= coi[None, :]``."""
    if wavelet not in _EFOLD:
        raise ValueError(f"unknown wavelet {wavelet!r}; pick from {sorted(_EFOLD)}")
    t = np.arange(n, dtype=np.float64)
    return (np.minimum(t, n - 1 - t) + 0.5) * dt / _EFOLD[wavelet]


def cwt2d(x, scales, thetas=None, *, dt: float = 1.0, sigma: float = 1.0) -> torch.Tensor:
    """Oriented 2D Morlet scaleogram over the trailing two axes:
    ``batch + (S, T, nr, nc)`` complex64.  One 2D FFT of the image, one
    broadcast multiply against the whole (scale, angle) bank, one batched
    inverse FFT.  ``thetas`` defaults to 4 orientations (0, pi/4, pi/2,
    3 pi/4); ``sigma`` widens the Gaussian envelope."""
    x = _tensor(x)
    nr, nc = x.shape[-2:]
    s = _scales(scales)
    th = (np.linspace(0.0, math.pi, 4, endpoint=False) if thetas is None
          else np.asarray(thetas, np.float64))
    psi = _bank_2d(s, tuple(float(t) for t in th), nr, nc, float(dt), float(sigma), x.device)
    X = torch.fft.fft2(x.float(), dim=(-2, -1))
    return torch.fft.ifft2(X[..., None, None, :, :] * psi, dim=(-2, -1))
