"""Stateful ``Wavelets`` facade (counterpart of ``pdwt_tpu/api.py``).

This slice covers one 2D image, the separable periodization DWT, the
exact precision tier: construction with level clamping, ``forward``,
``inverse``, ``soft_threshold``, ``hard_threshold``, ``norm1``,
``norm2sq``, ``get_image``, ``set_image`` and cycle spinning.  Other
flags raise ``NotImplementedError`` naming the ROADMAP item that adds
them.

The image and coefficients are tensors on one device: the device of the
image given, or ``device=``.  The facade never moves a tensor between
devices; ``get_image()`` copies to a host numpy array only when asked
(``copy=True``).
"""
from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Optional

import numpy as np
import torch

from . import ops
from .core.precision import check_tier
from .core.separable import Coeffs2D, all_periodization, dwt2d, idwt2d
from .core.shapes import coeff_shapes_2d, max_level
from .filters import Wavelet, get_wavelet


class WState(enum.Enum):
    INIT = "W_INIT"
    FORWARD = "W_FORWARD"
    INVERSE = "W_INVERSE"
    THRESHOLD = "W_THRESHOLD"


@dataclasses.dataclass(frozen=True)
class WaveletSpec:
    """Static configuration of a :class:`Wavelets` instance."""

    wname: str
    nr: int
    nc: int
    nlevels: int
    do_cycle_spinning: bool
    dtype: torch.dtype
    hlen: int


def _later(what: str, item: int):
    return NotImplementedError(f"{what} comes with ROADMAP queue 1, item {item}")


def _same_device(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


class Wavelets:
    """Stateful wavelet transform bound to one image geometry.

    >>> W = Wavelets(img, wname="db7", levels=5, device="cuda")
    >>> W.forward(); W.soft_threshold(10.0); img_dn = W.inverse()
    """

    def __init__(self, img=None, nr: Optional[int] = None, nc: Optional[int] = None,
                 wname: str = "haar", levels: int = 1, do_separable: bool = True,
                 do_cycle_spinning: bool = False, do_swt: bool = False,
                 ndim: int = 2, dtype=None, seed: int = 0, mode="periodization",
                 precision: Optional[str] = None, device=None):
        if do_swt:
            raise _later("the stationary transform (do_swt=True)", 6)
        if not do_separable:
            raise _later("the non-separable transform (do_separable=False)", 11)
        if ndim == 1:
            raise _later("the batched 1D transform (ndim=1)", 7)
        if ndim == 3:
            raise _later("the 3D transform (ndim=3)", 12)
        if ndim != 2:
            raise ValueError(f"ndim={ndim} is not implemented")
        if not all_periodization(mode):
            raise _later(f"boundary mode {mode!r}", 10)
        check_tier(precision)
        dtype = torch.float32 if dtype is None else dtype
        device = None if device is None else torch.device(device)

        if img is not None:
            if isinstance(img, torch.Tensor):
                if device is not None and not _same_device(img, device):
                    raise ValueError(f"img lies on {img.device}, not on device={device}; "
                                     "move it first")
                img = img.to(dtype=dtype)
            else:
                img = torch.as_tensor(np.asarray(img), dtype=dtype, device=device)
            if img.ndim == 1:
                raise _later("1D signals", 7)
            if img.ndim == 3:
                raise _later("3D volumes", 12)
            if img.ndim != 2:
                raise ValueError(f"expected a 2D image, got shape {tuple(img.shape)}")
            if (nr, nc) != (None, None) and (nr, nc) != tuple(img.shape):
                raise ValueError(f"nr, nc = {nr!r}, {nc!r} contradict the image's shape "
                                 f"{tuple(img.shape)} (pass wname= and levels= by keyword)")
            nr, nc = img.shape
        elif nr is None or nc is None:
            raise ValueError("provide either an image or (nr, nc)")
        else:
            img = torch.zeros((nr, nc), dtype=dtype, device=device)
        if nr == 1:
            raise _later("1D signals (nr == 1)", 7)

        if levels < 1:
            warnings.warn("cannot initialize wavelet coefficients with nlevels < 1; "
                          "forcing nlevels = 1")
            levels = 1
        self._wavelet: Wavelet = get_wavelet(wname)
        hlen = self._wavelet.hlen
        wmax = max_level(min(nr, nc), hlen)
        if levels > wmax:
            warnings.warn(
                f"required level ({levels}) is greater than the maximum possible "
                f"level for {wname} ({wmax}) on a {nr}x{nc} image; forcing "
                f"nlevels = {max(wmax, 1)}")
            levels = max(wmax, 1)

        self.spec = WaveletSpec(wname=wname, nr=nr, nc=nc, nlevels=levels,
                                do_cycle_spinning=do_cycle_spinning, dtype=dtype,
                                hlen=hlen)
        self.device = img.device
        self.d_image = img
        self.state = WState.INIT
        self.current_shift_r = 0
        self.current_shift_c = 0
        self._rng = np.random.default_rng(seed)
        a_shape, det_shapes = coeff_shapes_2d(nr, nc, levels)
        z = lambda s: torch.zeros(s, dtype=dtype, device=self.device)
        self._coeffs = Coeffs2D(z(a_shape), tuple((z(s), z(s), z(s)) for s in det_shapes))

    @property
    def wname(self) -> str:
        return self.spec.wname

    @property
    def coeffs(self) -> Coeffs2D:
        return self._coeffs

    @coeffs.setter
    def coeffs(self, value: Coeffs2D):
        self._coeffs = value
        self.state = WState.FORWARD

    def _check_not_inverse(self, action: str) -> bool:
        if self.state == WState.INVERSE:
            warnings.warn(f"cannot {action}, as the coefficients were modified "
                          "by inverse()")
            return False
        return True

    def forward(self) -> Coeffs2D:
        """Compute the coefficients of the current image.  With cycle
        spinning, the row then the column shift are drawn first from
        ``numpy.random.default_rng(seed)``."""
        s = self.spec
        img = self.d_image
        if s.do_cycle_spinning:
            self.current_shift_r = int(self._rng.integers(0, s.nr))
            self.current_shift_c = int(self._rng.integers(0, s.nc))
            img = ops.circshift2d(img, self.current_shift_r, self.current_shift_c)
        self._coeffs = dwt2d(img, self._wavelet, s.nlevels)
        self.state = WState.FORWARD
        return self._coeffs

    def inverse(self) -> torch.Tensor:
        """Reconstruct the image from the coefficients."""
        if self.state == WState.INVERSE:
            warnings.warn("inverse() has already been run; result available "
                          "via get_image()")
            return self.d_image
        s = self.spec
        img = idwt2d(self._coeffs, self._wavelet, (s.nr, s.nc))
        if s.do_cycle_spinning:
            img = ops.circshift2d(img, -self.current_shift_r, -self.current_shift_c)
        self.d_image = img
        self.state = WState.INVERSE
        return img

    def soft_threshold(self, beta, do_thresh_appcoeffs: bool = False,
                       normalize: bool = False) -> None:
        if not self._check_not_inverse("threshold coefficients"):
            return
        self._coeffs = ops.soft_threshold(self._coeffs, beta,
                                          do_thresh_appcoeffs=do_thresh_appcoeffs,
                                          normalize=normalize)
        self.state = WState.THRESHOLD

    def hard_threshold(self, beta, do_thresh_appcoeffs: bool = False,
                       normalize: bool = False) -> None:
        if not self._check_not_inverse("threshold coefficients"):
            return
        self._coeffs = ops.hard_threshold(self._coeffs, beta,
                                          do_thresh_appcoeffs=do_thresh_appcoeffs,
                                          normalize=normalize)
        self.state = WState.THRESHOLD

    def norm1(self) -> float:
        return float(ops.norm1(self._coeffs))

    def norm2sq(self) -> float:
        return float(ops.norm2sq(self._coeffs))

    def get_image(self, copy: bool = True):
        """A host numpy copy of the image (``copy=True``), or the tensor
        itself on its device."""
        if copy:
            return self.d_image.detach().cpu().numpy()
        return self.d_image

    def set_image(self, img) -> None:
        """Replace the image.  A tensor must lie on the facade's device."""
        s = self.spec
        if isinstance(img, torch.Tensor):
            if not _same_device(img, self.device):
                raise ValueError(f"img lies on {img.device}, the facade on "
                                 f"{self.device}; move it first")
            img = img.to(dtype=s.dtype)
        else:
            img = torch.as_tensor(np.asarray(img), dtype=s.dtype, device=self.device)
        self.d_image = img.reshape(s.nr, s.nc)
        self.state = WState.INIT

    def __repr__(self):
        s = self.spec
        return (f"Wavelets({s.wname!r}, shape=({s.nr}, {s.nc}), levels={s.nlevels}, "
                f"cycle_spinning={s.do_cycle_spinning}, dtype={s.dtype}, "
                f"device={self.device}, state={self.state.value})")
