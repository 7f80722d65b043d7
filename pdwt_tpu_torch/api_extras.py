"""Stateful facades of the starlet and dual-tree families (counterpart of
``pdwt_tpu/api_extras.py``).

    >>> S = Starlet(img, levels=4, device="cuda")
    >>> den = S.denoise()                 # k-sigma, knob-free
    >>> D = DualTree(img, levels=4, device="cuda")
    >>> den = D.denoise(k=3.0)            # complex magnitude k-sigma

``backend=`` is passed to every transform a facade runs, as JAX's facades
pass it.  The image lies on one device, as in ``WaveletPackets``; the port runs
eagerly, so JAX's per-configuration jit cache has no counterpart.  The CWT
stays functional-only, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .core import dualtree as dt_mod
# core/__init__ rebinds the name "starlet" to the function, so the
# submodule's names are imported directly
from .core.starlet import StarletCoeffs, istarlet
from .core.starlet import starlet as _starlet
from .utils.convert import image_tensor


class Starlet:
    """Isotropic a-trous (starlet) transform of one 1D/2D/3D array (spatial
    rank inferred from ``img.ndim``; pass ``ndim=`` for batched leading
    axes).  ``gen`` selects the generation (``core/starlet.py``)."""

    def __init__(self, img, levels: int = 4, *, ndim: Optional[int] = None, gen: int = 2,
                 dtype=None, backend: Optional[str] = None, device=None):
        img = image_tensor(img, device, dtype)
        self.ndim = int(ndim) if ndim is not None else min(img.ndim, 3)
        if not 1 <= self.ndim <= 3:
            raise ValueError(f"ndim must be 1..3, got {self.ndim}")
        if levels < 1:
            raise ValueError("levels must be >= 1")
        if gen not in (1, 2):
            raise ValueError(f"gen must be 1 or 2, got {gen}")
        self.levels = int(levels)
        self.gen = gen
        self.backend = backend
        self.d_image = img
        self.coeffs: Optional[StarletCoeffs] = None

    def forward(self) -> StarletCoeffs:
        self.coeffs = _starlet(self.d_image, self.levels, ndim=self.ndim, gen=self.gen,
                               backend=self.backend)
        return self.coeffs

    def inverse(self) -> torch.Tensor:
        if self.coeffs is None:
            raise ValueError("run forward() first (or assign .coeffs)")
        return istarlet(self.coeffs, ndim=self.ndim, gen=self.gen, backend=self.backend)

    def denoise(self, k=3.0, *, mode: str = "soft") -> torch.Tensor:
        """Knob-free k-sigma denoise (``models.starlet_auto_denoise``) of
        the held image; does not touch ``.coeffs``."""
        from .models.denoiser import starlet_auto_denoise

        kk = tuple(k) if isinstance(k, (list, tuple)) else float(k)
        return starlet_auto_denoise(self.d_image, self.levels, k=kk, ndim=self.ndim,
                                    gen=self.gen, mode=mode, backend=self.backend)


class DualTree:
    """Dual-tree complex wavelet transform of one 1D signal or 2D image (6
    oriented complex bands per level in 2D, about 4x redundancy, nearly
    shift-invariant; ``core/dualtree.py``)."""

    def __init__(self, img, levels: int = 4, *, order: Tuple[int, int] = (2, 4), dtype=None,
                 backend: Optional[str] = None, device=None):
        img = image_tensor(img, device, dtype)
        if img.ndim not in (1, 2):
            raise ValueError(
                f"DualTree holds one 1D signal or 2D image, got "
                f"shape {tuple(img.shape)}; use core.dtcwt1d/2d for batches")
        if levels < 1:
            raise ValueError("levels must be >= 1")
        self.ndim = img.ndim
        self.levels = int(levels)
        self.order = tuple(order)
        self.backend = backend
        self.d_image = img
        self.coeffs = None

    def forward(self):
        fwd = dt_mod.dtcwt2d if self.ndim == 2 else dt_mod.dtcwt1d
        self.coeffs = fwd(self.d_image, self.levels, order=self.order, backend=self.backend)
        return self.coeffs

    def inverse(self) -> torch.Tensor:
        if self.coeffs is None:
            raise ValueError("run forward() first (or assign .coeffs)")
        if self.ndim == 2:
            return dt_mod.idtcwt2d(self.coeffs, tuple(self.d_image.shape[-2:]),
                                   order=self.order, backend=self.backend)
        return dt_mod.idtcwt1d(self.coeffs, self.d_image.shape[-1], order=self.order,
                               backend=self.backend)

    def magnitudes(self):
        """Per-level oriented magnitude stacks |c| (the DT-CWT's
        shift-invariant feature maps); run forward() first."""
        if self.coeffs is None:
            raise ValueError("run forward() first")
        return tuple(d.abs() for d in self.coeffs.details)

    def denoise(self, k=3.0, *, mode: str = "soft") -> torch.Tensor:
        """Knob-free complex-magnitude k-sigma denoise
        (``core.dtcwt_auto_denoise``) of the held image."""
        kk = tuple(k) if isinstance(k, (list, tuple)) else float(k)
        return dt_mod.dtcwt_auto_denoise(self.d_image, self.levels, k=kk, mode=mode,
                                         order=self.order, backend=self.backend)
