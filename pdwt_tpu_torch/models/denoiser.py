"""Wavelet denoising step (counterpart of ``denoise_step`` in
``pdwt_tpu/models/denoiser.py``): random circular shift, DWT or SWT,
threshold, norm, inverse, unshift.  On the SWT branch the TI-denoise step
fuses the threshold into the inverse."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import ops
from ..core.separable import all_periodization, dwt2d, idwt2d, iswt2d, iswt2d_denoise, swt2d
from ..filters import get_wavelet
from ..ops.threshold import THRESHOLD_OPS as _THRESH


def check_mode(mode: str) -> None:
    """Raise on a threshold type the port does not have yet."""
    if mode not in _THRESH:
        raise NotImplementedError(
            f"threshold mode {mode!r}: the port has {sorted(_THRESH)}; the "
            "others come with ROADMAP queue 1, item 4")


def denoise_step(img: torch.Tensor, generator: Optional[torch.Generator], wav,
                 levels: int, beta, *, swt: bool = False, mode: str = "soft",
                 normalize: bool = False, boundary="periodization"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One denoising step; returns ``(denoised, norm1_of_thresholded_coeffs)``.

    ``generator=None`` disables cycle spinning.  Otherwise the row and
    column shifts are drawn, in that order, uniformly in [0, Nr) and
    [0, Nc) from ``generator``.  ``mode`` is the threshold type.  With
    ``swt=True`` and a scalar ``beta`` the threshold runs inside the
    inverse's kernel and the norm comes from the un-thresholded
    coefficients (``ops.thresholded_norm1``): the thresholded tree is never
    built."""
    if not all_periodization(boundary):
        raise NotImplementedError(
            f"boundary={boundary!r} comes with ROADMAP queue 1, item 10")
    check_mode(mode)
    wav = get_wavelet(wav) if isinstance(wav, str) else wav
    nr, nc = img.shape[-2:]
    if generator is not None:
        draw = lambda n: int(torch.randint(0, n, (), generator=generator,
                                           device=generator.device))
        sr, sc = draw(nr), draw(nc)
        img = ops.circshift2d(img, sr, sc)
    if swt and not isinstance(beta, (list, tuple)):
        coeffs = swt2d(img, wav, levels)
        n1 = ops.thresholded_norm1(coeffs, beta, mode=mode, normalize=normalize)
        out = iswt2d_denoise(coeffs, wav, beta, mode=mode, normalize=normalize)
    elif swt:
        coeffs = _THRESH[mode](swt2d(img, wav, levels), beta, normalize=normalize)
        n1 = ops.norm1(coeffs)
        out = iswt2d(coeffs, wav)
    else:
        coeffs = _THRESH[mode](dwt2d(img, wav, levels), beta, normalize=normalize)
        n1 = ops.norm1(coeffs)
        out = idwt2d(coeffs, wav, (nr, nc))
    if generator is not None:
        out = ops.circshift2d(out, -sr, -sc)
    return out, n1
