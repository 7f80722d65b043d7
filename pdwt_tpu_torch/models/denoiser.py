"""Wavelet denoising step (counterpart of ``denoise_step`` in
``pdwt_tpu/models/denoiser.py``, its DWT branch): random circular shift,
DWT, threshold, norm, inverse, unshift."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import ops
from ..core.separable import all_periodization, dwt2d, idwt2d
from ..filters import get_wavelet

_THRESH = {"soft": ops.soft_threshold, "hard": ops.hard_threshold}


def denoise_step(img: torch.Tensor, generator: Optional[torch.Generator], wav,
                 levels: int, beta, *, swt: bool = False, mode: str = "soft",
                 normalize: bool = False, boundary="periodization"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One denoising step; returns ``(denoised, norm1_of_thresholded_coeffs)``.

    ``generator=None`` disables cycle spinning.  Otherwise the row and
    column shifts are drawn, in that order, uniformly in [0, Nr) and
    [0, Nc) from ``generator``.  ``mode`` is the threshold type."""
    if swt:
        raise NotImplementedError("swt=True comes with ROADMAP queue 1, item 6")
    if not all_periodization(boundary):
        raise NotImplementedError(
            f"boundary={boundary!r} comes with ROADMAP queue 1, item 10")
    if mode not in _THRESH:
        raise NotImplementedError(
            f"threshold mode {mode!r}: the port has {sorted(_THRESH)}; the "
            "others come with ROADMAP queue 1, item 4")
    wav = get_wavelet(wav) if isinstance(wav, str) else wav
    nr, nc = img.shape[-2:]
    if generator is not None:
        draw = lambda n: int(torch.randint(0, n, (), generator=generator,
                                           device=generator.device))
        sr, sc = draw(nr), draw(nc)
        img = ops.circshift2d(img, sr, sc)
    coeffs = dwt2d(img, wav, levels)
    coeffs = _THRESH[mode](coeffs, beta, normalize=normalize)
    n1 = ops.norm1(coeffs)
    out = idwt2d(coeffs, wav, (nr, nc))
    if generator is not None:
        out = ops.circshift2d(out, -sr, -sc)
    return out, n1
