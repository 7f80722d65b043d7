"""The translation-invariant denoising step: the stationary transform of
the input, a soft threshold of the details at ``beta``, the L1 norm of the
thresholded tree and the inverse, over the trailing ``ndim`` axes, without
cycle spinning (2D: ``models.denoise_step``; 3D:
``models.denoise_step_3d``; ``swt=True``, ``generator=None``).  The check
judges the denoised output (``denoised_err``) and the norm
(``norm_err``)."""
from __future__ import annotations

import math

import torch

from wavebench import compare
from wavebench.reference import transforms as R
from wavebench.work import filterbank

CHECKS = ("denoised_err", "norm_err")


def _spatial(cfg: dict, cell: dict):
    ndim = int(cfg["ndim"])
    if (ndim not in (2, 3) or cfg["boundary"] != "periodization" or cfg["precision"] is not None
            or cfg["dtype"] != "float32"):
        raise ValueError("the TI step runs 2D or 3D periodization in float32 in the exact tier")
    if cell["threshold"] != "soft":
        raise ValueError("the TI step's reference thresholds soft")
    return ndim, tuple(int(n) for n in cell["shape"][-ndim:])


def program_call(P, cfg: dict, cell: dict):
    """One call of the program's step: x -> (denoised, norm)."""
    ndim, _ = _spatial(cfg, cell)
    step = P.models.denoise_step if ndim == 2 else P.models.denoise_step_3d
    wav, levels, beta = cfg["wavelet"], int(cell["levels"]), float(cell["beta"])

    def call(x):
        return step(x, None, wav, levels, beta, swt=True, mode="soft")

    return call


def _reference(p, x, ndim, levels, beta):
    coeffs = R.swt(p, x, levels, ndim)
    return R.iswt_soft(p, *coeffs, ndim, beta), R.soft_norm1(*coeffs, beta)


def reference_call(cfg: dict, cell: dict, dtype, device):
    """The reference in the program's place (the control in float32)."""
    ndim, _ = _spatial(cfg, cell)
    p = R.Passes(cfg["wavelet"], dtype, device)
    return lambda x: _reference(p, x, ndim, int(cell["levels"]), float(cell["beta"]))


def check(outputs, x: torch.Tensor, cfg: dict, cell: dict) -> dict:
    """{check name: value}: the float64 reference, one batch item at a time."""
    ndim, spatial = _spatial(cfg, cell)
    out, norm = outputs
    xs = x.reshape((-1,) + spatial)
    if out.numel() != x.numel() or torch.as_tensor(norm).numel() != 1:
        return {"denoised_err": math.inf, "norm_err": math.inf}
    out = out.reshape(xs.shape)
    p = R.Passes(cfg["wavelet"], torch.float64, x.device)
    err, ref_norm = compare.MaxRel(), 0.0
    for b in range(xs.shape[0]):
        ref_out, n1 = _reference(p, xs[b], ndim, int(cell["levels"]), float(cell["beta"]))
        err.add([out[b]], [ref_out])
        ref_norm += float(n1)
    return {"denoised_err": err.value(), "norm_err": compare.rel(norm, ref_norm)}


def work(cfg: dict, cell: dict):
    """(flops, bytes) of one call: the forward and the inverse stationary
    transforms; x read, the denoised output and the norm written."""
    ndim, spatial = _spatial(cfg, cell)
    n = math.prod(cell["shape"])
    hlen = len(R.orthogonal_bank(cfg["wavelet"])[0])
    flops = 2 * (n // math.prod(spatial)) * filterbank.transform_flops(
        spatial, hlen, int(cell["levels"]), True)
    return flops, 2 * n * 4 + 4
