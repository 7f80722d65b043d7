"""The batched 1D denoising step, as PDWT's users run its batched 1D mode:
one facade over B signals of N samples (``Wavelets(ndim=1)``), and each
call ``set_image`` then ``run_denoise``: the decimated 1D transform of
every signal, a soft threshold of the details at ``beta``, the L1 norm of
the thresholded tree (the approximation kept) and the inverse.  The check
judges the denoised signals (``denoised_err``) and the norm
(``norm_err``)."""
from __future__ import annotations

import math

import torch

from wavebench import compare
from wavebench.reference import transforms as R
from wavebench.work import filterbank

CHECKS = ("denoised_err", "norm_err")
#: signals a block of the float64 check: 128 MiB a block at 4096 samples,
#: so the whole input in float64 never sits on the card beside the passes
BLOCK = 4096


def _signals(cfg: dict, cell: dict):
    """(signals, samples a signal)."""
    if (int(cfg["ndim"]) != 1 or cfg["boundary"] != "periodization"
            or cfg["precision"] is not None or cfg["dtype"] != "float32"):
        raise ValueError("the batched 1D step runs 1D periodization in float32 in the exact tier")
    if cell["threshold"] != "soft":
        raise ValueError("the batched 1D step's reference thresholds soft")
    n = int(cell["shape"][-1])
    return math.prod(cell["shape"]) // n, n


def program_call(P, cfg: dict, cell: dict):
    """One call of the program's step: x -> (denoised, norm), through one
    facade made at the first call, on the input's device."""
    nr, nc = _signals(cfg, cell)
    levels, beta = int(cell["levels"]), float(cell["beta"])
    facade = None

    def call(x):
        nonlocal facade
        if facade is None:
            facade = P.Wavelets(nr=nr, nc=nc, wname=cfg["wavelet"], levels=levels, ndim=1,
                                device=x.device)
        facade.set_image(x)
        return facade.run_denoise(beta, mode="soft")

    return call


def _reference(p, x, levels, beta):
    a, details = R.dwt(p, x, levels, 1)
    kept = tuple(tuple(R.soft(b, beta) for b in bands) for bands in details)
    return R.idwt(p, a, kept, 1), R.soft_norm1(a, details, beta)


def reference_call(cfg: dict, cell: dict, dtype, device):
    """The reference in the program's place (the control in float32)."""
    _signals(cfg, cell)
    p = R.Passes(cfg["wavelet"], dtype, device)
    return lambda x: _reference(p, x, int(cell["levels"]), float(cell["beta"]))


def check(outputs, x: torch.Tensor, cfg: dict, cell: dict) -> dict:
    """{check name: value}: the float64 reference, ``BLOCK`` signals at a
    time."""
    _, n = _signals(cfg, cell)
    levels = int(cell["levels"])
    R.level_sizes_even((n,), levels)
    out, norm = outputs
    xs = x.reshape(-1, n)
    if out.numel() != x.numel() or torch.as_tensor(norm).numel() != 1:
        return {"denoised_err": math.inf, "norm_err": math.inf}
    out = out.reshape(xs.shape)
    p = R.Passes(cfg["wavelet"], torch.float64, x.device)
    err, ref_norm = compare.MaxRel(), 0.0
    for s in range(0, xs.shape[0], BLOCK):
        ref_out, n1 = _reference(p, xs[s:s + BLOCK], levels, float(cell["beta"]))
        err.add([out[s:s + BLOCK]], [ref_out])
        ref_norm += float(n1)
    return {"denoised_err": err.value(), "norm_err": compare.rel(norm, ref_norm)}


def work(cfg: dict, cell: dict):
    """(flops, bytes) of one call: the forward and the inverse decimated
    transforms; x read, the denoised signals and the norm written."""
    nr, n = _signals(cfg, cell)
    hlen = len(R.orthogonal_bank(cfg["wavelet"])[0])
    flops = 2 * nr * filterbank.transform_flops((n,), hlen, int(cell["levels"]), False)
    return flops, 2 * nr * n * 4 + 4
