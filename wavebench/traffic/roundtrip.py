"""The roundtrip operation: the forward DWT of the input, then the inverse
of that tree, over the trailing ``ndim`` axes (2D: ``dwt2d``/``idwt2d``;
3D: ``dwt3d``/``idwt3d``).  The call returns both, and the check judges
both: the whole coefficient tree (``coeff_err``) and the reconstruction
(``recon_err``), so a call that hands back its input fails."""
from __future__ import annotations

import math

import torch

from wavebench import compare
from wavebench.reference import transforms as R
from wavebench.work import filterbank

CHECKS = ("coeff_err", "recon_err")


def _spatial(cfg: dict, cell: dict):
    ndim = int(cfg["ndim"])
    if (ndim not in (2, 3) or cfg["boundary"] != "periodization" or cfg["precision"] is not None
            or cfg["dtype"] != "float32"):
        raise ValueError("the roundtrip runs 2D or 3D periodization in float32 in the exact tier")
    return ndim, tuple(int(n) for n in cell["shape"][-ndim:])


def program_call(P, cfg: dict, cell: dict):
    """One call of the program's entry points: x -> (coefficient tree,
    reconstruction)."""
    ndim, spatial = _spatial(cfg, cell)
    wav, levels = P.filters.get_wavelet(cfg["wavelet"]), int(cell["levels"])
    fwd, inv = (P.dwt2d, P.idwt2d) if ndim == 2 else (P.dwt3d, P.idwt3d)

    def call(x):
        coeffs = fwd(x, wav, levels)
        return coeffs, inv(coeffs, wav, spatial)

    return call


def reference_call(cfg: dict, cell: dict, dtype, device):
    """The reference in the program's place (the control in float32)."""
    ndim, _ = _spatial(cfg, cell)
    p = R.Passes(cfg["wavelet"], dtype, device)

    def call(x):
        coeffs = R.dwt(p, x, int(cell["levels"]), ndim)
        return coeffs, R.idwt(p, *coeffs, ndim)

    return call


def check(outputs, x: torch.Tensor, cfg: dict, cell: dict) -> dict:
    """{check name: value}: the float64 reference, one batch item at a time."""
    ndim, spatial = _spatial(cfg, cell)
    levels = int(cell["levels"])
    R.level_sizes_even(spatial, levels)
    coeffs, recon = outputs
    got = [t.reshape((-1,) + tuple(t.shape[-ndim:])) for t in compare.leaves(coeffs)]
    recon = recon.reshape((-1,) + tuple(recon.shape[-ndim:]))
    xs = x.reshape((-1,) + spatial)
    p = R.Passes(cfg["wavelet"], torch.float64, x.device)
    c_err, r_err = compare.MaxRel(), compare.MaxRel()
    if any(t.shape[0] != xs.shape[0] for t in got) or recon.shape[0] != xs.shape[0]:
        return {"coeff_err": math.inf, "recon_err": math.inf}
    for b in range(xs.shape[0]):
        ref = R.dwt(p, xs[b], levels, ndim)
        c_err.add([t[b] for t in got], compare.leaves(ref))
        r_err.add([recon[b]], [R.idwt(p, *ref, ndim)])
    return {"coeff_err": c_err.value(), "recon_err": r_err.value()}


def work(cfg: dict, cell: dict):
    """(flops, bytes) of one call: the forward and the inverse; x read,
    the tree and the reconstruction written (a periodized tree holds as
    many samples as x)."""
    ndim, spatial = _spatial(cfg, cell)
    items = math.prod(cell["shape"]) // math.prod(spatial)
    hlen = len(R.orthogonal_bank(cfg["wavelet"])[0])
    flops = 2 * items * filterbank.transform_flops(spatial, hlen, int(cell["levels"]), False)
    return flops, 3 * math.prod(cell["shape"]) * 4
