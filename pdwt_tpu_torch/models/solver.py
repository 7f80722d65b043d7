"""Wavelet-regularised inverse problems by (F)ISTA (counterpart of
``pdwt_tpu/models/solver.py``).

``ista(y, op, ...)`` minimises 1/2 ||op(x) - y||^2 + lam R(W x) over
images x, ``op`` any linear operator on tensors (the identity denoises, a
blur deconvolves, a mask inpaints) and R the L1 norm or the group-lasso
L2,1 norm of the detail bands.  Each iteration is a gradient step through
``op`` and its adjoint, a DWT, the proximal threshold and an inverse DWT
on the card's kernels; the objective trace stays on the device until one
``torch.stack`` at the end, so the loop never waits for the card.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import ops
from ..core.separable import dwt2d, idwt2d
from ..filters import get_wavelet
from ..ops.norms import _group_norms
from ..utils.profiling import spanned


@spanned("models")
def ista(y: torch.Tensor, op: Optional[Callable] = None, op_t: Optional[Callable] = None, *,
         wav="db7", levels: int = 4, lam: float = 1.0, step: float = 1.0, iters: int = 50,
         fista: bool = True, x0: Optional[torch.Tensor] = None, reg: str = "l1",
         backend: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F)ISTA in the analysis form: x <- W^-1 prox(W(v - step op^T(op(v) -
    y)), step lam), with Nesterov momentum under ``fista``.

    ``op`` defaults to the identity.  A missing ``op_t`` is the adjoint of
    the linear ``op``, from ``torch.func.vjp`` at ``x0`` (else ``y``).
    ``reg="l1"`` soft-thresholds, ``reg="group"`` group-soft-thresholds;
    both act on the detail bands only, and the objective's lam R term sums
    exactly those.  ``backend``: the transforms' route
    (``core/separable.py``).  Returns ``(x, objective per iteration)``."""
    if reg not in ("l1", "group"):
        raise ValueError(f"reg must be 'l1' or 'group', got {reg!r}")
    wav = get_wavelet(wav) if isinstance(wav, str) else wav
    shape = tuple(y.shape[-2:])
    if op is None:
        op = lambda x: x
        if op_t is None:
            op_t = op
    elif op_t is None:
        _, vjp = torch.func.vjp(op, y if x0 is None else x0)
        op_t = lambda r: vjp(r)[0]
    prox = ops.soft_threshold if reg == "l1" else ops.group_soft_threshold

    x = v = y if x0 is None else x0
    t = torch.ones((), dtype=y.dtype, device=y.device)
    trace = []
    for _ in range(iters):
        c = prox(dwt2d(v - step * op_t(op(v) - y), wav, levels, backend=backend), step * lam)
        x_new = idwt2d(c, wav, shape, backend=backend)
        if fista:
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            v = x_new + ((t - 1.0) / t_new) * (x_new - x)
            t = t_new
        else:
            v = x_new
        if reg == "l1":
            rterm = sum(torch.sum(torch.abs(b)) for lvl in c.details for b in lvl)
        else:
            rterm = sum(torch.sum(_group_norms(c, i, False)) for i in range(c.levels))
        trace.append(0.5 * torch.sum(torch.square(op(x_new) - y)) + lam * rterm)
        x = x_new
    return x, torch.stack(trace)
