"""Precision tiers (counterpart of ``pdwt_tpu/core/precision.py``).

==================  ========  ==================================================
tier                tensors   compute
==================  ========  ==================================================
``exact``           f32/f64   the exact level kernels (float32 FMAs)
``mixed``           f32       bf16x3 products (``b3``) on the banded-product
                              kernels, float32 storage
``bf16-fast``       bf16      level 1 forward ``b1``, last inverse level ``fd``
``bf16-balanced``   bf16      level 1 both ways ``b2f``
``bf16-accurate``   bf16      level 1 both ways ``b3``
==================  ========  ==================================================

Under the bf16 tiers the detail bands are stored bf16 and the
approximation chain float32; the deep levels run ``b3``
(``kernels/matmul.py`` states each scheme's arithmetic).

A tier is selected per ``Wavelets`` instance, per call through the
``precision=`` keyword of the transforms, or with :func:`precision_scope`.
The ``PDWT_TPU_PRECISION`` and ``PDWT_TPU_BF16_ACCURACY`` environment
variables are process-wide defaults, read only when no tier is active.
The tier is read when a transform runs (PyTorch runs eagerly), and an
autograd Function keeps the schemes of its forward for its backward.
"""
from __future__ import annotations

import contextlib
import functools
import os
from contextvars import ContextVar
from typing import Iterator, Optional

import torch

TIERS = ("exact", "mixed", "bf16-fast", "bf16-balanced", "bf16-accurate")
_ACCURACY = ("fast", "balanced", "accurate")

_active: ContextVar[Optional[str]] = ContextVar("pdwt_tpu_torch_precision", default=None)


def check_tier(tier: str) -> str:
    if tier not in TIERS:
        raise ValueError(f"unknown precision tier {tier!r}; expected one of {TIERS}")
    return tier


def current() -> Optional[str]:
    """The active tier, or None when the environment defaults apply."""
    return _active.get()


@contextlib.contextmanager
def precision_scope(tier: Optional[str]) -> Iterator[None]:
    """Activate a precision tier for the transforms run inside the scope
    (None keeps whatever is active)."""
    if tier is None:
        yield
        return
    token = _active.set(check_tier(tier))
    try:
        yield
    finally:
        _active.reset(token)


def mixed_requested() -> bool:
    """Should float32 tensors run the bf16x3 banded-product kernels?  The
    active tier decides (``"mixed"`` yes, any other no); without one, the
    ``PDWT_TPU_PRECISION`` default (``mixed`` or ``bf16x3``)."""
    tier = _active.get()
    if tier is not None:
        return tier == "mixed"
    return os.environ.get("PDWT_TPU_PRECISION", "").lower() in ("mixed", "bf16x3")


def bf16_accuracy() -> str:
    """The bf16 rung ("fast", "balanced" or "accurate"): the active
    ``bf16-*`` tier, else the ``PDWT_TPU_BF16_ACCURACY`` default."""
    tier = _active.get()
    if tier is not None and tier.startswith("bf16-"):
        return tier[len("bf16-"):]
    env = os.environ.get("PDWT_TPU_BF16_ACCURACY", "fast")
    if env not in _ACCURACY:
        raise ValueError(f"PDWT_TPU_BF16_ACCURACY={env!r}: pick from "
                         f"{sorted(_ACCURACY)}")
    return env


def _has_bf16(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.dtype == torch.bfloat16
    if isinstance(obj, (list, tuple)):  # Coeffs1D / Coeffs2D are tuples too
        return any(_has_bf16(o) for o in obj)
    return False


def takes_precision(fn):
    """Add a ``precision=`` keyword to a transform entry point: the tier is
    active (:func:`precision_scope`) while the call runs.  ``None`` keeps
    the ambient tier.  A ``bf16-*`` tier needs bfloat16 tensors among the
    arguments, ``exact`` and ``mixed`` need none (an inverse's tree may mix
    a float32 approximation with bf16 details: presence decides)."""

    @functools.wraps(fn)
    def wrapper(*args, precision: Optional[str] = None, **kwargs):
        if precision is None:
            return fn(*args, **kwargs)
        check_tier(precision)
        has_bf16 = _has_bf16(args)
        if precision.startswith("bf16-") != has_bf16:
            raise ValueError(
                f"precision {precision!r} does not match the input dtypes "
                f"({'some' if has_bf16 else 'no'} bfloat16 tensors): bf16-* tiers "
                "need bf16 tensors, exact/mixed need float tensors")
        with precision_scope(precision):
            return fn(*args, **kwargs)

    wrapper.__doc__ = (wrapper.__doc__ or "") + (
        "\n\n    ``precision=`` selects a compute tier for this call "
        "(core/precision.py): 'exact', 'mixed', or 'bf16-fast'/"
        "'bf16-balanced'/'bf16-accurate'.\n    ")
    return wrapper


def tier_for(dtype: torch.dtype, tier: Optional[str]) -> str:
    """Validate and resolve a tier against a tensor dtype (the facade's
    constructor contract): bf16 takes the ``bf16-*`` rungs, float32 takes
    ``exact``/``mixed``, float64 ``exact`` only."""
    if tier is not None:
        check_tier(tier)
    if dtype == torch.bfloat16:
        if tier is None:
            return "bf16-fast"
        if not tier.startswith("bf16-"):
            raise ValueError(
                f"precision {tier!r} needs float32 tensors; bf16 tensors take "
                "'bf16-fast'/'bf16-balanced'/'bf16-accurate' (cast to float32 "
                "for the exact/mixed tiers)")
        return tier
    if tier is not None and tier.startswith("bf16-"):
        raise ValueError(f"precision {tier!r} needs bfloat16 tensors (pass "
                         "dtype=torch.bfloat16 or leave dtype unset)")
    if dtype == torch.float64 and tier == "mixed":
        raise ValueError("precision 'mixed' applies to float32 tensors")
    return tier or "exact"
