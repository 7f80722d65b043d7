"""Precision tiers.  This slice of the port has the ``exact`` tier only:
float32 (float64 on the CPU) storage and arithmetic.  The reduced tiers
of ``pdwt_tpu/core/precision.py`` come with ROADMAP queue 1, item 9."""
from __future__ import annotations

from typing import Optional

TIERS = ("exact",)
_LATER = ("mixed", "bf16-fast", "bf16-balanced", "bf16-accurate")


def check_tier(tier: Optional[str]) -> str:
    """Resolve ``None`` to ``"exact"``; raise on every other tier."""
    if tier is None or tier == "exact":
        return "exact"
    if tier in _LATER:
        raise NotImplementedError(
            f"precision tier {tier!r} comes with ROADMAP queue 1, item 9")
    raise ValueError(f"unknown precision tier {tier!r}; expected one of "
                     f"{TIERS + _LATER}")
