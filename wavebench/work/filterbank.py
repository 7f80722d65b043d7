"""The work a separable wavelet transform needs, from its shapes alone,
whatever implements it.

Operations: the filter bank's multiply-adds, 2 flops a tap for each output
sample of each 1D pass, summed over passes and levels.  A decimated
analysis pass of an n-sample level writes n samples (two half bands), each
of ``hlen`` taps; its synthesis writes n samples, each summing ``hlen / 2``
taps of two bands, the same count.  A stationary pass doubles the bands:
the analysis's k-th pass writes ``2^k n`` samples of ``hlen`` taps, and the
synthesis's passes the same products in reverse.  Thresholds and norms
are not filter-bank work and are not counted.

Bytes: the call's inputs read once and its outputs written once.
"""
from __future__ import annotations

import math
from typing import Sequence


def level_flops(n: int, ndim: int, hlen: int, stationary: bool) -> int:
    """Flops of one analysis (or synthesis) level of ``n`` samples."""
    outputs = n * (2 ** (ndim + 1) - 2) if stationary else n * ndim
    return 2 * hlen * outputs


def transform_flops(spatial: Sequence[int], hlen: int, levels: int, stationary: bool) -> int:
    """Flops of one multi-level forward (or inverse) transform of one item."""
    ndim, n, total = len(spatial), math.prod(spatial), 0
    for _ in range(levels):
        total += level_flops(n, ndim, hlen, stationary)
        if not stationary:
            n //= 2 ** ndim
    return total
