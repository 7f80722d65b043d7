"""NaN and shape sanitizers (counterpart of ``pdwt_tpu/utils/debug.py``).

* ``assert_finite(tree, name)`` raises :class:`CheckError` if any leaf of a
  tensor tree holds a NaN or an Inf.  JAX builds it on ``checkify``, whose
  error is a ``ValueError`` with the text ``"<name>: leaf <i> contains
  NaN/Inf (`check` failed)"`` for the first failing leaf; the port raises a
  ``ValueError`` subclass with that text, eagerly.  The leaves' flags are
  stacked on their device and read once: one host sync per tree.
* ``checked(fn)`` runs ``fn`` with its checks raising on the host (they
  already do: torch runs eagerly), as JAX's wrapper makes them.
* ``validate_coeffs(coeffs, nr, nc, levels=, swt=, nd=)`` audits a
  coefficient tree's shapes against the layout rules (round-up halving).
"""
from __future__ import annotations

import functools
from typing import Union

import torch

from ..core.separable import Coeffs1D, Coeffs2D
from ..core.separable3d import Coeffs3D
from ..core.shapes import coeff_shapes_1d, coeff_shapes_2d, coeff_shapes_3d

Coeffs = Union[Coeffs1D, Coeffs2D, Coeffs3D]


class CheckError(ValueError):
    """A failed :func:`assert_finite` check (JAX raises its
    ``JaxRuntimeError``, also a ``ValueError``, with the same text)."""


def _leaves(tree) -> list:
    """The tensor leaves of a tree in JAX's order (tuples and lists in
    order, dicts by sorted key, None no leaf); numbers become tensors."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [torch.as_tensor(tree)]


def assert_finite(tree, name: str = "value") -> None:
    """Raise :class:`CheckError` naming the first leaf of ``tree`` that
    holds a NaN or an Inf."""
    leaves = _leaves(tree)
    if not leaves:
        return
    dev = leaves[0].device
    bad = torch.stack([~torch.isfinite(t).all().to(dev) for t in leaves])
    if bool(bad.any()):  # the one host sync
        i = int(bad.to(torch.uint8).argmax())
        raise CheckError(f"{name}: leaf {i} contains NaN/Inf (`check` failed)")


def checked(fn):
    """``fn`` with its :func:`assert_finite` checks raising on the host:

    >>> f = checked(lambda x: (assert_finite(x, "input"), x * 2)[1])
    >>> f(torch.ones(3))                      # fine
    >>> f(torch.tensor([float("nan")]))       # raises CheckError
    """

    @functools.wraps(fn)
    def run(*args, **kwargs):
        return fn(*args, **kwargs)

    return run


def validate_coeffs(coeffs: Coeffs, nr: int, nc: int = None, *, levels: int = None,
                    swt: bool = False, nd: int = None) -> None:
    """Host-side audit: every subband of ``coeffs`` must match the buffer
    geometry of an (nr[, nc]) input, or of an (nd, nr, nc) volume for a
    ``Coeffs3D`` (``nd`` required).  Raises ``ValueError`` naming the
    offending level and subband."""
    levels = coeffs.levels if levels is None else levels
    if coeffs.levels != levels:
        raise ValueError(f"expected {levels} levels, got {coeffs.levels}")
    if isinstance(coeffs, Coeffs3D):
        if nd is None:
            raise ValueError("validate_coeffs: Coeffs3D needs nd=")
        app, dets = coeff_shapes_3d(nd, nr, nc, levels, swt)
        if tuple(coeffs.approx.shape[-3:]) != app:
            raise ValueError(f"approx shape {tuple(coeffs.approx.shape[-3:])} != {app}")
        for i, (bands, want) in enumerate(zip(coeffs.details, dets)):
            if len(bands) != 7:
                raise ValueError(f"level {i + 1} has {len(bands)} bands")
            for j, arr in enumerate(bands):
                if tuple(arr.shape[-3:]) != want:
                    raise ValueError(f"level {i + 1} band {j} shape {tuple(arr.shape[-3:])} "
                                     f"!= {want}")
        return
    if isinstance(coeffs, Coeffs2D):
        app, dets = coeff_shapes_2d(nr, nc, levels, swt)
        if tuple(coeffs.approx.shape[-2:]) != app:
            raise ValueError(f"approx shape {tuple(coeffs.approx.shape[-2:])} != {app}")
        for i, (trip, want) in enumerate(zip(coeffs.details, dets)):
            for band, arr in zip("HVD", trip):
                if tuple(arr.shape[-2:]) != want:
                    raise ValueError(f"level {i + 1} {band} shape {tuple(arr.shape[-2:])} "
                                     f"!= {want}")
    else:
        app, dets = coeff_shapes_1d(nr, levels, swt)
        if coeffs.approx.shape[-1] != app:
            raise ValueError(f"approx length {coeffs.approx.shape[-1]} != {app}")
        for i, (arr, want) in enumerate(zip(coeffs.details, dets)):
            if arr.shape[-1] != want:
                raise ValueError(f"level {i + 1} D length {arr.shape[-1]} != {want}")
