"""Coefficient checkpoints: a ``Coeffs1D``, ``Coeffs2D`` or ``Coeffs3D`` as
a flat ``.npz`` in the JAX package's layout
(``pdwt_tpu/utils/checkpoint.py``), so a file written by either package
loads in the other: ``approx``, then ``b{i}_{j}`` (the 7 bands j = 0..6,
daa..ddd) per level in 3D, ``h{i}``, ``v{i}``, ``d{i}`` per level in 2D or
``d{i}`` in 1D, ``ndim`` and ``levels``.  npz has no bfloat16, so a bf16 band is stored as its
``uint16`` bits beside a ``_dt_<key>`` tag; the port reads and writes that
view itself (no ``ml_dtypes``)."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..core.separable import Coeffs1D, Coeffs2D
from ..core.separable3d import Coeffs3D
from .convert import default_device

Coeffs = Union[Coeffs1D, Coeffs2D, Coeffs3D]


def _pack(data: dict, key: str, t: torch.Tensor) -> None:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        data[key] = t.view(torch.int16).numpy().view(np.uint16)
        data[f"_dt_{key}"] = np.str_("bfloat16")
    else:
        data[key] = t.numpy()


def _unpack(z, key: str, device) -> torch.Tensor:
    a = z[key]
    if f"_dt_{key}" in z.files and str(z[f"_dt_{key}"]) == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def save_coeffs(path: str, coeffs: Coeffs) -> None:
    """Write a coefficient tree to ``path`` (.npz), copying it to the host."""
    data: dict = {}
    _pack(data, "approx", coeffs.approx)
    if isinstance(coeffs, Coeffs3D):
        data["ndim"] = np.int64(3)
        for i, bands in enumerate(coeffs.details):
            for j, b in enumerate(bands):
                _pack(data, f"b{i}_{j}", b)
    elif isinstance(coeffs, Coeffs2D):
        data["ndim"] = np.int64(2)
        for i, (h, v, d) in enumerate(coeffs.details):
            _pack(data, f"h{i}", h)
            _pack(data, f"v{i}", v)
            _pack(data, f"d{i}", d)
    else:
        data["ndim"] = np.int64(1)
        for i, d in enumerate(coeffs.details):
            _pack(data, f"d{i}", d)
    data["levels"] = np.int64(coeffs.levels)
    np.savez(path, **data)


def load_coeffs(path: str, device=None) -> Coeffs:
    """Load a tree written by :func:`save_coeffs` (or by the JAX package's)
    onto ``device`` (the CUDA card unless another is named), dtypes kept."""
    device = default_device(device)
    with np.load(path) as z:
        levels, ndim = int(z["levels"]), int(z["ndim"])
        t = lambda key: _unpack(z, key, device)
        if ndim == 3:
            return Coeffs3D(t("approx"), tuple(tuple(t(f"b{i}_{j}") for j in range(7))
                                               for i in range(levels)))
        if ndim == 2:
            return Coeffs2D(t("approx"), tuple((t(f"h{i}"), t(f"v{i}"), t(f"d{i}"))
                                               for i in range(levels)))
        if ndim == 1:
            return Coeffs1D(t("approx"), tuple(t(f"d{i}") for i in range(levels)))
    raise ValueError(f"a coefficient file of ndim {ndim}: expected 1, 2 or 3")
