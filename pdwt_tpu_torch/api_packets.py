"""Stateful ``WaveletPackets`` facade over the packet engine (counterpart of
``pdwt_tpu/api_packets.py``).

    >>> WP = WaveletPackets(img, wname="db4", levels=3, device="cuda")
    >>> WP.forward()
    >>> leaves, cost = WP.best_basis("shannon")
    >>> den = WP.reconstruct(beta=25.0)          # threshold + synthesize

The image lies on one device: the device of an image given as a tensor,
else ``device=`` (the CUDA card unless another is named).  The port runs
eagerly, so JAX's per-configuration jit cache has no counterpart; a
threshold in ``reconstruct`` runs once over each depth's node tensor
(``core.packets.threshold_details``), not once a leaf.
"""
from __future__ import annotations

from typing import Optional, Tuple

from .core import packets as pk_mod
from .filters import Wavelet, get_wavelet
from .ops.threshold import THR_ELEM
from .utils.convert import image_tensor, tensor_to_numpy


class WaveletPackets:
    """Full wavelet-packet tree of a 1D signal, 2D image or 3D volume
    (spatial rank inferred from ``img.ndim``; construct with an extra
    leading axis and ``ndim=`` for batched data).  ``dtype=None`` keeps the
    image's dtype; ``backend`` is every transform's route
    (``core/separable.py``)."""

    def __init__(self, img, wname: str = "haar", levels: int = 1, *,
                 ndim: Optional[int] = None, dtype=None, backend: Optional[str] = None,
                 device=None):
        img = image_tensor(img, device, dtype)
        self.ndim = int(ndim) if ndim is not None else min(img.ndim, 3)
        if not 1 <= self.ndim <= 3:
            raise ValueError(f"ndim must be 1..3, got {self.ndim}")
        if levels < 1:
            raise ValueError("levels must be >= 1")
        self.wavelet: Wavelet = get_wavelet(wname) if isinstance(wname, str) else wname
        self.levels = int(levels)
        self.backend = backend
        self.d_image = img
        self.packets = None
        self.leaves: Optional[Tuple[Tuple[int, int], ...]] = None

    def _full_cover(self):
        fan = {1: 2, 2: 4, 3: 8}[self.ndim]
        return tuple((self.levels, i) for i in range(fan ** self.levels))

    # -- pipeline ------------------------------------------------------
    def forward(self):
        """Decompose the image into the full packet tree (one batched
        single-level transform per depth)."""
        fwd = {1: pk_mod.wp1d, 2: pk_mod.wp2d, 3: pk_mod.wp3d}[self.ndim]
        self.packets = fwd(self.d_image, self.wavelet, self.levels, backend=self.backend)
        self.leaves = None
        return self.packets

    def best_basis(self, cost: str = "shannon", thresh: float = 0.0):
        """Pick and store the Coifman-Wickerhauser best basis; returns
        ``(leaves, total_cost)``."""
        if self.packets is None:
            self.forward()
        self.leaves, total = pk_mod.best_basis(self.packets, cost, thresh)
        return self.leaves, total

    def reconstruct(self, beta=None, mode: str = "soft"):
        """Synthesize from the stored basis (the full tree if
        :meth:`best_basis` was not called).  ``beta`` thresholds every
        detail leaf (node 0 of each depth, the pure approximation chain,
        passes through)."""
        if self.packets is None:
            raise ValueError("run forward() first")
        leaves = self.leaves if self.leaves is not None else self._full_cover()
        thr = THR_ELEM[mode]
        pk = (self.packets if beta is None
              else pk_mod.threshold_details(self.packets, leaves, thr, beta))
        return pk_mod.wp_reconstruct(pk, leaves, self.wavelet, backend=self.backend)

    # -- access --------------------------------------------------------
    def get_node(self, depth: int, index: int, copy: bool = True):
        """Coefficients of one tree node (a host numpy copy, or the tensor
        on its device with ``copy=False``)."""
        if self.packets is None:
            raise ValueError("run forward() first")
        val = self.packets.nodes[depth][(Ellipsis, index) + (slice(None),) * self.ndim]
        return tensor_to_numpy(val) if copy else val

    def costs(self, cost: str = "shannon", thresh: float = 0.0):
        """Per-depth per-node additive cost vectors (numpy)."""
        if self.packets is None:
            raise ValueError("run forward() first")
        return [tensor_to_numpy(c) for c in pk_mod.wp_costs(self.packets, cost, thresh)]

    def __repr__(self):
        basis = f"{len(self.leaves)}-leaf basis" if self.leaves else "full tree"
        return (f"WaveletPackets({self.wavelet.name}, levels="
                f"{self.levels}, ndim={self.ndim}, "
                f"{'decomposed, ' + basis if self.packets is not None else 'not decomposed'})")
