"""Multi-device parallelism on ``torch.distributed``: process groups and
device meshes, the ring halo exchange, and the sharded 2D and batched 1D
transforms (counterpart of ``pdwt_tpu/parallel``).  The JAX package's 3D,
non-separable, packet, isotropic and anisotropic sharded transforms wait
for the rest of ROADMAP queue 1 item 16; naming one raises
``NotImplementedError``."""
from .halo import make_pad_fn, ring_wrap_pad
from .mesh import init_distributed, make_mesh
from .sharded import (dwt1d, dwt2d, idwt1d, idwt2d, iswt1d, iswt2d, shard_image, swt1d,
                      swt2d)

__all__ = [
    "make_mesh", "init_distributed", "make_pad_fn", "ring_wrap_pad", "shard_image",
    "dwt1d", "dwt2d", "idwt1d", "idwt2d", "swt1d", "swt2d", "iswt1d", "iswt2d",
]

#: the JAX package's sharded transforms still to port, by the ROADMAP queue
#: 1 item that brings them (the second half of item 16: 3D after item 12,
#: the non-separable ones, then packets, starlet and the anisotropic
#: transform after item 14)
DEFERRED = {n: 16 for n in ("dwt3d", "idwt3d", "swt3d", "iswt3d", "dwt2d_ns", "idwt2d_ns",
                            "swt2d_ns", "iswt2d_ns", "fs_dwt", "fs_idwt", "packets", "starlet",
                            "istarlet")}


def __getattr__(name):
    if name in DEFERRED:
        raise NotImplementedError(f"parallel.{name} comes with ROADMAP queue 1, "
                                  f"item {DEFERRED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
