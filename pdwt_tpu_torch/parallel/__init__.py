"""Multi-device parallelism on ``torch.distributed``: process groups and
device meshes, the ring halo exchange, and the sharded 2D, batched 1D, 3D
and non-separable transforms (counterpart of ``pdwt_tpu/parallel``).  The
JAX package's sharded packet, starlet and anisotropic transforms wait for
the rest of ROADMAP queue 1 item 16 (the anisotropic one also for item
14c); naming one raises ``NotImplementedError``."""
from .halo import make_pad_fn, ring_wrap_pad
from .mesh import init_distributed, make_mesh
from .sharded import (dwt1d, dwt2d, dwt2d_ns, dwt3d, idwt1d, idwt2d, idwt2d_ns, idwt3d, iswt1d,
                      iswt2d, iswt2d_ns, iswt3d, shard_image, swt1d, swt2d, swt2d_ns, swt3d)

__all__ = [
    "make_mesh", "init_distributed", "make_pad_fn", "ring_wrap_pad", "shard_image",
    "dwt1d", "dwt2d", "idwt1d", "idwt2d", "swt1d", "swt2d", "iswt1d", "iswt2d",
    "dwt3d", "idwt3d", "swt3d", "iswt3d", "dwt2d_ns", "idwt2d_ns", "swt2d_ns", "iswt2d_ns",
]

#: the JAX package's sharded transforms still to port, by the ROADMAP queue
#: 1 item that brings them (the end of item 16: packets and starlet run on
#: item 14's modules, the anisotropic transform on item 14c's)
DEFERRED = {n: 16 for n in ("fs_dwt", "fs_idwt", "packets", "starlet", "istarlet")}


def __getattr__(name):
    if name in DEFERRED:
        raise NotImplementedError(f"parallel.{name} comes with ROADMAP queue 1, "
                                  f"item {DEFERRED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
