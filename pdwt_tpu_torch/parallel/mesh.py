"""Process groups and device meshes for the (data, row, col) sharding
layout: counterpart of ``pdwt_tpu/parallel/mesh.py`` on
``torch.distributed``."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch.distributed as dist


def init_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)``: the same program
    on every process, meshes over all of them.  A no-op where a process
    group is already initialized.  Nothing tells a process of its cluster:
    pass ``backend``, ``init_method`` (e.g. ``tcp://host:port`` or
    ``file://...``), ``world_size`` and ``rank``."""
    if not dist.is_initialized():
        dist.init_process_group(**kwargs)


def make_mesh(shape: Sequence[int], axis_names: Tuple[str, ...] = ("data", "row", "col"), *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the processes of the default
    group, named by the first ``len(shape)`` of ``axis_names``; on the
    card unless the caller asks for ``device_type="cpu"``.  One entry of
    -1 is inferred from the world size.  The last axis varies fastest, so
    ring neighbours along ``col`` are consecutive ranks.  Every process
    selects its card (``torch.cuda.set_device``) before it calls this."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    known = math.prod(s for s in shape if s != -1)
    if -1 in shape:
        if world % known != 0:
            raise ValueError(f"{world} devices not divisible by {known}")
        shape[shape.index(-1)] = world // known
    total = math.prod(shape)
    if total != world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {total} devices, have {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names[:len(shape)]))
