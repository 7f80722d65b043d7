"""Launch plumbing shared by the kernel wrappers: the launch counters,
the CPU/CUDA dispatch check, tap and offset conversion and the ctypes
call."""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ..core import conv

#: Longest filter the CUDA kernels take (PDWT_MAX_HLEN in csrc/*.cu).
MAX_HLEN = 128

#: Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {"fwd_level_2d": 0, "inv_level_2d": 0,
                            "fwd_tail_2d": 0, "inv_tail_2d": 0,
                            "swt_fwd_level_2d": 0, "swt_inv_level_2d": 0,
                            "fwd_level_1d": 0, "inv_level_1d": 0,
                            "swt_fwd_level_1d": 0, "swt_inv_level_1d": 0,
                            "fwd_level_2d_mxu": 0, "inv_level_2d_mxu": 0,
                            "fwd_level_1d_mxu": 0, "inv_level_1d_mxu": 0,
                            "swt_fwd_level_1d_mxu": 0, "swt_inv_level_1d_mxu": 0,
                            "swt_fwd_level_2d_mxu": 0, "swt_inv_level_2d_mxu": 0,
                            "ns_fwd_level_2d_mxu": 0, "ns_inv_level_2d_mxu": 0,
                            "ns_swt_fwd_level_2d_mxu": 0, "ns_swt_inv_level_2d_mxu": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cpu(*ts: torch.Tensor, ndim: int = 3, dtypes=(torch.float32,)) -> bool:
    """True for CPU tensors (the wrapper runs its plain version); False for
    tensors a CUDA kernel takes, of rank ``ndim`` ((B, R, C) images or
    (B, N) signals) and of one of ``dtypes``; raises on anything else."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if t.dtype not in dtypes:
            raise NotImplementedError(
                f"this CUDA kernel takes {', '.join(map(str, dtypes))}, got {t.dtype}; "
                "bfloat16 tensors run the banded-product kernels of the precision tiers")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if t.dim() != ndim or t.numel() == 0:
            want = "(B, R, C)" if ndim == 3 else "(B, N)"
            raise ValueError(f"expected a non-empty {want} tensor, got {tuple(t.shape)}")
    return False


def taps(f) -> np.ndarray:
    """Correlation-order float32 taps (kept alive by the caller)."""
    f = np.asarray(f, dtype=np.float64)
    if not 2 <= len(f) <= MAX_HLEN:
        raise ValueError(f"the CUDA kernels take filters of 2..{MAX_HLEN} taps, got {len(f)}")
    return np.ascontiguousarray(f[::-1], dtype=np.float32)


def ptr(a) -> ctypes.c_void_p:
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    return a.ctypes.data_as(ctypes.c_void_p)


def launch(name: str, device: torch.device, args) -> None:
    """Call ``pdwt_<name>`` of the kernel library on the current stream of
    ``device``; raise if the launch was refused, else count it."""
    from . import _build

    for a in args:
        if isinstance(a, int) and not -2 ** 31 <= a < 2 ** 31:
            raise ValueError(f"{name}: {a} does not fit the kernels' 32-bit int arguments")
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, "pdwt_" + name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.pdwt_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")
    LAUNCHES[name] += 1


def rev(f) -> np.ndarray:
    """Reversed float64 filter: the adjoint pairing's taps."""
    return np.asarray(f, dtype=np.float64)[::-1].copy()


def poly_geo(hlen: int) -> np.ndarray:
    """``conv.poly_geometry(hlen)`` as the int32 array the synthesis kernels
    read: p[0], p[1], o[0], o[1], nb[0], nb[1], lo, hi."""
    g = conv.poly_geometry(hlen)
    return np.array([*g.p, *g.o, *g.nb, g.lo, g.hi], dtype=np.int32)


def dilation(level: int) -> int:
    """The a-trous dilation 2^(level-1) of a stationary level."""
    if level < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    return 1 << (level - 1)


def check_span(hlen: int, f: int) -> None:
    if hlen * f >= 2 ** 31:
        raise ValueError(f"a dilated support of {hlen} x {f} taps overflows the kernels' "
                         "32-bit indices")
