"""ctypes wrapper over the C++ engine's two libraries, float32 and float64
arrays (counterpart of ``pdwt_tpu/native/lib.py``, the same entry points
and arguments).  Inputs are CPU tensors or numpy arrays, outputs CPU
tensors; ``set_dtype`` picks the library the module-level calls use."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Tuple

import numpy as np
import torch

from ..core.separable import Coeffs1D, Coeffs2D
from ..core.separable3d import Coeffs3D
from ..core.shapes import coeff_shapes_1d, coeff_shapes_2d, coeff_shapes_3d
from ..filters import Wavelet
from ..utils import cache

_CPP_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "cpp")
SOURCE = os.path.join(_CPP_DIR, "pdwt_cpu.cpp")
HEADER = os.path.join(_CPP_DIR, "pdwt_cpu.h")
#: ``cpp/Makefile``'s CXXFLAGS and each library's own flags
CXXFLAGS = ("-O2", "-Wall", "-fPIC", "-std=c++17")
_LIB_FLAGS = {np.dtype(np.float32): ("-shared",),
              np.dtype(np.float64): ("-DPDWT_DOUBLEPRECISION", "-shared")}
_NAMES = {np.dtype(np.float32): "libpdwt_cpu", np.dtype(np.float64): "libpdwt_cpud"}

_libs: dict = {}
_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_double_p = ctypes.POINTER(ctypes.c_double)

# the array dtype of the module-level calls (set_dtype switches)
_DTYPE = np.dtype(np.float32)


def set_dtype(dtype) -> None:
    """Pick the engine's array precision, np.float32 or np.float64 (or the
    torch dtypes): the run-time form of the reference's compile-time
    DOUBLEPRECISION switch."""
    global _DTYPE
    if isinstance(dtype, torch.dtype):
        dtype = {torch.float32: np.float32, torch.float64: np.float64}.get(dtype, dtype)
    dt = np.dtype(dtype)
    if dt not in _LIB_FLAGS:
        raise ValueError(f"native engine supports float32/float64, got {dt}")
    _DTYPE = dt


def get_dtype():
    return _DTYPE


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def library_path(dtype=None) -> str:
    """The library's path in the build directory: its name carries a hash
    of the source, the header, the compiler and the flags."""
    dt = np.dtype(dtype) if dtype is not None else _DTYPE
    digest = hashlib.sha256(" ".join((_cxx(),) + CXXFLAGS + _LIB_FLAGS[dt]).encode())
    for path in (SOURCE, HEADER):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(cache.build_dir(), f"{_NAMES[dt]}_{digest.hexdigest()[:16]}.so")


def _compile(so: str, dt) -> Tuple[str, bool]:
    """Compile into a file of this process, then move it into place with
    an atomic rename (``cache.keep``: a build too quick to keep stays at
    the temporary path).  Returns (path to load, whether it is temporary)."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{time.monotonic_ns()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_cxx(), *CXXFLAGS, *_LIB_FLAGS[dt], "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{_cxx()} failed with code {proc.returncode}:\n{proc.stderr}")
    if not cache.keep(time.perf_counter() - t0):
        return tmp, True
    os.replace(tmp, so)
    return so, False


def build(force: bool = False, dtype=None) -> str:
    """Build the library of ``dtype`` (default: the active one) unless it is
    there; returns its path."""
    dt = np.dtype(dtype) if dtype is not None else _DTYPE
    so = library_path(dt)
    if force or not os.path.isfile(so):
        path, temporary = _compile(so, dt)
        if temporary:
            return path
    return so


def _signatures() -> dict:
    """``cpp/pdwt_cpu.h``'s entry points under the active dtype: name ->
    (restype, argtypes)."""
    R = _real_p()
    Rv = ctypes.c_double if _DTYPE == np.float64 else ctypes.c_float
    RR, D, I, L = ctypes.POINTER(R), _c_double_p, ctypes.c_int, ctypes.c_long
    fwd = (ctypes.c_int, [R, I, I, D, D, I, I, I, RR])
    inv = (ctypes.c_int, [RR, I, I, D, D, I, I, I, R])
    return {
        "pdwt_forward2d": fwd, "pdwt_inverse2d": inv,
        "pdwt_forward1d": fwd, "pdwt_inverse1d": inv,
        "pdwt_forward3d": (ctypes.c_int, [R, I, I, I, D, D, I, I, I, RR]),
        "pdwt_inverse3d": (ctypes.c_int, [RR, I, I, I, D, D, I, I, I, R]),
        "pdwt_forward2d_ns": (ctypes.c_int, [R, I, I, D, I, I, I, RR]),
        "pdwt_inverse2d_ns": (ctypes.c_int, [RR, I, I, D, I, I, I, R]),
        "pdwt_soft_threshold": (None, [R, L, Rv]),
        "pdwt_garrote_threshold": (None, [R, L, Rv]),
        "pdwt_firm_threshold": (None, [R, L, Rv, Rv]),
        "pdwt_shrink": (None, [R, L, Rv]),
        "pdwt_axpy": (None, [R, R, L, Rv]),
        "pdwt_group_soft_threshold": (None, [R, R, R, R, L, Rv]),
        "pdwt_norm1": (ctypes.c_double, [R, L]),
        "pdwt_norm2sq": (ctypes.c_double, [R, L]),
        "pdwt_norm_l21": (ctypes.c_double, [R, R, R, R, L]),
    }


def _load() -> ctypes.CDLL:
    lib = _libs.get(_DTYPE)
    if lib is None:
        path = build()
        lib = ctypes.CDLL(path)
        if path != library_path():
            os.remove(path)  # a build too quick to keep: loaded, not kept
        for name, (restype, argtypes) in _signatures().items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _libs[_DTYPE] = lib
    return lib


def is_available() -> bool:
    """True where a C++ compiler and the engine's source are found."""
    return shutil.which(_cxx()) is not None and os.path.isfile(SOURCE)


def _real_p():
    return _c_double_p if _DTYPE == np.float64 else _c_float_p


def _c_real(v: float):
    return ctypes.c_double(v) if _DTYPE == np.float64 else ctypes.c_float(v)


def _arr(x) -> np.ndarray:
    """A contiguous host array of the active dtype; a tensor must lie on
    the CPU (the engine is a CPU engine: nothing moves behind the
    caller's back)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"the native engine runs on the CPU; got a tensor on "
                             f"{x.device}: pass x.cpu() explicitly")
        x = x.detach()
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.ascontiguousarray(x, dtype=_DTYPE)


def _out(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_real_p())


def _dptr(a: np.ndarray):
    return np.ascontiguousarray(a, dtype=np.float64).ctypes.data_as(_c_double_p)


def _ptr_array(arrs) -> ctypes.Array:
    return (_real_p() * len(arrs))(*[_fptr(a) for a in arrs])


def _check(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} failed ({rc})")


def _taps(w: Wavelet, fwd: bool):
    lo, hi = (w.dec_lo, w.dec_hi) if fwd else (w.rec_lo, w.rec_hi)
    return np.ascontiguousarray(lo, np.float64), np.ascontiguousarray(hi, np.float64)


def dwt2d(img, wav: Wavelet, levels: int, *, swt: bool = False) -> Coeffs2D:
    """Multi-level 2D DWT (or SWT) of one (nr, nc) image."""
    lib = _load()
    img = _arr(img)
    nr, nc = img.shape
    a_shape, det_shapes = coeff_shapes_2d(nr, nc, levels, swt)
    bufs = [np.empty(a_shape, _DTYPE)]
    for s in det_shapes:
        bufs.extend(np.empty(s, _DTYPE) for _ in range(3))
    lo, hi = _taps(wav, True)
    _check(lib.pdwt_forward2d(_fptr(img), nr, nc, _dptr(lo), _dptr(hi), wav.hlen, levels,
                              int(swt), _ptr_array(bufs)), "pdwt_forward2d")
    t = [_out(b) for b in bufs]
    return Coeffs2D(t[0], tuple((t[3 * i + 1], t[3 * i + 2], t[3 * i + 3])
                                for i in range(levels)))


def idwt2d(coeffs: Coeffs2D, wav: Wavelet, shape: Tuple[int, int], *,
           swt: bool = False) -> torch.Tensor:
    lib = _load()
    nr, nc = shape
    bufs = [_arr(coeffs.approx)] + [_arr(b) for det in coeffs.details for b in det]
    out = np.empty((nr, nc), _DTYPE)
    lo, hi = _taps(wav, False)
    _check(lib.pdwt_inverse2d(_ptr_array(bufs), nr, nc, _dptr(lo), _dptr(hi), wav.hlen,
                              coeffs.levels, int(swt), _fptr(out)), "pdwt_inverse2d")
    return _out(out)


def dwt1d(x, wav: Wavelet, levels: int, *, swt: bool = False) -> Coeffs1D:
    """Multi-level 1D DWT (or SWT) of a (batch, n) array (one (n,) signal
    is a batch of one)."""
    lib = _load()
    x = np.ascontiguousarray(np.atleast_2d(_arr(x)))
    batch, n = x.shape
    a_len, det_lens = coeff_shapes_1d(n, levels, swt)
    bufs = [np.empty((batch, a_len), _DTYPE)] + [np.empty((batch, m), _DTYPE) for m in det_lens]
    lo, hi = _taps(wav, True)
    _check(lib.pdwt_forward1d(_fptr(x), batch, n, _dptr(lo), _dptr(hi), wav.hlen, levels,
                              int(swt), _ptr_array(bufs)), "pdwt_forward1d")
    t = [_out(b) for b in bufs]
    return Coeffs1D(t[0], tuple(t[1:]))


def idwt1d(coeffs: Coeffs1D, wav: Wavelet, length: int, *, swt: bool = False) -> torch.Tensor:
    lib = _load()
    bufs = [_arr(coeffs.approx)] + [_arr(d) for d in coeffs.details]
    batch = bufs[0].shape[0]
    out = np.empty((batch, length), _DTYPE)
    lo, hi = _taps(wav, False)
    _check(lib.pdwt_inverse1d(_ptr_array(bufs), batch, length, _dptr(lo), _dptr(hi), wav.hlen,
                              coeffs.levels, int(swt), _fptr(out)), "pdwt_inverse1d")
    return _out(out)


def dwt3d(vol, wav: Wavelet, levels: int, *, swt: bool = False) -> Coeffs3D:
    """Multi-level separable 3D DWT (or SWT) of one (nd, nr, nc) volume."""
    lib = _load()
    vol = _arr(vol)
    nd, nr, nc = vol.shape
    a_shape, det_shapes = coeff_shapes_3d(nd, nr, nc, levels, swt)
    bufs = [np.empty(a_shape, _DTYPE)]
    for s in det_shapes:
        bufs.extend(np.empty(s, _DTYPE) for _ in range(7))
    lo, hi = _taps(wav, True)
    _check(lib.pdwt_forward3d(_fptr(vol), nd, nr, nc, _dptr(lo), _dptr(hi), wav.hlen, levels,
                              int(swt), _ptr_array(bufs)), "pdwt_forward3d")
    t = [_out(b) for b in bufs]
    return Coeffs3D(t[0], tuple(tuple(t[7 * i + 1 + j] for j in range(7))
                                for i in range(levels)))


def idwt3d(coeffs: Coeffs3D, wav: Wavelet, shape, *, swt: bool = False) -> torch.Tensor:
    lib = _load()
    nd, nr, nc = shape
    bufs = [_arr(coeffs.approx)] + [_arr(b) for bands in coeffs.details for b in bands]
    out = np.empty((nd, nr, nc), _DTYPE)
    lo, hi = _taps(wav, False)
    _check(lib.pdwt_inverse3d(_ptr_array(bufs), nd, nr, nc, _dptr(lo), _dptr(hi), wav.hlen,
                              coeffs.levels, int(swt), _fptr(out)), "pdwt_inverse3d")
    return _out(out)


def dwt2d_ns(img, quads, levels: int, *, swt: bool = False) -> Coeffs2D:
    """Non-separable 2D forward with true 2D quads (4, hlen, hlen)."""
    lib = _load()
    img = _arr(img)
    q = np.ascontiguousarray(quads, dtype=np.float64)
    nr, nc = img.shape
    a_shape, det_shapes = coeff_shapes_2d(nr, nc, levels, swt)
    bufs = [np.empty(a_shape, _DTYPE)]
    for s in det_shapes:
        bufs.extend(np.empty(s, _DTYPE) for _ in range(3))
    _check(lib.pdwt_forward2d_ns(_fptr(img), nr, nc, _dptr(q), q.shape[-1], levels, int(swt),
                                 _ptr_array(bufs)), "pdwt_forward2d_ns")
    t = [_out(b) for b in bufs]
    return Coeffs2D(t[0], tuple((t[3 * i + 1], t[3 * i + 2], t[3 * i + 3])
                                for i in range(levels)))


def idwt2d_ns(coeffs: Coeffs2D, quads_inv, shape: Tuple[int, int], *,
              swt: bool = False) -> torch.Tensor:
    lib = _load()
    q = np.ascontiguousarray(quads_inv, dtype=np.float64)
    nr, nc = shape
    bufs = [_arr(coeffs.approx)] + [_arr(b) for det in coeffs.details for b in det]
    out = np.empty((nr, nc), _DTYPE)
    _check(lib.pdwt_inverse2d_ns(_ptr_array(bufs), nr, nc, _dptr(q), q.shape[-1],
                                 coeffs.levels, int(swt), _fptr(out)), "pdwt_inverse2d_ns")
    return _out(out)


def _inplace(fn, x, *scalars) -> torch.Tensor:
    lib = _load()
    x = _arr(x).copy()
    getattr(lib, fn)(_fptr(x), ctypes.c_long(x.size), *map(_c_real, scalars))
    return _out(x)


def soft_threshold(x, beta: float) -> torch.Tensor:
    return _inplace("pdwt_soft_threshold", x, beta)


def garrote_threshold(x, beta: float) -> torch.Tensor:
    return _inplace("pdwt_garrote_threshold", x, beta)


def firm_threshold(x, beta: float, beta2: float) -> torch.Tensor:
    return _inplace("pdwt_firm_threshold", x, beta, beta2)


def shrink(x, beta: float) -> torch.Tensor:
    return _inplace("pdwt_shrink", x, beta)


def norm1(x) -> float:
    x = _arr(x)
    return float(_load().pdwt_norm1(_fptr(x), ctypes.c_long(x.size)))


def norm2sq(x) -> float:
    x = _arr(x)
    return float(_load().pdwt_norm2sq(_fptr(x), ctypes.c_long(x.size)))


def norm_l21(h, v, d, a=None) -> float:
    """Group-lasso (L2,1) norm over (h, v, d[, a]), the grouping of
    :func:`group_soft_threshold`."""
    lib = _load()
    h, v, d = _arr(h), _arr(v), _arr(d)
    ap = None
    if a is not None:
        a = _arr(a)
        ap = _fptr(a)
    return float(lib.pdwt_norm_l21(_fptr(h), _fptr(v), _fptr(d), ap, ctypes.c_long(h.size)))


def group_soft_threshold(h, v, d, beta: float, a=None):
    """Group-lasso shrink over (h, v, d[, a]); returns new tensors."""
    lib = _load()
    h, v, d = (_arr(t).copy() for t in (h, v, d))
    ap = None
    if a is not None:
        a = _arr(a).copy()
        ap = _fptr(a)
    lib.pdwt_group_soft_threshold(_fptr(h), _fptr(v), _fptr(d), ap, ctypes.c_long(h.size),
                                  _c_real(beta))
    out = (h, v, d) if a is None else (h, v, d, a)
    return tuple(_out(t) for t in out)


def axpy(y, x, alpha: float) -> torch.Tensor:
    lib = _load()
    y = _arr(y).copy()
    x = _arr(x)
    lib.pdwt_axpy(_fptr(y), _fptr(x), ctypes.c_long(y.size), _c_real(alpha))
    return _out(y)
