"""Build and load the CUDA kernels of ``csrc/separable.cu``.

The source is compiled with ``nvcc`` into a shared library with a plain C
interface, on first use, into ``kernels/_build/`` (listed in
``.gitignore``), and loaded with ctypes.  The library's file name carries a
hash of the source and the flags, so an edited source is rebuilt.  Nothing
is built when the package is imported, and a failed build or load raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "separable.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpdwt_separable_{digest.hexdigest()[:16]}.so")


def build_log() -> str:
    """nvcc's output for the current library (ptxas register and
    shared-memory report), or '' if it was not built yet."""
    log = library_path() + ".log"
    if not os.path.isfile(log):
        return ""
    with open(log) as f:
        return f.read()


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with open(so + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, so)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built first if its source changed."""
    so = library_path()
    if not os.path.isfile(so):
        _build(so)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "pdwt_fwd_level_2d": [P, P, P, P, P, I, I, I, P, P, I, I, P],
        "pdwt_inv_level_2d": [P, P, P, P, P, I, I, I, P, P, I, P, P],
        "pdwt_fwd_tail_2d": [P, P, P, I, I, I, I, P, P, I, I, P],
        "pdwt_inv_tail_2d": [P, P, P, I, I, I, I, P, P, I, P, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    lib.pdwt_error_string.argtypes = [I]
    lib.pdwt_error_string.restype = ctypes.c_char_p
    return lib
