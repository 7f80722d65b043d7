"""Build and load the CUDA kernels of ``csrc/*.cu``.

Each source is compiled with ``nvcc`` into an object file, all of them at
once in parallel, and the objects are linked into one shared library with
a plain C interface, on first use, into the build directory of
``utils/cache.py`` (``kernels/_build/`` in a checkout, listed in
``.gitignore``; the user's cache directory for a read-only install;
``enable_compile_cache`` or ``PDWT_TPU_COMPILE_CACHE`` to choose), and
loaded with ctypes.  The library's file name carries a hash of every
source, header and flag, so editing any of them rebuilds it, and it is
moved into place with an atomic rename.  Nothing is built when the package
is imported, and a failed build or load raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time

from ..utils import cache

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_HERE, "csrc", name)
                for name in ("separable.cu", "swt.cu", "matmul.cu", "mxu1d.cu", "swt_matmul.cu",
                             "ns_matmul.cu"))
#: headers the sources include; hashed with them, so editing one rebuilds
HEADERS = tuple(os.path.join(_HERE, "csrc", name) for name in ("mxu_common.cuh", "band_strip.cuh"))
#: the in-tree build directory (``cache.build_dir()`` is where builds go)
BUILD_DIR = cache.TREE_DIR
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


P, I = ctypes.c_void_p, ctypes.c_int
#: ctypes argument types of each ``extern "C" int`` entry point of SOURCES
#: (every one returns a cudaError_t as int), the stream last
SIGNATURES = {
    # x, a, scratch, det (3 * levels pointers), B, R, C, levels, taps (4, hlen on the
    # device), hlen, center, the launch plan (nb, cs, nt, threads, smem, tiles: lr, lc,
    # nph per level), stream
    "pdwt_fwd_tail_2d": [P, P, P, P, I, I, I, I, P, I, I, *[I] * 5, P, P],
    # a, det (3 * levels pointers, deepest first), out, scratch, B, Mr, Mc, levels, taps
    # (4, hlen on the device), hlen, geometry, the launch plan (nb, cs, nt, threads,
    # smem, tiles), stream
    "pdwt_inv_tail_2d": [P, P, P, P, I, I, I, I, P, I, P, *[I] * 5, P, P],
    # partials, their count, out (one float on the device), stream
    "pdwt_swt_norm_sum_2d": [P, I, P, P],
    # x, a, h, v, d, B, R, C, taps (4, hlen on the device), hlen, center, scheme,
    # in_bf16, det_bf16, the launch plan (lr, lc, gc, nph, nt, threads, grid x, y, z,
    # smem), stream
    "pdwt_fwd_level_2d_mxu": [P, P, P, P, P, I, I, I, P, I, I, I, I, I, *[I] * 10, P],
    # a, h, v, d, out, B, Mr, Mc, taps (4, hlen on the device), hlen, geometry, scheme,
    # det_bf16, out_bf16, the launch plan (lr, lc, nt, threads, grid x, y, z, smem),
    # stream
    "pdwt_inv_level_2d_mxu": [P, P, P, P, P, I, I, I, P, I, P, I, I, I, *[I] * 8, P],
    # x, a, h, v, d, B, R, C (the extended input), Ro, Co (the outputs), taps (4, hlen
    # on the device), hlen, scheme, in_bf16, det_bf16, the launch plan (lr, lc, gc, nph,
    # nt, threads, grid x, y, z, smem), stream
    "pdwt_fwd_level_2d_mxu_padded": [P, P, P, P, P, I, I, I, I, I, P, I, I, I, I, *[I] * 10,
                                     P],
    # a, h, v, d, out, B, Mr, Mc (the padded subbands), pad (base, off, n_out of the
    # rows, then of the columns), taps (4, hlen on the device), hlen, geometry, scheme,
    # det_bf16, out_bf16, the launch plan (lr, lc, nt, threads, grid x, y, z, smem),
    # stream
    "pdwt_inv_level_2d_mxu_padded": [P, P, P, P, P, I, I, I, P, P, I, P, I, I, I, *[I] * 8,
                                     P],
    # x, lo, hi, B, N, taps (4, hlen on the device), hlen, dilation, center, scheme,
    # in_bf16, hi_bf16, the launch plan (lc, gc, nt, threads, grid x, y, z, smem), stream
    "pdwt_fwd_level_1d_mxu": [P, P, P, I, I, P, I, I, I, I, I, I, *[I] * 8, P],
    "pdwt_swt_fwd_level_1d_mxu": [P, P, P, I, I, P, I, I, I, I, I, I, *[I] * 8, P],
    # the same, then norm mode, beta (one float on the device), partials, stream
    "pdwt_fwd_level_1d_norm": [P, P, P, I, I, P, I, I, I, I, I, I, *[I] * 8, I, P, P, P],
    # lo, hi, out, B, M, taps (4, hlen on the device), hlen, dilation, center,
    # geometry, scheme, hi_bf16, out_bf16, the launch plan (lc, gc, nt, threads,
    # grid x, y, z, smem), stream
    "pdwt_inv_level_1d_mxu": [P, P, P, I, I, P, I, I, I, P, I, I, I, *[I] * 8, P],
    "pdwt_swt_inv_level_1d_mxu": [P, P, P, I, I, P, I, I, I, P, I, I, I, *[I] * 8, P],
    # x, lo, hi, B, N (the extended signals), n_out, taps (4, hlen on the device),
    # hlen, scheme, in_bf16, hi_bf16, the launch plan (lc, gc, nt, threads, grid x, y,
    # z, smem), stream
    "pdwt_fwd_level_1d_mxu_padded": [P, P, P, I, I, I, P, I, I, I, I, *[I] * 8, P],
    # x, lo, hi, B, N (the signals with their halo), n_out, taps (4, hlen on the
    # device), hlen, dilation, scheme, in_bf16, hi_bf16, the launch plan (lc, gc, nt,
    # threads, grid x, y, z, smem), stream
    "pdwt_swt_fwd_level_1d_mxu_padded": [P, P, P, I, I, I, P, I, I, I, I, I, *[I] * 8, P],
    # lo, hi, out, B, M (the padded bands), pad (base, off, n_out), taps (4, hlen on
    # the device), hlen, geometry, scheme, hi_bf16, out_bf16, the launch plan (lc, gc,
    # nt, threads, grid x, y, z, smem), stream
    "pdwt_inv_level_1d_mxu_padded": [P, P, P, I, I, P, P, I, P, I, I, I, *[I] * 8, P],
    # lo, hi, out, B, M (the bands with their halo), n_out, taps (4, hlen of the
    # halved filters on the device), hlen, dilation, scheme, hi_bf16, out_bf16, the
    # launch plan (lc, gc, nt, threads, grid x, y, z, smem), stream
    "pdwt_swt_inv_level_1d_mxu_padded": [P, P, P, I, I, I, P, I, I, I, I, I, *[I] * 8, P],
    # x, a, h, v, d, B, R, C, taps (4, hlen on the device), hlen, dilation, center,
    # scheme, in_bf16, det_bf16, the launch plan (lr, lc, gc, nph, nt, threads,
    # grid x, y, z, smem), norm mode (0: none; fd only), beta (one float on the
    # device), partials, approx, stream
    "pdwt_swt_fwd_level_2d_mxu": [P, P, P, P, P, I, I, I, P, I, I, I, I, I, I, *[I] * 10,
                                  I, P, P, I, P],
    # a, h, v, d, out, B, R, C, taps (4, hlen on the device), hlen, dilation, center,
    # scheme, det_bf16, out_bf16, thresh_mode, beta (one float on the device), the
    # launch plan (lr, lc, gc, nph, nt, threads, grid x, y, z, smem), stream
    "pdwt_swt_inv_level_2d_mxu": [P, P, P, P, P, I, I, I, P, I, I, I, I, I, I, I, P,
                                  *[I] * 10, P],
    # x, a, h, v, d, B, R, C (the input with its halo), Ro, Co (the outputs), taps
    # (4, hlen on the device), hlen, dilation, scheme, in_bf16, det_bf16, the launch
    # plan (lr, lc, gc, nph, nt, threads, grid x, y, z, smem), stream
    "pdwt_swt_fwd_level_2d_mxu_padded": [P, P, P, P, P, I, I, I, I, I, P, I, I, I, I, I,
                                         *[I] * 10, P],
    # a, h, v, d, out, B, Ri, Ci (the subbands with their halo), R, C (the output),
    # taps (4, hlen of the halved filters on the device), hlen, dilation, scheme,
    # det_bf16, out_bf16, the launch plan (lr, lc, gc, nph, nt, threads, grid x, y, z,
    # smem), stream
    "pdwt_swt_inv_level_2d_mxu_padded": [P, P, P, P, P, I, I, I, I, I, P, I, I, I, I, I,
                                         *[I] * 10, P],
    # x, a, h, v, d, B, R, C, taps (device), hlen, rank, stride, dilation, center,
    # scheme, in_bf16, det_bf16, the launch plan (lr, lc, gc, nt, threads, grid x, y,
    # z, smem), stream
    "pdwt_ns_fwd_level_2d_mxu": [P, P, P, P, P, I, I, I, P, I, I, I, I, I, I, I, I,
                                 *[I] * 9, P],
    "pdwt_ns_swt_fwd_level_2d_mxu": [P, P, P, P, P, I, I, I, P, I, I, I, I, I, I, I, I,
                                     *[I] * 9, P],
    # a, h, v, d, out, B, Mr, Mc, taps (device), hlen, rank, dilation, geometry,
    # scheme, det_bf16, out_bf16, the launch plan (lr, lc, gc, nt, threads, grid x, y, z,
    # smem), stream
    "pdwt_ns_inv_level_2d_mxu": [P, P, P, P, P, I, I, I, P, I, I, I, P, I, I, I, *[I] * 9, P],
    "pdwt_ns_swt_inv_level_2d_mxu": [P, P, P, P, P, I, I, I, P, I, I, I, P, I, I, I,
                                     *[I] * 9, P],
}


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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(cache.build_dir(), f"libpdwt_kernels_{digest.hexdigest()[:16]}.so")


def build_log() -> str:
    """nvcc's output for the current library (ptxas register and
    shared-memory report), or '' if it was not built yet."""
    log = library_path() + ".log"
    if not os.path.isfile(log):
        return ""
    with open(log) as f:
        return f.read()


def _run_all(cmds):
    """Run the commands at once; raise with nvcc's output if one fails,
    else return their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {p.returncode} on {cmd[-1]}:\n{out}")
    return "".join(outs)


def _build(so: str) -> str:
    """Build the library; returns the path to load (``so``, or the
    temporary file of a build too quick to keep, ``cache.keep``)."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}"
    t0 = time.perf_counter()
    nvcc = _nvcc()
    objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, src] for o, src in zip(objs, SOURCES)])
    log += _run_all([[nvcc, *ARCH, "-shared", "-o", tmp + ".tmp", *objs]])
    for o in objs:
        os.remove(o)
    if not cache.keep(time.perf_counter() - t0):
        return tmp + ".tmp"
    with open(so + ".log", "w") as f:
        f.write(log)
    os.replace(tmp + ".tmp", so)
    return so


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built first if a source changed."""
    so = library_path()
    path = so if os.path.isfile(so) else _build(so)
    lib = ctypes.CDLL(path)
    if path != so:
        os.remove(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pdwt_error_string.argtypes = [ctypes.c_int]
    lib.pdwt_error_string.restype = ctypes.c_char_p
    return lib
