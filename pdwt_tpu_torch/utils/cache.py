"""Where the port keeps what it compiles (counterpart of
``pdwt_tpu/utils/cache.py``).

JAX's ``enable_compile_cache`` points XLA's persistent compilation cache
at a directory.  The port compiles two things, the CUDA kernel library
(``kernels/_build.py``, ``nvcc``) and the C++ CPU engine (``native/``,
``g++``), each into a file named by a hash of its sources, headers and
flags, moved into place with an atomic rename; this module says which
directory that is.

* :func:`enable_compile_cache` sets it (an explicit ``path``, else
  ``PDWT_TPU_COMPILE_CACHE``, else the default) and returns it; calling
  it again moves later builds, and a library already loaded stays
  loaded.
* Without a call, builds go to ``PDWT_TPU_COMPILE_CACHE`` when it is set,
  else to the default: ``pdwt_tpu_torch/kernels/_build/`` when the package
  can be written (a checkout), else ``$XDG_CACHE_HOME/pdwt_tpu_torch`` (or
  ``~/.cache/pdwt_tpu_torch``), so that an installed, read-only copy can
  build its kernels (JAX's ``_default_dir``).
* ``min_compile_secs`` keeps JAX's meaning: a build that took less is
  loaded from a temporary file and not kept.
"""
from __future__ import annotations

import os
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the in-tree build directory of a checkout
TREE_DIR = os.path.join(_PKG, "kernels", "_build")

_dir: Optional[str] = None
_min_compile_secs = 0.5


def _default_dir() -> str:
    """``kernels/_build/`` where the package can be written, else the
    user's cache directory."""
    probe = TREE_DIR if os.path.isdir(TREE_DIR) else os.path.dirname(TREE_DIR)
    if os.access(probe, os.W_OK):
        return TREE_DIR
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "pdwt_tpu_torch")


def enable_compile_cache(path: Optional[str] = None, min_compile_secs: float = 0.5) -> str:
    """Build the kernel library and the native engine into ``path``
    (default: ``PDWT_TPU_COMPILE_CACHE``, else :func:`_default_dir`).
    Builds faster than ``min_compile_secs`` are not kept.  Safe to call
    more than once; returns the directory."""
    global _dir, _min_compile_secs
    _dir = os.path.abspath(path or os.environ.get("PDWT_TPU_COMPILE_CACHE") or _default_dir())
    _min_compile_secs = float(min_compile_secs)
    return _dir


def build_dir() -> str:
    """The directory builds go into now (module docstring)."""
    if _dir is not None:
        return _dir
    env = os.environ.get("PDWT_TPU_COMPILE_CACHE")
    return os.path.abspath(env) if env else _default_dir()


def keep(seconds: float) -> bool:
    """Whether a build that took ``seconds`` is kept in the cache."""
    return seconds >= _min_compile_secs
