"""``utils.cache.enable_compile_cache``: where the CUDA kernel library and
the native engine are built.  It moves ``kernels._build.library_path()``
and the native build, honours ``PDWT_TPU_COMPILE_CACHE``, and falls back to
the user's cache directory when the package cannot be written (a
read-only install)."""
import os

import numpy as np
import pytest

from pdwt_tpu_torch.filters import get_wavelet
from pdwt_tpu_torch.kernels import _build
from pdwt_tpu_torch.native import lib as native
from pdwt_tpu_torch.utils import cache, enable_compile_cache


@pytest.fixture(autouse=True)
def _restore(monkeypatch):
    monkeypatch.setattr(cache, "_dir", None)
    monkeypatch.setattr(cache, "_min_compile_secs", 0.5)
    monkeypatch.delenv("PDWT_TPU_COMPILE_CACHE", raising=False)


def test_default_is_the_tree_where_it_can_be_written():
    assert cache.build_dir() == cache.TREE_DIR == _build.BUILD_DIR
    assert os.path.dirname(_build.library_path()) == cache.TREE_DIR


def test_enable_moves_the_kernel_library_and_the_native_build(tmp_path):
    assert enable_compile_cache(str(tmp_path)) == str(tmp_path)
    assert os.path.dirname(_build.library_path()) == str(tmp_path)
    assert os.path.dirname(native.library_path()) == str(tmp_path)
    assert enable_compile_cache(str(tmp_path / "b")) == str(tmp_path / "b")  # again
    assert os.path.dirname(_build.library_path()) == str(tmp_path / "b")


def test_the_environment_variable(tmp_path, monkeypatch):
    monkeypatch.setenv("PDWT_TPU_COMPILE_CACHE", str(tmp_path / "env"))
    assert cache.build_dir() == str(tmp_path / "env")
    assert enable_compile_cache() == str(tmp_path / "env")
    assert enable_compile_cache(str(tmp_path / "arg")) == str(tmp_path / "arg")


def test_read_only_package_falls_back_to_the_user_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    real = os.access
    monkeypatch.setattr(os, "access", lambda p, mode: False if str(p).startswith(
        os.path.dirname(cache.TREE_DIR)) else real(p, mode))
    want = str(tmp_path / "xdg" / "pdwt_tpu_torch")
    assert cache.build_dir() == want
    assert enable_compile_cache() == want
    assert os.path.dirname(_build.library_path()) == want
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setattr(cache, "_dir", None)
    assert cache.build_dir() == os.path.join(os.path.expanduser("~"), ".cache",
                                             "pdwt_tpu_torch")


@pytest.mark.skipif(not native.is_available(), reason="no C++ compiler")
def test_min_compile_secs_keeps_or_drops_the_build(tmp_path, monkeypatch):
    """A build faster than ``min_compile_secs`` is loaded and not kept; a
    slower one stays in the cache."""
    monkeypatch.setattr(native, "_libs", {})
    enable_compile_cache(str(tmp_path / "drop"), min_compile_secs=1e9)
    c = native.dwt2d(np.ones((8, 8), np.float32), get_wavelet("db2"), 1)
    assert float(c.approx.sum()) > 0 and os.listdir(tmp_path / "drop") == []
    monkeypatch.setattr(native, "_libs", {})
    enable_compile_cache(str(tmp_path / "keep"), min_compile_secs=0.0)
    native.dwt2d(np.ones((8, 8), np.float32), get_wavelet("db2"), 1)
    assert os.listdir(tmp_path / "keep") == [os.path.basename(native.library_path())]
