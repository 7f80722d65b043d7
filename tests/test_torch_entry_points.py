"""The ctypes table of the kernel library (``kernels/_build.py:
SIGNATURES``) and the ``extern "C" int`` entry points that
``_build.SOURCES`` define name the same functions, each with its arguments
in the same order, pointers and ints in the same places.  ctypes passes
what the table says, so a stale or missing row would hand an entry point
the wrong arguments without a word."""
import re

import pytest

from pdwt_tpu_torch.kernels import _build

_ENTRY = re.compile(r'extern "C" int (pdwt_\w+)\(([^)]*)\)\s*\{')


def _c_entries():
    """{name: ["P" or "I" per parameter]} of the entry points the sources
    define (declarations without a body left out)."""
    out = {}
    for src in _build.SOURCES:
        with open(src) as f:
            for name, params in _ENTRY.findall(f.read()):
                out[name] = ["P" if "*" in p else "I" for p in params.split(",")]
    return out


C_ENTRIES = _c_entries()


@pytest.mark.parametrize("name", sorted(set(C_ENTRIES) | set(_build.SIGNATURES)))
def test_ctypes_table_matches_the_c_entry_point(name):
    assert name in C_ENTRIES, f"{name} has a ctypes signature but no source defines it"
    assert name in _build.SIGNATURES, f"{name} is defined but has no ctypes signature"
    kinds = ["P" if t is _build.P else "I" for t in _build.SIGNATURES[name]]
    assert kinds == C_ENTRIES[name]
