"""What the program's span recorder (``pdwt_tpu_torch/utils/profiling.py``)
holds after a traced run: host time by layer and the operand bytes of the
program's launches, as values per call.

The recorder is on while the profiler runs, so its table covers every
traced window of the run (``tracing.profiled`` profiles again where a
window falls short) and nothing else.  The calls it saw are its
``pdwt.kernels.*`` spans over the program's launches a call
(``r.trace.port_launches``, from the launch counters): every call makes the
same launches, each inside the span of its wrapper.  A reading is None
where the program has no recorder (a checkout older than it), the trace is
missing, or the spans do not make a whole number of calls.
"""
from __future__ import annotations

from typing import Optional, Tuple

KERNELS = "pdwt.kernels."


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from pdwt_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "span_table") and hasattr(profiling, "OPERAND_BYTES")):
        return None
    return profiling


def calls_seen(table: dict, port_launches) -> Optional[int]:
    """The calls the table's kernel spans make at ``port_launches`` a call,
    or None where they do not make a whole number."""
    n = sum(row["count"] for name, row in table.items() if name.startswith(KERNELS))
    if not n or not port_launches:
        return None
    calls = round(n / port_launches)
    if calls < 1 or abs(calls * port_launches - n) > 1e-9 * n:
        return None
    return calls


def _reading(r) -> Optional[Tuple[dict, int, int]]:
    """(span table, operand bytes, calls seen), or None."""
    prof = recorder()
    if prof is None or r.trace is None:
        return None
    table = prof.span_table()
    calls = calls_seen(table, r.trace.port_launches)
    if calls is None:
        return None
    return table, sum(prof.OPERAND_BYTES.values()), calls


def host_ms(r, prefixes: Tuple[str, ...], field: str) -> Optional[float]:
    """Host ms per call in the spans whose names start with one of
    ``prefixes``, by ``field`` ("self_ns" or "total_ns"); None where no such
    span was recorded."""
    got = _reading(r)
    if got is None:
        return None
    table, _, calls = got
    rows = [row[field] for name, row in table.items() if name.startswith(prefixes)]
    return sum(rows) / calls / 1e6 if rows else None


def kernel_gb(r) -> Optional[float]:
    """GB (1e9 bytes) of operands per call of the program's launches."""
    got = _reading(r)
    if got is None:
        return None
    _, nbytes, calls = got
    return nbytes / calls / 1e9
