"""ops_gb (GB): bytes (1e9) per call that the program's ops layer takes and
returns, every tensor of an ops function's arguments and results once, as
its outermost ``pdwt.ops.*`` spans count them
(``OPS_OPERAND_BYTES`` in ``pdwt_tpu_torch/utils/profiling.py``), over the
calls ``program_spans.calls_seen`` finds.  0.0 where the recorder ran and
counted no ops span; None where the program has no such counter (a
checkout older than it), the trace is missing or the calls do not divide."""
from wavebench import program_spans


def read(r):
    prof = program_spans.recorder()
    counts = getattr(prof, "OPS_OPERAND_BYTES", None) if prof is not None else None
    if counts is None or r.trace is None:
        return None
    calls = program_spans.calls_seen(prof.span_table(), r.trace.port_launches)
    if calls is None:
        return None
    return sum(counts.values()) / calls / 1e9
