"""ops_host_ms (ms): host time per call in the norms' and thresholds' own
code (torch's elementwise ops and sums issued there), the self time of the
program's ``pdwt.ops.*`` spans (``program_spans.py``)."""
from wavebench import program_spans


def read(r):
    return program_spans.host_ms(r, ("pdwt.ops.",), "self_ns")
