"""ops_copies_ms (ms): device time per call in every device operation that
is not one of the program's own kernels: torch's elementwise ops and
reductions, copies, ``cat``, and any library kernel."""
from wavebench import tracing


def read(r):
    if r.trace is None:
        return None
    return tracing.per_call_ms(r.trace, lambda n: not tracing.is_port_kernel(n, r.trace.names))
