"""launches_per_call (count): the program's kernels by its launch counters,
plus every other device operation (torch's and cuBLAS's) by the trace's
count per name, rounded up to whole launches a call."""
from wavebench import tracing


def read(r):
    if r.trace is None:
        return None
    return r.trace.port_launches + tracing.other_launches(r.trace)
