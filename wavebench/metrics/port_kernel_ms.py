"""port_kernel_ms (ms): device time per call in the program's own CUDA
kernels (the ``__global__`` functions of its sources)."""
from wavebench import tracing


def read(r):
    if r.trace is None:
        return None
    return tracing.per_call_ms(r.trace, lambda n: tracing.is_port_kernel(n, r.trace.names))
