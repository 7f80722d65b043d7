"""kernels_host_ms (ms): host time per call in the program's kernel
wrappers (taps, plan, output allocation, the launch), the time of its
``pdwt.kernels.*`` spans (``program_spans.py``)."""
from wavebench import program_spans


def read(r):
    return program_spans.host_ms(r, ("pdwt.kernels.",), "total_ns")
