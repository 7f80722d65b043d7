"""port_kernel_gb (GB): bytes per call that the program's launches take
and return, every tensor of a kernel wrapper's arguments and results once,
as its ``pdwt.kernels.*`` spans count them (``program_spans.py``)."""
from wavebench import program_spans


def read(r):
    return program_spans.kernel_gb(r)
