"""transform_host_ms (ms): host time per call in the transform layer's own
code (route, batch flattening, odd extension, autograd's apply), the self
time of the program's ``pdwt.transform.*`` spans (``program_spans.py``)."""
from wavebench import program_spans


def read(r):
    return program_spans.host_ms(r, ("pdwt.transform.",), "self_ns")
