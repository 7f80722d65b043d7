"""models_host_ms (ms): host time per call in the facade's and the models'
own code, the self time of the program's ``pdwt.facade.*`` and
``pdwt.models.*`` spans (``program_spans.py``)."""
from wavebench import program_spans


def read(r):
    return program_spans.host_ms(r, ("pdwt.facade.", "pdwt.models."), "self_ns")
