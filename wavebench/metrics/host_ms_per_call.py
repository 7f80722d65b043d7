"""host_ms_per_call (ms): the host's time to issue one entry call, by the
benchmark's clock around it (the waits on earlier calls left out), the
mean over the traced window; the facade's and the models' layer."""


def read(r):
    if r.trace is None or not r.host_s:
        return None
    return sum(r.host_s) / len(r.host_s) * 1e3
