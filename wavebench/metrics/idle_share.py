"""idle_share (%): 1 - busy time per call times the calls over the traced
window's length: the share of the window in which the card ran nothing."""


def read(r):
    if r.trace is None:
        return None
    return (1 - r.trace.busy_ms_per_call * r.calls / (r.window_s * 1e3)) * 100
