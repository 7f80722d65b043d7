"""roofline_share (%): the least time the card could take for one call
over its device busy time per call.  The least time is the larger of the
call's bytes over the card's memory bandwidth and its filter-bank flops
over its float32 rate (``work/``, from the cell's shapes alone; the peaks
from ``peaks.json`` by the card's name).  The card's power limit is in the
result line beside it."""


def read(r):
    peak = r.peaks.get(r.device_kind)
    if r.trace is None or peak is None or r.trace.busy_ms_per_call <= 0:
        return None
    bound_s = max(r.bytes / peak["hbm_bytes_per_s"], r.flops / peak["fp32_flops_per_s"])
    return bound_s / (r.trace.busy_ms_per_call / 1e3) * 100
