"""ops_roofline_share (%): the least time the card could take to move the
ops layer's operand bytes of one call (``ops_gb`` over the card's memory
bandwidth, ``peaks.json`` by the card's name) over the device time per call
of the operations that are not the program's own kernels (what
``ops_copies_ms`` reads).  None where either reads nothing."""
from wavebench.metrics import ops_copies_ms, ops_gb


def read(r):
    gb, ms = ops_gb.read(r), ops_copies_ms.read(r)
    peak = r.peaks.get(r.device_kind)
    if gb is None or not ms or peak is None:
        return None
    return gb * 1e9 / peak["hbm_bytes_per_s"] / (ms / 1e3) * 100
