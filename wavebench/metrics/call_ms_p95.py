"""call_ms_p95 (ms): the 95th percentile over the window's calls of the
interval between consecutive end events on the stream (the first from the
window's start event), so idle time while the host falls behind counts."""
import statistics


def read(r):
    if len(r.intervals_ms) < 2:
        return None
    return statistics.quantiles(r.intervals_ms, n=20, method="inclusive")[18]
