"""throughput (Msamples/s): input samples of every call completed in the
window over the window's length, from a CUDA event recorded before the
first call to the last call's end event."""


def read(r):
    return r.samples_per_call * r.calls / r.window_s / 1e6
