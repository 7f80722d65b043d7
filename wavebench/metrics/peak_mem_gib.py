"""peak_mem_gib (GiB): ``torch.cuda.max_memory_allocated`` over the
window, its count reset at the window's start, the inputs included."""


def read(r):
    return r.peak_bytes / 2 ** 30 if r.peak_bytes else None
