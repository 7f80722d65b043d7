"""setup_s (s): from the process's start to the first timed call: CUDA's
start, the kernel library's load (or, in a fresh checkout, its build), the
inputs and the warm-up of the cell's own shapes."""


def read(r):
    return r.setup_s
