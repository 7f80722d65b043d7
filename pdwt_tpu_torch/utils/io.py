"""Raw ``.dat`` I/O, as the reference's demo reads and writes images: raw
float32 in native byte order, the shape given by the caller (the port's
own copy of ``pdwt_tpu/utils/io.py``; numpy only)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def read_dat(path: str, shape: Optional[Sequence[int]] = None, dtype=np.float32) -> np.ndarray:
    """Read a raw array; reshape it if ``shape`` is given."""
    arr = np.fromfile(path, dtype=dtype)
    if shape is not None:
        arr = arr.reshape(tuple(shape))
    return arr


def write_dat(path: str, arr) -> None:
    """Write ``arr`` as raw float32 in C order."""
    np.ascontiguousarray(np.asarray(arr, dtype=np.float32)).tofile(path)
