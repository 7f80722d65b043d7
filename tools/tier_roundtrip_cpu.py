"""Roundtrip error of each precision tier on the CPU, JAX package beside the
port, on the inputs ``chip_smoke.py`` uses on the card.

    JAX_PLATFORMS=cpu PDWT_PALLAS_INTERPRET=1 python tools/tier_roundtrip_cpu.py [--small]

The JAX side runs its Pallas path in interpret mode (``backend="pallas"``
inside ``precision_scope``), the port its plain versions (what its CUDA
kernels compute).  Inputs: db7, 5 levels, a 2048 x 2048 uniform [0, 255]
image from ``default_rng(0)``; sym8, 4 levels, 1024 signals of 4096
uniform [0, 255] samples from ``default_rng(3)``, DWT and SWT.  Prints one
JSON line per transform and tier: max |inverse(forward(x)) - x| on both
sides.  ``--small`` cuts the sizes (256 x 256 to 3 levels, 32 x 512 to 2
levels) for a quick look.
"""
import json
import os
import sys

os.environ.setdefault("PDWT_PALLAS_INTERPRET", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pdwt_tpu.core import precision as jprec  # noqa: E402
from pdwt_tpu.core import separable as jsep  # noqa: E402
from pdwt_tpu.filters import get_wavelet as jget_wavelet  # noqa: E402
from pdwt_tpu_torch import dwt1d, dwt2d, idwt1d, idwt2d, iswt1d, swt1d  # noqa: E402
from pdwt_tpu_torch.utils import wavelet_from_arrays  # noqa: E402

TIERS = ("mixed", "bf16-fast", "bf16-balanced", "bf16-accurate")


def main() -> None:
    small = "--small" in sys.argv
    n, levels = (256, 3) if small else (2048, 5)
    b, m, levels1 = (32, 512, 2) if small else (1024, 4096, 4)
    img = np.random.default_rng(0).uniform(0, 255, (n, n)).astype(np.float32)
    sig = np.random.default_rng(3).uniform(0, 255, (b, m)).astype(np.float32)
    jw7, jw8 = jget_wavelet("db7"), jget_wavelet("sym8")
    w7, w8 = wavelet_from_arrays(jw7), wavelet_from_arrays(jw8)
    for tier in TIERS:
        bf16 = tier.startswith("bf16-")
        for kind, x in (("dwt2d", img), ("dwt1d", sig), ("swt1d", sig)):
            jx = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
            tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
            with jprec.precision_scope(tier):
                if kind == "dwt2d":
                    jy = jsep.idwt2d(jsep.dwt2d(jx, jw7, levels, backend="pallas"), jw7, (n, n),
                                     backend="pallas")
                elif kind == "dwt1d":
                    jy = jsep.idwt1d(jsep.dwt1d(jx, jw8, levels1, backend="pallas"), jw8, m,
                                     backend="pallas")
                else:
                    jy = jsep.iswt1d(jsep.swt1d(jx, jw8, levels1, backend="pallas"), jw8,
                                     backend="pallas")
            if kind == "dwt2d":
                ty = idwt2d(dwt2d(tx, w7, levels, precision=tier), w7, (n, n), precision=tier)
            elif kind == "dwt1d":
                ty = idwt1d(dwt1d(tx, w8, levels1, precision=tier), w8, m, precision=tier)
            else:
                ty = iswt1d(swt1d(tx, w8, levels1, precision=tier), w8, precision=tier)
            jerr = float(np.abs(np.asarray(jy.astype(jnp.float32)) - x).max())
            terr = float((ty.float() - torch.from_numpy(x)).abs().max())
            print(json.dumps({"transform": kind, "tier": tier, "shape": list(x.shape),
                              "levels": levels if kind == "dwt2d" else levels1,
                              "jax_cpu_err": jerr, "port_cpu_err": terr}), flush=True)


if __name__ == "__main__":
    main()
