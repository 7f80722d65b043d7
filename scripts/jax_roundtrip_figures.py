"""Roundtrip errors of the JAX package on the CPU for the bf16 2D SWT, the
non-separable cells and the wavelet packets, on the inputs ``chip_smoke.py``
uses on the card.

    JAX_PLATFORMS=cpu python scripts/jax_roundtrip_figures.py [--small]

The JAX side runs its Pallas path in interpret mode (``backend="pallas"``
inside ``precision_scope``) under each tier.  Inputs: the TI image (1024 x
1024 uniform [0, 255] from ``default_rng(1)``), db7 SWT with 3 levels; the
DWT image (2048 x 2048 from ``default_rng(0)``), the rank-3 quads of
``chip_smoke.pr_quads`` with 5 levels, and the same quads' SWT of the TI
image with 3 levels; the packet tree of the DWT image (db7, 5 levels,
``iwp2d(wp2d(x))``) and of 1024 signals of 4096 uniform [0, 255] samples
from ``default_rng(2)`` (sym8, 4 levels) under ``mixed`` and
``bf16-fast``, whose A-chain JAX casts to bf16 at every depth.  Prints one
JSON line, max |inverse(forward(x)) - x| per cell and tier:
``chip_smoke.py`` keeps it as ``JAX_CPU_ROUNDTRIP``.  ``--small`` cuts the
images to 256 x 256 and the signals to 64 x 1024 for a quick look.  Takes
a few minutes on the CPU.
"""
import json
import os
import sys

os.environ.setdefault("PDWT_PALLAS_INTERPRET", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pdwt_tpu.core import nonseparable as jns  # noqa: E402
from pdwt_tpu.core import packets as jpk  # noqa: E402
from pdwt_tpu.core import precision as jprec  # noqa: E402
from pdwt_tpu.core import separable as jsep  # noqa: E402
from pdwt_tpu.filters import get_wavelet  # noqa: E402

TIERS = ("mixed", "bf16-fast", "bf16-balanced", "bf16-accurate")
PACKET_TIERS = ("mixed", "bf16-fast")


def pr_quads(seed: int = 3):
    """The rank-3 quads of ``chip_smoke.pr_quads``: db2's quads padded to 8
    taps, the HH column filter delayed by one subband sample, mixed by an
    orthogonal 4x4 matrix from a seed."""
    w = get_wavelet("db2")
    pad = lambda f, lo, hi: np.concatenate([np.zeros(lo), f, np.zeros(hi)])
    c = lambda f: pad(f, 2, 2)
    quads = lambda lo, hi, hh: np.stack([np.outer(c(lo), c(lo)), np.outer(c(hi), c(lo)),
                                         np.outer(c(lo), c(hi)), np.outer(c(hi), hh)])
    U = np.linalg.qr(np.random.default_rng(seed).standard_normal((4, 4)))[0]
    return (np.einsum("st,tij->sij", U, quads(w.dec_lo, w.dec_hi, pad(w.dec_hi, 0, 4))),
            np.einsum("st,tij->sij", U, quads(w.rec_lo, w.rec_hi, pad(w.rec_hi, 4, 0))))


def main() -> None:
    small = "--small" in sys.argv
    n_ti, n_ns = (256, 256) if small else (1024, 2048)
    ti_img = np.random.default_rng(1).uniform(0, 255, (n_ti, n_ti)).astype(np.float32)
    ns_img = np.random.default_rng(0).uniform(0, 255, (n_ns, n_ns)).astype(np.float32)
    w7 = get_wavelet("db7")
    qf, qi = pr_quads()
    err = lambda y, ref: float(jnp.abs(y.astype(jnp.float32) - ref).max())
    out = {"2D SWT": {}, "NS DWT": {}, "NS SWT": {}}
    for tier in TIERS:
        dt = jnp.bfloat16 if tier.startswith("bf16-") else jnp.float32
        xt, xn = jnp.asarray(ti_img).astype(dt), jnp.asarray(ns_img).astype(dt)
        with jprec.precision_scope(tier):
            y = jsep.iswt2d(jsep.swt2d(xt, w7, 3, backend="pallas"), w7, backend="pallas")
            out["2D SWT"][tier] = err(y, ti_img)
            y = jns.idwt2d_ns(jns.dwt2d_ns(xn, qf, 5, backend="pallas"), qi, ns_img.shape,
                              backend="pallas")
            out["NS DWT"][tier] = err(y, ns_img)
            y = jns.iswt2d_ns(jns.swt2d_ns(xt, qf, 3, backend="pallas"), qi, backend="pallas")
            out["NS SWT"][tier] = err(y, ti_img)
    sig = np.random.default_rng(2).uniform(0, 255, (64, 1024) if small else (1024, 4096))
    sig = sig.astype(np.float32)
    w8 = get_wavelet("sym8")
    out.update({"2D packets": {}, "1D packets": {}})
    for tier in PACKET_TIERS:
        dt = jnp.bfloat16 if tier.startswith("bf16-") else jnp.float32
        with jprec.precision_scope(tier):
            p = jpk.wp2d(jnp.asarray(ns_img).astype(dt), w7, 5, backend="pallas")
            out["2D packets"][tier] = err(jpk.iwp2d(p.nodes[-1], w7, ns_img.shape,
                                                    backend="pallas"), ns_img)
            p = jpk.wp1d(jnp.asarray(sig).astype(dt), w8, 4, backend="pallas")
            out["1D packets"][tier] = err(jpk.iwp1d(p.nodes[-1], w8, sig.shape[-1],
                                                    backend="pallas"), sig)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
