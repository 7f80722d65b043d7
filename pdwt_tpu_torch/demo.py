"""Demo CLI of the PyTorch port, scenarios 1-3 of the reference demo (and
of ``pdwt_tpu/demo.py``): load a raw float32 ``.dat`` image, run one
scenario on the CUDA card (``--device cpu`` for the CPU), write the result.

    python -m pdwt_tpu_torch.demo image.dat --nr 512 --nc 512 --scenario 3 \
        --wavelet db7 --levels 5 [--swt] [--nonseparable] [--cycle-spinning] \
        [--beta 90] [--auto-beta {none,universal,bayes}] [--mode symmetric] \
        [--precision {exact,mixed,bf16}] [--device cuda] [--nd 64]

Scenarios:
  1  forward only (writes the approximation)
  2  forward + inverse: perfect reconstruction.  The image is overwritten
     with zeros before the inverse, so the reconstruction comes from the
     coefficients alone, as in the reference.
  3  forward + soft threshold (--beta, or --auto-beta) + inverse
``--mode`` picks the boundary extension of the separable decimated DWT
(periodization, the reference's, or a pywt mode: zero, constant, symmetric,
reflect, periodic, smooth, antisymmetric, antireflect).  ``--nd`` reads a
volume of nd x nr x nc float32 samples and runs the scenario on it (the 3D
transforms).  Scenarios 4-6 (packets, starlet, dual-tree) are not ported
yet and exit with the ROADMAP item that brings them; --native (the C++ CPU
engine) is left out of the port.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("image", help="raw float32 .dat file")
    p.add_argument("--nr", type=int, required=True)
    p.add_argument("--nc", type=int, required=True)
    p.add_argument("--nd", type=int, default=0, help="depth of a 3D volume (the .dat holds nd*nr*nc float32); "
                        "0 = a 2D image")
    p.add_argument("--scenario", type=int, default=2, choices=(1, 2, 3, 4, 5, 6))
    p.add_argument("--wavelet", default="haar")
    p.add_argument("--levels", type=int, default=1)
    p.add_argument("--swt", action="store_true")
    p.add_argument("--nonseparable", action="store_true")
    p.add_argument("--cycle-spinning", action="store_true")
    p.add_argument("--beta", type=float, default=90.0)
    p.add_argument("--auto-beta", default="none", choices=("none", "universal", "bayes"),
                   help="scenario 3: the threshold from the data (VisuShrink's universal "
                        "scalar, or BayesShrink per band) instead of --beta")
    p.add_argument("--out", default="res.dat")
    p.add_argument("--native", action="store_true",
                   help="the C++ CPU engine (left out of the port)")
    p.add_argument("--mode", default="periodization",
                   help="boundary extension: periodization (the reference scheme) or any "
                        "pywt mode, zero, constant, symmetric, reflect, periodic, smooth, "
                        "antisymmetric, antireflect (separable DWT only)")
    p.add_argument("--precision", default="exact", choices=("exact", "mixed", "bf16"),
                   help="mixed = bf16x3 products; bf16 = the bf16-fast tier (bf16 "
                        "details, float32 approximation)")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card unless another is named")
    args = p.parse_args(argv)

    if args.native:
        p.error("--native: the C++ CPU engine is left out of the port (ROADMAP, "
                "\"Leave out of the port\"); run pdwt_tpu.demo for it")
    if args.scenario in (4, 5, 6):
        p.error(f"scenario {args.scenario} (packets, starlet, dual-tree) comes with "
                "ROADMAP queue 1, item 14")
    if args.mode != "periodization" and (args.swt or args.nonseparable):
        p.error("--mode (pywt boundary extensions) applies to the separable decimated DWT; "
                "the SWT and non-separable paths are periodization-only")

    from pdwt_tpu_torch import Wavelets
    from pdwt_tpu_torch.utils import read_dat, tensor_to_numpy, write_dat

    img = read_dat(args.image, (args.nd, args.nr, args.nc) if args.nd else (args.nr, args.nc))
    tier = {"exact": "exact", "mixed": "mixed", "bf16": "bf16-fast"}[args.precision]
    W = Wavelets(img, wname=args.wavelet, levels=args.levels, do_swt=args.swt,
                 do_separable=not args.nonseparable, do_cycle_spinning=args.cycle_spinning,
                 mode=args.mode, precision=tier, device=args.device)
    W.print_informations()
    W.forward()
    print(f"norm1(coeffs) = {W.norm1():.6e}")
    if args.scenario == 1:
        write_dat(args.out, W.get_coeff(0))
        print(f"approximation written to {args.out}")
        return 0
    if args.scenario == 3:
        if args.auto_beta == "bayes":
            sigma = W.noise_sigma()
            W.bayes_shrink()
            print(f"BayesShrink applied (sigma~{sigma:.4g}); norm1 = {W.norm1():.6e}")
        else:
            beta = W.universal_threshold() if args.auto_beta == "universal" else args.beta
            W.soft_threshold(beta)
            print(f"soft threshold beta={beta:.6g} applied; norm1 = {W.norm1():.6e}")
    # the reconstruction comes from the coefficients alone
    W.set_image(np.zeros_like(img))
    rec = tensor_to_numpy(W.inverse()).astype(np.float32)
    err = float(np.abs(rec - img).max())
    note = " (thresholded: expected nonzero)" if args.scenario == 3 else ""
    print(f"max |reconstruction - input| = {err:.3e}{note}")
    write_dat(args.out, rec)
    print(f"result written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
