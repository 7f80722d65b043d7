"""Demo CLI of the PyTorch port, the scenarios of ``pdwt_tpu/demo.py``
(1-3 those of the reference demo): load a raw float32 ``.dat`` image, run
one scenario on the CUDA card (``--device cpu`` for the CPU), write the
result.

    python -m pdwt_tpu_torch.demo image.dat --nr 512 --nc 512 --scenario 3 \
        --wavelet db7 --levels 5 [--swt] [--nonseparable] [--cycle-spinning] \
        [--beta 90] [--auto-beta {none,universal,bayes}] [--mode symmetric] \
        [--precision {exact,mixed,bf16}] [--device cuda] [--nd 64] [--interactive]

Scenarios:
  1  forward only (writes the approximation)
  2  forward + inverse: perfect reconstruction.  The image is overwritten
     with zeros before the inverse, so the reconstruction comes from the
     coefficients alone, as in the reference.
  3  forward + soft threshold (--beta, or --auto-beta) + inverse
  4  best-basis wavelet-packet denoise (2D; --auto-beta other than none
     takes the threshold from the data, else --beta)
  5  starlet k-sigma denoise (a volume under --nd)
  6  dual-tree complex magnitude denoise (2D)
``--interactive`` asks for the configuration as the reference demo does
when run without arguments.  ``--mode`` picks the boundary extension of
the separable decimated DWT (periodization, the reference's, or a pywt
mode: zero, constant, symmetric, reflect, periodic, smooth, antisymmetric,
antireflect).  ``--nd`` reads a volume of nd x nr x nc float32 samples and
runs the scenario on it (the 3D transforms; scenarios 4 and 6 refuse it,
as JAX's demo does).  ``--native`` runs scenarios 1-3 on the C++ CPU
engine (``pdwt_tpu_torch.native``) in place of the facade, as JAX's demo
does.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _ask_config(args) -> None:
    """The reference demo's questions, each keeping its default on an empty
    line or an invalid value."""
    def ask(label, default, cast):
        raw = input(f"{label} [{default}]: ").strip()
        try:
            return cast(raw) if raw else default
        except ValueError:
            print(f"  invalid value {raw!r}; keeping {default}")
            return default

    print("Interactive configuration (empty line keeps the default)")
    args.scenario = ask("Scenario (1=fwd, 2=fwd+inv, 3=fwd+thresh+inv, 4=packets, 5=starlet, "
                        "6=dual-tree)", args.scenario, int)
    args.wavelet = ask("Wavelet name", args.wavelet, str)
    args.levels = ask("Number of levels", args.levels, int)
    args.swt = bool(ask("Use SWT (0/1)", int(args.swt), int))
    args.cycle_spinning = bool(ask("Use cycle spinning (0/1)", int(args.cycle_spinning), int))
    if args.scenario == 3:
        args.beta = ask("Threshold beta", args.beta, float)


def _denoise_scenario(p, args, img) -> int:
    """Scenarios 4-6: the packet, starlet and dual-tree denoisers on the
    image (scenario 5 also on a volume)."""
    from pdwt_tpu_torch.core import dtcwt_auto_denoise
    from pdwt_tpu_torch.models import packet_denoise, starlet_auto_denoise
    from pdwt_tpu_torch.utils import tensor_to_numpy, write_dat
    from pdwt_tpu_torch.utils.convert import image_tensor

    if args.scenario == 6:
        if args.native or args.nd:
            p.error("scenario 6 (dual-tree denoise) needs the 2D JAX engine")
        rec = dtcwt_auto_denoise(image_tensor(img, args.device), args.levels)
        print("dual-tree complex magnitude denoise applied "
              f"({args.levels} levels, 6 oriented bands)")
    elif args.scenario == 5:
        if args.native:
            p.error("scenario 5 (starlet denoise) needs the JAX engine")
        rec = starlet_auto_denoise(image_tensor(img, args.device), args.levels,
                                   ndim=3 if args.nd else 2)
        print(f"starlet k-sigma auto denoise applied ({args.levels} isotropic scales)")
    else:
        if args.native or args.nd:
            p.error("scenario 4 (packet denoise) needs the 2D JAX engine")
        beta = None if args.auto_beta != "none" else args.beta
        rec = packet_denoise(image_tensor(img, args.device), args.wavelet, args.levels, beta)
        which = "universal (auto)" if beta is None else f"{beta:g}"
        print(f"best-basis packet denoise applied (beta = {which})")
    rec = tensor_to_numpy(rec).astype(np.float32)
    err = float(np.abs(rec - img).max())
    print(f"max |denoised - input| = {err:.3e} (expected nonzero)")
    write_dat(args.out, rec)
    print(f"result written to {args.out}")
    return 0


def _native(args, img, shape) -> int:
    """Scenarios 1-3 on the C++ CPU engine, as JAX's demo runs them."""
    from pdwt_tpu_torch import native
    from pdwt_tpu_torch.filters import get_wavelet
    from pdwt_tpu_torch.utils import tensor_to_numpy, write_dat

    w = get_wavelet(args.wavelet)
    fwd = native.dwt3d if args.nd else native.dwt2d
    inv = native.idwt3d if args.nd else native.idwt2d
    coeffs = fwd(img, w, args.levels, swt=args.swt)
    print(f"forward done (native): {args.wavelet}, {args.levels} levels")
    if args.scenario == 1:
        write_dat(args.out, tensor_to_numpy(coeffs.approx))
        print(f"approximation written to {args.out}")
        return 0
    if args.scenario == 3:
        det = tuple(tuple(native.soft_threshold(b, args.beta) for b in lvl)
                    for lvl in coeffs.details)
        coeffs = type(coeffs)(coeffs.approx, det)
    rec = tensor_to_numpy(inv(coeffs, w, shape, swt=args.swt)).astype(np.float32)
    err = float(np.abs(rec - img).max())
    note = " (thresholded: expected nonzero)" if args.scenario == 3 else ""
    print(f"max |reconstruction - input| = {err:.3e}{note}")
    write_dat(args.out, rec)
    print(f"result written to {args.out}")
    return 0


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
                   help="run on the C++ CPU engine (cpp/, compiled on first use)")
    p.add_argument("--mode", default="periodization",
                   help="boundary extension: periodization (the reference scheme) or any "
                        "pywt mode, zero, constant, symmetric, reflect, periodic, smooth, "
                        "antisymmetric, antireflect (separable DWT only)")
    p.add_argument("--precision", default="exact", choices=("exact", "mixed", "bf16"),
                   help="mixed = bf16x3 products; bf16 = the bf16-fast tier (bf16 "
                        "details, float32 approximation)")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card unless another is named")
    p.add_argument("--interactive", action="store_true",
                   help="prompt for the configuration as the reference demo does when run "
                        "without arguments")
    args = p.parse_args(argv)

    if args.mode != "periodization" and (args.swt or args.nonseparable):
        p.error("--mode (pywt boundary extensions) applies to the separable decimated DWT; "
                "the SWT and non-separable paths are periodization-only")

    if args.interactive:
        _ask_config(args)

    from pdwt_tpu_torch import Wavelets
    from pdwt_tpu_torch.utils import read_dat, tensor_to_numpy, write_dat

    if args.auto_beta != "none" and args.native:
        p.error("--auto-beta needs the JAX engine (drop --native)")
    shape = (args.nd, args.nr, args.nc) if args.nd else (args.nr, args.nc)
    img = read_dat(args.image, shape)
    if args.scenario in (4, 5, 6):
        return _denoise_scenario(p, args, img)
    if args.native:
        return _native(args, img, shape)
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
