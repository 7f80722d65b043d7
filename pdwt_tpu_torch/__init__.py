"""pdwt_tpu_torch: the PyTorch and CUDA port of pdwt-tpu.

A second package beside ``pdwt_tpu`` (the JAX reference, which stays as
it is), with the same module names:

* ``filters``  — the 72-wavelet bank, custom filters and the non-separable
  quads (numpy)
* ``core``     — ``dwt2d``/``idwt2d`` (with the boundary modes, ``MODES``),
  ``swt2d``/``iswt2d``/``iswt2d_denoise``, the 3D ``dwt3d``/``idwt3d``/
  ``swt3d``/``iswt3d``/``iswt3d_denoise`` (``Coeffs3D``),
  the batched 1D ``dwt1d``/``idwt1d``/``swt1d``/``iswt1d``, the
  non-separable ``dwt2d_ns``/``idwt2d_ns``/``swt2d_ns``/``iswt2d_ns``, the
  wavelet packets (``wp1d``/``wp2d``/``wp3d``, their inverses, the best
  basis, ``wp_reconstruct``), the starlet (``starlet``/``istarlet``), the
  dual-tree complex DWT (``dtcwt1d``/``dtcwt2d``, their inverses and
  denoisers), the fully separable ``fs_dwt``/``fs_idwt``/``fs_slices``,
  the continuous ``cwt``/``icwt``/``cwt2d`` and the plain reference path
  (``conv``)
* ``kernels``  — hand-written CUDA kernels for Hopper (sm_90a), their
  plain PyTorch versions, launch counters and autograd Functions
* ``ops``      — soft, hard, garrote, group and firm thresholds, the L2
  shrink and the L-infinity projection, the norms (``norm1``, ``norm2sq``,
  ``norm_l21`` and their thresholded forms), the coefficient axpy, circular
  shifts (1D, 2D, 3D) and the threshold estimators (noise sigma, universal, BayesShrink,
  SureShrink)
* ``models``   — the denoising step (DWT and TI), ``auto_denoise``,
  ``cycle_spin_denoise``, their volume forms ``denoise_step_3d`` and
  ``auto_denoise_3d``, ``starlet_auto_denoise``, ``packet_denoise`` and the
  (F)ISTA solver ``ista``
* ``api``      — the stateful ``Wavelets`` facade; ``api_packets``
  (``WaveletPackets``) and ``api_extras`` (``Starlet``, ``DualTree``)
* ``parallel`` — device meshes on ``torch.distributed``, the ring halo
  exchange and the sharded 2D, batched 1D, 3D, non-separable, fully
  separable, starlet and packet transforms (DTensors)
* ``utils``    — raw ``.dat`` I/O, coefficient checkpoints in the JAX
  package's ``.npz`` layout, numpy conversions to and from it, the pywt
  drop-ins and containers (``interop``), the sanitizers (``debug``), the
  slope timing and traces (``profiling``) and the build directory
  (``cache``)
* ``native``   — ctypes binding of the C++ CPU engine (``cpp/``), compiled
  on first use
* ``demo``     — the reference demo's scenarios 1-3, on an image or (``--nd``)
  a volume, and the packet, starlet and dual-tree denoisers (scenarios 4-6;
  ``python -m pdwt_tpu_torch.demo``)

The port covers the 2D separable DWT under every boundary mode of JAX's
(``mode=``: periodization, the default, and the eight pywt modes, per
axis too; the decimated 1D DWT likewise), the 2D stationary
transform with its TI-denoise step (the threshold fused into the
inverse), the batched 1D DWT and SWT
(``Wavelets(ndim=1)``) and the non-separable 2D DWT and SWT
(``Wavelets(do_separable=False)``), in the exact tier and the precision
tiers (``mixed``, ``bf16-fast``, ``bf16-balanced``, ``bf16-accurate``;
``precision=`` on every entry point, or ``precision_scope``), on eighteen
CUDA kernels (and the padded entry points of four of them, which carry
the boundary modes, and of four more, which carry the sharded SWT), the
reference's whole operator set on them, the sharded 2D and 1D transforms
over a device mesh, and the separable 3D DWT and SWT (with the 3D
TI-denoise step, ``Wavelets`` on a volume, the volume denoisers and 3D
checkpoints): the 2D level kernels with depth as their batch, the depth
pass one matrix product; the sharded volumes and non-separable
transforms; the packet, starlet and dual-tree families on those
transforms and the conv passes; the fully separable transform on the
batched 1D kernels, the CWT on ``torch.fft``, the pywt drop-ins, and the
sharded fully separable, starlet and packet transforms.  Importing the
package needs no GPU and builds nothing; the CUDA kernels are compiled at
their first launch.  ``backend=`` on every transform picks JAX's route:
the kernels (``None``, ``"pallas"``) or one of JAX's three conv
formulations (``"fma"``, ``"xla"``, ``"gather"``; ``core/conv.py``).
"""
# utils first: the layers below take their spans from utils/profiling.py, and
# utils' other modules import core
from . import utils
from . import core, filters, models, native, ops, parallel
from .api import Wavelets, WaveletSpec
from .api_extras import DualTree, Starlet
from .api_packets import WaveletPackets
from .core.modes import MODES
from .core.precision import TIERS, precision_scope
from .core.nonseparable import dwt2d_ns, idwt2d_ns, iswt2d_ns, swt2d_ns
from .core.separable import (Coeffs1D, Coeffs2D, dwt1d, dwt2d, idwt1d, idwt2d, iswt1d,
                             iswt2d, iswt2d_denoise, swt1d, swt2d)
from .core.separable3d import (DETAIL_KEYS_3D, Coeffs3D, dwt3d, idwt3d, iswt3d, iswt3d_denoise,
                               swt3d)
from .filters import (Wavelet, get_wavelet, list_wavelets, make_custom_wavelet, quad_filters,
                      register_wavelet)

__all__ = ["Wavelets", "WaveletSpec", "WaveletPackets", "Starlet", "DualTree", "Wavelet",
           "get_wavelet", "list_wavelets", "make_custom_wavelet", "register_wavelet",
           "quad_filters", "dwt2d", "idwt2d", "swt2d", "iswt2d", "iswt2d_denoise", "Coeffs2D",
           "dwt1d", "idwt1d", "swt1d", "iswt1d", "Coeffs1D", "dwt3d", "idwt3d", "swt3d",
           "iswt3d", "iswt3d_denoise", "Coeffs3D", "DETAIL_KEYS_3D", "dwt2d_ns", "idwt2d_ns",
           "swt2d_ns", "iswt2d_ns", "TIERS", "MODES", "precision_scope", "core", "filters",
           "models", "native", "ops", "parallel", "utils"]
