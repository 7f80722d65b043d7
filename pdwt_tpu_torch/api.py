"""Stateful ``Wavelets`` facade (counterpart of ``pdwt_tpu/api.py``).

The port covers one 2D image, a batch of 1D signals (``ndim=1``, or a 1D
array, or ``nr == 1``) or one 3D volume (a 3D array, or ``ndim=3``), the
separable and (2D, ``do_separable=False``)
non-separable DWT and SWT (``do_swt=True``), the boundary modes of the
separable DWT (``mode=``: periodization, the default, or any pywt mode, one
for every axis or one per axis) and the precision tiers (``precision=``),
with the reference's whole method set:
``forward``, ``inverse``, the thresholds (``soft_threshold``,
``hard_threshold``, ``garrote_threshold``, ``group_soft_threshold``,
``firm_threshold``, ``bayes_shrink``), ``shrink`` and ``proj_linf``, the
norms (``norm1``, ``norm2sq``, ``norm_l21``) and estimators
(``noise_sigma``, ``universal_threshold``), ``run_denoise`` (the whole
denoise step, an elementwise threshold fused into the 2D SWT inverse;
separable only), ``add_wavelet``, ``circshift``, ``copy``, ``get_coeff`` /
``set_coeff`` on the reference's flat numbering, ``get_image`` /
``set_image``, ``set_filters_forward`` / ``set_filters_inverse`` (two
filters, or four quads when non-separable), ``info`` /
``print_informations`` and cycle spinning (2D and 3D).  Haar runs the same
separable transforms as any other filter (the butterflies of
``core/haar.py`` are public functions, not a route of the facade).
A boundary mode other than periodization takes the decimated separable
DWT only (``ValueError`` with ``do_swt`` or ``do_separable=False``, a
warning under cycle spinning, as in JAX) and sizes the coefficients by
pywt's rule.  A volume runs the separable 3D transforms
(``core/separable3d.py``): the non-separable flag is ignored with a
warning, as in JAX; cycle spinning draws the row, the column, then the
depth shift; ``get_coeff``/``set_coeff`` number 0 the approximation, then
the 7 bands of level 1 (daa..ddd) 1..7, of level 2 8..14, and so on.

``backend=`` is passed to every separable transform the facade runs
(``core/separable.py``'s route: ``None`` or ``"pallas"`` the kernels,
``"fma"``, ``"xla"`` or ``"gather"`` JAX's conv formulations), as JAX's
facade passes it; the non-separable transforms take their default, as in
JAX.

The image and coefficients are tensors on one device: the device of an
image given as a tensor, else ``device=``, which defaults to the CUDA card
(without one, ``device="cpu"`` must be asked for).  The facade never moves
a tensor between devices; ``get_image()`` and ``get_coeff()`` copy to a
host numpy array only when asked (``copy=True``; a bf16 band comes out as
float32, which holds it exactly).

Precision: ``precision=None`` keeps the environment defaults ("auto");
``dtype=None`` means bf16 under a ``bf16-*`` tier, else float32; every
transform the facade runs runs inside ``precision_scope`` of its tier.
"""
from __future__ import annotations

import copy
import dataclasses
import enum
import warnings
from typing import Optional

import numpy as np
import torch

from . import ops
from .core import modes
from .core.nonseparable import dwt2d_ns, idwt2d_ns, iswt2d_ns, swt2d_ns
from .core.precision import check_tier, precision_scope, tier_for
from .core.separable import (Coeffs1D, Coeffs2D, _dwt1d_denoise_norm1, all_periodization,
                             dwt1d, dwt2d, idwt1d, idwt2d, iswt1d, iswt2d, iswt2d_denoise,
                             swt1d, swt2d, thresholds_in_kernel)
from .core.separable3d import Coeffs3D, dwt3d, idwt3d, iswt3d, iswt3d_denoise, swt3d
from .core.shapes import coeff_shapes_1d, coeff_shapes_2d, coeff_shapes_3d, max_level
from .filters import Wavelet, get_wavelet, make_custom_wavelet, quad_filters
from .utils.convert import (default_device, image_tensor, same_device, tensor_from_numpy,
                            tensor_to_numpy)
from .utils.profiling import DENOISE_PATHS, recording, spanned


class WState(enum.Enum):
    INIT = "W_INIT"
    FORWARD = "W_FORWARD"
    INVERSE = "W_INVERSE"
    THRESHOLD = "W_THRESHOLD"


@dataclasses.dataclass(frozen=True)
class WaveletSpec:
    """Static configuration of a :class:`Wavelets` instance."""

    wname: str
    nr: int
    nc: int
    nlevels: int
    do_cycle_spinning: bool
    dtype: torch.dtype
    hlen: int
    do_swt: bool
    ndim: int = 2
    #: precision tier (core/precision.py); "auto" = the environment defaults
    precision: str = "auto"
    do_separable: bool = True
    #: boundary extension (core/modes.py): a mode, or one per axis
    mode: object = "periodization"
    #: depth (ndim == 3 only)
    nd: int = 1

    @property
    def shape(self):
        return (self.nd, self.nr, self.nc) if self.ndim == 3 else (self.nr, self.nc)


class Wavelets:
    """Stateful wavelet transform bound to one image geometry.

    >>> W = Wavelets(img, wname="db7", levels=5, device="cuda")
    >>> W.forward(); W.soft_threshold(10.0); img_dn = W.inverse()
    >>> T = Wavelets(img, wname="db7", levels=3, do_swt=True, device="cuda")
    >>> img_dn, n1 = T.run_denoise(10.0)   # the TI-denoise step
    >>> S = Wavelets(sig, wname="sym8", levels=4, ndim=1, device="cuda")
    >>> sig_dn, n1 = S.run_denoise(0.1)    # sig: (batch, n) signals or one (n,)
    >>> V = Wavelets(vol, wname="db4", levels=2, do_swt=True, device="cuda")
    >>> vol_dn, n1 = V.run_denoise(1.0)    # vol: (nd, nr, nc)
    """

    def __init__(self, img=None, nr: Optional[int] = None, nc: Optional[int] = None,
                 wname: str = "haar", levels: int = 1, do_separable: bool = True,
                 do_cycle_spinning: bool = False, do_swt: bool = False,
                 ndim: int = 2, dtype=None, seed: int = 0, backend: Optional[str] = None,
                 mode="periodization", precision: Optional[str] = None, device=None):
        if ndim not in (1, 2, 3):
            raise ValueError(f"ndim={ndim} is not implemented")
        # one mode per transformed axis (pywt), its count checked below
        mode = modes.check_mode(mode) if isinstance(mode, str) else tuple(
            modes.check_mode(m) for m in mode)
        if not all_periodization(mode):
            if do_swt:
                raise ValueError(
                    "the stationary transform is periodic by definition (pywt.swt has no "
                    "mode either); non-periodization boundary modes apply to the decimated "
                    "DWT only")
            if not do_separable:
                raise ValueError("non-separable transforms support mode='periodization' only")
            if do_cycle_spinning:
                warnings.warn(
                    "cycle spinning shifts circularly, which mixes opposite edges — with a "
                    "non-periodization boundary mode the shifted transforms are not "
                    "shift-consistent at the borders")
        if precision is not None:
            check_tier(precision)
        if dtype is None:
            bf16_tier = precision is not None and precision.startswith("bf16-")
            dtype = torch.bfloat16 if bf16_tier else torch.float32
        tier = "auto" if precision is None else tier_for(dtype, precision)

        nd = 1
        if img is not None:
            img = image_tensor(img, device, dtype)
            if img.ndim == 1:
                img = img[None, :]
                ndim = 1
            if img.ndim == 3:
                ndim = 3
            elif ndim == 3:
                raise ValueError(f"ndim=3 takes a 3D volume (nd, nr, nc), got shape "
                                 f"{tuple(img.shape)}")
            if img.ndim not in (2, 3):
                raise ValueError(f"expected a 1D, 2D or 3D array, got shape "
                                 f"{tuple(img.shape)}")
            if (nr, nc) != (None, None) and (nr, nc) != tuple(img.shape[-2:]):
                raise ValueError(f"nr, nc = {nr!r}, {nc!r} contradict the image's shape "
                                 f"{tuple(img.shape)} (pass wname= and levels= by keyword)")
            nr, nc = img.shape[-2:]
            if ndim == 3:
                nd = img.shape[0]
        elif nr is None or nc is None:
            raise ValueError("provide either an image or (nr, nc)")
        else:
            shape = (nd, nr, nc) if ndim == 3 else (nr, nc)
            img = torch.zeros(shape, dtype=dtype, device=default_device(device))

        if levels < 1:
            warnings.warn("cannot initialize wavelet coefficients with nlevels < 1; "
                          "forcing nlevels = 1")
            levels = 1
        if nr == 1 and ndim == 2:  # one signal
            ndim = 1
        if not do_separable and ndim in (1, 3):
            warnings.warn(f"{ndim}D DWT is incompatible with non-separable transform; "
                          "ignoring do_separable")
            do_separable = True
        if do_cycle_spinning and do_swt:
            warnings.warn("makes little sense to use cycle spinning with stationary "
                          "wavelet transform")
        if do_cycle_spinning and ndim == 1:
            raise ValueError("cycle spinning is not implemented for 1D; use SWT instead")
        self._wavelet: Wavelet = get_wavelet(wname)
        hlen = self._wavelet.hlen
        self._quads_fwd = self._quads_inv = None
        if not do_separable:
            w = self._wavelet
            self._quads_fwd = quad_filters(w.dec_lo, w.dec_hi)
            self._quads_inv = quad_filters(w.rec_lo, w.rec_hi)
        wmax = max_level({1: nc, 2: min(nr, nc), 3: min(nd, nr, nc)}[ndim], hlen)
        if levels > wmax:
            dims = {1: f"length-{nc} signal", 2: f"{nr}x{nc} image",
                    3: f"{nd}x{nr}x{nc} volume"}[ndim]
            warnings.warn(
                f"required level ({levels}) is greater than the maximum possible "
                f"level for {wname} ({wmax}) on a {dims}; forcing "
                f"nlevels = {max(wmax, 1)}")
            levels = max(wmax, 1)

        if not isinstance(mode, str):
            mode = modes.per_axis(mode, ndim)  # one per axis of this geometry
        self.spec = WaveletSpec(wname=wname, nr=nr, nc=nc, nlevels=levels,
                                do_cycle_spinning=do_cycle_spinning, dtype=dtype,
                                hlen=hlen, do_swt=do_swt, ndim=ndim, precision=tier,
                                do_separable=do_separable, mode=mode, nd=nd)
        self.device = img.device
        self.d_image = img
        self.state = WState.INIT
        self.current_shift_r = 0
        self.current_shift_c = 0
        self.current_shift_d = 0  # the depth shift of a volume
        self._rng = np.random.default_rng(seed)
        self._backend = backend
        self._coeffs = self._zero_coeffs()

    def _zero_coeffs(self):
        """Zero coefficients of the spec's geometry.  The bf16 contract
        carries the approximation in float32; a boundary mode's does not
        (JAX's mode route keeps every band in the input's dtype) and sizes
        the bands by pywt's rule, which depends on the filter length."""
        s = self.spec
        z = lambda shape: torch.zeros(shape, dtype=s.dtype, device=self.device)
        bf16_chain = s.dtype == torch.bfloat16 and all_periodization(s.mode)
        za = lambda shape: z(shape).float() if bf16_chain else z(shape)
        if s.ndim == 1:
            a_len, det_lens = coeff_shapes_1d(s.nc, s.nlevels, s.do_swt, s.mode, s.hlen)
            return Coeffs1D(za((s.nr, a_len)), tuple(z((s.nr, n)) for n in det_lens))
        if s.ndim == 3:
            a_shape, det_shapes = coeff_shapes_3d(s.nd, s.nr, s.nc, s.nlevels, s.do_swt, s.mode,
                                                  s.hlen)
            return Coeffs3D(za(a_shape), tuple(tuple(z(d) for _ in range(7))
                                               for d in det_shapes))
        a_shape, det_shapes = coeff_shapes_2d(s.nr, s.nc, s.nlevels, s.do_swt, s.mode, s.hlen)
        return Coeffs2D(za(a_shape), tuple((z(d), z(d), z(d)) for d in det_shapes))

    @property
    def wname(self) -> str:
        return self.spec.wname

    @property
    def coeffs(self):
        """The coefficient tree: a :class:`Coeffs1D`, :class:`Coeffs2D` or
        :class:`Coeffs3D`."""
        return self._coeffs

    @coeffs.setter
    def coeffs(self, value):
        self._coeffs = value
        self.state = WState.FORWARD

    def copy(self) -> "Wavelets":
        """A deep copy: its own image, coefficients and shift generator."""
        w = object.__new__(Wavelets)
        w.__dict__.update(self.__dict__)
        w.d_image = self.d_image.clone()
        w._coeffs = type(self._coeffs)(self._coeffs.approx.clone(), tuple(
            d.clone() if isinstance(d, torch.Tensor) else tuple(t.clone() for t in d)
            for d in self._coeffs.details))
        w._rng = copy.deepcopy(self._rng)
        return w

    def __copy__(self) -> "Wavelets":
        return self.copy()

    def _check_not_inverse(self, action: str) -> bool:
        if self.state == WState.INVERSE:
            warnings.warn(f"cannot {action}, as the coefficients were modified "
                          "by inverse()")
            return False
        return True

    def _draw_shifts(self):
        """(depth, row, column) shifts: the row, the column, then (3D) the
        depth shift, drawn in that order from
        ``numpy.random.default_rng(seed)``; the depth shift is 0 in 2D."""
        s = self.spec
        sr, sc = int(self._rng.integers(0, s.nr)), int(self._rng.integers(0, s.nc))
        sd = int(self._rng.integers(0, s.nd)) if s.ndim == 3 else 0
        return sd, sr, sc

    def _shift(self, img: torch.Tensor, sd: int, sr: int, sc: int) -> torch.Tensor:
        if self.spec.ndim == 3:
            return ops.circshift3d(img, sd, sr, sc)
        return ops.circshift2d(img, sr, sc)

    def _tier(self):
        """The facade's tier, active for the transforms run inside."""
        tier = self.spec.precision
        return precision_scope(None if tier == "auto" else tier)

    def _analysis(self, img: torch.Tensor):
        s = self.spec
        if not s.do_separable:
            with self._tier():
                return (swt2d_ns if s.do_swt else dwt2d_ns)(img, self._quads_fwd, s.nlevels)
        fwd_kw = {"backend": self._backend} if s.do_swt else {"backend": self._backend,
                                                              "mode": s.mode}
        if s.ndim == 1:
            fwd = swt1d if s.do_swt else dwt1d
        elif s.ndim == 3:
            fwd = swt3d if s.do_swt else dwt3d
        else:
            fwd = swt2d if s.do_swt else dwt2d
        with self._tier():
            return fwd(img, self._wavelet, s.nlevels, **fwd_kw)

    def _synthesis(self, coeffs) -> torch.Tensor:
        s = self.spec
        with self._tier():
            if not s.do_separable:
                if s.do_swt:
                    return iswt2d_ns(coeffs, self._quads_inv)
                return idwt2d_ns(coeffs, self._quads_inv, (s.nr, s.nc))
            be = self._backend
            if s.do_swt:
                return {1: iswt1d, 2: iswt2d, 3: iswt3d}[s.ndim](coeffs, self._wavelet,
                                                                 backend=be)
            if s.ndim == 1:
                return idwt1d(coeffs, self._wavelet, s.nc, backend=be, mode=s.mode)
            return (idwt3d if s.ndim == 3 else idwt2d)(coeffs, self._wavelet, s.shape,
                                                        backend=be, mode=s.mode)

    @spanned("facade")
    def forward(self):
        """Compute the coefficients of the current image.  With cycle
        spinning, the row, the column and (3D) the depth shift are drawn
        first from ``numpy.random.default_rng(seed)``."""
        s = self.spec
        img = self.d_image
        if s.do_cycle_spinning:
            sd, self.current_shift_r, self.current_shift_c = self._draw_shifts()
            if s.ndim == 3:
                self.current_shift_d = sd
            img = self._shift(img, self.current_shift_d, self.current_shift_r,
                              self.current_shift_c)
        self._coeffs = self._analysis(img)
        self.state = WState.FORWARD
        return self._coeffs

    @spanned("facade")
    def run_denoise(self, beta, mode: str = "soft", do_thresh_appcoeffs: bool = False,
                    normalize: bool = False):
        """The whole denoise step: (cycle-spinning shift) -> analysis ->
        threshold -> norm1 -> synthesis -> unshift.  With ``do_swt`` in 2D
        and 3D, the threshold runs inside the synthesis kernels and the norm comes
        from the un-thresholded coefficients (``ops.thresholded_norm1``).
        The 1D DWT takes kernel 7's norm launches where they serve
        (``core/separable.py: _dwt1d_denoise_norm1``: float32 on the card,
        the exact tier, periodization, a scalar ``beta``, no gradient): the
        analysis stores the details thresholded and sums their L1 norm, and
        the approximation's is added apart (``ops.norms.add_approx_norm1``);
        everywhere else 1D runs the threshold, ``norm1`` and the synthesis in
        turn, as the JAX facade does.  Returns ``(denoised,
        norm1)`` as tensors on the facade's device and leaves the facade's
        image and coefficients as they were; a shift is drawn as in
        :meth:`forward`.  ``mode`` is soft, hard, group or garrote; group
        is never fused.  While the span recorder is on, the call counts in
        ``utils.profiling.DENOISE_PATHS`` by where the threshold ran."""
        from .models.denoiser import _THRESH, check_mode

        check_mode(mode)
        s = self.spec
        if not s.do_separable:
            raise ValueError("run_denoise supports separable specs only")
        img = self.d_image
        sd = sr = sc = 0
        if s.do_cycle_spinning:
            sd, sr, sc = self._draw_shifts()
            img = self._shift(img, sd, sr, sc)
        fused = None
        if s.ndim == 1 and not s.do_swt and all_periodization(s.mode):
            with self._tier():
                fused = _dwt1d_denoise_norm1(img, self._wavelet, s.nlevels, beta, mode,
                                             normalize, self._backend)
        if fused is not None:
            c, n1 = fused
            a, n1 = ops.norms.add_approx_norm1(n1, c.approx, beta, levels=c.levels, mode=mode,
                                               normalize=normalize,
                                               do_thresh_appcoeffs=do_thresh_appcoeffs)
            out = self._synthesis(Coeffs1D(a, c.details))
            in_kernel = True
        elif s.do_swt and s.ndim != 1 and mode in ops.THR_ELEM:
            c = self._analysis(img)
            n1 = ops.thresholded_norm1(c, beta, mode=mode, normalize=normalize,
                                       do_thresh_appcoeffs=do_thresh_appcoeffs)
            inv = iswt3d_denoise if s.ndim == 3 else iswt2d_denoise
            with self._tier():
                out = inv(c, self._wavelet, beta, mode=mode, normalize=normalize,
                          do_thresh_appcoeffs=do_thresh_appcoeffs, backend=self._backend)
            in_kernel = thresholds_in_kernel(beta, self._backend)
        else:
            c = _THRESH[mode](self._analysis(img), beta, normalize=normalize,
                              do_thresh_appcoeffs=do_thresh_appcoeffs)
            n1 = ops.norm1(c)
            out = self._synthesis(c)
            in_kernel = False
        if recording():
            DENOISE_PATHS["fused" if in_kernel else "plain"] += 1
        if s.do_cycle_spinning:
            out = self._shift(out, -sd, -sr, -sc)
        return out, n1

    @spanned("facade")
    def inverse(self) -> torch.Tensor:
        """Reconstruct the image from the coefficients."""
        if self.state == WState.INVERSE:
            warnings.warn("inverse() has already been run; result available "
                          "via get_image()")
            return self.d_image
        s = self.spec
        img = self._synthesis(self._coeffs)
        if s.do_cycle_spinning:
            img = self._shift(img, -self.current_shift_d, -self.current_shift_r,
                              -self.current_shift_c)
        self.d_image = img
        self.state = WState.INVERSE
        return img

    def _threshold(self, fn, beta, do_thresh_appcoeffs: bool, normalize: bool) -> None:
        if not self._check_not_inverse("threshold coefficients"):
            return
        self._coeffs = fn(self._coeffs, beta, do_thresh_appcoeffs=do_thresh_appcoeffs,
                          normalize=normalize)
        self.state = WState.THRESHOLD

    def soft_threshold(self, beta, do_thresh_appcoeffs: bool = False,
                       normalize: bool = False) -> None:
        self._threshold(ops.soft_threshold, beta, do_thresh_appcoeffs, normalize)

    def hard_threshold(self, beta, do_thresh_appcoeffs: bool = False,
                       normalize: bool = False) -> None:
        self._threshold(ops.hard_threshold, beta, do_thresh_appcoeffs, normalize)

    def garrote_threshold(self, beta, do_thresh_appcoeffs: bool = False,
                          normalize: bool = False) -> None:
        self._threshold(ops.garrote_threshold, beta, do_thresh_appcoeffs, normalize)

    def group_soft_threshold(self, beta, do_thresh_appcoeffs: bool = False,
                             normalize: bool = False) -> None:
        """Group-lasso soft threshold over each level's bands (``ops``)."""
        self._threshold(ops.group_soft_threshold, beta, do_thresh_appcoeffs, normalize)

    def firm_threshold(self, beta, beta2, do_thresh_appcoeffs: bool = False,
                       normalize: bool = False) -> None:
        """Firm (semisoft) threshold with knees ``beta`` < ``beta2``."""
        if not self._check_not_inverse("threshold coefficients"):
            return
        self._coeffs = ops.firm_threshold(self._coeffs, beta, beta2,
                                          do_thresh_appcoeffs=do_thresh_appcoeffs,
                                          normalize=normalize)
        self.state = WState.THRESHOLD

    def shrink(self, beta, do_thresh_appcoeffs: bool = True) -> None:
        """L2 proximal operator: scale by 1 / (1 + beta)."""
        if not self._check_not_inverse("shrink coefficients"):
            return
        self._coeffs = ops.shrink(self._coeffs, beta, do_thresh_appcoeffs=do_thresh_appcoeffs)
        self.state = WState.THRESHOLD

    def proj_linf(self, beta, do_thresh_appcoeffs: bool = True) -> None:
        """Projection onto the L-infinity ball of radius ``beta``."""
        if not self._check_not_inverse("project coefficients"):
            return
        self._coeffs = ops.proj_linf(self._coeffs, beta, do_thresh_appcoeffs=do_thresh_appcoeffs)
        self.state = WState.THRESHOLD

    def noise_sigma(self) -> float:
        """Robust MAD noise estimate from the finest diagonal band."""
        return float(ops.noise_sigma(self._coeffs))

    def universal_threshold(self) -> float:
        """VisuShrink sigma sqrt(2 ln N) of the current coefficients."""
        return float(ops.universal_threshold(self._coeffs))

    def bayes_shrink(self, do_thresh_appcoeffs: bool = False) -> None:
        """Soft threshold at the BayesShrink thresholds of each band, which
        stay on the device."""
        if not self._check_not_inverse("threshold coefficients"):
            return
        self._coeffs = ops.soft_threshold(self._coeffs, ops.bayes_thresholds(self._coeffs),
                                          do_thresh_appcoeffs=do_thresh_appcoeffs)
        self.state = WState.THRESHOLD

    def set_filters_forward(self, filtername: str, filter1, filter2, filter3=None,
                            filter4=None) -> int:
        """Custom analysis filters: (lo, hi) for the separable transform,
        which keeps the synthesis filters when they have the same length
        (else zeros until ``set_filters_inverse``); the four quads (LL, LH,
        HL, HH) for the non-separable one.  Renames the spec to
        ``filtername``."""
        s = self.spec
        if s.do_separable:
            n = len(np.atleast_1d(np.asarray(filter1)))
            w = self._wavelet
            same = w.hlen == n
            self._wavelet = make_custom_wavelet(filtername, filter1, filter2,
                                                w.rec_lo if same else np.zeros(n),
                                                w.rec_hi if same else np.zeros(n))
        else:
            if filter3 is None or filter4 is None:
                raise ValueError("set_filters_forward(): expected 4 filters for "
                                 "non-separable filtering")
            self._quads_fwd = np.stack([np.asarray(f, np.float64)
                                        for f in (filter1, filter2, filter3, filter4)])
            n = self._quads_fwd.shape[-1]
        self.spec = dataclasses.replace(s, wname=filtername, hlen=n)
        if n != s.hlen and not all_periodization(s.mode):
            # a boundary mode's coefficient sizes follow the filter length
            self._coeffs = self._zero_coeffs()
            self.state = WState.INIT
        return 0

    def set_filters_inverse(self, filter1, filter2, filter3=None, filter4=None) -> int:
        """Custom synthesis filters: (lo, hi), or the four inverse quads."""
        if self.spec.do_separable:
            w = self._wavelet
            self._wavelet = make_custom_wavelet(self.spec.wname, w.dec_lo, w.dec_hi, filter1,
                                                filter2)
        else:
            if filter3 is None or filter4 is None:
                raise ValueError("set_filters_inverse(): expected 4 filters for "
                                 "non-separable filtering")
            self._quads_inv = np.stack([np.asarray(f, np.float64)
                                        for f in (filter1, filter2, filter3, filter4)])
        return 0

    def norm1(self) -> float:
        return float(ops.norm1(self._coeffs))

    def norm2sq(self) -> float:
        return float(ops.norm2sq(self._coeffs))

    def norm_l21(self, do_thresh_appcoeffs: bool = False) -> float:
        """Group-lasso (L2,1) norm over ``group_soft_threshold``'s groups."""
        return float(ops.norm_l21(self._coeffs, do_thresh_appcoeffs=do_thresh_appcoeffs))

    def circshift(self, sr: int, sc: int, inplace: bool = True, sd: int = 0):
        """Circular shift of the image (the row shift is ignored in 1D; ``sd``
        shifts the depth of a volume).  ``inplace=False`` returns the
        shifted image and leaves the facade as it was."""
        if self.spec.ndim == 1:
            shifted = ops.circshift1d(self.d_image, sc)
        else:
            shifted = self._shift(self.d_image, sd, sr, sc)
        if inplace:
            self.d_image = shifted
            return None
        return shifted

    def add_wavelet(self, other: "Wavelets", alpha=1.0) -> int:
        """Coefficient axpy, self += alpha * other: 0 when done, 1 (with a
        warning) when either operand was just inverted; ValueError when the
        two are not the same transform."""
        s, o = self.spec, other.spec
        if s.nlevels != o.nlevels or s.wname.lower() != o.wname.lower():
            raise ValueError("add_wavelet(): right operand is not the same transform "
                             "(wname, level)")
        if self.state == WState.INVERSE or other.state == WState.INVERSE:
            warnings.warn("add_wavelet(): this operation makes no sense when wavelet "
                          "has just been inverted")
            return 1
        if (s.nd, s.nr, s.nc, s.ndim) != (o.nd, o.nr, o.nc, o.ndim):
            raise ValueError("add_wavelet(): operands do not have the same geometry")
        if s.do_swt != o.do_swt:
            raise ValueError("add_wavelet(): operands should both use SWT or DWT")
        if (s.do_cycle_spinning and o.do_cycle_spinning
                and (self.current_shift_r, self.current_shift_c)
                != (other.current_shift_r, other.current_shift_c)):
            raise ValueError("add_wavelet(): operands do not have the same current shift")
        self._coeffs = ops.add_coeffs(self._coeffs, other._coeffs, alpha)
        return 0

    def get_image(self, copy: bool = True):
        """A host numpy copy of the image (``copy=True``), or the tensor
        itself on its device."""
        if copy:
            return tensor_to_numpy(self.d_image)
        return self.d_image

    def set_image(self, img) -> None:
        """Replace the image.  A tensor must lie on the facade's device."""
        s = self.spec
        if isinstance(img, torch.Tensor):
            if not same_device(img, self.device):
                raise ValueError(f"img lies on {img.device}, the facade on "
                                 f"{self.device}; move it first")
            img = img.to(dtype=s.dtype)
        else:
            img = tensor_from_numpy(img, self.device, s.dtype)
        self.d_image = img.reshape(s.shape)
        self.state = WState.INIT

    def _coeff_ref(self, num: int):
        """The reference's flat numbering: 0 the approximation, then H, V, D
        of level 1 (1, 2, 3), of level 2 (4, 5, 6), ... in 2D; the 7 bands
        daa..ddd of level 1 (1..7), of level 2 (8..14), ... in 3D; D of
        level 1, 2, ... (1, 2, ...) in 1D.  Returns (level, band or None),
        level None for the approximation."""
        s = self.spec
        if num == 0:
            return None, None
        if s.ndim in (2, 3):
            level, band = divmod(num - 1, 7 if s.ndim == 3 else 3)
            if level >= s.nlevels:
                raise IndexError(f"coefficient {num} out of range")
            return level, band
        if num > s.nlevels:
            raise IndexError(f"coefficient {num} out of range")
        return num - 1, None

    def get_coeff(self, num: int, copy: bool = True):
        """One band by the flat numbering: a host numpy copy, or with
        ``copy=False`` the tensor itself on its device.  None, with a
        warning, after inverse()."""
        if self.state == WState.INVERSE:
            warnings.warn("get_coeff(): inverse() has been performed, the coefficients "
                          "do not make sense anymore")
            return None
        level, band = self._coeff_ref(num)
        c = self._coeffs
        out = c.approx if level is None else (c.details[level] if band is None
                                              else c.details[level][band])
        return tensor_to_numpy(out) if copy else out

    def set_coeff(self, coeff, num: int) -> None:
        """Replace one band by the flat numbering, cast to that band's dtype
        (the bf16 tiers carry a float32 approximation) and shape.  A tensor
        must lie on the facade's device."""
        level, band = self._coeff_ref(num)
        c = self._coeffs
        old = c.approx if level is None else (c.details[level] if band is None
                                              else c.details[level][band])
        if isinstance(coeff, torch.Tensor):
            if not same_device(coeff, self.device):
                raise ValueError(f"coeff lies on {coeff.device}, the facade on "
                                 f"{self.device}; move it first")
            coeff = coeff.to(dtype=old.dtype)
        else:
            coeff = tensor_from_numpy(coeff, self.device, old.dtype)
        coeff = coeff.reshape(old.shape)
        if level is None:
            self._coeffs = type(c)(coeff, c.details)
            return
        details = list(c.details)
        if band is None:
            details[level] = coeff
        else:
            details[level] = tuple(coeff if j == band else t
                                   for j, t in enumerate(details[level]))
        self._coeffs = type(c)(c.approx, tuple(details))

    def info(self) -> dict:
        """The transform's configuration, its estimated memory footprint (the
        reference's formula) and the device."""
        s = self.spec
        npix = s.nd * s.nr * s.nc  # nd is 1 unless ndim == 3
        if not s.do_swt:
            mem = 5 * npix * s.dtype.itemsize
        elif s.ndim == 3:
            mem = (7 * s.nlevels + 4) * npix * s.dtype.itemsize
        elif s.ndim == 2:
            mem = (3 * s.nlevels + 4) * npix * s.dtype.itemsize
        else:
            mem = (s.nlevels + 4) * npix * s.dtype.itemsize
        dev = self.device
        return {
            "dims": s.shape if s.ndim in (2, 3) else s.nc,
            "batched_1d": s.ndim == 1 and s.nr > 1,
            "wavelet": s.wname,
            "levels": s.nlevels,
            "stationary": s.do_swt,
            "cycle_spinning": s.do_cycle_spinning,
            "separable": s.do_separable,
            "dtype": s.dtype,
            "mode": s.mode,
            "precision": s.precision,
            "estimated_memory_mb": mem / 1e6,
            "device": (f"cuda:{torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
                       else dev.type),
            "state": self.state.value,
        }

    def print_informations(self) -> None:
        i = self.info()
        print("------------- Wavelet transform infos ------------")
        if self.spec.ndim in (2, 3):
            print(f"Data dimensions : {i['dims']}")
        elif i["batched_1d"]:
            print(f"Data dimensions : ({self.spec.nr}, {self.spec.nc}) "
                  "[batched 1D transform]")
        else:
            print(f"Data dimensions : {self.spec.nc}")
        yn = {False: "no", True: "yes"}
        print(f"Wavelet name : {i['wavelet']}")
        print(f"Number of levels : {i['levels']}")
        print(f"Stationary WT : {yn[i['stationary']]}")
        print(f"Cycle spinning : {yn[i['cycle_spinning']]}")
        print(f"Separable transform : {yn[i['separable']]}")
        print(f"Boundary mode : {i['mode']}")
        print(f"Precision tier : {i['precision']}")
        print(f"Estimated memory footprint : {i['estimated_memory_mb']:.2f} MB")
        print(f"Running on device : {i['device']}")
        print("--------------------------------------------------")

    def __repr__(self):
        s = self.spec
        return (f"Wavelets({s.wname!r}, shape={s.shape}, ndim={s.ndim}, "
                f"levels={s.nlevels}, "
                f"swt={s.do_swt}, separable={s.do_separable}, "
                f"cycle_spinning={s.do_cycle_spinning}, dtype={s.dtype}, "
                f"mode={s.mode}, precision={s.precision}, "
                f"device={self.device}, state={self.state.value})")
