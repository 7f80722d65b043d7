"""Launch plumbing shared by the kernel wrappers: the launch counters,
the CPU/CUDA dispatch check, tap and offset conversion and the ctypes
call."""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core import conv

#: Longest filter the CUDA kernels take (PDWT_MAX_HLEN in csrc/*.cu).
MAX_HLEN = 128

#: Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {"fwd_level_2d": 0, "inv_level_2d": 0,
                            "fwd_tail_2d": 0, "inv_tail_2d": 0,
                            "swt_fwd_level_2d": 0, "swt_inv_level_2d": 0,
                            "swt_norm_sum_2d": 0,
                            "fwd_level_1d": 0, "fwd_level_1d_norm": 0, "inv_level_1d": 0,
                            "swt_fwd_level_1d": 0, "swt_inv_level_1d": 0,
                            "fwd_level_2d_mxu": 0, "inv_level_2d_mxu": 0,
                            "fwd_level_1d_mxu": 0, "inv_level_1d_mxu": 0,
                            "swt_fwd_level_1d_mxu": 0, "swt_inv_level_1d_mxu": 0,
                            "swt_fwd_level_2d_mxu": 0, "swt_inv_level_2d_mxu": 0,
                            "ns_fwd_level_2d_mxu": 0, "ns_inv_level_2d_mxu": 0,
                            "ns_swt_fwd_level_2d_mxu": 0, "ns_swt_inv_level_2d_mxu": 0,
                            "fwd_level_2d_padded": 0, "inv_level_2d_padded": 0,
                            "fwd_level_1d_padded": 0, "inv_level_1d_padded": 0,
                            "swt_fwd_level_2d_padded": 0, "swt_inv_level_2d_padded": 0,
                            "swt_fwd_level_1d_padded": 0, "swt_inv_level_1d_padded": 0,
                            "fwd_level_2d_mxu_padded": 0, "inv_level_2d_mxu_padded": 0,
                            "swt_fwd_level_2d_mxu_padded": 0, "swt_inv_level_2d_mxu_padded": 0,
                            "fwd_level_1d_mxu_padded": 0, "inv_level_1d_mxu_padded": 0,
                            "swt_fwd_level_1d_mxu_padded": 0, "swt_inv_level_1d_mxu_padded": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cpu(*ts: torch.Tensor, ndim: int = 3, dtypes=(torch.float32,)) -> bool:
    """True for CPU tensors (the wrapper runs its plain version); False for
    tensors a CUDA kernel takes, of rank ``ndim`` ((B, R, C) images or
    (B, N) signals) and of one of ``dtypes``; raises on anything else."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if t.dtype not in dtypes:
            raise NotImplementedError(
                f"this CUDA kernel takes {', '.join(map(str, dtypes))}, got {t.dtype}; "
                "bfloat16 tensors run the banded-product kernels of the precision tiers")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if t.dim() != ndim or t.numel() == 0:
            want = "(B, R, C)" if ndim == 3 else "(B, N)"
            raise ValueError(f"expected a non-empty {want} tensor, got {tuple(t.shape)}")
    return False


def taps(f) -> np.ndarray:
    """Correlation-order float32 taps (kept alive by the caller)."""
    f = np.asarray(f, dtype=np.float64)
    if not 2 <= len(f) <= MAX_HLEN:
        raise ValueError(f"the CUDA kernels take filters of 2..{MAX_HLEN} taps, got {len(f)}")
    return np.ascontiguousarray(f[::-1], dtype=np.float32)


def scheme_taps(f, scheme: str) -> Tuple[np.ndarray, np.ndarray]:
    """The (first, second) taps of a compute scheme (kernels/matmul.py) in
    forward convention, float64 arrays that hold float32 values: (f32(f),
    0) for fd, else the bf16 split (f_h, f_l) of f32(f)."""
    f32 = torch.tensor(np.asarray(f, dtype=np.float64)).float()
    if scheme == "fd":
        return f32.double().numpy(), np.zeros(len(f32))
    hi = f32.to(torch.bfloat16).float()
    lo = (f32 - hi).to(torch.bfloat16).float()
    return hi.double().numpy(), lo.double().numpy()


def kernel_taps(filters: Sequence, scheme: str):
    """Correlation-order float32 (first, second) taps of each filter for
    the kernels, kept alive by the caller."""
    out = []
    for f in filters:
        t1, t2 = scheme_taps(f, scheme)
        out.extend((taps(t1), taps(t2)))
    return out


@functools.lru_cache(maxsize=64)
def _dual_taps_on(lo: bytes, hi: bytes, scheme: str, device: str) -> torch.Tensor:
    filters = [np.frombuffer(f, dtype=np.float64) for f in (lo, hi)]
    return torch.from_numpy(np.stack(kernel_taps(filters, scheme))).to(device)


def dual_taps(filters, scheme: str, device) -> torch.Tensor:
    """A filter pair's taps as the kernels on ``band_strip.cuh`` read them:
    (4, hlen) float32 on ``device``, the low filter's first and second
    values, then the high filter's, correlation order.  Copied there once
    per filter pair and scheme; the key is the taps themselves, since the
    backwards pass reversed and rescaled ones."""
    lo, hi = (np.asarray(f, dtype=np.float64) for f in filters)
    return _dual_taps_on(lo.tobytes(), hi.tobytes(), scheme, str(device))


def ptr(a) -> ctypes.c_void_p:
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    return a.ctypes.data_as(ctypes.c_void_p)


def launch(key: str, device: torch.device, args, entry: str = "") -> None:
    """Call ``pdwt_<entry>`` of the kernel library (``pdwt_<key>`` where no
    entry is given) on the current stream of ``device``; raise if the
    launch was refused, else count it in ``LAUNCHES[key]``.  An exact
    kernel's wrapper counts under its own key the launch of its tier
    twin's entry point in ``fd``."""
    from . import _build

    for a in args:
        if isinstance(a, int) and not -2 ** 31 <= a < 2 ** 31:
            raise ValueError(f"{key}: {a} does not fit the kernels' 32-bit int arguments")
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, "pdwt_" + (entry or key))(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.pdwt_error_string(err).decode()
        raise RuntimeError(f"{key} kernel launch failed: {msg} (cudaError {err})")
    LAUNCHES[key] += 1


#: thresh_mode / norm_mode codes of the fused threshold and norm arguments
#: (mxu_common.cuh: kNone, kSoft, kHard, kGarrote)
THRESH_CODES = {None: 0, "soft": 1, "hard": 2, "garrote": 3}


def beta_buffer(beta, device: torch.device) -> torch.Tensor:
    """beta as one float32 on ``device``, with no host synchronisation."""
    if isinstance(beta, torch.Tensor):
        if beta.numel() != 1:
            raise ValueError(f"the fused threshold takes one beta, got shape {tuple(beta.shape)}")
        return beta.detach().to(device=device, dtype=torch.float32).reshape(1).contiguous()
    return torch.full((1,), float(beta), dtype=torch.float32, device=device)


def _c(ts):
    """Each tensor of ``ts`` made contiguous (the cotangents a backward
    hands a kernel)."""
    return [t.contiguous() for t in ts]


def rev(f) -> np.ndarray:
    """Reversed float64 filter: the adjoint pairing's taps."""
    return np.asarray(f, dtype=np.float64)[::-1].copy()


def poly_geo(hlen: int) -> np.ndarray:
    """``conv.poly_geometry(hlen)`` as the int32 array the synthesis kernels
    read: p[0], p[1], o[0], o[1], nb[0], nb[1], lo, hi."""
    g = conv.poly_geometry(hlen)
    return np.array([*g.p, *g.o, *g.nb, g.lo, g.hi], dtype=np.int32)


class PadAxis(NamedTuple):
    """One axis of a padded synthesis launch (``band_strip.cuh: PadAxis``):
    stored output i < ``n_out`` is the periodic body's output i + ``off``,
    which sums the coefficients ``base + m + o_q + b`` (``poly_geometry``)."""
    base: int
    off: int
    n_out: int


def pad_axis(hlen: int, c0: int, n_out: int) -> PadAxis:
    """The padded synthesis of ``conv.padded_synthesis_pass`` at offset
    ``c0`` on the periodic body, whose shift is ``s = inv_shift(hlen)``:
    its output t sums ``U[t - s + j + 2 base]``, so ``base`` whole
    coefficients and ``off`` (0 or 1) outputs make ``c0 = off - s + 2
    base``."""
    t = c0 + conv.inv_shift(hlen)
    return PadAxis(t // 2, t % 2, n_out)


def pad_positions(p: PadAxis) -> int:
    """``band_strip.cuh: pad_positions``: the coefficient positions the
    grid covers, two outputs each, up to output ``off + n_out - 1``."""
    return (p.off + p.n_out + 1) // 2


def dilation(level: int) -> int:
    """The a-trous dilation 2^(level-1) of a stationary level."""
    if level < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    return 1 << (level - 1)


def swt_fwd_halo(hlen: int, level: int) -> Tuple[int, int]:
    """(lo, hi): the samples the padded a-trous analysis of a level (kernels
    5 and 9's padded entry points) needs below and above a shard along each
    filtered axis, the bare periodic support: ``fwd_center(hlen) f`` and the
    rest of the span ``(hlen - 1) f``.  JAX's ``swt_fwd_geometry`` adds
    Mosaic alignment margins on top (tile tuning, left out)."""
    f = dilation(level)
    lo = conv.fwd_center(hlen) * f
    return lo, (hlen - 1) * f - lo


def swt_inv_halo(hlen: int, level: int) -> Tuple[int, int]:
    """(lo, hi) of the padded a-trous synthesis (kernels 6 and 10's padded
    entry points) along each filtered axis: ``swt_inv_center(hlen) f`` and
    the rest of the span."""
    f = dilation(level)
    lo = conv.swt_inv_center(hlen) * f
    return lo, (hlen - 1) * f - lo


def check_span(hlen: int, f: int) -> None:
    if hlen * f >= 2 ** 31:
        raise ValueError(f"a dilated support of {hlen} x {f} taps overflows the kernels' "
                         "32-bit indices")


# ---------------------------------------------------------------------------
# launch plans of the kernels on csrc/band_strip.cuh
# ---------------------------------------------------------------------------

#: shared memory a block may use on an H100 (mxu_common.cuh: kSmemLimit)
SMEM_LIMIT = 232448
#: the most a block may take and still share its SM with a second block
SMEM_TWO_BLOCKS = 113 * 1024
#: SMs of an H100 SXM; the inverses aim at two blocks for each
SMS = 132
#: tile candidates (rows, columns), largest first
PLAN_TILES = ((32, 64), (32, 32), (16, 32), (16, 16), (8, 16), (8, 8))
#: strip lengths of the two passes (band_strip.cuh: kRowStrip, kColStrip)
ROW_STRIP = {"b1": 8, "fd": 8, "b2f": 4, "b2d": 4, "b3": 4}
COL_STRIP = 8


class InvPlan(NamedTuple):
    """Geometry of one launch of a kernel on ``band_strip.cuh`` (the
    banded-product inverses, the exact inverses, kernel 17): tile (lr, lc)
    of positions (kernel 16: lr signals), column stride gc (1: consecutive
    columns; f: one residue class), band phases nph (kernel 14), taps
    padded to nt, threads per block, grid (x, y, z) and dynamic
    shared-memory bytes."""
    lr: int
    lc: int
    gc: int
    nph: int
    nt: int
    threads: int
    grid: Tuple[int, int, int]
    smem: int


def stage_bytes(scheme: str) -> Tuple[int, int]:
    """(operands, bytes per operand) a scheme stages per sample."""
    return (2 if scheme in ("b2d", "b3") else 1), (4 if scheme == "fd" else 2)


def temp_pitch(w: int, es: int) -> int:
    """band_strip.cuh: temp_pitch, an odd number of 32-bit words >= w."""
    return w | 1 if es == 4 else ((w + 1) // 4) * 4 + 2


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def align16(b: int) -> int:
    return (b + 15) // 16 * 16


def axis_blocks(n: int, f: int, lt: int) -> int:
    """mxu_common.cuh: axis_blocks, one residue class mod f per block."""
    fr = min(f, n)
    return fr * cdiv(cdiv(n, f), lt)


def plan_threads(items: int) -> int:
    """Threads for a block whose busiest pass has ``items`` work items:
    256, or the warps that take them all in one round where fewer do."""
    return min(256, max(32, cdiv(items, 32) * 32))


def pick_plan(cands, target: int) -> InvPlan:
    """The first candidate plan (largest tile first) that fits two blocks
    on an SM and has ``target`` blocks; else the one of those with the most
    blocks; else the first that fits in shared memory."""
    fits = [p for p in cands if p.smem <= SMEM_TWO_BLOCKS]
    for p in fits:
        if p.grid[0] * p.grid[1] * p.grid[2] >= target:
            return p
    if fits:
        return max(fits, key=lambda p: p.grid[0] * p.grid[1] * p.grid[2])
    for p in cands:
        if p.smem <= SMEM_LIMIT:
            return p
    raise ValueError("no launch plan of the banded-product inverse fits in shared memory")


def block_target(b: int, ro: int, co: int) -> int:
    """Blocks an inverse aims at: about two per SM (256) where the output
    has at least 2 * 132 tiles of 16 x 16, else one per two such tiles
    (smaller tiles cost more halo than the idle SMs they fill, as measured
    on an H100: PERF.md, section 6)."""
    n16 = b * cdiv(ro, 16) * cdiv(co, 16)
    return 256 if n16 >= 2 * SMS else max(1, n16 // 2)


def consecutive_columns(f: int, lc: int, span: int) -> bool:
    """Does a tile of lc columns at dilation f take consecutive columns
    (coalesced loads and stores, a window of lc + span f columns) rather
    than one residue class mod f (a window of lc + span)?  While the
    consecutive window is at most 1.4x the other and a column strip of
    COL_STRIP outputs f apart fits the tile."""
    return f * COL_STRIP <= lc and 5 * (lc + span * f) <= 7 * (lc + span)


#: taps per chunk of the 2D analysis's strips (swt_matmul.cu: kFwdCh)
FWD_CHUNK = 8
#: the 2D analysis's tiles: a wider one first (its halo is the smallest)
FWD_TILES = ((32, 128),) + PLAN_TILES


def fwd_smem(scheme: str, lr: int, lc: int, dc: int, nt: int, nph: int, os_: int = 1) -> int:
    """swt_matmul.cu: fwd_smem at output step ``os_`` -- taps, index
    tables, the window (the 4 / nph output tiles after the row pass), two
    temps."""
    nd, es = stage_bytes(scheme)
    wr, wc = os_ * (lr - 1) + nt, os_ * (lc - 1) + (nt - 1) * dc + 1
    tile = 4 * (4 // nph) * lr * (lc + 1)
    return (16 * nt + align16(4 * (wr + wc)) + align16(max(nd * wr * wc * es, tile))
            + 2 * nd * lr * temp_pitch(wc, es) * es)


def fwd_plan(B: int, R: int, C: int, hlen: int, f: int, scheme: str, os_: int) -> InvPlan:
    """The launch of swt_matmul.cu's 2D analysis body (kernels 13 and 5 at
    output step 1, kernels 11 and 1 at step 2) on a (B, R, C) input at
    output step ``os_`` (outputs R / os_ x C / os_): candidates, largest
    tile first, lr output rows of one residue class mod f by lc output
    columns, consecutive or one residue class (``consecutive_columns``;
    always consecutive at f = 1); all four output tiles at once (nph = 1) or two
    at a time; taps padded to nt.  The first that fits two blocks on an SM
    and gives ``block_target`` blocks for the input's size (the four
    subbands' outputs together), so the deep levels and small images take
    smaller tiles.  Always 256 threads, as the other analyses on
    ``band_strip.cuh``."""
    nt = cdiv(hlen, FWD_CHUNK) * FWD_CHUNK
    pr = ROW_STRIP[scheme]
    ro, co = R // os_, C // os_
    cands = []
    for lr, lc in FWD_TILES:
        if lr % pr:
            continue
        gc = 1 if consecutive_columns(f, lc, nt - 1) else f
        dc = f // gc
        grid = (cdiv(co, lc) if gc == 1 else axis_blocks(co, f, lc), axis_blocks(ro, f, lr),
                min(B, 65535))
        if lc % (COL_STRIP * dc) or grid[1] > 65535:
            continue
        for nph in (1, 2):
            cands.append(InvPlan(lr, lc, gc, nph, nt, 256, grid,
                                 fwd_smem(scheme, lr, lc, dc, nt, nph, os_)))
    return pick_plan(cands, block_target(B, R, C))
