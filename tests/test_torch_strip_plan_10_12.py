"""Launch plans and tilings of kernels 12 and 10, redesigned for Hopper's
CUDA cores on the strip bodies that already computed their functions,
checked on the CPU:

* kernel 12, the polyphase 2D synthesis of the precision tiers
  (``matmul.inv_level_2d_mxu``), runs kernel 2's body templated on the
  compute scheme, on ``separable.inv_level_launch_plan(..., scheme)``:
  every output falls in exactly one tile of one block in every scheme, the
  plan fits the H100's shared memory for every even filter of up to 40 taps
  (byte for byte the C ``inv_smem<S>``), the main path's levels (1024^2 to
  128^2 subbands) get their block target, the ``fd`` plan is kernel 2's plan
  of before the change on every shape tested, and a float32 numpy model of
  the generalised tiling (per-parity tap tables from the (4, hlen) buffer,
  row strips, the temps split per scheme, column strips, one rounding of the
  tile) equals ``inv_level_2d_mxu_ref`` bit for bit in b1, b2f, b2d and b3,
  and within ``tier_limit`` in fd;
* kernel 10, the exact a-trous 1D synthesis (``batched1d.swt_inv_level_1d``),
  runs kernel 16's a-trous body in ``fd`` on float32 bands, on
  ``mxu1d.inv1d_launch_plan(..., "fd", False)``: the plan covers every
  output once and fits for 2 to 128 taps, odd lengths, dilations up to
  2^12 past the signal, and batches of 1, 33 and 1024, and kernel 16's
  tiling model on float32 bands equals kernel 10's plain version within
  1e-5 of its largest output.
"""
import numpy as np
import pytest
import torch

from pdwt_tpu_torch import get_wavelet
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.filters import make_custom_wavelet
from pdwt_tpu_torch.kernels import _launch as L
from pdwt_tpu_torch.kernels import batched1d as K1
from pdwt_tpu_torch.kernels import matmul as M
from pdwt_tpu_torch.kernels import mxu1d as M1
from pdwt_tpu_torch.kernels import separable as K
from test_torch_inv_launch_plan import _check_shape_rules, _coverage
from test_torch_strip_plan_16_17 import _check_rules, _coverage_1d, _model_inv1d

F32, BF16 = torch.float32, torch.bfloat16


def _wavelet(name):
    """A named wavelet, or a custom bank of n taps (``w<n>``) from a seed, as
    ``chip_smoke.py`` makes them (``odd5``: 5 taps)."""
    if name == "odd5":
        return make_custom_wavelet("odd5", *np.random.default_rng(5).standard_normal((4, 5)))
    if name.startswith("w"):
        n = int(name[1:])
        return make_custom_wavelet(name, *np.random.default_rng(n).standard_normal((4, n)))
    return get_wavelet(name)


def _blocks(plan):
    return plan.grid[0] * plan.grid[1] * plan.grid[2]


def _offmax(hlen):
    g = conv.poly_geometry(hlen)
    return g.lo + max(g.o)


# -- kernel 12: inv_level_launch_plan in every scheme ---------------------------

@pytest.mark.parametrize("scheme", M.SCHEMES)
@pytest.mark.parametrize("B,Mr,Mc", [(1, 1, 1), (3, 1, 1), (1, 8, 8), (3, 37, 53),
                                     (1, 40, 70), (2, 64, 128), (1, 128, 128), (2, 100, 9)])
@pytest.mark.parametrize("hlen", [2, 5, 14, 40])
def test_inv_level_plan_covers_every_output_once_in_every_scheme(scheme, B, Mr, Mc, hlen):
    plan = K.inv_level_launch_plan(B, Mr, Mc, hlen, scheme)
    _check_shape_rules(plan, scheme, 1)
    assert plan.gc == 1 and plan.nph == 1 and plan.threads == 256
    assert (_coverage(plan, Mr, Mc, 1, 2, B) == 1).all(), plan


def _c_inv_smem(scheme, offmax, lr, lc, nt):
    """separable.cu: inv_smem<S>, term by term as the C source writes it:
    taps (16 nv nt), the index tables, the band windows or the tile, the
    two temps of nd operands at temp_pitch<St>(WC)."""
    st = 4 if scheme == "fd" else 2                      # sizeof(Stage<S>)
    nd = 2 if scheme in ("b2d", "b3") else 1             # kDataLo<S>
    nv = 2 if scheme in ("b2f", "b3") else 1             # kTapLo<S>
    WR, WC = lr + offmax + nt - 1, lc + offmax + nt - 1
    win = 4 * nd * WR * WC * st
    tile = 2 * lr * (2 * lc + 1) * 4
    tp = (WC | 1) if st == 4 else ((WC + 1) // 4) * 4 + 2
    a16 = lambda b: (b + 15) & ~15
    return 16 * nv * nt + a16((WR + WC) * 4) + a16(max(win, tile)) + 2 * nd * 2 * lr * tp * st


@pytest.mark.parametrize("scheme", M.SCHEMES)
@pytest.mark.parametrize("shape", [(1, 1024, 1024), (1, 128, 128), (3, 37, 53), (1, 1, 1),
                                   (70000, 4, 4)])
def test_inv_level_plan_fits_shared_memory_for_every_even_filter(scheme, shape):
    for hlen in range(2, M.MXU_MAX_HLEN + 1, 2):
        plan = K.inv_level_launch_plan(*shape, hlen, scheme)
        _check_shape_rules(plan, scheme, 1)
        assert plan.nt >= max(conv.poly_geometry(hlen).nb) and plan.nt % K.INV_CHUNK == 0
        assert plan.smem == _c_inv_smem(scheme, _offmax(hlen), plan.lr, plan.lc, plan.nt)
        assert plan.grid[2] == min(shape[0], 65535)


@pytest.mark.parametrize("scheme", M.SCHEMES)
@pytest.mark.parametrize("m", [1024, 512, 256, 128])
def test_main_path_levels_get_their_block_target_in_every_scheme(scheme, m):
    """The tier DWT roundtrip's synthesis levels (db7, subbands 1024^2 down
    to 128^2; fd, b2f or b3 at level 1, b3 below): about two blocks per SM,
    at most the shared memory that lets two blocks share one."""
    plan = K.inv_level_launch_plan(1, m, m, 14, scheme)
    assert _blocks(plan) >= L.block_target(1, 2 * m, 2 * m)
    assert _blocks(plan) >= (128 if m == 128 else 256)
    assert plan.smem <= L.SMEM_TWO_BLOCKS


def _kernel_2_plan_before(B, Mr, Mc, hlen):
    """kernels/separable.py:inv_level_launch_plan as kernel 2 had it before
    the plan took a scheme (float32 staging, one table of taps)."""
    g = conv.poly_geometry(hlen)
    nt = L.cdiv(max(g.nb), 4) * 4
    offmax = g.lo + max(g.o)
    cands = []
    for lr, lc in L.PLAN_TILES:
        grid = (L.cdiv(Mc, lc), L.cdiv(Mr, lr), min(B, 65535))
        if lr % 8 or grid[1] > 65535:
            continue
        wr, wc = lr + offmax + nt - 1, lc + offmax + nt - 1
        smem = (16 * nt + L.align16(4 * (wr + wc)) + L.align16(max(16 * wr * wc,
                                                                    8 * lr * (2 * lc + 1)))
                + 16 * lr * L.temp_pitch(wc, 4))
        cands.append(L.InvPlan(lr, lc, 1, 1, nt, 256, grid, smem))
    return L.pick_plan(cands, L.block_target(B, 2 * Mr, 2 * Mc))


@pytest.mark.parametrize("shape", [(1, 1024, 1024), (1, 512, 512), (1, 256, 256), (1, 128, 128),
                                   (1, 8, 8), (3, 8, 8), (3, 37, 53), (2, 35, 67), (1, 40, 70),
                                   (1, 70, 38), (1, 1, 1), (70000, 4, 4)])
def test_fd_plan_is_kernel_2_plan_of_before(shape):
    for hlen in range(2, L.MAX_HLEN + 1):
        assert K.inv_level_launch_plan(*shape, hlen) == _kernel_2_plan_before(*shape, hlen)
        assert K.inv_level_launch_plan(*shape, hlen, "fd") == K.inv_level_launch_plan(*shape, hlen)


def _tap_tables(tp, hlen, nt, scheme):
    """The shared tap tables t1, t2 [q][low, high][nt] as inv_level_kernel's
    `tap` index fills them from the (4, hlen) buffer (rows lo1, lo2, hi1,
    hi2): entry e -> row 2 (qk & 1) + e / (4 nt), tap p_q + 2 j, 0 past nb_q."""
    g = conv.poly_geometry(hlen)
    flat = np.stack(tp).astype(np.float32).ravel()
    nv = 2 if scheme in ("b2f", "b3") else 1
    out = np.zeros(nv * 4 * nt, dtype=np.float32)
    for e in range(nv * 4 * nt):
        j, qk, val = e % nt, (e // nt) % 4, e // (4 * nt)
        q = qk >> 1
        if j < g.nb[q]:
            out[e] = flat[(2 * (qk & 1) + val) * hlen + g.p[q] + 2 * j]
    t1 = out[:4 * nt].reshape(2, 2, nt)
    t2 = out[4 * nt:].reshape(2, 2, nt) if nv == 2 else np.zeros_like(t1)
    return t1, t2


def _split(x, scheme):
    """A scheme's data operands of float32 values, as stage<S> keeps them."""
    d1, d2 = M.split_data(torch.from_numpy(np.ascontiguousarray(x)), scheme)
    return d1.numpy(), (np.zeros_like(x) if d2 is None else d2.numpy())


def _strip_sums(t1, t2, ops, take, n, scheme):
    """Acc<S> over two bands' operands `ops` [(d1, d2), (d1, d2)], taps in
    order, in float32, each term its own sum, then total(): band outer, tap
    inner, sample j + i of output i from take(array, j)."""
    s = [np.zeros(n, dtype=np.float32) for _ in range(3)]
    for b, (d1, d2) in enumerate(ops):
        for j in range(t1.shape[-1]):
            a1, a2 = np.float32(t1[b, j]), np.float32(t2[b, j])
            x1, x2 = take(d1, j), take(d2, j)
            s[0] = s[0] + a1 * x1
            if scheme == "b2f":
                s[1] = s[1] + a2 * x1
            if scheme in ("b2d", "b3"):
                s[1] = s[1] + a1 * x2
            if scheme == "b3":
                s[2] = s[2] + a2 * x1
    if scheme == "b3":
        return (s[0] + s[1]) + s[2]
    return s[0] + s[1] if scheme in ("b2f", "b2d") else s[0]


def _model_inv_level_scheme(bands, rlo, rhi, scheme, out_dtype):
    """inv_level_kernel<S> in float32: per block, the window tables, the four
    bands' windows split per scheme, the row pass into the temps of (A, H)
    and (V, D) (rows 2 (r0 + i) + q), the temps split per scheme, the column
    pass into a float tile, and one rounding to ``out_dtype`` as it is
    stored.  Products of bf16 values are exact in float32, so numpy's
    multiply-then-add is the kernel's FMA in the b-schemes."""
    B, Mr, Mc = bands[0].shape
    tp = M.kernel_taps((rlo, rhi), scheme)
    hlen = len(tp[0])
    g = conv.poly_geometry(hlen)
    pl = K.inv_level_launch_plan(B, Mr, Mc, hlen, scheme)
    nt, lr, lc = pl.nt, pl.lr, pl.lc
    t1, t2 = _tap_tables(tp, hlen, nt, scheme)
    off = [g.lo + g.o[q] for q in (0, 1)]
    WR, WC = lr + max(off) + nt - 1, lc + max(off) + nt - 1
    x = [t.float().numpy() for t in bands]
    out = torch.zeros((B, 2 * Mr, 2 * Mc), dtype=out_dtype)
    for by in range(pl.grid[1]):
        r0 = by * lr
        wrows = (r0 - g.lo + np.arange(WR)) % Mr
        orows = 2 * r0 + np.arange(2 * lr)
        for bx in range(pl.grid[0]):
            c0 = bx * lc
            wcols = (c0 - g.lo + np.arange(WC)) % Mc
            ocols = 2 * c0 + np.arange(2 * lc)
            rin, cin = orows < 2 * Mr, ocols < 2 * Mc
            for b in range(B):
                win = [_split(t[b][np.ix_(wrows, wcols)], scheme) for t in x]
                tmp = []
                for k in (0, 1):
                    tk = np.zeros((2 * lr, WC), dtype=np.float32)
                    for q in (0, 1):
                        tk[q::2] = _strip_sums(t1[q], t2[q], win[2 * k:2 * k + 2],
                                               lambda a, j, q=q: a[off[q] + j:off[q] + j + lr],
                                               (lr, WC), scheme)
                    tmp.append(_split(tk, scheme))
                tile = np.zeros((2 * lr, 2 * lc), dtype=np.float32)
                for q in (0, 1):
                    tile[:, q::2] = _strip_sums(t1[q], t2[q], tmp,
                                                lambda a, j, q=q: a[:, off[q] + j:off[q] + j + lc],
                                                (2 * lr, lc), scheme)
                keep = torch.from_numpy(tile[np.ix_(rin, cin)]).to(out_dtype)
                out[b][np.ix_(orows[rin], ocols[cin])] = keep
    return out


@pytest.mark.parametrize("scheme", M.SCHEMES)
@pytest.mark.parametrize("wname,shape,det,out", [
    ("db7", (1, 40, 70), BF16, BF16), ("db7", (2, 37, 53), F32, F32),
    ("db2", (3, 9, 13), BF16, F32), ("odd5", (1, 35, 67), F32, BF16),
    ("w40", (1, 70, 38), BF16, F32), ("haar", (1, 1, 1), F32, F32)])
def test_model_of_kernel_12_tiling_matches_the_plain_version(scheme, wname, shape, det, out):
    """b-schemes bit for bit; fd within tier_limit (the kernel's FMAs round
    once where the plain version rounds twice)."""
    w = _wavelet(wname)
    g = np.random.default_rng(sum(shape) + len(wname))
    bands = [torch.from_numpy(g.uniform(0, 255, shape).astype(np.float32))]
    bands += [torch.from_numpy(g.uniform(-127.5, 127.5, shape).astype(np.float32)).to(det)
              for _ in range(3)]
    want = M.inv_level_2d_mxu_ref(*bands, w.rec_lo, w.rec_hi, scheme, out)
    got = _model_inv_level_scheme(bands, w.rec_lo, w.rec_hi, scheme, out)
    assert got.dtype == want.dtype and got.shape == want.shape
    if scheme == "fd":
        limit = (2.0 ** -7 if out == BF16 else 1e-5) * float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= limit
    else:
        assert torch.equal(got, want)


# -- kernel 10: inv1d_launch_plan in fd, a-trous, on float32 bands --------------

PLAN_10 = [(1, 1), (1, 7), (33, 1), (33, 7), (1, 100), (33, 257), (1024, 64), (3, 4096)]


@pytest.mark.parametrize("B,N", PLAN_10)
@pytest.mark.parametrize("f", [1, 2, 16, 256, 4096])
@pytest.mark.parametrize("hlen", [2, 3, 16, 64, 127, 128])
def test_kernel_10_plan_covers_every_output_once(B, N, f, hlen):
    plan = M1.inv1d_launch_plan(B, N, hlen, f, "fd", False)
    _check_rules(plan, "fd", f)
    assert plan.nt >= hlen and plan.nt % M1.INV_CHUNK[False] == 0
    assert plan.nt <= L.MAX_HLEN + M1.INV_CHUNK[False]  # mxu1d.cu: launch_inv
    assert plan.smem == M1._inv1d_smem("fd", 1, plan.lc, f // plan.gc, plan.nt)
    assert (_coverage_1d(plan, B, N, f, False) == 1).all(), plan


@pytest.mark.parametrize("B,N,f", [(1024, 4096, 1), (1024, 4096, 8), (33, 7, 4096), (1, 1, 4096),
                                   (1, 5000, 2048), (33, 100, 64)])
def test_kernel_10_plan_fits_for_every_filter_length(B, N, f):
    """2 to 128 taps, odd ones too (custom banks), with supports far wider
    than the signal at the large dilations."""
    for hlen in range(2, L.MAX_HLEN + 1):
        plan = M1.inv1d_launch_plan(B, N, hlen, f, "fd", False)
        _check_rules(plan, "fd", f)
        assert plan.nt >= hlen and plan.nt % M1.INV_CHUNK[False] == 0


@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_kernel_10_cell_levels_fill_the_card(level):
    """The 1D SWT cell (sym8, 1024 x 4096, levels 1-4) on kernel 10:
    consecutive positions and about two blocks per SM, as kernel 16's."""
    plan = M1.inv1d_launch_plan(1024, 4096, 16, L.dilation(level), "fd", False)
    assert plan.gc == 1 and _blocks(plan) >= 2 * L.SMS and plan.smem <= L.SMEM_TWO_BLOCKS


@pytest.mark.parametrize("wname,B,N,level", [
    ("sym8", 33, 300, 1), ("sym8", 2, 77, 3), ("odd3", 3, 50, 2), ("odd3", 33, 7, 5),
    ("w64", 2, 150, 2), ("w128", 3, 90, 1), ("w128", 1, 7, 13), ("db2", 1, 1, 4),
    ("sym8", 33, 1, 2), ("db7", 5, 7, 6)])
def test_model_of_kernel_10_tiling_matches_the_plain_version(wname, B, N, level):
    """Kernel 16's a-trous tiling in fd on float32 bands (its float64 model)
    against kernel 10's plain version: hlen 3 (odd), 64 and 128, dilations
    past the signal, N = 1 and 7, a batch of 33."""
    w = (make_custom_wavelet("odd3", *np.random.default_rng(3).standard_normal((4, 3)))
         if wname == "odd3" else _wavelet(wname))
    g = np.random.default_rng(N + level)
    lo, hi = (torch.from_numpy(g.standard_normal((B, N)).astype(np.float32)) for _ in range(2))
    want = K1.swt_inv_level_1d_ref(lo, hi, w.rec_lo, w.rec_hi, level)
    got = _model_inv1d(lo, hi, w.rec_lo, w.rec_hi, L.dilation(level), False)
    scale = float(want.abs().max())
    assert np.abs(got - want.double().numpy()).max() <= 1e-5 * scale
