"""Launch plans and tilings of kernels 3 and 4, the fused deep levels of
the 2D DWT, redesigned for Hopper as one launch spread over a thread-block
cluster on the level bodies of kernels 1 and 2, checked on the CPU:

* ``separable.tail_launch_plan`` covers every output of every level once,
  in both directions, with cluster sizes 1, 2, 4, 8 and 16, for 2 to 128
  taps (odd ones too) on the shapes the tails take: the CUDA tests' tail
  cases, 128 taps on 16 x 16 at 2 levels, a batch of 70000 4 x 4 images at
  2 levels and 160 x 160 at 5 levels; every block fits 227 KiB and the
  plan's shared memory is the C launchers' formula for its largest level;
  the DWT cell's tail (1 x 128^2, db7, one level) gets at least 16 blocks;
* the tiling models of kernel 1 (``_model_fwd_level``, rows first) and of
  kernel 2 (``_model_inv_level``), each level on the tail's tile and
  chained over the levels as the tails chain them, equal the tails' plain
  versions within 1e-5 of the largest output, and JAX's kernels 3 and 4
  (``separable_pallas.py:576, 648``) in interpret mode within
  ``test_torch_separable_kernels.py``'s 4e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import kernels as jk
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu_torch.core import conv
from pdwt_tpu_torch.kernels import _launch as L
from pdwt_tpu_torch.kernels import matmul as M
from pdwt_tpu_torch.kernels import separable as K
from test_torch_exact_inv_plan import _model_inv_level
from test_torch_inv_launch_plan import _coverage
from test_torch_strip_plan_10_12 import _c_inv_smem, _offmax, _wavelet
from test_torch_strip_plan_1_7 import JAX_RTOL, _within
from test_torch_strip_plan_9_11 import _c_fwd_smem, _model_fwd_level

F32 = torch.float32

# tests/test_torch_cuda.py: TAIL_CASES, then 128 taps on 16 x 16, a batch
# past gridDim.z of 4 x 4 images, 160 x 160 to 5 x 5, and the cell's tail
# at 4 levels
PLAN_CASES = [("db7", (1, 128, 128), 1), ("db7", (3, 32, 64), 3), ("db18", (1, 64, 128), 3),
              ("haar", (2, 16, 16), 4), ("odd5", (1, 24, 40), 3), ("w128", (1, 16, 16), 2),
              ("db2", (70000, 4, 4), 2), ("db7", (1, 160, 160), 5), ("db7", (1, 128, 128), 4)]


def _level_shapes(R, C, levels, inverse):
    """Per level in launch order: the (rows, columns) of the positions its
    tiles cover (the forward's subband outputs, the inverse's subband
    inputs) and the output step (1 forward, 2 inverse)."""
    if inverse:
        return [(R >> (levels - j), C >> (levels - j), 2) for j in range(levels)]
    return [(R >> (j + 1), C >> (j + 1), 1) for j in range(levels)]


def _check_plan(pl, B, R, C, hlen, levels, inverse):
    assert pl.cs in K.TAIL_CLUSTERS and pl.nb >= 1
    assert pl.cs == (1 if levels == 1 else pl.nb)  # one cluster per item where levels meet
    assert B * pl.nb < 2 ** 31 and pl.threads == 256 and len(pl.levels) == levels
    g = conv.poly_geometry(hlen)
    smems = []
    for lp, (n_r, n_c, st) in zip(pl.levels, _level_shapes(R, C, levels, inverse)):
        assert lp.gc == 1 and lp.lr % L.ROW_STRIP["fd"] == 0 and lp.lc % L.COL_STRIP == 0
        assert lp.nt == pl.levels[0].nt and lp.grid == (-(-n_c // lp.lc), -(-n_r // lp.lr),
                                                        min(B, 65535))
        if inverse:
            assert lp.nph == 1 and lp.nt % K.INV_CHUNK == 0 and max(g.nb) <= lp.nt
            smems.append(_c_inv_smem("fd", _offmax(hlen), lp.lr, lp.lc, lp.nt))
        else:
            assert lp.nph in (1, 2) and lp.nt % L.FWD_CHUNK == 0 and hlen <= lp.nt
            smems.append(_c_fwd_smem("fd", 2, lp.lr, lp.lc, 1, lp.nt, lp.nph))
        assert lp.smem == smems[-1]
    assert pl.smem == max(smems) <= L.SMEM_LIMIT


def _covers(pl, B, R, C, levels, inverse):
    """Tile k of a level on block k mod nb: every tile on one block, and
    the level's tiles cover each of its outputs once."""
    for lp, (n_r, n_c, st) in zip(pl.levels, _level_shapes(R, C, levels, inverse)):
        tiles = lp.grid[0] * lp.grid[1]
        owners = np.bincount(np.arange(tiles) % pl.nb, minlength=pl.nb)
        assert owners.sum() == tiles and owners.max() == -(-tiles // pl.nb)
        assert (_coverage(lp, n_r, n_c, 1, st, B) == 1).all(), lp


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("wname,shape,levels", PLAN_CASES)
def test_tail_plan_covers_every_output_of_every_level_once(wname, shape, levels, inverse):
    B, R, C = shape
    hlen = _wavelet(wname).hlen
    assert K.tail_supported((R, C), hlen, levels)
    pl = K.tail_launch_plan(B, R, C, hlen, levels, inverse)
    _check_plan(pl, B, R, C, hlen, levels, inverse)
    _covers(pl, B, R, C, levels, inverse)


@pytest.fixture
def cluster(monkeypatch):
    """Set the cluster size of multi-level tails (as the timing script
    does to compare them), the plan cache cleared around it."""
    def set_cs(cs):
        monkeypatch.setattr(K, "_tail_cluster", lambda B, tiles: cs)
        K.tail_launch_plan.cache_clear()
    yield set_cs
    monkeypatch.undo()
    K.tail_launch_plan.cache_clear()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("cs", K.TAIL_CLUSTERS)
@pytest.mark.parametrize("wname,shape,levels", [("db7", (1, 128, 128), 4),
                                                ("db7", (1, 160, 160), 5),
                                                ("db18", (1, 64, 128), 3)])
def test_tail_plan_covers_at_every_cluster_size(wname, shape, levels, cs, inverse, cluster):
    B, R, C = shape
    hlen = _wavelet(wname).hlen
    cluster(cs)
    pl = K.tail_launch_plan(B, R, C, hlen, levels, inverse)
    assert pl.cs == pl.nb == cs
    _check_plan(pl, B, R, C, hlen, levels, inverse)
    _covers(pl, B, R, C, levels, inverse)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,levels", [((1, 128, 128), 1), ((1, 128, 128), 4),
                                          ((3, 16, 16), 2), ((70000, 4, 4), 2)])
def test_tail_plan_fits_for_every_filter_length(shape, levels, inverse):
    """2 to 128 taps, odd ones too (custom banks): nothing the tails took
    before is refused, whatever the halo against the deepest level."""
    B, R, C = shape
    for hlen in range(2, L.MAX_HLEN + 1):
        if not K.tail_supported((R, C), hlen, levels):
            continue
        pl = K.tail_launch_plan(B, R, C, hlen, levels, inverse)
        _check_plan(pl, B, R, C, hlen, levels, inverse)


@pytest.mark.parametrize("inverse", [False, True])
def test_cell_tail_fills_more_than_one_sm(inverse):
    """The DWT cell's tail (1 x 128^2, db7, level 5) gets kernel 1's (2's)
    own plan, at least 16 blocks, where the first bodies ran one block; at
    4 levels one 16-block cluster, each block a tile of the first level."""
    one = K.tail_launch_plan(1, 128, 128, 14, 1, inverse)
    assert one.nb >= 16 and one.cs == 1
    assert one.levels[0] == (K.inv_level_launch_plan(1, 64, 64, 14) if inverse
                             else M.fwd_launch_plan(1, 128, 128, 14, "fd"))
    four = K.tail_launch_plan(1, 128, 128, 14, 4, inverse)
    first = four.levels[-1 if inverse else 0]
    assert four.nb == four.cs == 16 and first.grid[0] * first.grid[1] == 16


def test_tail_plan_refuses_what_the_tails_do_not_take():
    with pytest.raises(ValueError, match="divisible"):
        K.tail_launch_plan(1, 24, 40, 5, 4)


@pytest.mark.parametrize("B,cs", [(1, 16), (3, 16), (8, 16), (9, 8), (33, 4), (66, 2),
                                  (131, 1), (132, 1), (70000, 1)])
def test_tail_cluster_keeps_the_card_within_one_block_an_sm(B, cs):
    """16 blocks an item where the first level's 8 x 8 tiles (64 at 128^2)
    and the card's 132 SMs allow, fewer as the batch grows, 1 from 132
    items on."""
    assert K._tail_cluster(B, 64) == cs
    assert K._tail_cluster(B, 1) == 1


# -- the tiling models, chained over the levels --------------------------------

def _model_fwd_tail(x, w, levels, pl, monkeypatch):
    """Kernel 1's tiling model, each level on the tail's tile."""
    a, dets = x, []
    for lp in pl.levels:
        monkeypatch.setattr(M, "fwd_launch_plan", lambda *args, lp=lp: lp)
        a, h, v, d = _model_fwd_level(a, w.dec_lo, w.dec_hi, "fd", (F32, F32))
        dets.append((h, v, d))
    return a, dets


def _model_inv_tail(a, details, w, pl, monkeypatch):
    """Kernel 2's tiling model (float64), each level on the tail's tile;
    the approximation goes on in float32, as the tail's scratch holds it."""
    for lp, band in zip(pl.levels, details):
        monkeypatch.setattr(K, "inv_level_launch_plan", lambda *args, lp=lp: lp)
        a = torch.from_numpy(_model_inv_level([a, *band], w.rec_lo, w.rec_hi)).float()
    return a


MODEL_CASES = [c + (None,) for c in PLAN_CASES if c[1][0] < 70000] + \
    [("db7", (1, 128, 128), 4, cs) for cs in (1, 2, 8)]


@pytest.mark.parametrize("wname,shape,levels,cs", MODEL_CASES)
def test_model_of_the_forward_tail_matches_its_plain_version(wname, shape, levels, cs,
                                                             monkeypatch, cluster):
    """Kernel 1's tiling model (rows first) on the tail's tiles, level by
    level, against the tail's plain version (columns first)."""
    w = _wavelet(wname)
    x = torch.from_numpy(np.random.default_rng(sum(shape) + levels)
                         .uniform(0, 255, shape).astype(np.float32))
    if cs:
        cluster(cs)
    pl = K.tail_launch_plan(*shape, w.hlen, levels)
    a, dets = _model_fwd_tail(x, w, levels, pl, monkeypatch)
    ra, rdets = K.fwd_tail_2d_ref(x, w.dec_lo, w.dec_hi, levels)
    _within([a, *sum(dets, ())], [ra, *sum(rdets, ())], 1e-5)


@pytest.mark.parametrize("wname,shape,levels,cs", MODEL_CASES)
def test_model_of_the_inverse_tail_matches_its_plain_version(wname, shape, levels, cs,
                                                             monkeypatch, cluster):
    """Kernel 2's tiling model on the tail's tiles, deepest level first."""
    w = _wavelet(wname)
    B, R, C = shape
    g = np.random.default_rng(sum(shape) + 7 * levels)
    a = torch.from_numpy(g.uniform(-1, 1, (B, R >> levels, C >> levels)).astype(np.float32))
    details = [tuple(torch.from_numpy(g.uniform(-1, 1, (B, R >> k, C >> k)).astype(np.float32))
                     for _ in range(3)) for k in range(levels, 0, -1)]
    if cs:
        cluster(cs)
    pl = K.tail_launch_plan(B, R, C, w.hlen, levels, True)
    got = _model_inv_tail(a, details, w, pl, monkeypatch)
    want = K.inv_tail_2d_ref(a, details, w.rec_lo, w.rec_hi)
    _within([got], [want], 1e-5)


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("wname,shape,levels", [("db7", (2, 16, 128), 1),
                                                ("db18", (1, 64, 128), 3)])
def test_models_of_the_tails_match_the_pallas_kernels(_interpret, wname, shape, levels,
                                                      monkeypatch):
    """The chained models against JAX's kernels 3 and 4 (interpret mode) at
    ``test_tail_refs_match_pallas``'s shapes: db18's 35-sample halo is
    wider than the 8-row deepest level."""
    jw, w = jget_wavelet(wname), _wavelet(wname)
    B, R, C = shape
    x = np.random.default_rng(sum(shape)).uniform(0, 255, shape).astype(np.float32)
    want = jk.fwd_tail_2d(jnp.asarray(x), jw.dec_lo, jw.dec_hi, levels)
    assert want is not None
    pl = K.tail_launch_plan(B, R, C, w.hlen, levels)
    a, dets = _model_fwd_tail(torch.from_numpy(x), w, levels, pl, monkeypatch)
    _within([a, *sum(dets, ())], [want[0], *sum((tuple(b) for b in want[1]), ())], JAX_RTOL)
    deepest_first = [tuple(map(jnp.asarray, band)) for band in want[1][::-1]]
    want_y = jk.inv_tail_2d(want[0], deepest_first, jw.rec_lo, jw.rec_hi)
    assert want_y is not None
    pl = K.tail_launch_plan(B, R, C, w.hlen, levels, True)
    got_y = _model_inv_tail(torch.tensor(np.asarray(want[0])),
                            [tuple(torch.tensor(np.asarray(t)) for t in band)
                             for band in deepest_first], w, pl, monkeypatch)
    _within([got_y], [want_y], JAX_RTOL)
