"""The port's wavelet packets against the JAX package's, on the CPU (the
port's kernel wrappers run their plain versions; JAX runs its ``fma``
path, and under a tier its Pallas path in interpret mode): ``wp1d``/
``wp2d``/``wp3d`` nodes at odd and prime sizes, their inverses, the four
costs, the best basis, ``wp_reconstruct`` with ``map_fn`` and its errors,
the bf16-fast and mixed tiers, a gradient, ``packet_denoise`` and the
``WaveletPackets`` facade; the three family facades' signatures.

Tolerances, max|port - jax| relative to the largest |jax| value of one
depth or output:

* float32 nodes and reconstructions: 1e-5 (the single-level transforms'
  FMAs; the nodes came out bit for bit when this file was written);
  float64: 1e-12; a float64 roundtrip against its input 1e-8 (the filter
  tables' own precision);
* costs: 1e-5 of the depth's largest |cost| (float32 sums in another
  order);
* the best basis: equal leaves wherever every split decision's relative
  margin, |children's sum - cost| / (|children's sum| + |cost|), exceeds
  ``MARGIN`` = 1e-4, asserted per case; otherwise JAX's reconstruction
  given the port's leaves;
* tiers as ``tests/test_torch_precision.py``: bf16 nodes 2^-7, float32
  under ``mixed`` 1e-4;
* the gradient 1e-5.
"""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu import DualTree as JDualTree
from pdwt_tpu import Starlet as JStarlet
from pdwt_tpu import WaveletPackets as JWaveletPackets
from pdwt_tpu import models as jmodels
from pdwt_tpu.core import packets as jpk
from pdwt_tpu.core import precision as jprec
from pdwt_tpu.filters import get_wavelet as jget_wavelet
from pdwt_tpu.ops.threshold import THR_ELEM as JTHR
from pdwt_tpu_torch import DualTree, Starlet, WaveletPackets, models, precision_scope
from pdwt_tpu_torch.core import packets as pk
from pdwt_tpu_torch.ops.threshold import THR_ELEM
from pdwt_tpu_torch.utils import tensor_to_numpy, wavelet_from_arrays

F32_RTOL, F64_RTOL, COST_RTOL, MARGIN, PR_RTOL = 1e-5, 1e-12, 1e-5, 1e-4, 1e-8
BF16_RTOL, MIXED_RTOL = 2.0 ** -7, 1e-4


def _w(name):
    jw = jget_wavelet(name)
    return jw, wavelet_from_arrays(jw)


def _host(t):
    if isinstance(t, torch.Tensor):
        return tensor_to_numpy(t).astype(np.float64)
    return np.asarray(jnp.asarray(t).astype(jnp.float64))


def _close(got, want, rtol):
    g, w = _host(got), _host(want)
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= rtol * scale, (err, rtol * scale)


def _smooth_noisy(shape, seed):
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*(np.linspace(0, 3, n) for n in shape), indexing="ij")
    base = 80 * np.sin(grids[-1]) * np.cos(2 * grids[0]) + 120
    return (base + rng.normal(0, 12, shape)).astype(np.float32)


FWD = {1: (pk.wp1d, jpk.wp1d), 2: (pk.wp2d, jpk.wp2d), 3: (pk.wp3d, jpk.wp3d)}
INV = {1: (pk.iwp1d, jpk.iwp1d), 2: (pk.iwp2d, jpk.iwp2d), 3: (pk.iwp3d, jpk.iwp3d)}


@functools.lru_cache(maxsize=None)
def _jwp(sd, wname, levels):
    """JAX's packet decomposition on its fma path, jitted: one compile a
    geometry instead of one a primitive."""
    jw = jget_wavelet(wname)
    return jax.jit(lambda x: FWD[sd][1](x, jw, levels, backend="fma"))


def _jrec(jp, leaves, wname, mfn=None):
    jw = jget_wavelet(wname)
    return jax.jit(lambda t: jpk.wp_reconstruct(t, leaves, jw, map_fn=mfn, backend="fma"))(jp)
NODE_CASES = [
    (2, (37, 53), "db4", 3, np.float32),
    (2, (64, 48), "sym4", 2, np.float32),
    (2, (2, 31, 29), "db2", 2, np.float64),     # a batch of two prime-sized images
    (1, (3, 97), "sym4", 3, np.float32),
    (1, (2, 64), "db3", 1, np.float64),
    (3, (7, 10, 9), "db2", 2, np.float32),
    (3, (8, 8, 8), "haar", 1, np.float64),
]


@pytest.mark.parametrize("sd,shape,wname,levels,dt", NODE_CASES)
def test_nodes_and_full_inverse_match_jax(sd, shape, wname, levels, dt):
    x = np.random.default_rng(levels).uniform(0, 255, shape).astype(dt)
    jw, w = _w(wname)
    fwd, jfwd = FWD[sd]
    got = fwd(torch.from_numpy(x), w, levels)
    want = _jwp(sd, wname, levels)(jnp.asarray(x))
    assert type(got).__name__ == type(want).__name__ and got.levels == levels
    rtol = F64_RTOL if dt == np.float64 else F32_RTOL
    for g, wn in zip(got.nodes, want.nodes):
        assert str(g.dtype).split(".")[-1] == jnp.dtype(wn.dtype).name
        _close(g, wn, rtol)
    inv, jinv = INV[sd]
    size = shape[-1] if sd == 1 else shape[-sd:]
    y = inv(got.nodes[-1], w, size)
    _close(y, jax.jit(lambda n: jinv(n, jw, size, backend="fma"))(want.nodes[-1]), rtol)
    _close(y, x, max(rtol, PR_RTOL))


@pytest.mark.parametrize("cost", pk.COSTS)
@pytest.mark.parametrize("sd", [1, 2])
def test_costs_match_jax(cost, sd):
    x = _smooth_noisy((48, 40) if sd == 2 else (4, 96), 3)
    jw, w = _w("db3")
    got = pk.wp_costs(FWD[sd][0](torch.from_numpy(x), w, 2), cost, 20.0)
    want = jpk.wp_costs(_jwp(sd, "db3", 2)(jnp.asarray(x)), cost, 20.0)
    for g, wn in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, wn, COST_RTOL)


def _margin(costs, fan):
    """The smallest relative margin of the best-basis split decisions."""
    best = costs[-1]
    worst = np.inf
    for j in range(len(costs) - 2, -1, -1):
        child = best.reshape(-1, fan).sum(axis=1)
        worst = min(worst, float(np.min(np.abs(child - costs[j])
                                        / (np.abs(child) + np.abs(costs[j]) + 1e-300))))
        best = np.where(child < costs[j], child, costs[j])
    return worst


BASIS_CASES = [
    ("shannon", "smooth", 2, True), ("l1", "smooth", 2, True),
    ("threshold", "smooth", 2, None), ("logenergy", "noise", 2, False),
    ("shannon", "smooth", 1, True), ("logenergy", "smooth", 1, True),
]


@pytest.mark.parametrize("cost,kind,sd,clear", BASIS_CASES)
def test_best_basis_matches_jax_under_the_margin_rule(cost, kind, sd, clear):
    """Equal leaves where every decision clears MARGIN; else the same
    reconstruction from the port's leaves.  ``clear`` states which the case
    is, so a case that drifts into a near-tie fails rather than changes
    branch.  The threshold cost counts (exact integers in float32): its
    costs are equal and so are its leaves, ties included."""
    shape = (64, 64) if sd == 2 else (4, 256)
    x = (_smooth_noisy(shape, 5) if kind == "smooth"
         else np.random.default_rng(0).standard_normal(shape).astype(np.float32))
    _, w = _w("db4")
    p = FWD[sd][0](torch.from_numpy(x), w, 3)
    jp = _jwp(sd, "db4", 3)(jnp.asarray(x))
    leaves, total = pk.best_basis(p, cost, 20.0)
    jleaves, jtotal = jpk.best_basis(jp, cost, 20.0)
    jcosts = [np.asarray(c, np.float64) for c in jpk.wp_costs(jp, cost, 20.0)]
    margin = _margin(jcosts, 4 if sd == 2 else 2)
    if clear is None:
        assert all(np.array_equal(c.numpy(), j) for c, j in zip(pk.wp_costs(p, cost, 20.0),
                                                                 jcosts))
    else:
        assert (margin > MARGIN) == clear, margin
    assert abs(total - jtotal) <= COST_RTOL * abs(jtotal)
    if clear is not False:
        assert leaves == jleaves
    thr = lambda v, j, i: v if i == 0 else JTHR["soft"](v, 10.0)
    got = pk.wp_reconstruct(pk.threshold_details(p, leaves, THR_ELEM["soft"], 10.0), leaves, w)
    _close(got, _jrec(jp, leaves, "db4", thr), F32_RTOL)


def test_reconstruct_map_fn_and_the_stacked_threshold_agree():
    """``map_fn`` a leaf at a time against JAX, and ``threshold_details``
    (one pass a depth) against ``map_fn`` bit for bit, also on a 3D tree
    whose cover mixes depths."""
    x = _smooth_noisy((33, 47), 2)
    _, w = _w("db2")
    p = pk.wp2d(torch.from_numpy(x), w, 2)
    jp = _jwp(2, "db2", 2)(jnp.asarray(x))
    cover = ((1, 0), (1, 1), (1, 2)) + tuple((2, i) for i in range(12, 16))
    seen = []

    def mfn(v, j, i):
        seen.append((j, i))
        return v if i == 0 else THR_ELEM["hard"](v, 15.0)

    got = pk.wp_reconstruct(p, cover, w, map_fn=mfn)
    assert sorted(seen) == sorted(cover)
    jmfn = lambda v, j, i: v if i == 0 else JTHR["hard"](v, 15.0)
    _close(got, _jrec(jp, cover, "db2", jmfn), F32_RTOL)
    stacked = pk.wp_reconstruct(pk.threshold_details(p, cover, THR_ELEM["hard"], 15.0), cover, w)
    assert torch.equal(stacked, got)
    v = torch.from_numpy(_smooth_noisy((6, 10, 12), 4))
    p3 = pk.wp3d(v, w, 2)
    cover3 = ((1, 0),) + tuple((2, i) for i in range(8, 64))
    soft = lambda t, j, i: t if i == 0 else THR_ELEM["soft"](t, 9.0)
    a = pk.wp_reconstruct(p3, cover3, w, map_fn=soft)
    b = pk.wp_reconstruct(pk.threshold_details(p3, cover3, THR_ELEM["soft"], 9.0), cover3, w)
    assert torch.equal(a, b)


def test_reconstruct_inv1_fn_is_called_per_group():
    x = torch.from_numpy(_smooth_noisy((16, 16), 1))
    _, w = _w("haar")
    p = pk.wp2d(x, w, 2)
    calls = []

    def inv1(cfs, out_shape):
        calls.append((tuple(cfs.approx.shape), out_shape))
        return pk._inv1(w, 2)(cfs, out_shape)

    y = pk.wp_reconstruct(p, tuple((2, i) for i in range(16)), w, inv1_fn=inv1)
    assert calls == [((4, 4, 4), (8, 8)), ((1, 8, 8), (16, 16))]
    _close(y, x, F32_RTOL)


def test_errors_match_jax():
    x = np.random.default_rng(0).standard_normal((32, 32)).astype(np.float32)
    jw, w = _w("db2")
    p = pk.wp2d(torch.from_numpy(x), w, 2)
    jp = _jwp(2, "db2", 2)(jnp.asarray(x))
    bad = [((1, 0), (1, 1)), tuple([(0, 0)] + [(1, i) for i in range(4)]), ((3, 0),),
           ((1, 0), (1, 1), (1, 2))]
    for leaves in bad:
        with pytest.raises(ValueError) as mine:
            pk.wp_reconstruct(p, leaves, w)
        with pytest.raises(ValueError) as theirs:
            jpk.wp_reconstruct(jp, leaves, jw)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="leaves do not cover the root"):
        pk.wp_reconstruct(p, ((2, 0),) * 0, w)
    with pytest.raises(ValueError, match="power of 4"):
        pk.iwp2d(p.nodes[2][..., :8, :, :], w, (32, 32))
    with pytest.raises(ValueError, match="power of 2"):
        pk.iwp1d(torch.zeros(3, 8), w, 16)
    with pytest.raises(ValueError, match="unknown cost"):
        pk.best_basis(p, "nope")
    with pytest.raises(TypeError, match="Packets"):
        pk.best_basis((p.nodes,), "l1")


TIER_CASES = [("bf16-fast", 2, (64, 256), "db2"), ("mixed", 2, (64, 256), "db2"),
              ("bf16-fast", 1, (32, 512), "sym8"), ("mixed", 1, (32, 512), "sym8")]


@pytest.mark.parametrize("tier,sd,shape,wname", TIER_CASES)
def test_tiers_match_jax(tier, sd, shape, wname, monkeypatch):
    """Depth 1 on the banded-product kernels (2D: 32 x 128 subbands; 1D:
    32 signals of 512), depth 2 on them in 1D and off them in 2D; the
    A-chain cast to the details' dtype under bf16."""
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")
    x = np.random.default_rng(9).uniform(0, 255, shape).astype(np.float32)
    jw, w = _w(wname)
    bf = tier.startswith("bf16")
    xt = torch.from_numpy(x).to(torch.bfloat16 if bf else torch.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if bf else jnp.float32)
    fwd, jfwd = FWD[sd]
    inv, jinv = INV[sd]
    size = shape[-1] if sd == 1 else shape
    with precision_scope(tier):
        got = fwd(xt, w, 2)
        y = inv(got.nodes[-1], w, size)
    with jprec.precision_scope(tier):
        want = jax.jit(lambda t: jfwd(t, jw, 2, backend="pallas"))(jx)
        jy = jax.jit(lambda t: jinv(t, jw, size, backend="pallas"))(want.nodes[-1])
    rtol = BF16_RTOL if bf else MIXED_RTOL
    for g, wn in zip(got.nodes + (y,), want.nodes + (jy,)):
        assert str(g.dtype).split(".")[-1] == jnp.dtype(wn.dtype).name
        _close(g, wn, rtol)


def test_gradient_matches_jax():
    x = np.random.default_rng(4).standard_normal((32, 32)).astype(np.float32)
    jw, w = _w("db2")
    leaves = ((1, 0), (1, 1), (1, 2)) + tuple((2, i) for i in range(12, 16))

    def jloss(img):
        m = lambda v, j, i: v if i == 0 else JTHR["soft"](v, 0.5)
        y = jpk.wp_reconstruct(jpk.wp2d(img, jw, 2, backend="fma"), leaves, jw, map_fn=m,
                               backend="fma")
        return jnp.sum(y * y * jnp.sin(img))

    t = torch.from_numpy(x).requires_grad_(True)
    p = pk.wp2d(t, w, 2)
    y = pk.wp_reconstruct(pk.threshold_details(p, leaves, THR_ELEM["soft"], 0.5), leaves, w)
    (g,) = torch.autograd.grad((y * y * torch.sin(t)).sum(), t)
    _close(g, jax.jit(jax.grad(jloss))(jnp.asarray(x)), F32_RTOL)


@pytest.mark.parametrize("beta", [None, 25.0])
def test_packet_denoise_matches_jax(beta):
    x = _smooth_noisy((64, 48), 6)
    got = models.packet_denoise(torch.from_numpy(x), "db4", 3, beta)
    want = jmodels.packet_denoise(jnp.asarray(x), "db4", 3, beta, backend="fma")
    assert got.dtype == torch.float32
    _close(got, want, F32_RTOL)


def test_wavelet_packets_facade_matches_jax():
    x = _smooth_noisy((40, 56), 8)
    WP = WaveletPackets(x, wname="sym4", levels=2, device="cpu")
    JP = JWaveletPackets(x, wname="sym4", levels=2, backend="fma")
    assert repr(WP) == repr(JP)
    with pytest.raises(ValueError, match="forward"):
        WP.reconstruct()
    with pytest.raises(ValueError, match="forward"):
        WP.get_node(0, 0)
    WP.forward(), JP.forward()
    _close(WP.reconstruct(beta=8.0), JP.reconstruct(beta=8.0), F32_RTOL)  # the full cover
    _close(WP.get_node(2, 7), JP.get_node(2, 7), F32_RTOL)
    assert WP.get_node(1, 2, copy=False) is not None and isinstance(WP.get_node(1, 2), np.ndarray)
    for g, wn in zip(WP.costs("l1"), JP.costs("l1")):
        _close(g, wn, COST_RTOL)
    (leaves, _), (jleaves, _) = WP.best_basis("l1"), JP.best_basis("l1")
    assert leaves == jleaves and repr(WP) == repr(JP)
    _close(WP.reconstruct(), JP.reconstruct(), F32_RTOL)
    _close(WP.reconstruct(beta=8.0, mode="hard"), JP.reconstruct(beta=8.0, mode="hard"),
           F32_RTOL)
    V = WaveletPackets(np.zeros((8, 8, 8), np.float32), levels=1, device="cpu")
    assert V.ndim == 3 and WaveletPackets(x[0], levels=1, device="cpu").ndim == 1
    with pytest.raises(ValueError, match="levels"):
        WaveletPackets(x, levels=0, device="cpu")
    with pytest.raises(ValueError, match="ndim"):
        WaveletPackets(x, ndim=4, device="cpu")


@pytest.mark.parametrize("mine,theirs", [(WaveletPackets, JWaveletPackets),
                                         (Starlet, JStarlet), (DualTree, JDualTree)],
                         ids=["WaveletPackets", "Starlet", "DualTree"])
def test_family_facades_take_jax_arguments(mine, theirs):
    """Every public method takes JAX's arguments, ``backend`` included; the
    constructor also takes ``device`` after them."""
    names = {n for n in dir(theirs) if not n.startswith("_") and callable(getattr(theirs, n))}
    assert names == {n for n in dir(mine) if not n.startswith("_")
                     and callable(getattr(mine, n))}
    for name in sorted(names) + ["__init__"]:
        want = [p for p in inspect.signature(getattr(theirs, name)).parameters]
        got = list(inspect.signature(getattr(mine, name)).parameters)
        assert got == want + (["device"] if name == "__init__" else []), name
