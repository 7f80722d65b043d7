"""The port's sharded volume transforms and ``sharded_denoise_step_3d`` on 4
gloo ranks on the CPU, against the JAX package; and the ring depth product
against its plain versions in one process.

One module-scoped ``torch.multiprocessing`` spawn runs every case
(``tests/torch_sharded_3d_worker.py``, which imports the port only), as
``tests/test_torch_sharded.py`` does.  The port's meshes are (data, dep, row,
col) = (1, 2, 2, 1) and (1, 4, 1, 1); JAX's are 8 virtual CPU devices whose
shards have the same shapes, (2, 2, 2) with the depth over ``data`` and
(4, 2) with the depth over ``dep`` (the other axes replicate).  Each exact
case is held to JAX's ``par.dwt3d``/``idwt3d``/``swt3d``/``iswt3d`` and to
JAX's single-device ``separable3d`` within 1e-5 * max|jax| over its
outputs, float32 (float64 for the odd-length bank, whose levels run the conv
passes with the ring); the port runs the padded kernels' plain versions and
the ring depth product, JAX its conv passes, the same sums in another
order.  The tier cases are held to JAX's sharded Pallas path in interpret
mode, at ``tests/test_torch_sharded.py``'s tier tolerances, with JAX's
dtypes.
"""
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax.numpy as jnp
import torch_sharded_3d_worker as W
from pdwt_tpu import parallel as jpar
from pdwt_tpu.core import precision as jprec
from pdwt_tpu.core import separable3d as jsep3
from pdwt_tpu.filters import get_wavelet, make_custom_wavelet
from pdwt_tpu.models.denoiser import sharded_denoise_step_3d
from pdwt_tpu_torch.core import conv, depth_matmul
from pdwt_tpu_torch.filters import get_wavelet as tget_wavelet
from test_torch_sharded import RTOL, SWT_F32, TIER_F32, _case, _close, _jit, _leaves, _tier_close

#: seconds the ranks may take together (about 25 on one core)
RANKS_TIMEOUT_S = 240
AX22 = dict(dep_axis="data", row_axis="row")


def spawn_suite(tmp_path_factory, suite: str) -> dict:
    """Run ``suite`` of the worker on 4 spawned gloo ranks; its saved
    results.  A rank that fails or hangs fails the module's tests."""
    d = tmp_path_factory.mktemp(suite)
    ctx = mp.spawn(W.run, args=(str(d / "store"), str(d), suite), nprocs=W.WORLD, join=False)
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ctx.join(timeout=1):  # raises if a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the sharded ranks did not finish in {RANKS_TIMEOUT_S} s")
    with np.load(d / f"{suite}.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    return spawn_suite(tmp_path_factory, "3d")


def _jax_mesh(tag):
    """JAX's mesh and axes whose shards match the port's mesh ``tag``."""
    if tag == "22":
        return jpar.make_mesh((2, 2, 2)), AX22
    return jpar.make_mesh((4, 2), ("dep", "x")), dict(dep_axis="dep")


def _dtypes_f32(got, name):
    assert set(str(got[name + "#dtypes"]).split()) == {"float32"}


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
@pytest.mark.parametrize("tag", ["22", "4"], ids=["dep2_row2", "dep4_multihop"])
def test_volume_matches_jax_sharded_and_single_device(got, tag, swt):
    """16 x 32 x 32, db4, 2 levels: on (dep, row) = (2, 2), and on dep = 4,
    whose 4-plane shards take level 2's halos in several hops (the SWT's is
    (8 - 1) * 2 = 14 planes)."""
    w, x = get_wavelet("db4"), W.image(W.VOL, 10)
    mesh, axes = _jax_mesh(tag)
    xs = jpar.shard_image(x, mesh, **axes)
    c = _jit(lambda v: jpar.dwt3d(v, w, 2, mesh, swt=swt, **axes), xs)
    y = _jit(lambda c: jpar.idwt3d(c, w, W.VOL, mesh, swt=swt, **axes), c)
    name = f"{'swt' if swt else 'dwt'}_{tag}"
    _dtypes_f32(got, name)
    _close(_case(got, name), _leaves(c) + [y])
    cs = _jit(lambda v: (jsep3.swt3d if swt else jsep3.dwt3d)(v, w, 2), jnp.asarray(x))
    ys = _jit(lambda c: jsep3.iswt3d(c, w) if swt else jsep3.idwt3d(c, w, W.VOL), cs)
    _close(_case(got, name), _leaves(cs) + [ys])


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_odd_bank_float64_conv_route_matches_jax(got, swt):
    w = make_custom_wavelet("odd5", *W.ODD5)
    x = jnp.asarray(W.image(W.VOL, 10).astype(np.float64))
    c = _jit(lambda v: (jsep3.swt3d if swt else jsep3.dwt3d)(v, w, 2), x)
    _close(_case(got, f"odd_{'swt' if swt else 'dwt'}"), _leaves(c), np.float64)


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_batch_over_data_depth_unsharded_matches_jax(got, swt):
    """Four 8 x 16 x 32 volumes over (data, col) = (2, 2), the depth
    unsharded (its pass the local wrap)."""
    w, x = get_wavelet("db4"), W.image((4, 8, 16, 32), 11)
    mesh = jpar.make_mesh((2, 2, 2))
    axes = dict(data_axis="data", col_axis="col")
    xs = jpar.shard_image(x, mesh, dep_axis=None, **axes)
    c = _jit(lambda v: jpar.dwt3d(v, w, 2, mesh, swt=swt, **axes), xs)
    y = _jit(lambda c: jpar.idwt3d(c, w, (8, 16, 32), mesh, swt=swt, **axes), c)
    name = f"batch_{'swt' if swt else 'dwt'}"
    _dtypes_f32(got, name)
    _close(_case(got, name), _leaves(c) + [y])


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_sharded_denoise_step_3d_matches_jax(got, swt):
    x = W.image(W.VOL, 10)
    mesh = jpar.make_mesh((2, 2, 2))
    xs = jpar.shard_image(x, mesh, **AX22)
    out, n1 = _jit(lambda v: sharded_denoise_step_3d(v, "db4", 2, 10.0, mesh, swt=swt, **AX22),
                   xs)
    name = f"step_{'swt' if swt else 'dwt'}"
    _dtypes_f32(got, name)
    den, norm = _case(got, name)
    _close([den], [out])
    assert norm.shape == () and abs(float(norm) - float(n1)) <= RTOL * abs(float(n1))


@pytest.fixture
def _pallas(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")
    for knob in ("PDWT_TPU_PRECISION", "PDWT_TPU_BF16_ACCURACY", "PDWT_TPU_BF16_L1FWD",
                 "PDWT_TPU_BF16_L1INV", "PDWT_TPU_SWT_BF16_SCHEME", "PDWT_TPU_MXU_TILES"):
        monkeypatch.delenv(knob, raising=False)


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
@pytest.mark.parametrize("tier", ["bf16-fast", "mixed"])
def test_tier_volume_matches_jax_sharded_pallas(got, _pallas, tier, swt):
    """8 x 128 x 512 on (dep, row) = (2, 2): level 1 of the DWT on the
    banded-product padded kernels 11 and 12, level 2 on 1 and 2; the bf16
    SWT's both levels on 13 and 14, the ``mixed`` SWT exact; JAX's sharded
    Pallas path on the same shards.  The dtype contract: float32
    approximation, bf16 details (``daa`` included), bf16 output."""
    w, x = get_wavelet("db4"), W.image(W.TIER_VOL, 12)
    mesh = jpar.make_mesh((2, 2, 2))
    xx = jnp.asarray(x)
    xx = xx.astype(jnp.bfloat16) if tier.startswith("bf16") else xx
    with jprec.precision_scope(tier):
        xs = jpar.shard_image(xx, mesh, **AX22)
        c = _jit(lambda v: jpar.dwt3d(v, w, 2, mesh, swt=swt, backend="pallas", **AX22), xs)
        y = _jit(lambda c: jpar.idwt3d(c, w, W.TIER_VOL, mesh, swt=swt, backend="pallas",
                                       **AX22), c)
    name = f"tier_{'swt' if swt else 'dwt'}_{tier}"
    _tier_close(got, name, _leaves(c) + [y], SWT_F32 if swt else TIER_F32[tier])
    if tier.startswith("bf16"):
        assert str(got[name + "#dtypes"]).split() == ["float32"] + ["bfloat16"] * 15


def test_tier_step_3d_matches_jax_sharded_pallas(got, _pallas):
    """``sharded_denoise_step_3d(swt=True)`` on the bf16 volume under
    bf16-fast: the image bf16, the norm float32."""
    x = W.image(W.TIER_VOL, 12)
    mesh = jpar.make_mesh((2, 2, 2))
    with jprec.precision_scope("bf16-fast"):
        xs = jpar.shard_image(jnp.asarray(x).astype(jnp.bfloat16), mesh, **AX22)
        out, n1 = _jit(lambda v: sharded_denoise_step_3d(v, "db4", 2, 10.0, mesh, swt=True,
                                                         backend="pallas", **AX22), xs)
    _tier_close(got, "tier_step_bf16-fast", [out, n1], SWT_F32)


def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return f"ValueError: {e.value}"


def test_divisibility_and_rank_errors_are_jaxs(got):
    """The port raises JAX's ValueError, with JAX's message, on meshes of
    the port's shapes, before any exchange."""
    w = get_wavelet("db4")
    m222, (m4, ax4) = jpar.make_mesh((2, 2, 2)), _jax_mesh("4")
    axb = dict(data_axis="data", col_axis="col")
    want = {
        "err_depth": lambda: jpar.dwt3d(jnp.zeros((12, 32, 32)), w, 2, m222, **AX22),
        "err_depth_swt": lambda: jpar.swt3d(jnp.zeros((6, 32, 32)), w, 2, m4, **ax4),
        "err_rank": lambda: jpar.dwt3d(jnp.zeros((32, 32)), w, 1, m222, **AX22),
        "err_batch": lambda: jpar.dwt3d(jnp.zeros((16, 32, 32)), w, 1, m222, **axb),
        "err_inverse": lambda: jpar.idwt3d(
            jpar.dwt3d(jnp.zeros(W.VOL, jnp.float32), w, 1, m222, **AX22), w, (18, 32, 32),
            m222, **AX22),
    }
    for name, call in want.items():
        assert str(got[name]) == _jax_error(call), name


# ---------------------------------------------------------------------------
# the ring depth product against its plain versions, one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [16, 7])
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("decimate", [True, False], ids=["decimated", "atrous"])
def test_ring_depth_product_matches_conv_and_dense(decimate, level, depth):
    """``depth_analysis_ring`` and ``depth_synthesis_ring`` with
    ``pad_fn=wrap_pad`` (one shard's ring) against the conv passes along
    depth (JAX's fma formulation) and the dense periodic product, on the
    same volume: the decimated pass at level L on depth >> (L - 1) planes,
    the a-trous pass at dilation 2^(L-1) (level 3 of db4 reads 28 planes
    past a 16-plane axis)."""
    w = tget_wavelet("db4")
    d = max(depth >> (level - 1), 2) if decimate else depth
    x = torch.from_numpy(np.random.default_rng(level).uniform(0, 255, (2, d, 5, 6))
                         .astype(np.float32))
    dil = 1 if decimate else 1 << (level - 1)
    kw = dict(dilation=dil, decimate=decimate)
    dec = (w.dec_lo, w.dec_hi)
    got = depth_matmul.depth_analysis_ring(x, dec, pad_fn=conv.wrap_pad, **kw)
    for want in (conv.analysis_pass(x[:, None], dec, axis=-3, **kw),
                 depth_matmul.depth_analysis_mm(x, dec, **kw)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    rec = (w.rec_lo, w.rec_hi) if decimate else (w.rec_lo * 0.5, w.rec_hi * 0.5)
    skw = dict(out_len=d, dilation=dil, decimated=decimate)
    bands = [got[:, 0], got[:, 1]]
    syn = depth_matmul.depth_synthesis_ring(bands, rec, pad_fn=conv.wrap_pad, **skw)
    for want in (conv.synthesis_pass(got, rec, axis=-3, **skw)[:, 0],
                 depth_matmul.depth_synthesis_mm(bands, rec, **skw)):
        assert syn.shape == want.shape
        assert float((syn - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((syn - x).abs().max()) <= 1e-3  # the pair inverts on [0, 255]
