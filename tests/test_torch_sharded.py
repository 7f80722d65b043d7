"""The port's sharded 2D and 1D transforms and ``sharded_denoise_step``
on 4 gloo ranks on the CPU, against the JAX package.

One module-scoped ``torch.multiprocessing`` spawn runs every case
(``tests/torch_sharded_worker.py``, which imports the port only) over a
``FileStore`` under the test's temporary directory, and rank 0 saves the
gathered results.  Each is held to JAX's single-device transform of the
same seeded input, as JAX's own sharded tests hold JAX's
(``tests/test_parallel.py:38-56``); the 2D DWT also to JAX's ``par.dwt2d``
on its 8-device virtual mesh, and the denoising step to JAX's
``sharded_denoise_step`` there.  Tolerance: max|port - jax| <= 1e-5 *
max|jax| over a case's outputs in float32 (the norm 1e-5 relative); the
port's sharded levels run the padded kernels' plain versions, JAX's CPU
route its conv passes, the same sums in float32.  The float64 cases run
the conv passes with the ring on both sides.  The JAX references run under
``jax.jit`` (op by op, its fma passes take seconds a case).
"""
import time

import numpy as np
import pytest
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
import torch_sharded_worker as W
from pdwt_tpu import parallel as jpar
from pdwt_tpu.core import precision as jprec
from pdwt_tpu.core import separable as jsep
from pdwt_tpu.filters import get_wavelet, make_custom_wavelet
from pdwt_tpu.models.denoiser import sharded_denoise_step

RTOL = 1e-5


#: seconds the ranks may take together (about 8 on one core)
RANKS_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    ctx = mp.spawn(W.run, args=(str(d / "store"), str(d)), nprocs=W.WORLD, join=False)
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ctx.join(timeout=1):  # raises if a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the sharded ranks did not finish in {RANKS_TIMEOUT_S} s")
    with np.load(d / "sharded.npz") as z:
        return {k: z[k] for k in z.files}


def _case(got, name):
    return [got[f"{name}/{k}"] for k in range(sum(k.startswith(name + "/") for k in got))]


def _leaves(c):
    return [c.approx] + [t for band in c.details
                         for t in (band if isinstance(band, tuple) else (band,))]


def _jit(fn, *args):
    return jax.jit(fn)(*args)


def _close(mine, want, dtype=np.float32):
    want = [np.asarray(w) for w in want]
    assert len(mine) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    for m, w in zip(mine, want):
        assert m.shape == w.shape and m.dtype == w.dtype == dtype
        assert float(np.abs(m - w).max()) <= RTOL * scale


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_2d_db7_matches_jax(got, swt):
    w, x = get_wavelet("db7"), jnp.asarray(W.image((64, 64), 0))
    c = _jit(lambda v: (jsep.swt2d if swt else jsep.dwt2d)(v, w, 3), x)
    y = _jit(lambda c: jsep.iswt2d(c, w) if swt else jsep.idwt2d(c, w, (64, 64)), c)
    _close(_case(got, f"2d_{'swt' if swt else 'dwt'}"), _leaves(c) + [y])


def test_2d_dwt_matches_jax_sharded_on_its_mesh(got):
    """JAX's own sharded DWT, on (data, row, col) = (2, 2, 2) virtual CPU
    devices of a batch of two copies of the image."""
    w, x = get_wavelet("db7"), W.image((64, 64), 0)
    mesh = jpar.make_mesh((2, 2, 2))
    axes = dict(data_axis="data", row_axis="row", col_axis="col")
    xs = jpar.shard_image(np.stack([x, x]), mesh, **axes)
    c = _jit(lambda v: jpar.dwt2d(v, w, 3, mesh, **axes), xs)
    y = _jit(lambda c: jpar.idwt2d(c, w, (64, 64), mesh, **axes), c)
    _close(_case(got, "2d_dwt"), [t[0] for t in _leaves(c)] + [y[0]])


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_sharded_denoise_step_matches_jax(got, swt):
    x = W.image((64, 64), 0)
    mesh = jpar.make_mesh((2, 2, 2))
    axes = dict(data_axis="data", row_axis="row", col_axis="col")
    xs = jpar.shard_image(np.stack([x, x]), mesh, **axes)
    out, n1 = _jit(lambda v: sharded_denoise_step(v, "db7", 3, 10.0, mesh, swt=swt, **axes), xs)
    den, norm = _case(got, f"step_{'swt' if swt else 'dwt'}")
    _close([den], [out[0]])
    assert norm.shape == () and norm.dtype == np.float32
    assert abs(float(norm) - float(n1) / 2) <= RTOL * abs(float(n1) / 2)


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_2d_float64_conv_route_matches_jax(got, swt):
    w, x = get_wavelet("db7"), jnp.asarray(W.image((64, 64), 0).astype(np.float64))
    c = _jit(lambda v: (jsep.swt2d if swt else jsep.dwt2d)(v, w, 3), x)
    y = _jit(lambda c: jsep.iswt2d(c, w) if swt else jsep.idwt2d(c, w, (64, 64)), c)
    _close(_case(got, f"f64_{'swt' if swt else 'dwt'}"), _leaves(c) + [y], np.float64)


def test_odd_filter_conv_route_matches_jax(got):
    w = make_custom_wavelet("odd5", *W.ODD5)
    x = jnp.asarray(W.image((64, 64), 0))
    _close(_case(got, "odd_filter"), _leaves(_jit(lambda v: jsep.swt2d(v, w, 2), x))
           + _leaves(_jit(lambda v: jsep.dwt2d(v, w, 2), x)))


def test_odd_unsharded_axis_matches_jax(got):
    w, x = get_wavelet("db4"), jnp.asarray(W.image((2, 63, 64), 1))
    c = _jit(lambda v: jsep.dwt2d(v, w, 2), x)
    _close(_case(got, "odd_rows"), _leaves(c) + [_jit(lambda c: jsep.idwt2d(c, w, (63, 64)), c)])


def test_batch_over_data_matches_jax(got):
    w, x = get_wavelet("db4"), jnp.asarray(W.image((4, 32, 32), 2))
    c = _jit(lambda v: jsep.swt2d(v, w, 2), x)
    _close(_case(got, "batch_swt"), _leaves(c) + [_jit(lambda c: jsep.iswt2d(c, w), c)])


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
def test_1d_sym8_matches_jax(got, swt):
    w, x = get_wavelet("sym8"), jnp.asarray(W.image((4, 256), 3))
    c = _jit(lambda v: (jsep.swt1d if swt else jsep.dwt1d)(v, w, 4), x)
    y = _jit(lambda c: jsep.iswt1d(c, w) if swt else jsep.idwt1d(c, w, 256), c)
    _close(_case(got, f"1d_{'swt' if swt else 'dwt'}"), _leaves(c) + [y])


@pytest.mark.parametrize("n", [256, 128])
def test_halo_wider_than_a_shard_matches_jax(got, n):
    """Level 5 of sym8 (a span of 15 * 16 = 240) over 4 shards of n / 4
    samples: two hops a side, or four, the last back to the shard itself."""
    w, x = get_wavelet("sym8"), jnp.asarray(W.image((8, n), 4))
    c = _jit(lambda v: jsep.swt1d(v, w, 5), x)
    _close(_case(got, f"wide_halo_{n}"), _leaves(c) + [_jit(lambda c: jsep.iswt1d(c, w), c)])


@pytest.mark.parametrize("name,call", [
    ("err_row", lambda m, w: jpar.dwt2d(jnp.zeros((60, 64)), w["db7"], 3, m,
                                        row_axis="row", col_axis="col")),
    ("err_col_swt", lambda m, w: jpar.swt2d(jnp.zeros((64, 65)), w["db7"], 2, m,
                                            row_axis="row", col_axis="col")),
    ("err_signal", lambda m, w: jpar.dwt1d(jnp.zeros((4, 100)), w["sym8"], 4,
                                           jpar.make_mesh((2, 4), ("data", "col")),
                                           col_axis="col")),
    ("err_batch", lambda m, w: jpar.dwt2d(jnp.zeros((3, 32, 32)), w["db4"], 1, m,
                                          data_axis="data", row_axis="row", col_axis="col")),
])
def test_divisibility_errors_are_jaxs(got, name, call):
    """The port raises JAX's ValueError, with JAX's message, on meshes of
    the port's shapes (2 x 2 for the 2D cases, 4 for the signal, a data
    axis of 2), before any exchange."""
    ws = {n: get_wavelet(n) for n in ("db7", "sym8", "db4")}
    with pytest.raises(ValueError) as e:
        call(jpar.make_mesh((2, 2, 2)), ws)
    assert str(got[name]) == f"ValueError: {e.value}"


@pytest.mark.parametrize("name", ["err_bf16", "err_mixed"])
def test_mxu_modes_raise_naming_the_next_slice(got, name):
    """The MXU modes (a bf16 input; float32 under ``mixed``) raised until
    the slice that named them (ROADMAP queue 2, part A2, row 6) came: the
    same calls now run the tier route and raise nothing."""
    assert str(got[name]) == "no error"


def test_bf16_halos_cross_gloo_byte_for_byte(got):
    """A bf16 level exchanges bf16 halos: gloo's send and receive (staged
    through the host for card tensors) carry them bit for bit, on every
    rank."""
    assert got["bf16_halo/0"].tolist() == [1]


# ---------------------------------------------------------------------------
# the precision tiers on the shards, against JAX's sharded Pallas path
# ---------------------------------------------------------------------------

TIERED = ("mixed", "bf16-fast", "bf16-balanced", "bf16-accurate")
#: tests/test_torch_precision.py's tolerances, max|port - jax| relative to
#: max|jax| per output: bf16-stored 2^-7; float32-stored 2e-3 under the
#: schemes whose 2D passes round their row-pass result to bf16 (b1, b2f:
#: the decimated level 1 of bf16-fast and bf16-balanced, every a-trous
#: level of the bf16 rungs, which run b1/fd or b2f), 1e-4 under b3 (mixed,
#: the decimated level 1 of bf16-accurate)
TIER_F32 = {"mixed": 1e-4, "bf16-fast": 2e-3, "bf16-balanced": 2e-3, "bf16-accurate": 1e-4}
SWT_F32 = 2e-3
TIER_BF16 = 2.0 ** -7


def _tier_close(got, name, want, f32_tol):
    """A tier case against JAX: each output of JAX's dtype and shape,
    float32 ones within ``f32_tol``, bf16 ones within 2^-7."""
    mine, dts = _case(got, name), str(got[name + "#dtypes"]).split()
    assert len(mine) == len(dts) == len(want)
    for m, dt, w in zip(mine, dts, want):
        wd = jnp.dtype(w.dtype).name
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        assert dt == wd and m.shape == w.shape, (name, dt, wd, m.shape, w.shape)
        tol = TIER_BF16 if wd == "bfloat16" else f32_tol
        err = float(np.abs(m - w).max()) / float(np.abs(w).max())
        assert err <= tol, (name, wd, err)


@pytest.fixture
def _pallas(monkeypatch):
    monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")
    for knob in ("PDWT_TPU_PRECISION", "PDWT_TPU_BF16_ACCURACY", "PDWT_TPU_BF16_L1FWD",
                 "PDWT_TPU_BF16_L1INV", "PDWT_TPU_SWT_BF16_SCHEME", "PDWT_TPU_MXU_TILES"):
        monkeypatch.delenv(knob, raising=False)


@pytest.mark.parametrize("tier", TIERED)
def test_tier_2d_dwt_matches_jax_sharded(got, _pallas, tier):
    """The 2D DWT of 128 x 512, 2 levels, on 64 x 256 shards: level 1 on
    the banded-product padded kernels 11 and 12, level 2 on 1 and 2 (its
    32 x 128 image has 16 x 64 subbands), on both sides."""
    w, x = get_wavelet("db7"), W.image((128, 512), 6)
    mesh = jpar.make_mesh((2, 2, 2))
    axes = dict(data_axis="data", row_axis="row", col_axis="col", backend="pallas")
    xx = jnp.asarray(np.stack([x, x]))
    xx = xx.astype(jnp.bfloat16) if tier.startswith("bf16-") else xx
    with jprec.precision_scope(tier):
        xs = jpar.shard_image(xx, mesh, data_axis="data", row_axis="row", col_axis="col")
        c = _jit(lambda v: jpar.dwt2d(v, w, 2, mesh, **axes), xs)
        y = _jit(lambda c: jpar.idwt2d(c, w, (128, 512), mesh, **axes), c)
    _tier_close(got, f"tier_dwt2d_{tier}", [t[0] for t in _leaves(c)] + [y[0]], TIER_F32[tier])


@pytest.mark.parametrize("tier", ["bf16-fast", "bf16-accurate"])
def test_tier_2d_swt_and_ti_step_match_jax_sharded(got, _pallas, tier):
    """The 2D SWT of a bf16 128 x 512 image, 2 levels (both banded on the
    shards: kernels 13 and 14), its inverse, and
    ``sharded_denoise_step(swt=True)`` (soft, beta 10): the image, and the
    norm, float32 on both sides (JAX's sums both copies)."""
    w, x = get_wavelet("db7"), W.image((128, 512), 6)
    mesh = jpar.make_mesh((2, 2, 2))
    axes = dict(data_axis="data", row_axis="row", col_axis="col")
    xx = jnp.asarray(np.stack([x, x])).astype(jnp.bfloat16)
    with jprec.precision_scope(tier):
        xs = jpar.shard_image(xx, mesh, **axes)
        c = _jit(lambda v: jpar.swt2d(v, w, 2, mesh, backend="pallas", **axes), xs)
        y = _jit(lambda c: jpar.iswt2d(c, w, (128, 512), mesh, backend="pallas", **axes), c)
        out, n1 = _jit(lambda v: sharded_denoise_step(v, "db7", 2, 10.0, mesh, swt=True,
                                                      backend="pallas", **axes), xs)
    _tier_close(got, f"tier_swt2d_{tier}", [t[0] for t in _leaves(c)] + [y[0]], SWT_F32)
    assert jnp.dtype(n1.dtype).name == "float32"
    _tier_close(got, f"tier_step_{tier}", [out[0], n1 / 2], SWT_F32)


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
@pytest.mark.parametrize("tier", TIERED)
def test_tier_1d_matches_jax_sharded(got, _pallas, tier, swt):
    """The 1D DWT and SWT of 16 x 1024 (sym8, 3 levels) on 16 x 256
    shards: the DWT's level 1 banded (kernels 15 and 16), 2 and 3 exact;
    every SWT level banded under the bf16 tiers, exact under ``mixed``."""
    w, s = get_wavelet("sym8"), W.image((16, 1024), 7)
    mesh = jpar.make_mesh((2, 4), ("data", "col"))
    axes = dict(data_axis="data", col_axis="col")
    ss = jnp.asarray(np.concatenate([s, s]))
    ss = ss.astype(jnp.bfloat16) if tier.startswith("bf16-") else ss
    with jprec.precision_scope(tier):
        xs = jpar.shard_image(ss, mesh, **axes)
        c = _jit(lambda v: jpar.dwt1d(v, w, 3, mesh, swt=swt, backend="pallas", **axes), xs)
        y = _jit(lambda c: jpar.idwt1d(c, w, 1024, mesh, swt=swt, backend="pallas", **axes), c)
    _tier_close(got, f"tier_{'swt' if swt else 'dwt'}1d_{tier}",
                [t[:16] for t in _leaves(c)] + [y[:16]], TIER_F32[tier])
