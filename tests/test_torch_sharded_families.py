"""The port's sharded fully separable, starlet and packet transforms on 4
gloo ranks on the CPU, against the JAX package's ``parallel.fs_dwt``/
``fs_idwt``, ``starlet``/``istarlet`` and ``parallel.packets`` on 8 virtual
CPU devices.

One module-scoped spawn runs every case (``tests/torch_sharded_3d_worker.py``,
suite "families", port only).  The port's meshes are (data, row, col) = (1, 2,
2) and (data, col) = (2, 2); JAX's is (2, 2, 2), the batch over ``data``
where the input has one: the shards differ, the global results do not.
Each float32 case is held to JAX's sharded call and, where JAX has one, to
its single-device call, within 1e-5 * max|jax| over the case's outputs
(the port runs the padded kernels' plain versions, JAX its conv passes,
the same sums in another order).  The bf16 cases (``bf16-fast``) are held
to the port's own single-device call on the same image, at
``tests/test_torch_sharded.py``'s bf16-fast tolerances (a level's route may
differ between a shard and the whole image).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch_sharded_3d_worker as W
from pdwt_tpu import parallel as jpar
from pdwt_tpu.core import anisotropic as jA
from pdwt_tpu.core import packets as jPK
from pdwt_tpu.core.starlet import istarlet as j_istarlet
from pdwt_tpu.core.starlet import starlet as j_starlet
from pdwt_tpu.filters import get_wavelet
from pdwt_tpu.parallel import packets as jPP
from test_torch_sharded import TIER_BF16, TIER_F32, _case, _close, _jit, _leaves
from test_torch_sharded_3d import spawn_suite

AXES = dict(data_axis="data", row_axis="row", col_axis="col")


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    return spawn_suite(tmp_path_factory, "families")


@pytest.fixture(scope="module")
def mesh():
    return jpar.make_mesh((2, 2, 2), ("data", "row", "col"))


def _dtypes(got, name):
    return str(got[name + "#dtypes"]).split()


FS = {"22": (W.FS_IMG, (2, 1), ("row", "col"), "db4", 30, AXES),
      "none_col": (W.FS_ODD, (1, 2), (None, "col"), "db3", 31,
                   dict(data_axis="data", col_axis="col"))}


@pytest.mark.parametrize("tag", list(FS), ids=["row2_col2", "rows_odd_unsharded_col2"])
def test_fs_matches_jax_sharded_and_single_device(got, mesh, tag):
    """fs_dwt and fs_idwt on (row, col) = (2, 2), levels (2, 1), db4; and
    with 45 unsharded rows, the columns over col, levels (1, 2), db3."""
    shape, lv, axes, wname, seed, place = FS[tag]
    w, x = get_wavelet(wname), W.image(shape, seed)
    xs = jpar.shard_image(x, mesh, **place)
    y = _jit(lambda v: jpar.fs_dwt(v, w, lv, mesh, axes=axes, data_axis="data"), xs)
    r = _jit(lambda c: jpar.fs_idwt(c, w, shape[-2:], lv, mesh, axes=axes, data_axis="data"), y)
    name = f"fs_{tag}"
    assert _dtypes(got, name) == ["float32", "float32"]
    _close(_case(got, name), [y, r])
    ys = _jit(lambda v: jA.fs_dwt(v, w, lv), jnp.asarray(x))
    _close(_case(got, name)[:1], [ys])
    assert float(np.abs(_case(got, name)[1] - x).max()) <= 1e-3


@pytest.mark.parametrize("tag,gathers", [("22", "2 2"), ("none_col", "1 1")])
def test_fs_relayout_costs_one_all_gather_a_sharded_pass(got, tag, gathers):
    """The pack and the unpack of each sharded pass: one all-gather each
    (forward, inverse); an unsharded axis none."""
    assert str(got[f"fs_{tag}_gathers"]) == gathers


def test_fs_bf16_fast_matches_the_single_device_call(got):
    """A bf16 image under bf16-fast: the packed result is float32 (the
    float32 approximation and the bf16 details promote, as in JAX)."""
    sh, one = _case(got, "fs_bf16")
    assert _dtypes(got, "fs_bf16") == ["float32", "float32"] and sh.shape == one.shape
    assert float(np.abs(sh - one).max()) <= TIER_F32["bf16-fast"] * float(np.abs(one).max())


@pytest.mark.parametrize("gen", [2, 1])
def test_starlet_2d_matches_jax_sharded_and_single_device(got, mesh, gen):
    x = W.image(W.ST_IMG, 32)
    xs = jpar.shard_image(x, mesh, **AXES)
    kw = dict(data_axis="data", spatial_axes=("row", "col"), gen=gen)
    c = _jit(lambda v: jpar.starlet(v, 3, mesh, **kw), xs)
    y = _jit(lambda c: jpar.istarlet(c, mesh, **kw), c)
    name = f"starlet2d_gen{gen}"
    _close(_case(got, name), _leaves(c) + [y])
    cs = _jit(lambda v: j_starlet(v, 3, ndim=2, gen=gen, backend="fma"), jnp.asarray(x))
    ys = _jit(lambda c: j_istarlet(c, ndim=2, gen=gen, backend="fma"), cs)
    _close(_case(got, name), _leaves(cs) + [ys])


def test_starlet_1d_matches_jax_sharded(got, mesh):
    """Signals over (data, col): the one spatial axis is the lane axis."""
    s = W.image(W.ST_SIG, 33)
    ss = jpar.shard_image(s, mesh, data_axis="data", col_axis="col")
    kw = dict(data_axis="data", spatial_axes=("col",))
    c = _jit(lambda v: jpar.starlet(v, 3, mesh, **kw), ss)
    y = _jit(lambda c: jpar.istarlet(c, mesh, **kw), c)
    _close(_case(got, "starlet1d"), _leaves(c) + [y])


def _leaf_list(got, name):
    return [tuple(int(v) for v in row) for row in _case(got, name)]


def test_wp2d_and_reconstructions_match_jax_sharded(got, mesh):
    """The 2-level db3 tree of a batch of two 64 x 128 images, the
    shannon cover's reconstruction plain and with a soft map_fn on the
    details, and the full inverse."""
    w, x = get_wavelet("db3"), W.image(W.WP_IMG, 34)
    xs = jpar.shard_image(x, mesh, **AXES)
    pk = _jit(lambda v: jPP.wp2d(v, w, 2, mesh, **AXES), xs)
    leaves = _leaf_list(got, "wp2d_leaves")
    assert leaves == list(jPK.best_basis(pk, "shannon")[0])
    soft = lambda v, j, i: v if i == 0 else jnp.sign(v) * jnp.maximum(jnp.abs(v) - 20.0, 0.0)
    r0 = _jit(lambda p: jPP.wp_reconstruct(p, leaves, w, mesh, **AXES), pk)
    r1 = _jit(lambda p: jPP.wp_reconstruct(p, leaves, w, mesh, map_fn=soft, **AXES), pk)
    full = _jit(lambda n: jPP.iwp2d(n, w, W.WP_IMG[-2:], mesh, **AXES), pk.nodes[-1])
    _close(_case(got, "wp2d"), list(pk.nodes) + [r0, r1, full])
    ref = _jit(lambda v: jPK.wp2d(v, w, 2), jnp.asarray(x))
    _close(_case(got, "wp2d")[:3], list(ref.nodes))


def test_wp2d_bf16_fast_matches_the_single_device_call(got):
    """Every node and the full inverse stay bf16 (the A-chain cast to the
    details' dtype at every depth, as JAX casts it)."""
    mine, one = _case(got, "wp2d_bf16"), _case(got, "wp2d_bf16_one")
    assert _dtypes(got, "wp2d_bf16") == ["bfloat16"] * 4
    for m, o in zip(mine, one):
        assert m.shape == o.shape
        assert float(np.abs(m - o).max()) <= TIER_BF16 * float(np.abs(o).max())


def test_wp1d_matches_jax_sharded(got, mesh):
    w, s = get_wavelet("db2"), W.image(W.WP_SIG, 35)
    ax = dict(data_axis="data", col_axis="col")
    ss = jpar.shard_image(s, mesh, **ax)
    pk = _jit(lambda v: jPP.wp1d(v, w, 3, mesh, **ax), ss)
    y = _jit(lambda n: jPP.iwp1d(n, w, W.WP_SIG[-1], mesh, **ax), pk.nodes[-1])
    _close(_case(got, "wp1d"), list(pk.nodes) + [y])


def test_wp3d_matches_jax_sharded(got, mesh):
    """A 16 x 32 x 64 volume over the (row, col) rings, the depth local:
    the octree, the l1 cover's reconstruction, the full inverse."""
    w, v = get_wavelet("db2"), W.image(W.WP_VOL, 36)
    ax = dict(row_axis="row", col_axis="col")
    vs = jpar.shard_image(v, mesh, **ax)
    pk = _jit(lambda t: jPP.wp3d(t, w, 2, mesh, **ax), vs)
    leaves = _leaf_list(got, "wp3d_leaves")
    r = _jit(lambda p: jPP.wp_reconstruct(p, leaves, w, mesh, **ax), pk)
    full = _jit(lambda n: jPP.iwp3d(n, w, W.WP_VOL, mesh, **ax), pk.nodes[-1])
    _close(_case(got, "wp3d"), list(pk.nodes) + [r, full])


def test_wp3d_over_depth_and_rows_matches_jax_sharded(got, mesh):
    """The same volume over (dep, row) = (2, 2): each depth's single-level
    3D DWT runs the depth ring."""
    w, v = get_wavelet("db2"), W.image(W.WP_VOL, 36)
    ax = dict(dep_axis="data", row_axis="row")
    vs = jpar.shard_image(v, mesh, **ax)
    pk = _jit(lambda t: jPP.wp3d(t, w, 2, mesh, **ax), vs)
    full = _jit(lambda n: jPP.iwp3d(n, w, W.WP_VOL, mesh, **ax), pk.nodes[-1])
    _close(_case(got, "wp3d_dep"), list(pk.nodes) + [full])


@pytest.mark.parametrize("name,call", [
    ("err_fs_div", lambda m: jpar.fs_dwt(jnp.zeros((2, 60, 128)), get_wavelet("db4"), (2, 1), m,
                                         axes=("row", "col"))),
    ("err_fs_batch", lambda m: jpar.fs_dwt(jnp.zeros((64, 128)), get_wavelet("db4"), (1, 1), m,
                                           axes=("row", "col"), data_axis="data")),
    ("err_fs_axes", lambda m: jpar.fs_dwt(jnp.zeros((64, 128)), get_wavelet("db4"), (1, 1, 1),
                                          m, axes=("row", "col"))),
    ("err_starlet_div", lambda m: jpar.starlet(jnp.zeros((2, 63, 64)), 2, m,
                                               spatial_axes=("row", "col"))),
    ("err_starlet_batch", lambda m: jpar.starlet(jnp.zeros((3, 64)), 2, m, data_axis="data",
                                                 spatial_axes=("col",))),
    ("err_wp2d_div", lambda m: jPP.wp2d(jnp.zeros((2, 60, 128)), get_wavelet("db3"), 2, m,
                                        row_axis="row", col_axis="col")),
])
def test_errors_are_jaxs(got, mesh, name, call):
    """The port raises JAX's ValueError, with JAX's message, before any
    exchange."""
    with pytest.raises(ValueError) as e:
        call(mesh)
    assert str(got[name]) == f"ValueError: {e.value}"


def test_jax_side_is_float32():
    """The comparisons above run JAX in float32 (conftest turns on x64)."""
    assert jnp.asarray(W.image((2, 2), 0)).dtype == jnp.float32
    assert jax.config.jax_enable_x64
