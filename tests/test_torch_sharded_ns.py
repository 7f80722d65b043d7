"""The port's sharded non-separable transforms on 4 gloo ranks on the CPU,
against JAX's ``par.dwt2d_ns``/``idwt2d_ns``/``swt2d_ns``/``iswt2d_ns``.

One module-scoped spawn runs every case (``tests/torch_sharded_3d_worker.py``,
suite "ns", port only).  Three quad sets: the rank-2 6 x 6 quads of
``tests/test_parallel.py:243-273`` (the rank-r sum), anisotropic jointly
separable quads (db4 rows, sym4 columns) and db2's isotropic outer
products; two layouts: (row, col) = (2, 2), where the ring ``pad_fn`` runs,
and the batch over ``data_axis`` alone, where each shard is the
single-card call; DWT and SWT, 2 levels, float32 and bf16.

Under the ring both packages run no tier (JAX skips kernels 17-18 under a
``pad_fn``): float32 is held to 1e-5 * max|jax| over a case's outputs, and
bf16, conv passes in bf16 on both sides, to one bf16 ulp of each output's
largest value (XLA's CPU keeps excess precision between the passes' sums,
so a rounding can land one ulp apart).  On the batch axis alone, float32 is
held to JAX's CPU route; bf16 to JAX's TPU route (its conv default set to
"pallas", kernels 17-18 and 1-4 in interpret mode), the route the port
takes, at ``tests/test_torch_sharded.py``'s tier tolerances with JAX's
dtypes.  JAX's CPU route differs there: it runs the conv passes in bf16 and
returns a bf16 approximation (``ROADMAP.md`` §3).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch_sharded_3d_worker as W
from pdwt_tpu import parallel as jpar
from pdwt_tpu.core import conv as jconv
from test_torch_sharded import RTOL, TIER_BF16, _case, _jit, _leaves
from test_torch_sharded_3d import spawn_suite

#: tests/test_torch_sharded.py's float32 tolerance under the bf16 tiers
BF16_TIER_F32 = 2e-3


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    return spawn_suite(tmp_path_factory, "ns")


def _jax_case(quads, layout, dtype, swt, monkeypatch):
    """JAX's sharded forward and inverse of the worker's input, on a mesh
    whose shards have the port's shapes."""
    qf, qi = W.ns_quads()[quads]
    if layout == "ring":
        mesh, axes, x = jpar.make_mesh((2, 2, 2)), dict(row_axis="row", col_axis="col"), \
            W.image(W.NS_IMG, 20)
    else:
        mesh, axes, x = jpar.make_mesh((4, 2), ("data", "x")), dict(data_axis="data"), \
            W.image(W.NS_BATCH, 21)
        if quads != "rank2" or dtype != "bfloat16":
            x = x[:, :32, :32]
        if dtype == "bfloat16":  # JAX's TPU route, the one the port takes
            monkeypatch.setenv("PDWT_PALLAS_INTERPRET", "1")
            monkeypatch.setattr(jconv, "_default_backend", "pallas")
    xx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xs = jpar.shard_image(xx, mesh, **axes)
    if swt:
        c = _jit(lambda v: jpar.swt2d_ns(v, qf, 2, mesh, **axes), xs)
        y = _jit(lambda c: jpar.iswt2d_ns(c, qi, mesh, **axes), c)
    else:
        c = _jit(lambda v: jpar.dwt2d_ns(v, qf, 2, mesh, **axes), xs)
        y = _jit(lambda c: jpar.idwt2d_ns(c, qi, x.shape[-2:], mesh, **axes), c)
    return _leaves(c) + [y]


def _ulp(v: float) -> float:
    """One bf16 ulp at magnitude ``v``."""
    return 2.0 ** (np.floor(np.log2(v)) - 7) if v > 0 else 0.0


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["ring", "data"])
@pytest.mark.parametrize("quads", ["rank2", "aniso", "db2"])
def test_ns_matches_jax_sharded(got, monkeypatch, quads, layout, dtype, swt):
    want = _jax_case(quads, layout, dtype, swt, monkeypatch)
    name = f"{quads}_{layout}_{dtype}_{'swt' if swt else 'dwt'}"
    mine, dts = _case(got, name), str(got[name + "#dtypes"]).split()
    assert len(mine) == len(dts) == len(want)
    tier = layout == "data" and dtype == "bfloat16" and quads != "aniso"
    scale = max(float(jnp.abs(w.astype(jnp.float32)).max()) for w in want)
    for m, dt, w in zip(mine, dts, want):
        wd = jnp.dtype(w.dtype).name
        w = np.asarray(w.astype(jnp.float32))
        assert dt == wd and m.shape == w.shape, (name, dt, wd, m.shape, w.shape)
        err = float(np.abs(m - w).max())
        if tier:
            tol = TIER_BF16 if wd == "bfloat16" else BF16_TIER_F32
            assert err <= tol * float(np.abs(w).max()), (name, wd, err)
        elif wd == "bfloat16":
            assert err <= _ulp(float(np.abs(w).max())), (name, err)
        else:
            assert err <= RTOL * scale, (name, err)


def test_divisibility_error_is_jaxs(got):
    with pytest.raises(ValueError) as e:
        jpar.dwt2d_ns(jnp.zeros((36, 32)), W.rank2_quads(), 2, jpar.make_mesh((2, 2, 2)),
                      row_axis="row", col_axis="col")
    assert str(got["err_row"]) == f"ValueError: {e.value}"
