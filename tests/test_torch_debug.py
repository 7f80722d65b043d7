"""The port's sanitizers (``utils/debug.py``) against the JAX package's on
the CPU: ``assert_finite`` eagerly and under ``checked`` raises a
``ValueError`` with JAX's text on both sides (JAX's ``JaxRuntimeError``
from ``checkify``, the port's ``CheckError``), naming the first bad leaf
in JAX's leaf order; ``validate_coeffs`` raises JAX's messages on 1D, 2D
and 3D trees.  Inputs are made from a seed with numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdwt_tpu.core import separable as jsep
from pdwt_tpu.core import separable3d as jsep3
from pdwt_tpu.filters import get_wavelet as jget
from pdwt_tpu.utils import debug as JD
from pdwt_tpu_torch import dwt1d, dwt2d, dwt3d, swt2d
from pdwt_tpu_torch.core.separable import Coeffs1D, Coeffs2D
from pdwt_tpu_torch.core.separable3d import Coeffs3D
from pdwt_tpu_torch.filters import get_wavelet
from pdwt_tpu_torch.utils import debug as TD

NAN, INF = float("nan"), float("inf")


def _trees(bad: float, where: int):
    """The same tree for both sides: a tuple of (a list and a dict), with
    ``bad`` at leaf ``where`` in JAX's leaf order (dicts by sorted key)."""
    vals = [np.arange(4, dtype=np.float32) + k for k in range(4)]
    if where >= 0:
        vals[where][1] = bad
    build = lambda f: ([f(vals[0]), f(vals[1])], {"a": f(vals[2]), "b": f(vals[3])})
    return build(jnp.asarray), build(torch.from_numpy)


def _err(fn):
    """The ValueError's text, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("bad,where", [(NAN, 0), (INF, 2), (-INF, 3), (NAN, 1)])
@pytest.mark.parametrize("wrapped", [False, True], ids=["eager", "checked"])
def test_assert_finite_raises_jaxs_valueerror(bad, where, wrapped):
    jt, tt = _trees(bad, where)
    if wrapped:
        jfn = JD.checked(lambda t: (JD.assert_finite(t, "coeffs"), t)[1])
        tfn = TD.checked(lambda t: (TD.assert_finite(t, "coeffs"), t)[1])
    else:
        jfn = lambda t: JD.assert_finite(t, "coeffs")
        tfn = lambda t: TD.assert_finite(t, "coeffs")
    want, got = _err(lambda: jfn(jt)), _err(lambda: tfn(tt))
    assert want is not None and got == want
    assert got == f"coeffs: leaf {where} contains NaN/Inf (`check` failed)"


def test_first_bad_leaf_is_named_and_clean_trees_pass():
    jt, tt = _trees(NAN, -1)
    assert _err(lambda: JD.assert_finite(jt)) is None
    assert _err(lambda: TD.assert_finite(tt)) is None
    f = TD.checked(lambda t, k=2: [x * k for x in t[0]])
    assert [v.tolist() for v in f(tt)] == [[0.0, 2.0, 4.0, 6.0], [2.0, 4.0, 6.0, 8.0]]
    tt[0][1][0] = INF
    tt[1]["b"][3] = NAN
    with pytest.raises(TD.CheckError, match="value: leaf 1 contains"):
        TD.assert_finite(tt)
    TD.assert_finite(None)
    TD.assert_finite(())


def test_assert_finite_on_a_coefficient_tree():
    """A Coeffs2D's leaves in JAX's order: the approximation, then H, V, D
    of each level."""
    x = np.random.default_rng(0).uniform(0, 255, (32, 32)).astype(np.float32)
    c = dwt2d(torch.from_numpy(x), get_wavelet("db2"), 2)
    jc = jsep.dwt2d(jnp.asarray(x), jget("db2"), 2)
    TD.assert_finite(c, "c")
    c.details[1][2][0, 0] = NAN
    jc = jsep.Coeffs2D(jc.approx, (jc.details[0], (*jc.details[1][:2],
                                                   jc.details[1][2].at[0, 0].set(jnp.nan))))
    assert _err(lambda: TD.assert_finite(c, "c")) == _err(lambda: JD.assert_finite(jc, "c"))


def _cases():
    x1 = np.random.default_rng(1).standard_normal((2, 50)).astype(np.float32)
    x2 = np.random.default_rng(2).standard_normal((37, 30)).astype(np.float32)
    x3 = np.random.default_rng(3).standard_normal((9, 12, 16)).astype(np.float32)
    w, jw = get_wavelet("db2"), jget("db2")
    return [
        ("1d", dwt1d(torch.from_numpy(x1), w, 3), jsep.dwt1d(jnp.asarray(x1), jw, 3),
         (50,), {}),
        ("2d", dwt2d(torch.from_numpy(x2), w, 2), jsep.dwt2d(jnp.asarray(x2), jw, 2),
         (37, 30), {}),
        ("2d_swt", swt2d(torch.from_numpy(x2), w, 2), jsep.swt2d(jnp.asarray(x2), jw, 2),
         (37, 30), {"swt": True}),
        ("3d", dwt3d(torch.from_numpy(x3), w, 2), jsep3.dwt3d(jnp.asarray(x3), jw, 2),
         (12, 16), {"nd": 9}),
    ]


def _verdict(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "ok"


def _damage(c, kind, how):
    """``c`` with one band cut short (``how``) in the port's or JAX's types."""
    if how == "ok":
        return c
    if how == "approx":
        return type(c)(c.approx[..., :-1], c.details)
    lvl = len(c.details) - 1
    if kind == "1d":
        dets = list(c.details)
        dets[lvl] = dets[lvl][..., :-1]
        return type(c)(c.approx, tuple(dets))
    band = list(c.details[lvl])
    if how == "bands":  # a 3D level with a band missing
        band = band[:-1]
    else:
        band[-1] = band[-1][..., :-1, :]
    return type(c)(c.approx, tuple(c.details[:lvl]) + (tuple(band),))


KINDS = ("1d", "2d", "2d_swt", "3d")
DAMAGE = [(k, h) for k in range(4) for h in ("ok", "approx", "detail", "levels")] + [
    (3, "bands"), (3, "no_nd")]


@pytest.mark.parametrize("case,how", DAMAGE, ids=[f"{KINDS[k]}-{h}" for k, h in DAMAGE])
def test_validate_coeffs_messages_are_jaxs(case, how):
    kind, c, jc, shape, kw = _cases()[case]
    kw = dict(kw)
    if how == "levels":
        kw["levels"] = 3 if c.levels != 3 else 2
    if how == "no_nd":
        kw.pop("nd")
    got = _verdict(lambda: TD.validate_coeffs(_damage(c, kind, how), *shape, **kw))
    want = _verdict(lambda: JD.validate_coeffs(_damage(jc, kind, how), *shape, **kw))
    assert got == want
    assert (got == "ok") == (how == "ok")


def test_port_containers_are_validated_by_type():
    assert issubclass(TD.CheckError, ValueError)
    c = Coeffs1D(torch.zeros(2, 13), (torch.zeros(2, 13),))
    TD.validate_coeffs(c, 26)
    c3 = Coeffs3D(torch.zeros(4, 4, 4), (tuple(torch.zeros(4, 4, 4) for _ in range(7)),))
    TD.validate_coeffs(c3, 8, 8, nd=8)
    assert isinstance(Coeffs2D(torch.zeros(1), ()), tuple)
