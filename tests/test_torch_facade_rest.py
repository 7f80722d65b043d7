"""The rest of the port's facade against the JAX package's: the new
``Wavelets`` methods on the same coefficients, 1D and 2D, DWT and SWT,
exact and under ``bf16-fast``; the Haar butterflies; checkpoints and raw
``.dat`` files across the two packages; the wavelet registry; the demo's
scenarios (4-6 and the prompt since the packet, starlet and dual-tree
families came); and the public names the port still lacks, which must be
exactly the documented deferrals.

The JAX facade is handed the port's coefficients (its ``coeffs`` setter)
so that both act on the same values.  Tolerances: elementwise operators as
in ``tests/test_torch_ops_rest.py`` (float32 within 2 ulps of the largest
output, bf16 within 1 bf16 ulp); images, transforms and ``bayes_shrink``
(whose thresholds come from float32 sums in another order) within 4e-6 of
the largest reference value; norms 1e-5; the estimators 1 float32 ulp.
"""
import copy
import os
import pkgutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdwt_tpu
import pdwt_tpu_torch
from pdwt_tpu import Wavelets as JWavelets
from pdwt_tpu import demo as jdemo
from pdwt_tpu.core import haar as jhaar
from pdwt_tpu.core.separable3d import Coeffs3D as JC3
from pdwt_tpu.filters import MAX_FILTER_WIDTH as JMAX_FILTER_WIDTH
from pdwt_tpu.utils import checkpoint as jckpt
from pdwt_tpu.utils import io as jio
from pdwt_tpu import ops as jops
from pdwt_tpu_torch import (Wavelets, demo, dwt1d, dwt2d, filters, get_wavelet, idwt1d, idwt2d,
                            ops)
from pdwt_tpu_torch.core import haar
from pdwt_tpu_torch.utils import load_coeffs, read_dat, save_coeffs, tensor_to_numpy, write_dat
from test_torch_ops_rest import _f32_ulp, _jax, _leaves, _tree, close_elementwise

RTOL, NORM_RTOL = 4e-6, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    "2d dwt": ((70, 61), dict(wname="db3", levels=3)),
    "2d swt": ((33, 29), dict(wname="db2", levels=2, do_swt=True)),
    "1d dwt": ((4, 97), dict(wname="sym4", levels=3, ndim=1)),
    "1d swt": ((3, 64), dict(wname="db2", levels=2, ndim=1, do_swt=True)),
    "2d dwt bf16": ((64, 48), dict(wname="db2", levels=2, precision="bf16-fast")),
    "2d swt bf16": ((32, 40), dict(wname="db2", levels=2, do_swt=True,
                                   precision="bf16-fast")),
    "1d dwt bf16": ((4, 128), dict(wname="db2", levels=2, ndim=1, precision="bf16-fast")),
}
EXACT = [k for k in CONFIGS if "bf16" not in k]


def _noisy(shape, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(*(np.linspace(0, 3, n) for n in shape), indexing="ij")
    return (80 * np.sin(yy) * np.cos(2 * xx) + 120 + rng.normal(0, 12, shape)).astype(np.float32)


def _pair(name, seed=0):
    """A port facade after forward() and a JAX facade holding the same
    coefficients."""
    shape, kw = CONFIGS[name]
    img = _noisy(shape, seed)
    W = Wavelets(img, device="cpu", **kw)
    J = JWavelets(img, backend="fma", **kw)
    W.forward()
    J.coeffs = _jax(W.coeffs)
    return W, J


def _close(got, want, rtol=RTOL):
    g = tensor_to_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= rtol * np.abs(w).max(), np.abs(g - w).max()


# ---------------------------------------------------------------------------
# the new Wavelets methods
# ---------------------------------------------------------------------------

OPS = {
    "group": lambda F: F.group_soft_threshold(20.0),
    "group normalize app": lambda F: F.group_soft_threshold(20.0, do_thresh_appcoeffs=True,
                                                            normalize=True),
    "firm": lambda F: F.firm_threshold(10.0, 30.0),
    "firm per level app": lambda F: F.firm_threshold([8.0, 10.0, 12.0], [20.0, 25.0, 30.0],
                                                     do_thresh_appcoeffs=True),
    "shrink": lambda F: F.shrink(0.3),
    "shrink details": lambda F: F.shrink(0.3, do_thresh_appcoeffs=False),
    "proj_linf": lambda F: F.proj_linf(15.0),
    "proj_linf details": lambda F: F.proj_linf(15.0, do_thresh_appcoeffs=False),
}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("op", list(OPS))
def test_facade_operators_match_jax(config, op):
    W, J = _pair(config)
    OPS[op](W)
    OPS[op](J)
    assert W.state.value == J.state.value == "W_THRESHOLD"
    close_elementwise(W.coeffs, J.coeffs, "bf16" in config)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_facade_estimators_norms_and_bayes_shrink_match_jax(config):
    W, J = _pair(config, seed=1)
    for name in ("noise_sigma", "universal_threshold"):
        got, want = getattr(W, name)(), getattr(J, name)()
        assert isinstance(got, float) and abs(got - want) <= _f32_ulp(want)
    for app in (False, True):
        got, want = W.norm_l21(app), J.norm_l21(app)
        assert isinstance(got, float) and abs(got - want) <= NORM_RTOL * abs(want)
    # the soft threshold at BayesShrink's thresholds, which differ between
    # the packages by float32 sums (tests/test_torch_ops_rest.py holds
    # them; JAX's facade computes them jitted): each band's outputs may also
    # differ by its thresholds' difference, rounded to the band's dtype
    per_band = lambda t: _leaves(SimpleNamespace(approx=None, details=t))[1:]
    betas = zip(per_band(ops.bayes_thresholds(W.coeffs)),
                per_band(jax.jit(jops.bayes_thresholds)(J.coeffs)), _leaves(W.coeffs)[1:])
    slack = [0.0] + [abs(float(b.to(x.dtype)) - float(torch.tensor(float(jb)).to(x.dtype)))
                     for b, jb, x in betas]
    W.bayes_shrink()
    J.bayes_shrink()
    close_elementwise(W.coeffs, J.coeffs, slack=slack)


@pytest.mark.parametrize("config", EXACT)
@pytest.mark.parametrize("kw", [{}, {"normalize": True, "do_thresh_appcoeffs": True}],
                         ids=["plain", "normalize-app"])
def test_run_denoise_group_matches_jax(config, kw):
    """Never fused; the facade's image and coefficients stay as they were."""
    shape, ckw = CONFIGS[config]
    img = _noisy(shape, seed=2)
    W, J = Wavelets(img, device="cpu", **ckw), JWavelets(img, backend="fma", **ckw)
    out, n1 = W.run_denoise(18.0, mode="group", **kw)
    jout, jn1 = J.run_denoise(18.0, mode="group", **kw)
    _close(out, jout)
    assert abs(float(n1) - float(jn1)) <= NORM_RTOL * abs(float(jn1))
    np.testing.assert_array_equal(W.get_image(), img.reshape(W.get_image().shape))


@pytest.mark.parametrize("config", ["2d dwt", "1d swt", "2d dwt bf16"])
def test_get_and_set_coeff_use_the_flat_numbering(config):
    W, J = _pair(config, seed=3)
    s = W.spec
    count = 1 + (3 if s.ndim == 2 else 1) * s.nlevels
    for num in range(count):
        got, want = W.get_coeff(num), J.get_coeff(num)
        np.testing.assert_array_equal(got, np.asarray(jnp.asarray(want).astype(jnp.float32)))
        t = W.get_coeff(num, copy=False)
        assert isinstance(t, torch.Tensor) and t.device == W.device
        assert str(t.dtype).split(".")[-1] == jnp.dtype(J.get_coeff(num, copy=False).dtype).name
    with pytest.raises(IndexError):
        W.get_coeff(count)
    with pytest.raises(IndexError):
        J.get_coeff(count)
    # set_coeff casts to the band's own dtype (float32 approximation, bf16
    # details under the tier) and shape, as JAX does
    rng = np.random.default_rng(4)
    for num in (0, count - 1, 1):
        new = rng.standard_normal(W.get_coeff(num).size) * 50.0
        W.set_coeff(new, num)
        J.set_coeff(new, num)
    close_elementwise(W.coeffs, J.coeffs)
    W.set_coeff(torch.zeros(W.get_coeff(1).shape), 1)
    assert not W.get_coeff(1).any()
    with pytest.raises(ValueError, match="move it first"):
        W.set_coeff(torch.zeros(1, device="meta"), 0)
    W.inverse()
    with pytest.warns(UserWarning, match="do not make sense"):
        assert W.get_coeff(0) is None


@pytest.mark.parametrize("config", ["2d dwt", "1d dwt"])
def test_circshift_matches_jax(config):
    W, J = _pair(config, seed=5)
    img = W.get_image()
    got = W.circshift(3, -5, inplace=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.circshift(3, -5, inplace=False)))
    np.testing.assert_array_equal(W.get_image(), img)  # untouched
    assert W.circshift(3, -5) is None and J.circshift(3, -5) is None
    np.testing.assert_array_equal(W.get_image(), np.asarray(J.get_image()))
    want = np.roll(img, -5, axis=-1) if W.spec.ndim == 1 else np.roll(img, (3, -5), (0, 1))
    np.testing.assert_array_equal(W.get_image(), want)


@pytest.mark.parametrize("config", ["2d dwt", "1d swt", "2d dwt bf16"])
def test_add_wavelet_matches_jax(config):
    W, J = _pair(config, seed=6)
    W2, J2 = _pair(config, seed=7)
    assert W.add_wavelet(W2, -0.37) == J.add_wavelet(J2, -0.37) == 0
    close_elementwise(W.coeffs, J.coeffs)


def test_add_wavelet_checks_and_return_codes_match_jax():
    img = _noisy((32, 32), seed=8)

    def both(**kw):
        return (Wavelets(img, device="cpu", **kw), JWavelets(img, backend="fma", **kw))

    base = both(wname="db2", levels=2)
    others = {"levels": both(wname="db2", levels=3), "wname": both(wname="db3", levels=2),
              "swt": both(wname="db2", levels=2, do_swt=True),
              "geometry": (Wavelets(img[:, :16], wname="db2", levels=2, device="cpu"),
                           JWavelets(img[:, :16], wname="db2", levels=2, backend="fma"))}
    for key, pair in others.items():
        msgs = []
        for left, right in zip(base, pair):
            with pytest.raises(ValueError) as err:
                left.add_wavelet(right)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], key
    for F in base:
        F.forward()
        F.inverse()
    for left, right in zip(base, both(wname="db2", levels=2)):
        with pytest.warns(UserWarning, match="just been inverted"):
            assert left.add_wavelet(right) == 1
    spin = [both(wname="db2", levels=2, do_cycle_spinning=True, seed=s) for s in (1, 2)]
    for F in (*spin[0], *spin[1]):
        F.forward()
    for left, right in zip(*spin):
        with pytest.raises(ValueError, match="same current shift"):
            left.add_wavelet(right)


def test_copy_is_deep_and_keeps_the_shift_generator():
    img = _noisy((40, 40), seed=9)
    W = Wavelets(img, wname="db2", levels=2, do_cycle_spinning=True, seed=3, device="cpu")
    W.forward()
    for C in (W.copy(), copy.copy(W)):
        before = [t.clone() for t in _leaves(W.coeffs)]
        C.soft_threshold(1e9)
        C.set_image(np.zeros_like(img))
        assert all(torch.equal(a, b) for a, b in zip(_leaves(W.coeffs), before))
        np.testing.assert_array_equal(W.get_image(), img)
    C = W.copy()
    W.forward()
    C.forward()
    assert (W.current_shift_r, W.current_shift_c) == (C.current_shift_r, C.current_shift_c)
    J = JWavelets(img, wname="db2", levels=2, do_cycle_spinning=True, seed=3, backend="fma")
    J.forward()
    J.forward()
    assert (J.current_shift_r, J.current_shift_c) == (W.current_shift_r, W.current_shift_c)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_info_and_print_informations_match_jax(config, capsys):
    """Every field as JAX's but the dtype (torch's) and the device (the
    port's: ``cpu`` here, ``cuda:<card name>`` on the card)."""
    W, J = _pair(config)
    got, want = W.info(), J.info()
    assert got.keys() == want.keys()
    for key in got:
        if key == "dtype":
            assert str(got[key]).split(".")[-1] == jnp.dtype(want[key]).name
        elif key == "device":
            assert got[key] == "cpu"
        else:
            assert got[key] == want[key], key
    W.print_informations()
    mine = capsys.readouterr().out.splitlines()
    J.print_informations()
    theirs = capsys.readouterr().out.splitlines()
    assert mine[-2] == "Running on device : cpu"
    assert mine[:-2] + mine[-1:] == theirs[:-2] + theirs[-1:]


# ---------------------------------------------------------------------------
# Haar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,levels", [((32, 32), 3), ((37, 45), 4), ((2, 17, 23), 2),
                                          ((1, 1), 1)])
def test_haar_butterflies_match_jax_and_the_conv_path_2d(shape, levels):
    x = np.random.default_rng(10).uniform(0, 255, shape).astype(np.float32)
    t = torch.from_numpy(x)
    c = haar.haar_dwt2d(t, levels)
    jc = jhaar.haar_dwt2d(jnp.asarray(x), levels)
    for g, w in zip(_leaves(c), _leaves(jc)):
        _close(g, w)
    for g, w in zip(_leaves(c), _leaves(dwt2d(t, get_wavelet("haar"), levels))):
        _close(g, w)
    y = haar.haar_idwt2d(c, shape[-2:])
    _close(y, jhaar.haar_idwt2d(jc, shape[-2:]))
    _close(y, idwt2d(c, get_wavelet("haar"), shape[-2:]))
    _close(y, x)


@pytest.mark.parametrize("shape,levels", [((3, 64), 4), ((2, 97), 5), ((1, 5), 2)])
def test_haar_butterflies_match_jax_and_the_conv_path_1d(shape, levels):
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x)
    c = haar.haar_dwt1d(t, levels)
    jc = jhaar.haar_dwt1d(jnp.asarray(x), levels)
    for g, w in zip(_leaves(c), _leaves(jc)):
        _close(g, w)
    for g, w in zip(_leaves(c), _leaves(dwt1d(t, get_wavelet("haar"), levels))):
        _close(g, w)
    y = haar.haar_idwt1d(c, shape[-1])
    _close(y, jhaar.haar_idwt1d(jc, shape[-1]))
    _close(y, idwt1d(c, get_wavelet("haar"), shape[-1]))


# ---------------------------------------------------------------------------
# checkpoints, .dat files, the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", ["2d odd", "2d prime swt", "1d odd", "2d bf16", "1d bf16"])
def test_checkpoints_load_across_packages(tree, tmp_path):
    c, j = _tree(tree, seed=13)
    save_coeffs(str(tmp_path / "port.npz"), c)
    jc = jckpt.load_coeffs(str(tmp_path / "port.npz"))
    jckpt.save_coeffs(str(tmp_path / "jax.npz"), j)
    pc = load_coeffs(str(tmp_path / "jax.npz"), device="cpu")
    assert type(pc) is type(c) and type(jc) is type(j)
    for a, b, ja in zip(_leaves(c), _leaves(pc), _leaves(jc)):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert jnp.dtype(ja.dtype).name == str(a.dtype).split(".")[-1]
        np.testing.assert_array_equal(np.asarray(ja).astype(np.float32), tensor_to_numpy(a))
    for a, b in zip(_leaves(c), _leaves(load_coeffs(str(tmp_path / "port.npz"), device="cpu"))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_3d_checkpoint_names_its_roadmap_item(tmp_path):
    """3D checkpoints came with ROADMAP item 12: a JAX-written volume tree
    loads as a ``Coeffs3D`` (``tests/test_torch_3d_rest.py`` crosses them
    both ways)."""
    z = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
    jckpt.save_coeffs(str(tmp_path / "v.npz"), JC3(z, (tuple(z + j for j in range(7)),)))
    c = load_coeffs(str(tmp_path / "v.npz"), device="cpu")
    assert type(c).__name__ == "Coeffs3D" and c.levels == 1 and len(c.details[0]) == 7
    assert [float(b[0, 0, 0]) for b in c.details[0]] == [float(j) for j in range(7)]


def test_dat_files_cross_packages(tmp_path):
    img = _noisy((13, 17), seed=14)
    write_dat(str(tmp_path / "p.dat"), torch.from_numpy(img).numpy())
    np.testing.assert_array_equal(jio.read_dat(str(tmp_path / "p.dat"), (13, 17)), img)
    jio.write_dat(str(tmp_path / "j.dat"), img.astype(np.float64))
    got = read_dat(str(tmp_path / "j.dat"), (13, 17))
    assert got.dtype == np.float32 and np.array_equal(got, img)
    assert read_dat(str(tmp_path / "j.dat")).shape == (13 * 17,)


def test_register_wavelet_and_max_filter_width():
    assert filters.MAX_FILTER_WIDTH == JMAX_FILTER_WIDTH == 40
    f = np.random.default_rng(15).standard_normal((4, 9))
    w = filters.make_custom_wavelet("Torch-Test-Odd9", *f)
    filters.register_wavelet(w)
    assert get_wavelet("TORCH-TEST-ODD9") is w
    assert "torch-test-odd9" in pdwt_tpu_torch.list_wavelets()
    img = _noisy((30, 30), seed=16)
    W = Wavelets(img, wname="torch-test-odd9", levels=1, device="cpu")
    _close(W.forward().approx, dwt2d(torch.from_numpy(img), w, 1).approx)


# ---------------------------------------------------------------------------
# the demo
# ---------------------------------------------------------------------------

DEMO_CASES = [
    ("1", ["--wavelet", "db4", "--levels", "2"]),
    ("2", ["--wavelet", "db4", "--levels", "2"]),
    ("2", []),  # haar, one level: the butterflies in JAX, the conv path here
    ("3", ["--wavelet", "db4", "--levels", "2", "--beta", "30"]),
    ("3", ["--wavelet", "db2", "--levels", "2", "--swt", "--beta", "30"]),
    ("2", ["--wavelet", "db2", "--levels", "2", "--nonseparable"]),
    ("3", ["--wavelet", "db2", "--levels", "2", "--cycle-spinning", "--beta", "30"]),
    ("3", ["--wavelet", "sym4", "--levels", "2", "--auto-beta", "universal"]),
    ("3", ["--wavelet", "sym4", "--levels", "2", "--auto-beta", "bayes"]),
]


@pytest.fixture()
def dat_image(tmp_path):
    img = _noisy((64, 48), seed=17)
    img.tofile(tmp_path / "img.dat")
    return str(tmp_path / "img.dat"), img


@pytest.mark.parametrize("scenario,extra", DEMO_CASES)
def test_demo_scenarios_match_jax(scenario, extra, dat_image, tmp_path, capsys):
    path, img = dat_image
    args = [path, "--nr", "64", "--nc", "48", "--scenario", scenario, *extra]
    assert demo.main(args + ["--out", str(tmp_path / "p.dat"), "--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    assert jdemo.main(args + ["--out", str(tmp_path / "j.dat")]) == 0
    theirs = capsys.readouterr().out
    got, want = (np.fromfile(tmp_path / f, np.float32) for f in ("p.dat", "j.dat"))
    _close(got, want)
    if scenario == "2":
        assert np.abs(got.reshape(64, 48) - img).max() < 1e-3
    last = [line for line in mine.splitlines() if line.startswith(("soft", "BayesShrink"))]
    assert len(last) == (scenario == "3") and (not last or last[0].split()[0] in theirs)


@pytest.mark.parametrize("precision,bound", [("mixed", 2e-2), ("bf16", 5.0)])
def test_demo_precision_flag(precision, bound, dat_image, tmp_path):
    path, img = dat_image
    assert demo.main([path, "--nr", "64", "--nc", "48", "--wavelet", "db2", "--levels", "2",
                      "--precision", precision, "--device", "cpu",
                      "--out", str(tmp_path / "p.dat")]) == 0
    assert np.abs(np.fromfile(tmp_path / "p.dat", np.float32).reshape(64, 48) - img).max() < bound


@pytest.mark.parametrize("extra", [["--scenario", "4", "--wavelet", "db4", "--levels", "2"],
                                   ["--scenario", "4", "--wavelet", "sym4", "--levels", "2",
                                    "--auto-beta", "universal"],
                                   ["--scenario", "5", "--levels", "3"],
                                   ["--scenario", "6", "--levels", "3"]])
def test_demo_scenarios_4_to_6_match_jax(extra, dat_image, tmp_path, capsys):
    """The packet, starlet and dual-tree denoisers: JAX's printed lines and
    its result within RTOL of its largest value."""
    path, img = dat_image
    args = [path, "--nr", "64", "--nc", "48", *extra]
    assert demo.main(args + ["--out", str(tmp_path / "p.dat"), "--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    assert jdemo.main(args + ["--out", str(tmp_path / "j.dat")]) == 0
    theirs = capsys.readouterr().out
    assert mine.replace("p.dat", "j.dat").splitlines()[0] == theirs.splitlines()[0]
    assert len(mine.splitlines()) == len(theirs.splitlines()) == 3
    got, want = (np.fromfile(tmp_path / f, np.float32) for f in ("p.dat", "j.dat"))
    _close(got, want)
    assert np.abs(got.reshape(img.shape) - img).max() > 0


def test_demo_interactive_matches_jax(dat_image, tmp_path, capsys, monkeypatch):
    """The prompt's questions, defaults and "invalid value ... keeping"
    rule, JAX's lines; the answers choose the packet scenario."""
    path, _ = dat_image
    out = {}
    for name, main in (("p", demo.main), ("j", jdemo.main)):
        answers = iter(["4", "db2", "two", "", "1"])
        monkeypatch.setattr("builtins.input", lambda prompt, a=answers: print(prompt) or next(a))
        extra = ["--device", "cpu"] if name == "p" else []
        assert main([path, "--nr", "64", "--nc", "48", "--interactive", "--levels", "2",
                     "--out", str(tmp_path / f"{name}.dat"), *extra]) == 0
        out[name] = capsys.readouterr().out
    assert "invalid value 'two'; keeping 2" in out["p"]
    lines = {n: [ln for ln in t.replace("p.dat", "j.dat").splitlines()
                 if not ln.startswith("max |")] for n, t in out.items()}
    assert lines["p"] == lines["j"]
    _close(*(np.fromfile(tmp_path / f"{n}.dat", np.float32) for n in ("p", "j")))


@pytest.mark.parametrize("extra,message", [(["--mode", "symmetric", "--swt"],
                                            "periodization-only"),
                                           (["--native", "--scenario", "5"],
                                            "needs the JAX engine")])
def test_demo_refuses_what_waits(extra, message, dat_image, capsys):
    with pytest.raises(SystemExit) as err:
        demo.main([dat_image[0], "--nr", "64", "--nc", "48", "--device", "cpu", *extra])
    assert err.value.code == 2 and message in capsys.readouterr().err


def test_demo_runs_as_a_module(dat_image, tmp_path):
    path, img = dat_image
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "pdwt_tpu_torch.demo", path, "--nr", "64",
                           "--nc", "48", "--scenario", "2", "--wavelet", "db4", "--levels", "2",
                           "--device", "cpu", "--out", str(tmp_path / "m.dat")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "max |reconstruction - input|" in proc.stdout
    assert np.abs(np.fromfile(tmp_path / "m.dat", np.float32).reshape(64, 48) - img).max() < 1e-3


# ---------------------------------------------------------------------------
# the public names the port still lacks
# ---------------------------------------------------------------------------

#: every public name of the JAX package that the port lacks, by namespace,
#: with the ROADMAP queue 1 item that brings it: none is left
DEFERRED = {
    "top": {},
    "Wavelets": {},
    "filters": {},
    "ops": {},
    "models": {},
    "core": {},
    "parallel": {},
    "utils": {},
}


def _public(ns, pkg):
    if ns == "top":
        return set(pkg.__all__) | {m.name for m in pkgutil.iter_modules(pkg.__path__)}
    if ns == "Wavelets":
        return {n for n in dir(pkg.Wavelets) if not n.startswith("_")}
    return set(getattr(pkg, ns).__all__)


@pytest.mark.parametrize("ns", list(DEFERRED))
def test_public_names_the_port_lacks_are_the_documented_deferrals(ns):
    lacking = _public(ns, pdwt_tpu) - _public(ns, pdwt_tpu_torch)
    assert lacking == set(DEFERRED[ns])
    if ns == "parallel":
        assert getattr(pdwt_tpu_torch, ns).DEFERRED == DEFERRED[ns]
        for name in DEFERRED[ns]:
            with pytest.raises(NotImplementedError, match=f"item {DEFERRED[ns][name]}"):
                getattr(getattr(pdwt_tpu_torch, ns), name)
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        roadmap = fh.read()
    for name in DEFERRED[ns]:
        assert f"`{name}`" in roadmap, name


def test_facade_methods_take_jax_arguments():
    """Every Wavelets method the port shares with JAX takes its arguments,
    ``backend`` included."""
    import inspect

    for name in _public("Wavelets", pdwt_tpu_torch):
        if isinstance(getattr(Wavelets, name), property):
            continue
        mine, theirs = (inspect.signature(getattr(cls, name))
                        for cls in (Wavelets, JWavelets))
        assert list(theirs.parameters) == list(mine.parameters), name
