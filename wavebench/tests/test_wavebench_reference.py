"""The reference's frozen taps against the Daubechies conditions, its
passes against their algebra, and each operation on the program's CPU path
against the reference at a tiny size."""
import math

import pytest
import torch
from tiny_cells import TINY, tiny_cell

from wavebench import harness, inputs
from wavebench.reference import transforms as R


@pytest.mark.parametrize("name,n", [("db4", 4), ("db7", 7)])
def test_taps_are_daubechies(name, n):
    dec_lo, dec_hi = R.orthogonal_bank(name)
    h = torch.tensor(dec_lo, dtype=torch.float64)
    assert len(h) == 2 * n
    assert abs(float(h.sum()) - math.sqrt(2)) < 1e-12
    for m in range(n):  # orthonormal under even shifts
        assert abs(float((h[2 * m:] * h[:len(h) - 2 * m]).sum()) - (m == 0)) < 1e-11
    g = torch.tensor(dec_hi, dtype=torch.float64)
    k = torch.arange(len(g), dtype=torch.float64)
    for p in range(n):  # n vanishing moments of the high-pass
        assert abs(float((g * k ** p).sum())) < 1e-8 * (len(g) ** p)
    assert abs(float((g * h).sum())) < 1e-12


def test_taps_match_the_program_bank():
    from pdwt_tpu_torch.filters import get_wavelet

    for name in ("db4", "db7"):
        dec_lo, dec_hi = R.orthogonal_bank(name)
        w = get_wavelet(name)
        assert max(abs(a - b) for a, b in zip(dec_lo, w.dec_lo)) < 1e-11
        assert max(abs(a - b) for a, b in zip(dec_hi, w.dec_hi)) < 1e-11


@pytest.mark.parametrize("decimate,dilation", [(True, 1), (False, 1), (False, 4)])
def test_pass_matrix_algebra(decimate, dilation):
    m = R.pass_matrix(R.orthogonal_bank("db7"), 32, dilation, decimate, torch.float64, "cpu")
    gram = m.T @ m if decimate else m @ m.T
    assert torch.allclose(gram, (1 if decimate else 2) * torch.eye(32, dtype=torch.float64),
                          atol=1e-11)


@pytest.mark.parametrize("ndim,levels", [(2, 3), (3, 2)])
def test_roundtrips_reconstruct(ndim, levels):
    p = R.Passes("db4", torch.float64, "cpu")
    x = torch.rand((2,) + (16,) * ndim, dtype=torch.float64)
    assert torch.allclose(R.idwt(p, *R.dwt(p, x, levels, ndim), ndim), x, atol=1e-11)
    assert torch.allclose(R.iswt_soft(p, *R.swt(p, x, levels, ndim), ndim, 0.0), x, atol=1e-11)


@pytest.mark.parametrize("name", sorted(TINY))
def test_program_cpu_path_matches_reference(name):
    import pdwt_tpu_torch as P

    spec = harness.Spec(name, cell=tiny_cell(name))
    cell, cfg = spec.cell, spec.config
    x = inputs.make(cell["input"], cell["shape"], cfg["ndim"], inputs.generator(7, "cpu"), "cpu")
    got = spec.op.check(spec.op.program_call(P, cfg, cell)(x), x, cfg, cell)
    assert set(got) == set(spec.op.CHECKS)
    for n in spec.op.CHECKS:
        assert got[n] <= cell["limits"][n] / 4, (n, got[n])


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_in_float64_checks_exactly(name):
    spec = harness.Spec(name, cell=tiny_cell(name))
    cell, cfg = spec.cell, spec.config
    x = inputs.make(cell["input"], cell["shape"], cfg["ndim"], inputs.generator(8, "cpu"), "cpu")
    got = spec.op.check(spec.op.reference_call(cfg, cell, torch.float64, "cpu")(x), x, cfg, cell)
    assert all(v < 1e-13 for v in got.values()), got


def test_inputs_repeat_by_seed():
    spec = {"kind": "phantom", "low": 0, "high": 255, "ellipsoids": 4, "noise_sigma": 1.0}
    make = lambda s: inputs.make(spec, (2, 16, 16), 2, inputs.generator(s, "cpu"), "cpu")
    assert torch.equal(make(3000000001), make(3000000001))
    assert not torch.equal(make(3000000001), make(3000000002))
    assert make(2 ** 70 + 5).shape == (2, 16, 16)
