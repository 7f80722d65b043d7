"""The 2D TI step's fused norm route (``core/separable.py:
_swt2d_denoise_norm1``, kernel 5's norm launches and
``kernels.swt_norm_sum_2d``) on the CPU, against the plain route
(``swt2d`` + ``ops.thresholded_norm1`` + ``iswt2d_denoise``), and the
fallbacks that keep the plain route.

The route takes float32 on the card only (``norm_route``); these tests
open it to CPU tensors (the rule, with the tensor taken as on the card),
where the kernel wrappers run their plain versions: one partial a level
in the first slot of its range.
The coefficients are the same tensors either way, so the denoised output
is equal bit for bit; the norm is summed in another order (a float32 sum
a level, then the levels in float64), so it is held to 2e-6 relative.  On
the card the kernel itself is held to a float64 norm
(``tests/test_torch_cuda.py``)."""
from types import SimpleNamespace

import pytest
import torch

from pdwt_tpu_torch import get_wavelet, iswt2d_denoise, kernels, ops, swt2d
from pdwt_tpu_torch.core import separable
from pdwt_tpu_torch.kernels import swt as S
from pdwt_tpu_torch.models import denoise_step, denoise_step_3d
from pdwt_tpu_torch.utils import profiling

NORM_RTOL = 2e-6


def _img(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * 255


def _on_card(x):
    """What ``norm_route`` reads of ``x``, as if ``x`` were on the card."""
    return SimpleNamespace(is_cuda=True, dtype=x.dtype)


@pytest.fixture
def fused_on_cpu(monkeypatch):
    rule = separable.norm_route
    monkeypatch.setattr(separable, "norm_route", lambda x, backend: rule(_on_card(x), backend))
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _plain_step(x, w, levels, beta, mode, normalize):
    c = swt2d(x, w, levels)
    n1 = ops.thresholded_norm1(c, beta, mode=mode, normalize=normalize)
    return iswt2d_denoise(c, w, beta, mode=mode, normalize=normalize), n1


@pytest.mark.parametrize("beta", [30.0, "tensor"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
def test_denoise_step_through_the_fused_route_matches_the_plain_route(fused_on_cpu, mode,
                                                                     normalize, beta):
    beta = torch.tensor(30.0) if beta == "tensor" else beta
    w = get_wavelet("db4")
    x = _img(2, 24, 40)
    want_out, want_n1 = _plain_step(x, w, 5, beta, mode, normalize)
    with profiling.record_spans():
        out, n1 = denoise_step(x, None, w, 5, beta, swt=True, mode=mode, normalize=normalize)
    assert profiling.NORM_PATHS == {"fused": 1, "plain": 0}
    assert torch.equal(out, want_out)
    assert n1.dtype == torch.float32 and n1.shape == ()
    torch.testing.assert_close(n1, want_n1, rtol=NORM_RTOL, atol=0)


def test_the_fused_entry_gives_the_step_and_the_norm(fused_on_cpu):
    """The denoised image equal to the plain route's, leading dimensions
    kept; the norm's sum under one span of the ops layer, each level's
    kernels once."""
    w = get_wavelet("db7")
    x = _img(2, 3, 37, 53)
    with profiling.record_spans():
        out, n1 = separable._swt2d_denoise_norm1(x, w, 3, 12.0, "soft", False)
    want_out, want_n1 = _plain_step(x, w, 3, 12.0, "soft", False)
    assert out.shape == x.shape and torch.equal(out, want_out)
    torch.testing.assert_close(n1, want_n1, rtol=NORM_RTOL, atol=0)
    table = profiling.span_table()
    assert table["pdwt.ops.thresholded_norm1"]["count"] == 1
    assert table["pdwt.transform._swt2d_denoise_norm1"]["count"] == 1
    assert table["pdwt.kernels.swt_fwd_level_2d"]["count"] == 3
    assert table["pdwt.kernels.swt_norm_sum_2d"]["count"] == 1
    assert table["pdwt.kernels.swt_inv_level_2d"]["count"] == 3


@pytest.mark.parametrize("normalize", [False, True])
def test_each_level_beta_is_made_once_for_both_kernels(fused_on_cpu, monkeypatch, normalize):
    """One beta buffer a level (one for all levels without ``normalize``)
    serves kernel 5's norm and kernel 6's threshold (on the card the plain
    route fills one a level in the inverse alone)."""
    fills = []
    full = torch.full
    monkeypatch.setattr(torch, "full", lambda *a, **k: fills.append(a) or full(*a, **k))
    separable._swt2d_denoise_norm1(_img(2, 16, 24), get_wavelet("db2"), 4, 20.0, "hard",
                                   normalize)
    assert len(fills) == (4 if normalize else 1)


def _boom(*args, **kwargs):
    raise AssertionError("the fused route ran")


FALLBACKS = ["grad_img", "grad_beta", "list_beta", "bf16", "xla", "3d"]


@pytest.mark.parametrize("case", FALLBACKS)
def test_each_fallback_takes_the_plain_route(fused_on_cpu, monkeypatch, case):
    """Autograd wanting the norm, a per-level beta, a bf16 image (the
    tiers), a conv backend and the 3D step keep the plain route: no sum
    kernel, nothing counted as fused, and ``thresholded_norm1`` counted as
    plain where it takes the norm (a list beta thresholds the tree and
    takes ``norm1``)."""
    monkeypatch.setattr(kernels, "swt_norm_sum_2d", _boom)
    w = get_wavelet("db2")
    x, beta, kw, step = _img(2, 16, 24), 20.0, {}, denoise_step
    if case == "grad_img":
        x.requires_grad_(True)
    elif case == "grad_beta":
        beta = torch.tensor(20.0, requires_grad=True)
    elif case == "list_beta":
        beta = [20.0, 10.0]
    elif case == "bf16":
        x = x.to(torch.bfloat16)
    elif case == "xla":
        kw = {"backend": "xla"}
    else:
        x, step = _img(4, 8, 16), denoise_step_3d
    with profiling.record_spans():
        out, n1 = step(x, None, w, 2, beta, swt=True, **kw)
    assert profiling.NORM_PATHS == {"fused": 0, "plain": 0 if case == "list_beta" else 1}
    assert out.shape == x.shape and bool(torch.isfinite(n1))
    if case.startswith("grad"):
        n1.backward()
        leaf = x if case == "grad_img" else beta
        assert leaf.grad is not None


def test_the_route_rule():
    x = _img(8, 8)
    assert not separable.norm_route(x, None)  # a CPU tensor
    meta = torch.empty(1, 8, 8, device="meta")
    assert not separable.norm_route(meta, None)


def test_the_route_rule_on_the_card_types():
    x = _img(8, 8)
    route = separable.norm_route
    assert route(_on_card(x), None) and route(_on_card(x), "pallas")
    assert not route(_on_card(x.to(torch.bfloat16)), None)
    assert not route(_on_card(x.double()), None)
    for backend in ("fma", "xla", "gather"):
        assert not route(_on_card(x), backend)


@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
@pytest.mark.parametrize("approx", [False, True])
def test_the_plain_partials_of_a_norm_launch(mode, approx):
    w = get_wavelet("db3")
    x = _img(2, 16, 24)
    partials = torch.full((S.swt_norm_slots(2, 16, 24, w.hlen, 2),), 7.0)
    bands = S.swt_fwd_level_2d(x, w.dec_lo, w.dec_hi, 2,
                               norm=(mode, torch.tensor([15.0]), partials, approx))
    for got, ref in zip(bands, S.swt_fwd_level_2d_ref(x, w.dec_lo, w.dec_hi, 2)):
        assert torch.equal(got, ref)
    want = sum(ops.norms.thresholded_l1(t, 15.0, mode) for t in bands[1:])
    if approx:
        want = want + bands[0].abs().sum()
    assert float(partials[0]) == float(want) and not bool(partials[1:].any())
    assert float(S.swt_norm_sum_2d(partials)) == pytest.approx(float(want), rel=1e-7)


def test_norm_launches_refuse_a_mode_they_do_not_take():
    w = get_wavelet("db2")
    x = _img(1, 8, 8)
    with pytest.raises(ValueError, match="norm mode"):
        S.swt_fwd_level_2d(x, w.dec_lo, w.dec_hi, 1, norm=("group", 1.0, torch.zeros(4), False))


def test_no_level_takes_the_plain_route(fused_on_cpu):
    w = get_wavelet("db2")
    assert separable._swt2d_denoise_norm1(_img(8, 8), w, 0, 1.0, "soft", False) is None
