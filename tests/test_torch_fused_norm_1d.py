"""The batched 1D step's fused threshold and norm (``core/separable.py:
_dwt1d_denoise_norm1``, kernel 7's norm launches and
``kernels.swt_norm_sum_2d``, then ``ops.norms.add_approx_norm1``) on the
CPU, against the plain route (``dwt1d``, the threshold ops, ``norm1``,
``idwt1d``), the fallbacks that keep the plain route and the
``DENOISE_PATHS`` counter (its reader's tests are the benchmark's,
``wavebench/tests/test_wavebench_denoise_fused_share.py``).

The route takes float32 on the card only (``norm_route``); these tests
open it to CPU tensors (the rule, with the tensor taken as on the card),
where ``fwd_level_1d_norm`` runs its plain version: the high
band thresholded by the threshold ops, one partial a level.  The denoised signals are then equal bit for bit; the
norm is summed in another order (a float32 sum a level, the levels in
float64, then the approximation's), so it is held to 2e-6 relative.  On
the card the kernel itself is held to the plain route
(``tests/test_torch_cuda.py``)."""
from types import SimpleNamespace

import pytest
import torch

from pdwt_tpu_torch import Wavelets, dwt1d, get_wavelet, idwt1d, kernels, ops
from pdwt_tpu_torch.core import separable
from pdwt_tpu_torch.core.precision import precision_scope
from pdwt_tpu_torch.filters import make_custom_wavelet
from pdwt_tpu_torch.kernels import batched1d as K1
from pdwt_tpu_torch.ops.threshold import THR_ELEM, THRESHOLD_OPS
from pdwt_tpu_torch.utils import profiling

NORM_RTOL = 2e-6


def _signals(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g)


def _on_card(x):
    """What ``norm_route`` reads of ``x``, as if ``x`` were on the card."""
    return SimpleNamespace(is_cuda=True, dtype=x.dtype)


@pytest.fixture
def clean():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture
def fused_on_cpu(monkeypatch, clean):
    rule = separable.norm_route
    monkeypatch.setattr(separable, "norm_route", lambda x, backend: rule(_on_card(x), backend))


def _wavelet(name):
    if name == "odd5":  # an odd-length custom bank
        g = torch.Generator().manual_seed(5)
        return make_custom_wavelet("odd5", *torch.randn((4, 5), generator=g,
                                                        dtype=torch.float64).numpy())
    return get_wavelet(name)


def _plain_step(x, w, levels, beta, mode, normalize, do_thresh_appcoeffs=False):
    c = THRESHOLD_OPS[mode](dwt1d(x, w, levels), beta, normalize=normalize,
                            do_thresh_appcoeffs=do_thresh_appcoeffs)
    return idwt1d(c, w, x.shape[-1]), ops.norm1(c)


# ---------------------------------------------------------------------------
# kernel 7's norm launch, plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [0.2, "tensor"])
@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
def test_the_plain_version_of_a_norm_launch(mode, beta):
    """The low band as the plain launch's, the high band thresholded by the
    threshold ops, and one float32 partial: the thresholded L1 norm of the
    high band."""
    beta = torch.tensor([0.2]) if beta == "tensor" else beta
    w = get_wavelet("sym8")
    x = _signals(5, 64) - 0.5
    lo, hi, partials = K1.fwd_level_1d_norm(x, w.dec_lo, w.dec_hi, norm=(mode, beta))
    rlo, rhi = K1.fwd_level_1d_ref(x, w.dec_lo, w.dec_hi)
    assert torch.equal(lo, rlo) and torch.equal(hi, THR_ELEM[mode](rhi, beta))
    want = ops.norms.thresholded_l1(rhi, beta, mode)
    assert partials.shape == (1,) and partials.dtype == torch.float32
    assert float(partials[0]) == float(want)
    assert float(partials[0]) == pytest.approx(float(hi.abs().sum()), rel=1e-6)
    assert float(kernels.swt_norm_sum_2d(partials)) == pytest.approx(float(want), rel=1e-7)


def test_norm_launches_refuse_a_mode_they_do_not_take():
    w = get_wavelet("db2")
    with pytest.raises(ValueError, match="norm mode"):
        K1.fwd_level_1d_norm(_signals(2, 16), w.dec_lo, w.dec_hi, norm=("group", 1.0))


# ---------------------------------------------------------------------------
# the route, through the facade and alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dta", [False, True])
@pytest.mark.parametrize("beta", [0.3, "tensor"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("mode", ["soft", "hard", "garrote"])
def test_run_denoise_through_the_fused_route_matches_the_plain_route(fused_on_cpu, mode,
                                                                    normalize, beta, dta):
    beta = torch.tensor(0.3) if beta == "tensor" else beta
    w = get_wavelet("sym8")
    x = _signals(33, 1000)
    want_out, want_n1 = _plain_step(x, w, 4, beta, mode, normalize, dta)
    W = Wavelets(x, wname="sym8", levels=4, ndim=1, device="cpu")
    with profiling.record_spans():
        out, n1 = W.run_denoise(beta, mode=mode, normalize=normalize, do_thresh_appcoeffs=dta)
    assert profiling.DENOISE_PATHS == {"fused": 1, "plain": 0}
    assert profiling.NORM_PATHS == {"fused": 1, "plain": 0}
    assert torch.equal(out, want_out)
    assert n1.dtype == torch.float32 and n1.shape == ()
    torch.testing.assert_close(n1, want_n1, rtol=NORM_RTOL, atol=0)


@pytest.mark.parametrize("wname,shape,levels", [("sym8", (4096,), 4), ("db7", (2, 3, 1000), 4),
                                                ("odd5", (7, 250), 3), ("haar", (1, 64), 6)])
def test_the_fused_entry_gives_the_tree_and_the_details_norm(fused_on_cpu, wname, shape, levels):
    """Leading dimensions kept, odd levels extended as ``dwt1d`` extends
    them; the details thresholded, the approximation as it is; the norm of
    the details under one span of the ops layer, each level's kernel
    once."""
    w = _wavelet(wname)
    x = _signals(*shape)
    with profiling.record_spans():
        c, n = separable._dwt1d_denoise_norm1(x, w, levels, 0.2, "soft", False)
    want = ops.soft_threshold(dwt1d(x, w, levels), 0.2)
    assert torch.equal(c.approx, want.approx)
    assert len(c.details) == levels
    assert all(torch.equal(d, e) for d, e in zip(c.details, want.details))
    want_n = sum(float(d.abs().double().sum()) for d in want.details)
    assert float(n) == pytest.approx(want_n, rel=NORM_RTOL)
    table = profiling.span_table()
    assert table["pdwt.transform._dwt1d_denoise_norm1"]["count"] == 1
    assert table["pdwt.kernels.fwd_level_1d_norm"]["count"] == levels
    assert "pdwt.kernels.fwd_level_1d" not in table
    assert table["pdwt.kernels.swt_norm_sum_2d"]["count"] == 1
    assert table["pdwt.ops.thresholded_norm1"]["count"] == 1


def test_the_ops_layer_reads_the_approximation_alone(fused_on_cpu):
    """The fused step's ops bytes: the details' norm, the approximation and
    the norm returned (the approximation returned is the one taken), not
    the tree."""
    x = _signals(3, 256)
    W = Wavelets(x, wname="sym8", levels=4, ndim=1, device="cpu")
    with profiling.record_spans():
        _, n1 = W.run_denoise(0.1)
    assert profiling.OPS_OPERAND_BYTES == {"add_approx_norm1": 4 + 3 * 16 * 4 + 4}


@pytest.mark.parametrize("normalize", [False, True])
def test_each_level_beta_is_made_once(fused_on_cpu, monkeypatch, normalize):
    fills = []
    full = torch.full
    monkeypatch.setattr(torch, "full", lambda *a, **k: fills.append(a) or full(*a, **k))
    separable._dwt1d_denoise_norm1(_signals(2, 256), get_wavelet("db2"), 4, 0.2, "hard",
                                   normalize)
    assert len(fills) == (4 if normalize else 1)


FALLBACKS = ["cpu", "bf16", "mixed", "xla", "grad_x", "grad_beta", "list_beta", "beta_shape",
             "group", "firm", "no_level"]


@pytest.mark.parametrize("case", FALLBACKS)
def test_each_fallback_takes_the_plain_route(monkeypatch, clean, case):
    """CPU tensors, a bf16 signal (the tiers), ``mixed``, a conv backend,
    autograd wanting a gradient, a per-level or many-element beta, the
    group and firm thresholds and no level: None, so the caller takes the
    plain route."""
    if case != "cpu":
        rule = separable.norm_route
        monkeypatch.setattr(separable, "norm_route",
                            lambda x, backend: rule(_on_card(x), backend))
    w = get_wavelet("db2")
    x, beta, mode, backend, levels, tier = _signals(4, 64), 0.2, "soft", None, 3, None
    if case == "bf16":
        x = x.to(torch.bfloat16)
    elif case == "mixed":
        tier = "mixed"
    elif case == "xla":
        backend = "xla"
    elif case == "grad_x":
        x.requires_grad_(True)
    elif case == "grad_beta":
        beta = torch.tensor(0.2, requires_grad=True)
    elif case == "list_beta":
        beta = [0.2, 0.1, 0.05]
    elif case == "beta_shape":
        beta = torch.tensor([0.2, 0.1])
    elif case in ("group", "firm"):
        mode = case
    else:
        levels = 0
    with precision_scope(tier):
        assert separable._dwt1d_denoise_norm1(x, w, levels, beta, mode, False, backend) is None


def test_the_facade_keeps_the_plain_route_off_the_card(clean):
    x = _signals(5, 128)
    want_out, want_n1 = _plain_step(x, get_wavelet("sym8"), 3, 0.1, "soft", False)
    with profiling.record_spans():
        out, n1 = Wavelets(x, wname="sym8", levels=3, ndim=1, device="cpu").run_denoise(0.1)
    assert profiling.DENOISE_PATHS == {"fused": 0, "plain": 1}
    assert profiling.NORM_PATHS == {"fused": 0, "plain": 0}
    assert torch.equal(out, want_out) and torch.equal(n1, want_n1)


# ---------------------------------------------------------------------------
# DENOISE_PATHS
# ---------------------------------------------------------------------------

ROUTES = [("1d fused", True), ("1d plain", False), ("1d group", False), ("1d swt", False),
          ("2d swt", True), ("2d swt list beta", False), ("2d swt group", False),
          ("2d swt xla", False), ("2d dwt", False), ("3d swt", True)]


@pytest.mark.parametrize("route,fused", ROUTES)
def test_denoise_paths_count_each_call_by_where_the_threshold_ran(monkeypatch, clean, route,
                                                                  fused):
    """Once a ``run_denoise`` call while the recorder is on: "fused" for
    kernel 7's norm launches and for the thresholding SWT syntheses, "plain"
    where the threshold ops run; nothing with the recorder off."""
    if route == "1d fused":
        rule = separable.norm_route
        monkeypatch.setattr(separable, "norm_route",
                            lambda x, backend: rule(_on_card(x), backend))
    kw, beta, mode = {}, 2.0, "soft"
    if route.startswith("1d"):
        img, kw = _signals(3, 64), {"ndim": 1, "do_swt": route == "1d swt"}
    elif route.startswith("3d"):
        img, kw = _signals(8, 16, 16), {"do_swt": True}
    else:
        img, kw = _signals(16, 24), {"do_swt": "swt" in route}
    if route.endswith("group"):
        mode = "group"
    if route.endswith("list beta"):
        beta = [2.0, 1.0]
    if route.endswith("xla"):
        kw["backend"] = "xla"
    W = Wavelets(img, wname="haar" if route.startswith("3d") else "db2", levels=2, device="cpu",
                 **kw)
    W.run_denoise(beta, mode=mode)
    assert profiling.DENOISE_PATHS == {"fused": 0, "plain": 0}
    with profiling.record_spans():
        W.run_denoise(beta, mode=mode)
    assert profiling.DENOISE_PATHS == {"fused": int(fused), "plain": int(not fused)}
    profiling.reset_spans()
    assert profiling.DENOISE_PATHS == {"fused": 0, "plain": 0}

