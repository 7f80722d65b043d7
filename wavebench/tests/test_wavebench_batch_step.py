"""The cell ``sym8_1d.batch_step``: sym8's frozen taps against the
Daubechies conditions and the program's bank, the reference's 1D roundtrip,
the operation on the program's CPU path at a tiny size, planted faults that
must come out not correct, the work counts, the two ops-layer readers
(``ops_gb``, ``ops_roofline_share``), and on the card the TF32 control."""
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

import pdwt_tpu_torch as P
from wavebench import harness, inputs, program_spans
from wavebench.reference import transforms as R

NAME = "sym8_1d.batch_step"
#: the cell at a size the CPU runs in a moment: 8 signals of 256 samples
TINY = {"shape": [8, 256], "levels": 4}


def tiny_spec() -> harness.Spec:
    return harness.Spec(NAME, cell=dict(harness.load_json(
        os.path.join(harness.HERE, "workloads", f"{NAME}.json")), **TINY))


def test_sym8_taps_are_daubechies():
    n = 8
    dec_lo, dec_hi = R.orthogonal_bank("sym8")
    h = torch.tensor(dec_lo, dtype=torch.float64)
    assert len(h) == 2 * n
    assert abs(float(h.sum()) - math.sqrt(2)) < 1e-12
    for m in range(n):  # orthonormal under even shifts
        assert abs(float((h[2 * m:] * h[:len(h) - 2 * m]).sum()) - (m == 0)) < 1e-11
    g = torch.tensor(dec_hi, dtype=torch.float64)
    k = torch.arange(len(g), dtype=torch.float64)
    for p in range(n):  # eight vanishing moments of the high-pass
        assert abs(float((g * k ** p).sum())) < 1e-8 * (len(g) ** p)
    assert abs(float((g * h).sum())) < 1e-12


def test_sym8_taps_match_the_program_bank():
    dec_lo, dec_hi = R.orthogonal_bank("sym8")
    w = P.get_wavelet("sym8")
    assert max(abs(a - b) for a, b in zip(dec_lo, w.dec_lo)) < 1e-11
    assert max(abs(a - b) for a, b in zip(dec_hi, w.dec_hi)) < 1e-11


def test_reference_1d_roundtrip_reconstructs():
    p = R.Passes("sym8", torch.float64, "cpu")
    x = torch.rand((3, 256), dtype=torch.float64)
    a, details = R.dwt(p, x, 4, 1)
    assert a.shape == (3, 16) and [b[0].shape[-1] for b in details] == [128, 64, 32, 16]
    assert torch.allclose(R.idwt(p, a, details, 1), x, atol=1e-11)


def test_program_cpu_path_passes_the_limits():
    spec = tiny_spec()
    cell, cfg, op = spec.cell, spec.config, spec.op
    x = inputs.make(cell["input"], cell["shape"], 1, inputs.generator(3000000007, "cpu"), "cpu")
    got = op.check(op.program_call(P, cfg, cell)(x), x, cfg, cell)
    assert set(got) == set(op.CHECKS) == {"denoised_err", "norm_err"}
    for n in op.CHECKS:
        assert got[n] <= cell["limits"][n] / 4, (n, got[n])
    ref = op.check(op.reference_call(cfg, cell, torch.float64, "cpu")(x), x, cfg, cell)
    assert all(v < 1e-13 for v in ref.values()), ref


def test_a_cpu_run_of_the_cell_is_correct():
    res = harness.run(tiny_spec(), 3000000019, 0.2, False, torch.device("cpu"),
                      time.perf_counter())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == {"denoised_err", "norm_err"}
    json.dumps(res)


_RUN_DENOISE = P.Wavelets.run_denoise
_SOFT = P.ops.soft_threshold


def _unthresholded_norm(self, beta, mode="soft"):
    out, _ = _RUN_DENOISE(self, beta, mode=mode)
    return out, P.ops.norm1(self.forward())


def _norm_without_approx(self, beta, mode="soft"):
    out, n1 = _RUN_DENOISE(self, beta, mode=mode)
    return out, n1 - self.forward().approx.abs().sum()


def _output_is_input(self, beta, mode="soft"):
    _, n1 = _RUN_DENOISE(self, beta, mode=mode)
    return self.get_image(copy=False), n1


#: fault -> (the threshold the facade runs for "soft" or None, a replaced
#: ``run_denoise`` or None, the checks that must fail)
FAULTS = {
    "threshold_skipped": (lambda c, beta, **k: c, None, ("denoised_err", "norm_err")),
    "beta_off_10pct": (lambda c, beta, **k: _SOFT(c, 1.1 * beta, **k), None,
                       ("denoised_err", "norm_err")),
    "hard_for_soft": (P.ops.hard_threshold, None, ("denoised_err", "norm_err")),
    "norm_of_unthresholded_tree": (None, _unthresholded_norm, ("norm_err",)),
    "norm_without_approx": (None, _norm_without_approx, ("norm_err",)),
    "output_is_input": (None, _output_is_input, ("denoised_err",)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_comes_out_not_correct(monkeypatch, fault):
    from pdwt_tpu_torch.ops.threshold import THRESHOLD_OPS

    thresh, run, failing = FAULTS[fault]
    if thresh is not None:
        monkeypatch.setitem(THRESHOLD_OPS, "soft", thresh)
    if run is not None:
        monkeypatch.setattr(P.Wavelets, "run_denoise", run)
    res = harness.run(tiny_spec(), 3000000023, 0.1, False, torch.device("cpu"),
                      time.perf_counter())
    assert not res["correct"]
    for n in failing:
        assert res["checks"][n]["value"] > res["checks"][n]["limit"], (n, res["checks"])


def test_work_counts():
    spec = harness.Spec(NAME)
    # forward and inverse of 4 decimated levels, each level of n samples
    # writing n outputs of 16 taps; x read and the signals written in float32
    flops = 2 * 65536 * 2 * 16 * (4096 + 2048 + 1024 + 512)
    assert spec.op.work(spec.config, spec.cell) == (flops, 2 * 4 * 65536 * 4096 + 4)


def test_reference_and_check_import_nothing_of_the_program():
    code = ("import json, sys\n"
            "from wavebench.traffic import batch_step\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'pdwt_tpu_torch', 'pdwt_tpu', 'jax', 'jaxlib'})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": harness.ROOT})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def _read(name, r):
    return harness.load_module(os.path.join(harness.HERE, "metrics", name + ".py"),
                               "t_" + name).read(r)


#: two calls of the step: 8 launches a call
TABLE = {"pdwt.kernels.fwd_level_1d": {"count": 8, "total_ns": 1, "self_ns": 1},
         "pdwt.kernels.inv_level_1d": {"count": 8, "total_ns": 1, "self_ns": 1},
         "pdwt.ops.soft_threshold": {"count": 2, "total_ns": 1, "self_ns": 1}}
PORT = "(anonymous namespace)::fwd1d_strip_kernel<1, 2, false>"


def _plant(monkeypatch, **attrs):
    fake = SimpleNamespace(span_table=lambda: TABLE, OPERAND_BYTES={}, **attrs)
    monkeypatch.setattr(program_spans, "recorder", lambda: fake)


def _reading(ops_ms=25.0, port_launches=8.0):
    names = frozenset({"fwd1d_strip_kernel"})
    trace = SimpleNamespace(port_launches=port_launches, names=names,
                            by_name={PORT: 5.0, "void at::vectorized_elementwise_kernel": ops_ms},
                            per_call={PORT: 4, "void at::vectorized_elementwise_kernel": 20})
    return SimpleNamespace(trace=trace, device_kind="NVIDIA H100 80GB HBM3",
                           peaks={"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 2e12,
                                                            "fp32_flops_per_s": 67e12}})


def test_readers_on_a_planted_counter(monkeypatch):
    _plant(monkeypatch, OPS_OPERAND_BYTES={"soft_threshold": 8_000_000_000,
                                           "norm1": 2_000_000_000})
    r = _reading()
    assert _read("ops_gb", r) == pytest.approx(5.0)  # 10 GB over two calls
    # 5 GB at 2 TB/s is 2.5 ms of the 25 ms the other operations take
    assert _read("ops_roofline_share", r) == pytest.approx(10.0)


def test_readers_where_there_is_nothing_to_read(monkeypatch):
    _plant(monkeypatch, OPS_OPERAND_BYTES={})
    assert _read("ops_gb", _reading()) == 0.0  # the recorder ran, no ops span
    assert _read("ops_roofline_share", _reading()) == 0.0
    assert _read("ops_gb", _reading(port_launches=3.0)) is None  # the calls do not divide
    assert _read("ops_roofline_share", _reading(ops_ms=0.0)) is None
    assert _read("ops_gb", SimpleNamespace(trace=None)) is None
    _plant(monkeypatch)  # a program without the counter
    assert _read("ops_gb", _reading()) is None
    assert _read("ops_roofline_share", _reading()) is None
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert _read("ops_gb", _reading()) is None


def test_ops_gb_on_the_programs_counter_on_the_cpu():
    from pdwt_tpu_torch.utils import profiling

    spec = tiny_spec()
    x = inputs.make(spec.cell["input"], spec.cell["shape"], 1, inputs.generator(5, "cpu"), "cpu")
    call = spec.op.program_call(P, spec.config, spec.cell)
    profiling.reset_spans()
    call(x)  # the recorder off: nothing counted
    assert profiling.OPS_OPERAND_BYTES == {}
    with profiling.record_spans():
        call(x)
        call(x)
    r = SimpleNamespace(trace=SimpleNamespace(port_launches=8.0))
    try:
        # the tree (the input's samples) and the new details in the threshold,
        # the tree and a float in the norm, a call
        details = x.nbytes - x.nbytes // 16
        assert _read("ops_gb", r) == pytest.approx((2 * x.nbytes + details + 4) / 1e9)
    finally:
        profiling.reset_spans()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_control_fails_and_program_passes_on_the_card():
    """The plain reference in float32 with TF32 products fails the cell's
    check on every seed, and the program passes it, at 4096 signals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 products exist only there")
    spec = harness.Spec(NAME)
    cell, cfg, op = dict(spec.cell, shape=[4096, 4096]), spec.config, spec.op
    dev = torch.device("cuda", 0)
    for seed in (3000000101, 3000000102, 3000000103):
        x = inputs.make(cell["input"], cell["shape"], 1, inputs.generator(seed, dev), dev)
        got = op.check(op.program_call(P, cfg, cell)(x), x, cfg, cell)
        assert all(got[n] <= cell["limits"][n] for n in op.CHECKS), got
        with R.tf32():
            ctl = op.reference_call(cfg, cell, torch.float32, dev)(x)
        got = op.check(ctl, x, cfg, cell)
        assert any(got[n] > cell["limits"][n] for n in op.CHECKS), got
