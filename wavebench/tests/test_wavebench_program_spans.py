"""The readers of the program's span recorder (``program_spans.py`` and its
five metrics) on a planted table: known values per call, and None where
the kernel spans do not make whole calls, the trace is missing or the
program has no recorder; then on the recorder's own table after calls of
the program's plain path on the CPU."""
import os
from types import SimpleNamespace

import pytest
import torch

from wavebench import harness, program_spans

METRICS = ("models_host_ms", "transform_host_ms", "kernels_host_ms", "ops_host_ms",
           "port_kernel_gb")

#: four calls of a TI step: 10 launches a call
TABLE = {
    "pdwt.models.denoise_step": {"count": 4, "total_ns": 40_000_000, "self_ns": 400_000},
    "pdwt.facade.Wavelets.run_denoise": {"count": 0, "total_ns": 0, "self_ns": 0},
    "pdwt.transform.swt2d": {"count": 4, "total_ns": 8_000_000, "self_ns": 800_000},
    "pdwt.transform.iswt2d_denoise": {"count": 4, "total_ns": 12_000_000, "self_ns": 1_200_000},
    "pdwt.ops.thresholded_norm1": {"count": 4, "total_ns": 16_000_000, "self_ns": 16_000_000},
    "pdwt.kernels.swt_fwd_level_2d": {"count": 20, "total_ns": 7_200_000, "self_ns": 7_200_000},
    "pdwt.kernels.swt_inv_level_2d": {"count": 20, "total_ns": 10_800_000,
                                      "self_ns": 10_800_000},
}
BYTES = {"swt_fwd_level_2d": 6_000_000_000, "swt_inv_level_2d": 8_000_000_000}


def _read(name, r):
    path = os.path.join(harness.HERE, "metrics", name + ".py")
    return harness.load_module(path, "t_" + name).read(r)


def _plant(monkeypatch, table=TABLE, nbytes=BYTES):
    fake = SimpleNamespace(span_table=lambda: table, OPERAND_BYTES=nbytes)
    monkeypatch.setattr(program_spans, "recorder", lambda: fake)


def _r(port_launches=10.0):
    return SimpleNamespace(trace=SimpleNamespace(port_launches=port_launches))


def test_planted_table_per_call(monkeypatch):
    _plant(monkeypatch)
    r = _r()
    assert _read("models_host_ms", r) == pytest.approx(0.1)
    assert _read("transform_host_ms", r) == pytest.approx(0.5)
    assert _read("kernels_host_ms", r) == pytest.approx(4.5)
    assert _read("ops_host_ms", r) == pytest.approx(4.0)
    assert _read("port_kernel_gb", r) == pytest.approx(3.5)


@pytest.mark.parametrize("port_launches", [3.0, 7.0, 11.0, 80.0])
def test_calls_that_do_not_divide_read_none(monkeypatch, port_launches):
    _plant(monkeypatch)
    for name in METRICS:
        assert _read(name, _r(port_launches)) is None, name


def test_two_calls_read_as_four(monkeypatch):
    """The same table at 20 launches a call is two calls of twice the work."""
    _plant(monkeypatch)
    assert _read("kernels_host_ms", _r(20.0)) == pytest.approx(9.0)
    assert _read("port_kernel_gb", _r(20.0)) == pytest.approx(7.0)


@pytest.mark.parametrize("case", ["no recorder", "no trace", "no launches", "empty table",
                                  "no span of the layer"])
def test_nothing_to_read_reads_none(monkeypatch, case):
    r = _r()
    if case == "no recorder":
        monkeypatch.setattr(program_spans, "recorder", lambda: None)
    elif case == "no trace":
        _plant(monkeypatch)
        r = SimpleNamespace(trace=None)
    elif case == "no launches":
        _plant(monkeypatch)
        r = _r(0.0)
    elif case == "empty table":
        _plant(monkeypatch, {}, {})
    else:
        _plant(monkeypatch, {k: v for k, v in TABLE.items() if ".ops." not in k})
        assert _read("ops_host_ms", r) is None
        assert _read("kernels_host_ms", r) == pytest.approx(4.5)
        return
    for name in METRICS:
        assert _read(name, r) is None, name


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    import pdwt_tpu_torch.utils.profiling as prof

    monkeypatch.delattr(prof, "span_table")
    assert program_spans.recorder() is None
    for name in METRICS:
        assert _read(name, _r()) is None, name


def test_the_recorders_own_table(monkeypatch):
    """Three roundtrip calls of the plain path under ``record_spans()``: the
    readers give the recorder's per-call values."""
    import pdwt_tpu_torch as P
    from pdwt_tpu_torch.utils import profiling as prof

    w = P.get_wavelet("db7")
    x = torch.rand(2, 128, 64)
    prof.reset_spans()
    try:
        with prof.record_spans():
            for _ in range(3):
                P.idwt2d(P.dwt2d(x, w, 3), w, (128, 64))
        table = prof.span_table()
        kern = {k: v for k, v in table.items() if k.startswith("pdwt.kernels.")}
        per_call = sum(v["count"] for v in kern.values()) / 3
        r = _r(per_call)
        want = sum(v["total_ns"] for v in kern.values()) / 3 / 1e6
        assert _read("kernels_host_ms", r) == pytest.approx(want)
        want = sum(v["self_ns"] for k, v in table.items() if k.startswith("pdwt.transform."))
        assert _read("transform_host_ms", r) == pytest.approx(want / 3 / 1e6)
        assert _read("port_kernel_gb", r) == pytest.approx(
            sum(prof.OPERAND_BYTES.values()) / 3 / 1e9)
        assert _read("ops_host_ms", r) is None
    finally:
        prof.reset_spans()
