"""The trace's readings on synthetic events: kernel time per call held to
the launch counters, the breakdown, and the per-layer readers."""
import os
from types import SimpleNamespace

import pytest

from wavebench import harness, tracing

NAMES = frozenset({"fwd_tail_kernel", "inv_level_kernel"})
PORT = "(anonymous namespace)::fwd_tail_kernel(float const*, int)"
PORT2 = "void (anonymous namespace)::inv_level_kernel<1, false>(float const*)"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_cublas"
ADD = "void at::native::vectorized_elementwise_kernel<4, at::native::AbsFunctor<float>>"


def _events(reps, drop=0):
    ev = []
    for _ in range(reps):
        ev += [(PORT, 0.5), (PORT2, 0.25), (PORT2, 0.25), (GEMM, 1.0), (ADD, 0.1)]
    return ev[drop * 5:] if drop else ev


def test_names_of_the_program_kernels():
    from pdwt_tpu_torch.kernels import _build

    names = tracing.port_kernels(_build.SOURCES)
    assert {"fwd_tail_kernel", "inv_level_kernel"} <= names
    assert tracing.is_port_kernel(PORT, names) and not tracing.is_port_kernel(GEMM, names)


def test_busy_per_call_held_to_the_counters():
    busy, by_name, per_call = tracing.busy_per_call(_events(10), 10, 30, NAMES)
    assert busy == pytest.approx(2.1)
    assert per_call == {PORT: 1, PORT2: 2, GEMM: 1, ADD: 1}
    assert tracing.busy_per_call(_events(10), 10, 31, NAMES) is None
    assert tracing.busy_per_call([], 10, 0, NAMES) is None


def test_a_dropped_event_does_not_lower_the_reading():
    ev = _events(10)
    del ev[3]  # one GEMM event of one call lost
    busy, by_name, _ = tracing.busy_per_call(ev, 10, 30, NAMES)
    assert by_name[GEMM] == pytest.approx(1.0) and busy == pytest.approx(2.1)


def test_breakdown_labels_gaps_by_the_innermost_host_range():
    device = [("k1", 0.0, 10.0), ("k2", 30.0, 40.0), ("k1", 40.0, 50.0), ("k3", 100.0, 110.0)]
    host = [("wavebench.call", 0.0, 120.0), ("aten::abs", 15.0, 35.0)]
    b = tracing.breakdown(device, host)
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert dict((k, v) for k, v in b["idle_gaps"]) == {"aten::abs": pytest.approx(20e-6),
                                                        "wavebench.call": pytest.approx(50e-6)}


def _reading(**kw):
    busy, by_name, per_call = tracing.busy_per_call(_events(10), 10, 30, NAMES)
    t = SimpleNamespace(busy_ms_per_call=busy, by_name=by_name, per_call=per_call,
                        port_launches=3.0, names=NAMES, breakdown={})
    base = dict(calls=10, window_s=0.042, intervals_ms=[4.2] * 10, host_s=[0.001] * 10,
                samples_per_call=1000, setup_s=1.0, peak_bytes=2 ** 30, flops=67e12 * 1e-3,
                bytes=3.35e12 * 0.5e-3, trace=t,
                device_kind="NVIDIA H100 80GB HBM3",
                peaks=harness.load_json(os.path.join(harness.HERE, "peaks.json")))
    base.update(kw)
    return SimpleNamespace(**base)


def _read(name, r):
    return harness.load_module(os.path.join(harness.HERE, "metrics", name + ".py"), "t_" + name).read(r)


def test_per_layer_readers():
    r = _reading()
    assert _read("port_kernel_ms", r) == pytest.approx(1.0)
    assert _read("ops_copies_ms", r) == pytest.approx(1.1)
    assert _read("launches_per_call", r) == 5
    assert _read("host_ms_per_call", r) == pytest.approx(1.0)
    # the bound is the 1 ms of flops at 67 TFLOP/s over 2.1 ms busy
    assert _read("roofline_share", r) == pytest.approx(100 / 2.1)
    assert _read("idle_share", r) == pytest.approx(50.0)
    assert _read("roofline_share", _reading(device_kind="another card")) is None
    for name in ("port_kernel_ms", "idle_share", "launches_per_call"):
        assert _read(name, _reading(trace=None)) is None


def test_end_to_end_readers():
    r = _reading(intervals_ms=[1.0] * 95 + [10.0] * 5)
    assert _read("throughput", r) == pytest.approx(1000 * 10 / 0.042 / 1e6)
    assert 1.0 <= _read("call_ms_p95", r) <= 10.0
    assert _read("peak_mem_gib", r) == 1.0
    assert _read("peak_mem_gib", _reading(peak_bytes=0)) is None
    assert _read("setup_s", r) == 1.0
