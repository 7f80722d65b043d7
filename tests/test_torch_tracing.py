"""The port's span recorder (``pdwt_tpu_torch/utils/profiling.py``) on the
CPU: spans nest and self time leaves out the children; off, a span is a
plain call (no ``record_function``, no clock); on, under ``torch.profiler``
or ``record_spans()``, the table fills and the profiler shows the spans as
host ranges; the kernel wrappers count their operand bytes, as the shapes
give them, and every launch counter has its kernel span."""
import ast
import inspect
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pdwt_tpu_torch as P
from pdwt_tpu_torch import kernels
from pdwt_tpu_torch.kernels import separable as K
from pdwt_tpu_torch.kernels import swt as S
from pdwt_tpu_torch.utils import profiling as prof

W = P.get_wavelet("db2")
F32 = 4  # bytes a float32


@pytest.fixture(autouse=True)
def clean_table():
    prof.reset_spans()
    yield
    prof.reset_spans()


class Clock:
    """A fake ``perf_counter_ns`` that steps through the given readings."""

    def __init__(self, *readings):
        self.readings = list(readings)

    def perf_counter_ns(self):
        return self.readings.pop(0)


def test_spans_nest_and_self_time_subtracts_every_child(monkeypatch):
    # outer [0, 100]: block [10, 40], inner [50, 55], inner [60, 80]
    monkeypatch.setattr(prof, "time", Clock(0, 10, 40, 50, 55, 60, 80, 100))

    @prof.spanned("ops")
    def inner():
        return 1

    @prof.spanned("models")
    def outer():
        with prof.span("pdwt.ops.block"):
            pass
        return inner() + inner()

    with prof.record_spans():
        assert outer() == 2
    table = prof.span_table()
    assert table == {
        "pdwt.ops.block": {"count": 1, "total_ns": 30, "self_ns": 30},
        "pdwt.ops.test_spans_nest_and_self_time_subtracts_every_child.<locals>.inner":
            {"count": 2, "total_ns": 25, "self_ns": 25},
        "pdwt.models.test_spans_nest_and_self_time_subtracts_every_child.<locals>.outer":
            {"count": 1, "total_ns": 100, "self_ns": 45},
    }
    prof.reset_spans()
    assert prof.span_table() == {}


def test_a_span_that_raises_is_recorded_and_counts_no_bytes(monkeypatch):
    monkeypatch.setattr(prof, "time", Clock(0, 7))

    @prof.spanned("kernels")
    def boom(x):
        raise ValueError("no")

    with prof.record_spans(), pytest.raises(ValueError):
        boom(torch.ones(4))
    row = prof.span_table()[boom.span_name]
    assert row == {"count": 1, "total_ns": 7, "self_ns": 7}
    assert prof.OPERAND_BYTES == {}


def test_off_a_span_is_a_plain_call(monkeypatch):
    made = []

    def no_clock():
        raise AssertionError("the off path read the clock")

    real_init = torch.autograd.profiler.record_function.__init__

    def counting_init(self, *a, **k):
        made.append(a)
        real_init(self, *a, **k)

    monkeypatch.setattr(prof, "time", SimpleNamespace(perf_counter_ns=no_clock))
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", counting_init)

    @prof.spanned("kernels")
    def add(x):
        return x + 1

    assert not prof.recording()
    assert torch.equal(add(torch.zeros(3)), torch.ones(3))
    with prof.span("pdwt.ops.block") as s:
        assert s is None  # the shared no-op context
    assert prof.span("pdwt.ops.a") is prof.span("pdwt.ops.b")
    x = torch.rand(2, 16, 16)
    P.dwt2d(x, W, 2)
    P.models.denoise_step(x, None, W, 2, 0.1, swt=True)
    assert made == [] and prof.span_table() == {} and prof.OPERAND_BYTES == {}


def test_record_spans_alone_opens_no_profiler_range(monkeypatch):
    made = []
    real_init = torch.autograd.profiler.record_function.__init__

    def counting_init(self, *a, **k):
        made.append(a)
        real_init(self, *a, **k)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", counting_init)
    x = torch.rand(2, 16, 16)
    with prof.record_spans():
        assert prof.recording()
        P.models.denoise_step(x, None, W, 2, 0.1, swt=True)
    assert not prof.recording()
    assert made == []
    table = prof.span_table()
    assert table["pdwt.models.denoise_step"]["count"] == 1
    assert table["pdwt.kernels.swt_fwd_level_2d"]["count"] == 2
    assert table["pdwt.kernels.swt_inv_level_2d"]["count"] == 2
    assert table["pdwt.ops.thresholded_norm1"]["count"] == 1  # one span, not one a band
    assert table["pdwt.transform.swt2d"]["count"] == 1
    assert table["pdwt.transform.iswt2d_denoise"]["count"] == 1


@pytest.mark.parametrize("how", ["profiler", "record_spans"])
def test_on_the_table_fills_by_layer(how):
    x = torch.rand(3, 32, 32)

    def run():
        w = P.Wavelets(x[0], wname="db2", levels=2, device="cpu")
        w.forward()
        w.inverse()
        c = P.dwt2d(x, W, 2)
        P.idwt2d(c, W, (32, 32))

    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]) as p:
            run()
    else:
        with prof.record_spans():
            run()
    table = prof.span_table()
    assert table["pdwt.facade.Wavelets.forward"]["count"] == 1
    assert table["pdwt.facade.Wavelets.inverse"]["count"] == 1
    assert table["pdwt.transform.dwt2d"]["count"] == 2
    assert table["pdwt.transform.idwt2d"]["count"] == 2
    kern = {k: v for k, v in table.items() if k.startswith("pdwt.kernels.")}
    assert kern and all(v["self_ns"] == v["total_ns"] for v in kern.values())
    for k, v in table.items():
        assert 0 <= v["self_ns"] <= v["total_ns"], k
    fwd = table["pdwt.transform.dwt2d"]
    assert fwd["total_ns"] - fwd["self_ns"] >= table["pdwt.kernels.fwd_tail_2d"]["total_ns"]
    if how == "profiler":
        host = [e.name for e in p.events() if e.device_type == torch.autograd.DeviceType.CPU]
        for name in table:
            assert host.count(name) == table[name]["count"], name


def test_the_profiler_shows_the_layers_over_the_ops():
    """A kernel span's range holds the torch ops its plain version runs."""
    x = torch.rand(2, 16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        K.fwd_level_2d(x, W.dec_lo, W.dec_hi)
    ev = {e.name: e for e in p.events()}
    outer = ev["pdwt.kernels.fwd_level_2d"]
    inner = [e for e in p.events() if e.name.startswith("aten::")]
    assert inner and all(outer.time_range.start <= e.time_range.start
                         and e.time_range.end <= outer.time_range.end for e in inner)


def _bytes(*shapes):
    return F32 * sum(int(np.prod(s)) for s in shapes)


def _rand(*shape):
    return torch.rand(*shape, generator=torch.Generator().manual_seed(1))


def _fwd_level(B, R, C):
    x = _rand(B, R, C)
    return (lambda: K.fwd_level_2d(x, W.dec_lo, W.dec_hi),
            _bytes((B, R, C), *[(B, R // 2, C // 2)] * 4))


def _inv_level(B, m, n):
    bands = [_rand(B, m, n) for _ in range(4)]
    return (lambda: K.inv_level_2d(*bands, W.rec_lo, W.rec_hi),
            _bytes(*[(B, m, n)] * 4, (B, 2 * m, 2 * n)))


def _fwd_tail(B, R, C, L):
    x = _rand(B, R, C)
    dets = [(B, R >> lvl, C >> lvl) for lvl in range(1, L + 1) for _ in range(3)]
    return (lambda: K.fwd_tail_2d(x, W.dec_lo, W.dec_hi, L),
            _bytes((B, R, C), (B, R >> L, C >> L), *dets))


def _inv_tail(B, m, n, L):
    a = _rand(B, m, n)
    details = [tuple(_rand(B, m << k, n << k) for _ in range(3)) for k in range(L)]
    return (lambda: K.inv_tail_2d(a, details, W.rec_lo, W.rec_hi),
            _bytes((B, m, n), *[(B, m << k, n << k) for k in range(L) for _ in range(3)],
                   (B, m << L, n << L)))


def _fwd_padded(B, R, C):
    x = _rand(B, R, C)
    ro, co = (R - W.hlen) // 2 + 1, (C - W.hlen) // 2 + 1
    return (lambda: K.fwd_level_2d_padded(x, W.dec_lo, W.dec_hi),
            _bytes((B, R, C), *[(B, ro, co)] * 4))


def _inv_padded(B, m, n, out):
    bands = [_rand(B, m, n) for _ in range(4)]
    return (lambda: K.inv_level_2d_padded(*bands, W.rec_lo, W.rec_hi, (-1, 0), out),
            _bytes(*[(B, m, n)] * 4, (B, *out)))


def _swt_fwd(B, R, C, level):
    x = _rand(B, R, C)
    return (lambda: S.swt_fwd_level_2d(x, W.dec_lo, W.dec_hi, level),
            _bytes(*[(B, R, C)] * 5))


def _swt_inv(B, R, C, level, beta=None):
    bands = [_rand(B, R, C) for _ in range(4)]
    thr = None if beta is None else ("soft", beta)
    extra = [(1,)] if isinstance(beta, torch.Tensor) else []
    return (lambda: S.swt_inv_level_2d(*bands, W.rec_lo, W.rec_hi, level, thr),
            _bytes(*[(B, R, C)] * 5, *extra))


def _swt_fwd_padded(B, R, C, level):
    x = _rand(B, R, C)
    span = (W.hlen - 1) * (1 << (level - 1))
    return (lambda: S.swt_fwd_level_2d_padded(x, W.dec_lo, W.dec_hi, level),
            _bytes((B, R, C), *[(B, R - span, C - span)] * 4))


def _swt_inv_padded(B, R, C, level):
    bands = [_rand(B, R, C) for _ in range(4)]
    span = (W.hlen - 1) * (1 << (level - 1))
    return (lambda: S.swt_inv_level_2d_padded(*bands, W.rec_lo, W.rec_hi, level),
            _bytes(*[(B, R, C)] * 4, (B, R - span, C - span)))


BYTE_CASES = {
    "fwd_level_2d": [lambda: _fwd_level(2, 16, 24), lambda: _fwd_level(1, 6, 10)],
    "inv_level_2d": [lambda: _inv_level(2, 8, 12), lambda: _inv_level(3, 7, 9)],
    "fwd_tail_2d": [lambda: _fwd_tail(2, 16, 24, 2), lambda: _fwd_tail(1, 24, 40, 3)],
    "inv_tail_2d": [lambda: _inv_tail(2, 4, 6, 2), lambda: _inv_tail(1, 3, 5, 3)],
    "fwd_level_2d_padded": [lambda: _fwd_padded(2, 20, 24), lambda: _fwd_padded(3, 23, 17)],
    "inv_level_2d_padded": [lambda: _inv_padded(2, 9, 10, (13, 15)),
                            lambda: _inv_padded(1, 8, 8, (12, 12))],
    "swt_fwd_level_2d": [lambda: _swt_fwd(2, 16, 16, 1), lambda: _swt_fwd(3, 15, 22, 2)],
    "swt_inv_level_2d": [lambda: _swt_inv(2, 16, 16, 1), lambda: _swt_inv(1, 15, 22, 3, 0.2),
                         lambda: _swt_inv(2, 9, 13, 2, torch.tensor(0.3))],
    "swt_fwd_level_2d_padded": [lambda: _swt_fwd_padded(2, 20, 24, 1),
                                lambda: _swt_fwd_padded(1, 21, 27, 2)],
    "swt_inv_level_2d_padded": [lambda: _swt_inv_padded(2, 20, 24, 1),
                                lambda: _swt_inv_padded(1, 21, 27, 2)],
}


@pytest.mark.parametrize("key,case", [(k, i) for k, cs in BYTE_CASES.items()
                                      for i in range(len(cs))])
def test_the_byte_counter_reads_the_operands_from_the_shapes(key, case):
    call, want = BYTE_CASES[key][case]()
    call()  # off: nothing counted
    assert prof.OPERAND_BYTES == {}
    with prof.record_spans():
        call()
        call()
    assert prof.OPERAND_BYTES == {key: 2 * want}
    assert prof.span_table()[f"pdwt.kernels.{key}"]["count"] == 2


def test_a_tensor_given_twice_counts_once():
    @prof.spanned("kernels")
    def same(x, y):
        return x

    x = torch.zeros(5)
    with prof.record_spans():
        same(x, [x, (x, {"k": x})])
    assert prof.OPERAND_BYTES == {"same": 5 * F32}


def test_the_transforms_count_their_launches_bytes_at_odd_sizes():
    """An odd image: the forward's first level takes the extended image."""
    x = _rand(2, 37, 51)
    with prof.record_spans():
        c = P.dwt2d(x, W, 2)
    # level 1: the 38 x 52 extension, four 19 x 26 bands; level 2 (a tail of
    # one level): the 20 x 26 extension, four 10 x 13 bands
    assert prof.OPERAND_BYTES == {"fwd_level_2d": _bytes((2, 38, 52), *[(2, 19, 26)] * 4),
                                  "fwd_tail_2d": _bytes((2, 20, 26), *[(2, 10, 13)] * 4)}
    assert tuple(c.approx.shape) == (2, 10, 13)


def test_every_launch_counter_has_its_kernel_span():
    for key in kernels.LAUNCHES:
        fn = getattr(kernels, key)
        assert fn.span_name == f"pdwt.kernels.{key}", key
        assert fn.__wrapped__.__name__ == key


def test_every_launch_sits_in_the_wrapper_of_its_name():
    """Each ``launch("<key>", ...)`` of the kernel modules (or a launch
    helper's, ``_fwd_launch("<key>", ...)``) is in the body of the
    function ``<key>``, decorated ``@spanned("kernels")``."""
    seen = set()
    for mod in {inspect.getmodule(getattr(kernels, k).__wrapped__) for k in kernels.LAUNCHES}:
        tree = ast.parse(inspect.getsource(mod))
        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and getattr(node.func, "id", "").endswith("launch")
                        and node.args and isinstance(node.args[0], ast.Constant)):
                    key = node.args[0].value
                    assert key == fn.name, (mod.__name__, fn.name, key)
                    assert any(ast.unparse(d) == "spanned('kernels')"
                               for d in fn.decorator_list), key
                    seen.add(key)
    assert seen == set(kernels.LAUNCHES)


def test_transform_spans_sit_outside_the_precision_keyword():
    x = _rand(2, 16, 16).to(torch.bfloat16)
    with prof.record_spans():
        P.dwt2d(x, W, 2, precision="bf16-fast")
    assert prof.span_table()["pdwt.transform.dwt2d"]["count"] == 1
    assert P.dwt2d.span_name == "pdwt.transform.dwt2d"
    assert "precision" in P.dwt2d.__doc__
