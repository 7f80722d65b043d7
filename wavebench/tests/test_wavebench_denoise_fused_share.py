"""The ``denoise_fused_share`` reader on planted ``DENOISE_PATHS`` counters:
None where the program has no recorder, no counter (a checkout older than
it) or counted no call; otherwise fused / (fused + plain) x 100.  Then on
the program's own counter after a batched 1D step on the CPU, which takes
the plain route."""
import os
from types import SimpleNamespace

import pytest
import torch

from wavebench import harness, program_spans


def _read(r=None):
    path = os.path.join(harness.HERE, "metrics", "denoise_fused_share.py")
    return harness.load_module(path, "t_denoise_fused_share").read(r or SimpleNamespace())


def _plant(monkeypatch, **attrs):
    monkeypatch.setattr(program_spans, "recorder", lambda: SimpleNamespace(**attrs))


def test_no_recorder_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert _read() is None


def test_no_counter_reads_none(monkeypatch):
    _plant(monkeypatch, span_table=dict, NORM_PATHS={"fused": 1})
    assert _read() is None


@pytest.mark.parametrize("fused,plain,want", [(0, 0, None), (9, 0, 100.0), (0, 4, 0.0),
                                              (1, 3, 25.0)])
def test_the_share_of_fused_denoise_calls(monkeypatch, fused, plain, want):
    _plant(monkeypatch, DENOISE_PATHS={"fused": fused, "plain": plain})
    assert _read() == want


def test_the_programs_counter_on_the_cpu():
    from pdwt_tpu_torch import Wavelets
    from pdwt_tpu_torch.utils import profiling

    profiling.reset_spans()
    W = Wavelets(torch.rand(3, 64), wname="sym8", levels=2, ndim=1, device="cpu")
    W.run_denoise(0.1)  # the recorder off: nothing counted
    assert _read() is None
    with profiling.record_spans():
        W.run_denoise(0.1)
    assert profiling.DENOISE_PATHS == {"fused": 0, "plain": 1}
    assert _read() == 0.0
    profiling.reset_spans()
    assert profiling.DENOISE_PATHS == {"fused": 0, "plain": 0}
