"""The ``norm_fused_share`` reader on planted ``NORM_PATHS`` counters: None
where the program has no recorder, no counter (a checkout older than it)
or counted no norm; otherwise fused / (fused + plain) x 100.  Then on the
program's own counter after a TI step on the CPU, which takes the plain
route."""
import os
from types import SimpleNamespace

import pytest
import torch

from wavebench import harness, program_spans


def _read(r=None):
    path = os.path.join(harness.HERE, "metrics", "norm_fused_share.py")
    return harness.load_module(path, "t_norm_fused_share").read(r or SimpleNamespace())


def _plant(monkeypatch, **attrs):
    monkeypatch.setattr(program_spans, "recorder", lambda: SimpleNamespace(**attrs))


def test_no_recorder_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert _read() is None


def test_no_counter_reads_none(monkeypatch):
    _plant(monkeypatch, span_table=dict, OPERAND_BYTES={})
    assert _read() is None


@pytest.mark.parametrize("fused,plain,want", [(0, 0, None), (12, 0, 100.0), (0, 7, 0.0),
                                              (5, 5, 50.0), (3, 1, 75.0)])
def test_the_share_of_fused_norms(monkeypatch, fused, plain, want):
    _plant(monkeypatch, NORM_PATHS={"fused": fused, "plain": plain})
    assert _read() == want


def test_the_programs_counter_on_the_cpu():
    from pdwt_tpu_torch.models import denoise_step
    from pdwt_tpu_torch.utils import profiling

    profiling.reset_spans()
    x = torch.rand(2, 16, 24) * 255
    denoise_step(x, None, "db2", 2, 30.0, swt=True)  # the recorder off: nothing counted
    assert _read() is None
    with profiling.record_spans():
        denoise_step(x, None, "db2", 2, 30.0, swt=True)
    assert profiling.NORM_PATHS == {"fused": 0, "plain": 1}
    assert _read() == 0.0
    profiling.reset_spans()
    assert profiling.NORM_PATHS == {"fused": 0, "plain": 0}
