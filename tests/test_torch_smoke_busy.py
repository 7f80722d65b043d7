"""``chip_smoke.busy_per_call``, the device busy time of one profiler
window, checked on the CPU with made-up windows: a name's time per call is
its mean per recorded event times its launches per call, so a window that
dropped a few events reads the same as a whole one, and a window in which
the port's kernels fall short of the launch counters reads None (not
measured) rather than a low figure."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as CS  # noqa: E402

OURS = "void (anonymous namespace)::ns_fwd_mxu_kernel<4, 3, 1>(void const*, float*)"
PLAIN = "(anonymous namespace)::fwd_tail_kernel(float const*, float*)"
LIB = "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>(float*)"


def _window(per_call, reps, drop=None):
    """Device events of ``reps`` calls, each launching ``per_call[name]``
    events of ``ms`` each; ``drop[name]`` of them lost."""
    drop = drop or {}
    return [(name, ms) for name, (n, ms) in per_call.items()
            for _ in range(n * reps - drop.get(name, 0))]


def test_the_port_kernels_are_named_from_their_sources():
    assert {"ns_fwd_mxu_kernel", "fwd_tail_kernel", "fwd1d_strip_kernel"} <= CS.port_kernels()
    assert CS.is_port_kernel(OURS) and CS.is_port_kernel(PLAIN)
    assert not CS.is_port_kernel(LIB)
    assert not CS.is_port_kernel("void at::native::vectorized_elementwise_kernel<4>(int)")


@pytest.mark.parametrize("drop", [{}, {OURS: 1}, {OURS: 9, LIB: 2}, {LIB: 9, PLAIN: 1}])
def test_a_window_that_lost_a_few_events_reads_as_a_whole_one(drop):
    calls = {OURS: (3, 0.02), PLAIN: (1, 0.05), LIB: (15, 0.001)}
    busy, by_name = CS.busy_per_call(_window(calls, 10, drop), 10, 40)
    assert by_name[OURS] == pytest.approx(0.06)
    assert by_name[PLAIN] == pytest.approx(0.05)
    assert by_name[LIB] == pytest.approx(0.015)
    assert busy == pytest.approx(0.125)


@pytest.mark.parametrize("drop", [{OURS: 10}, {OURS: 30}, {PLAIN: 10}])
def test_a_port_kernel_short_of_the_counters_reads_not_measured(drop):
    # a third of a kernel launched three times a call: the per-call
    # rounding this replaces counted it twice a call and read low
    calls = {OURS: (3, 0.02), PLAIN: (1, 0.05), LIB: (15, 0.001)}
    assert CS.busy_per_call(_window(calls, 10, drop), 10, 40) is None


def test_an_empty_window_reads_not_measured():
    assert CS.busy_per_call([], 10, 0) is None


def test_a_plain_path_with_no_port_kernel_reads_its_library_kernels():
    busy, _ = CS.busy_per_call(_window({LIB: (5, 0.002)}, 10, {LIB: 3}), 10, 0)
    assert busy == pytest.approx(0.01)
