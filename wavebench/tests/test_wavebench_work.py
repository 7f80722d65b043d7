"""The work counts against hand counts for one level of each transform,
and each cell's (flops, bytes) from its shapes."""
import pytest

from wavebench import harness
from wavebench.work import filterbank


def test_one_decimated_2d_level():
    # 8x8, 4 taps: the column pass writes 64 samples (two 8x4 halves), the
    # row pass 64 more, each of 4 multiply-adds: 2 * 4 * 128 flops
    assert filterbank.transform_flops((8, 8), 4, 1, False) == 2 * 4 * 128


def test_one_decimated_3d_level():
    # 4x8x8, 8 taps: three passes of 256 output samples each
    assert filterbank.transform_flops((4, 8, 8), 8, 1, False) == 2 * 8 * 3 * 256


def test_one_stationary_2d_level():
    # 8x8, 14 taps: the column pass writes 2 full bands (128 samples), the
    # row pass 4 (256)
    assert filterbank.transform_flops((8, 8), 14, 1, True) == 2 * 14 * (128 + 256)


def test_one_stationary_3d_level():
    # 4x8x8, 8 taps: 2, 4 and 8 full bands of 256 samples
    assert filterbank.transform_flops((4, 8, 8), 8, 1, True) == 2 * 8 * (2 + 4 + 8) * 256


def test_levels_sum():
    one = filterbank.transform_flops((64, 64), 14, 1, False)
    assert filterbank.transform_flops((64, 64), 14, 3, False) == one * (1 + 1 / 4 + 1 / 16)
    assert filterbank.transform_flops((64, 64), 14, 3, True) == 3 * filterbank.transform_flops(
        (64, 64), 14, 1, True)


@pytest.mark.parametrize("name,flops,nbytes", [
    # forward and inverse; x, the tree and the reconstruction in float32
    ("db7_2d.roundtrip", 2 * 64 * 2 * 14 * 2 * 2048 ** 2 * (1 + 1 / 4 + 1 / 16 + 1 / 64 + 1 / 256),
     3 * 4 * 64 * 2048 ** 2),
    # forward and inverse of 5 levels: 6 full-size bands written a level
    ("db7_2d.ti_step", 2 * 64 * 5 * 2 * 14 * 6 * 512 ** 2, 2 * 4 * 64 * 512 ** 2 + 4),
])
def test_cell_work(name, flops, nbytes):
    spec = harness.Spec(name)
    got = spec.op.work(spec.config, spec.cell)
    assert got == (pytest.approx(flops, rel=1e-12), nbytes)
