"""The ops layer's operand bytes (``OPS_OPERAND_BYTES`` in
``pdwt_tpu_torch/utils/profiling.py``) on the CPU: each outermost
``pdwt.ops.*`` span adds every tensor its call takes and returns, once; an
ops function run inside another's span adds nothing; nothing is counted
with the recorder off, and ``reset_spans`` clears the counts.  No JAX."""
import pytest
import torch

import pdwt_tpu_torch as P
from pdwt_tpu_torch import ops
from pdwt_tpu_torch.utils import profiling as prof

W = P.get_wavelet("sym8")
F32 = 4  # bytes a float32
#: (signals, samples, levels): a small batched 1D tree
B, N, L = 3, 256, 4


@pytest.fixture(autouse=True)
def clean_table():
    prof.reset_spans()
    yield
    prof.reset_spans()


def _signals(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((B, N), generator=g)


def _tree_bytes(levels=L):
    """A decimated 1D tree of (B, N) holds B N samples."""
    assert N % 2 ** levels == 0
    return B * N * F32


def test_counts_are_exact_for_soft_threshold_and_norm1():
    c = P.dwt1d(_signals(), W, L)
    with prof.record_spans():
        t = ops.soft_threshold(c, 0.1)
        n1 = ops.norm1(t)
    details = B * N * F32 - c.approx.nbytes
    # the threshold takes the tree and returns new details beside the same
    # approximation, which counts once; the norm takes the tree, returns a float
    assert prof.OPS_OPERAND_BYTES == {"soft_threshold": _tree_bytes() + details,
                                      "norm1": _tree_bytes() + n1.nbytes}
    assert t.approx is c.approx and n1.nbytes == F32


def test_nothing_is_counted_with_the_recorder_off():
    c = P.dwt1d(_signals(), W, L)
    ops.norm1(ops.soft_threshold(c, 0.1))
    assert prof.OPS_OPERAND_BYTES == {} and prof.span_table() == {}


def test_nested_ops_spans_count_once():
    @prof.spanned("ops")
    def soft_norm(coeffs, beta):
        return ops.norm1(ops.soft_threshold(coeffs, beta))

    c = P.dwt1d(_signals(), W, L)
    with prof.record_spans():
        n1 = soft_norm(c, 0.1)
    assert prof.OPS_OPERAND_BYTES == {"soft_norm": _tree_bytes() + n1.nbytes}
    table = prof.span_table()  # the inner spans still time their calls
    assert table["pdwt.ops.soft_threshold"]["count"] == table["pdwt.ops.norm1"]["count"] == 1
    with prof.record_spans():  # and a later outermost span counts again
        ops.norm1(c)
    assert prof.OPS_OPERAND_BYTES["norm1"] == _tree_bytes() + F32


def test_an_ops_span_that_raises_leaves_the_next_one_outermost():
    @prof.spanned("ops")
    def broken(coeffs):
        ops.norm1(coeffs)
        raise RuntimeError("broken")

    c = P.dwt1d(_signals(), W, L)
    with prof.record_spans():
        with pytest.raises(RuntimeError):
            broken(c)
        ops.norm1(c)
    assert prof.OPS_OPERAND_BYTES == {"norm1": _tree_bytes() + F32}


def test_reset_spans_clears_the_counts():
    c = P.dwt1d(_signals(), W, L)
    with prof.record_spans():
        ops.norm1(c)
    assert prof.OPS_OPERAND_BYTES
    prof.reset_spans()
    assert prof.OPS_OPERAND_BYTES == {}


def test_run_denoise_counts_what_its_two_calls_count_alone():
    x = _signals(1)
    S = P.Wavelets(x, wname="sym8", levels=L, ndim=1, device="cpu")
    with prof.record_spans():
        out, n1 = S.run_denoise(0.1)
    facade = dict(prof.OPS_OPERAND_BYTES)
    prof.reset_spans()
    c = P.dwt1d(x, W, L)
    with prof.record_spans():
        t = ops.soft_threshold(c, 0.1)
        n2 = ops.norm1(t)
    assert facade == prof.OPS_OPERAND_BYTES
    assert sum(facade.values()) == 2 * _tree_bytes() + (B * N * F32 - c.approx.nbytes) + F32
    assert torch.equal(n1, n2) and torch.equal(out, P.idwt1d(t, W, N))
