"""The control, on the card: the plain reference in the program's place in
float32 with TF32 products (the precision below the configurations' IEEE
float32) fails each cell's check, and the program passes it, at sizes a
test run holds."""
import pytest
import torch

import pdwt_tpu_torch
from wavebench import harness, inputs
from wavebench.reference import transforms as R

SIZES = {"db7_2d.roundtrip": [4, 512, 512], "db7_2d.ti_step": [4, 512, 512]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_fails_and_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 products exist only there")
    spec = harness.Spec(name)
    cell, cfg, op = dict(spec.cell, shape=SIZES[name]), spec.config, spec.op
    dev = torch.device("cuda", 0)
    for seed in (3000000101, 3000000102, 3000000103):
        x = inputs.make(cell["input"], cell["shape"], cfg["ndim"], inputs.generator(seed, dev), dev)
        got = op.check(op.program_call(pdwt_tpu_torch, cfg, cell)(x), x, cfg, cell)
        assert all(got[n] <= cell["limits"][n] for n in op.CHECKS), got
        with R.tf32():
            ctl = op.reference_call(cfg, cell, torch.float32, dev)(x)
        got = op.check(ctl, x, cfg, cell)
        assert any(got[n] > cell["limits"][n] for n in op.CHECKS), got
