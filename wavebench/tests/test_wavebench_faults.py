"""A run of the harness with the timed path broken underneath comes out
not correct: once for each fault a cell can have (one card, so no
exchange between chips to leave out)."""
import time

import pytest
import torch
from tiny_cells import TINY, tiny_cell

import pdwt_tpu_torch
from wavebench import harness


def _fill(t, n):
    """The first n items of t, the rest the mean over them."""
    return torch.cat([t[:n], t[:n].mean(0, keepdim=True).expand((t.shape[0] - n,) + t.shape[1:])])


def _tree(c, fn):
    return type(c)(fn(c.approx), tuple(tuple(fn(b) for b in level) for level in c.details))


def _bump(t):
    t = t.clone()
    t.view(-1)[t.numel() // 3] += 1.0
    return t


def roundtrip_faults(monkeypatch, fault):
    fwd = pdwt_tpu_torch.dwt2d
    if fault == "unchanged":  # the transform hands back its state
        monkeypatch.setattr(pdwt_tpu_torch, "dwt2d", lambda x, w, levels: type(fwd(x, w, 1))(x, ()))
        monkeypatch.setattr(pdwt_tpu_torch, "idwt2d", lambda c, w, shape: c.approx)
    elif fault == "half_batch":
        def half(x, w, levels):
            n = x.shape[0] // 2
            return _tree(fwd(x[:n], w, levels), lambda t: torch.cat(
                [t, t.mean(0, keepdim=True).expand((x.shape[0] - n,) + t.shape[1:])]))
        monkeypatch.setattr(pdwt_tpu_torch, "dwt2d", half)
    else:  # one coefficient altered where it is produced
        def altered(x, w, levels):
            c = fwd(x, w, levels)
            det = ((_bump(c.details[0][0]),) + tuple(c.details[0][1:]),) + tuple(c.details[1:])
            return type(c)(c.approx, det)
        monkeypatch.setattr(pdwt_tpu_torch, "dwt2d", altered)


def ti_faults(monkeypatch, fault):
    step = pdwt_tpu_torch.models.denoise_step
    if fault == "unchanged":  # the step hands back its input
        broken = lambda x, *a, **k: (x, step(x, *a, **k)[1])
    elif fault == "half_batch":
        def broken(x, *a, **k):
            n = x.shape[0] // 2
            out, norm = step(x[:n], *a, **k)
            return _fill(torch.cat([out, out[:x.shape[0] - n]]), n), norm * x.shape[0] / n
    else:
        def broken(x, *a, **k):
            out, norm = step(x, *a, **k)
            return _bump(out), norm
    monkeypatch.setattr(pdwt_tpu_torch.models, "denoise_step", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("name", sorted(TINY))
def test_fault_comes_out_not_correct(monkeypatch, name, fault):
    spec = harness.Spec(name, cell=tiny_cell(name))
    inject = roundtrip_faults if spec.entry["traffic"].split(".")[0] == "roundtrip" else ti_faults
    inject(monkeypatch, fault)
    res = harness.run(spec, 3000000023, 0.1, False, torch.device("cpu"), time.perf_counter())
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
