"""denoise_fused_share (%): the share of the ``Wavelets.run_denoise`` calls a
traced run made with the threshold in a kernel (kernel 7's norm launches in
1D), fused / (fused + plain) x 100 by the program's ``DENOISE_PATHS``
counter (``pdwt_tpu_torch/utils/profiling.py``, counted while the recorder
is on, so over the traced windows).  None where the program has no such
counter or counted no call."""
from wavebench import program_spans


def read(r):
    prof = program_spans.recorder()
    paths = getattr(prof, "DENOISE_PATHS", None) if prof is not None else None
    if not paths:
        return None
    fused, plain = paths.get("fused", 0), paths.get("plain", 0)
    if fused + plain == 0:
        return None
    return fused / (fused + plain) * 100
