"""norm_fused_share (%): the share of the thresholded L1 norms a traced run
took in kernel 5's store epilogue, fused / (fused + plain) x 100 by the
program's ``NORM_PATHS`` counter (``pdwt_tpu_torch/utils/profiling.py``,
counted while the recorder is on, so over the traced windows).  None
where the program has no such counter or counted no norm."""
from wavebench import program_spans


def read(r):
    prof = program_spans.recorder()
    paths = getattr(prof, "NORM_PATHS", None) if prof is not None else None
    if not paths:
        return None
    fused, plain = paths.get("fused", 0), paths.get("plain", 0)
    if fused + plain == 0:
        return None
    return fused / (fused + plain) * 100
