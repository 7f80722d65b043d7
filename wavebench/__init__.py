"""The benchmark of pdwt_tpu_torch on one CUDA card (``run.py``)."""
