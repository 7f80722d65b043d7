"""Application models on the wavelet engine: the denoisers (the sharded
steps, the starlet and the best-basis packet denoisers included), the
volume denoisers and the (F)ISTA solver."""
from .denoiser import (auto_denoise, auto_denoise_3d, cycle_spin_denoise, denoise_step,
                       denoise_step_3d, packet_denoise, sharded_denoise_step,
                       sharded_denoise_step_3d, starlet_auto_denoise)
from .solver import ista

__all__ = ["denoise_step", "auto_denoise", "cycle_spin_denoise", "ista",
           "sharded_denoise_step", "denoise_step_3d", "auto_denoise_3d",
           "sharded_denoise_step_3d", "starlet_auto_denoise", "packet_denoise"]
