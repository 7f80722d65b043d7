"""Application models on the wavelet engine: the denoisers (the sharded
steps included), the volume denoisers and the (F)ISTA solver.  The JAX
package's packet and starlet denoisers wait for the modules they run on
(ROADMAP queue 1 item 14); naming one raises ``NotImplementedError`` with
its item."""
from .denoiser import (auto_denoise, auto_denoise_3d, cycle_spin_denoise, denoise_step,
                       denoise_step_3d, sharded_denoise_step, sharded_denoise_step_3d)
from .solver import ista

__all__ = ["denoise_step", "auto_denoise", "cycle_spin_denoise", "ista",
           "sharded_denoise_step", "denoise_step_3d", "auto_denoise_3d",
           "sharded_denoise_step_3d"]

#: the JAX package's models still to port, by the ROADMAP queue 1 item
#: that brings the module each runs on
DEFERRED = {"packet_denoise": 14, "starlet_auto_denoise": 14}


def __getattr__(name):
    if name in DEFERRED:
        raise NotImplementedError(f"models.{name} comes with ROADMAP queue 1, "
                                  f"item {DEFERRED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
