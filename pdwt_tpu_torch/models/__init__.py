"""Application models on the wavelet engine: the denoisers (the sharded
step included) and the (F)ISTA solver.  The JAX package's 3D, packet and
starlet denoisers wait for the modules they run on; naming one raises
``NotImplementedError`` with its ROADMAP item."""
from .denoiser import auto_denoise, cycle_spin_denoise, denoise_step, sharded_denoise_step
from .solver import ista

__all__ = ["denoise_step", "auto_denoise", "cycle_spin_denoise", "ista",
           "sharded_denoise_step"]

#: the JAX package's models still to port, by the ROADMAP queue 1 item
#: that brings the module each runs on
DEFERRED = {"auto_denoise_3d": 12, "denoise_step_3d": 12, "packet_denoise": 14,
            "starlet_auto_denoise": 14, "sharded_denoise_step_3d": 12}


def __getattr__(name):
    if name in DEFERRED:
        raise NotImplementedError(f"models.{name} comes with ROADMAP queue 1, "
                                  f"item {DEFERRED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
