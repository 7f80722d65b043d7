from .denoiser import denoise_step

__all__ = ["denoise_step"]
