from .norms import norm1, norm2sq
from .shift import circshift2d
from .threshold import hard_threshold, soft_threshold

__all__ = ["norm1", "norm2sq", "circshift2d", "soft_threshold", "hard_threshold"]
