from .norms import norm1, norm2sq, thresholded_norm1
from .shift import circshift2d
from .threshold import THR_ELEM, garrote_threshold, hard_threshold, soft_threshold

__all__ = ["norm1", "norm2sq", "thresholded_norm1", "circshift2d", "soft_threshold",
           "hard_threshold", "garrote_threshold", "THR_ELEM"]
