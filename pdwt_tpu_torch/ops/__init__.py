from .estimate import bayes_thresholds, noise_sigma, sure_thresholds, universal_threshold
from .norms import (add_coeffs, norm1, norm2sq, norm_l21, thresholded_norm1,
                    thresholded_norm_l21)
from .shift import circshift1d, circshift2d, circshift3d, random_shift
from .threshold import (THR_ELEM, firm_threshold, garrote_threshold, group_soft_threshold,
                        hard_threshold, proj_linf, shrink, soft_threshold)

__all__ = ["soft_threshold", "hard_threshold", "group_soft_threshold", "proj_linf", "shrink",
           "garrote_threshold", "firm_threshold", "noise_sigma", "universal_threshold",
           "bayes_thresholds", "sure_thresholds", "norm1", "norm2sq", "norm_l21", "add_coeffs",
           "thresholded_norm1", "thresholded_norm_l21", "circshift1d", "circshift2d", "circshift3d",
           "random_shift", "THR_ELEM"]
