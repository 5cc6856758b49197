"""Template models: Gaussian components with their frequency evolution,
PCA + B-spline portraits, wavelet smoothing."""

from .gaussian import (GaussianModel, evolve_parameter,  # noqa: F401
                       gen_gaussian_portrait, gen_gaussian_profile,
                       linear_evolution, power_law_evolution)
from .spline import (bspline_eval, fft_resample,  # noqa: F401
                     find_significant_eigvec, fit_spline_curve,
                     gen_spline_portrait, pca, reconstruct_portrait)
from .wavelet import (get_red_chi2, iswt, smart_smooth, swt,  # noqa: F401
                      wavelet_smooth)
