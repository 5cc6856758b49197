"""Fit engines: the wideband portrait fits (the fast lane, its
scattering twin and the complex engine), the narrowband phase-shift
fit, the Levenberg-Marquardt engine and the Gaussian template fits,
the power-law fits."""

from .gauss import fit_gaussian_portrait, fit_gaussian_profile  # noqa: F401
from .lm import LMResult, levenberg_marquardt  # noqa: F401
from .phase_shift import fit_phase_shift, fit_phase_shift_batch  # noqa: F401
from .portrait import (FitFlags, FitResult, chi2_prime,  # noqa: F401
                       fit_portrait, fit_portrait_batch,
                       fit_portrait_batch_fast)
from .powlaw import (fit_DM_to_freq_resids, fit_powlaw,  # noqa: F401
                     powlaw, powlaw_freqs)
