"""Numerical ops of the port.  The host numerics (filters, ism, noise,
phasor) are exported here as the JAX package exports them, but for the
function ``phasor``: the name stays the submodule's.  The kernel modules
(fused, decode, fourier) are imported by name."""

from .filters import (brickwall_filter, find_kc, fit_brickwall,  # noqa: F401
                      get_noise_fit, half_triangle_function, wiener_filter)
from .ism import DMc_from_GM, GM_from_DMc, dDM, mean_C2N  # noqa: F401
from .noise import (channel_SNRs_FT, get_noise, get_noise_PS,  # noqa: F401
                    get_scales, get_SNR)
from .phasor import (DM_delay, cexp, dispersion_phases,  # noqa: F401
                     doppler_correct_freqs, guess_fit_freq, phase_shifts,
                     phase_transform)
