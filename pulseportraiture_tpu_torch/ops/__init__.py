"""Numerical ops of the port, exported here as the JAX package exports
them, but for the function ``phasor``: the name stays the submodule's.
The kernel modules (fused, fourier) are imported by name."""

from .decode import (PACKED_BITS, RAW_CODES, affine_decode,  # noqa: F401
                     decode_stokes_I, unpack_bitplanes)
from .filters import (brickwall_filter, find_kc, fit_brickwall,  # noqa: F401
                      get_noise_fit, half_triangle_function, wiener_filter)
from .ism import DMc_from_GM, GM_from_DMc, dDM, mean_C2N  # noqa: F401
from .noise import (channel_SNRs_FT, get_noise, get_noise_PS,  # noqa: F401
                    get_scales, get_SNR)
from .phasor import (DM_delay, cexp, dispersion_phases,  # noqa: F401
                     doppler_correct_freqs, guess_fit_freq, phase_shifts,
                     phase_transform)
from .gaussian import (dm_smearing_width, gaussian_profile,  # noqa: F401
                       gaussian_profile_FT, instrumental_response_FT,
                       instrumental_response_port_FT)
from .rotation import (add_DM_nu, fft_shift_bins, rotate_full,  # noqa: F401
                       rotate_portrait, rotate_profile)
from .scattering import (add_scattering,  # noqa: F401
                         scattering_kernel_time, scattering_portrait_FT,
                         scattering_profile_FT, scattering_times)
