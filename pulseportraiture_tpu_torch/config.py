"""Behaviour-defining constants and knobs of the ported path.

The subset of ``pulseportraiture_tpu/config.py`` that the ported TOA
lanes read (the fast fit, the scattering fits, the complex engine, the
stream's raw transport), with the same defaults.  A tri-state whose ``'auto'``
arm meant "on a TPU" there means "on a CUDA device" here
(device.resolve_auto).
"""

# --- Dispersion constant [MHz^2 s cm^3 / pc] ------------------------------
# Two conventions exist; the "traditional" value is the default,
# matching TEMPO.
Dconst_exact = 4.148808e3
Dconst_trad = 0.000241**-1
Dconst = Dconst_trad

# --- Scattering -----------------------------------------------------------
# Default scattering power-law index: tau(nu) = tau * (nu/nu_tau)**alpha.
scattering_alpha = -4.0

# --- Fourier DC term ------------------------------------------------------
# Weight applied to the k=0 (DC) harmonic in all Fourier-domain fits.
# 0 removes sensitivity to the baseline.
F0_fact = 0.0

# Route no-scattering pipeline fits through the complex-free fast fit
# (fit.portrait.fit_portrait_batch_fast), and the stream lane's
# scattering buckets through its complex-free scatter lane.  'auto' =
# on CUDA devices; True/False force.  Where it resolves False the
# pipelines run the complex engine (fit.portrait.fit_portrait_batch).
# GetTOAs always fits scattering groups with the complex engine.
use_fast_fit = "auto"

# Dot2-compensated k-reductions in scattering fits (hybrid: the plain
# loop to convergence, then a short compensated polish; float32 X).
scatter_compensated = False

# Fused DFT -> cross-spectrum stage of the fast fit (ops/fused.py):
# one hand-written CUDA kernel on a CUDA device, its plain PyTorch
# version on the CPU.  Takes effect only with a harmonic window.
#   False: unfused (two rfft_mm matmuls and elementwise products).
#   'auto' (default): fused on CUDA devices, unfused elsewhere.
#   True:  fused everywhere.
fit_fused = "auto"

# Channel-block size of the plain fused version's tiling (None: the
# built-in 32).  The CUDA kernel tiles by its own fixed block shape.
fused_block = None

# Matmul-DFT precision: 'highest' = full float32 products (the only
# setting the CUDA lane implements; 'high' and 'default' raise there).
dft_precision = "highest"

# Storage dtype for the fit's precomputed cross-spectrum Xr/Xi.
# 'bfloat16' halves the Newton loop's read traffic; applies only when
# the working dtype is float32.  None keeps float32 storage.
cross_spectrum_dtype = "bfloat16"

# --- Streaming campaign lane (pipeline/stream.py) ------------------------
# Devices full buckets are dealt across, round-robin: 'auto' = every
# visible CUDA device; an int N = the first N; or a device sequence.
stream_devices = "auto"
# Fused dispatches that may be pending per device before the host
# blocks on that device's oldest (the bound is exact).
stream_max_inflight = 4
# Buckets that may occupy a device's copy -> fit pipeline at once:
# 2 double-buffers the host->device copy against the running fit.
stream_pipeline_depth = 2
# Pad bucket channel counts to the next power of two with zero-weight
# channels.  False (default): exact shapes; 'auto': pad on CUDA
# devices; True: always pad.
bucket_pad = False

# Ship NBIT=1/2/4 DATA columns PACKED to the device in the stream's raw
# lane (decoded there).  False refuses the sub-byte layouts in
# io.psrfits.read_archive(decode=False), and the stream falls back to
# the host-decoded lane per archive.
raw_subbyte = True

# Fold-symmetry matmul DFT (half-length contraction).
#   False (default): direct matmul.  'auto': fold off CUDA only.
#   True: fold everywhere.
dft_fold = False

# Harmonic window of the fast fit:
#   "auto": derive K from a host-resident (numpy) model's spectrum;
#   int:    explicit harmonic count (rounded up to a multiple of 128);
#   None:   always full spectrum.
fit_harmonic_window = "auto"
# Maximum relative model power allowed beyond the window.
harmonic_window_tail = 1e-12
# Noise-floor-aware window derivation: the excess tail power must
# clear this many sigma of the template's own white-noise floor.
# None or 0 disables floor awareness.
harmonic_window_floor_sigma = 20.0
