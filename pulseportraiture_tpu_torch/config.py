"""Behaviour-defining constants and knobs of the ported path.

The subset of ``pulseportraiture_tpu/config.py`` that the ported TOA
lanes read (the fast fit, the scattering fits, the complex engine, the
stream's raw transport and its codec, the trace plane, the serving loop
and its result cache, metrics and SLOs), with the same defaults.  A
tri-state whose ``'auto'`` arm meant "on a TPU" there means "on a CUDA
device" here (device.resolve_auto).

The PPT_* environment hooks (:func:`env_overrides`) are applied once at
import, as in the JAX package; a script that sets its own defaults calls
env_overrides() again afterwards so the environment wins.
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

# Lossless transport codec of the stream's raw copy stage
# (io/blockcodec.py): an int16/byte payload whose subint rows all span
# fewer levels than a narrower width ships as packed w-bit residuals
# plus one per-subint minimum, unpacked exactly on the device.
#   False (default): never.
#   'auto': the per-pipeline cost model decides per dispatch from the
#           link rate it measured on its own copies and the codec rate
#           of its own encodes.
#   True:  whenever a narrower width exists (the deterministic A/B arm).
# .tim output is identical compressed or not.
transport_compress = False

# Ship NBIT=1/2/4 DATA columns PACKED to the device in the stream's raw
# lane (decoded there).  False refuses the sub-byte layouts in
# io.psrfits.read_archive(decode=False), and the stream falls back to
# the host-decoded lane per archive.
raw_subbyte = True

# Fold-symmetry matmul DFT (half-length contraction).
#   False (default): direct matmul.  'auto': fold off CUDA only.
#   True: fold everywhere.
# On CUDA it shapes only the float64 GEMM arm of the fused kernels: their
# float32 GEMM arm folds every even nbin >= 8 whatever this says, and
# their FFT arm never folds.
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

# --- Channel zapping (quality/, pipeline/zap.py) -------------------------
# Route the median-algorithm zap statistics (pipeline/zap.py,
# quality/excision.py) through the batched torch cut on the device, every
# subint of an archive at once.  'auto' = on CUDA devices; True/False
# force.  The host lane (the reference loop vectorized in numpy) is the
# oracle: the masked median is exact on both, the std agrees to ~1 ulp
# of accumulation, and the flagged lists are gated equal by the tests.
zap_device = "auto"

# Run ppalign's rotate-and-accumulate template update (parallel/batch.py)
# on the align's device: the split-real harmonic accumulate in float32
# where device_f32 resolves on (CUDA), float64 elsewhere.  'auto' = on
# CUDA devices; False is the host lane, a float64 accumulate on the CPU
# (the fits still run on the align's device).
align_device = "auto"

# --- Template building (fit/lm.py, fit/gauss.py, pipeline/gauss.py) ------
# Upper bound on Gaussian FWHM [rotations] in template fits.
wid_max = 0.25

# The .gmodel evolution code of a new model: power laws in loc, wid and
# amp.
default_model_code = "000"

# Run template building's Gaussian LM fits (the breadth-first profile
# trials of pipeline/gauss.auto_fit_profile) through the BATCHED engine
# (fit/lm.levenberg_marquardt_batched): every trial in one batched
# dispatch instead of one serial LM per trial.  'auto' = on CUDA
# devices; True/False force.  The serial lane, the same padded problems
# through the single-problem engine one at a time, is the oracle.
gauss_device = "auto"

# The LM engine's Jacobian source:
#   'auto' (default): the closed-form residual Jacobian whenever the
#          caller provides one; torch.func.jacfwd otherwise.
#   'analytic': require the closed form (a fit without one raises).
#   'ad': force torch.func.jacfwd, the oracle lane.
lm_jacobian = "auto"

# Straggler-compaction chunk length of the batched template LM fits:
# the still-iterating problems are re-batched every this many
# iterations.  The results do not depend on it (the split falls on
# exact iteration boundaries); None = one uninterrupted dispatch.
lm_compact_every = 16

# --- Autotune (tune/: the per-backend autotune subsystem) ----------------
# Path of the persisted JSON tuning DB (tune/store.TuningStore): the
# autotune sweep's accepted winners, keyed by (backend fingerprint,
# shape class).  None (default) = no persistence: every
# tune.ensure_tuned call sweeps again.  A DB written on another backend
# fingerprint (another card or torch build, or the JAX package) is
# refused with a loud warning, never applied, never fatal.  CLI:
# pptoas/ppserve/pproute --tune-db.
tune_db = None
# Whether campaign entry points (pptoas --autotune) run the autotune
# sweep when the tuning DB has no entry for this backend and shape
# class.  False (default): tuning is explicit, a campaign never pays
# sweep time unasked.
autotune = False
# Opt-in for the NUMERICS knob tier (tune/autotune.NUMERICS_TIER:
# cross_spectrum_dtype).  It changes output digits, so it is never swept
# silently: False (default) sweeps only the output-identical tier (and
# every candidate there is still byte-gated against the default).
tune_numerics = False

# --- Timing (timing/fleet.py, timing/incremental.py) ---------------------
# Route the fleet timing stage's GLS solves (timing/fleet.fleet_gls_fit,
# pptime) through the BATCHED lane: per-pulsar whitened systems bucketed
# by power-of-two (rows, params) class, zero-padded, each bucket solved
# by one batched torch program on the fleet's device.  'auto' = on CUDA
# devices; True/False force.  The host-NumPy per-pulsar path (False) is
# the digit oracle and the CPU default.
gls_device = "auto"

# Full-resolve cadence of the incremental GLS lane
# (timing/incremental.IncrementalGLS): every this-many sequential TOA
# updates the lane rebuilds the batch system, compares, and raises
# GLSDriftError beyond its tolerance; 0 disables the periodic gate
# (structural resolves on epoch renumbering still happen).
gls_resolve_every = 64

# Threshold [standard deviations] of the median-algorithm channel cut
# (the reference's nstd=3): a channel whose noise level exceeds
# median + zap_nstd*std of the surviving channels is flagged,
# iteratively.  Shared by ppzap and the stream drivers' zap_inline.
zap_nstd = 3.0


# --- Quality-gated refit (serve/server.ToaServer) --------------------------
# The serving loop's closed quality loop: a request archive whose fitted
# TOAs trip the thresholds below gets exactly ONE automatic zap-and-refit
# through the same warm lane before its .tim demuxes.  Off by default:
# the .tim is byte-identical with the loop on or off for data that never
# trips a gate.
quality_refit = False

# A TOA whose goodness-of-fit (reduced chi^2, the -gof flag) exceeds
# this trips the refit gate (the reference's ppzap -R threshold).
quality_max_gof = 1.3

# A TOA whose S/N falls below this trips the refit gate; 0 disables the
# S/N gate.
quality_min_snr = 0.0


# --- Serving (serve/) ------------------------------------------------------
# Deadline of partially filled buckets in the serving loop: a bucket
# launches when full (nsub_batch subints) or when its oldest pending
# subint has waited this many milliseconds.  ToaServer(max_wait_ms=) /
# ppserve --max-wait-ms override it per server.
serve_max_wait_ms = 50.0

# Admission-queue capacity of the serving loop in ARCHIVES across all
# pending requests; a submit beyond it is rejected (serve.ServeRejected)
# rather than queued into unbounded host memory.
serve_queue_depth = 64

# Per-tenant pending-archive quota inside the admission queue: an int
# caps every tenant, a dict {tenant: cap} (with an optional '*' default)
# caps named tenants, None applies only serve_queue_depth.
serve_tenant_quota = None

# Per-tenant weights of the admission queue's weighted-fair scheduler:
# {tenant: weight} ('*' sets the default; unlisted tenants weigh 1.0),
# in archives.  None = equal weights.
serve_tenant_weight = None

# Content-addressed result cache of completed .tim results
# (serve/cache.py; a hit is byte-identical to a fresh fit).  Tri-state:
# False off; 'auto' on iff cache_dir is set (so off out of the box);
# True on, and an error without cache_dir.
result_cache = "auto"
# Directory of the on-disk store (created on demand); None = no store.
cache_dir = None
# Store size bound in MB: least-recently-used entries evict beyond it.
cache_max_mb = 512.0

# The serving loop's streaming metrics registry (obs/metrics.py:
# counters and log-bucket latency histograms, ToaServer.metrics()).
# The .tim is byte-identical either way.
metrics = True

# Per-tenant request-latency SLO targets in seconds for the burn-rate
# engine (obs/slo.py): {tenant: seconds} with '*' as the default, or a
# bare number for every tenant.  None = no SLO tracking.
slo_targets = None

# --- Routing across a fleet (serve/router.py, fleet.py, transport.py) -----
# Default fleet of ToaRouter / pproute: a tuple of 'host:port' endpoints,
# each a ``ppserve --listen`` server.  () = none; pproute then needs
# --hosts or --fleet-file.
router_hosts = ()

# Total placement attempts the router spends on one request: every
# retryable ServeRejected and every unreachable host takes one, and each
# full pass over the fleet backs off exponentially (capped).
router_retry_max = 16

# Default endpoint of ``ppserve --listen``: 'host:port' (port 0 binds an
# ephemeral port, printed at start).  None = ppserve needs -r or --listen.
serve_listen = None

# Deadline [ms] of the router's per-host ``stat`` probes: a placement pass
# waits at most this long; a probe still outstanding feeds the host's
# SUSPECT transition and the cached load is used.  Must be > 0.
router_probe_ms = 1000.0

# Hedged requests [ms]: a routed request unresolved after this long
# launches ONE duplicate attempt on the least-loaded other host; the first
# completion wins.  None = off.
router_hedge_ms = None

# Watched fleet file (one host:port per line, # comments): the router
# joins and leaves hosts to match whenever it changes.  None = static.
router_fleet_file = None


# --- Online ingest (ingest/, ppwatch) --------------------------------------
# Poll cadence [ms] of the watch-folder source (ingest/source.
# WatchFolderSource): how often the directory is re-scanned, and the
# driver's idle sleep.  Per-source override via WatchFolderSource(poll_ms=).
ingest_poll_ms = 200.0

# Size-stability window [ms] of watch-folder admission: a file whose
# (size, mtime) changed within the last this-many milliseconds is presumed
# still being written and is not admitted; a '<name>.done' sentinel next to
# it bypasses the wait.  Per-source override via WatchFolderSource(stable_ms=).
ingest_stable_ms = 500.0

# CUSUM reference value k of the residual-stream detectors
# (ingest/alerts.py), in sigmas of the standardized residual: drifts below
# k per sample accumulate nothing.  Per-detector override via
# CusumDetector(k=).
alert_cusum_k = 0.5

# CUSUM decision threshold h (same units): an alert fires when a one-sided
# sum crosses h.  Per-detector override via CusumDetector(h=).
alert_cusum_h = 5.0

# ppmon's refresh interval [ms]: how often the endpoint's 'metrics' op is
# polled.  ppmon --interval overrides it.
mon_interval_ms = 1000.0


# --- Telemetry (telemetry.py) --------------------------------------------
# Path of the JSONL event trace the campaign drivers (GetTOAs,
# get_channels_to_zap, the stream drivers, stream_ipta_campaign, ppzap,
# build_templates, fleet_gls_fit) write.  None (default) = off: one
# attribute read per instrumentation site.  A driver's telemetry=
# argument (a path or a shared telemetry.Tracer) overrides it per call;
# read a trace with python -m pulseportraiture_tpu_torch.cli.pptrace.
telemetry_path = None

# Shared build directory of the hand kernels (ops/fused.build_kernels,
# the port's one compiled artefact): utils/device.enable_compile_cache()
# routes the build there, so a restarted replica or a fresh host on the
# same checkout loads the library built there instead of running nvcc
# again.  The stream executor and GetTOAs apply it on construction.
# None (default) = off: the checkout's build/torch_kernels.
compile_cache_dir = None


# --- Environment hooks ----------------------------------------------------
# One A/B switch per knob, applied once at import (env_overrides):
#
#   PPT_FIT_FUSED=off|auto|on       -> fit_fused
#   PPT_FUSED_BLOCK=<N>             -> fused_block
#   PPT_XSPEC=float32|bfloat16      -> cross_spectrum_dtype
#   PPT_DFT_PRECISION=highest|high|default -> dft_precision
#   PPT_DFT_FOLD=off|auto|on        -> dft_fold
#   PPT_ALIGN_DEVICE=off|auto|on    -> align_device
#   PPT_GAUSS_DEVICE=off|auto|on    -> gauss_device
#   PPT_GLS_DEVICE=off|auto|on      -> gls_device
#   PPT_GLS_RESOLVE_EVERY=<N>       -> gls_resolve_every
#   PPT_INGEST_POLL_MS=<float>      -> ingest_poll_ms
#   PPT_INGEST_STABLE_MS=<float>    -> ingest_stable_ms
#   PPT_ALERT_CUSUM_K=<float>       -> alert_cusum_k
#   PPT_ALERT_CUSUM_H=<float>       -> alert_cusum_h
#   PPT_MON_INTERVAL_MS=<float>     -> mon_interval_ms
#   PPT_LM_JACOBIAN=auto|analytic|ad -> lm_jacobian
#   PPT_ZAP_DEVICE=off|auto|on      -> zap_device
#   PPT_ZAP_NSTD=<float>            -> zap_nstd
#   PPT_STREAM_DEVICES=auto|<N>     -> stream_devices
#   PPT_MAX_INFLIGHT=<N>            -> stream_max_inflight
#   PPT_PIPELINE_DEPTH=<N>          -> stream_pipeline_depth
#   PPT_BUCKET_PAD=off|auto|on      -> bucket_pad
#   PPT_RAW_SUBBYTE=on|off          -> raw_subbyte
#   PPT_TRANSPORT_COMPRESS=off|auto|on -> transport_compress
#   PPT_TELEMETRY=<path>|off|none|0 -> telemetry_path
#   PPT_COMPILE_CACHE=<dir>|off     -> compile_cache_dir
#   PPT_QUALITY_REFIT=off|on        -> quality_refit
#   PPT_QUALITY_MAX_GOF=<float>     -> quality_max_gof
#   PPT_QUALITY_MIN_SNR=<float>     -> quality_min_snr
#   PPT_SERVE_MAX_WAIT_MS=<float>   -> serve_max_wait_ms
#   PPT_SERVE_QUEUE_DEPTH=<N>       -> serve_queue_depth
#   PPT_SERVE_TENANT_QUOTA=<N>|t:N,...|off -> serve_tenant_quota
#   PPT_SERVE_TENANT_WEIGHT=t:W,...|off    -> serve_tenant_weight
#   PPT_RESULT_CACHE=off|auto|on    -> result_cache
#   PPT_CACHE_DIR=<dir>|off         -> cache_dir
#   PPT_CACHE_MAX_MB=<float>        -> cache_max_mb
#   PPT_METRICS=off|on              -> metrics
#   PPT_SLO_TARGETS=t:S,...|<S>|off -> slo_targets
#   PPT_ROUTER_HOSTS=h:p,...|off    -> router_hosts
#   PPT_ROUTER_RETRY_MAX=<N>        -> router_retry_max
#   PPT_SERVE_LISTEN=h:p|off        -> serve_listen
#   PPT_ROUTER_PROBE_MS=<float>     -> router_probe_ms
#   PPT_ROUTER_HEDGE_MS=<float>|off -> router_hedge_ms
#   PPT_ROUTER_FLEET_FILE=<path>|off -> router_fleet_file
#   PPT_TUNE_DB=<path>|off          -> tune_db
#   PPT_AUTOTUNE=off|on             -> autotune
#   PPT_TUNE_NUMERICS=off|on        -> tune_numerics
#
# Unset variables leave the module values untouched; a bad value of a
# hooked variable raises ValueError (a silent fallback would quietly
# invalidate an A/B run).  The JAX package reads more PPT_* variables
# (KNOWN_PPT_ENV) whose knobs the port does not have yet: each warns once
# with the ROADMAP item that brings it (UNPORTED_PPT_ENV).  Any other
# PPT_*-prefixed name warns once as unrecognized, with the closest known
# name.

# Every PPT_* variable the JAX package reads: its config hooks plus its
# benchmark and smoke-test shape knobs.
KNOWN_PPT_ENV = frozenset({
    "PPT_LM_JACOBIAN", "PPT_FIT_FUSED",
    "PPT_FIT_PALLAS", "PPT_FUSED_BLOCK",
    "PPT_XSPEC", "PPT_DFT_PRECISION", "PPT_DFT_FOLD",
    "PPT_ALIGN_DEVICE", "PPT_GAUSS_DEVICE",
    "PPT_GLS_DEVICE", "PPT_ZAP_DEVICE", "PPT_ZAP_NSTD",
    "PPT_QUALITY_REFIT", "PPT_QUALITY_MAX_GOF", "PPT_QUALITY_MIN_SNR",
    "PPT_STREAM_DEVICES", "PPT_MAX_INFLIGHT",
    "PPT_PIPELINE_DEPTH", "PPT_COMPILE_CACHE", "PPT_TELEMETRY",
    "PPT_SERVE_MAX_WAIT_MS", "PPT_SERVE_QUEUE_DEPTH", "PPT_BUCKET_PAD",
    "PPT_INGEST_POLL_MS", "PPT_INGEST_STABLE_MS",
    "PPT_ALERT_CUSUM_K", "PPT_ALERT_CUSUM_H", "PPT_GLS_RESOLVE_EVERY",
    "PPT_ROUTER_HOSTS", "PPT_ROUTER_RETRY_MAX", "PPT_SERVE_LISTEN",
    "PPT_ROUTER_PROBE_MS", "PPT_ROUTER_HEDGE_MS",
    "PPT_ROUTER_FLEET_FILE", "PPT_SERVE_TENANT_QUOTA",
    "PPT_SERVE_TENANT_WEIGHT",
    "PPT_RAW_SUBBYTE", "PPT_TRANSPORT_COMPRESS",
    "PPT_RESULT_CACHE", "PPT_CACHE_DIR", "PPT_CACHE_MAX_MB",
    "PPT_TUNE_DB", "PPT_AUTOTUNE", "PPT_TUNE_NUMERICS",
    "PPT_METRICS", "PPT_SLO_TARGETS", "PPT_MON_INTERVAL_MS",
    # benchmark / smoke-test shape and mode knobs
    "PPT_NB", "PPT_NE", "PPT_NPSR", "PPT_NARCH", "PPT_NSUB",
    "PPT_NSUBB", "PPT_NCHAN", "PPT_NBIN", "PPT_NITER", "PPT_K",
    "PPT_NREQ", "PPT_NHOSTS", "PPT_DEVICES", "PPT_CAMPAIGN_CACHE",
    "PPT_ALIGN_CACHE",
    "PPT_GAUSS_CACHE", "PPT_NGAUSS",
    "PPT_TEMPLATE_NOISE", "PPT_STREAM_SPEEDUP_GATE",
    "PPT_HARMONIC_WINDOW", "PPT_TUNNEL_EMU", "PPT_RETUNE",
    "PPT_ZIPF_S", "PPT_CACHE_SPEEDUP_GATE",
    "PPT_NSEEDS", "PPT_INGEST_P99_GATE",
    "PPT_TUNE_NRUN", "PPT_SLOW_MS", "PPT_OBS_OVERHEAD_GATE",
})

# The hooks env_overrides applies here.
HOOKED_PPT_ENV = frozenset({
    "PPT_LM_JACOBIAN", "PPT_GAUSS_DEVICE", "PPT_FIT_FUSED",
    "PPT_FUSED_BLOCK", "PPT_XSPEC", "PPT_DFT_PRECISION", "PPT_DFT_FOLD",
    "PPT_ALIGN_DEVICE", "PPT_ZAP_DEVICE", "PPT_ZAP_NSTD",
    "PPT_STREAM_DEVICES", "PPT_MAX_INFLIGHT", "PPT_PIPELINE_DEPTH",
    "PPT_BUCKET_PAD", "PPT_RAW_SUBBYTE", "PPT_GLS_DEVICE",
    "PPT_GLS_RESOLVE_EVERY", "PPT_TRANSPORT_COMPRESS", "PPT_TELEMETRY",
    "PPT_QUALITY_REFIT", "PPT_QUALITY_MAX_GOF", "PPT_QUALITY_MIN_SNR",
    "PPT_SERVE_MAX_WAIT_MS", "PPT_SERVE_QUEUE_DEPTH",
    "PPT_SERVE_TENANT_QUOTA", "PPT_SERVE_TENANT_WEIGHT",
    "PPT_RESULT_CACHE", "PPT_CACHE_DIR", "PPT_CACHE_MAX_MB",
    "PPT_METRICS", "PPT_SLO_TARGETS", "PPT_ROUTER_HOSTS",
    "PPT_ROUTER_RETRY_MAX", "PPT_SERVE_LISTEN", "PPT_ROUTER_PROBE_MS",
    "PPT_ROUTER_HEDGE_MS", "PPT_ROUTER_FLEET_FILE",
    "PPT_INGEST_POLL_MS", "PPT_INGEST_STABLE_MS", "PPT_ALERT_CUSUM_K",
    "PPT_ALERT_CUSUM_H", "PPT_MON_INTERVAL_MS", "PPT_TUNE_DB",
    "PPT_AUTOTUNE", "PPT_TUNE_NUMERICS", "PPT_COMPILE_CACHE"})


def _unported_ppt_env():
    """{KNOWN_PPT_ENV name without a hook here: why, and its ROADMAP
    item}."""
    why = {}
    why["PPT_FIT_PALLAS"] = (
        "the JAX package's Pallas mode; the port's kernels run wherever "
        "fit_fused resolves on (PPT_FIT_FUSED)")
    for name in KNOWN_PPT_ENV - HOOKED_PPT_ENV - set(why):
        why[name] = ("a shape knob of the JAX package's benchmarks; the "
                     "port's bench is ROADMAP A5")
    return why


UNPORTED_PPT_ENV = _unported_ppt_env()

def parse_tenant_spec(raw, name, cast=int, allow_bare=True):
    """Parse a tenant QoS spec: '<N>' (every tenant, needs allow_bare)
    or 'tenantA:N,tenantB:M[,*:K]' -> int-or-dict, with the JAX
    package's ValueErrors; shared by the PPT_SERVE_TENANT_* and
    PPT_SLO_TARGETS hooks and the ppserve CLI."""
    s = str(raw).strip()
    if not s:
        raise ValueError(f"{name}: empty tenant spec")
    if ":" not in s:
        if not allow_bare:
            raise ValueError(
                f"{name} must be 'tenant:value[,tenant:value...]' "
                f"pairs, got {s!r} (a bare value is meaningless for "
                "weights — equal weights are the default)")
        try:
            v = cast(s)
        except ValueError:
            raise ValueError(
                f"{name} must be a number or tenant:value pairs, got "
                f"{s!r}")
        if not v > 0:
            raise ValueError(f"{name} must be > 0, got {v}")
        return v
    out = {}
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        tenant, sep, val = part.rpartition(":")
        if not sep or not tenant:
            raise ValueError(
                f"{name}: expected 'tenant:value', got {part!r}")
        try:
            v = cast(val)
        except ValueError:
            raise ValueError(
                f"{name}: expected a numeric value in {part!r}, got "
                f"{val!r}")
        if not v > 0:
            raise ValueError(
                f"{name}: value for tenant {tenant!r} must be > 0, "
                f"got {v}")
        if tenant in out:
            raise ValueError(
                f"{name}: tenant {tenant!r} listed twice")
        out[tenant] = v
    if not out:
        raise ValueError(f"{name}: no tenant:value pairs in {raw!r}")
    return out


def parse_hostport(spec):
    """'host:port' -> (host, port), with the JAX package's ValueErrors;
    shared by the router env hooks, the transports and the CLIs."""
    s = str(spec).strip()
    host, sep, port = s.rpartition(":")
    if not sep or not host:
        raise ValueError(f"expected 'host:port', got {spec!r}")
    try:
        port = int(port)
    except ValueError:
        raise ValueError(
            f"expected an integer port in {spec!r}, got {port!r}")
    if not 0 <= port <= 65535:
        raise ValueError(f"port {port} out of range in {spec!r}")
    return host, port


_warned_ppt = set()  # warn ONCE per process per variable

_TRISTATE = {"off": False, "false": False, "auto": "auto", "on": True,
             "true": True}
_ONOFF = {"off": False, "false": False, "on": True, "true": True}


def _warn_ppt_vars(environ):
    """Warn (once, stderr) about PPT_* variables the port reads nothing
    from: known JAX-package hooks without a knob here (with their
    ROADMAP item) and unrecognized names (with the closest known one)."""
    import difflib
    import sys as _sys

    for name in sorted(environ):
        if (not name.startswith("PPT_") or name in HOOKED_PPT_ENV
                or name in _warned_ppt):
            continue
        _warned_ppt.add(name)
        if name in UNPORTED_PPT_ENV:
            print(f"pulseportraiture_tpu_torch.config: ignoring {name}, "
                  f"which the port does not read yet: "
                  f"{UNPORTED_PPT_ENV[name]}", file=_sys.stderr)
            continue
        close = difflib.get_close_matches(name, KNOWN_PPT_ENV, n=1)
        hint = f" (did you mean {close[0]}?)" if close else ""
        print(f"pulseportraiture_tpu_torch.config: ignoring unrecognized "
              f"environment variable {name}{hint} -- known PPT_* hooks "
              "are listed in config.KNOWN_PPT_ENV", file=_sys.stderr)


def _table(environ, name, table, what):
    val = environ.get(name, "").lower()
    if not val:
        return None
    if val not in table:
        raise ValueError(f"{name} must be {what}, got {val!r}")
    return (table[val],)


def _int_env(environ, name, what):
    raw = environ.get(name, "")
    if not raw:
        return None
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be {what}, got {raw!r}")
    return n


def _float_env(environ, name, what, ok, bound):
    """A float hook: None when unset; the JAX package's two ValueErrors
    (unparseable, then ``ok(v)`` false, naming ``bound``)."""
    raw = environ.get(name, "")
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"{name} must be {what}, got {raw!r}")
    if not ok(v):
        raise ValueError(f"{name} must be {bound}, got {v}")
    return (v,)


def _tenant_env(environ, name, cast, allow_bare):
    """A tenant-spec hook: 'off'/'none' clear it to None."""
    raw = environ.get(name, "")
    if not raw:
        return None
    if raw.lower() in ("off", "none"):
        return (None,)
    return (parse_tenant_spec(raw, name, cast=cast, allow_bare=allow_bare),)


def env_overrides():
    """Apply the PPT_* environment hooks to this module (the JAX
    package's env_overrides for the knobs the port has, with its
    ValueErrors); returns the names of the knobs it set."""
    import os as _os
    import sys as _sys

    cfg = _sys.modules[__name__]
    env = _os.environ
    changed = []

    def put(attr, val):
        if val is not None:
            setattr(cfg, attr, val[0])
            changed.append(attr)

    _warn_ppt_vars(env)
    put("lm_jacobian", _table(
        env, "PPT_LM_JACOBIAN", {v: v for v in ("auto", "analytic", "ad")},
        "'auto', 'analytic' or 'ad'"))
    put("fit_fused", _table(env, "PPT_FIT_FUSED", _TRISTATE,
                            "'off', 'auto' or 'on'"))
    n = _int_env(env, "PPT_FUSED_BLOCK",
                      "a positive integer channel block size")
    if n is not None:
        if not n > 0:
            raise ValueError(f"PPT_FUSED_BLOCK must be > 0, got {n}")
        put("fused_block", (n,))
    put("cross_spectrum_dtype", _table(
        env, "PPT_XSPEC", {"float32": None, "none": None,
                           "bfloat16": "bfloat16"},
        "'float32' or 'bfloat16'"))
    put("dft_precision", _table(
        env, "PPT_DFT_PRECISION",
        {v: v for v in ("highest", "high", "default")},
        "'highest', 'high' or 'default'"))
    put("dft_fold", _table(env, "PPT_DFT_FOLD", _TRISTATE,
                           "'off', 'auto' or 'on'"))
    put("align_device", _table(env, "PPT_ALIGN_DEVICE", _TRISTATE,
                               "'off', 'auto' or 'on'"))
    put("gauss_device", _table(env, "PPT_GAUSS_DEVICE", _TRISTATE,
                               "'off', 'auto' or 'on'"))
    put("zap_device", _table(env, "PPT_ZAP_DEVICE", _TRISTATE,
                             "'off', 'auto' or 'on'"))
    put("gls_device", _table(env, "PPT_GLS_DEVICE", _TRISTATE,
                             "'off', 'auto' or 'on'"))
    rev = env.get("PPT_GLS_RESOLVE_EVERY", "")
    if rev:
        try:
            n = int(rev)
        except ValueError:
            raise ValueError(
                "PPT_GLS_RESOLVE_EVERY must be a non-negative "
                f"integer (0 disables), got {rev!r}")
        if n < 0:
            raise ValueError(
                f"PPT_GLS_RESOLVE_EVERY must be >= 0, got {n}")
        put("gls_resolve_every", (n,))
    put("ingest_poll_ms", _float_env(
        env, "PPT_INGEST_POLL_MS", "a positive number of milliseconds",
        lambda v: v > 0, "> 0"))
    put("ingest_stable_ms", _float_env(
        env, "PPT_INGEST_STABLE_MS",
        "a non-negative number of milliseconds", lambda v: v >= 0, ">= 0"))
    put("alert_cusum_k", _float_env(
        env, "PPT_ALERT_CUSUM_K",
        "a non-negative number (in sigma units)", lambda v: v >= 0,
        ">= 0"))
    put("alert_cusum_h", _float_env(
        env, "PPT_ALERT_CUSUM_H", "a positive number (in sigma units)",
        lambda v: v > 0, "> 0"))
    znstd = env.get("PPT_ZAP_NSTD", "")
    if znstd:
        try:
            v = float(znstd)
        except ValueError:
            raise ValueError(
                "PPT_ZAP_NSTD must be a positive number of standard "
                f"deviations, got {znstd!r}")
        if not v > 0:
            raise ValueError(f"PPT_ZAP_NSTD must be > 0, got {v}")
        put("zap_nstd", (v,))
    sdev = env.get("PPT_STREAM_DEVICES", "").lower()
    if sdev:
        if sdev == "auto":
            put("stream_devices", ("auto",))
        else:
            try:
                n = int(sdev)
            except ValueError:
                raise ValueError(
                    "PPT_STREAM_DEVICES must be 'auto' or a positive "
                    f"device count, got {sdev!r}")
            if n < 1:
                raise ValueError(
                    "PPT_STREAM_DEVICES must be >= 1 when numeric, "
                    f"got {n}")
            put("stream_devices", (n,))
    for name, attr in (("PPT_MAX_INFLIGHT", "stream_max_inflight"),
                       ("PPT_PIPELINE_DEPTH", "stream_pipeline_depth")):
        n = _int_env(env, name, "a positive integer")
        if n is not None:
            if n < 1:
                raise ValueError(f"{name} must be >= 1, got {n}")
            put(attr, (n,))
    put("bucket_pad", _table(env, "PPT_BUCKET_PAD", _TRISTATE,
                             "'off', 'auto' or 'on'"))
    put("raw_subbyte", _table(env, "PPT_RAW_SUBBYTE", _ONOFF,
                              "'on' or 'off'"))
    put("transport_compress", _table(env, "PPT_TRANSPORT_COMPRESS",
                                     _TRISTATE, "'off', 'auto' or 'on'"))
    put("quality_refit", _table(env, "PPT_QUALITY_REFIT", _ONOFF,
                                "'off' or 'on'"))
    put("quality_max_gof", _float_env(
        env, "PPT_QUALITY_MAX_GOF",
        "a positive reduced-chi^2 threshold", lambda v: v > 0, "> 0"))
    put("quality_min_snr", _float_env(
        env, "PPT_QUALITY_MIN_SNR",
        "a non-negative S/N threshold (0 disables)", lambda v: v >= 0,
        ">= 0"))
    put("serve_max_wait_ms", _float_env(
        env, "PPT_SERVE_MAX_WAIT_MS",
        "a non-negative number of milliseconds", lambda v: v >= 0,
        ">= 0"))
    n = _int_env(env, "PPT_SERVE_QUEUE_DEPTH", "a positive integer")
    if n is not None:
        if n < 1:
            raise ValueError(f"PPT_SERVE_QUEUE_DEPTH must be >= 1, got {n}")
        put("serve_queue_depth", (n,))
    put("serve_tenant_quota", _tenant_env(env, "PPT_SERVE_TENANT_QUOTA",
                                          int, True))
    put("serve_tenant_weight", _tenant_env(env, "PPT_SERVE_TENANT_WEIGHT",
                                           float, False))
    put("result_cache", _table(env, "PPT_RESULT_CACHE", _TRISTATE,
                               "'off', 'auto' or 'on'"))
    cache = env.get("PPT_COMPILE_CACHE", "")
    if cache:
        # 'off'/'none'/'0' disable explicitly (a wrapper script can
        # force the cache off over a config default)
        put("compile_cache_dir",
            (None if cache.lower() in ("off", "none", "0") else cache,))
    cdir = env.get("PPT_CACHE_DIR", "")
    if cdir:
        put("cache_dir",
            (None if cdir.lower() in ("off", "none", "0") else cdir,))
    put("cache_max_mb", _float_env(
        env, "PPT_CACHE_MAX_MB", "a positive number of megabytes",
        lambda v: v > 0, "> 0"))
    put("metrics", _table(env, "PPT_METRICS", {**_ONOFF, "0": False,
                                               "1": True},
                          "'off' or 'on'"))
    slo = env.get("PPT_SLO_TARGETS", "")
    if slo:
        put("slo_targets", (None if slo.lower() in ("off", "none", "0")
                            else parse_tenant_spec(
                                slo, "PPT_SLO_TARGETS", cast=float,
                                allow_bare=True),))
    rh = env.get("PPT_ROUTER_HOSTS", "")
    if rh:
        if rh.lower() in ("off", "none"):
            put("router_hosts", ((),))
        else:
            hosts = []
            for part in rh.split(","):
                part = part.strip()
                if not part:
                    continue
                try:
                    parse_hostport(part)
                except ValueError as e:
                    raise ValueError(
                        "PPT_ROUTER_HOSTS must be a comma-separated "
                        f"list of host:port endpoints: {e}")
                hosts.append(part)
            if not hosts:
                raise ValueError(
                    "PPT_ROUTER_HOSTS must name at least one "
                    f"host:port endpoint (or 'off'), got {rh!r}")
            if len(set(hosts)) != len(hosts):
                raise ValueError(
                    f"PPT_ROUTER_HOSTS lists a duplicate endpoint: {rh!r}")
            put("router_hosts", (tuple(hosts),))
    n = _int_env(env, "PPT_ROUTER_RETRY_MAX", "a positive integer")
    if n is not None:
        if n < 1:
            raise ValueError(f"PPT_ROUTER_RETRY_MAX must be >= 1, got {n}")
        put("router_retry_max", (n,))
    put("router_probe_ms", _float_env(
        env, "PPT_ROUTER_PROBE_MS", "a positive number of milliseconds",
        lambda v: v > 0, "> 0"))
    hms = env.get("PPT_ROUTER_HEDGE_MS", "")
    if hms:
        put("router_hedge_ms", (None,) if hms.lower() in ("off", "none")
            else _float_env(env, "PPT_ROUTER_HEDGE_MS",
                            "a non-negative number of milliseconds or "
                            "'off'", lambda v: v >= 0, ">= 0"))
    ffile = env.get("PPT_ROUTER_FLEET_FILE", "")
    if ffile:
        put("router_fleet_file",
            (None if ffile.lower() in ("off", "none") else ffile,))
    listen = env.get("PPT_SERVE_LISTEN", "")
    if listen:
        if listen.lower() in ("off", "none"):
            put("serve_listen", (None,))
        else:
            try:
                parse_hostport(listen)
            except ValueError as e:
                raise ValueError(f"PPT_SERVE_LISTEN: {e}")
            put("serve_listen", (listen,))
    put("mon_interval_ms", _float_env(
        env, "PPT_MON_INTERVAL_MS", "a positive number of milliseconds",
        lambda v: v > 0, "> 0"))
    tdb = env.get("PPT_TUNE_DB", "")
    if tdb:
        put("tune_db",
            (None if tdb.lower() in ("off", "none", "0") else tdb,))
    onoff = {**_ONOFF, "0": False, "1": True}
    put("autotune", _table(env, "PPT_AUTOTUNE", onoff, "'off' or 'on'"))
    put("tune_numerics", _table(env, "PPT_TUNE_NUMERICS", onoff,
                                "'off' or 'on'"))
    tel = env.get("PPT_TELEMETRY", "")
    if tel:
        # 'off'/'none'/'0' disable explicitly (a wrapper script can force
        # telemetry off over a config default); anything else is the path
        put("telemetry_path",
            (None if tel.lower() in ("off", "none", "0") else tel,))
    return changed


env_overrides()
