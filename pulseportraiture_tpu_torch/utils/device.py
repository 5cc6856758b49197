"""Warm-up of the serving loop from a prior run's trace (counterpart of
pulseportraiture_tpu/utils/device.warmup_from_manifest).

Eager PyTorch compiles no program per shape.  What a first dispatch of
a bucket shape pays on a device is the kernels' module load, the FFT
plans of its sizes, the caching allocator's growth on the dispatch's
streams, and the first library handles of the pipeline's worker
threads.  The warm-up pays these before traffic arrives: ONE padded
dispatch per (manifest shape x device) through the stream's real launch
path (``pipeline/stream._launch``) on synthetic rows, through the
caller's own device pipelines when it passes them (a server passes its
executor's, so the allocator blocks, streams and worker threads it
warms are the ones the requests use).

The port's one compiled artefact is the library of its hand kernels
(ops/fused.build_kernels, built by nvcc at a process's first launch).
:func:`enable_compile_cache` (``config.compile_cache_dir``,
``PPT_COMPILE_CACHE``, ``pptoas`` / ``ppserve --compile-cache``) routes
its build directory to a shared one, so a restarted replica, or a fresh
host on the same checkout, loads the library built there instead of
running nvcc again.  :func:`host_compute` and :func:`on_host` place
torch work on the CPU, as the JAX package's helpers do for jnp.
"""

import functools
import os
import time

import numpy as np
import torch

__all__ = ["warmup_from_manifest", "host_compute", "on_host",
           "enable_compile_cache"]


def host_compute():
    """Context manager making the CPU torch's default device for the
    tensors created inside it (torch.device('cpu') as a context), the
    counterpart of the JAX package's host placement: small offline
    computations (phasors, 1-D guesses) that are cheaper on the host
    than one device dispatch."""
    return torch.device("cpu")


def on_host(fn):
    """Decorator: run the whole function under host_compute()."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with host_compute():
            return fn(*args, **kwargs)
    return wrapper


_compile_cache_dir = None  # what enable_compile_cache last applied


def enable_compile_cache(path=None):
    """Route the hand kernels' build directory (ops.fused.BUILD_DIR) to
    ``path`` (None = ``config.compile_cache_dir``), created on demand.
    The library is kept there under a digest of its sources, headers
    and flags (ops.fused.build_kernels), so every process that points
    at the directory loads the library the first one built, and a
    changed source builds beside it.  A false path ('' / None with no
    config value) unconfigures: the build directory goes back to the
    default (``build/torch_kernels`` in the checkout).  Returns the
    applied directory, or None when unconfigured.  Idempotent; takes
    effect at the process's next build (a library already loaded in
    this process stays)."""
    global _compile_cache_dir
    from .. import config
    from ..ops import fused

    if path is None:
        path = config.compile_cache_dir
    if not path:
        if _compile_cache_dir is not None:
            fused.BUILD_DIR = fused.DEFAULT_BUILD_DIR
            _compile_cache_dir = None
        return None
    path = os.path.abspath(str(path))
    if path != _compile_cache_dir:
        os.makedirs(path, exist_ok=True)
        fused.BUILD_DIR = path
        _compile_cache_dir = path
    return path

# Wire dtype of each raw sample code, as pipeline/stream's raw loader
# stacks them.
_WIRE = {"i16": np.int16, "u8": np.uint8, "i8": np.uint8,
         "f32": np.float32, "p1": np.uint8, "p2": np.uint8,
         "p4": np.uint8}


def _synthetic_bucket(S, spec, freqs, modelx, rng):
    """One synthetic row of a manifest shape's bucket (the dispatch pads
    it to nsub_batch): arbitrary values, a nonzero DM guess (the general
    seed-derotation path) and no re-dispersion."""
    from ..ops.decode import PACKED_BITS

    nchan, nbin = spec["nchan"], spec["nbin"]
    b = S._Bucket(freqs, nbin, modelx, spec["flags"], kind=spec["kind"],
                  raw_code=spec["raw_code"], pol_sum=spec["pol_sum"],
                  col_scaled=spec["col_scaled"])
    if spec["kind"] == "raw":
        nbit = PACKED_BITS.get(spec["raw_code"])
        if nbit is not None:
            plane = nchan * nbin * nbit // 8
            rshape = (2, plane) if spec["pol_sum"] else (plane,)
        else:
            rshape = ((2, nchan, nbin) if spec["pol_sum"]
                      else (nchan, nbin))
        cshape = (2, nchan) if spec["pol_sum"] else (nchan,)
        if spec["raw_code"] == "f32":
            b.raw.append(rng.standard_normal(rshape).astype(np.float32))
        else:
            b.raw.append(rng.integers(1, 100, size=rshape)
                         .astype(_WIRE[spec["raw_code"]]))
        b.scl.append(np.ones(cshape, np.float32))
        b.offs.append(np.zeros(cshape, np.float32))
        if spec["col_scaled"]:
            b.tscal.append(0.5)
            b.tzero.append(1.0)
        b.DM_guess.append(1.0)
        b.dedisp.append((0.0, 0.0))
    else:
        b.ports.append(rng.standard_normal((nchan, nbin)))
        b.noise.append(np.ones(nchan))
        b.nu_fits.append(float(freqs.mean()))
        th = np.zeros(5)
        th[1] = 1.0
        b.theta0.append(th)
    b.masks.append(np.ones(nchan))
    b.Ps.append(0.003)
    b.dfs.append(1.0)
    b.owners.append((0, 0))
    return b


def warmup_from_manifest(manifest_path, modelfile=None, devices=None,
                         nsub_batch=64, tracer=None, quiet=True,
                         max_iter=25, fit_scat=False, log10_tau=True,
                         scat_guess=None, print_flux=False,
                         nu_ref_DM=None, pipelines=None):
    """Dispatch every wideband bucket shape a prior run's trace records
    (its ``dispatch`` events' ``shape`` strings, parsed back by
    pipeline/stream.parse_shape_key) once per device, before a server
    takes traffic.

    ``modelfile`` shapes the warm-up template (its harmonic window
    selects the fit's arm); without one a synthetic smooth profile is
    used.  The fit options must match the serving workload's.
    ``devices``: the stream devices (resolve_stream_devices); with
    ``pipelines`` (one _DevicePipeline per device, e.g. an executor's)
    the dispatches run through them, else through temporary pipelines.
    Narrowband (flagless) shapes and sub-byte planes that do not
    byte-align are skipped with a warning.  Emits one
    ``warmup_compile`` per dispatch with its wall in ``compile_s`` (the
    schema's field name).  Returns the ``[(shape, device_index)]`` list
    dispatched; a server adds it to its executor's warm set, so the
    serve trace records no cold dispatch of these shapes."""
    from ..ops.decode import PACKED_BITS
    from ..pipeline import stream as S
    from ..pipeline.models import TemplateModel
    from ..telemetry import NULL_TRACER, load_trace, log

    tracer = NULL_TRACER if tracer is None else tracer
    _, events = load_trace(manifest_path)
    shapes = list(dict.fromkeys(
        ev["shape"] for ev in events
        if ev.get("type") == "dispatch" and ev.get("shape")))
    devices = S.resolve_stream_devices(devices)

    # tau seeding, as make_wideband_lane resolves it
    if scat_guess is not None and not isinstance(scat_guess, str):
        tau_mode = "explicit"
        tau_args = tuple(float(v) for v in scat_guess)
    elif fit_scat and scat_guess == "auto":
        tau_mode, tau_args = "auto", (0.0, 1.0, 0.0)
    elif fit_scat:
        tau_mode, tau_args = "neutral", (0.0, 1.0, 0.0)
    else:
        tau_mode, tau_args = "none", (0.0, 1.0, 0.0)
    if not fit_scat:
        log10_tau = False

    rng = np.random.default_rng(0)
    warmed = []
    t_all = time.perf_counter()
    for shape in shapes:
        try:
            spec = S.parse_shape_key(shape)
        except ValueError as e:
            log(f"warmup: skipping {shape!r}: {e}", level="warn")
            continue
        if spec["flags"] is None:
            log(f"warmup: skipping narrowband shape {shape!r} (only "
                "the wideband launch path is warmed)", level="warn")
            continue
        nchan, nbin = spec["nchan"], spec["nbin"]
        if spec["raw_code"] in PACKED_BITS \
                and (nchan * nbin * PACKED_BITS[spec["raw_code"]]) % 8:
            log(f"warmup: skipping {shape!r} (sub-byte plane does "
                "not byte-align)", level="warn")
            continue
        freqs = np.linspace(1400.0, 1600.0, nchan) if nchan > 1 \
            else np.array([1500.0])
        modelx = None
        if modelfile:
            try:
                modelx = TemplateModel(
                    modelfile, quiet=True, device=devices[0]).portrait(
                        freqs, nbin, P=0.003)
            except (OSError, ValueError) as e:
                log(f"warmup: template portrait failed for {shape!r} "
                    f"({e}); using a synthetic profile", level="warn")
        if modelx is None:
            ph = np.arange(nbin) / nbin
            prof = np.exp(-0.5 * ((ph - 0.3) / 0.02) ** 2)
            modelx = np.broadcast_to(prof, (nchan, nbin)).copy()
        for idev, dev in enumerate(devices):
            b = _synthetic_bucket(S, spec, freqs, modelx, rng)
            own = pipelines is None
            if own:
                pl = S._DevicePipeline(dev, idev, 1, NULL_TRACER,
                                       lambda seq: False)
            else:
                # the owner's pipeline, idle before serving starts: its
                # copy events stay out of the owner's trace
                pl = pipelines[idev]
                pl_tracer, pl.tracer = pl.tracer, NULL_TRACER
            t0 = time.perf_counter()
            try:
                rec = S._launch(b, nu_ref_DM, max_iter, nsub_batch, pl,
                                want_flux=print_flux, alpha0=-4.0, seq=0,
                                log10_tau=log10_tau, tau_mode=tau_mode,
                                tau_args=tau_args)
                rec[0].result().wait()
            finally:
                if own:
                    pl.shutdown(wait=True)
                else:
                    pl.tracer = pl_tracer
            dt = time.perf_counter() - t0
            if tracer.enabled:
                tracer.emit("warmup_compile", shape=shape, device=idev,
                            compile_s=round(dt, 6))
            warmed.append((shape, idev))
    if warmed:
        log(f"warmup: dispatched {len(warmed)} (shape x device) "
            f"bucket(s) from {manifest_path} in "
            f"{time.perf_counter() - t_all:.2f} s", quiet=quiet,
            tracer=None)
    return warmed
