"""Iterative align-and-average of archives, ppalign (counterpart of
pulseportraiture_tpu/pipeline/align.py; reference ppalign.py:65-280).

Each iteration loads every archive, seeds each subint's phase from its
frequency-scrunched profile (one batched rotation and phase-shift fit),
runs ONE batched (phi[, DM]) portrait fit per archive on the align's
device, and accumulates the weighted, back-rotated subints in the
harmonic domain; one inverse transform per iteration gives the new
template.  The psradd/psrsmooth subprocess steps of the reference are
internal averaging and wavelet smoothing.

On CUDA the fits take the fast lane in float32, and its fused DFT ->
cross-spectrum kernel (ops/fused.py, B1) runs in every iteration: over
the harmonic window that resolves from the iteration's template, or,
where a noisy template (the default seed, the first archive) resolves
none, over every harmonic (harmonic_window='full', the lane of
parallel.batch.align_iteration_sharded).  The template stays a host
numpy array, the only form fit.portrait.resolve_harmonic_window derives
a window from.
"""

import copy
import math
import time

import numpy as np
import torch

from ..device import resolve_auto, resolve_device
from ..fit.phase_shift import fit_phase_shift_batch
from ..fit.portrait import (FitFlags, fit_portrait_batch,
                            fit_portrait_batch_fast, resolve_harmonic_window,
                            use_fast_fit_default)
from ..io.psrfits import load_data, read_archive, unload_new_archive
from ..models.gaussian import gen_gaussian_profile
from ..ops.fourier import irfft_c, rfft_c
from ..ops.fused import kernel_launches
from ..ops.phasor import phase_shifts, phasor
from ..ops.rotation import rotate_full, rotate_portrait
from ..parallel.batch import (align_accumulate_archive,
                              align_accumulator_init, align_finalize,
                              use_align_device)
from .portrait import normalize_portrait
from .toas import _read_metafile

__all__ = ["psradd_archives", "psrsmooth_archive", "make_constant_portrait",
           "gaussian_seed_portrait", "align_archives", "align_stats"]

# subints per step of the phase-guess rotation and of the host lane's
# accumulate: a rotate_full of a whole 64 x 512 x 2048 float64 archive
# holds ~1 GB of spectra at once
_CHUNK = 16

_last_stats = {}


def align_stats():
    """What the last align_archives call in this process did: host walls
    [s] by stage ('load', 'template' (the window derivation and the
    template's copy to the device), 'guess', 'fit', 'accumulate',
    'finalize' (the inverse transform, and -N / --place / -r at the
    end), 'write'; on CUDA each stage ends with a synchronize, so its
    wall holds its device work), the archives skipped, and per
    iteration the fit's harmonic window K (None: the full spectrum or
    the complex engine), the archives accumulated and the fused
    kernels' launch counts (ops.fused.kernel_launches keys)."""
    return copy.deepcopy(_last_stats)


def psradd_archives(datafiles, outfile=None, quiet=False):
    """Average archives without alignment (internal psradd -T
    equivalent; reference ppalign.py:30-47).  Returns the (nchan, nbin)
    average portrait (host numpy) and writes it as an archive if outfile
    is given."""
    total = None
    wsum = None
    first_arch = None
    for path in datafiles:
        d = load_data(path, dedisperse=True, tscrunch=True, pscrunch=True,
                      quiet=True)
        if first_arch is None:
            first_arch = read_archive(path)
            first_arch.tscrunch()
            first_arch.pscrunch()
        port = np.asarray(d.subints[0, 0])
        w = np.asarray(d.weights[0])[:, None]
        total = port * w if total is None else total + port * w
        wsum = w if wsum is None else wsum + w
    avg = total / np.maximum(wsum, 1e-30)
    if outfile is not None:
        unload_new_archive(avg[None, None], first_arch, outfile, DM=0.0,
                           dmc=1, quiet=quiet)
    return avg


def psrsmooth_archive(datafile, outfile=None, device=None, **kwargs):
    """Wavelet-smooth an archive's portrait on ``device`` (default cuda;
    internal psrsmooth -W equivalent, reference ppalign.py:50-62) and
    write it to outfile (default datafile + '.sm').  kwargs go to
    models.wavelet.wavelet_smooth.  Returns the host numpy portrait."""
    from ..models.wavelet import wavelet_smooth

    dev = resolve_device(device)
    d = load_data(datafile, dedisperse=True, tscrunch=True, pscrunch=True,
                  quiet=True)
    sm = wavelet_smooth(np.asarray(d.subints[0, 0]), device=dev,
                        **kwargs).cpu().numpy()
    if outfile is None:
        outfile = datafile + ".sm"
    arch = read_archive(datafile)
    arch.tscrunch()
    arch.pscrunch()
    unload_new_archive(sm[None, None], arch, outfile, DM=0.0, dmc=1,
                       quiet=True)
    return sm


def make_constant_portrait(profile_or_archive, nchan):
    """Tile one profile across nchan channels (reference
    make_constant_portrait, pplib.py:993-1029); an archive path gives
    its fully scrunched profile."""
    if isinstance(profile_or_archive, str):
        d = load_data(profile_or_archive, dedisperse=True, tscrunch=True,
                      pscrunch=True, fscrunch=True, quiet=True)
        prof = np.asarray(d.subints[0, 0, 0])
    else:
        prof = np.asarray(profile_or_archive, float)
    return np.tile(prof, (nchan, 1))


def gaussian_seed_portrait(nchan, nbin, fwhm, loc=0.5, device=None):
    """Single-Gaussian constant template, host numpy (nchan, nbin),
    generated on ``device`` (default cuda; reference ppalign.py '-g fwhm'
    path, :386-396)."""
    prof = gen_gaussian_profile(
        {"dc": 0.0, "locs": np.array([loc]), "wids": np.array([fwhm]),
         "amps": np.array([1.0]), "mlocs": np.zeros(1),
         "mwids": np.zeros(1), "mamps": np.zeros(1),
         "tau": 0.0, "alpha": 0.0}, nbin, scattered=False, device=device)
    return np.tile(prof.cpu().numpy(), (nchan, 1))


def _host(x):
    """A fit leaf (tensor or array) as host float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, float)


def _host_accumulate_archive(aligned_FT, total_weights, sub_cube, phis,
                             DMs, nu_ref_fit, Ps_ok, freqs0, noise,
                             masks, scales):
    """The host lane of one archive's weighted back-rotated accumulate
    (reference ppalign.py:236-242): weights = scales / noise^2, the
    rotation a phasor multiply in the harmonic domain, float64 and
    complex128 on the CPU in chunks of 16 subints; the one inverse
    transform comes after the archive loop.  aligned_FT (npol, nchan,
    nharm) complex128 and total_weights (nchan, nbin) (host numpy) are
    updated and returned; scales arrives mask-multiplied.  Masked
    channels weigh exactly zero even with NaN scales (a where, as in
    the device lane's weights; the JAX package's host lane multiplies)."""
    noise_safe = np.where(noise > 0.0, noise, np.inf)
    w = np.where(masks > 0.0,
                 masks * np.maximum(scales, 0.0) / noise_safe ** 2, 0.0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=float))

    delays = phase_shifts(t(phis)[:, None], t(DMs)[:, None], 0.0,
                          t(freqs0)[None, :], t(Ps_ok)[:, None],
                          t(nu_ref_fit)[:, None], 1.0)
    for lo in range(0, len(sub_cube), _CHUNK):
        sl = slice(lo, lo + _CHUNK)
        cFT = rfft_c(t(sub_cube[sl]))
        ph = phasor(delays[sl], cFT.shape[-1])
        aligned_FT += torch.sum(cFT * ph[:, None]
                                * t(w[sl])[:, None, :, None], dim=0).numpy()
    total_weights += w.sum(axis=0)[:, None]
    return aligned_FT, total_weights


def _phase_guesses(cube, Ps_ok, freqs0, DM_guess, mean_model, noise, dev):
    """Each subint's phase relative to the template's mean profile: its
    first-polarization portrait dedispersed by DM_guess and scrunched in
    frequency, then one batched FFTFIT (ppalign.py:214-219), on the
    align's device in the cube's dtype."""
    nok, nchan, nbin = cube.shape[0], cube.shape[2], cube.shape[3]
    Ps_t = torch.as_tensor(Ps_ok, dtype=cube.dtype, device=dev)
    freqs_t = torch.as_tensor(freqs0, dtype=cube.dtype, device=dev)
    profs = torch.empty((nok, nbin), dtype=cube.dtype, device=dev)
    for lo in range(0, nok, _CHUNK):
        sl = slice(lo, lo + _CHUNK)
        n = len(range(nok)[sl])
        rot = rotate_full(cube[sl, :1], 0.0, DM_guess, Ps_t[sl],
                          freqs_t.expand(n, nchan), math.inf)
        profs[sl] = rot[:, 0].mean(dim=1)
    r = fit_phase_shift_batch(profs, mean_model, np.median(noise, axis=1),
                              device=dev)
    return _host(r.phase)


def align_archives(metafile, initial_guess, fit_dm=True, tscrunch=False,
                   pscrunch=True, SNR_cutoff=0.0, outfile=None, norm=None,
                   rot_phase=0.0, place=None, niter=1, quiet=False,
                   align_device=None, device=None):
    """Iteratively align and average archives against a template
    (reference ppalign.py:65-280; the JAX package's options and
    semantics), on ``device`` (default cuda).

    metafile: a metafile path or a list of archive paths.
    initial_guess: an archive path OR an (nchan, nbin) portrait array.
    The output archive has DM=0, dmc=1 and unit weights.  Returns the
    final average portrait (npol, nchan, nbin), host numpy float64.

    align_device: None -> config.align_device; 'auto' = the accumulate
    on ``device`` when it is CUDA (parallel/batch.py, float32 there,
    float64 elsewhere); False = the host lane, a float64 accumulate on
    the CPU (the fits still run on ``device``); True forces the device
    lane.  Nothing switches lanes on its own.  Unreadable or mismatched
    archives are skipped with a message, as in the JAX package
    (align_stats() lists them).
    """
    global _last_stats
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if isinstance(metafile, str):
        datafiles = _read_metafile(metafile)
        if outfile is None:
            outfile = metafile + ".algnd.fits"
    else:
        datafiles = list(metafile)
        if outfile is None:
            outfile = "aligned.algnd.fits"
    state = "Intensity" if pscrunch else "Stokes"
    npol = 1 if pscrunch else 4
    walls = dict.fromkeys(("load", "template", "guess", "fit",
                           "accumulate", "finalize", "write"), 0.0)
    stats = {"walls": walls, "skipped": [], "iterations": []}
    _last_stats = stats
    t_last = time.perf_counter()

    def lap(stage):
        nonlocal t_last
        if cuda:
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        walls[stage] += now - t_last
        t_last = now

    if isinstance(initial_guess, str):
        md = load_data(initial_guess, state=state, dedisperse=True,
                       tscrunch=True, pscrunch=pscrunch, quiet=quiet)
        model_port = np.asarray(md.masks[0, 0] * md.subints[0, 0])
        template_arch_path = initial_guess
        lap("load")
    else:
        model_port = np.asarray(initial_guess, float)
        template_arch_path = None
    nchan, nbin = model_port.shape[-2:]

    use_dev = use_align_device(align_device, dev)
    # the card's working dtype: the cube goes up once per archive in it
    # and serves the phase guess, the fit and the device accumulate
    # (float32 where device_f32 resolves on, as the JAX package runs
    # float32 on the TPU; the phasors stay accurate through the delays'
    # wrap to [-0.5, 0.5)); float64 elsewhere, where a device lane on the
    # CPU is the host lane's float64 peer
    dt = torch.float32 if resolve_auto("device_f32", "auto", dev) \
        else torch.float64

    skip_these = set()
    final = None
    for it in range(niter):
        if not quiet:
            print(f"Doing iteration {it + 1}...")
        before = kernel_launches()
        if use_dev:
            acc = align_accumulator_init(npol, nchan, nbin, dt, dev)
        else:
            aligned_FT = np.zeros((npol, nchan, nbin // 2 + 1), complex)
            total_weights = np.zeros((nchan, nbin))
        use_fast = use_fast_fit_default(dev)
        hwin = None
        if use_fast:
            # one copy of the shared template per iteration; the window
            # derives from the HOST template (a noisy one resolves None)
            model_t = torch.as_tensor(model_port, dtype=torch.float32,
                                      device=dev)
            hwin = resolve_harmonic_window(None, model_port, nbin)
        else:
            model_t = torch.as_tensor(model_port, dtype=torch.float64,
                                      device=dev)
        mean_model = model_port.mean(axis=0)
        naligned = 0
        lap("template")
        for path in datafiles:
            if path in skip_these:
                continue
            try:
                d = load_data(path, state=state, dedisperse=False,
                              dededisperse=True, tscrunch=tscrunch,
                              pscrunch=pscrunch, quiet=True)
            except Exception as e:  # noqa: BLE001 -- skip-and-continue,
                # the JAX package's semantics over unreadable archives
                print(f"Skipping {path}: {e}")
                skip_these.add(path)
                stats["skipped"].append((path, str(e)))
                continue
            reason = None
            ok = np.asarray(d.ok_isubs, int)
            if d.nchan != nchan or d.nbin != nbin:
                reason = "shape mismatch"
                print(f"Skipping {path}: shape mismatch")
            elif len(ok) == 0:
                reason = "no usable subints"
            elif SNR_cutoff and float(d.prof_SNR) < SNR_cutoff:
                reason = f"S/N {float(d.prof_SNR):.2f} < {SNR_cutoff}"
            if reason is not None:
                skip_these.add(path)
                stats["skipped"].append((path, reason))
                continue
            freqs0 = np.asarray(d.freqs[0], float)
            Ps_ok = np.asarray(d.Ps[ok], float)
            masks = np.asarray(d.weights[ok] > 0.0, float)
            noise = np.asarray(d.noise_stds[ok, 0], float)
            DM_guess = 0.0 if d.dmc else float(d.DM)
            sub_cube = np.asarray(d.subints[ok], float)  # (nok, npol, ...)
            cube = torch.as_tensor(sub_cube, dtype=dt, device=dev)
            lap("load")

            theta0 = np.zeros((len(ok), 5))
            theta0[:, 1] = DM_guess
            theta0[:, 0] = _phase_guesses(cube, Ps_ok, freqs0, DM_guess,
                                          mean_model, noise, dev)
            lap("guess")

            nchx = masks.sum(axis=1)
            if nchan > 1 and np.all(nchx > 1):
                # ppalign's fit is always (phi[, DM]), never scattering
                flags = FitFlags(True, bool(fit_dm), False, False, False)
                if use_fast:
                    f32 = torch.float32
                    res = fit_portrait_batch_fast(
                        cube[:, 0].to(f32), model_t,
                        noise.astype(np.float32),
                        freqs0.astype(np.float32), Ps_ok.astype(np.float32),
                        np.full(len(ok), freqs0.mean(), np.float32),
                        nu_out=freqs0.mean(),
                        theta0=theta0.astype(np.float32), fit_flags=flags,
                        chan_masks=masks.astype(np.float32),
                        harmonic_window=hwin if hwin is not None else "full",
                        device=dev)
                else:
                    res = fit_portrait_batch(
                        cube[:, 0], model_t, noise, freqs0, Ps_ok,
                        np.full(len(ok), freqs0.mean()),
                        nu_out=freqs0.mean(), theta0=theta0,
                        fit_flags=flags, chan_masks=masks, device=dev)
                # the fit leaves stay on the device: the accumulate
                # consumes them there
                phis, DMs = res.phi, res.DM
                scales, nu_ref_fit = res.scales, res.nu_DM
            else:  # 1-channel fallback (ppalign.py:230-235)
                phis = theta0[:, 0]
                DMs = np.full(len(ok), DM_guess)
                scales = masks.copy()
                nu_ref_fit = np.full(len(ok), freqs0.mean())
            lap("fit")

            # weighted accumulate of back-rotated subints
            # (ppalign.py:236-242): weights = scales / noise^2
            if use_dev:
                align_accumulate_archive(acc, cube, phis, DMs, nu_ref_fit,
                                         Ps_ok, freqs0, noise, masks, scales)
            else:
                aligned_FT, total_weights = _host_accumulate_archive(
                    aligned_FT, total_weights, sub_cube, _host(phis),
                    _host(DMs), _host(nu_ref_fit), Ps_ok, freqs0, noise,
                    masks, _host(scales) * masks)
            del cube  # before the next archive's load: one cube at a time
            naligned += 1
            lap("accumulate")
        if use_dev:
            if not bool(acc[2].any()):
                raise RuntimeError("no archives could be aligned")
            aligned = _host(align_finalize(acc, nbin))
        else:
            if not total_weights.any():
                raise RuntimeError("no archives could be aligned")
            aligned = irfft_c(torch.from_numpy(aligned_FT), n=nbin).numpy()
            aligned /= np.maximum(total_weights, 1e-30)[None]
        lap("finalize")
        after = kernel_launches()
        stats["iterations"].append({
            "K": hwin, "archives": naligned,
            "launches": {k: after[k] - before[k] for k in after}})
        model_port = aligned[0]
        final = aligned

    if norm is not None:
        for ipol in range(npol):
            final[ipol] = normalize_portrait(final[ipol], method=norm,
                                             device=dev)
        model_port = final[0]
    if place is not None:
        # put the peak at the requested phase (ppalign.py:255-261)
        prof = model_port.mean(axis=0)
        peak = np.argmax(prof) / nbin
        rot_phase = peak - place
    if rot_phase:
        final = _host(rotate_portrait(
            torch.as_tensor(final, dtype=torch.float64, device=dev),
            rot_phase))
        model_port = final[0]
    lap("finalize")

    # write into a cloned archive with DM=0 and unit weights
    # (ppalign.py:262-279)
    src = template_arch_path or datafiles[0]
    arch = read_archive(src)
    arch.tscrunch()
    if pscrunch:
        arch.pscrunch()
    if arch.nchan != nchan or arch.nbin != nbin:
        raise ValueError("template archive shape changed on reload")
    unload_new_archive(final[None] if final.ndim == 3 else final, arch,
                       outfile, DM=0.0, dmc=1,
                       weights=np.ones((1, nchan)), quiet=quiet)
    if not quiet:
        print(f"Wrote {outfile}.")
    lap("write")
    return final
