"""Synthetic RFI injection (counterpart of pulseportraiture_tpu/synth/rfi.py):
the contaminated-data fixture of the quality tests and the chip check.

Two contamination shapes:

- **narrowband tones**: a few channels carry persistent interference,
  each tone a WHITE component (raises the channel's estimated noise
  level: what the ppzap median algorithm flags) plus an optional
  STRUCTURED low-harmonic component (corrupts the fit's goodness of fit
  without raising the power-spectrum-tail noise estimate much: what the
  post-fit cut flags);
- **broadband bursts**: one subint's contiguous channel block takes a
  strong white hit.

Everything is seeded and returns the ground-truth channel lists.
Amplitudes are in units of the archive's own median per-channel noise
level (the power-spectrum estimator the pipeline uses).  Host numpy
only; the archive is rewritten at 16 bits, as in the JAX package.
"""

import numpy as np

from ..io.psrfits import noise_std_ps, read_archive
from ..utils.bunch import DataBunch

__all__ = ["inject_rfi"]


def inject_rfi(path, tone_channels=(), tone_white=10.0,
               tone_structured=0.0, bursts=(), rng=None, outfile=None,
               quiet=True):
    """Inject RFI into an existing archive (in place, or to
    ``outfile``) and return the ground truth.

    tone_channels: channel indices contaminated in EVERY subint;
    tone_white / tone_structured: tone amplitudes in units of the
    archive's median per-channel noise (white: Gaussian per bin —
    elevates the noise estimate; structured: a random 2..4-cycle
    sinusoid across pulse phase — corrupts the profile at low
    harmonics, mostly invisible to the PS-tail noise estimator).
    bursts: (isub, channels, white_strength) triples — a one-subint
    broadband hit.

    Returns a DataBunch:
      zap_truth     — [subint][channels] whose NOISE level was raised
                      (what the median algorithm should recover);
      contaminated  — [subint][channels] touched by anything
                      (superset: structured-only tones corrupt fits
                      but are not noise-separable);
      noise_base    — the background noise unit used.
    """
    rng = np.random.default_rng(rng)
    arch = read_archive(path)
    amps = arch.amps  # (nsub, npol, nchan, nbin), decoded float
    nsub, npol, nchan, nbin = amps.shape
    base = float(np.median(noise_std_ps(amps)))
    if not base > 0:
        base = float(np.max(np.abs(amps))) * 1e-3 or 1.0
    phases = (np.arange(nbin) + 0.5) / nbin
    noisy = [set() for _ in range(nsub)]
    touched = [set() for _ in range(nsub)]
    for ch in tone_channels:
        ch = int(ch)
        if not 0 <= ch < nchan:
            raise ValueError(
                f"tone channel {ch} outside 0..{nchan - 1}")
        for isub in range(nsub):
            for ipol in range(npol):
                if tone_white:
                    amps[isub, ipol, ch] += (
                        tone_white * base
                        * rng.standard_normal(nbin))
                if tone_structured:
                    k = int(rng.integers(2, 5))
                    ph = float(rng.uniform())
                    amps[isub, ipol, ch] += (
                        tone_structured * base
                        * np.sin(2.0 * np.pi * (k * phases + ph)))
            if tone_white:
                noisy[isub].add(ch)
            touched[isub].add(ch)
    for isub, chans, strength in bursts:
        isub = int(isub)
        if not 0 <= isub < nsub:
            raise ValueError(f"burst subint {isub} outside 0..{nsub - 1}")
        for ch in chans:
            ch = int(ch)
            if not 0 <= ch < nchan:
                raise ValueError(
                    f"burst channel {ch} outside 0..{nchan - 1}")
            for ipol in range(npol):
                amps[isub, ipol, ch] += (
                    strength * base * rng.standard_normal(nbin))
            noisy[isub].add(ch)
            touched[isub].add(ch)
    arch.unload(outfile or path)
    if not quiet:
        n = sum(len(s) for s in touched)
        print(f"Injected RFI into {n} (subint, channel) cell(s) of "
              f"{outfile or path}.")
    return DataBunch(
        zap_truth=[sorted(s) for s in noisy],
        contaminated=[sorted(s) for s in touched],
        noise_base=base)
