"""Portrait helpers (counterpart of pulseportraiture_tpu/pipeline/portrait.py).

Only :func:`normalize_portrait` is ported, for ``ppzap -N``; the
DataPortrait class and the template builders come with ROADMAP A9.
"""

import numpy as np

from ..fit.phase_shift import fit_phase_shift
from ..io.psrfits import noise_std_ps

__all__ = ["normalize_portrait"]


def normalize_portrait(port, method="rms", weights=None,
                       return_norms=False, device=None):
    """Normalize each channel profile (reference pplib.py:2553-2598):
    'mean' | 'max' | 'prof' (scale against the weighted mean profile
    by a phase-shift fit, on ``device``, default cuda) | 'rms' (unit
    noise) | 'abs' (unit L2 norm).  Host float64 in and out."""
    port = np.asarray(port, float)
    if method not in ("mean", "max", "prof", "rms", "abs"):
        raise ValueError(f"unknown normalization method {method!r}")
    norm_port = np.zeros_like(port)
    norm_vals = np.ones(len(port))
    if method == "prof":
        good = np.where(port.sum(axis=1) != 0.0)[0]
        w = np.ones(len(good)) if weights is None \
            else np.asarray(weights)[good]
        mean_prof = np.average(port[good], axis=0, weights=w)
    for ichan in range(len(port)):
        if not port[ichan].any():
            continue
        if method == "mean":
            norm = port[ichan].mean()
        elif method == "max":
            norm = port[ichan].max()
        elif method == "prof":
            norm = float(fit_phase_shift(port[ichan], mean_prof,
                                         device=device).scale)
        elif method == "rms":
            norm = float(noise_std_ps(port[ichan]))
        else:
            norm = float(np.sqrt((port[ichan] ** 2).sum()))
        if norm != 0.0:
            norm_port[ichan] = port[ichan] / norm
            norm_vals[ichan] = norm
    return (norm_port, norm_vals) if return_norms else norm_port
