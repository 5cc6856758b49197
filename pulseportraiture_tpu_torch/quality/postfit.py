"""Model-based post-fit channel cut (counterpart of pulseportraiture_tpu/quality/postfit.py).

The reference flags channels whose per-channel reduced chi^2 or
matched-filter S/N disqualify them AFTER a fit (pptoas.py:1266-1343,
ppzap's model path): up to 8 rounds, each re-deriving the chi^2 cut
from the median of the surviving channels.  This module holds the host
numpy oracle (:func:`postfit_cut_np`) and the batched torch twin
(:func:`postfit_cut_mask`), which ``GetTOAs.get_channels_to_zap`` and the
stream's ``postfit_cut`` run.

The cut's only statistics are an exact median (the sort in
quality.excision.masked_median_lastaxis), a multiply by 3 and
comparisons, so the torch twin flags the same channels as the oracle.
The twin runs a fixed 8 rounds with per-row done flags, so it needs no
device -> host sync.
"""

import numpy as np
import torch

from ..device import resolve_device
from .excision import masked_median_lastaxis

__all__ = ["postfit_cut_np", "postfit_cut_mask", "postfit_cut_device"]

_MAX_ROUNDS = 8  # reference pptoas.py:1296 (iterate=True)


def _snr_floor(snr_tot, nchx, SNR_threshold):
    """min(SNR_threshold, sqrt(max(snr_tot, 0)^2 / nchx)) with the
    reference's non-finite fallback."""
    snr_tot = np.asarray(snr_tot, float)
    nchx = np.maximum(np.asarray(nchx, float), 1.0)
    cut = np.sqrt(np.maximum(snr_tot, 0.0) ** 2 / nchx)
    cut = np.where(np.isfinite(snr_tot), cut, SNR_threshold)
    return np.minimum(SNR_threshold, cut)


def postfit_cut_np(chan_rchi2, chan_snr, snr_tot, okc_mask,
                   SNR_threshold=8.0, rchi2_threshold=1.3,
                   iterate=True):
    """Host oracle: the reference red-chi^2 / S-N channel cut
    (pptoas.py:1292-1307) vectorized over rows.

    chan_rchi2 / chan_snr / okc_mask: (nsub, nchan); snr_tot: (nsub,).
    Returns a (nsub, nchan) boolean BAD mask (True = zap)."""
    rchi2 = np.asarray(chan_rchi2, float)
    snr = np.asarray(chan_snr, float)
    okc = np.asarray(okc_mask) > 0
    nsub, nchan = rchi2.shape
    floor = _snr_floor(snr_tot, okc.sum(axis=1), SNR_threshold)
    bad_out = np.zeros((nsub, nchan), bool)
    for i in range(nsub):
        oi = np.flatnonzero(okc[i])
        if oi.size == 0:
            continue
        bad = np.zeros(nchan, bool)
        cut = float(rchi2_threshold)
        for _ in range(_MAX_ROUNDS if iterate else 1):
            with np.errstate(invalid="ignore"):
                new_bad = okc[i] & ((rchi2[i] > cut)
                                    | (snr[i] < floor[i]))
            if np.array_equal(new_bad, bad):
                break
            bad = new_bad
            good = oi[~bad[oi]]
            if good.size == 0:
                break
            cut = max(float(rchi2_threshold),
                      float(np.median(rchi2[i, good])) * 3.0)
        bad_out[i] = bad
    return bad_out


def postfit_cut_mask(chan_rchi2, chan_snr, snr_tot, okc_mask,
                     SNR_threshold=8.0, rchi2_threshold=1.3,
                     iterate=True):
    """Batched torch twin of :func:`postfit_cut_np` on the device and in
    the dtype of ``chan_rchi2``: a fixed 8 rounds (1 without iterate)
    with per-row done flags -- a row freezes once its bad set stops
    changing or its survivor set empties, the reference's two break
    conditions.  The re-derived cut is ``max(threshold, median * 3)``.
    NaN rchi2/snr entries compare False against every cut, so they are
    never flagged.  Returns the (..., nchan) bool bad mask."""
    rchi2 = chan_rchi2
    dt = rchi2.dtype
    snr = chan_snr.to(dt)
    okc = okc_mask > 0
    snr_tot = snr_tot.to(dt)
    thr = float(rchi2_threshold)
    nchx = torch.clamp(okc.sum(dim=-1), min=1).to(dt)
    st = torch.where(snr_tot < 0, torch.zeros_like(snr_tot), snr_tot)
    floor_ = torch.sqrt(st * st / nchx)
    floor_ = torch.where(torch.isfinite(snr_tot), floor_,
                         torch.full_like(floor_, float(SNR_threshold)))
    floor_ = torch.clamp(floor_, max=float(SNR_threshold))

    bad = torch.zeros_like(okc)
    cut = torch.full(okc.shape[:-1], thr, dtype=dt, device=rchi2.device)
    done = okc.sum(dim=-1) == 0
    for _ in range(_MAX_ROUNDS if iterate else 1):
        base = okc & ((rchi2 > cut[..., None])
                      | (snr < floor_[..., None]))
        same = torch.all(base == bad, dim=-1)
        bad = torch.where((done | same)[..., None], bad, base)
        done = done | same
        good = okc & ~bad
        empty = good.sum(dim=-1) == 0
        med = masked_median_lastaxis(rchi2, good)
        new_cut = torch.clamp(med * 3, min=thr)
        cut = torch.where(done | empty, cut, new_cut)
        done = done | empty
    return bad


def postfit_cut_device(chan_rchi2, chan_snr, snr_tot, okc_mask,
                       SNR_threshold=8.0, rchi2_threshold=1.3,
                       iterate=True, device=None):
    """:func:`postfit_cut_mask` on ``device`` (default cuda) for host
    arrays (float64 kept); returns the host bool bad mask."""
    dev = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype)).to(dev)

    rchi2 = t(chan_rchi2, float)
    bad = postfit_cut_mask(rchi2, t(chan_snr, float), t(snr_tot, float),
                           t(np.asarray(okc_mask) > 0),
                           SNR_threshold=SNR_threshold,
                           rchi2_threshold=rchi2_threshold,
                           iterate=iterate)
    return bad.cpu().numpy()
