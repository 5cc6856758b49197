"""Batched RFI excision (counterpart of pulseportraiture_tpu/quality/excision.py):
the iterative median + nstd noise cut over every row of a batch at once.

The reference's median algorithm (ppzap.py:24-54) loops per subint: each
pass takes the median and std of the surviving channels, flags the
channels above median + nstd*std, and repeats until a pass flags
nothing.  :func:`zap_keep_mask` runs that loop for every row of a batch
together in torch, on the device of its input; the stream's raw bucket
program calls it on the noise levels it computed on the card, and
:func:`zap_keep_device` is the offline lane of pipeline/zap.

Exactness: the masked MEDIAN is the sort's order statistics, so it
equals ``np.median`` of each row's survivors bit for bit.  The STD is
the two-pass formula in the input dtype; its sums reduce in torch's
order, not numpy's, so a channel within ~1 ulp of ``median + nstd*std``
could flip between this and the host oracle :func:`zap_keep_np`.  The
tests gate the flagged LISTS equal.

The loop's exit test reads a device flag on the host (a sync).  A row
whose pass flags nothing is a fixed point (the same survivors give the
same median and std), so the loop runs ZAP_CHECK_EVERY passes between
exit tests without changing the result; :func:`zap_stats` counts the
calls, passes and syncs.
"""

import threading

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["masked_median_lastaxis", "zap_keep_mask", "zap_keep_device",
           "zap_keep_np", "zap_lists_from_masks", "zap_bunch", "zap_stats",
           "reset_zap_stats", "ZAP_CHECK_EVERY"]

# Passes of the cut between two host-side exit tests.  The corpus and the
# chip's RFI cases converge in 2-3 flagging passes plus one clean one, so
# 4 costs one sync per call in the common case.
ZAP_CHECK_EVERY = 4

_stats_lock = threading.Lock()
_stats = {"calls": 0, "passes": 0, "syncs": 0}


def zap_stats():
    """{'calls', 'passes', 'syncs'} of zap_keep_mask since the last
    reset_zap_stats()."""
    with _stats_lock:
        return dict(_stats)


def reset_zap_stats():
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0


def masked_median_lastaxis(x, keep):
    """Median over the kept entries of the last axis, equal to
    ``np.median(x[row][keep[row]])`` per row bit for bit: the kept values
    sorted (excluded entries sent past every kept value), the order
    statistics at (n-1)//2 and n//2, and their mean (lo + hi) / 2.

    ``keep``: boolean mask, same shape as ``x``.  Rows with no kept entry
    return 0 (callers mask those rows out)."""
    keep = keep.bool()
    srt = torch.sort(torch.where(keep, x, torch.full_like(x, float("inf"))),
                     dim=-1).values
    n = keep.sum(dim=-1, keepdim=True)
    k_lo = torch.clamp(n - 1, min=0) // 2
    k_hi = n // 2
    lo = torch.gather(srt, -1, k_lo)
    hi = torch.gather(srt, -1, k_hi)
    med = ((lo + hi) / 2)[..., 0]
    return torch.where(n[..., 0] > 0, med, torch.zeros_like(med))


def _cut_pass(noise, kb, nstd):
    """One pass of the cut: (survivors, rows that flagged a channel)."""
    n = kb.sum(dim=-1)
    nf = torch.clamp(n, min=1).to(noise.dtype)
    zero = torch.zeros_like(noise)
    med = masked_median_lastaxis(noise, kb)
    m1 = torch.where(kb, noise, zero).sum(dim=-1) / nf
    dev = noise - m1[..., None]
    var = torch.where(kb, dev * dev, zero).sum(dim=-1) / nf
    std = torch.sqrt(var)
    bad = kb & (noise > (med + nstd * std)[..., None])
    return kb & ~bad, bad.any(dim=-1)


def zap_keep_mask(noise, keep, nstd):
    """The iterative median + ``nstd``*std cut over a batch of rows, in
    torch on the device of ``noise``.

    noise: (..., nchan) per-channel noise levels; keep: same-shape
    boolean (or 0/1) survivor mask (channels already zero-weight enter
    False and are never counted).  Returns ``(keep_out, n_iter)``: the
    surviving mask (bool) and, per row, how many passes flagged at least
    one channel (0 = the row was clean), row for row as
    :func:`zap_keep_np`.  The exit test runs every ZAP_CHECK_EVERY
    passes (one device -> host sync each)."""
    kb = keep > 0
    it = torch.zeros(noise.shape[:-1], dtype=torch.int32,
                     device=noise.device)
    passes = syncs = 0
    while True:
        for _ in range(ZAP_CHECK_EVERY):
            kb, row_bad = _cut_pass(noise, kb, nstd)
            it = it + row_bad.to(torch.int32)
            passes += 1
        syncs += 1
        if not bool(row_bad.any()):
            break
    with _stats_lock:
        _stats["calls"] += 1
        _stats["passes"] += passes
        _stats["syncs"] += syncs
    return kb, it


def zap_keep_device(noise, keep, nstd, device=None):
    """:func:`zap_keep_mask` on ``device`` (default cuda) for host
    arrays; returns host ``(keep, n_iter)`` numpy arrays.  The dtype of
    ``noise`` is kept.  The device lane of pipeline/zap.get_zap_channels:
    every subint of an archive in one batched cut."""
    dev = resolve_device(device)
    noise_t = torch.as_tensor(np.ascontiguousarray(noise)).to(dev)
    keep_t = torch.as_tensor(np.asarray(keep) > 0).to(dev)
    kb, it = zap_keep_mask(noise_t, keep_t, float(nstd))
    return kb.cpu().numpy(), it.cpu().numpy()


def zap_keep_np(noise, keep, nstd):
    """Host oracle: the reference median algorithm (ppzap.py:24-54)
    vectorized over rows -- per row: np.median / np.std of the survivor
    set, flag strictly-greater outliers, repeat until clean.  Returns
    ``(keep, n_iter)`` like the device twin."""
    noise = np.asarray(noise)
    keep = np.array(np.asarray(keep) > 0)
    flat = keep.reshape(-1, keep.shape[-1])
    nflat = noise.reshape(-1, noise.shape[-1])
    n_iter = np.zeros(flat.shape[0], int)
    for i in range(flat.shape[0]):
        while True:
            idx = np.flatnonzero(flat[i])
            if idx.size == 0:
                break
            vals = nflat[i, idx]
            med, std = np.median(vals), np.std(vals)
            bad = idx[vals > med + nstd * std]
            if bad.size == 0:
                break
            flat[i, bad] = False
            n_iter[i] += 1
    return (flat.reshape(keep.shape),
            n_iter.reshape(keep.shape[:-1]))


def zap_lists_from_masks(keep0, keep):
    """Per-row sorted flagged-channel lists from before/after survivor
    masks: the ppzap list format ([row][channel indices])."""
    keep0 = np.asarray(keep0) > 0
    keep = np.asarray(keep) > 0
    return [sorted(int(c) for c in np.flatnonzero(k0 & ~k))
            for k0, k in zip(keep0, keep)]


def zap_bunch(d, zap_channels):
    """Apply a zap list to a LOADED archive bunch in memory: weight
    zeroing plus the recomputation of what the loaders derive from the
    weights, so downstream fits see exactly what loading a weight-zapped
    archive yields.

    This, not ``pipeline/zap.apply_zaps``, is the lossless offline zap:
    the PSRFITS writer re-quantizes DATA from the decoded floats, so a
    zap-rewrite-reload round trip perturbs the data in its low bits,
    while load_data/_load_raw never fold weights into the data.

    ``d``: a ``load_data`` bunch or a raw-mode stream bunch
    (``pipeline.stream._load_raw``); ``zap_channels``: [subint][channel
    indices], indexed by TRUE subint number (rows beyond ``d.nsub``
    ignored).  Returns ``d`` (mutated)."""
    w = np.asarray(d.weights)
    for isub, chans in enumerate(zap_channels):
        if isub >= w.shape[0] or not len(chans):
            continue
        w[isub, np.asarray(chans, int)] = 0.0
    d.weights = w
    weights_norm = np.where(w == 0.0, 0.0, 1.0)
    nsub, nchan = w.shape
    d.ok_isubs = np.compress(weights_norm.mean(axis=1),
                             np.arange(nsub)).astype(int)
    if "ok_ichans" in d:
        d.ok_ichans = [np.compress(weights_norm[isub],
                                   np.arange(nchan)).astype(int)
                       for isub in range(nsub)]
    if "masks" in d and not d.get("raw_mode", False):
        npol = int(d.get("npol", 1))
        nbin = int(d.nbin)
        d.masks = np.broadcast_to(weights_norm[:, None, :, None],
                                  (nsub, npol, nchan, nbin))
    return d
