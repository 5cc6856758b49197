"""The single-device align programs (counterpart of the align part of
pulseportraiture_tpu/parallel/batch.py, :276-483).

One align_archives iteration (pipeline/align.py) accumulates every
archive's weighted, back-rotated subints in the HARMONIC domain on the
align's device: the rotation is a split-real (cos, sin) multiply on the
spectra, the weighted sum over subints is added in place into three
preallocated accumulators, and ONE irfft per iteration recovers the
average.  The JAX package runs this as jitted XLA programs with donated
buffers; here it is plain torch, eagerly: torch.fft for the DFTs, and
``add_`` into the accumulators in place of donation.

The sharded programs of the JAX module (align_iteration_sharded, the
sharded fits) are ROADMAP A12.
"""

import math

import numpy as np
import torch

from .. import config
from ..device import resolve_auto, resolve_device
from ..ops.fourier import irfft_sr, rfft_sr
from ..ops.phasor import phase_shifts

__all__ = ["ALIGN_DEVICE_CHUNK", "use_align_device", "align_accumulator_init",
           "align_accumulate_archive", "align_finalize"]

_ALIGN_TINY = 1e-30

# Subints per accumulate step: bounds the transient (Cr, Ci, rotated,
# weighted) footprint to ~4 * chunk * npol * nchan * nharm floats.
ALIGN_DEVICE_CHUNK = 64


def use_align_device(setting=None, device=None):
    """Whether align_archives runs its rotate-and-accumulate on the
    align's ``device`` (default cuda): config.align_device when
    ``setting`` is None (True/False force; 'auto' = on CUDA devices).
    Read per call, so in-process A/B flips take effect; a typo raises
    (device.resolve_auto)."""
    if setting is None:
        setting = config.align_device
    return resolve_auto("align_device", setting, resolve_device(device),
                        label="align_device")


def _align_rotate_real(cube_r, cube_i, delays):
    """Split-real phasor rotation of per-subint harmonic stacks:
    (Cr + i Ci) * exp(+2 pi i k t) expanded into real parts.  Rotating
    by positive delays moves features to earlier phase, the convention
    of ops.phasor.phasor / ops.rotation.rotate_portrait.

    cube_r/cube_i: (nb, npol, nchan, nharm); delays: (nb, nchan) [rot]."""
    k = torch.arange(cube_r.shape[-1], dtype=cube_r.dtype,
                     device=cube_r.device)
    ang = 2.0 * math.pi * delays[..., None] * k          # (nb, nchan, K)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    return cube_r * c - cube_i * s, cube_r * s + cube_i * c


def _align_weights(phi, DM, nu_ref, P_s, freqs, noise, masks, scales):
    """Per-archive (delays, weights), both (nb, nchan), on the fit
    results' device (they never round-trip to the host).  The host
    lane's formulas (pipeline/align.py): delays = phase_shifts(phi, DM,
    GM=0) and w = mask * max(scales, 0) / noise**2 with non-positive
    noise weighted zero."""
    delays = phase_shifts(phi[:, None], DM[:, None], 0.0, freqs[None, :],
                          P_s[:, None], nu_ref[:, None], 1.0)
    # wrap to [-0.5, 0.5): integer-harmonic phasors are 1-periodic, and
    # small arguments keep the float32 trig accurate
    delays = delays - torch.round(delays)
    good = noise > 0.0
    inv = torch.where(good, 1.0 / torch.where(good, noise,
                                              torch.ones_like(noise)) ** 2,
                      torch.zeros_like(noise))
    # masked channels must weigh EXACTLY zero even when the fit left NaN
    # scales there (0 * NaN = NaN would poison the stack): a where, not a
    # product
    w = torch.where(masks > 0.0, masks * torch.clamp(scales, min=0.0) * inv,
                    torch.zeros_like(masks))
    return delays, w


def align_accumulator_init(npol, nchan, nbin, dtype, device=None):
    """Fresh zeroed accumulators (acc_r, acc_i, wacc) of one align
    iteration on ``device`` (default cuda): (npol, nchan, nbin//2+1)
    twice and (nchan,).  Feed them to align_accumulate_archive, which
    adds into them in place, and finish with align_finalize."""
    dev = resolve_device(device)
    k = nbin // 2 + 1
    return (torch.zeros((npol, nchan, k), dtype=dtype, device=dev),
            torch.zeros((npol, nchan, k), dtype=dtype, device=dev),
            torch.zeros((nchan,), dtype=dtype, device=dev))


def align_accumulate_archive(acc, cube, phi, DM, nu_ref, P_s, freqs, noise,
                             masks, scales, chunk=ALIGN_DEVICE_CHUNK):
    """Add one archive's weighted, back-rotated subints into the harmonic
    accumulators ``acc`` (from align_accumulator_init), in place, in the
    accumulators' dtype and on their device (reference ppalign.py:
    236-242).

    cube: (nb, npol, nchan, nbin) numpy or tensor; phi/DM/nu_ref/P_s
    (nb,), noise/masks/scales (nb, nchan) and freqs (nchan,), numpy or
    tensors (straight from the batched fit: nothing here syncs with the
    host).  Returns acc."""
    acc_r, acc_i, wacc = acc
    dt, dev = acc_r.dtype, acc_r.device

    def on(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dt)
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    cube = on(cube)
    delays, w = _align_weights(on(phi), on(DM), on(nu_ref), on(P_s),
                               on(freqs), on(noise), on(masks), on(scales))
    # the tail chunk runs unpadded: the JAX package pads it with
    # zero-weight rows (and rounds a short batch's chunk up to a power of
    # two, _align_chunk) only to bound its count of compiled programs
    for lo in range(0, cube.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        cr, ci = rfft_sr(cube[sl])
        rr, ri = _align_rotate_real(cr, ci, delays[sl])
        wb = w[sl][:, None, :, None]
        acc_r.add_(torch.sum(rr * wb, dim=0))
        acc_i.add_(torch.sum(ri * wb, dim=0))
        wacc.add_(torch.sum(w[sl], dim=0))
    return acc


def align_finalize(acc, nbin):
    """The iteration's one irfft and weight normalization: harmonic
    accumulators -> the (npol, nchan, nbin) average portrait, on the
    accumulators' device."""
    acc_r, acc_i, wacc = acc
    aligned = irfft_sr(acc_r, acc_i, n=nbin)
    return aligned / torch.clamp(wacc, min=_ALIGN_TINY)[:, None]
