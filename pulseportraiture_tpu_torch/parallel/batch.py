"""The batched device programs of the align pipeline and the sharded
fits (counterpart of pulseportraiture_tpu/parallel/batch.py).

One align_archives iteration (pipeline/align.py) accumulates every
archive's weighted, back-rotated subints in the HARMONIC domain on the
align's device: the rotation is a split-real (cos, sin) multiply on the
spectra, the weighted sum over subints is added in place into three
preallocated accumulators, and ONE irfft per iteration recovers the
average.  The JAX package runs this as jitted XLA programs with donated
buffers; here it is plain torch, eagerly: torch.fft for the DFTs, and
``add_`` into the accumulators in place of donation.

The sharded programs (fit_portrait_sharded[_fast],
align_iteration_sharded) run on the rank mesh of parallel/mesh.py: each
rank takes its slice of the batch over 'data' (shard_batch), runs the
port's batched lanes on it, and the results are gathered (the fits) or
summed (the align accumulators) over the 'data' subgroup, so every rank
returns what the JAX program returns at one process.

shard_channels=True also splits each portrait's channel axis over
'chan', as the JAX program does: a rank holds nchan / n_chan channels of
its batch slice (B1 runs on those rows), and the fit engines combine the
chi^2 channel sums over the mesh's 'chan' subgroup (the ``chan_group``
of fit.portrait): the ranks' partial sums are all-gathered, one
collective per Newton evaluation, and added by the same fixed-order
tree (fit.portrait.chan_sums), so every rank of a 'chan' line holds the
same bits and leaves the Newton loop on the same trip.  The per-channel
outputs (scales, scale_errs, channel_snrs) and the align template are
gathered over 'chan' in channel order.
"""

import math

import numpy as np
import torch

from .. import config
from ..device import resolve_auto, resolve_device
from ..fit.portrait import FitFlags
from ..ops.fourier import irfft_sr, rfft_sr
from ..ops.phasor import phase_shifts

__all__ = ["ALIGN_DEVICE_CHUNK", "use_align_device", "align_accumulator_init",
           "align_accumulate_archive", "align_finalize", "shard_batch",
           "fit_portrait_sharded", "fit_portrait_sharded_fast",
           "align_iteration_sharded"]

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


# ---------------------------------------------------------------------------
# the sharded programs

def _host_or_tensor(a):
    """A tensor as it is, anything else as a CPU tensor (no copy)."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


def shard_batch(mesh, arrays, chan_axis=None, device=None):
    """This rank's slice of each array of ``arrays`` (one array, or a
    tuple, list or dict of them) as tensors on the rank's device
    (``device``, else the mesh's, else cuda): the leading axis over
    'data', axis ``chan_axis`` over 'chan'.  An axis that does not
    divide by its mesh axis raises ValueError."""
    from .mesh import batch_sharding

    dev = resolve_device(device if device is not None else mesh.device)

    def one(a):
        t = _host_or_tensor(a)
        return t[batch_sharding(mesh, t.dim(), chan_axis).slices(
            t.shape)].to(dev)

    if isinstance(arrays, dict):
        return {k: one(v) for k, v in arrays.items()}
    if isinstance(arrays, (tuple, list)):
        return type(arrays)(one(a) for a in arrays)
    return one(arrays)


def _local(mesh, a, dev, dtype, data_axis, chan_axis, shard_channels):
    """This rank's block of ``a`` for a sharded fit, sliced where ``a``
    lies and then moved to ``dev``: ``data_axis`` over 'data' (None:
    whole) and, with shard_channels, ``chan_axis`` over 'chan'; a sliced
    axis must divide over its mesh axis, as the JAX package requires."""
    from .mesh import Sharding

    t = _host_or_tensor(a)
    spec = [None] * t.dim()
    if data_axis is not None:
        spec[data_axis] = "data"
    if shard_channels and chan_axis is not None:
        spec[chan_axis] = "chan"
    return t[Sharding(mesh, tuple(spec)).slices(t.shape)].to(device=dev,
                                                             dtype=dtype)


def _chan_group(mesh, shard_channels):
    """The 'chan' subgroup the fit engines combine channel sums over:
    None unless the channels are split over more than one rank."""
    if shard_channels and mesh.axis_size("chan") > 1:
        return mesh.groups["chan"]
    return None


def _per_fit(x, nb):
    """A scalar or (nb,) per-fit input as an (nb,) tensor."""
    return _host_or_tensor(x).expand(nb)


def _gather_result(mesh, res):
    """Every rank's FitResult rows, concatenated over the 'data'
    subgroup in mesh order."""
    from .multihost import all_gather

    if mesh.axis_size("data") == 1:
        return res
    g = mesh.groups["data"]
    return type(res)(*[torch.cat(all_gather(v, g), dim=0) for v in res])


def _sharded_inputs(mesh, ports, models, noise_stds, freqs, P_s, nu_fit,
                    theta0, chan_masks, shard_channels, device):
    """The rank's blocks of a sharded fit's inputs (ports' dtype, on its
    device; nu_fit None is left out) and the 'chan' subgroup
    (``chan_group``).  Shared templates (nchan, nbin) and freqs (nchan,)
    have their channel axis 0."""
    dev = resolve_device(device if device is not None else mesh.device)
    ports_t = _host_or_tensor(ports)
    dt = ports_t.dtype
    nb = ports_t.shape[0]
    mesh.axis_index("data")  # a rank outside the mesh raises here

    def loc(a, data_axis, chan_axis):
        return _local(mesh, a, dev, dt, data_axis, chan_axis,
                      shard_channels)

    m_nd = np.ndim(models)
    f_nd = np.ndim(freqs)
    return dict(
        ports=loc(ports_t, 0, 1),
        models=loc(models, 0 if m_nd == 3 else None, 1 if m_nd == 3 else 0),
        noise_stds=loc(noise_stds, 0, 1),
        freqs=loc(freqs, 0 if f_nd == 2 else None, 1 if f_nd == 2 else 0),
        P=loc(_per_fit(P_s, nb), 0, None),
        nu_fit=None if nu_fit is None else loc(_per_fit(nu_fit, nb), 0,
                                               None),
        theta0=None if theta0 is None else loc(theta0, 0, None),
        chan_masks=None if chan_masks is None else loc(chan_masks, 0, 1),
        chan_group=_chan_group(mesh, shard_channels))


def fit_portrait_sharded(mesh, ports, models, noise_stds, freqs, P_s, nu_fit,
                         theta0=None, nu_out=None, fit_flags=FitFlags(),
                         log10_tau=False, max_iter=40, shard_channels=False,
                         use_scatter=None, device=None):
    """The complex engine (fit.portrait.fit_portrait_batch) over a
    (nb, nchan, nbin) batch sharded on the mesh: each rank fits its
    'data' slice (and, with shard_channels, its block of the channels,
    the chi^2 sums combined over 'chan') and every rank returns the
    whole batch's FitResult.

    models (nb, nchan, nbin) or a shared (nchan, nbin) template; freqs
    (nchan,) or (nb, nchan); P_s / nu_fit scalars or (nb,); nu_out None
    or a scalar.  use_scatter None: derived from fit_flags, log10_tau and
    theta0, so a fixed nonzero tau is not ignored.  device: the rank's
    device (None: the mesh's, else cuda)."""
    from ..fit.portrait import derive_use_scatter, fit_portrait_batch

    if use_scatter is None:
        use_scatter = derive_use_scatter(fit_flags, log10_tau, theta0)
    b = _sharded_inputs(mesh, ports, models, noise_stds, freqs, P_s, nu_fit,
                        theta0, None, shard_channels, device)
    res = fit_portrait_batch(
        b["ports"], b["models"], b["noise_stds"], b["freqs"], b["P"],
        b["nu_fit"], nu_out=nu_out, theta0=b["theta0"], fit_flags=fit_flags,
        log10_tau=log10_tau, max_iter=max_iter, use_scatter=use_scatter,
        device=b["ports"].device, chan_group=b["chan_group"])
    return _gather_result(mesh, res)


def fit_portrait_sharded_fast(mesh, ports, models, noise_stds, freqs, P_s,
                              nu_fit, theta0=None, nu_out=None,
                              fit_flags=FitFlags(), chan_masks=None,
                              max_iter=40, shard_channels=False,
                              log10_tau=False, compensated=None,
                              harmonic_window=None, device=None):
    """fit_portrait_sharded through the complex-free lanes
    (fit.portrait.fit_portrait_batch_fast): the three-moment fast fit, or
    the scattering lane when tau/alpha are fitted, log10_tau is set or
    theta0 seeds a fixed nonzero tau.  On CUDA with a harmonic window the
    fast fit's DFT and cross-spectrum are the fused kernel B1 (its
    want_m2 form on the scattering lane), on the rank's rows: its
    'data' slice, and with shard_channels its block of the channels.

    models (nb, nchan, nbin) or a shared (nchan, nbin) template;
    harmonic_window as fit_portrait_batch_fast ('auto' derives K from a
    host numpy model), resolved once from the whole batch so every rank
    fits with the same K."""
    from ..fit.portrait import (derive_use_scatter, fit_portrait_batch_fast,
                                reject_fixed_tau_seed,
                                resolve_harmonic_window)

    use_scatter = derive_use_scatter(fit_flags, log10_tau, theta0)
    if not use_scatter:
        reject_fixed_tau_seed(theta0, "fit_portrait_sharded_fast")
    nbin = np.shape(ports)[-1]
    K = resolve_harmonic_window(harmonic_window, models, nbin)
    b = _sharded_inputs(mesh, ports, models, noise_stds, freqs, P_s, nu_fit,
                        theta0, chan_masks, shard_channels, device)
    res = fit_portrait_batch_fast(
        b["ports"], b["models"], b["noise_stds"], b["freqs"], b["P"],
        b["nu_fit"], nu_out=nu_out, theta0=b["theta0"], fit_flags=fit_flags,
        chan_masks=b["chan_masks"], max_iter=max_iter, log10_tau=log10_tau,
        compensated=compensated,
        harmonic_window=False if K is None else K,
        device=b["ports"].device, chan_group=b["chan_group"])
    return _gather_result(mesh, res)


def align_iteration_sharded(mesh, ports, model, noise_stds, chan_masks,
                            freqs, P_s, fit_dm=True, max_iter=20,
                            shard_channels=False, device=None):
    """ONE ppalign iteration on the rank mesh: the batched (phi[, DM])
    fast fit of every (archive, subint) against the shared template, at
    nu_fit = nu_out = mean(freqs) and over every harmonic, as in the JAX
    program; then each rank back-rotates and weights its slice into the
    harmonic accumulators (align_accumulate_archive), the accumulators
    and the weight sum are summed over 'data', and every rank finishes
    with the same align_finalize (reference ppalign.py: 220-248).  With
    shard_channels a rank fits, accumulates and finalizes its block of
    the channels (nu_fit stays the whole band's mean), and the template
    is gathered over 'chan'.

    The fit takes harmonic_window='full' (fit.portrait.
    resolve_harmonic_window): where the fused lane is on (CUDA) that is
    B1's S0 form over all nbin/2 + 1 harmonics, whose rows are
    transformed independently, so a subint's fit has the same bits
    however the batch and channels are split; a matmul DFT (the JAX
    program's, and the port's without the fused lane) rounds by its row
    count on the card.

    ports (nb, nchan, nbin); model the shared (nchan, nbin) template;
    noise_stds / chan_masks (nb, nchan); freqs (nchan,); P_s scalar or
    (nb,).  Returns (new_template (nchan, nbin) on the rank's device,
    the whole batch's FitResult)."""
    from ..fit.portrait import fit_portrait_batch_fast
    from .multihost import all_gather, all_reduce_sum

    b = _sharded_inputs(mesh, ports, model, noise_stds, freqs, P_s, None,
                        None, chan_masks, shard_channels, device)
    port, dt, dev = b["ports"], b["ports"].dtype, b["ports"].device
    nloc, nchan, nbin = port.shape
    # the whole band's mean, on every rank (its channels may be a block)
    nu0 = torch.mean(_host_or_tensor(freqs).to(device=dev, dtype=dt))
    res = fit_portrait_batch_fast(
        port, b["models"], b["noise_stds"], b["freqs"], b["P"], nu0,
        nu_out=nu0, fit_flags=FitFlags(True, bool(fit_dm), False, False,
                                       False),
        chan_masks=b["chan_masks"], max_iter=max_iter,
        harmonic_window="full", device=dev, chan_group=b["chan_group"])
    c0 = mesh.axis_index("chan") * nchan if b["chan_group"] is not None \
        else 0
    acc = align_accumulate_archive(
        align_accumulator_init(1, nchan, nbin, dt, dev), port[:, None],
        res.phi, res.DM, nu0.expand(nloc), b["P"], b["freqs"],
        b["noise_stds"], b["chan_masks"], res.scales[:, c0:c0 + nchan])
    if mesh.axis_size("data") > 1:
        acc = tuple(all_reduce_sum(a, mesh.groups["data"]) for a in acc)
    template = align_finalize(acc, nbin)[0]
    if b["chan_group"] is not None:
        template = torch.cat(all_gather(template, b["chan_group"]), dim=0)
    return template, _gather_result(mesh, res)
