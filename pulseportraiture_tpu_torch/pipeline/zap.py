"""Channel-zap proposals and application, the ppzap library (counterpart of pulseportraiture_tpu/pipeline/zap.py).

Two paths, as in the reference CLI (ppzap.py:24-104): the model-less
median algorithm on per-channel noise levels (:func:`get_zap_channels`),
and the model-based path through GetTOAs' reduced-chi^2 / S-N cut
(pipeline/toas.GetTOAs.get_channels_to_zap).  Besides printing PSRCHIVE
``paz`` commands, :func:`apply_zaps` edits the archive weights directly.

The median algorithm's iterating lives in quality/excision.py: the host
lane is the reference loop vectorized over subints (the oracle), the
device lane runs every subint's cut together in torch.  The same cut
runs inside the stream's raw bucket program (``zap_inline``).

Two selectors: ``zap_device`` is the tri-state lane switch (None follows
config.zap_device / PPT_ZAP_DEVICE; 'auto' = on CUDA devices), and
``device`` is where the device lane runs (default cuda).  ``tracer``
(a telemetry.Tracer) receives one ``zap_propose`` per proposal pass and
one ``zap_apply`` per applied zap.
"""

import time

import numpy as np

from .. import config
from ..device import resolve_auto, resolve_device
from ..io.psrfits import read_archive
from ..quality.excision import (zap_bunch, zap_keep_device,  # noqa: F401
                                zap_keep_np, zap_lists_from_masks)
from ..telemetry import NULL_TRACER

__all__ = ["resolve_zap_device", "resolve_zap_nstd", "get_zap_channels",
           "print_paz_cmds", "apply_zaps"]


def resolve_zap_device(zap_device=None, device=None):
    """The zap statistics lane for ``device`` (default cuda): None
    follows config.zap_device; 'auto' = the torch lane on CUDA devices,
    the host lane elsewhere; True/False force."""
    if zap_device is None:
        zap_device = config.zap_device
    return resolve_auto("zap_device", zap_device, resolve_device(device))


def resolve_zap_nstd(nstd=None):
    """None follows ``config.zap_nstd`` (PPT_ZAP_NSTD); explicit values
    pass through (ValueError on non-positive)."""
    if nstd is None:
        nstd = config.zap_nstd
    nstd = float(nstd)
    if not nstd > 0:
        raise ValueError(f"zap nstd must be > 0, got {nstd}")
    return nstd


def get_zap_channels(data, nstd=None, zap_device=None, tracer=None,
                     device=None):
    """Iterative median + nstd*std cut on per-channel noise levels
    (reference ppzap.py:24-54).  data: a load_data DataBunch.  Returns
    [subint][channel indices], one row per TRUE subint (empty rows for
    subints with no usable channels), the indexing
    GetTOAs.get_channels_to_zap uses and print_paz_cmds / apply_zaps
    consume.

    nstd: threshold in stds (None = config.zap_nstd).  zap_device: the
    lane tri-state (resolve_zap_device); the device lane runs every
    subint's whole cut in torch on ``device`` (default cuda); the lists
    equal the host lane's (the median is exact, the std within ~1 ulp,
    gated by the tests).  tracer: optional telemetry sink; one
    ``zap_propose`` (n_channels, n_iter, device, wall_s)."""
    nstd = resolve_zap_nstd(nstd)
    use_device = resolve_zap_device(zap_device, device)
    ok = np.asarray(data.ok_isubs, int)
    nchan = int(data.nchan)
    noise = np.asarray(data.noise_stds[ok, 0])
    keep0 = np.zeros((len(ok), nchan), bool)
    for j, isub in enumerate(ok):
        keep0[j, np.asarray(data.ok_ichans[isub], int)] = True
    t0 = time.perf_counter()
    if use_device:
        keep, iters = zap_keep_device(noise, keep0, nstd, device=device)
    else:
        keep, iters = zap_keep_np(noise, keep0, nstd)
    wall = time.perf_counter() - t0
    zap_channels = [[] for _ in range(int(data.nsub))]
    for isub, z in zip(ok, zap_lists_from_masks(keep0, keep)):
        zap_channels[int(isub)] = z
    if tracer is not None and tracer.enabled:
        tracer.emit("zap_propose", datafile=str(data.get("filename", "")),
                    n_channels=sum(len(z) for z in zap_channels),
                    n_iter=int(np.max(iters, initial=0)),
                    device=bool(use_device), wall_s=round(wall, 6))
    return zap_channels


def print_paz_cmds(datafiles, zap_list, all_subs=False, modify=True,
                   outfile=None, quiet=False, append=False):
    """Emit PSRCHIVE ``paz`` commands for a zap list (reference
    ppzap.py:57-104); returns the command lines.  outfile is written
    (truncated) unless ``append=True``."""
    lines = []
    for iarch, datafile in enumerate(datafiles):
        count = sum(len(z) for z in zap_list[iarch])
        if not count:
            continue
        if modify:
            paz_outfile = datafile
        else:
            ii = datafile[::-1].find(".")
            paz_outfile = (datafile + ".zap" if ii < 0
                           else datafile[:-ii] + "zap")
            lines.append(f"paz -e zap {datafile}")
        last = ""
        for isub, bad_ichans in enumerate(zap_list[iarch]):
            for bad in bad_ichans:
                if not all_subs:
                    lines.append(
                        f"paz -m -I -z {bad} -w {isub} {paz_outfile}")
                else:
                    line = f"paz -m -z {bad} {paz_outfile}"
                    if line != last:
                        lines.append(line)
                    last = line
    if outfile is not None:
        with open(outfile, "a" if append else "w") as f:
            f.write("".join(line + "\n" for line in lines))
        if not quiet:
            print(f"Wrote {outfile}.")
    elif not quiet:
        for line in lines:
            print(line)
    return lines


def apply_zaps(datafile, zap_channels, all_subs=False, outfile=None,
               quiet=False, tracer=None):
    """Zero the weights of flagged channels in the archive (the
    replacement for shelling out to ``paz``).  zap_channels:
    [subint][channel indices].  The PSRFITS writer re-quantizes DATA
    from the decoded floats, so the data pick up ~half-LSB noise; for a
    lossless offline zap feed the lists to the stream drivers'
    ``zap_channels=`` (quality.zap_bunch) instead.  tracer: one
    ``zap_apply``."""
    tracer = NULL_TRACER if tracer is None else tracer
    arch = read_archive(datafile)
    w = arch.get_weights()
    for isub, chans in enumerate(zap_channels):
        if not len(chans):
            continue
        if all_subs:
            w[:, np.asarray(chans, int)] = 0.0
        elif isub < len(w):
            w[isub, np.asarray(chans, int)] = 0.0
    arch.set_weights(w)
    arch.unload(outfile or datafile)
    n = sum(map(len, zap_channels))
    if tracer.enabled:
        tracer.emit("zap_apply", datafile=str(datafile), n_channels=int(n))
    if not quiet:
        print(f"Zapped {n} channel entries in {outfile or datafile}.")
    return w
