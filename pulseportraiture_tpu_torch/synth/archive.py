"""Fake-pulsar PSRFITS generation — the de-facto end-to-end test
fixture (reference make_fake_pulsar, pplib.py:3302-3499, driven by
examples/example.py).

Same injection knobs as the reference: phase offset, dDM, DM(nu)
power-law terms, scattering, scintillation, per-channel scales/noise,
weights/RFI masks, dispersed or dedispersed output.  One deliberate
difference: the reference snapshot's phase/dDM injection line is
commented out (pplib.py:3463-3465), silently injecting nothing; here
the documented behavior — rotate by (phase, dDM) with dispersion
referenced to nu_DM (default: infinite frequency) — is implemented.

Host-side numpy except for the template portrait, which the torch
generator builds in float64 on ``device``.  Noise comes from a seeded
numpy Generator.
"""

import numpy as np
import torch

from ..config import Dconst, scattering_alpha
from ..device import resolve_device
from ..io.gmodel import gen_gmodel_portrait, read_gmodel
from ..io.psrfits import new_archive, parse_parfile, rotate_phase
from ..utils.mjd import MJD


def add_scintillation(port, params=None, random=True, nsin=2, amax=1.0,
                      wmax=3.0, rng=None):
    """Multiply channels by a sum of sin^2 patterns (reference
    pplib.py:1190-1218).  params: flat triplets (amp, freq [cycles],
    phase [cycles]); otherwise ``nsin`` random sinusoids."""
    port = np.asarray(port, np.float64)
    nchan = port.shape[0]
    pattern = np.zeros(nchan)
    if params is None and not random:
        return port
    if params is not None:
        triplets = [params[i:i + 3] for i in range(0, len(params), 3)]
    else:
        rng = rng or np.random.default_rng()
        triplets = [(rng.uniform(0, amax), rng.chisquare(wmax),
                     rng.uniform(0, 1)) for _ in range(nsin)]
    for a, w, p in triplets:
        pattern += a * np.sin(np.linspace(0.0, w * np.pi, nchan)
                              + p * np.pi) ** 2.0
    return port * pattern[:, None]


def _dm_nu_delays(phase, dDM, P, freqs, xs, Cs, nu_DM):
    """Delays [rot] for the injected rotation: an achromatic phase
    plus either the standard nu^-2 dispersion of dDM or arbitrary
    power-law terms sum_i C_i*(nu^x_i - nu_DM^x_i)/P (reference
    add_DM_nu, pplib.py:2601-2638)."""
    freqs = np.asarray(freqs, np.float64)
    if xs is None:
        xs, Cs = [-2.0], [Dconst * dDM]
    delays = np.full(freqs.shape, float(phase))
    for x, C in zip(xs, Cs):
        ref_term = 0.0 if np.isinf(nu_DM) else float(nu_DM) ** x
        delays = delays + C * (freqs ** x - ref_term) / P
    return delays


def make_fake_pulsar(modelfile, ephemeris, outfile="fake_pulsar.fits",
                     nsub=1, npol=1, nchan=512, nbin=2048, nu0=1500.0,
                     bw=800.0, tsub=300.0, phase=0.0, dDM=0.0,
                     start_MJD=None, weights=None, noise_stds=1.0,
                     scales=1.0, dedispersed=False, t_scat=0.0,
                     alpha=scattering_alpha, scint=False, xs=None, Cs=None,
                     nu_DM=np.inf, state="Stokes", telescope="GBT",
                     quiet=False, rng=None, barycentred=True,
                     spin_coherent=False, nbit=16, levels=None,
                     dither=False, device=None):
    """Generate a fake fold-mode PSRFITS archive with known injected
    parameters and write it to ``outfile``.  Returns the Archive.

    Signature parity with the reference (pplib.py:3302); start_MJD may
    be a utils.mjd.MJD or a float MJD; ``rng`` (numpy Generator or
    seed) makes the noise/scint draws reproducible.

    The template portrait is generated on ``device`` (default cuda).

    spin_coherent=True ties the absolute pulse phase of every subint to
    the spin ephemeris — each subint is additionally rotated by
    -frac(F0 (epoch - PEPOCH)), computed in exact rational arithmetic
    (the product is ~1e9 turns, beyond f64) — which is what
    polyco-driven folding produces on real archives.  With it, measured
    TOAs from different epochs phase-connect: a timing fit
    (timing.wideband_gls_fit) yields white residuals.  Default False:
    each archive's absolute phase is arbitrary (grid-aligned).

    Binary pulsars: when the ephemeris carries a complete ELL1 or BT
    element set (timing/binary.py semantics; partial sets and
    unsupported models raise), spin_coherent folding additionally delays
    each subint by the orbital Roemer delay — the pulse phase becomes
    frac(F0 (epoch - Delta_R(epoch) - PEPOCH)).  The delay is evaluated
    at the SUBINT EPOCH; the measurement reports the TOA up to half a
    spin period away, where the true orbit has moved on — a mistiming
    bounded by pi * A1 * P / PB seconds.  Keep the orbit mild enough
    that this sits below the TOA noise (e.g. A1 = 0.05 lt-s, PB = 1 d,
    P = 4 ms leaves < 0.01 us).  Binary keys without spin_coherent=True
    are ignored.  The rotation comes before the noise, so it composes
    with ``dither``.

    ``nbit``/``levels`` select the written DATA sample width and
    quantization depth (io/psrfits.write_archive_file): nbit=2 forges
    the sub-byte packed archives the raw streaming lane ships 32x
    smaller; levels=4 with nbit=8 forges the coarsely-quantized byte
    archives the transport-compression cost model packs on the fly.
    dither=True quantizes the sub-byte or level-limited samples with
    rectangular dither drawn from ``rng`` after the noise
    (io/psrfits.write_archive_file), so their mean is the unquantized
    profile.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(rng)
    model = read_gmodel(modelfile, quiet=True) \
        if isinstance(modelfile, (str, bytes)) else modelfile
    par = parse_parfile(ephemeris) if isinstance(ephemeris, (str, bytes)) \
        else dict(ephemeris)
    PSR = par.get("PSR", par.get("PSRJ", "FAKE"))
    if "P0" in par:
        P0 = float(par["P0"])
    elif "F0" in par:
        P0 = 1.0 / float(par["F0"].replace("D", "E")
                         if isinstance(par["F0"], str) else par["F0"])
    else:
        raise ValueError("ephemeris needs P0 or F0")
    DM = float(par.get("DM", 0.0))
    PEPOCH = float(par.get("PEPOCH", 55000.0))

    chanwidth = bw / nchan
    lofreq = nu0 - bw / 2.0
    freqs = np.linspace(lofreq + chanwidth / 2.0,
                        lofreq + bw - chanwidth / 2.0, nchan)
    phases = (np.arange(nbin) + 0.5) / nbin

    noise_stds = np.broadcast_to(np.asarray(noise_stds, float),
                                 (nchan,)).copy()
    scales = np.broadcast_to(np.asarray(scales, float), (nchan,)).copy()
    if weights is None:
        weights = np.ones((nsub, nchan))
    weights = np.asarray(weights, float)

    if start_MJD is None:
        start_MJD = MJD.from_float(PEPOCH)
    elif not isinstance(start_MJD, MJD):
        start_MJD = MJD.from_float(float(start_MJD))
    epochs = [start_MJD.add_seconds((isub + 0.5) * tsub)
              for isub in range(nsub)]

    # clean dedispersed model portrait (tau from the modelfile is in
    # seconds and scatters during generation)
    base = gen_gmodel_portrait(model, phases, freqs, P=P0, quiet=True,
                               device=dev)
    # injected achromatic phase + dDM (or DM(nu) terms): delay the data
    delays = _dm_nu_delays(phase, dDM, P0, freqs, xs, Cs, nu_DM)
    rotmodel = rotate_phase(base, -delays)
    if t_scat and model.tau == 0.0:  # modelfile overrides
        from ..ops.scattering import scattering_portrait_FT, scattering_times

        taus = scattering_times(
            t_scat / P0, alpha,
            torch.as_tensor(freqs, dtype=torch.float64, device=dev), nu0)
        B = scattering_portrait_FT(taus, nbin // 2 + 1).cpu().numpy()
        rotmodel = np.fft.irfft(np.fft.rfft(rotmodel, axis=-1) * B,
                                n=nbin, axis=-1)

    spin_fracs = np.zeros(nsub)
    if spin_coherent:
        # frac(F0 * (epoch - PEPOCH)) per subint, exactly (~1e9 turns,
        # beyond f64) — the rational helper the timing fit reduces with,
        # so both use the identical F0 representation
        from ..timing.binary import binary_delay_np, parse_binary
        from ..utils.spin import rational, spin_F0, spin_phase_frac

        F0r = spin_F0(par)
        F0f = float(F0r)
        pep = rational(par.get("PEPOCH", PEPOCH))  # parsed once
        bp = parse_binary(par)  # None for isolated; loud on partial
        for isub, e in enumerate(epochs):
            frac = spin_phase_frac(F0r, pep, e.day, e.frac)
            if bp is not None:
                # the pulse is LATE by the orbital Roemer delay: phase
                # at the epoch is F0*(t - Delta_R - PEPOCH).  F0*Delta
                # is only ~1e2 turns, safe as a float product (and the
                # SAME float F0 the timing fit's remainder term uses)
                frac -= F0f * float(binary_delay_np(bp, e.day, e.frac))
            spin_fracs[isub] = frac % 1.0

    amps = np.zeros((nsub, npol, nchan, nbin))
    for isub in range(nsub):
        port = rotmodel
        if spin_coherent and spin_fracs[isub] != 0.0:
            # pulse earlier by the ephemeris phase at this epoch, so
            # epoch + phi*P phase-connects across the campaign
            port = rotate_phase(port, spin_fracs[isub])
        if scint is not False:
            if scint is True:
                port = add_scintillation(port, random=True, nsin=3,
                                         amax=1.0, wmax=5.0, rng=rng)
            else:
                port = add_scintillation(port, scint)
        for ipol in range(npol):
            # NB like the reference: pols are not realistic (same model
            # and noise level in every pol)
            noisy = scales[:, None] * port
            nz = noise_stds[:, None] * rng.standard_normal((nchan, nbin))
            amps[isub, ipol] = noisy + np.where(noise_stds[:, None] > 0,
                                                nz, 0.0)

    psrparam = [f"{k} {v}" for k, v in par.items()]
    arch = new_archive(
        amps, freqs, P0, epochs, tsub, weights=weights, DM=DM,
        dedispersed=True, source=PSR, telescope=telescope, nu0=nu0, bw=bw,
        state=("Intensity" if npol == 1 else state), psrparam=psrparam)
    if "RAJ" in par:
        arch.primary["RA"] = str(par["RAJ"])
    if "DECJ" in par:
        arch.primary["DEC"] = str(par["DECJ"])
    if barycentred:
        # the injected data carry no topocentric Doppler signature, so
        # mark the archive barycentred: Archive.doppler_factors() then
        # returns 1.0 instead of ephemeris-computed factors.  Pass
        # barycentred=False to test the Doppler-correction path.
        arch.primary["PPTBARY"] = True
    if not dedispersed:
        arch.dededisperse()
    arch.unload(outfile, nbit=nbit, levels=levels,
                dither=rng if dither else None)
    if not quiet:
        print(f"\nUnloaded {outfile}.\n")
    return arch
