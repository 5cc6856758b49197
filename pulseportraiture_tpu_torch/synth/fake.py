"""Synthetic portraits, template models and timing campaigns
(counterpart of pulseportraiture_tpu/synth/fake.py).

default_test_model, the known-truth template the synthetic archives
(synth/archive.py) are generated from; fake_portrait and
fake_observation, portraits with known injected (phi, DM, GM, tau,
alpha, scales, noise, zapped channels, scintillation) in torch on a
device; and fake_timing_campaign, TOA campaigns straight from a parfile
for the timing fits (host numpy with numpy Generators, draw for draw as
in the JAX package).

The portraits' random draws come from an explicit ``torch.Generator``
(None: a fixed seed) where the JAX package takes a PRNG key, so noisy
portraits agree with the JAX ones in distribution, not draw for draw.
"""

import math

import numpy as np
import torch

from ..device import resolve_device
from ..models.gaussian import GaussianModel, gen_gaussian_portrait
from ..ops.phasor import phase_shifts, phasor
from ..ops.scattering import add_scattering, scattering_times
from ..utils.bunch import DataBunch

__all__ = ["default_test_model", "fake_portrait", "fake_observation",
           "fake_timing_campaign"]


def default_test_model(nu_ref=1500.0):
    """A 3-component evolving-Gaussian model (the same values as the
    JAX package's default_test_model)."""
    return GaussianModel(
        name="FAKE_0000+0000",
        code="000",
        nu_ref=nu_ref,
        dc=0.0,
        tau=0.0,
        alpha=-4.0,
        locs=np.array([0.48, 0.505, 0.52]),
        wids=np.array([0.045, 0.015, 0.022]),
        amps=np.array([4.0, 9.5, 2.5]),
        mlocs=np.array([-0.005, -0.003, 0.003]),
        mwids=np.array([-0.2, 0.16, -0.3]),
        mamps=np.array([-1.6, -2.0, -0.9]),
    )


def _generator(key):
    """The portraits' random source: ``key`` itself, or a generator
    seeded 0 when it is None."""
    return torch.Generator().manual_seed(0) if key is None else key


def fake_portrait(key, model, freqs, nbin, P, phi=0.0, DM=0.0, GM=0.0,
                  tau=0.0, alpha=None, nu_ref=None, scales=None,
                  noise_std=1.0, zap_frac=0.0, scint_nsin=0,
                  dtype=torch.float64, device=None):
    """One (nchan, nbin) data portrait with known injected parameters, on
    ``device`` (default cuda).

    phi/DM/GM are referenced to ``nu_ref`` (default: model.nu_ref); a
    fit of this portrait against the clean model should recover them
    there.  ``tau`` [s at nu_ref] scatters with index ``alpha``;
    ``scales`` (nchan,) multiplies channels; ``noise_std`` adds white
    noise; ``zap_frac`` zero-weights each channel with that probability;
    ``scint_nsin`` multiplies a sin^2 scintillation pattern of that many
    half-periods across the band.  ``key``: a torch.Generator (None: a
    fixed seed); the draws are made on its device.

    Returns a DataBunch with port, model_port, weights, noise_stds (those
    tensors on the device), freqs, P and the injected truth values.
    """
    dev = resolve_device(device)
    gen = _generator(key)
    freqs = torch.as_tensor(np.asarray(freqs, float) if not isinstance(
        freqs, torch.Tensor) else freqs).to(device=dev, dtype=dtype)
    nchan = freqs.shape[0]
    nu_ref = model.nu_ref if nu_ref is None else nu_ref
    alpha = model.alpha if alpha is None else alpha

    def draw(fn, shape):
        return fn(shape, generator=gen, dtype=dtype,
                  device=gen.device).to(dev)

    clean = gen_gaussian_portrait(model.params(dev, dtype), freqs,
                                  model.nu_ref, nbin, P=P, code=model.code,
                                  scattered=False)
    port = clean
    if tau != 0.0:
        port = add_scattering(port, scattering_times(tau / P, alpha, freqs,
                                                     nu_ref))
    # delay by the injected (phi, DM, GM): rotate to *later* phase, so
    # that a fit returns positive (phi, DM, GM)
    delays = phase_shifts(phi, DM, GM, freqs, P, nu_ref, nu_ref)
    pFT = torch.fft.rfft(port, dim=-1)
    pFT = pFT * torch.conj(phasor(delays, pFT.shape[-1]))
    port = torch.fft.irfft(pFT, n=nbin, dim=-1)

    if scint_nsin:
        x = torch.linspace(0.0, scint_nsin * math.pi, nchan, dtype=dtype,
                           device=dev)
        u = draw(torch.rand, ())
        pattern = torch.sin(x + u * 2 * math.pi) ** 2.0 + 0.1
        port = port * pattern[:, None]
    if scales is not None:
        port = port * torch.as_tensor(np.asarray(scales, float)).to(
            device=dev, dtype=dtype)[:, None]
    if noise_std:
        port = port + noise_std * draw(torch.randn, tuple(port.shape))
    weights = torch.ones(nchan, dtype=dtype, device=dev)
    if zap_frac > 0.0:
        weights = (draw(torch.rand, (nchan,)) >= zap_frac).to(dtype)
        port = port * weights[:, None]

    return DataBunch(
        port=port, model_port=clean, freqs=freqs, weights=weights,
        noise_stds=torch.full((nchan,), float(noise_std), dtype=dtype,
                              device=dev),
        P=P, nbin=nbin, nu_ref=nu_ref, phi=phi, DM=DM, GM=GM, tau=tau,
        alpha=alpha, scales=scales)


def fake_observation(key, model, nsub=1, nchan=64, nbin=1024, P=0.002,
                     lofreq=1200.0, bw=800.0, dDM_std=0.0, **kwargs):
    """A stack of subint portraits (nsub, nchan, nbin) with per-subint
    dDMs drawn from N(0, dDM_std), the shape pptoas consumes; the other
    keywords (device= among them) go to fake_portrait.  ``key``: a
    torch.Generator (None: a fixed seed) that draws the dDMs and then
    every subint in turn.

    Returns (DataBunch with the subints stacked, the injected dDMs as a
    numpy array)."""
    gen = _generator(key)
    freqs = lofreq + (bw / nchan) * (np.arange(nchan) + 0.5)
    dDMs = dDM_std * torch.randn((nsub,), generator=gen,
                                 dtype=torch.float64,
                                 device=gen.device).cpu().numpy()
    base_DM = kwargs.pop("DM", 0.0)
    truths = [fake_portrait(gen, model, freqs, nbin, P,
                            DM=base_DM + float(dDMs[i]), **kwargs)
              for i in range(nsub)]
    first = truths[0]
    return (DataBunch(
        subints=torch.stack([t.port for t in truths]),
        model_port=first.model_port, freqs=first.freqs,
        weights=torch.stack([t.weights for t in truths]),
        noise_stds=torch.stack([t.noise_stds for t in truths]),
        P=P, nbin=nbin, nu_ref=first.nu_ref, DMs=base_DM + dDMs), dDMs)


def fake_timing_campaign(par, truth=None, n_epochs=10, toas_per_epoch=2,
                         span_days=90.0, toa_err_us=0.1, dm_err=2e-4,
                         dmx=0.0, start_mjd=None, rng=None, site="@",
                         glitch=None, dm_step=None):
    """Synthesize a phase-connected wideband TOA campaign directly
    from a parfile — no archives, no portrait fits.

    The timing subsystem (timing/gls.py, timing/fleet.py) consumes
    ``.tim``-level TimTOA lists; generating them through the full
    archive -> GetTOAs pipeline costs seconds per pulsar, which makes
    fleet-scale fixtures (dozens of pulsars) impractical.  This helper
    realizes the TRUTH ephemeris exactly at the TOA level: for each
    epoch it picks an integer pulse number in exact rational
    arithmetic (utils/spin.py — frac(F0*dt) is ~1e9
    turns, beyond f64), places the barycentric arrival at that pulse,
    adds the orbital Roemer delay of the truth binary model by
    fixed-point iteration (two steps; the map contracts by 2*pi*A1/PB
    per step, so the self-consistency error is far below any TOA
    noise), and jitters by white noise of ``toa_err_us``.

    par:   the NOMINAL parfile mapping (what the caller will fit
           with).  truth: overrides merged over par to form the truth
           ephemeris (e.g. {'PB': pb + 1e-6}) — the fitted
           corrections should recover truth - par.
    dmx:   per-epoch DM offsets [pc cm^-3]: an array (len n_epochs),
           or a scalar std for random draws (0 = none).
    toa frequencies are infinite (the .tim 0.0-MHz convention): the
    dispersion delay is zero and the DMX columns are constrained
    through the DM rows alone, which keeps the fixture orthogonal to
    the dispersion machinery other tests cover.

    Returns (toas, truth_bunch) with truth_bunch carrying the truth
    par, the per-epoch DMX draws, and the injected correction dict
    {name: truth - nominal} for every spin/binary fit parameter.

    Anomaly injection (ground truth for anomaly detectors):

    glitch:  {'epoch': k[, 'dphi': turns][, 'df0': Hz]} — from epoch
             k onward every arrival picks up the ACHROMATIC time step
             of a pulsar glitch: -dphi/F0 seconds (the phase jump)
             plus -df0*(t - t_glitch)/F0 (the frequency step's growing
             ramp).  Sign convention: a spun-UP pulsar (positive
             dphi/df0) arrives EARLY.
    dm_step: {'epoch': k, 'ddm': pc cm^-3} — the per-epoch DM offsets
             gain a persistent step of ddm from epoch k onward (the
             nu^-2 chromatic signature; at these infinite-frequency
             TOAs it rides the wideband DM measurements directly).

    Both events are recorded in the truth bunch as ``glitch`` /
    ``dm_step`` dicts with their epoch index and epoch MJD, so
    detection tests can score localization against ground truth.
    """
    from fractions import Fraction

    from ..timing.binary import binary_delay_np, parse_binary
    from ..timing.tim import TimTOA
    from ..utils.spin import rational, spin_F0

    rng = np.random.default_rng(rng)
    par = dict(par)
    tpar = {**par, **(truth or {})}
    F0r = spin_F0(tpar)
    pep = rational(tpar["PEPOCH"])
    DM0 = float(str(tpar.get("DM", 0.0)).replace("D", "E"))
    bp = parse_binary(tpar)
    if start_mjd is None:
        start_mjd = float(pep)
    dmx_arr = (np.asarray(dmx, float) if np.ndim(dmx) else
               (float(dmx) * rng.standard_normal(n_epochs)
                if dmx else np.zeros(n_epochs)))
    if dmx_arr.shape != (n_epochs,):
        raise ValueError(
            f"fake_timing_campaign: dmx must be scalar or length "
            f"{n_epochs}, got shape {dmx_arr.shape}")

    step = span_days / max(n_epochs - 1, 1)

    def _event(spec, name, keys):
        if spec is None:
            return None
        spec = dict(spec)
        bad = set(spec) - ({"epoch"} | set(keys))
        if bad or "epoch" not in spec:
            raise ValueError(
                f"fake_timing_campaign: {name} must be a dict with "
                f"'epoch' and any of {sorted(keys)}, got {spec!r}")
        ep = int(spec["epoch"])
        if not 0 <= ep < n_epochs:
            raise ValueError(
                f"fake_timing_campaign: {name} epoch {ep} outside "
                f"[0, {n_epochs})")
        spec["epoch"] = ep
        spec["mjd"] = start_mjd + ep * step
        return spec

    glitch = _event(glitch, "glitch", ("dphi", "df0"))
    dm_step = _event(dm_step, "dm_step", ("ddm",))
    if dm_step is not None:
        dmx_arr = dmx_arr.copy()
        dmx_arr[dm_step["epoch"]:] += float(dm_step["ddm"])

    F0 = float(F0r)
    toas = []
    for k in range(n_epochs):
        for j in range(toas_per_epoch):
            # target epoch; intra-epoch TOAs sit minutes apart so the
            # GLS 0.5-day gap grouping keeps them in one DMX epoch
            e = start_mjd + k * step + j * (180.0 / 86400.0)
            dt_s = (rational(e) - pep) * 86400
            N = round(F0r * dt_s)  # exact integer pulse number
            t_bary = pep + Fraction(N) / (F0r * 86400)  # days, exact
            day = int(t_bary // 1)
            frac = float(t_bary - day)
            delay = 0.0
            if bp is not None:
                # t_obs = t_bary + Delta(t_obs): two fixed-point steps
                delay = float(binary_delay_np(bp, day, frac))
                d1 = t_bary + Fraction(delay) / 86400
                delay = float(binary_delay_np(
                    bp, int(d1 // 1), float(d1 - int(d1 // 1))))
            noise_s = float(toa_err_us) * 1e-6 * rng.standard_normal()
            event_s = 0.0
            if glitch is not None and k >= glitch["epoch"]:
                dt_g = (e - glitch["mjd"]) * 86400.0
                event_s = -(float(glitch.get("dphi", 0.0))
                            + float(glitch.get("df0", 0.0)) * dt_g) / F0
            t_obs = t_bary + Fraction(delay + noise_s + event_s) / 86400
            day = int(t_obs // 1)
            frac = float(t_obs - day)
            toas.append(TimTOA(
                archive=f"synth_{k:03d}_{j}", frequency=np.inf,
                mjd_int=day, mjd_frac=frac,
                error_us=float(toa_err_us), site=site,
                dm=DM0 + dmx_arr[k] + dm_err * rng.standard_normal(),
                dm_err=float(dm_err)))

    # the correction dict a fit against the NOMINAL par should recover
    def _f(m, k, d=0.0):
        v = m.get(k)
        return float(str(v).replace("D", "E")) if v is not None else d

    injected = {}
    if _f(tpar, "F0") and _f(par, "F0"):
        injected["F0"] = _f(tpar, "F0") - _f(par, "F0")
    for key in ("PB", "A1", "TASC", "T0", "EPS1", "EPS2", "ECC", "OM"):
        if par.get(key) is not None or tpar.get(key) is not None:
            injected[key] = _f(tpar, key) - _f(par, key)
    return toas, DataBunch(par=tpar, nominal=par, dmx=dmx_arr,
                           injected=injected, binary=bp,
                           glitch=glitch, dm_step=dm_step)
