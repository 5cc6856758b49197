"""Diagnostic plots (counterpart of pulseportraiture_tpu/viz/plots.py).

show_portrait, show_stacked_profiles, show_profiles, show_residual_plot,
show_spline_curve_projections, show_eigenprofiles and the flux-profile
plot of fit_flux_profile, drawn on the host with matplotlib, headless
(Agg) unless a display is configured.  The numbers inside a plot (noise
estimates, phase fits, rotations, spline curves) come from the port's
own functions on ``device`` (default cuda; pass ``device="cpu"`` on a
host without a card).

matplotlib is imported when a plot is drawn, not with this module: a
host without it (a card machine) imports the package and the pipelines,
and a plot call there raises ImportError naming matplotlib.
"""

import os

import numpy as np
import torch

from ..device import resolve_device


def _pyplot():
    """matplotlib.pyplot, headless (Agg) unless a display is configured;
    ImportError naming matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the port's plots need matplotlib, which is not installed "
            f"here ({e})") from e
    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _f64(x, dev):
    return torch.as_tensor(np.asarray(x, np.float64), device=dev)


def set_colormap(name="viridis"):
    """Set the default image colormap (reference pplib.py:677)."""
    _pyplot().rcParams["image.cmap"] = name


def _finish(fig, show, savefig):
    plt = _pyplot()
    if savefig:
        fig.savefig(savefig, bbox_inches="tight", dpi=120)
        plt.close(fig)
    elif show:
        plt.show()
    return fig


def show_portrait(port, phases=None, freqs=None, title=None, prof=True,
                  fluxprof=True, rvrsd=False, colorbar=True, show=True,
                  savefig=None, aspect="auto", interpolation="none",
                  origin="lower", extent=None, **kwargs):
    """Portrait image with average-profile (top) and phase-averaged-
    spectrum (left) side panels (reference pplib.py:3652-3757: same
    panel geometry, zero-weight channels compressed out of both side
    panels, rvrsd frequency flip, colorbar, extent override, and
    imshow passthrough kwargs e.g. vmin/vmax)."""
    plt = _pyplot()
    port = np.asarray(port)
    nchan, nbin = port.shape
    if phases is None:
        phases = np.arange(nbin)
        xlabel = "Bin Number"
    else:
        phases = np.asarray(phases)
        xlabel = "Phase [rot]"
    if freqs is None:
        freqs = np.arange(nchan)
        ylabel = "Channel Number"
    else:
        freqs = np.asarray(freqs)
        ylabel = "Frequency [MHz]"
    if rvrsd:
        freqs = freqs[::-1]
        port = port[::-1]
    if extent is None:
        extent = (phases[0], phases[-1], freqs[0], freqs[-1])
    # zero-weight (zapped) channels carry no flux: compress them out
    # of the side panels exactly like the reference (weights = channel
    # means; np.compress)
    weights = port.mean(axis=1)
    portx = np.compress(weights, port, axis=0)
    fluxx = np.compress(weights, weights)
    freqsx = np.compress(weights, freqs)
    if portx.size == 0:  # fully zapped: fall back to raw panels
        portx, fluxx, freqsx = port, weights, freqs

    fig = plt.figure(figsize=(7.5, 6))
    gs = fig.add_gridspec(2 if prof else 1, 2 if fluxprof else 1,
                          width_ratios=([1, 3] if fluxprof else [1]),
                          height_ratios=([1, 3] if prof else [1]),
                          hspace=0.05, wspace=0.05)
    ax_im = fig.add_subplot(gs[-1, -1])
    im = ax_im.imshow(port, aspect=aspect, origin=origin, extent=extent,
                      interpolation=interpolation, **kwargs)
    if colorbar:
        fig.colorbar(im, ax=ax_im, pad=0.01)
    ax_im.set_xlabel(xlabel)
    if fluxprof:
        ax_im.tick_params(labelleft=False)
    else:
        ax_im.set_ylabel(ylabel)
    if prof:
        ax_p = fig.add_subplot(gs[0, -1], sharex=ax_im)
        avg = portx.mean(axis=0)
        ax_p.plot(phases, avg, "k-", lw=1)
        ax_p.tick_params(labelbottom=False)
        rng = avg.max() - avg.min()
        if rng > 0:  # a flat (fully-zapped) profile keeps auto limits
            ax_p.set_ylim(avg.min() - 0.03 * rng,
                          avg.max() + 0.05 * rng)
        ax_p.set_ylabel("Flux Units")
        if title:
            ax_p.set_title(title)
    elif title:
        ax_im.set_title(title)
    if fluxprof:
        ax_f = fig.add_subplot(gs[-1, 0], sharey=ax_im)
        # phase-averaged spectrum as markers, flux increasing LEFTWARD
        # (the reference's inverted x-axis, pplib.py:3741-3746)
        ax_f.plot(fluxx, freqsx, "kx", ms=4)
        rng = fluxx.max() - fluxx.min()
        if rng > 0:
            ax_f.set_xlim(fluxx.max() + 0.03 * rng,
                          min(fluxx.min(), 0.0) - 0.01 * rng)
        else:
            ax_f.invert_xaxis()
        ax_f.set_xlabel("Flux Units")
        ax_f.set_ylabel(ylabel)
    return _finish(fig, show, savefig)


def show_stacked_profiles(port, freqs=None, *, model_profiles=None,
                          phases=None, rvrsd=False, fit=False,
                          spacing=None, fact=0.25, show=True,
                          savefig=None, title=None, device=None):
    """Vertically offset per-channel profiles with optional overlaid
    model profiles (reference pplib.py:3760-3824: dashed model under
    solid data in matching colors; fit=True aligns/scales each model
    to its data profile via fit_phase_shift first; frequency tick
    labels every 10 channels; rvrsd flips the stack).  The fits run in
    float64 on ``device`` (default cuda)."""
    plt = _pyplot()
    port = np.asarray(port)
    nchan, nbin = port.shape
    models = None if model_profiles is None else \
        np.asarray(model_profiles)
    if phases is None:
        phases = np.arange(nbin)
        xlabel = "Bin Number"
    else:
        phases = np.asarray(phases)
        xlabel = "Phase [rot]"
    if freqs is None:
        freqs = np.arange(nchan)
        ylabel = "Approx. Channel Number"
    else:
        freqs = np.asarray(freqs)
        ylabel = "Approx. Frequency [MHz]"
    if rvrsd:
        freqs = freqs[::-1]
        port = port[::-1]
        if models is not None:
            models = models[::-1]
    if spacing is None:
        spacing = (port.max() - port.min()) * fact
    fig, ax = plt.subplots(figsize=(5, 8))
    for i in range(nchan):
        base = i * spacing
        if models is not None:
            mprof = models[i]
            if fit and np.any(port[i] - mprof):
                from ..fit.phase_shift import fit_phase_shift
                from ..ops.rotation import rotate_profile

                dev = resolve_device(device)
                r = fit_phase_shift(_f64(port[i], dev), _f64(mprof, dev),
                                    device=dev)
                mprof = float(r.scale) * rotate_profile(
                    _f64(mprof, dev), -float(r.phase)).cpu().numpy()
            m, = ax.plot(phases, mprof + base, lw=1.2, ls="dashed")
            ax.plot(phases, port[i] + base, lw=0.8, ls="solid",
                    color=m.get_color())
        else:
            ax.plot(phases, port[i] + base, "k-", lw=0.6)
    ax.set_xlabel(xlabel)
    step = max(1, nchan // 10)
    ax.set_yticks(np.arange(nchan)[::step] * spacing)
    ax.set_yticklabels([str(int(round(f))) for f in freqs[::step]])
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    return _finish(fig, show, savefig)


def show_profiles(profiles, labels=None, show=True, savefig=None,
                  title=None):
    """Overlayed profiles (reference pplib.py:3827-3850)."""
    plt = _pyplot()
    profiles = np.atleast_2d(np.asarray(profiles))
    nbin = profiles.shape[-1]
    phases = (np.arange(nbin) + 0.5) / nbin
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, prof in enumerate(profiles):
        label = labels[i] if labels else None
        ax.plot(phases, prof, lw=1, label=label)
    ax.set_xlabel("Phase [rot]")
    ax.set_ylabel("Flux")
    if labels:
        ax.legend()
    if title:
        ax.set_title(title)
    return _finish(fig, show, savefig)


# composite red-chi2 histogram bin edges (reference pplib.py:3955-3957):
# fine [0, 2], coarser decades above, an overflow bin at the end
_RCHI2_BINS = np.concatenate([
    np.linspace(0.0, 2.0, 21), np.linspace(3.0, 10.0, 8),
    np.linspace(20.0, 100.0, 9), np.linspace(200.0, 1000.0, 9),
    [np.inf]])


def show_residual_plot(port, model, phases=None, freqs=None,
                       noise_stds=None, weights=None, titles=None,
                       resids=None, nfit=0, rvrsd=False, colorbar=True,
                       show=True, savefig=None, device=None,
                       **imshow_kwargs):
    """Data / model / residual triptych with a per-channel reduced-chi2
    histogram (reference pplib.py:3853-3974; same behaviors):

    - the model panel shares the DATA panel's color limits, so over-
      and under-fitting are visible at a glance;
    - per-panel colorbars (colorbar=False to drop), rvrsd frequency
      flip, imshow passthrough kwargs (vmin/vmax/cmap/...);
    - axis labels fall back to bin/channel NUMBERS when phases/freqs
      are not given;
    - the histogram uses the reference's composite bins (fine to 2,
      decade blocks above, overflow at inf), a step outline, log x
      when the channel spread exceeds two decades, x-limits hugging
      [0.9 min, 1.1 max], and counts only unzapped channels
      ("# chans. (total = N)"); dof = nbin - nfit per channel.
    resids: precomputed residuals (default port - model); noise_stds:
    per-channel sigmas (None -> power-spectrum estimate); weights:
    channels with weight <= 0 are excluded from the histogram (the
    reference compresses on the row means); device: where the noise
    estimate runs, in float64 (default cuda)."""
    from ..ops.noise import get_noise_PS

    plt = _pyplot()

    port = np.asarray(port)
    model = np.asarray(model)
    resid = np.asarray(resids) if resids is not None else port - model
    nchan, nbin = port.shape
    if phases is None:
        phases = np.arange(nbin)
        xlabel = "Bin Number"
    else:
        phases = np.asarray(phases)
        xlabel = "Phase [rot]"
    if freqs is None:
        freqs = np.arange(nchan)
        ylabel = "Channel Number"
    else:
        freqs = np.asarray(freqs)
        ylabel = "Frequency [MHz]"
    if noise_stds is not None:
        noise_stds = np.asarray(noise_stds)
    if rvrsd:
        freqs = freqs[::-1]
        port, model, resid = port[::-1], model[::-1], resid[::-1]
        if noise_stds is not None:
            noise_stds = noise_stds[::-1]
        if weights is not None:
            weights = np.asarray(weights)[::-1]
    extent = [phases[0], phases[-1], freqs[0], freqs[-1]]
    fig, axes = plt.subplots(2, 2, figsize=(8.5, 6.67))
    im0 = None
    panels = [(port, "Data"), (model, "Model"), (resid, "Residuals")]
    for i, (ax, (img, name)) in enumerate(zip(axes.flat, panels)):
        kw = dict(imshow_kwargs)
        if i == 1 and im0 is not None and "vmin" not in kw \
                and "norm" not in kw:
            # reference: the model panel inherits the data panel's clim
            # (skipped when the caller controls scaling via vmin/norm —
            # imshow rejects a norm combined with vmin/vmax)
            kw["vmin"], kw["vmax"] = im0.get_clim()
        im = ax.imshow(img, aspect="auto", origin="lower", extent=extent,
                       interpolation="none", **kw)
        if i == 0:
            im0 = im
        if colorbar:
            fig.colorbar(im, ax=ax)
        ax.set_title(titles[i] if titles else name)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)

    ax = axes.flat[3]
    ok = np.asarray(weights) > 0 if weights is not None \
        else np.abs(port).mean(axis=1) > 0
    if noise_stds is None:
        dev = resolve_device(device)
        sig = get_noise_PS(_f64(port, dev)).cpu().numpy()  # every row
    else:
        sig = noise_stds
    sig = np.where(sig > 0, sig, np.inf)
    dof = max(nbin - nfit, 1)
    rchi2 = (resid ** 2).sum(axis=1) / sig ** 2 / dof
    rchi2 = rchi2[ok & np.isfinite(rchi2)]
    if len(rchi2):
        ax.hist(rchi2, bins=_RCHI2_BINS, histtype="step", color="k")
        lo, hi = rchi2.min(), rchi2.max()
        if lo > 0 and np.log10(hi) - np.log10(lo) > 2:
            ax.semilogx()
        ax.set_xlim(0.9 * lo, 1.1 * hi)
        ax.set_xlabel(r"Red. $\chi^2$")
        ax.set_ylabel(f"# chans. (total = {len(rchi2)})")
        ax.set_title(r"Channel Reduced $\chi^2$")
    else:
        ax.axis("off")
    fig.tight_layout()
    return _finish(fig, show, savefig)


def plot_flux_profile(freqs, fluxes, flux_errs, fit_result, nu_ref,
                      show=True, savefig=None):
    """Flux vs frequency with the fitted power law (reference
    fit_flux_profile plot, pplib.py:448-506)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.errorbar(freqs, fluxes, yerr=flux_errs, fmt="k.", ms=4, lw=0.8)
    grid = np.linspace(min(freqs), max(freqs), 200)
    A = float(fit_result.amp)
    alpha = float(fit_result.alpha)
    ax.plot(grid, A * (grid / nu_ref) ** alpha, "r-", lw=1,
            label=rf"$\alpha$ = {alpha:.2f}")
    ax.set_xlabel("Frequency [MHz]")
    ax.set_ylabel("Flux")
    ax.legend()
    return _finish(fig, show, savefig)


def show_eigenprofiles(eigvec, smooth_eigvec=None, mean_prof=None,
                       smooth_mean_prof=None, show=True, savefig=None,
                       title=None, xlim=(0.0, 1.0), show_snrs=False,
                       device=None):
    """Mean profile + significant eigenprofiles, raw and smoothed
    (reference pplib.py:4126-4207; same behaviors): one shared-phase
    column — mean panel first (raw as a faint dotted line under the
    heavy smoothed curve), then one panel per eigenprofile labelled
    1-indexed; x is PHASE in rotations (bin centers), clipped to
    `xlim`; show_snrs annotates each smoothed eigenprofile with the
    Fourier-domain S/N used by the significance veto
    (find_significant_eigvec: spectral power of the smoothed vector
    over the raw vector's scaled noise).

    eigvec / smooth_eigvec: (nbin, ncomp) columns (this framework's
    PCA layout; the reference passes (ncomp, nbin) rows).  The S/N's
    noise estimate runs in float64 on ``device`` (default cuda)."""
    from ..ops.noise import get_noise_PS

    plt = _pyplot()

    eigvec = np.asarray(eigvec)
    ncomp = eigvec.shape[1] if eigvec.ndim == 2 else 0
    nrows = max(ncomp + (1 if mean_prof is not None else 0), 1)
    fig, axes = plt.subplots(nrows, 1, figsize=(7, 2.2 * nrows),
                             sharex=True, squeeze=False)
    irow = 0
    if mean_prof is not None:
        mean_prof = np.asarray(mean_prof)
        ph = (np.arange(len(mean_prof)) + 0.5) / len(mean_prof)
        ax = axes[irow, 0]
        ax.plot(ph, mean_prof, "k:", alpha=0.5)
        if smooth_mean_prof is not None:
            ax.plot(ph, np.asarray(smooth_mean_prof), "k-", lw=2)
        ax.set_ylabel("Mean profile")
        ax.yaxis.set_label_coords(-0.1, 0.5)
        irow += 1
    for icomp in range(ncomp):
        ax = axes[irow, 0]
        ph = (np.arange(eigvec.shape[0]) + 0.5) / eigvec.shape[0]
        ax.plot(ph, eigvec[:, icomp], "k:", alpha=0.5)
        if smooth_eigvec is not None:
            sm = np.asarray(smooth_eigvec)[:, icomp]
            ax.plot(ph, sm, "k-", lw=2)
            if show_snrs:
                # the significance veto's Fourier S/N: smoothed
                # spectral power (DC excluded) over the raw vector's
                # Fourier-scaled noise (reference pplib.py:4168-4174)
                noise = float(get_noise_PS(_f64(
                    eigvec[:, icomp], resolve_device(device)))) \
                    * np.sqrt(len(sm) / 2.0)
                if noise > 0.0:  # same guard as the significance veto
                    snr = np.sum(np.abs(np.fft.rfft(sm)[1:]) ** 2) \
                        / noise
                    ax.text(0.9, 0.9, f"S/N = {snr:.0f}", ha="center",
                            va="center", transform=ax.transAxes)
        ax.set_ylabel(f"Eigenprofile {icomp + 1}")
        ax.yaxis.set_label_coords(-0.1, 0.5)
        irow += 1
    for ax in axes[:, 0]:
        ax.set_xlim(xlim)
    axes[-1, 0].set_xlabel("Phase [rot]")
    if title:
        axes[0, 0].set_title(title)
    fig.tight_layout()
    return _finish(fig, show, savefig)


def show_spline_curve_projections(proj, freqs, tck=None, ncoord=None,
                                  show=True, savefig=None, title=None,
                                  weights=None, icoord=None, device=None):
    """Projections of the fitted B-spline evolution curve (reference
    pplib.py:3977-4123; same behaviors, two figures):

    - a PAIRWISE grid over every coordinate pair (upper triangle of an
      (ncoord-1) x (ncoord-1) layout, shared "Coordinate" master
      labels), and a coordinate-vs-FREQUENCY column with a shared
      frequency axis;
    - per-channel points carry the fit's structure: marker size maps
      the spline-fit weights onto [5, 15] pt, opacity ramps 0.25 -> 1
      along the channel order, a thin black line connects the data in
      order, the 10x-oversampled spline curve is drawn in green, and
      the knot locations are starred;
    - descending-frequency (negative-bandwidth) data flips the curve
      overlays so they draw in plot order;
    - icoord selects ONE coordinate-vs-frequency panel (no pair grid);
      ncoord limits how many leading coordinates are shown;
    - savefig writes <base>.proj.png and <base>.freq.png like the
      reference.

    The spline curve is evaluated in float64 on ``device`` (default
    cuda).  Returns (pair_fig_or_None, freq_fig)."""
    from ..models.spline import bspline_eval

    plt = _pyplot()
    from matplotlib.colors import to_rgba

    proj = np.asarray(proj)
    freqs = np.asarray(freqs)
    nprof, ntot = proj.shape
    if icoord is not None:
        if not 0 <= icoord < ntot:
            raise ValueError(f"0 <= icoord < {ntot}; got {icoord}")
        coords = [icoord]
    else:
        ncoord = ntot if ncoord is None else ncoord
        if not 1 <= ncoord <= ntot:
            raise ValueError(f"1 <= ncoord <= {ntot}; got {ncoord}")
        coords = list(range(ncoord))
    flip = -1 if len(freqs) > 1 and freqs[0] > freqs[-1] else 1
    if tck is not None:
        grid = np.linspace(freqs.min(), freqs.max(), nprof * 10)
        dev = resolve_device(device)
        curve = np.atleast_2d(bspline_eval(grid, tck, device=dev)
                              .cpu().numpy())
        knot_pos = np.asarray(tck[0])
        knot_vals = np.atleast_2d(bspline_eval(knot_pos, tck, device=dev)
                                  .cpu().numpy())
    # weight-mapped marker sizes on [5, 15] pt, opacity ramp along the
    # channel order (reference pplib.py:4040-4046)
    if weights is None:
        ms = np.full(nprof, 4.0)
    else:
        w = np.asarray(weights, float)
        span = w.max() - w.min()
        ms = 5.0 + 10.0 * (w - w.min()) / (span if span > 0 else 1.0)
    alphas = np.linspace(0.25, 1.0, nprof)
    colors = np.asarray([to_rgba("purple", a) for a in alphas])

    def scatter_pts(ax, x, y):
        ax.scatter(x, y, s=ms ** 2, c=colors, marker="o",
                   linewidths=0.0)

    npair_axis = len(coords) - 1
    fig_pair = None
    if icoord is None and npair_axis >= 1:
        fig_pair, paxes = plt.subplots(
            npair_axis, npair_axis, squeeze=False,
            figsize=(3 * npair_axis + 2, 3 * npair_axis + 2))
        for ix in range(npair_axis):        # x coordinate index
            for iy in range(npair_axis):    # row: y coordinate ix+...
                oy = iy + 1
                ax = paxes[iy, ix]
                if oy <= ix:                # lower triangle: unused
                    ax.axis("off")
                    continue
                scatter_pts(ax, proj[:, ix], proj[:, oy])
                ax.plot(proj[:, ix], proj[:, oy], "k-", lw=1)
                if tck is not None:
                    ax.plot(curve[:, ix], curve[:, oy], "g-", lw=2)
                    ax.plot(knot_vals[:, ix], knot_vals[:, oy], "k*",
                            ms=10)
                if oy == npair_axis:
                    ax.set_xlabel(str(ix + 1))
                else:
                    ax.tick_params(labelbottom=False)
                if ix == 0:
                    ax.set_ylabel(str(oy + 1))
                else:
                    ax.tick_params(labelleft=False)
        fig_pair.supxlabel("Coordinate")
        fig_pair.supylabel("Coordinate")
        if title:
            fig_pair.suptitle(title)

    fig_freq, faxes = plt.subplots(len(coords), 1, sharex=True,
                                   squeeze=False,
                                   figsize=(7, 3 * len(coords) + 1))
    for row, ic in enumerate(coords):
        ax = faxes[row, 0]
        scatter_pts(ax, freqs, proj[:, ic])
        ax.plot(freqs, proj[:, ic], "k-", lw=1)
        if tck is not None:
            ax.plot(grid[::flip], curve[:, ic][::flip], "g-", lw=2)
            ax.plot(knot_pos[::flip], knot_vals[:, ic][::flip], "k*",
                    ms=10)
        ax.set_ylabel(f"Coordinate {ic + 1}")
        ax.yaxis.set_label_coords(-0.1, 0.5)
    faxes[-1, 0].set_xlabel("Frequency [MHz]")
    if title:
        fig_freq.suptitle(title)

    if savefig:
        if fig_pair is not None:
            fig_pair.savefig(f"{savefig}.proj.png", format="png",
                             bbox_inches="tight", dpi=120)
            plt.close(fig_pair)
        fig_freq.savefig(f"{savefig}.freq.png", format="png",
                         bbox_inches="tight", dpi=120)
        plt.close(fig_freq)
    elif show:
        plt.show()
    return fig_pair, fig_freq
