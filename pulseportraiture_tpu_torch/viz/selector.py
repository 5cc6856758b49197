"""Interactive Gaussian-component hand-fitting GUI (counterpart of
pulseportraiture_tpu/viz/selector.py).

The reference's GaussianSelector (ppgauss.py:382-663): a matplotlib
event-driven tool where a left-click drag sketches a new Gaussian
(position and width from the span, height from the drag), a middle
click runs the profile fit, a right click removes the last component,
and 'q' finishes.  The fit is the port's LM profile fitter, and the
model curve its Gaussian profile, in float64 on ``device`` (default
cuda).

Needs an interactive matplotlib backend to be used by hand; headless
pipelines use GaussPortrait.fit_profile(auto_gauss=...).  matplotlib is
imported when a selector is made (viz/plots.py says why).
"""

import numpy as np

from ..device import resolve_device
from ..fit.gauss import fit_gaussian_profile, gen_gaussian_profile_flat
from ..io.psrfits import noise_std_ps
from .plots import _pyplot


class GaussianSelector:
    def __init__(self, profile, errs=None, tau=0.0, fixscat=True,
                 profile_fit_flags=None, show=True, ax=None, device=None):
        plt = _pyplot()
        self.device = resolve_device(device)
        self.profile = np.asarray(profile, float)
        self.nbin = len(self.profile)
        self.phases = (np.arange(self.nbin) + 0.5) / self.nbin
        self.errs = float(errs) if errs is not None else \
            float(noise_std_ps(self.profile))
        self.tau = float(tau)
        self.fixscat = fixscat
        self.profile_fit_flags = profile_fit_flags
        self.init_params = [0.0, self.tau]  # [dc, tau] + (loc, wid, amp)*
        self.ngauss = 0
        self.fitted_params = np.asarray(self.init_params)
        self.fit_errs = np.zeros(2)
        self.chi2 = np.inf
        self.dof = self.nbin - 2

        if ax is None:
            self.fig, (self.ax, self.ax_resid) = plt.subplots(
                2, 1, sharex=True, figsize=(7, 6))
        else:
            self.fig = ax.figure
            self.ax = ax
            self.ax_resid = None
        self._press = None
        self._draw()
        self.cids = [
            self.fig.canvas.mpl_connect("button_press_event",
                                        self._on_press),
            self.fig.canvas.mpl_connect("button_release_event",
                                        self._on_release),
            self.fig.canvas.mpl_connect("key_press_event", self._on_key),
        ]
        if show:
            plt.show()

    # -- drawing -----------------------------------------------------------
    def _draw(self):
        self.ax.cla()
        self.ax.plot(self.phases, self.profile, "k-", lw=0.8)
        if self.ngauss:
            model = gen_gaussian_profile_flat(
                np.asarray(self.fitted_params, np.float64), self.nbin,
                device=self.device).cpu().numpy()
            self.ax.plot(self.phases, model, "r-", lw=1.2)
            if self.ax_resid is not None:
                self.ax_resid.cla()
                self.ax_resid.plot(self.phases, self.profile - model, "k-",
                                   lw=0.6)
                self.ax_resid.set_xlabel("Pulse Phase")
                self.ax_resid.set_ylabel("Data-Fit Residuals")
        self.ax.set_ylabel("Flux")
        self.ax.set_title(
            f"{self.ngauss} component(s) — left-drag: add, middle: fit, "
            f"right: remove last, 'q': done")
        self.fig.canvas.draw_idle()

    # -- events ------------------------------------------------------------
    def _on_press(self, event):
        if event.inaxes != self.ax:
            return
        if event.button == 1:
            self._press = (event.xdata, event.ydata)
        elif event.button == 2:
            self.do_fit()
        elif event.button == 3:
            self.remove_last()

    def _on_release(self, event):
        if self._press is None or event.inaxes != self.ax or \
                event.button != 1:
            return
        x0, y0 = self._press
        self._press = None
        self.add_component(loc=0.5 * (x0 + event.xdata),
                           wid=max(abs(event.xdata - x0), 1.0 / self.nbin),
                           amp=max(abs(y0), abs(event.ydata or y0)))

    def _on_key(self, event):
        if event.key == "q":
            plt = _pyplot()
            for cid in self.cids:
                self.fig.canvas.mpl_disconnect(cid)
            plt.close(self.fig)

    # -- actions (also usable programmatically/for tests) ------------------
    def add_component(self, loc, wid, amp):
        self.init_params = list(self.init_params) + \
            [float(loc) % 1.0, float(wid), float(amp)]
        self.ngauss += 1
        self.fitted_params = np.asarray(self.init_params)
        self._draw()

    def remove_last(self):
        if self.ngauss:
            self.init_params = list(self.init_params)[:-3]
            self.ngauss -= 1
            self.fitted_params = np.asarray(self.init_params)
            self._draw()

    def do_fit(self):
        if not self.ngauss:
            return
        fgp = fit_gaussian_profile(
            self.profile, np.asarray(self.init_params), self.errs,
            fit_flags=self.profile_fit_flags,
            fit_scattering=not self.fixscat, quiet=True,
            device=self.device)
        self.fitted_params = np.asarray(fgp.fitted_params)
        self.fit_errs = np.asarray(fgp.fit_errs)
        self.chi2 = float(fgp.chi2)
        self.dof = int(fgp.dof)
        self.init_params = list(self.fitted_params)
        self._draw()
