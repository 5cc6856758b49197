"""Harmonic-domain filters and the power-spectrum noise-floor cutoff
(counterpart of pulseportraiture_tpu/ops/filters.py, a NumPy copy).

Capability parity with the reference's filter utilities
(pplib.py:1450-1561) and the 'fit' noise method (get_noise_fit,
pplib.py:2341-2373).  These are offline/host-side estimators used for
noise characterization and profile smoothing — numpy (they
run once per channel at load/model-build time, never inside the fit
loop, and find_kc's grid search is data-dependent control flow).

The reference marks wiener_filter "does not work" and fit_brickwall
"obviously wrong"; here both are implemented correctly: the Wiener
filter uses the noise-debiased signal power estimate, and the
brickwall fit picks the cutoff minimizing squared deviation from the
Wiener filter computed analytically via cumulative sums instead of an
O(N^2) python loop.
"""

import numpy as np

__all__ = [
    "wiener_filter",
    "brickwall_filter",
    "fit_brickwall",
    "half_triangle_function",
    "find_kc",
    "get_noise_fit",
]


def wiener_filter(prof, noise):
    """Wiener filter W_k = S_k / (S_k + N) for a noisy profile.

    prof: 1-D profile; noise: time-domain standard error of the profile.
    Returns the per-harmonic filter (len nbin//2+1, values in [0, 1]).

    Unlike the reference (pplib.py:1450-1464, marked "FIX does not
    work"), the signal power S_k is estimated by subtracting the
    expected white-noise power floor from the measured power, clipped
    at zero, which makes W_k -> 0 in noise-dominated harmonics.
    """
    prof = np.asarray(prof, np.float64)
    FFT = np.fft.rfft(prof)
    pows = (FFT * np.conj(FFT)).real / len(prof)
    # white noise of std sigma has E|X_k|^2 = nbin sigma^2, so in these
    # per-harmonic units the expected noise floor is exactly sigma^2
    noise_pow = float(noise) ** 2
    sig = np.clip(pows - noise_pow, 0.0, None)
    denom = np.where(pows > 0.0, pows, 1.0)
    return np.where(pows > 0.0, sig / denom, 0.0)


def brickwall_filter(N, kc):
    """Length-N filter: ones below harmonic kc, zeros above
    (reference pplib.py:1468-1476)."""
    fk = np.zeros(N)
    fk[: int(kc)] = 1.0
    return fk


def fit_brickwall(prof, noise):
    """Best-fit brickwall cutoff kc to the Wiener filter of prof.

    Minimizes sum_k (W_k - brickwall(kc)_k)^2 over kc.  Computed in
    closed form with cumulative sums: the objective at cutoff kc is
    sum_{k<kc}(W_k-1)^2 + sum_{k>=kc} W_k^2 (replaces the reference's
    O(N^2) loop at pplib.py:1479-1493, marked "obviously wrong").
    """
    wf = wiener_filter(prof, noise)
    # cost(kc) = prefix[(W-1)^2](kc) + (total[W^2] - prefix[W^2](kc))
    c1 = np.concatenate([[0.0], np.cumsum((wf - 1.0) ** 2)])
    c2 = np.concatenate([[0.0], np.cumsum(wf**2)])
    cost = c1 + (c2[-1] - c2)
    return int(np.argmin(cost))


def half_triangle_function(a, b, dc, N):
    """Half-triangle of base a, height b on a dc baseline, length N
    (reference pplib.py:1496-1506)."""
    fn = np.zeros(N) + dc
    a = int(np.floor(a))
    if a > 0:
        fn[:a] += -(np.float64(b) / a) * np.arange(a) + b
    return fn


def _kc_models(params_grid, N, fn):
    """Model curves for each (a, b, dc) row of params_grid, vectorized."""
    a = params_grid[:, 0:1]
    b = params_grid[:, 1:2]
    dc = params_grid[:, 2:3]
    x = np.arange(N)[None, :]
    if fn == "exp_dc":
        return b * np.exp(-a * x) + dc
    # half_tri: piecewise-linear descent over the first floor(a) points
    af = np.floor(a)
    ramp = np.where(x < af, -(b / np.maximum(af, 1.0)) * x + b, 0.0)
    return ramp + dc


def find_kc(pows, errs=1.0, fn="exp_dc", Ns=20):
    """Critical cutoff index where the noise floor of a power spectrum
    begins (reference pplib.py:1536-1561).

    Fits log10(pows) with a decaying exponential ('exp_dc') or
    half-triangle ('half_tri') over a brute-force parameter grid
    (vectorized over the whole grid instead of scipy.optimize.brute),
    then returns the first index where the fitted shape has decayed
    to <0.5% of its height ('exp_dc') or the fitted base ('half_tri').
    """
    pows = np.asarray(pows, np.float64)
    if not np.any(pows > 0.0):  # fully zapped channel: no spectrum
        return 0
    # an exactly-zero power (e.g. removed DC) would put -inf into the
    # log and NaN the whole chi2 grid; floor at 1e-12 of the peak
    pows = np.maximum(pows, pows.max() * 1e-12)
    data = np.log10(pows)
    N = len(data)
    lo, hi = data.min(), data.max()
    if fn == "exp_dc":
        a_r = np.linspace(N**-1.0, 1.0, Ns)
    elif fn == "half_tri":
        a_r = np.linspace(1, N, Ns)
    else:
        raise ValueError(f"unknown noise-floor fit function {fn!r}")
    b_r = np.linspace(0, hi - lo, Ns)
    dc_r = np.linspace(lo, hi, Ns)
    grid = np.stack(
        [g.ravel() for g in np.meshgrid(a_r, b_r, dc_r, indexing="ij")], axis=1
    )
    models = _kc_models(grid, N, fn)
    chi2 = np.sum(((data[None, :] - models) / errs) ** 2, axis=1)
    imin = int(np.argmin(chi2))
    a, b, dc = grid[imin]
    # significance check: a fitted decay height within the residual
    # scatter means the spectrum is flat (pure noise floor) — cutoff 0.
    # Without this, a tiny spurious b with slow decay returns N-1 and
    # the noise would be estimated from only the last few harmonics.
    resid = data - models[imin]
    if b <= 2.0 * resid.std():
        return 0
    if fn == "exp_dc":
        decayed = np.where(np.exp(-a * np.arange(N)) < 0.005)[0]
        return int(decayed.min()) if len(decayed) else N - 1
    return int(np.floor(a))


def get_noise_fit(data, fact=1.1, chans=False):
    """Off-pulse noise estimate from the mean power above a fitted
    noise-floor cutoff harmonic (reference pplib.py:2341-2373).

    data: 1- or 2-D array; fact scales the fitted cutoff; chans=True
    returns a per-channel estimate for 2-D input.
    """
    data = np.asarray(data, np.float64)
    if chans:
        # per-profile estimate over all leading axes, matching
        # get_noise_PS's batching: (..., nbin) -> (...)
        flat = data.reshape(-1, data.shape[-1])
        out = np.array([get_noise_fit(prof, fact=fact) for prof in flat])
        return out.reshape(data.shape[:-1])
    raveld = data.ravel()
    FFT = np.fft.rfft(raveld)
    pows = (FFT * np.conj(FFT)).real / len(raveld)
    k_crit = min(int(fact * find_kc(pows)), int(0.99 * len(pows)))
    return float(np.sqrt(np.mean(pows[k_crit:])))
