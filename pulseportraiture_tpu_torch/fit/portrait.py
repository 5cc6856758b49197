"""The wideband portrait fit (counterpart of pulseportraiture_tpu/fit/portrait.py).

(phi, DM[, GM, tau, alpha]) per subint in the Fourier domain with
per-channel amplitudes profiled out analytically:

    t_n(theta)  = phi + (Dconst DM / P)(nu_n^-2 - nu_fit^-2)
                      + (Dconst^2 GM / P)(nu_n^-4 - nu_fit^-4)
    B_nk        = 1 / (1 + 2 pi i k tau_n) * IR_nk,
                  tau_n = tau (nu_n / nu_fit)^alpha
    C_n         = Re sum_k d_nk conj(m_nk B_nk) e^{2 pi i k t_n} w_nk
    S_n         = sum_k |m_nk B_nk|^2 w_nk
    chi2        = sum_nk |d_nk|^2 w_nk - sum_n C_n^2 / S_n

Three engines, routed as in the JAX package:

- the complex-free fast lane (fit_portrait_batch_fast -> fast_fit_batched):
  matmul DFTs or the fused DFT -> cross-spectrum kernel (B1), the CCF
  phase seed, and a damped Newton loop over three harmonic moments;
- its scattering twin (fit_portrait_batch_fast with tau/alpha free, a
  log10 tau, a nonzero tau seed or an instrumental response ->
  fast_scatter_fit_batched): B1 in its want_m2 form (the weighted model
  power per harmonic), the tau-matched CCF seed, and the analytic
  nine-reduction evaluator _cgh_scatter, optionally Dot2-compensated;
- the complex engine (fit_portrait_batch, fit_portrait): complex
  spectra from torch.fft, the complex CCF seed, and either the three
  complex moments or _cgh_scatter on the complex cross-spectrum.

Batching: the subint batch is a leading tensor dimension (the JAX
package vmaps a per-element function).  A shared template stays 2-D.
The Newton loop keeps a per-element ``done`` mask: finished elements
keep their state while the others iterate, exactly like a vmapped
``lax.while_loop``, at the cost of one host sync per trip.

Channel sums: every chi^2 sum over channels goes through chan_sums, a
fixed tree of elementwise adds, and the packaging's 5 x 5 products are
fixed-order (_bmm, _quad), so a fit's bits do not depend on the batch
it runs in (a reduction or batched GEMM kernel on CUDA rounds by the
batch's size).  With ``chan_group`` (the sharded fits' 'chan' subgroup,
parallel/batch.py) each rank holds a block of the channels and the
ranks' partial sums are combined by one all-gather per Newton
evaluation, in the same tree.
"""

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..config import Dconst, F0_fact
from ..device import resolve_auto, resolve_device
from ..ops.fourier import (irfft_c_rows, irfft_mm, irfft_mm_invariant,
                            rfft_c_rows, rfft_mm, use_dft_fold)
from ..ops.phasor import cexp, guess_fit_freq
from ..ops.scattering import scattering_portrait_FT
from ..utils import collectives

__all__ = ["FitFlags", "FitResult", "fit_portrait_batch_fast",
           "fast_fit_batched", "prepare_portrait_fit_real",
           "fast_fit_batched_packed", "prepare_portrait_fit_real_packed",
           "fast_scatter_fit_batched", "prepare_scatter_fit_real",
           "fit_portrait_batch", "fit_portrait", "chi2_prime",
           "estimate_tau", "estimate_tau_batch", "make_weights",
           "model_harmonic_window", "resolve_harmonic_window",
           "use_fast_fit_default", "use_bf16_cross_spectrum",
           "use_scatter_compensated", "effective_x_bf16",
           "derive_use_scatter", "reject_fixed_tau_seed", "split_ir_host",
           "resolve_fit_fused", "warn_bf16_high_snr", "chan_sum",
           "chan_sums", "fast_fit_one", "fast_fit_one_packed",
           "fast_scatter_fit_one", "use_fit_fused"]

# Per-iteration step bound for (phi, DM, GM, theta3, alpha): one decade
# of log10 tau (or one rotation) and 2 units of alpha per trip keep the
# soft tau-alpha valley and the extreme-tau descent path out of reach;
# phi/DM/GM enter the phasor linearly and need no cap.
_STEP_CAP = (float("inf"), float("inf"), float("inf"), 1.0, 2.0)

# Initial Levenberg damping of SCATTERING fits (the JAX package's
# measured choice: a well-seeded trajectory needs fewer trips than
# from 1e-3; rejections still grow lam 8x per trip).
_SCATTER_LAM0 = 1e-5

# Trip budget of the compensated polish after the plain scattering loop.
_POLISH_MAX_ITER = 6


def _tiny(dtype):
    return torch.finfo(dtype).tiny


# ---------------------------------------------------------------------------
# the channel reduction: one order for every batch size and channel split

@lru_cache(maxsize=64)
def _tree_layout(n):
    """Where chan_sum's tree puts each of n channels: recursive halving
    (the first ceil(m/2) of a block of m left, the rest right, the right
    half zero-padded at its end to the left's length), so that a block
    of n / R channels, R a power of two dividing n, is one subtree.
    Returns the positions (n,) in the padded length 2^ceil(log2 n)."""
    def rec(lo, m):
        if m == 1:
            return [lo]
        h = (m + 1) // 2
        left, right = rec(lo, h), rec(lo + h, m - h)
        return left + right + [-1] * (len(left) - len(right))

    order = rec(0, n)
    pos = [0] * n
    for p, c in enumerate(order):
        if c >= 0:
            pos[c] = p
    return len(order), tuple(pos)


@lru_cache(maxsize=64)
def _tree_positions(n, device):
    return torch.tensor(_tree_layout(n)[1], dtype=torch.int64,
                        device=device)


def _tree_sum(x, dim):
    """Sum axis ``dim`` of x by a tree of elementwise adds of adjacent
    pairs over _tree_layout's zero-padded order.  Every row's bits are
    the same whatever the batch, the device's kernel choices included:
    no reduction kernel runs."""
    dim = dim % x.dim()
    n = x.shape[dim]
    if n & (n - 1):
        size, _ = _tree_layout(n)
        shape = list(x.shape)
        shape[dim] = size
        x = x.new_zeros(shape).index_copy_(
            dim, _tree_positions(n, x.device), x)
    while x.shape[dim] > 1:
        pairs = x.unflatten(dim, (-1, 2))
        x = pairs.select(dim + 1, 0) + pairs.select(dim + 1, 1)
    return x.squeeze(dim)


def chan_sums(xs, dim=-1, group=None):
    """The sums of each tensor of ``xs`` over its channel axis ``dim`` in
    one fixed order (_tree_sum).  With a process ``group`` (the mesh's
    'chan' subgroup, each rank holding a block of the channels in rank
    order) the ranks' partial sums are all-gathered in ONE collective
    and combined by the same tree in rank order, so every rank holds the
    same bits, and at a power-of-two count of ranks dividing the
    channels the bits of the whole-portrait sum."""
    parts = [_tree_sum(x, dim) for x in xs]
    if group is None:
        return parts
    real = [torch.view_as_real(p) if p.is_complex() else p for p in parts]
    flat = torch.cat([p.reshape(-1) for p in real])
    whole = _tree_sum(torch.stack(collectives.all_gather(flat, group)),
                      0)
    out, at = [], 0
    for p, r in zip(parts, real):
        v = whole[at:at + r.numel()].reshape(r.shape)
        out.append(torch.view_as_complex(v) if p.is_complex() else v)
        at += r.numel()
    return out


def chan_sum(x, dim=-1, group=None):
    """chan_sums of one tensor."""
    return chan_sums([x], dim, group)[0]


def _bmm(A, B):
    """A @ B per batch element, (B, p, q) @ (B, q, r), as q elementwise
    products added in order: a batched GEMM on CUDA rounds by the batch
    count, these do not (for the small matrices of the packaging)."""
    out = A[:, :, 0, None] * B[:, None, 0, :]
    for k in range(1, A.shape[-1]):
        out = out + A[:, :, k, None] * B[:, None, k, :]
    return out


def _quad(u, M):
    """u^T M u per batch element, u (B, p), M (B, p, p), through _bmm."""
    return _bmm(_bmm(u[:, None, :], M), u[:, :, None])[:, 0, 0]


def _gather_chans(xs, group):
    """Per-channel tensors (B, n_local), whole over ``group``'s channel
    blocks in rank order (one collective); unchanged without a group."""
    if group is None:
        return xs
    blocks = collectives.all_gather(torch.stack(xs), group)
    return tuple(torch.cat(blocks, dim=-1).unbind(0))


class FitFlags(NamedTuple):
    """Which of (phi, DM, GM, tau, alpha) are free."""

    phi: bool = True
    DM: bool = True
    GM: bool = False
    tau: bool = False
    alpha: bool = False

    def as_tensor(self, dtype, device):
        return torch.tensor([float(f) for f in self], dtype=dtype,
                            device=device)

    def as_array(self, dtype=torch.float64, device=None):
        """The JAX package's name: the flags as a (5,) 0/1 tensor
        (float64 on the CPU unless told otherwise)."""
        return self.as_tensor(dtype, "cpu" if device is None else device)


class FitResult(NamedTuple):
    """Per-fit outputs, each a tensor with the batch as leading axis.
    tau is in rotations; phi is referenced to nu_DM."""

    phi: torch.Tensor
    phi_err: torch.Tensor
    DM: torch.Tensor
    DM_err: torch.Tensor
    GM: torch.Tensor
    GM_err: torch.Tensor
    tau: torch.Tensor
    tau_err: torch.Tensor
    alpha: torch.Tensor
    alpha_err: torch.Tensor
    nu_DM: torch.Tensor
    nu_GM: torch.Tensor
    nu_tau: torch.Tensor
    scales: torch.Tensor
    scale_errs: torch.Tensor
    channel_snrs: torch.Tensor
    snr: torch.Tensor
    covariance: torch.Tensor
    chi2: torch.Tensor
    dof: torch.Tensor
    nfeval: torch.Tensor
    return_code: torch.Tensor

    @property
    def red_chi2(self):
        return self.chi2 / self.dof


def _t_coeffs(freqs, P, nu_fit):
    """t_n = phi + cvec_n * DM + gvec_n * GM; freqs (nchan,) or
    (B, nchan), P and nu_fit (B,) -> (B, nchan) each."""
    P = P[..., None]
    nu_fit = nu_fit[..., None]
    cvec = (Dconst / P) * (freqs**-2.0 - nu_fit**-2.0)
    gvec = (Dconst**2.0 / P) * (freqs**-4.0 - nu_fit**-4.0)
    return cvec, gvec


def _tau_of(theta, log10_tau):
    """The scattering timescale [rot] of theta (B, 5)."""
    return 10.0 ** theta[:, 3] if log10_tau else theta[:, 3]


def _scatter_B(theta, freqs, nu_fit, nharm, ir_FT, log10_tau):
    """Per-channel scattering (+ instrumental) kernel B (B, nchan,
    nharm), complex."""
    tau = _tau_of(theta, log10_tau)
    taus = tau[:, None] * (freqs / nu_fit[:, None]) ** theta[:, 4:5]
    B = scattering_portrait_FT(taus, nharm)
    if ir_FT is not None:
        B = B * ir_FT
    return B


def _CS_general(theta, X, M2, freqs, P, nu_fit, ir_FT, log10_tau):
    """C_n, S_n (B, nchan) with scattering / instrumental response
    active, from the complex cross-spectrum X and model power M2."""
    nharm = X.shape[-1]
    k = torch.arange(nharm, dtype=M2.dtype, device=M2.device)
    B = _scatter_B(theta, freqs, nu_fit, nharm, ir_FT, log10_tau)
    cvec, gvec = _t_coeffs(freqs, P, nu_fit)
    t_n = theta[:, 0:1] + cvec * theta[:, 1:2] + gvec * theta[:, 2:3]
    ph = cexp(2.0 * math.pi * t_n[..., None] * k)
    C = torch.sum((X * torch.conj(B) * ph).real, dim=-1)
    S = torch.sum(M2 * (B.real**2 + B.imag**2), dim=-1)
    return C, S


def chi2_prime(theta, dFT, mFT, w, freqs, P, nu_fit, ir_FT=None,
               log10_tau=False):
    """The profiled-amplitude objective chi2' (B,) of complex spectra
    dFT (B, nchan, nharm) against mFT (shared or per element); theta
    (B, 5), P and nu_fit (B,)."""
    X = dFT * torch.conj(mFT) * w
    M2 = (mFT.real**2 + mFT.imag**2) * w
    C, S = _CS_general(theta, X, M2, freqs, P, nu_fit, ir_FT, log10_tau)
    good = S > 0.0
    S_safe = torch.where(good, S, 1.0)
    return -chan_sum(torch.where(good, C**2.0 / S_safe, 0.0))


# ---------------------------------------------------------------------------
# knobs

def use_bf16_cross_spectrum():
    """Whether the fast fit stores Xr/Xi in bfloat16
    (config.cross_spectrum_dtype)."""
    return str(config.cross_spectrum_dtype) == "bfloat16"


def use_fit_fused(device=None, setting=None):
    """config.fit_fused (or ``setting``, the JAX keyword) resolved for
    ``device`` (None: cuda, the port's default device; 'auto' = CUDA)."""
    if setting is None:
        setting = config.fit_fused
    return resolve_auto("fit_fused", setting,
                        "cuda" if device is None else device)


def resolve_fit_fused(nharm_eff, device):
    """Whether the fit takes the fused lane: config.fit_fused is on for
    ``device`` and a harmonic window is active.  The plain version's
    channel tiling reads config.fused_block itself."""
    return bool(use_fit_fused(device) and nharm_eff is not None)


def use_fast_fit_default(device):
    """config.use_fast_fit resolved for ``device`` ('auto' = CUDA; like
    the JAX package, any value other than True/False means 'auto')."""
    setting = config.use_fast_fit
    if setting is True or setting is False:
        return setting
    return resolve_auto("fast_fit", "auto", device)


def use_scatter_compensated():
    """Whether scattering fits run the Dot2-compensated reductions
    (config.scatter_compensated)."""
    return bool(config.scatter_compensated)


def effective_x_bf16(compensated, x_bf16=None):
    """The bf16 cross-spectrum storage flag in effect for a scattering
    fit: compensated mode keeps X in the working dtype, so the bf16 knob
    is dead under it."""
    if x_bf16 is None:
        x_bf16 = use_bf16_cross_spectrum()
    return bool(x_bf16) and not bool(compensated)


def split_ir_host(ir_FT, dt, device):
    """A host (or tensor) instrumental-response FT, complex or real, as
    two real tensors (ir_r, ir_i) of dtype dt on device; None -> (None,
    None)."""
    if ir_FT is None:
        return None, None
    ir = np.asarray(_host(ir_FT))
    return (torch.as_tensor(np.array(ir.real), dtype=dt, device=device),
            torch.as_tensor(np.array(ir.imag), dtype=dt, device=device))


def _canonical_real_dtype(x, device):
    """float64 -> float32 where config's device_f32 knob resolves on
    (CUDA devices: the complex engine runs complex64 there); unchanged
    otherwise."""
    if x.dtype != torch.float64 or not resolve_auto("device_f32", "auto",
                                                    device):
        return x
    return x.float()


# Calibrated channel-S/N envelope of the bf16 cross-spectrum default.
BF16_CALIBRATED_CHANNEL_SNR = 3.0e3
_bf16_snr_warned = [False]


def warn_bf16_high_snr(max_channel_snr, quiet=False):
    """One-line, once-per-process warning when the bf16 cross-spectrum
    storage default is active and a fit's channel S/N exceeds the
    calibrated regime.  Returns True when the warning applies."""
    if (_bf16_snr_warned[0] or not use_bf16_cross_spectrum()
            or not math.isfinite(max_channel_snr)
            or max_channel_snr <= BF16_CALIBRATED_CHANNEL_SNR):
        return False
    if quiet:
        return True
    _bf16_snr_warned[0] = True
    print(f"Warning: channel S/N {max_channel_snr:.0f} exceeds the "
          f"bf16 cross-spectrum calibrated regime "
          f"(~{BF16_CALIBRATED_CHANNEL_SNR:.0f}); consider "
          "config.cross_spectrum_dtype = None for this data")
    return True


# ---------------------------------------------------------------------------
# harmonic window (host numpy, copied from the JAX package)

def model_harmonic_window(model, nbin, tail=None, floor_sigma=None):
    """Static harmonic count K for the band-limited fast fit, derived
    from a HOST model portrait (numpy (nchan, nbin) or (nb, nchan,
    nbin)): the smallest K such that every channel keeps all but `tail`
    of its (noise-floor-subtracted) spectral power below K, plus one
    128-harmonic guard block, rounded up to a multiple of 128.  None
    when no truncation is worthwhile.  See the JAX package's docstring
    for the noise-floor criterion."""
    if tail is None:
        tail = float(config.harmonic_window_tail)
    if floor_sigma is None:
        floor_sigma = config.harmonic_window_floor_sigma
    floor_sigma = 0.0 if floor_sigma is None else float(floor_sigma)
    nharm = nbin // 2 + 1
    m = np.asarray(model).reshape(-1, nbin)
    if m.dtype not in (np.float32, np.float64):
        m = m.astype(np.float32)
    ntail = np.maximum(nharm - np.arange(nharm), 0).astype(np.float64)
    ntail[0] = nharm - 1.0
    K = 0
    any_good = False
    for lo in range(0, m.shape[0], 256):
        spec = np.abs(np.fft.rfft(m[lo:lo + 256], axis=-1)) ** 2.0
        spec = spec.astype(np.float64)
        spec[:, 0] = 0.0
        tot = spec.sum(axis=-1)
        good = tot > 0.0
        if not np.any(good):
            continue
        any_good = True
        spec = spec[good]
        tot = tot[good]
        if floor_sigma > 0.0 and nharm >= 64:
            q = nharm // 4
            mu = np.median(spec[:, -q:], axis=-1) / np.log(2.0)
            q8 = nharm // 8
            med_hi = np.median(spec[:, -q8:], axis=-1)
            med_lo = np.median(spec[:, -2 * q8:-q8], axis=-1)
            flat = (med_lo <= 2.0 * med_hi) & (med_hi <= 2.0 * med_lo)
            mu = np.where(flat & (mu * (nharm - 1) <= 0.1 * tot), mu, 0.0)
        else:
            mu = np.zeros(spec.shape[0])
        rev_cum = spec[:, ::-1].cumsum(axis=-1)[:, ::-1]
        excess = rev_cum - mu[:, None] * ntail
        budget = floor_sigma * np.sqrt(ntail) * mu[:, None]
        tot_sig = np.maximum(tot - mu * (nharm - 1), tot * 1e-30)
        needed = (excess > tail * tot_sig[:, None]) & (excess > budget)
        any_needed = needed.any(axis=-1)
        if any_needed.any():
            last = nharm - 1 - needed[:, ::-1].argmax(axis=-1)
            K = max(K, int((last[any_needed] + 1).max()))
    if not any_good:
        return None
    K = (K + 128 + 127) // 128 * 128  # +1 guard block, tile-rounded
    if K >= nharm:
        return None
    return K


def full_spectrum_window(nbin, device):
    """The window of an unwindowed fast fit: nbin // 2 + 1 (every
    harmonic, through the fused kernels) where the full_spectrum knob
    resolves on for ``device`` (CUDA) and the fused lane is on there,
    else None (the matmul DFT).  B1 and B2 transform each row alone, so
    a subint's fit has the same bits whatever bucket it runs in; a
    cuBLAS matmul DFT rounds by its row count (ROADMAP C8).  The CPU
    keeps the matmul DFT of the JAX package.  device None: None."""
    if device is None:
        return None
    if resolve_auto("full_spectrum", "auto", device) \
            and use_fit_fused(device):
        return nbin // 2 + 1
    return None


def resolve_harmonic_window(harmonic_window, models, nbin, device=None):
    """Parse the harmonic-window knob: explicit int wins (tile-rounded);
    None -> config.fit_harmonic_window; True or 'auto' derives from the
    model ONLY when it is host-resident numpy (never a device pull).
    'full' fits every harmonic: nbin // 2 + 1 where the fused lane is on
    for ``device`` (B1 transforms each row alone, so a fit has the same
    bits however its batch and channels are split), else None, the
    unwindowed matmul DFT.  Where the knob resolves to no window (None,
    False, 'auto' finding none, an int of nbin // 2 + 1 or more) the
    result is full_spectrum_window(nbin, device): every harmonic on a
    CUDA device with the fused lane on, None elsewhere.  Unknown
    strings raise."""
    if harmonic_window is None:
        harmonic_window = config.fit_harmonic_window
    if harmonic_window is None or harmonic_window is False:
        return full_spectrum_window(nbin, device)
    if harmonic_window == "full":
        return nbin // 2 + 1 if use_fit_fused(device) else None
    if harmonic_window is True or harmonic_window == "auto":
        K = (model_harmonic_window(models, nbin)
             if isinstance(models, np.ndarray) else None)
        return K if K is not None else full_spectrum_window(nbin, device)
    if isinstance(harmonic_window, str):
        raise ValueError(
            f"fit_harmonic_window must be 'auto', 'full', True/False/None, "
            f"or a positive int; got {harmonic_window!r}")
    K = int(harmonic_window)
    if K <= 0:
        raise ValueError(
            f"fit_harmonic_window must be positive (got {K}); use "
            f"None or False to disable the window")
    K = (K + 127) // 128 * 128
    return K if K < nbin // 2 + 1 else full_spectrum_window(nbin, device)


# ---------------------------------------------------------------------------
# prepare stage

def make_weights(noise_stds, nbin, chan_mask=None, dtype=None, nharm=None):
    """w_nk = chan_mask_n / sigma_F,n^2, DC harmonic scaled by F0_fact,
    for k < nharm (default: the full nbin//2+1).  noise_stds are
    time-domain per-channel stds; sigma_F = noise_std * sqrt(nbin/2)."""
    dtype = dtype or noise_stds.dtype
    if nharm is None:
        nharm = nbin // 2 + 1
    errs_F = (noise_stds * math.sqrt(nbin / 2.0)).to(dtype)
    good = errs_F > 0.0
    inv = torch.where(good, 1.0 / torch.where(good, errs_F, 1.0) ** 2.0,
                      0.0)
    kfac = torch.ones(nharm, dtype=dtype, device=inv.device)
    kfac[0] = F0_fact
    w = inv[..., None] * kfac
    if chan_mask is not None:
        w = w * chan_mask.to(dtype)[..., None]
    return w


def _parseval_Sd(port, w_full, chan_group=None):
    """Weighted one-sided data power over ALL harmonics from the time
    domain (exact Parseval; DC per F0_fact), per batch element.
    w_full needs columns 0 (DC) and 1 (every k >= 1)."""
    nbin = port.shape[-1]
    x0 = torch.sum(port, dim=-1)
    mu = x0 / nbin
    pwr = nbin * torch.sum((port - mu[..., None]) ** 2, dim=-1)
    if nbin % 2 == 0:
        sgn = torch.tensor((-1.0) ** np.arange(nbin), dtype=w_full.dtype,
                           device=port.device)
        xn = torch.sum(port * sgn, dim=-1)
        pwr = pwr + xn**2
    return _sd_rows(pwr, x0, w_full, chan_group)


def _sd_rows(pwr, x0, w_full, chan_group=None):
    """_parseval_Sd's channel sums from the per-channel Parseval rows
    pwr and x0 (B, nchan), in one chan_sums call."""
    terms = [w_full[..., 1] * (0.5 * pwr)]
    if float(F0_fact) != 0.0:
        terms.append(w_full[..., 0] * x0**2)
    sums = chan_sums(terms, -1, chan_group)
    return sums[0] + sums[1] if len(sums) == 2 else sums[0]


def _initial_phase_guess_real(Xr, Xi, cvec, DM0, oversamp=2,
                              derotate=True, nbin=None, chan_group=None):
    """Dense-CCF phase seed: derotate by DM0, sum channels, inverse
    matmul DFT onto a 2x oversampled lag grid, first argmax."""
    nharm = Xr.shape[-1]
    if nbin is None:
        nbin = 2 * (nharm - 1)
    dt = cvec.dtype
    if derotate:
        k = torch.arange(nharm, dtype=dt, device=cvec.device)
        ang = 2.0 * math.pi * (cvec * DM0[..., None])[..., None] * k
        c = torch.cos(ang)
        s = torch.sin(ang)
        xr, xi = chan_sums([Xr * c - Xi * s, Xr * s + Xi * c], -2,
                           chan_group)
    else:
        xr, xi = chan_sums([Xr, Xi], -2, chan_group)
    nlag = nbin * oversamp
    # one GEMM shape on CUDA, whatever the batch: the argmax must not
    # move with the bucket at a near-tie (ROADMAP C8)
    inv = xr.device.type == "cuda"
    ccf = (irfft_mm_invariant if inv else irfft_mm)(xr, xi, n=nlag)
    j0 = torch.argmax(ccf, dim=-1)
    phi0 = j0.to(dt) / nlag
    return torch.remainder(phi0 + 0.5, 1.0) - 0.5


def prepare_portrait_fit_real(port, model, w, freqs, P, nu_fit, theta0,
                              seed_phi=True, seed_derotate=True,
                              x_dtype=None, nharm_eff=None, dft_fold=None,
                              fit_fused=None, chan_group=None):
    """Everything before the Newton loop, batched, in real arithmetic:
    the windowed DFT -> cross-spectrum (fused kernel or two rfft_mm
    matmuls), model/data powers, and the CCF phase seed.

    port (B, nchan, nbin); model (nchan, nbin) shared or (B, nchan,
    nbin); w (B, nchan, nharm_w) with nharm_w >= nharm_eff (only
    columns < nharm_eff and the two Parseval columns are read when the
    window is active).  chan_group: the mesh's 'chan' subgroup when the
    channels are split over ranks (Sd and the seed's channel sums are
    then combined over it).  Returns (Xr, Xi, S0, Sd, theta0_seeded)."""
    dt = w.dtype
    if fit_fused is None:
        fit_fused = resolve_fit_fused(nharm_eff, port.device)
    cvec, _ = _t_coeffs(freqs, P, nu_fit)
    cvec = cvec.to(dt)
    if fit_fused and nharm_eff is not None:
        from ..ops.fused import fused_cross_spectrum

        Xr, Xi, S0 = fused_cross_spectrum(
            port, model, w[..., :nharm_eff].contiguous(), nharm_eff,
            fold=dft_fold)
        Sd = _parseval_Sd(port, w, chan_group)
    else:
        dr, di = rfft_mm(port, nharm=nharm_eff, fold=dft_fold)
        mr, mi = rfft_mm(model, nharm=nharm_eff, fold=dft_fold)
        w_full = w
        if nharm_eff is not None:
            w = w[..., :nharm_eff]
        Xr = (dr * mr + di * mi) * w
        Xi = (di * mr - dr * mi) * w
        S0 = torch.sum((mr**2 + mi**2) * w, dim=-1)
        if nharm_eff is None:
            Sd = chan_sum(torch.sum((dr**2 + di**2) * w, dim=-1), -1,
                          chan_group)
        else:
            Sd = _parseval_Sd(port, w_full, chan_group)
    theta0 = theta0.to(dt)
    if seed_phi:
        phi0 = _initial_phase_guess_real(Xr, Xi, cvec, theta0[:, 1],
                                         derotate=seed_derotate,
                                         nbin=port.shape[-1],
                                         chan_group=chan_group)
        theta0 = theta0.clone()
        theta0[:, 0] = phi0
    xdt = x_dtype or dt
    return Xr.to(xdt), Xi.to(xdt), S0, Sd, theta0


def prepare_portrait_fit_real_packed(raw, scl, offs, model, w, freqs, P,
                                     nu_fit, theta0, *, raw_code, nbin,
                                     nharm_eff, seed_phi=True,
                                     seed_derotate=True, x_dtype=None,
                                     dft_fold=None, fused_block=None):
    """prepare_portrait_fit_real for sub-byte PACKED raw rows: the
    decode (bit-plane unpack, affine decode, min-window baseline) and
    the windowed DFT -> cross-spectrum run in one fused stage
    (ops.fused.fused_decode_cross_spectrum, kernel B2 on a CUDA device),
    so the decoded portrait is never materialized for the fit.

    raw (B, nchan, bpc) uint8; scl/offs (B, nchan); model (nchan, nbin)
    shared; w (B, nchan, nharm_w) with nharm_w >= nharm_eff (columns 0
    and 1 carry the Parseval weights).  The full-spectrum Sd comes from
    the stage's per-channel Parseval rows with _parseval_Sd's outer
    reductions.  Windowed lanes only: nharm_eff must be set (on CUDA
    the unwindowed lane sets it to nbin // 2 + 1, full_spectrum_window).
    fused_block: the plain version's channel tile (ops.fused._block_size;
    None -> config.fused_block); the kernel ignores it."""
    from ..ops.fused import fused_decode_cross_spectrum

    dt = w.dtype
    cvec, _ = _t_coeffs(freqs, P, nu_fit)
    cvec = cvec.to(dt)
    Xr, Xi, S0, pwr, x0 = fused_decode_cross_spectrum(
        raw, scl, offs, model, w[..., :nharm_eff].contiguous(), nharm_eff,
        code=raw_code, nbin=nbin, fold=dft_fold, block=fused_block)
    Sd = _sd_rows(pwr, x0, w)
    theta0 = theta0.to(dt)
    if seed_phi:
        phi0 = _initial_phase_guess_real(Xr, Xi, cvec, theta0[:, 1],
                                         derotate=seed_derotate, nbin=nbin)
        theta0 = theta0.clone()
        theta0[:, 0] = phi0
    xdt = x_dtype or dt
    return Xr.to(xdt), Xi.to(xdt), S0, Sd, theta0


# ---------------------------------------------------------------------------
# Newton loop

def _moments_real(t_n, Xr, Xi):
    """Harmonic moments (C, C1, C2), each (B, nchan), of the split
    cross-spectrum under rotation t_n (B, nchan)."""
    nharm = Xr.shape[-1]
    dt = t_n.dtype
    k2pi = 2.0 * math.pi * torch.arange(nharm, dtype=dt, device=t_n.device)
    ang = t_n[..., None] * k2pi
    c = torch.cos(ang)
    s = torch.sin(ang)
    wr = Xr * c - Xi * s
    wi = Xr * s + Xi * c
    return (torch.sum(wr, dim=-1),
            -torch.sum(wi * k2pi, dim=-1),
            -torch.sum(wr * k2pi**2, dim=-1))


def _outer(a, b):
    """Per-channel outer products (B, p, q, n) of a (B, p, n) and b (B,
    q, n)."""
    return a[:, :, None, :] * b[:, None, :, :]


def _cgh_tail(C, C1, C2, S0inv, cvec, gvec, chan_group=None):
    """(f (B,), grad (B, 5), hess (B, 5, 5)) from the harmonic moments:
    the per-channel terms summed by one chan_sums call."""
    base1 = 2.0 * C * C1 * S0inv
    base2 = 2.0 * (C1**2.0 + C * C2) * S0inv
    J = torch.stack([torch.ones_like(cvec), cvec, gvec], dim=-2)
    f, g3, H3 = chan_sums([-(C**2.0 * S0inv), -(J * base1[:, None]),
                           -(_outer(J, J) * base2[:, None, None])], -1,
                          chan_group)
    B = C.shape[0]
    g5 = C.new_zeros((B, 5))
    g5[:, :3] = g3
    H5 = C.new_zeros((B, 5, 5))
    H5[:, :3, :3] = H3
    return f, g5, H5


def _moments_complex(t_n, X):
    """Harmonic moments (C, C1, C2), each (B, nchan), of the complex
    cross-spectrum X under rotation t_n (B, nchan): the JAX package's
    _moments_xla."""
    nharm = X.shape[-1]
    dt = t_n.dtype
    k2pi = 2.0 * math.pi * torch.arange(nharm, dtype=dt, device=t_n.device)
    W = X * cexp(t_n[..., None] * k2pi)
    return (torch.sum(W, dim=-1).real,
            -torch.sum(W * k2pi, dim=-1).imag,
            -torch.sum(W * k2pi**2, dim=-1).real)


def _cgh_fast(theta, X, S0inv, cvec, gvec, chan_group=None):
    """(f, grad, hess) of chi2' in one pass over the complex X: the
    complex engine's no-scattering evaluator."""
    t_n = theta[:, 0:1] + cvec * theta[:, 1:2] + gvec * theta[:, 2:3]
    C, C1, C2 = _moments_complex(t_n, X)
    return _cgh_tail(C, C1, C2, S0inv, cvec, gvec, chan_group)


# ---------------------------------------------------------------------------
# Dot2: compensated k-reductions for float32 scattering fits.  Eager
# PyTorch runs each operation as its own kernel, so nothing fuses or
# re-associates the error-free transforms (they must never be compiled).

def _two_sum(ah, al, bh, bl):
    """Double-word (hi, lo) addition: Knuth TwoSum on the hi words, the
    lows accumulated."""
    s = ah + bh
    bb = s - ah
    err = (ah - (s - bb)) + (bh - bb)
    return s, al + bl + err


def _pair_sum_df64(x, lo=None):
    """Sum the last axis through a double-word reduction tree that
    combines contiguous halves with TwoSum, carrying the rounding
    residue in a lo word; odd lengths are zero-padded by one."""
    hi = x
    lo = torch.zeros_like(x) if lo is None else lo
    while hi.shape[-1] > 1:
        if hi.shape[-1] % 2:
            hi = torch.nn.functional.pad(hi, (0, 1))
            lo = torch.nn.functional.pad(lo, (0, 1))
        half = hi.shape[-1] // 2
        hi, lo = _two_sum(hi[..., :half], lo[..., :half],
                          hi[..., half:], lo[..., half:])
    return hi[..., 0] + lo[..., 0]


def _two_product(a, b):
    """Exact product splitting: (p, e) with p = fl(a b) and p + e = a b
    exactly (Dekker's TwoProduct through the Veltkamp split, constant
    2^12 + 1 in float32 and 2^27 + 1 in float64)."""
    dt = torch.result_type(a, b)
    c = 134217729.0 if dt == torch.float64 else 4097.0
    p = a * b
    ac = a * c
    ah = ac - (ac - a)
    al = a - ah
    bc = b * c
    bh = bc - (bc - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _dot2(a, b):
    """sum_k a_k b_k with the product errors captured (_two_product) and
    the sum taken double-word pairwise (_pair_sum_df64): Dot2."""
    p, e = _two_product(a, b)
    return _pair_sum_df64(p, e)


def _cgh_scatter(theta, Xr, Xi, M2, freqs, nu_fit, cvec, gvec, log10_tau,
                 compensated=False, chan_group=None):
    """(f (B,), grad (B, 5), hess (B, 5, 5), (C, S)) of chi2' with the
    scattering kernel active, in one pass over the split cross-spectrum.

    theta (B, 5); Xr/Xi (B, nchan, nharm) in the working dtype or
    bfloat16 (every product with the float32 kernel terms promotes to
    float32); M2 (B, nchan, nharm) the weighted model power; freqs
    (nchan,) or (B, nchan); nu_fit (B,); cvec/gvec (B, nchan).  Any
    instrumental response is already folded into X and M2.

    Chain (the JAX package's, re-derived there from the reference):
      t_n   = phi + c_n DM + g_n GM
      tau_n = T(theta3) (nu_n/nu_fit)^alpha
      B_k   = 1/(1 + 2 pi i tau_n k), dB/dtau = -2 pi i k B^2
      C_n   = sum_k Re[X conj(B) e^{2 pi i t k}], S_n = sum_k M2 |B|^2
    Nine k-reductions per channel give the exact 5x5 curvature;
    compensated=True takes each through Dot2.  The channel sums of f,
    g and H (31 numbers per fit) are one chan_sums call: one collective
    over chan_group when the channels are split over ranks."""
    dt = M2.dtype
    nharm = Xr.shape[-1]
    k = torch.arange(nharm, dtype=dt, device=M2.device)
    twopi = 2.0 * math.pi

    # kernel path
    r = (freqs / nu_fit[:, None]).to(dt)
    logr = torch.log(r)
    if log10_tau:
        T = 10.0 ** theta[:, 3:4]
        tau_n = T * r ** theta[:, 4:5]
        ln10 = math.log(10.0)
        s1 = ln10 * tau_n
        s11 = ln10 ** 2.0 * tau_n
        s12 = ln10 * tau_n * logr
    else:
        T = theta[:, 3:4]
        ra = r ** theta[:, 4:5]
        tau_n = T * ra
        s1 = ra
        s11 = torch.zeros_like(ra)
        s12 = ra * logr
    s2 = tau_n * logr
    s22 = tau_n * logr ** 2.0

    # phasor path
    t_n = theta[:, 0:1] + cvec * theta[:, 1:2] + gvec * theta[:, 2:3]

    bk = (twopi * tau_n)[..., None] * k
    q = 1.0 / (1.0 + bk * bk)  # |B|^2; conj(B) = (1 + i bk) q
    cBi = bk.mul_(q)
    del bk
    ang = twopi * t_n[..., None] * k
    c = torch.cos(ang)
    s = ang.sin_()
    er = Xr * c - Xi * s  # Re[X e]
    ei = Xr * s + Xi * c  # Im[X e]
    del ang, c, s
    # U = X conj(B) e
    Ur = er * q - ei * cBi
    Ui = er * cBi + ei * q
    del er, ei
    # U conj(B), and the real part of U conj(B)^2
    UBr = Ur * q - Ui * cBi
    UBi = Ur * cBi + Ui * q
    UB2r = UBr * q - UBi * cBi
    del cBi

    k2 = k * k
    if compensated:
        red1 = _pair_sum_df64
        red = _dot2
    else:
        def red1(x):
            return torch.sum(x, dim=-1)

        def red(a, b):
            return torch.sum(a * b, dim=-1)
    C = red1(Ur)
    C_t = -twopi * red(k, Ui)
    C_tt = -(twopi ** 2.0) * red(k2, Ur)
    del Ur, Ui
    C_tau = -twopi * red(k, UBi)
    C_taut = -(twopi ** 2.0) * red(k2, UBr)
    C_tautau = -2.0 * twopi ** 2.0 * red(k2, UB2r)
    del UBr, UBi, UB2r

    M2q = M2 * q
    S = red1(M2q)
    Sk2q2 = red(M2q * q, k2)
    Sk4q3 = red(M2q, (q * k2) ** 2.0)
    del M2q, q
    S_tau = -2.0 * twopi ** 2.0 * tau_n * Sk2q2
    S_tautau = (-2.0 * twopi ** 2.0 * Sk2q2
                + 8.0 * twopi ** 4.0 * tau_n ** 2.0 * Sk4q3)

    # chain to (phi, DM, GM, theta3, alpha)
    ones = torch.ones_like(cvec)
    zeros = torch.zeros_like(cvec)
    Jt = torch.stack([ones, cvec, gvec, zeros, zeros], dim=-2)   # (B,5,n)
    Jtau = torch.stack([zeros, zeros, zeros, s1, s2], dim=-2)
    Cp = Jt * C_t[:, None, :] + Jtau * C_tau[:, None, :]
    Sp = Jtau * S_tau[:, None, :]

    good = S > 0.0
    Sinv = torch.where(good, 1.0 / torch.where(good, S, 1.0), 0.0)
    CS = C * Sinv

    # per-channel terms of f, g and H
    w_sp = CS ** 2.0
    f_n = -(C * CS)
    g_n = -2.0 * Cp * CS[:, None] + Sp * w_sp[:, None]

    def wo(a, b, w):
        return _outer(a, b) * w[:, None, None]

    # sum_pq [w_tt Jt Jt + w_taut (Jt Jtau + Jtau Jt) + w_tautau Jtau Jtau]
    # with w_x = -2 C C_x / S
    H_n = (wo(Jt, Jt, -2.0 * (C * C_tt) * Sinv)
           + wo(Jt, Jtau, -2.0 * (C * C_taut) * Sinv)
           + wo(Jtau, Jt, -2.0 * (C * C_taut) * Sinv)
           + wo(Jtau, Jtau, -2.0 * (C * C_tautau) * Sinv))
    # -2 C_p C_q / S
    H_n = H_n - wo(Cp, Cp, 2.0 * Sinv)
    # + 2 C (C_p S_q + C_q S_p) / S^2
    CpSq = wo(Cp, Sp, 2.0 * CS * Sinv)
    H_n = H_n + CpSq + CpSq.transpose(1, 2)
    # + C^2 S_pq / S^2 - 2 C^2 S_p S_q / S^3
    H_n = H_n + wo(Jtau, Jtau, w_sp * S_tautau)
    H_n = H_n - wo(Sp, Sp, 2.0 * w_sp * Sinv)
    # second derivatives of the tau(theta3, alpha) chain itself
    chain_C = -2.0 * CS * C_tau + w_sp * S_tau
    H_n[:, 3, 3] += chain_C * s11
    H_n[:, 3, 4] += chain_C * s12
    H_n[:, 4, 3] += chain_C * s12
    H_n[:, 4, 4] += chain_C * s22
    f, g, H = chan_sums([f_n, g_n, H_n], -1, chan_group)
    return f, g, H, (C, S)


def _scatter_ftol(dt, compensated=False):
    """Convergence threshold of SCATTERING fits: float32 runs to 1e-9
    (1e-10 with the compensated reductions), far tighter than the
    generic 50 eps (|f| + 1), which stops a float32 tau fit ~0.3 % short
    of its minimum; float64 keeps 50 eps."""
    if dt == torch.float32:
        return 1e-10 if compensated else 1e-9
    return 50.0 * float(torch.finfo(dt).eps)


def _aux_map(fn, aux):
    """fn over an aux: a tensor or a (possibly empty) tuple of tensors."""
    if isinstance(aux, tuple):
        return tuple(_aux_map(fn, a) for a in aux)
    return fn(aux)


def _aux_where(mask, new, old):
    """Per-element torch.where over an aux, the (B,) mask broadcast
    along each tensor's trailing axes."""
    if isinstance(new, tuple):
        return tuple(_aux_where(mask, n, o) for n, o in zip(new, old))
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _newton_loop(cgh, theta0, flags_arr, max_iter, ftol, lam0=1.0e-3,
                 stall_max=4, bounds=None):
    """Levenberg-damped Newton minimization over a batch, given a fused
    (f, grad, hess, aux) evaluator — one cgh() call per trip.  aux is a
    tensor or a tuple of tensors with the batch as leading axis (the
    per-channel moments the packaging needs); the state carries the aux
    that matches theta.

    Semantics are the JAX package's _newton_loop under vmap: damping
    H + lam diag|H|, convergence when 0.5 g^T diag(H)^-1 g < ftol
    (|f| + 1), flat-rejection stall exit after stall_max trips, a
    bootstrap trip that evaluates theta0 inside the loop, projected box
    bounds with TNC-vocabulary return codes, and NaN poisoning when no
    trip was ever accepted.  Return codes: 0 converged, 1 converged in
    the interior with bounds active, 2 stall, 3 max-iterations.

    Batching: an element is active while it < max_iter + 1 and not
    done; every trip evaluates all elements and commits the new state
    only to the active ones, so each element's state, nfev and code are
    what the vmapped while_loop gives.  The loop ends when no element is
    active: one host sync (``active.any()``) per trip.  Singular damped
    Hessians go through solve_ex, which like jnp.linalg.solve returns
    non-finite values instead of raising."""
    B = theta0.shape[0]
    dt = theta0.dtype
    dev = theta0.device
    flags = flags_arr
    nfix = 1.0 - flags
    fmask = torch.outer(flags, flags)
    dfix = torch.diag(nfix)
    eps = torch.finfo(dt).eps
    tiny = _tiny(dt)
    if bounds is not None:
        blo = bounds[..., 0]
        bhi = bounds[..., 1]
        theta0 = torch.where(flags > 0.0,
                             torch.clamp(theta0, blo, bhi), theta0)
    cap = torch.tensor(_STEP_CAP, dtype=dt, device=dev)

    def mask_gH(g, H):
        return g * flags, H * fmask + dfix

    def project_active(theta, g, H):
        if bounds is None:
            return g, H
        out = ((torch.isfinite(blo) & (theta <= blo) & (g > 0.0))
               | (torch.isfinite(bhi) & (theta >= bhi) & (g < 0.0)))
        free = 1.0 - out.to(dt)
        return (g * free, H * (free[:, :, None] * free[:, None, :])
                + torch.diag_embed(1.0 - free))

    def _pred(g, H):
        dH = torch.abs(torch.diagonal(H, dim1=-2, dim2=-1))
        dH = torch.maximum(dH, 1e-12 * torch.amax(dH, dim=-1,
                                                   keepdim=True))
        return (0.5 * torch.sum(g**2.0 / torch.clamp(dH, min=tiny),
                                dim=-1), dH)

    theta = theta0
    f = torch.full((B,), math.inf, dtype=dt, device=dev)
    g = torch.zeros((B, 5), dtype=dt, device=dev)
    H = torch.eye(5, dtype=dt, device=dev).expand(B, 5, 5).clone()
    aux = None
    lam = torch.full((B,), lam0 / 0.33, dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    nfev = torch.zeros(B, dtype=torch.int32, device=dev)
    rej = torch.zeros(B, dtype=torch.int32, device=dev)
    code = torch.full((B,), 3, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    while True:
        active = (it < max_iter + 1) & ~done
        if not bool(active.any()):
            break
        gm0, Hm0 = mask_gH(g, H)
        gm0, Hm0 = project_active(theta, gm0, Hm0)
        pred_cur, dH = _pred(gm0, Hm0)
        fin = torch.isfinite(f)
        conv_now = (pred_cur < ftol * (torch.abs(f) + 1.0)) & fin
        A = Hm0 + lam[:, None, None] * torch.diag_embed(dH)
        step = -torch.linalg.solve_ex(A, gm0)[0]
        step = torch.clamp(step, -cap, cap)
        theta_new = theta + step * flags
        if bounds is not None:
            theta_new = torch.where(flags > 0.0,
                                    torch.clamp(theta_new, blo, bhi),
                                    theta_new)
        f_new, g_new, H_new, aux_new = cgh(theta_new)
        if aux is None:  # bootstrap placeholder, never committed
            aux = _aux_map(torch.zeros_like, aux_new)
        accept_f = (f_new < f) & ~conv_now
        gm, Hm = mask_gH(g_new, H_new)
        gm, _ = project_active(theta_new, gm, Hm)
        pred_new, _ = _pred(gm, Hm0)
        f_flat = f_new <= f + 64.0 * eps * (torch.abs(f) + 1.0)
        accept_g = (f_flat & ~accept_f & (pred_new < 0.25 * pred_cur)
                    & fin & ~conv_now)
        accept = accept_f | accept_g
        done_conv = conv_now | (accept & fin & (
            pred_new < ftol * (torch.abs(f_new) + 1.0)))
        flat = ~accept & f_flat
        rej_new = torch.where(flat, rej + 1, torch.zeros_like(rej))
        done_stall = (rej_new >= stall_max) & ~done_conv
        code_new = torch.where(done_conv, torch.zeros_like(code),
                               torch.where(done_stall,
                                           torch.full_like(code, 2), code))
        lam_new = torch.where(accept_f, lam * 0.33,
                              torch.where(accept_g, lam, lam * 8.0)
                              ).clamp(1e-14, 1e14)
        acc = accept & active
        theta = torch.where(acc[:, None], theta_new, theta)
        f = torch.where(acc, f_new, f)
        g = torch.where(acc[:, None], g_new, g)
        H = torch.where(acc[:, None, None], H_new, H)
        aux = _aux_where(acc, aux_new, aux)
        lam = torch.where(active, lam_new, lam)
        it = it + active.to(it.dtype)
        nfev = nfev + active.to(nfev.dtype)
        rej = torch.where(active, rej_new, rej)
        code = torch.where(active, code_new, code)
        done = torch.where(active, done_conv | done_stall, done)

    if bounds is not None:
        at_b = torch.any(
            (flags > 0.0)
            & ((torch.isfinite(blo) & (theta <= blo))
               | (torch.isfinite(bhi) & (theta >= bhi))), dim=-1)
        code = torch.where(code == 0,
                           torch.where(at_b, torch.zeros_like(code),
                                       torch.ones_like(code)), code)
    bad = ~torch.isfinite(f)
    H = torch.where(bad[:, None, None], math.nan, H)
    aux = _aux_where(bad, _aux_map(lambda a: torch.full_like(a, math.nan),
                                   aux), aux)
    return theta, f, H, aux, nfev, code


def _hybrid_scatter_loop(cgh_plain, cgh_comp, theta0, flags_arr, max_iter,
                         ftol_comp, dt, lam0=_SCATTER_LAM0, bounds=None):
    """Two-stage scattering Newton: the plain loop to its own convergence
    floor, then a short compensated polish (_POLISH_MAX_ITER trips, a
    fresh bootstrap trip: plain and compensated objectives differ by
    more than ftol |f| near the floor).  nfev is the sum of both stages.
    The code is the polish's, except that a polish that ran out of trips
    (3) after a plain stage that ended normally reports the plain
    stage's code."""
    th1, _, _, _, nfev1, code1 = _newton_loop(
        cgh_plain, theta0, flags_arr, max_iter, _scatter_ftol(dt, False),
        lam0=lam0, bounds=bounds)
    theta, f, H, aux, nfev2, code2 = _newton_loop(
        cgh_comp, th1, flags_arr, _POLISH_MAX_ITER, ftol_comp, lam0=lam0,
        bounds=bounds)
    code = torch.where((code2 == 3) & (code1 != 3), code1, code2)
    return theta, f, H, aux, nfev1 + nfev2, code


def _finalize_fit(theta, f, H, C, S, Sd, nharm, flags_arr, fit_flags, P,
                  nu_fit, nu_out, nfev, code, log10_tau=False,
                  out_dtype=None, chan_group=None):
    """Covariance, zero-covariance frequencies, re-referencing, scales,
    S/N and chi2 packaging, shared by every engine; theta[:, 3] is
    log10 tau when log10_tau.  Every input carries the batch as its
    leading axis.  out_dtype: the dtype the result is cast to when it
    differs from theta's (its tiny floors the divisions, so a masked
    channel's scale error stays finite there).  chan_group: C and S are
    the rank's channel block, gathered whole over it first, so every
    rank packages the whole portrait's per-channel outputs."""
    C, S = _gather_chans((C, S), chan_group)
    dt = theta.dtype
    dev = theta.device
    tiny = _tiny(out_dtype or dt)
    B = theta.shape[0]
    fo = torch.outer(flags_arr, flags_arr)
    Hm = H * fo + torch.diag(1.0 - flags_arr)
    cov = 2.0 * torch.linalg.inv_ex(Hm)[0] * fo

    cD_fit = (Dconst / P) * nu_fit**-2.0
    cG_fit = (Dconst**2.0 / P) * nu_fit**-4.0
    J = torch.eye(5, dtype=dt, device=dev).expand(B, 5, 5).clone()
    J[:, 0, 1] = -cD_fit
    J[:, 0, 2] = -cG_fit
    covI = _bmm(_bmm(J, cov), J.transpose(-1, -2))

    vD, vG, vDG = covI[:, 1, 1], covI[:, 2, 2], covI[:, 1, 2]
    cpD, cpG = covI[:, 0, 1], covI[:, 0, 2]
    if fit_flags[1] and fit_flags[2]:
        det = vD * vG - vDG**2.0
        det_safe = torch.where(torch.abs(det) > tiny, det, 1.0)
        cD0 = (-cpD * vG + cpG * vDG) / det_safe
        cG0 = (-cpG * vD + cpD * vDG) / det_safe
    else:
        cD0 = -cpD / torch.clamp(vD, min=tiny)
        cG0 = -cpG / torch.clamp(vG, min=tiny)
    nu_zero_DM = torch.where(
        cD0 > 0.0,
        (Dconst / (P * torch.where(cD0 > 0, cD0, 1.0))) ** 0.5, nu_fit)
    nu_zero_GM = torch.where(
        cG0 > 0.0,
        (Dconst**2.0 / (P * torch.where(cG0 > 0, cG0, 1.0))) ** 0.25,
        nu_fit)
    if not fit_flags[1]:
        nu_zero_DM = nu_fit
    if not fit_flags[2]:
        nu_zero_GM = nu_fit

    # tau/alpha zero-covariance frequency: Cov(log tau_ref, alpha) = 0
    # (only when both are fitted)
    vA = covI[:, 4, 4]
    cTA = covI[:, 3, 4]
    tau_fit = _tau_of(theta, log10_tau)
    if log10_tau:
        dlog = -cTA / torch.clamp(vA, min=tiny)
    else:
        dlog = -cTA / torch.clamp(tau_fit * vA * math.log(10.0), min=tiny)
    if not (fit_flags[3] and fit_flags[4]):
        dlog = torch.zeros_like(dlog)
    dlog = torch.clamp(dlog, -1.0, 1.0)
    nu_zero_tau = nu_fit * 10.0**dlog

    nu_DM_out = torch.where(nu_out > 0.0, nu_out, nu_zero_DM)
    nu_GM_out = torch.where(nu_out > 0.0, nu_out, nu_zero_GM)
    nu_tau_out = torch.where(nu_out > 0.0, nu_out, nu_zero_tau)

    cD_out = (Dconst / P) * nu_DM_out**-2.0
    cG_out = (Dconst**2.0 / P) * nu_GM_out**-4.0
    phi_inf = theta[:, 0] - cD_fit * theta[:, 1] - cG_fit * theta[:, 2]
    phi_out = phi_inf + cD_out * theta[:, 1] + cG_out * theta[:, 2]
    phi_out = torch.remainder(phi_out + 0.5, 1.0) - 0.5
    zero = torch.zeros_like(cD_out)
    u = torch.stack([torch.ones_like(cD_out), cD_out, cG_out, zero, zero],
                    dim=-1)
    phi_var = _quad(u, covI)
    phi_var = torch.where(torch.isfinite(phi_var), phi_var, math.inf)
    if fit_flags[0]:
        phi_err = torch.sqrt(torch.clamp(phi_var, min=0.0))
    else:
        phi_err = torch.zeros_like(phi_var)

    r_tau = (nu_tau_out / nu_fit) ** theta[:, 4]
    tau_out = tau_fit * r_tau
    if log10_tau:
        ut = torch.stack([zero, zero, zero, torch.ones_like(zero),
                          torch.log10(nu_tau_out / nu_fit)], dim=-1)
        taup_var = _quad(ut, covI)
        tau_err = (torch.sqrt(torch.clamp(taup_var, min=0.0)) * tau_out
                   * math.log(10.0))
    else:
        ut = torch.stack([zero, zero, zero, r_tau,
                          tau_out * torch.log(nu_tau_out / nu_fit)], dim=-1)
        tau_err = torch.sqrt(torch.clamp(_quad(ut, covI), min=0.0))

    DM_err = torch.sqrt(torch.clamp(cov[:, 1, 1], min=0.0))
    GM_err = torch.sqrt(torch.clamp(cov[:, 2, 2], min=0.0))
    alpha_err = torch.sqrt(torch.clamp(cov[:, 4, 4], min=0.0))

    S_safe = torch.clamp(S, min=tiny)
    scales = C / S_safe
    scale_errs = S_safe**-0.5
    mask = (S > 0.0).to(dt)
    channel_snrs = C / torch.sqrt(S_safe) * mask
    snr2, nmask = chan_sums([channel_snrs**2.0, mask])
    snr = torch.sqrt(torch.clamp(snr2, min=0.0))
    chi2 = Sd + f
    nbin = 2 * (nharm - 1)
    nfit = torch.sum(flags_arr)
    dof = nmask * (nbin - 1.0) - nfit - nmask

    return FitResult(
        phi=phi_out, phi_err=phi_err, DM=theta[:, 1], DM_err=DM_err,
        GM=theta[:, 2], GM_err=GM_err, tau=tau_out, tau_err=tau_err,
        alpha=theta[:, 4], alpha_err=alpha_err, nu_DM=nu_DM_out,
        nu_GM=nu_GM_out, nu_tau=nu_tau_out, scales=scales,
        scale_errs=scale_errs, channel_snrs=channel_snrs, snr=snr,
        covariance=cov, chi2=chi2, dof=dof, nfeval=nfev, return_code=code)


def _newton_dtype(fit_flags, dt):
    """The dtype the Newton loop and _finalize_fit run in: float64 when
    GM is fitted.  The (phi, DM, GM) normal equations are so
    ill-conditioned that a float32 Hessian moves the TOA errors by
    percents; the moments are then summed in float64 from the stored
    (float32 or bfloat16) cross-spectrum, a 3x3 system per subint."""
    return torch.float64 if fit_flags[2] else dt


def _result_dtype(r, dt):
    """A FitResult with its floating fields cast to dt."""
    return FitResult(*[v.to(dt) if v.is_floating_point() else v
                       for v in r])


def _fit_portrait_core_real(Xr, Xi, S0, Sd, freqs, P, nu_fit, nu_out,
                            theta0, fit_flags=FitFlags(), max_iter=40,
                            ftol=None, nharm_total=None, bounds=None,
                            chan_group=None):
    """Stage 2 of the split fit, batched: the (phi, DM, GM) Newton loop
    over the three harmonic moments and the result packaging.
    nharm_total: the full spectrum's harmonic count when Xr/Xi are
    band-limited (dof counts every data harmonic).  chan_group: the
    'chan' subgroup when Xr/Xi/S0/freqs hold the rank's channel block
    (one collective per Newton evaluation)."""
    if fit_flags[3] or fit_flags[4]:
        raise ValueError("the real core handles the no-scattering path "
                         "only")
    dt = S0.dtype
    wdt = _newton_dtype(fit_flags, dt)
    nharm = nharm_total if nharm_total is not None else Xr.shape[-1]
    flags_arr = FitFlags(*fit_flags).as_tensor(wdt, S0.device)
    if ftol is None:
        ftol = 50.0 * float(torch.finfo(dt).eps)
    S0, Sd, P, nu_fit, nu_out = (v.to(wdt) for v in (S0, Sd, P, nu_fit,
                                                      nu_out))
    good0 = S0 > 0.0
    S0inv = torch.where(good0, 1.0 / torch.where(good0, S0, 1.0), 0.0)
    cvec, gvec = _t_coeffs(freqs, P, nu_fit)
    cvec = cvec.to(wdt)
    gvec = gvec.to(wdt)

    def cgh(theta):
        t_n = (theta[:, 0:1] + cvec * theta[:, 1:2]
               + gvec * theta[:, 2:3])
        C, C1, C2 = _moments_real(t_n, Xr, Xi)
        f, g, H = _cgh_tail(C, C1, C2, S0inv, cvec, gvec, chan_group)
        return f, g, H, C

    theta, f, H, C, nfev, code = _newton_loop(
        cgh, theta0.to(wdt), flags_arr, max_iter, ftol,
        bounds=None if bounds is None else bounds.to(wdt))
    return _result_dtype(_finalize_fit(
        theta, f, H, C, S0, Sd, nharm, flags_arr, fit_flags, P, nu_fit,
        nu_out, nfev, code, out_dtype=dt, chan_group=chan_group), dt)


def fast_fit_batched(ports, model, noise_stds, chan_masks, freqs, P,
                     nu_fit, nu_out, theta0, bounds=None, *, fit_flags,
                     max_iter, seed_derotate=True, x_bf16=None,
                     nharm_eff=None, dft_fold=None, fit_fused=None,
                     chan_group=None):
    """The JAX package's fast_fit_one with the batch as a leading
    dimension: weights, DFT -> cross-spectrum + CCF seed, real Newton
    core.  nharm_eff band-limits the DFTs and moment passes; chi2/dof
    stay full-spectrum (Parseval Sd, nharm_total).  chan_group: the
    mesh's 'chan' subgroup when the channel axis of ports, model,
    noise_stds, chan_masks and freqs is the rank's block."""
    if x_bf16 is None:
        x_bf16 = use_bf16_cross_spectrum()
    nbin = ports.shape[-1]
    w = make_weights(noise_stds, nbin, chan_masks, dtype=ports.dtype,
                     nharm=nharm_eff)
    # float64 runs never narrow: bf16 storage is a float32 optimization
    x_dtype = (torch.bfloat16
               if (x_bf16 and ports.dtype == torch.float32) else None)
    Xr, Xi, S0, Sd, th0 = prepare_portrait_fit_real(
        ports, model.to(ports.dtype), w, freqs, P, nu_fit, theta0,
        seed_phi=bool(fit_flags[0]), seed_derotate=seed_derotate,
        x_dtype=x_dtype, nharm_eff=nharm_eff, dft_fold=dft_fold,
        fit_fused=fit_fused, chan_group=chan_group)
    return _fit_portrait_core_real(
        Xr, Xi, S0, Sd, freqs, P, nu_fit, nu_out, th0,
        fit_flags=fit_flags, max_iter=max_iter,
        nharm_total=nbin // 2 + 1 if nharm_eff is not None else None,
        bounds=bounds, chan_group=chan_group)


def fast_fit_batched_packed(raw, scl, offs, model, noise_stds, chan_masks,
                            freqs, P, nu_fit, nu_out, theta0, *, raw_code,
                            nbin, fit_flags, max_iter, nharm_eff,
                            seed_derotate=True, x_bf16=None, dft_fold=None,
                            fused_block=None):
    """fast_fit_batched for sub-byte packed raw rows (the JAX package's
    fast_fit_one_packed with the batch as a leading dimension): weights
    from the noise levels, the decode-fused prepare
    (prepare_portrait_fit_real_packed), then the same real Newton core.
    noise_stds' dtype is the working dtype; model and freqs are shared
    across the batch, everything else is per element."""
    if x_bf16 is None:
        x_bf16 = use_bf16_cross_spectrum()
    dt = noise_stds.dtype
    w = make_weights(noise_stds, nbin, chan_masks, dtype=dt,
                     nharm=nharm_eff)
    x_dtype = torch.bfloat16 if (x_bf16 and dt == torch.float32) else None
    Xr, Xi, S0, Sd, th0 = prepare_portrait_fit_real_packed(
        raw, scl, offs, model.to(dt), w, freqs, P, nu_fit, theta0,
        raw_code=raw_code, nbin=nbin, nharm_eff=nharm_eff,
        seed_phi=bool(fit_flags[0]), seed_derotate=seed_derotate,
        x_dtype=x_dtype, dft_fold=dft_fold, fused_block=fused_block)
    return _fit_portrait_core_real(
        Xr, Xi, S0, Sd, freqs, P, nu_fit, nu_out, th0,
        fit_flags=fit_flags, max_iter=max_iter, nharm_total=nbin // 2 + 1)


# ---------------------------------------------------------------------------
# the complex-free scattering lane

def _initial_phase_guess_scatter(Xr, Xi, cvec, DM0, tau_n, nbin,
                                 derotate=True, oversamp=2,
                                 chan_group=None):
    """The CCF phase seed matched to the scattering kernel: the
    channel-summed CCF of X conj(B(tau_seed)) is sum_n C_n(phi) on the
    lag grid, so its argmax is the objective's own at the seeded tau
    (the unmatched CCF peaks early by O(tau)).  tau_n (B, nchan): the
    per-channel seed timescale in rotations (0 gives the plain seed)."""
    nharm = Xr.shape[-1]
    dt = cvec.dtype
    k = torch.arange(nharm, dtype=dt, device=cvec.device)
    bk = (2.0 * math.pi * tau_n)[..., None] * k
    q = 1.0 / (1.0 + bk * bk)
    cBi = bk * q
    Yr = Xr * q - Xi * cBi
    Yi = Xr * cBi + Xi * q
    return _initial_phase_guess_real(Yr, Yi, cvec, DM0, derotate=derotate,
                                     nbin=nbin, oversamp=oversamp,
                                     chan_group=chan_group)


def prepare_scatter_fit_real(port, model, noise_stds, chan_mask, freqs, P,
                             nu_fit, theta0, ir_r=None, ir_i=None, *,
                             fit_flags, log10_tau=False, compensated=False,
                             x_bf16=None, nharm_eff=None, seed_derotate=True,
                             dft_fold=None, fit_fused=None, chan_group=None):
    """Everything before the scattering Newton loop, batched, in real
    arithmetic: weights, the windowed DFT -> cross-spectrum with the
    weighted model power per harmonic (B1 in its want_m2 form on the
    fused lane, two rfft_mm matmuls otherwise), the instrumental
    response folded in (X' = X conj(ir), M2' = M2 |ir|^2), the
    full-spectrum Sd, and the tau-matched CCF seed at theta0's (tau,
    alpha).  X is stored in bfloat16 when the knob says so, unless the
    fit is compensated.  port (B, nchan, nbin); model shared (nchan,
    nbin) or per element; ir_r/ir_i (nchan, nharm_w) sliced to the
    window; chan_group as prepare_portrait_fit_real.  Returns (Xr, Xi,
    M2w, Sd, theta0)."""
    if x_bf16 is None:
        x_bf16 = use_bf16_cross_spectrum()
    nbin = port.shape[-1]
    dt = port.dtype
    w = make_weights(noise_stds, nbin, chan_mask, dtype=dt,
                     nharm=nharm_eff)
    if fit_fused is None:
        fit_fused = resolve_fit_fused(nharm_eff, port.device)
    if fit_fused and nharm_eff is not None:
        from ..ops.fused import fused_cross_spectrum

        Xr, Xi, M2w = fused_cross_spectrum(
            port, model.to(dt).contiguous(), w, nharm_eff, fold=dft_fold,
            want_m2=True)
        Sd = _parseval_Sd(port, w, chan_group)
    else:
        dr, di = rfft_mm(port, nharm=nharm_eff, fold=dft_fold)
        mr, mi = rfft_mm(model.to(dt), nharm=nharm_eff, fold=dft_fold)
        Xr = (dr * mr + di * mi) * w
        Xi = (di * mr - dr * mi) * w
        M2w = (mr**2 + mi**2) * w
        if nharm_eff is None:
            Sd = chan_sum(torch.sum((dr**2 + di**2) * w, dim=-1), -1,
                          chan_group)
        else:
            Sd = _parseval_Sd(port, w, chan_group)
        del dr, di
    if ir_r is not None:
        Xr, Xi = Xr * ir_r + Xi * ir_i, Xi * ir_r - Xr * ir_i
        M2w = M2w * (ir_r**2 + ir_i**2)
    cvec, _ = _t_coeffs(freqs, P, nu_fit)
    theta0 = theta0.to(dt)
    if fit_flags[0]:
        # per-channel seed timescale from theta0's (tau, alpha): the
        # kernel the first Newton evaluation sees
        tau0 = 10.0 ** theta0[:, 3] if log10_tau else theta0[:, 3]
        tau_n = tau0[:, None] * (freqs.to(dt) / nu_fit[:, None]) \
            ** theta0[:, 4:5]
        phi0 = _initial_phase_guess_scatter(
            Xr, Xi, cvec.to(dt), theta0[:, 1], tau_n, nbin,
            derotate=seed_derotate, chan_group=chan_group)
        theta0 = theta0.clone()
        theta0[:, 0] = phi0
    xdt = (dt if compensated
           else torch.bfloat16 if (x_bf16 and dt == torch.float32) else dt)
    return Xr.to(xdt), Xi.to(xdt), M2w, Sd, theta0


def _fit_portrait_core_real_scatter(Xr, Xi, M2w, Sd, freqs, P, nu_fit,
                                    nu_out, theta0, fit_flags=FitFlags(),
                                    log10_tau=False, max_iter=40, ftol=None,
                                    compensated=False, nharm_total=None,
                                    bounds=None, chan_group=None):
    """Stage 2 of the split scattering fit, batched: the (phi, DM, GM,
    tau, alpha) Newton loop on _cgh_scatter (hybrid plain + compensated
    polish when compensated) and the packaging, with (C, S) riding the
    loop state as aux.  nharm_total: the full spectrum's harmonic count
    when the spectra are band-limited (the unscattered template's
    window holds for every tau: the kernel never widens the spectrum).
    chan_group as _fit_portrait_core_real."""
    dt = M2w.dtype
    nharm = nharm_total if nharm_total is not None else Xr.shape[-1]
    flags_arr = FitFlags(*fit_flags).as_tensor(dt, M2w.device)
    if ftol is None:
        ftol = _scatter_ftol(dt, compensated)
    cvec, gvec = _t_coeffs(freqs, P, nu_fit)
    cvec = cvec.to(dt)
    gvec = gvec.to(dt)

    def mk_cgh(comp):
        def cgh(theta):
            return _cgh_scatter(theta, Xr, Xi, M2w, freqs, nu_fit, cvec,
                                gvec, log10_tau, comp, chan_group)
        return cgh

    if compensated:
        theta, f, H, (C, S), nfev, code = _hybrid_scatter_loop(
            mk_cgh(False), mk_cgh(True), theta0.to(dt), flags_arr,
            max_iter, ftol, dt, bounds=bounds)
    else:
        theta, f, H, (C, S), nfev, code = _newton_loop(
            mk_cgh(False), theta0.to(dt), flags_arr, max_iter, ftol,
            lam0=_SCATTER_LAM0, bounds=bounds)
    return _finalize_fit(theta, f, H, C, S, Sd, nharm, flags_arr,
                         fit_flags, P, nu_fit, nu_out, nfev, code,
                         log10_tau, chan_group=chan_group)


def fast_scatter_fit_batched(ports, model, noise_stds, chan_masks, freqs, P,
                             nu_fit, nu_out, theta0, ir_r=None, ir_i=None,
                             bounds=None, *, fit_flags, log10_tau, max_iter,
                             compensated=False, x_bf16=None, nharm_eff=None,
                             seed_derotate=True, dft_fold=None,
                             fit_fused=None, chan_group=None):
    """The JAX package's fast_scatter_fit_one with the batch as a leading
    dimension: prepare_scatter_fit_real, then the scattering Newton
    core.  The (tau, alpha) seeds arrive in theta0's columns 3 and 4.
    chan_group as fast_fit_batched (ir_r/ir_i then hold the rank's
    channel block too)."""
    nbin = ports.shape[-1]
    Xr, Xi, M2w, Sd, th0 = prepare_scatter_fit_real(
        ports, model, noise_stds, chan_masks, freqs, P, nu_fit, theta0,
        ir_r, ir_i, fit_flags=fit_flags, log10_tau=log10_tau,
        compensated=compensated, x_bf16=x_bf16, nharm_eff=nharm_eff,
        seed_derotate=seed_derotate, dft_fold=dft_fold, fit_fused=fit_fused,
        chan_group=chan_group)
    return _fit_portrait_core_real_scatter(
        Xr, Xi, M2w, Sd, freqs, P, nu_fit, nu_out, th0, fit_flags=fit_flags,
        log10_tau=log10_tau, max_iter=max_iter, compensated=compensated,
        nharm_total=nbin // 2 + 1 if nharm_eff is not None else None,
        bounds=bounds, chan_group=chan_group)


# ---------------------------------------------------------------------------
# one subint: the JAX package's per-element bodies, as the batched lanes
# at B = 1

def _unbatched(r):
    """A batched FitResult's only element (0-d fields, the covariance
    (5, 5), the per-channel fields (nchan,))."""
    return FitResult(*[v[0] for v in r])


def _one(x, dt, dev, ndim):
    """x (numpy, scalar or tensor) as a tensor of dtype dt on dev with a
    leading batch axis of 1 (``ndim`` = the un-batched rank)."""
    t = _as_tensor(x, dt, dev)
    return t.reshape((1,) + tuple(t.shape[t.dim() - ndim:]))


def _nu_out_one(nu_out, dt, dev):
    """A single fit's nu_out (None: the zero-covariance frequency, as
    -1) as a (1,) tensor."""
    return _nu_out_tensor(None if nu_out is None else _as_tensor(
        nu_out, dt, dev).reshape(()), 1, dt, dev)


def fast_fit_one(port, model, noise_stds, chan_mask, freqs, P, nu_fit,
                 nu_out, theta0, bounds=None, *, fit_flags, max_iter,
                 seed_derotate=True, x_bf16=None, nharm_eff=None,
                 dft_fold=None, fit_fused=None):
    """One complex-free fast fit, the JAX package's per-element body:
    fast_fit_batched at B = 1 on port's device and dtype, returning the
    un-batched FitResult.  port (nchan, nbin); model (nchan, nbin);
    noise_stds, chan_mask (None: all channels) and freqs (nchan,); P,
    nu_fit, nu_out (None: the zero-covariance frequency) scalars;
    theta0 (5,); bounds (5, 2) or None.  nharm_eff None is the
    unwindowed lane, as in the JAX function (pass
    full_spectrum_window(nbin, device) for the fused one on the card).
    The batched lane gives every row its own bits (ROADMAP C8), so this
    equals that row of any batch."""
    port = port if isinstance(port, torch.Tensor) else \
        torch.as_tensor(np.asarray(port))
    dt, dev = port.dtype, port.device
    nchan = port.shape[-2]
    r = fast_fit_batched(
        port.reshape((1,) + tuple(port.shape[-2:])).contiguous(),
        _as_tensor(model, dt, dev).contiguous(),
        _one(noise_stds, dt, dev, 1),
        (torch.ones((1, nchan), dtype=dt, device=dev) if chan_mask is None
         else _one(chan_mask, dt, dev, 1)),
        _as_tensor(freqs, dt, dev), _one(P, dt, dev, 0),
        _one(nu_fit, dt, dev, 0), _nu_out_one(nu_out, dt, dev),
        _one(theta0, dt, dev, 1),
        None if bounds is None else _as_tensor(bounds, dt, dev),
        fit_flags=FitFlags(*[bool(f) for f in fit_flags]),
        max_iter=int(max_iter), seed_derotate=seed_derotate, x_bf16=x_bf16,
        nharm_eff=nharm_eff, dft_fold=dft_fold, fit_fused=fit_fused)
    return _unbatched(r)


def fast_fit_one_packed(raw, scl, offs, model, noise_stds, chan_mask,
                        freqs, P, nu_fit, nu_out, theta0, *, raw_code,
                        nbin, fit_flags, max_iter, seed_derotate=True,
                        x_bf16=None, nharm_eff=None, dft_fold=None,
                        fused_block=None):
    """fast_fit_one for sub-byte packed rows (the JAX package's
    per-element body of the decode-fused raw lane):
    fast_fit_batched_packed at B = 1, returning the un-batched
    FitResult.  raw (nchan, nbin * nbit / 8) uint8; scl, offs,
    noise_stds, chan_mask (nchan,); noise_stds' dtype is the working
    dtype; nharm_eff must be set (the decode-fused stage is windowed;
    nbin // 2 + 1 takes every harmonic)."""
    if nharm_eff is None:
        raise ValueError("fast_fit_one_packed: the decode-fused stage needs "
                         "a harmonic window (nharm_eff; nbin // 2 + 1 for "
                         "every harmonic)")
    noise = noise_stds if isinstance(noise_stds, torch.Tensor) else \
        torch.as_tensor(np.asarray(noise_stds))
    dt, dev = noise.dtype, noise.device
    raw = torch.as_tensor(raw).to(dev)
    nchan = raw.shape[-2]
    r = fast_fit_batched_packed(
        raw.reshape((1,) + tuple(raw.shape[-2:])).contiguous(),
        _one(scl, dt, dev, 1), _one(offs, dt, dev, 1),
        _as_tensor(model, dt, dev).contiguous(), _one(noise, dt, dev, 1),
        (torch.ones((1, nchan), dtype=dt, device=dev) if chan_mask is None
         else _one(chan_mask, dt, dev, 1)),
        _as_tensor(freqs, dt, dev), _one(P, dt, dev, 0),
        _one(nu_fit, dt, dev, 0), _nu_out_one(nu_out, dt, dev),
        _one(theta0, dt, dev, 1), raw_code=raw_code, nbin=int(nbin),
        fit_flags=FitFlags(*[bool(f) for f in fit_flags]),
        max_iter=int(max_iter), nharm_eff=int(nharm_eff),
        seed_derotate=seed_derotate, x_bf16=x_bf16, dft_fold=dft_fold,
        fused_block=fused_block)
    return _unbatched(r)


def fast_scatter_fit_one(port, model, noise_stds, chan_mask, freqs, P,
                         nu_fit, nu_out, theta0, ir_r=None, ir_i=None,
                         bounds=None, *, fit_flags, log10_tau, max_iter,
                         compensated=False, x_bf16=None, nharm_eff=None,
                         seed_derotate=True, dft_fold=None,
                         fit_fused=None):
    """One complex-free scattering fit, the JAX package's per-element
    body: fast_scatter_fit_batched at B = 1, returning the un-batched
    FitResult.  Arguments as fast_fit_one's; ir_r/ir_i the instrumental
    response's real parts (nchan, nharm_w), sliced to the window when
    nharm_eff is set; the (tau, alpha) seeds in theta0[3:5]."""
    port = port if isinstance(port, torch.Tensor) else \
        torch.as_tensor(np.asarray(port))
    dt, dev = port.dtype, port.device
    nchan = port.shape[-2]
    ir = [None if v is None else _as_tensor(v, dt, dev) for v in (ir_r, ir_i)]
    r = fast_scatter_fit_batched(
        port.reshape((1,) + tuple(port.shape[-2:])).contiguous(),
        _as_tensor(model, dt, dev).contiguous(),
        _one(noise_stds, dt, dev, 1),
        (torch.ones((1, nchan), dtype=dt, device=dev) if chan_mask is None
         else _one(chan_mask, dt, dev, 1)),
        _as_tensor(freqs, dt, dev), _one(P, dt, dev, 0),
        _one(nu_fit, dt, dev, 0), _nu_out_one(nu_out, dt, dev),
        _one(theta0, dt, dev, 1), ir[0], ir[1],
        None if bounds is None else _as_tensor(bounds, dt, dev),
        fit_flags=FitFlags(*[bool(f) for f in fit_flags]),
        log10_tau=bool(log10_tau), max_iter=int(max_iter),
        compensated=bool(compensated), x_bf16=x_bf16, nharm_eff=nharm_eff,
        seed_derotate=seed_derotate, dft_fold=dft_fold, fit_fused=fit_fused)
    return _unbatched(r)


def _as_tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _nu_out_tensor(nu_out, nb, dt, dev):
    """nu_out (None = the zero-covariance frequencies, a scalar, or a
    (nb,) tensor) as a (nb,) tensor; -1 marks "none"."""
    if nu_out is None:
        return torch.full((nb,), -1.0, dtype=dt, device=dev)
    if isinstance(nu_out, torch.Tensor):
        return nu_out.to(device=dev, dtype=dt).expand(nb).contiguous()
    return torch.full((nb,), float(nu_out), dtype=dt, device=dev)


def _stage_batch(ports, models, noise_stds, freqs, P, nu_fit, nu_out,
                 theta0, chan_masks, bounds, dev, canonical=False):
    """The batch wrappers' host staging: every input as a tensor on dev
    in the ports' dtype (float64 made float32 first where
    _canonical_real_dtype says so, with canonical), P / nu_fit / nu_out
    broadcast to (nb,), theta0 zeros when None, masks ones when None,
    bounds checked.  seed_derotate: whether any DM guess is nonzero (the
    CCF seed's derotation is the identity otherwise)."""
    ports_t = ports if isinstance(ports, torch.Tensor) else \
        torch.as_tensor(np.asarray(ports))
    ports_t = ports_t.to(dev)
    if canonical:
        ports_t = _canonical_real_dtype(ports_t, dev)
    dt = ports_t.dtype
    nb, nchan, _ = ports_t.shape
    if theta0 is None:
        theta0_t = torch.zeros((nb, 5), dtype=dt, device=dev)
        seed_derotate = False
    else:
        theta0_t = _as_tensor(theta0, dt, dev)
        seed_derotate = bool(np.any(np.asarray(_host(theta0))[..., 1]
                                    != 0.0))
    if bounds is not None:
        bounds = _as_tensor(bounds, dt, dev)
        if bounds.shape[-2:] != (5, 2) or bounds.dim() not in (2, 3):
            raise ValueError(f"bounds must be (5, 2) or (nb, 5, 2); got "
                             f"{tuple(bounds.shape)}")
    return dict(
        ports=ports_t.contiguous(),
        models=_as_tensor(models, dt, dev).contiguous(),
        noise=_as_tensor(noise_stds, dt, dev),
        masks=(torch.ones((nb, nchan), dtype=dt, device=dev)
               if chan_masks is None else _as_tensor(chan_masks, dt, dev)),
        freqs=_as_tensor(freqs, dt, dev),
        P=_as_tensor(P, dt, dev).expand(nb).contiguous(),
        nu_fit=_as_tensor(nu_fit, dt, dev).expand(nb).contiguous(),
        nu_out=_nu_out_tensor(nu_out, nb, dt, dev), theta0=theta0_t,
        bounds=bounds, seed_derotate=seed_derotate)


def derive_use_scatter(fit_flags, log10_tau, theta0):
    """True when the scattering kernel must be active: tau/alpha fitted,
    the log10 parameterization (tau = 10^theta3 > 0 always), or a fixed
    nonzero tau seeded in theta0."""
    if bool(fit_flags[3]) or bool(fit_flags[4]) or log10_tau:
        return True
    if theta0 is not None:
        return bool(np.any(np.asarray(_host(theta0))[..., 3] != 0.0))
    return False


def reject_fixed_tau_seed(theta0, caller):
    """The no-scattering core has no kernel: a fixed nonzero tau seed
    is refused, not silently dropped."""
    if theta0 is not None and bool(np.any(np.asarray(_host(theta0))[..., 3]
                                          != 0.0)):
        raise ValueError(
            f"{caller}: fixed nonzero tau in theta0 requires the "
            "scattering kernel; use the complex engine instead")


def fit_portrait_batch_fast(ports, models, noise_stds, freqs, P, nu_fit,
                            nu_out=None, theta0=None, fit_flags=FitFlags(),
                            chan_masks=None, max_iter=40, log10_tau=False,
                            ir_FT=None, use_scatter=None, compensated=None,
                            harmonic_window=None, bounds=None,
                            device=None, chan_group=None):
    """Batched fit through the complex-free lanes, on ``device`` (default
    cuda):

    - no scattering: the three-moment fast fit (fast_fit_batched);
    - scattering active (tau/alpha fitted, log10_tau, a fixed nonzero
      tau seed, or an instrumental response ir_FT (nchan, nharm)): the
      scattering lane (fast_scatter_fit_batched).  compensated: None ->
      config.scatter_compensated (nfeval may then exceed max_iter by the
      polish budget).

    ports (nb, nchan, nbin) numpy or tensor (its dtype is the working
    dtype); models (nb, nchan, nbin) or a shared (nchan, nbin) template
    (kept 2-D); noise_stds/chan_masks (nb, nchan); freqs (nchan,) or
    (nb, nchan); P and nu_fit scalars or (nb,).  harmonic_window: None
    -> config.fit_harmonic_window; 'auto' derives K from the model only
    when it is host numpy; 'full' every harmonic (resolve_harmonic_window).
    bounds: (5, 2) or (nb, 5, 2) [lo, hi] box.
    chan_group: the mesh's 'chan' subgroup (parallel/batch.py) when the
    channel axis of every per-channel input is this rank's block: the
    chi^2 channel sums are then combined over it, one collective per
    Newton evaluation, and every rank returns the whole FitResult."""
    if use_scatter is None:
        use_scatter = (derive_use_scatter(fit_flags, log10_tau, theta0)
                       or ir_FT is not None)
    if not use_scatter and ir_FT is not None:
        raise ValueError(
            "fit_portrait_batch_fast: an instrumental response needs the "
            "scatter-shaped engine; do not pass use_scatter=False with "
            "ir_FT")
    if use_scatter:
        return _fit_batch_fast_scatter(
            ports, models, noise_stds, freqs, P, nu_fit, nu_out, theta0,
            fit_flags, chan_masks, max_iter, log10_tau, ir_FT, compensated,
            harmonic_window, bounds, device, chan_group)
    reject_fixed_tau_seed(theta0, "fit_portrait_batch_fast")
    args, bounds, common = _stage_fast(
        ports, models, noise_stds, freqs, P, nu_fit, nu_out, theta0,
        fit_flags, chan_masks, max_iter, harmonic_window, bounds, device,
        chan_group)
    return fast_fit_batched(*args, bounds, x_bf16=use_bf16_cross_spectrum(),
                            **common)


def _stage_fast(ports, models, noise_stds, freqs, P, nu_fit, nu_out, theta0,
                fit_flags, chan_masks, max_iter, harmonic_window, bounds,
                device, chan_group=None):
    """The fast lanes' staging: the batch's tensors (_stage_batch) as
    positional args, the bounds, and the keywords both lanes share
    (flags, the resolved window, fold and fused knobs, the channel
    group)."""
    dev = resolve_device(device)
    st = _stage_batch(ports, models, noise_stds, freqs, P, nu_fit, nu_out,
                      theta0, chan_masks, bounds, dev)
    nharm_eff = resolve_harmonic_window(harmonic_window, models,
                                        st["ports"].shape[-1], dev)
    common = dict(fit_flags=FitFlags(*[bool(f) for f in fit_flags]),
                  max_iter=int(max_iter), seed_derotate=st["seed_derotate"],
                  nharm_eff=nharm_eff, dft_fold=use_dft_fold(dev),
                  fit_fused=resolve_fit_fused(nharm_eff, dev),
                  chan_group=chan_group)
    args = (st["ports"], st["models"], st["noise"], st["masks"],
            st["freqs"], st["P"], st["nu_fit"], st["nu_out"], st["theta0"])
    return args, st["bounds"], common


def _fit_batch_fast_scatter(ports, models, noise_stds, freqs, P, nu_fit,
                            nu_out, theta0, fit_flags, chan_masks, max_iter,
                            log10_tau, ir_FT, compensated, harmonic_window,
                            bounds, device, chan_group):
    """Batch wrapper of the complex-free scattering lane (see
    fit_portrait_batch_fast, which routes here): the response is cut to
    the harmonic window and split into real parts."""
    args, bounds, common = _stage_fast(
        ports, models, noise_stds, freqs, P, nu_fit, nu_out, theta0,
        fit_flags, chan_masks, max_iter, harmonic_window, bounds, device,
        chan_group)
    if compensated is None:
        compensated = use_scatter_compensated()
    nharm_eff = common["nharm_eff"]
    if ir_FT is not None and nharm_eff is not None:
        ir_FT = np.asarray(_host(ir_FT))[..., :nharm_eff]
    ir_r, ir_i = split_ir_host(ir_FT, args[0].dtype, args[0].device)
    return fast_scatter_fit_batched(
        *args, ir_r, ir_i, bounds, log10_tau=bool(log10_tau),
        compensated=bool(compensated), x_bf16=effective_x_bf16(compensated),
        **common)


# ---------------------------------------------------------------------------
# the complex engine

def _initial_phase_guess(X, cvec, DM0, oversamp=2, chan_group=None):
    """Dense-CCF phase seed of the complex cross-spectrum X (B, nchan,
    nharm): derotate by DM0 (B,), sum channels, inverse FFT onto a 2x
    oversampled lag grid, first argmax."""
    nharm = X.shape[-1]
    nbin = 2 * (nharm - 1)
    dt = cvec.dtype
    k = torch.arange(nharm, dtype=dt, device=cvec.device)
    ph = cexp(2.0 * math.pi * (cvec * DM0[:, None])[..., None] * k)
    x = chan_sum(X * ph, -2, chan_group)
    nlag = nbin * oversamp
    ccf = irfft_c_rows(x, n=nlag)
    j0 = torch.argmax(ccf, dim=-1)
    phi0 = j0.to(dt) / nlag
    return torch.remainder(phi0 + 0.5, 1.0) - 0.5


def _fit_portrait_core(dFT, mFT, w, freqs, P, nu_fit, nu_out, theta0,
                       ir_FT=None, fit_flags=FitFlags(), log10_tau=False,
                       max_iter=40, ftol=None, use_ir=False,
                       use_scatter=False, auto_seed=True, compensated=False,
                       bounds=None, chan_group=None):
    """The complex engine, batched: dFT (B, nchan, nharm) complex data
    spectra, mFT the template's (shared (nchan, nharm) or per element),
    w (B, nchan, nharm) weights, ir_FT complex (nchan, nharm) or None.
    No scattering: the three complex moments (_cgh_fast).  Scattering
    (tau/alpha free, log10_tau, a fixed tau seed or the response):
    _cgh_scatter on X conj(ir) and M2 |ir|^2, the hybrid compensated
    loop when compensated.  C and S are re-evaluated at the solution
    from the complex spectra (_CS_general).  chan_group as
    _fit_portrait_core_real."""
    dt = w.dtype
    ir = ir_FT if use_ir else None
    # log10_tau implies tau = 10^theta3 > 0, so the no-scatter path would
    # disagree with the packaging's scales and chi2
    scatter = (use_scatter or use_ir or fit_flags[3] or fit_flags[4]
               or log10_tau)
    wdt = dt if scatter else _newton_dtype(fit_flags, dt)
    flags_arr = FitFlags(*fit_flags).as_tensor(wdt, w.device)
    if ftol is None:
        ftol = (_scatter_ftol(dt, compensated) if scatter
                else 50.0 * float(torch.finfo(dt).eps))

    X = dFT * torch.conj(mFT) * w
    P, nu_fit, nu_out = (v.to(wdt) for v in (P, nu_fit, nu_out))
    cvec, gvec = _t_coeffs(freqs, P, nu_fit)
    cvec = cvec.to(wdt)
    gvec = gvec.to(wdt)
    M2s = (mFT.real**2 + mFT.imag**2) * w

    if scatter:
        if ir is not None:
            Xs = X * torch.conj(ir)
            M2s_ = M2s * (ir.real**2.0 + ir.imag**2.0)
        else:
            Xs, M2s_ = X, M2s
        Xs_r = Xs.real.contiguous()
        Xs_i = Xs.imag.contiguous()
        del Xs

        def mk_cgh(comp):
            def cgh(theta):
                f, g, H, _ = _cgh_scatter(theta, Xs_r, Xs_i, M2s_, freqs,
                                          nu_fit, cvec, gvec, log10_tau,
                                          comp, chan_group)
                return f, g, H, ()
            return cgh

        cgh = mk_cgh(False)
    else:
        S0 = torch.sum(M2s, dim=-1).to(wdt)
        good0 = S0 > 0.0
        S0inv = torch.where(good0, 1.0 / torch.where(good0, S0, 1.0), 0.0)

        def cgh(theta):
            return _cgh_fast(theta, X, S0inv, cvec, gvec, chan_group) + ((),)

    theta0 = theta0.to(wdt)
    if auto_seed and fit_flags[0]:
        phi0 = _initial_phase_guess(X, cvec, theta0[:, 1],
                                    chan_group=chan_group)
        theta0 = theta0.clone()
        theta0[:, 0] = phi0

    if scatter and compensated:
        theta, f, H, _, nfev, code = _hybrid_scatter_loop(
            cgh, mk_cgh(True), theta0, flags_arr, max_iter, ftol, dt,
            bounds=bounds)
    else:
        theta, f, H, _, nfev, code = _newton_loop(
            cgh, theta0, flags_arr, max_iter, ftol,
            lam0=_SCATTER_LAM0 if scatter else 1.0e-3,
            bounds=None if bounds is None else bounds.to(wdt))
    C, S = _CS_general(theta, X, M2s, freqs, P, nu_fit, ir, log10_tau)
    Sd = chan_sum(torch.sum((dFT.real**2 + dFT.imag**2) * w, dim=-1), -1,
                  chan_group)
    return _result_dtype(_finalize_fit(
        theta, f, H, C.to(wdt), S.to(wdt), Sd.to(wdt), dFT.shape[-1],
        flags_arr, fit_flags, P, nu_fit, nu_out, nfev, code, log10_tau,
        out_dtype=dt, chan_group=chan_group), dt)


def _complex_ir(ir_FT, dt, dev):
    """A host or tensor response as the complex tensor of dtype dt's
    complex counterpart on dev (None passes through)."""
    if ir_FT is None:
        return None
    cdt = torch.complex64 if dt == torch.float32 else torch.complex128
    if not isinstance(ir_FT, torch.Tensor):
        ir_FT = torch.as_tensor(np.asarray(ir_FT))
    return ir_FT.to(device=dev, dtype=cdt)


def fit_portrait_batch(ports, models, noise_stds, freqs, P, nu_fit,
                       nu_out=None, theta0=None, fit_flags=FitFlags(),
                       chan_masks=None, log10_tau=False, max_iter=40,
                       use_scatter=None, ir_FT=None, compensated=None,
                       bounds=None, device=None, chan_group=None):
    """The complex engine over a batch, on ``device`` (default cuda).

    ports (nb, nchan, nbin); models shared (nchan, nbin) (kept 2-D) or
    (nb, nchan, nbin); noise_stds/chan_masks (nb, nchan); freqs (nchan,)
    or (nb, nchan); P, nu_fit scalars or (nb,); nu_out None, a scalar
    or (nb,).  use_scatter None -> derived from fit_flags/log10_tau/
    theta0 (a fixed nonzero tau seed still scatters the model).  ir_FT:
    an (nchan, nharm) instrumental response shared by the batch.
    compensated None -> config.scatter_compensated.  float64 inputs run
    as float32 (complex64) where config's device_f32 knob resolves on:
    CUDA devices.  The body of the JAX package's _complex_batch_fn
    (weights, spectra, the batched core) runs here eagerly.  chan_group
    as fit_portrait_batch_fast (ir_FT then the rank's channel block)."""
    dev = resolve_device(device)
    if use_scatter is None:
        use_scatter = derive_use_scatter(fit_flags, log10_tau, theta0)
    if compensated is None:
        compensated = use_scatter_compensated()
    st = _stage_batch(ports, models, noise_stds, freqs, P, nu_fit, nu_out,
                      theta0, chan_masks, bounds, dev, canonical=True)
    dt = st["ports"].dtype
    w = make_weights(st["noise"], st["ports"].shape[-1], st["masks"],
                     dtype=dt)
    return _fit_portrait_core(
        rfft_c_rows(st["ports"]), rfft_c_rows(st["models"]), w, st["freqs"],
        st["P"],
        st["nu_fit"], st["nu_out"], st["theta0"], _complex_ir(ir_FT, dt, dev),
        fit_flags=FitFlags(*[bool(f) for f in fit_flags]),
        log10_tau=bool(log10_tau), max_iter=int(max_iter),
        use_ir=ir_FT is not None, use_scatter=bool(use_scatter),
        compensated=bool(compensated), bounds=st["bounds"],
        chan_group=chan_group)


def fit_portrait(port, model, noise_stds, freqs, P, nu_fit=None, nu_out=None,
                 phi0=None, DM0=0.0, GM0=0.0, tau0=0.0, alpha0=None,
                 fit_flags=FitFlags(), chan_mask=None, ir_FT=None,
                 log10_tau=False, max_iter=40, dtype=None, bounds=None,
                 device=None):
    """Fit (phi, DM[, GM, tau, alpha]) of one (nchan, nbin) portrait with
    the complex engine.  nu_fit None -> guess_fit_freq(freqs); nu_out
    None -> the zero-covariance frequencies; phi0 None -> the CCF seed;
    tau0 in rotations (seeded as log10 with log10_tau); alpha0 None ->
    config.scattering_alpha.  dtype None runs in the data's dtype (made
    float32 where device_f32 resolves on); an explicit dtype runs the
    whole fit in it, on every device.  Returns a FitResult of 0-d
    tensors."""
    from ..config import scattering_alpha

    dev = resolve_device(device)
    port_t = _as_tensor(port, None, dev)
    if dtype is None:
        port_t = _canonical_real_dtype(port_t, dev)
    dt = dtype or port_t.dtype
    nbin = port_t.shape[-1]
    w = make_weights(_as_tensor(noise_stds, dt, dev)[None], nbin,
                     None if chan_mask is None
                     else _as_tensor(chan_mask, dt, dev)[None], dtype=dt)
    freqs_t = _as_tensor(freqs, dt, dev)
    if nu_fit is None:
        nu_fit = guess_fit_freq(freqs_t)
    if alpha0 is None:
        alpha0 = scattering_alpha
    taup0 = math.log10(max(float(tau0), 1e-30)) if log10_tau else tau0
    theta0 = torch.tensor([[0.0 if phi0 is None else phi0, DM0, GM0, taup0,
                            alpha0]], dtype=dt, device=dev)
    use_scatter = (bool(fit_flags[3]) or bool(fit_flags[4])
                   or float(tau0) != 0.0)
    r = _fit_portrait_core(
        rfft_c_rows(port_t.to(dt))[None],
        rfft_c_rows(_as_tensor(model, dt, dev)), w,
        freqs_t, _as_tensor(P, dt, dev).reshape(1),
        _as_tensor(nu_fit, dt, dev).reshape(1),
        _nu_out_tensor(nu_out, 1, dt, dev), theta0,
        _complex_ir(ir_FT, dt, dev),
        fit_flags=FitFlags(*[bool(f) for f in fit_flags]),
        log10_tau=bool(log10_tau), max_iter=int(max_iter),
        use_ir=ir_FT is not None, use_scatter=use_scatter,
        auto_seed=phi0 is None, compensated=use_scatter_compensated(),
        bounds=None if bounds is None else _as_tensor(bounds, dt, dev))
    return FitResult(*[v[0] for v in r])


# ---------------------------------------------------------------------------
# scattering-timescale seeds

def estimate_tau_batch(ports, models, noise_stds, chan_masks=None,
                       fit_fused=None):
    """Seed-quality broadband scattering timescales [rot], (B,), on the
    ports' device: the channel-summed weighted cross-spectrum amplitude
    ratio q(k) = sum_n w|d conj(m)| / sum_n w|m|^2, the analytic Rice
    floor of |X| under pure noise subtracted in quadrature, matched to
    the kernel's Lorentzian amplitude |B(k)| = (1 + (2 pi k tau)^2)^-1/2
    by profiled-amplitude least squares on a 64-point log-tau grid from
    a quarter bin to half a turn, refined by a parabola through the
    argmin.  Unscattered data return the neutral half-bin seed.

    ports (B, nchan, nbin); models shared (nchan, nbin) or per element;
    noise_stds/chan_masks (B, nchan).  fit_fused None -> on where an
    unwindowed fit takes the fused kernels (full_spectrum_window: CUDA
    with the fused lane on; the CPU keeps the JAX package's matmul
    DFT).  On, the three channel sums come from B1's
    want_m2 form at every harmonic (w|d conj(m)| = |(Xr, Xi)|, w|m|^2 =
    M2w, sqrt(w)|m| = sqrt(M2w)), which transforms each row alone, so a
    subint's seed does not depend on its bucket; off, from two matmul
    DFTs (rfft_mm), whose cuBLAS GEMM rounds by the row count."""
    dt = ports.dtype
    nbin = ports.shape[-1]
    nharm = nbin // 2 + 1
    tiny = _tiny(dt)
    w = make_weights(noise_stds.to(dt), nbin, chan_masks, dtype=dt)
    if fit_fused is None:
        fit_fused = full_spectrum_window(nbin, ports.device) is not None
    if fit_fused:
        from ..ops.fused import fused_cross_spectrum

        Xr, Xi, M2w = fused_cross_spectrum(
            ports.contiguous(), models.to(dt).contiguous(), w.contiguous(),
            nharm, want_m2=True)
        del w
        num = chan_sum(torch.sqrt(Xr**2.0 + Xi**2.0), -2)
        del Xr, Xi
        den = chan_sum(M2w, -2)
        fl = chan_sum(torch.sqrt(M2w), -2)
        del M2w
    else:
        dr, di = rfft_mm(ports)
        mr, mi = rfft_mm(models.to(dt))
        mabs = torch.sqrt(mr**2.0 + mi**2.0)
        Xa = torch.sqrt((dr * mr + di * mi) ** 2.0
                        + (di * mr - dr * mi) ** 2.0)
        del dr, di
        # one product at a time: Xa goes before the other two are built
        num = chan_sum(w * Xa, -2)
        del Xa
        den = chan_sum(w * mabs**2.0, -2)
        fl = chan_sum(torch.sqrt(w) * mabs, -2)
        del w
    den_safe = torch.clamp(den, min=tiny)
    q = num / den_safe
    floor = math.sqrt(math.pi / 2.0) * fl / den_safe
    q_sig = torch.sqrt(torch.clamp(q**2.0 - floor**2.0, min=0.0))
    k = torch.arange(nharm, dtype=dt, device=ports.device)
    ngrid = 64
    taus = torch.as_tensor(np.logspace(np.log10(0.25 / nbin),
                                       np.log10(0.5), ngrid),
                           dtype=dt, device=ports.device)
    b = (1.0 + (2.0 * math.pi * taus[:, None] * k) ** 2.0) ** -0.5
    u = den[:, None, :]
    A = torch.sum(u * q_sig[:, None, :] * b, dim=-1) / torch.clamp(
        torch.sum(u * b**2.0, dim=-1), min=tiny)
    sse = torch.sum(u * (q_sig[:, None, :] - A[..., None] * b) ** 2.0,
                    dim=-1)
    i0 = torch.argmin(sse, dim=-1)
    im = torch.clamp(i0 - 1, 0, ngrid - 1)
    ip = torch.clamp(i0 + 1, 0, ngrid - 1)

    def at(i):
        return torch.gather(sse, 1, i[:, None])[:, 0]

    f0, fm, fp = at(i0), at(im), at(ip)
    denom = fm - 2.0 * f0 + fp
    ok = (i0 > 0) & (i0 < ngrid - 1) & (denom > 0.0)
    delta = torch.where(ok, 0.5 * (fm - fp) / torch.where(ok, denom, 1.0),
                        0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    ltaus = torch.log10(taus)
    dlog = (ltaus[-1] - ltaus[0]) / (ngrid - 1.0)
    tau = 10.0 ** (ltaus[i0] + delta * dlog)
    return torch.clamp(tau, min=0.5 / nbin)


def estimate_tau(port, model, noise_stds, chan_mask=None):
    """estimate_tau_batch for one (nchan, nbin) portrait: a 0-d tensor."""
    return estimate_tau_batch(
        port[None], model, noise_stds[None],
        None if chan_mask is None else chan_mask[None])[0]


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
