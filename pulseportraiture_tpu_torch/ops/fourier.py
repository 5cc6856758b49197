"""Real-valued DFT as matmuls (counterpart of pulseportraiture_tpu/ops/fourier.py).

The length-n real DFT is two real matmuls against precomputed cos/-sin
matrices, band-limited to the first ``nharm`` harmonics when the fit's
harmonic window is active.  The twiddles are built once per shape on
the host in float64 numpy and then cast, exactly as in the JAX package,
so both packages contract against the same numbers.

The matmul API is split-real: rfft_mm(x) -> (Xr, Xi),
irfft_mm(Xr, Xi, n) -> x, matching numpy's rfft/irfft conventions.
The complex fit engine and the scattering ops take the complex
interface, rfft_c / irfft_c (torch.fft), as the JAX package's do off
the TPU.  The split-real interface of the align accumulate, rfft_sr /
irfft_sr, is torch.fft too: the JAX package's matmul arm of it exists
for TPUs only, whose programs cannot hold complex values.
"""

from functools import lru_cache

import numpy as np
import torch

from .. import config
from ..device import resolve_auto

__all__ = ["rfft_mm", "irfft_mm", "rfft_c", "irfft_c", "rfft_sr",
           "irfft_sr", "use_dft_fold", "check_dft_precision",
           "device_weights"]


def _dtype_str(dtype):
    return str(dtype).replace("torch.", "")


def check_dft_precision(precision, device):
    """Validate config.dft_precision (or an explicit value) for a DFT on
    ``device``.  On the CPU all three settings compute full float32
    products, as the JAX package's CPU backend does.  On CUDA only
    'highest' (full FP32, no TF32) is implemented: 'high' and 'default'
    raise rather than compute something else."""
    name = str(config.dft_precision if precision is None
               else precision).lower()
    if name not in ("highest", "high", "default"):
        raise ValueError(
            f"config.dft_precision must be 'highest', 'high' or "
            f"'default', got {name!r}")
    if name != "highest" and torch.device(device).type == "cuda":
        raise NotImplementedError(
            f"dft_precision={name!r} has no CUDA arm yet (tensor-core "
            "TF32/bf16 DFTs are queued in ROADMAP.md); use 'highest'")
    return name


# host numpy caches, built in float64 and cast (the JAX package's
# single source of truth for the twiddles)
@lru_cache(maxsize=None)
def _rfft_weights(n, dtype_str, nharm=None):
    """(Wc, Ws): x @ Wc = Re rfft(x), x @ Ws = Im rfft(x), truncated to
    the first nharm harmonics when nharm is given."""
    k = np.arange(n // 2 + 1 if nharm is None else nharm)
    j = np.arange(n)
    ang = 2.0 * np.pi * np.outer(j, k) / n
    Wc = np.cos(ang)
    Ws = -np.sin(ang)
    return (Wc.astype(dtype_str), Ws.astype(dtype_str))


@lru_cache(maxsize=None)
def _irfft_weights(nharm, n, dtype_str):
    """(Vc, Vs): Xr @ Vc + Xi @ Vs = irfft(X, n).  Interior harmonics
    count twice, the DC and (for even n) Nyquist rows once."""
    k = np.arange(nharm)
    j = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, j) / n
    wk = np.full(nharm, 2.0)
    wk[0] = 1.0
    if n % 2 == 0 and nharm == n // 2 + 1:
        wk[-1] = 1.0
    Vc = (wk[:, None] * np.cos(ang)) / n
    Vs = (-wk[:, None] * np.sin(ang)) / n
    return (Vc.astype(dtype_str), Vs.astype(dtype_str))


@lru_cache(maxsize=None)
def _rfft_fold_weights(n, dtype_str, nharm=None):
    """Half-length weights for the fold-symmetry real DFT (even n):
      Re X_k = x[0] + (-1)^k x[n/2] + sum_{j=1}^{n/2-1} xe_j cos(2pi jk/n)
      Im X_k =                      - sum_{j=1}^{n/2-1} xo_j sin(2pi jk/n)
    with xe_j = x[j] + x[n-j], xo_j = x[j] - x[n-j]."""
    j = np.arange(1, n // 2)
    k = np.arange(n // 2 + 1 if nharm is None else nharm)
    ang = 2.0 * np.pi * np.outer(j, k) / n
    sgn = (-1.0) ** k
    return (np.cos(ang).astype(dtype_str), (-np.sin(ang)).astype(dtype_str),
            sgn.astype(dtype_str))


@lru_cache(maxsize=None)
def _fft_twiddles(n, dtype_str):
    """(tw,): the (n, 2) table of exp(-2 pi i j / n), j < n, as (re, im)
    pairs: the twiddles of the fused kernels' shared-memory FFT
    (csrc/fft_smem.cuh), read as complex values."""
    ang = 2.0 * np.pi * np.arange(n) / n
    return (np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(dtype_str),)


_HOST_WEIGHTS = {"rfft": _rfft_weights, "fold": _rfft_fold_weights,
                 "irfft": _irfft_weights, "fft": _fft_twiddles}
_device_cache = {}


def device_weights(kind, device, *args):
    """The cached host twiddles of ``kind`` ('rfft', 'fold', 'irfft', 'fft';
    args as the host constructor's) as tensors on ``device``, copied
    once per (shape, dtype, device)."""
    key = (kind, str(device)) + args
    hit = _device_cache.get(key)
    if hit is None:
        hit = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in _HOST_WEIGHTS[kind](*args))
        _device_cache[key] = hit
    return hit


def use_dft_fold(device):
    """config.dft_fold resolved for ``device`` (True/False force; 'auto'
    folds off CUDA only)."""
    return resolve_auto("dft_fold", config.dft_fold, device,
                        label="config.dft_fold")


def rfft_mm(x, precision=None, nharm=None, fold=None):
    """Real DFT of the last axis via matmul: (..., n) -> two (..., nharm)
    tensors (Re, Im); nharm defaults to the full n//2+1.  fold None ->
    config.dft_fold (the half-length fold-symmetry contraction)."""
    check_dft_precision(precision, x.device)
    n = x.shape[-1]
    if fold is None:
        fold = use_dft_fold(x.device)
    dts = _dtype_str(x.dtype)
    if fold and n % 2 == 0 and n >= 8:
        Wc_h, Ws_h, sgn = device_weights("fold", x.device, n, dts, nharm)
        head = x[..., 1:n // 2]
        tail = torch.flip(x[..., n // 2 + 1:], dims=(-1,))
        dr = (torch.matmul(head + tail, Wc_h)
              + x[..., 0:1] + x[..., n // 2:n // 2 + 1] * sgn)
        di = torch.matmul(head - tail, Ws_h)
        return dr, di
    Wc, Ws = device_weights("rfft", x.device, n, dts, nharm)
    return torch.matmul(x, Wc), torch.matmul(x, Ws)


def irfft_mm(Xr, Xi, n=None, precision=None):
    """Inverse of rfft_mm: two (..., nharm) tensors -> (..., n)."""
    check_dft_precision(precision, Xr.device)
    nharm = Xr.shape[-1]
    if n is None:
        n = 2 * (nharm - 1)
    Vc, Vs = device_weights("irfft", Xr.device, nharm, n,
                            _dtype_str(Xr.dtype))
    return torch.matmul(Xr, Vc) + torch.matmul(Xi, Vs)


def rfft_c(x):
    """numpy-convention rfft of the last axis as a complex tensor
    (torch.fft; bfloat16 and float16 inputs are taken in float32)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return torch.fft.rfft(x, dim=-1)


def irfft_c(X, n=None):
    """Inverse of rfft_c: complex (..., nharm) -> real (..., n), the
    spectrum zero-padded or cut to n // 2 + 1 harmonics."""
    return torch.fft.irfft(X, n=n, dim=-1)


def rfft_sr(x, precision=None):
    """Split-real rfft of the last axis: (..., n) -> (Re, Im), each
    (..., n//2+1) real, through torch.fft (the JAX package's arm for
    backends with a working FFT).  precision is checked as for the
    matmul DFTs and changes nothing here."""
    check_dft_precision(precision, x.device)
    X = torch.fft.rfft(x, dim=-1)
    return X.real, X.imag


def irfft_sr(Xr, Xi, n=None, precision=None):
    """Inverse of rfft_sr: (Re, Im) -> (..., n) real."""
    check_dft_precision(precision, Xr.device)
    return torch.fft.irfft(torch.complex(Xr, Xi), n=n, dim=-1)
