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

dft_precision: 'highest' computes full float32 products everywhere.
On CUDA, 'high' and 'default' run the matmul DFTs' products in TF32
(what XLA gives these settings on a GPU), with
``torch.backends.cuda.matmul.allow_tf32`` set for the call and restored
after it; on the CPU all three are full float32, as the JAX package's
CPU backend computes them.  The fused kernels (ops.fused) and the
torch.fft transforms compute every setting to FP32 accuracy: the fused
kernels' GEMM arm runs float32 on the tensor cores as three TF32
products per FP32 product, against the host's split twiddles
(device_weights "tf32x3").

Batch invariance: a cuBLAS GEMM picks its kernel, and so its rounding,
by the row count, so a matmul DFT of one row and of the same row among
many differ in their last bits.  rfft_mm_invariant / irfft_mm_invariant
run the rows through GEMMs of one fixed shape (ROW_BLOCK rows,
zero-padded), so a row's bits do not depend on how many rows share
the call; the fast lanes take them on CUDA where a DFT's row count
follows the batch (fit.portrait's CCF seed, pipeline.stream's
re-dispersion), and rfft_c_rows / irfft_c_rows give the complex engine
and narrowband the same through complex spectra (cuFFT's plan, and its
rounding, follows the batch count too), computed in float64 and rounded
once to the input's precision.
"""

import contextlib
from functools import lru_cache

import numpy as np
import torch

from .. import config
from ..device import resolve_auto

__all__ = ["rfft_mm", "irfft_mm", "rfft_c", "irfft_c", "rfft_sr",
           "irfft_sr", "use_dft_fold", "check_dft_precision",
           "device_weights", "rfft_mm_invariant", "irfft_mm_invariant",
           "rfft_c_invariant", "irfft_c_invariant", "rfft_c_rows",
           "irfft_c_rows", "matmul_rows_invariant", "ROW_BLOCK",
           "CHANNEL_ROW_BLOCK"]

# Rows per GEMM of the batch-invariant matmul DFT (matmul_rows_invariant):
# every GEMM it issues is (block, n) @ (n, m).  ROW_BLOCK where a row is
# a subint (the CCF seeds), CHANNEL_ROW_BLOCK where a row is a channel of
# a subint (spectra, the re-dispersion rotation, narrowband's CCF).
# Chosen on the card (tools/fit_batch_invariance.py, PERF.md PR 18).
ROW_BLOCK = 64
CHANNEL_ROW_BLOCK = 512


def _dtype_str(dtype):
    return str(dtype).replace("torch.", "")


def check_dft_precision(precision=None):
    """Validate config.dft_precision (or an explicit value): one of
    'highest', 'high', 'default'; returns it lower-cased.  On CUDA,
    'high' and 'default' run the matmul DFTs in TF32
    (matmul_precision); elsewhere every setting is full float32."""
    name = str(config.dft_precision if precision is None
               else precision).lower()
    if name not in ("highest", "high", "default"):
        raise ValueError(
            f"config.dft_precision must be 'highest', 'high' or "
            f"'default', got {name!r}")
    return name


@contextlib.contextmanager
def matmul_precision(precision, device):
    """The matmul DFTs' product precision for one call: on a CUDA
    device, 'high' and 'default' (config.dft_precision when None) allow
    TF32 in cuBLAS float32 GEMMs and restore the process's setting on
    exit; 'highest', and every setting off CUDA, leave it as it is."""
    name = check_dft_precision(precision)
    if name == "highest" or torch.device(device).type != "cuda":
        yield name
        return
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        yield name
    finally:
        flags.allow_tf32 = prev


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


# the float32 GEMM arm's tiles (csrc/fcs_gemm.cuh TC_BK, TC_BH): its
# twiddle planes are zero-padded to whole tiles
TF32_TIME_CHUNK, TF32_HARM_TILE = 16, 128


def tf32_rna(x):
    """float64 x rounded to TF32 (11 significant bits: the low 13 of a
    float32 mantissa zero), to nearest with ties away from zero, as the
    card's cvt.rna.tf32.f32 rounds; float64 out."""
    m, e = np.frexp(np.asarray(x, dtype=np.float64))
    s = np.ldexp(m, 11)
    return np.ldexp(np.sign(s) * np.floor(np.abs(s) + 0.5), e - 11)


@lru_cache(maxsize=None)
def _tf32x3_weights(n, nharm, fold=False):
    """(hi, lo, sgn): the float32 GEMM arm's twiddles (csrc/fcs_gemm.cuh)
    for the three-product TF32 DFT of length n over nharm harmonics, as
    float32 (2, Kp, Lp) planes [cos, -sin][harmonic][time], K-major (time
    contiguous), the time axis zero-padded to TF32_TIME_CHUNK and the
    harmonics to TF32_HARM_TILE: hi = tf32_rna(w), lo = tf32_rna(w - hi),
    w built in float64, so hi + lo is w to 2^-22 |w|.  fold: the
    half-length fold-symmetry twiddles (_rfft_fold_weights, times
    1 ... n/2 - 1).  sgn = (-1)^k (the fold's Nyquist sign)."""
    if fold:
        Wc, Ws, sgn = _rfft_fold_weights.__wrapped__(n, "float64", nharm)
    else:
        Wc, Ws = _rfft_weights.__wrapped__(n, "float64", nharm)
        sgn = (-1.0) ** np.arange(Wc.shape[1])
    L, K = Wc.shape
    Lp = -(-L // TF32_TIME_CHUNK) * TF32_TIME_CHUNK
    Kp = -(-K // TF32_HARM_TILE) * TF32_HARM_TILE
    w = np.zeros((2, Kp, Lp))
    w[0, :K, :L] = Wc.T
    w[1, :K, :L] = Ws.T
    hi = tf32_rna(w)
    lo = tf32_rna(w - hi)
    return (hi.astype(np.float32), lo.astype(np.float32),
            sgn.astype(np.float32))


@lru_cache(maxsize=None)
def _fft_twiddles(n, dtype_str):
    """(tw,): the (n, 2) table of exp(-2 pi i j / n), j < n, as (re, im)
    pairs: the twiddles of the fused kernels' shared-memory FFT
    (csrc/fft_smem.cuh), read as complex values."""
    ang = 2.0 * np.pi * np.arange(n) / n
    return (np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(dtype_str),)


@lru_cache(maxsize=None)
def _rfft_pair(n):
    """(W,): the (n, 2 (n // 2 + 1)) float64 [Wc | Ws] of rfft_c_invariant:
    Re and Im of the spectrum from one GEMM."""
    return (np.concatenate(_rfft_weights(n, "float64"), axis=1),)


@lru_cache(maxsize=None)
def _irfft_pair(nharm, n):
    """(V,): the (2 nharm, n) float64 [Vc ; Vs] of irfft_c_invariant."""
    return (np.concatenate(_irfft_weights(nharm, n, "float64"), axis=0),)


_HOST_WEIGHTS = {"rfft": _rfft_weights, "fold": _rfft_fold_weights,
                 "irfft": _irfft_weights, "fft": _fft_twiddles,
                 "tf32x3": _tf32x3_weights,
                 "rfft_pair": _rfft_pair, "irfft_pair": _irfft_pair}
_device_cache = {}


def device_weights(kind, device, *args):
    """The cached host twiddles of ``kind`` ('rfft', 'fold', 'irfft', 'fft',
    'tf32x3', ...; args as the host constructor's) as tensors on
    ``device``, copied once per (shape, dtype, device)."""
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


def _matmul(x, W, block):
    """x @ W over the last axis: one torch.matmul (block None) or
    matmul_rows_invariant."""
    if block is None:
        return torch.matmul(x, W)
    return matmul_rows_invariant(x, W, block)


def matmul_rows_invariant(x, W, block=None, out_dtype=None):
    """x (..., n) @ W (n, m) with every GEMM of one shape: the rows
    (all leading axes flattened) go through (block, n) @ (n, m) GEMMs,
    the last block zero-padded, so a row's bits do not depend on the row
    count (a single GEMM of R rows lets cuBLAS pick its kernel by R).
    block None -> ROW_BLOCK.  No torch.bmm: a batched GEMM rounds by its
    batch count too.  With W wider than x (float64 twiddles for float32
    rows) each block is widened, multiplied in W's dtype and rounded
    once to out_dtype (None: x's dtype)."""
    block = int(ROW_BLOCK if block is None else block)
    if block < 1:
        raise ValueError(f"block must be a positive int; got {block}")
    lead, n = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, n).contiguous()
    M, m = rows.shape[0], W.shape[-1]
    out = rows.new_empty((M, m), dtype=out_dtype or rows.dtype)
    direct = rows.dtype == W.dtype == out.dtype
    for lo in range(0, M, block):
        hi = min(lo + block, M)
        if direct and hi - lo == block:
            torch.matmul(rows[lo:hi], W, out=out[lo:hi])
            continue
        a = rows.new_zeros((block, n), dtype=W.dtype)
        a[:hi - lo] = rows[lo:hi]
        out[lo:hi] = torch.matmul(a, W)[:hi - lo]
    return out.reshape(lead + (m,))


def _rfft(x, precision, nharm, fold, block):
    n = x.shape[-1]
    if fold is None:
        fold = use_dft_fold(x.device)
    dts = _dtype_str(x.dtype)
    with matmul_precision(precision, x.device):
        if fold and n % 2 == 0 and n >= 8:
            Wc_h, Ws_h, sgn = device_weights("fold", x.device, n, dts, nharm)
            head = x[..., 1:n // 2]
            tail = torch.flip(x[..., n // 2 + 1:], dims=(-1,))
            dr = (_matmul(head + tail, Wc_h, block)
                  + x[..., 0:1] + x[..., n // 2:n // 2 + 1] * sgn)
            di = _matmul(head - tail, Ws_h, block)
            return dr, di
        Wc, Ws = device_weights("rfft", x.device, n, dts, nharm)
        return _matmul(x, Wc, block), _matmul(x, Ws, block)


def _irfft(Xr, Xi, n, precision, block):
    nharm = Xr.shape[-1]
    if n is None:
        n = 2 * (nharm - 1)
    Vc, Vs = device_weights("irfft", Xr.device, nharm, n,
                            _dtype_str(Xr.dtype))
    with matmul_precision(precision, Xr.device):
        return _matmul(Xr, Vc, block) + _matmul(Xi, Vs, block)


def rfft_mm(x, precision=None, nharm=None, fold=None):
    """Real DFT of the last axis via matmul: (..., n) -> two (..., nharm)
    tensors (Re, Im); nharm defaults to the full n//2+1.  fold None ->
    config.dft_fold (the half-length fold-symmetry contraction)."""
    return _rfft(x, precision, nharm, fold, None)


def irfft_mm(Xr, Xi, n=None, precision=None):
    """Inverse of rfft_mm: two (..., nharm) tensors -> (..., n)."""
    return _irfft(Xr, Xi, n, precision, None)


def rfft_mm_invariant(x, precision=None, nharm=None, fold=None,
                      block=None):
    """rfft_mm with every GEMM of one shape (matmul_rows_invariant): a
    row's bits are the same whatever the number of rows."""
    return _rfft(x, precision, nharm, fold,
                 ROW_BLOCK if block is None else block)


def irfft_mm_invariant(Xr, Xi, n=None, precision=None, block=None):
    """irfft_mm with every GEMM of one shape (matmul_rows_invariant)."""
    return _irfft(Xr, Xi, n, precision,
                  ROW_BLOCK if block is None else block)


def rfft_c_invariant(x, precision=None, block=None):
    """rfft_c as GEMMs of one shape (matmul_rows_invariant, block None:
    ROW_BLOCK), so a row's spectrum has the same bits whatever the number
    of rows (cuFFT picks its plan, and its rounding, by the batch count).
    The products and sums run in float64 against float64 twiddles
    (Re and Im in one GEMM) and the spectrum is rounded once to x's
    precision: a float32 DFT summed in float32 over n terms would carry
    ~sqrt(n) roundings, more than cuFFT's ~log2(n).  precision is
    checked and changes nothing (no TF32 arm).  Complex (..., n // 2 +
    1) in x's complex dtype."""
    check_dft_precision(precision)
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    n = x.shape[-1]
    W, = device_weights("rfft_pair", x.device, n)
    out = matmul_rows_invariant(x, W, block, out_dtype=x.dtype)
    return torch.complex(out[..., :n // 2 + 1], out[..., n // 2 + 1:])


def irfft_c_invariant(X, n=None, precision=None, block=None):
    """irfft_c as GEMMs of one shape, in float64 as rfft_c_invariant: the
    spectrum zero-padded or cut to n // 2 + 1 harmonics, as
    torch.fft.irfft does."""
    check_dft_precision(precision)
    nharm = X.shape[-1]
    if n is None:
        n = 2 * (nharm - 1)
    keep = min(nharm, n // 2 + 1)
    V, = device_weights("irfft_pair", X.device, keep, n)
    rows = torch.cat([X.real[..., :keep], X.imag[..., :keep]], dim=-1)
    return matmul_rows_invariant(rows, V, block, out_dtype=rows.dtype)


def rfft_c_rows(x, precision=None, block=None):
    """The complex engine's and narrowband's spectra: on CUDA
    rfft_c_invariant (block None: CHANNEL_ROW_BLOCK), so a subint's
    spectrum does not depend on its batch (cuFFT's plan rounds by the
    batch count, ROADMAP C8); elsewhere rfft_c, the JAX package's
    torch.fft."""
    if x.device.type == "cuda":
        return rfft_c_invariant(x, precision, CHANNEL_ROW_BLOCK
                                if block is None else block)
    return rfft_c(x, precision)


def irfft_c_rows(X, n=None, precision=None, block=None):
    """irfft_c for the fit lanes' CCFs: on CUDA irfft_c_invariant (block
    None: ROW_BLOCK), elsewhere irfft_c."""
    if X.device.type == "cuda":
        return irfft_c_invariant(X, n, precision,
                                 ROW_BLOCK if block is None else block)
    return irfft_c(X, n, precision)


def rfft_c(x, precision=None):
    """numpy-convention rfft of the last axis as a complex tensor
    (torch.fft; bfloat16 and float16 inputs are taken in float32).
    precision is checked as for the matmul DFTs (the JAX signature) and
    changes nothing here: cuFFT has no TF32 arm."""
    check_dft_precision(precision)
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return torch.fft.rfft(x, dim=-1)


def irfft_c(X, n=None, precision=None):
    """Inverse of rfft_c: complex (..., nharm) -> real (..., n), the
    spectrum zero-padded or cut to n // 2 + 1 harmonics.  precision as
    rfft_c's."""
    check_dft_precision(precision)
    return torch.fft.irfft(X, n=n, dim=-1)


def rfft_sr(x, precision=None):
    """Split-real rfft of the last axis: (..., n) -> (Re, Im), each
    (..., n//2+1) real, through torch.fft (the JAX package's arm for
    backends with a working FFT).  precision is checked as for the
    matmul DFTs and changes nothing here."""
    check_dft_precision(precision)
    X = torch.fft.rfft(x, dim=-1)
    return X.real, X.imag


def irfft_sr(Xr, Xi, n=None, precision=None):
    """Inverse of rfft_sr: (Re, Im) -> (..., n) real."""
    check_dft_precision(precision)
    return torch.fft.irfft(torch.complex(Xr, Xi), n=n, dim=-1)
