"""Fused DFT -> cross-spectrum hot path (counterpart of pulseportraiture_tpu/ops/fused.py).

The wideband fit's prepare stage needs, per (subint, channel), only the
weighted cross-spectrum Xr/Xi and the model power S0 (or the full
weighted model power M2w on the scattering lane); the four DFT products
dr/di/mr/mi in between are pure traffic.  Two implementations of the
same function live here:

- :func:`fused_cross_spectrum_cuda` — the hand-written Hopper kernel
  (csrc/fused_cross_spectrum.cu), the port of the TPU Pallas kernel
  ``fused_cross_spectrum_pallas``.  It runs for CUDA tensors, and only
  for them; a build or launch failure raises.
- :func:`fused_cross_spectrum_ref` — the plain PyTorch version, a
  mirror of the JAX package's hand-blocked scan: the same zero-padded
  channel tiling and the same host-built twiddles (ops.fourier).  It
  is the CPU implementation and the kernel's oracle on the card.

The kernel has two arms, chosen by a rule on the shape (:func:`fft_arm`):
an nbin in [FFT_NBIN_MIN, FFT_NBIN_MAX] = [16, 8192] with no prime factor
other than 2, 3 and 5 and a harmonic window K <= nbin/2 + 1 takes the
FFT arm (csrc/fft_smem.cuh: a mixed-radix 2/3/4/5/8 real FFT of the rows
in shared memory, two rows per complex transform), every other shape
the GEMM arm (csrc/fcs_gemm.cuh: the DFT as a matrix product, in
float32 three TF32 products per FP32 product on the tensor cores, in
float64 a SIMT GEMM).  A failed build or launch of either arm raises;
neither falls back to the other, nor the float32 GEMM to the SIMT one.

:func:`fused_cross_spectrum` dispatches by the device the tensors are
on.  Inputs carry an optional leading batch (subint) dimension: port
(B, nchan, nbin) against a shared (nchan, nbin) template or per-element
(B, nchan, nbin) models, with weights (B, nchan, K) or shared
(nchan, K).  The shared template is never broadcast in memory.

The streaming lane's sub-byte raw buckets take the decode-fused form
of the same stage (B2), :func:`fused_decode_cross_spectrum`: packed
1/2/4-bit rows -> unpack -> affine decode -> min-window baseline ->
the Parseval rows and the same cross-spectrum, with the kernel
csrc/fused_decode_cross_spectrum.cu (the same two arms) for CUDA
tensors and :func:`fused_decode_cross_spectrum_ref` for CPU tensors.
"""

import ctypes
import hashlib
import os
import threading
import time

import numpy as np
import torch

from .. import config
from .fourier import (_dtype_str, check_dft_precision, device_weights,
                      rfft_mm, use_dft_fold)
from .noise import baseline_window

__all__ = ["fused_cross_spectrum", "fused_cross_spectrum_ref",
           "fused_cross_spectrum_cuda", "fused_decode_cross_spectrum",
           "fused_decode_cross_spectrum_ref",
           "fused_decode_cross_spectrum_cuda", "decode_rows_cuda",
           "fused_block_default", "kernel_launches",
           "reset_kernel_launches", "build_kernels", "fft_arm",
           "FFT_NBIN_MIN", "FFT_NBIN_MAX"]

# Channel-block target of the plain version's tiling (the scan's).
_BLOCK_TARGET = 32

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SOURCES = [os.path.join(_CSRC, "fused_cross_spectrum.cu"),
            os.path.join(_CSRC, "fused_decode_cross_spectrum.cu")]
# included by both sources; they are part of the build's digest, so
# editing a header builds a new library
_HEADERS = [os.path.join(_CSRC, "fcs_gemm.cuh"),
            os.path.join(_CSRC, "fft_smem.cuh")]
# where build_kernels keeps the library, one subdirectory per digest of
# its sources, headers and flags; utils.device.enable_compile_cache
# (--compile-cache, PPT_COMPILE_CACHE) points it at a shared directory
DEFAULT_BUILD_DIR = os.path.join(_REPO, "build", "torch_kernels")
BUILD_DIR = DEFAULT_BUILD_DIR

# the FFT arm's range of nbin (csrc/fft_smem.cuh FFT_MIN_N, FFT_MAX_N),
# in float32 and float64
FFT_NBIN_MIN, FFT_NBIN_MAX = 16, 8192

_KERNELS = ("fused_cross_spectrum", "fused_decode_cross_spectrum")
# kernel launches since the last reset, counted where the wrapper
# launches the kernel and nowhere else: each kernel's total, its arms'
# ("<name>.fft", "<name>.gemm") and, for B1, the launches of its want_m2
# form ("fused_cross_spectrum.m2", the scattering lane's)
_launches = {f"{k}{arm}": 0 for k in _KERNELS
             for arm in ("", ".fft", ".gemm")}
_launches["fused_cross_spectrum.m2"] = 0


def kernel_launches():
    """{kernel name or "<name>.<arm>": launches since the last reset}."""
    return dict(_launches)


def reset_kernel_launches():
    for k in _launches:
        _launches[k] = 0


def _count(kernel, arm, m2=False):
    _launches[kernel] += 1
    _launches[f"{kernel}.{arm}"] += 1
    if m2:
        _launches[f"{kernel}.m2"] += 1


def _five_smooth(n):
    """Whether n > 0 has no prime factor other than 2, 3 and 5."""
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def fft_arm(nbin, nharm):
    """The shape rule between the kernels' arms: True (the FFT arm) for an
    nbin in [FFT_NBIN_MIN, FFT_NBIN_MAX] with no prime factor other than
    2, 3 and 5 and a harmonic window nharm <= nbin/2 + 1, False (the GEMM
    arm) otherwise."""
    nbin, nharm = int(nbin), int(nharm)
    return (FFT_NBIN_MIN <= nbin <= FFT_NBIN_MAX and _five_smooth(nbin)
            and nharm <= nbin // 2 + 1)


def fused_block_default():
    """config.fused_block when set, else the built-in target."""
    b = config.fused_block
    if b is None:
        return _BLOCK_TARGET
    b = int(b)
    if b < 1:
        raise ValueError(
            f"config.fused_block must be a positive int or None; got {b!r}")
    return b


def _block_size(nchan, target=None):
    """Channel-tile size of the plain version: the target (explicit >
    config.fused_block > built-in), clamped to nchan.  A ragged channel
    count is zero-padded up to a tile multiple."""
    if target is None:
        target = fused_block_default()
    return min(int(target), int(nchan))


def fused_cross_spectrum(port, model, w, nharm, precision=None, fold=None,
                         want_m2=False, block=None):
    """Windowed split-real DFT of data and model -> weighted cross
    spectrum (+ model power), never materializing dr/di/mr/mi.

    port: (..., nchan, nbin); model: (nchan, nbin) shared or the same
    shape as port; w: (..., nchan, nharm) weights already sliced to the
    harmonic window (or shared (nchan, nharm)).  Returns (Xr, Xi, S0)
    with S0 (..., nchan), or (Xr, Xi, M2w) when want_m2.

    CUDA tensors run the hand-written kernel; CPU tensors the plain
    version.  block only shapes the plain version's tiling.  fold (None:
    config.dft_fold) shapes the plain version and, on CUDA, only the
    float64 GEMM arm: the float32 GEMM arm folds every even nbin >= 8
    whatever it says, and the FFT arm never folds."""
    if port.device.type == "cuda":
        return fused_cross_spectrum_cuda(port, model, w, nharm,
                                         precision=precision, fold=fold,
                                         want_m2=want_m2)
    if port.device.type != "cpu":
        raise ValueError(f"fused_cross_spectrum: unsupported device "
                         f"{port.device}")
    return fused_cross_spectrum_ref(port, model, w, nharm,
                                    precision=precision, fold=fold,
                                    want_m2=want_m2, block=block)


def fused_cross_spectrum_ref(port, model, w, nharm, precision=None,
                             fold=None, want_m2=False, block=None):
    """The plain PyTorch version: the JAX package's scan, one channel
    tile per step, with the same zero padding and twiddles (rfft_mm).
    A shared template's per-tile DFT is computed once per tile for the
    whole batch."""
    nchan, nbin = port.shape[-2], port.shape[-1]
    cb = _block_size(nchan, block)
    nblk = -(-nchan // cb)
    pad = nblk * cb - nchan

    def padded(x):
        if not pad:
            return x
        z = x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))
        return torch.cat([x, z], dim=-2)

    pb, mb, wb = padded(port), padded(model), padded(w)
    xr, xi, o2 = [], [], []
    for i in range(nblk):
        sl = slice(i * cb, (i + 1) * cb)
        drb, dib = rfft_mm(pb[..., sl, :], precision=precision,
                           nharm=nharm, fold=fold)
        mrb, mib = rfft_mm(mb[..., sl, :], precision=precision,
                           nharm=nharm, fold=fold)
        wk = wb[..., sl, :]
        xr.append((drb * mrb + dib * mib) * wk)
        xi.append((dib * mrb - drb * mib) * wk)
        m2b = (mrb**2 + mib**2) * wk
        o2.append(m2b if want_m2 else torch.sum(m2b, dim=-1))
    Xr = torch.cat(xr, dim=-2)[..., :nchan, :]
    Xi = torch.cat(xi, dim=-2)[..., :nchan, :]
    o2 = (torch.cat(o2, dim=-2)[..., :nchan, :] if want_m2
          else torch.cat(o2, dim=-1)[..., :nchan])
    return Xr, Xi, o2


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch

_lib = None
_lib_lock = threading.Lock()


def _build_digest(flags):
    """sha1 of the kernels' sources, headers, flags and the CUDA build
    of torch: the name of the library's directory under BUILD_DIR."""
    digest = hashlib.sha1()
    for path in _SOURCES + _HEADERS:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags).encode())
    digest.update(str(torch.version.cuda).encode())
    return digest.hexdigest()[:16]


# how the last build_kernels call of this process got its library:
# {"dir": ..., "cached": True when it loaded a library already built
# there (no nvcc), "seconds": the call's wall}
build_info = {}


def build_kernels(verbose=False):
    """Compile the kernels' sources (csrc/*.cu, one object each, built in
    parallel; both include csrc/fcs_gemm.cuh and csrc/fft_smem.cuh) for
    sm_90a with torch.utils.cpp_extension.load as one library, and bind
    its plain C interface with ctypes.  No source includes PyTorch
    headers, so the build takes seconds.  The library lives in
    BUILD_DIR/<digest of the sources, headers, flags and torch's CUDA>:
    a process that finds it there loads it without calling the builder
    (the compile cache, utils.device.enable_compile_cache), and an
    edited source or header builds into a new directory.  Idempotent
    per process.  verbose prints ptxas's register, shared-memory and
    spill report (-Xptxas=-v is always passed, so a verbose and a quiet
    build of the same sources are one build)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        flags = ["-O3", "-gencode=arch=compute_90a,code=sm_90a",
                 "-Xptxas=-v"]
        name = "ppt_fused_kernels"
        out_dir = os.path.join(BUILD_DIR, _build_digest(flags))
        so = os.path.join(out_dir, f"{name}.so")
        cached = os.path.exists(so) and not verbose
        if not cached:
            from torch.utils.cpp_extension import load

            os.makedirs(out_dir, exist_ok=True)
            load(name=name, sources=_SOURCES, extra_cuda_cflags=flags,
                 build_directory=out_dir, verbose=verbose, with_cuda=True,
                 is_python_module=False)
        lib = ctypes.CDLL(so)
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        argtypes = {
            "ppt_fcs_spectrum": [vp, i64, i32, vp, vp, vp, i32, i32, i32,
                                 vp, vp, vp],
            "ppt_fcs_cross": [vp, i64, i32, vp, vp, vp, i32, i32, i32, vp,
                              vp, i64, vp, i64, vp, vp, vp, i32, vp],
            "ppt_fdcs_stats": [vp, i64, i32, i32, i32, i32, vp, vp, vp, vp,
                               vp, vp],
            "ppt_fdcs_cross": [vp, i64, i32, i32, i32, vp, vp, vp, vp, vp,
                               vp, i32, i32, i32, vp, vp, i64, vp, i64, vp,
                               vp, vp, vp],
            "ppt_fdcs_decode": [vp, i64, i32, i32, i32, vp, vp, vp, vp, vp],
            "ppt_fcs_fft_spectrum": [vp, i64, i32, vp, i32, vp, vp, vp],
            "ppt_fcs_fft_cross": [vp, i64, i32, vp, i32, vp, vp, i64, vp,
                                  i64, vp, vp, vp, i32, vp],
            "ppt_fdcs_fft": [vp, i64, i32, i32, i32, i32, vp, vp, vp, i32,
                             vp, vp, i64, vp, i64, vp, vp, vp, vp, vp, vp],
        }
        for stem, args in argtypes.items():
            for sfx in ("f32", "f64"):
                fn = getattr(lib, f"{stem}_{sfx}")
                fn.restype = i32
                fn.argtypes = args
        build_info.clear()
        build_info.update({"dir": out_dir, "cached": cached,
                           "seconds": time.perf_counter() - t0})
        _lib = lib
        return _lib


def _resolve_arm(arm, nbin, K, name):
    """'fft' or 'gemm': the shape rule when arm is None (the FFT arm for
    an nbin in [FFT_NBIN_MIN, FFT_NBIN_MAX] with no prime factor other
    than 2, 3 and 5 and nharm <= nbin/2 + 1, else the GEMM arm); 'gemm'
    may be forced for any shape, 'fft' only within the rule."""
    rule = "fft" if fft_arm(nbin, K) else "gemm"
    if arm is None or arm == rule or arm == "gemm":
        return arm or rule
    if arm == "fft":
        raise ValueError(f"{name}: the FFT arm takes an nbin in "
                         f"[{FFT_NBIN_MIN}, {FFT_NBIN_MAX}] with no prime "
                         f"factor other than 2, 3 and 5 and nharm <= "
                         f"nbin/2 + 1; got nbin={nbin}, nharm={K}")
    raise ValueError(f"{name}: arm must be None, 'fft' or 'gemm'; got "
                     f"{arm!r}")


def _gemm_weights(fold, device, nbin, dts, K):
    """(Wc, Ws, sgn, L, fold) of the GEMM arm: the direct or the folded
    DFT twiddles (fold only for even nbin >= 8) over L time samples.  In
    float32 (Wc, Ws) are the tensor cores' TF32 (hi, lo) planes
    (ops.fourier "tf32x3"), folded for every even nbin >= 8 whatever
    ``fold`` says: the fold's sums are formed as the samples are staged,
    and halve the tensor-core products (its own arithmetic, as the FFT
    arm's); float64 (the SIMT GEMM) follows ``fold`` (None:
    config.dft_fold)."""
    if dts == "float32":
        fold = nbin % 2 == 0 and nbin >= 8
        hi, lo, sgn = device_weights("tf32x3", device, nbin, K, fold)
        return hi, lo, sgn, nbin // 2 - 1 if fold else nbin, fold
    if fold is None:
        fold = use_dft_fold(device)
    fold = bool(fold) and nbin % 2 == 0 and nbin >= 8
    if fold:
        Wc, Ws, sgn = device_weights("fold", device, nbin, dts, K)
    else:
        Wc, Ws = device_weights("rfft", device, nbin, dts, K)
        sgn = Wc  # unread without fold; any valid pointer
    return Wc, Ws, sgn, Wc.shape[0], fold


def _pad_chan(t, dim=-2):
    """t with one zero channel appended along ``dim``."""
    shape = list(t.shape)
    shape[dim] = 1
    return torch.cat([t, t.new_zeros(shape)], dim=dim).contiguous()


def _odd_batch(arm, batch, nchan):
    """Whether a call must pad each subint to an even channel count: the
    FFT arm transforms real rows two at a time (one complex FFT, rows 2g
    and 2g + 1 of the flattened batch), and a pair's rounding depends on
    both of its rows, so at an odd channel count a subint's last channel
    would pair with the next subint's first and its bits would depend on
    the batch.  With one zero channel per subint every pair stays within
    its subint (ROADMAP C8)."""
    return arm == "fft" and nchan % 2 == 1 and len(batch) > 0 \
        and int(np.prod(batch)) > 1


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def fused_cross_spectrum_cuda(port, model, w, nharm, precision=None,
                              fold=None, want_m2=False, arm=None):
    """The hand-written Hopper kernel (csrc/fused_cross_spectrum.cu).

    Two launches per call: the model spectrum (once for a shared
    template, else per element) into scratch, then the data transform
    with the cross-spectrum and the S0 row sum (or M2w) formed in its
    epilogue.  arm None takes the shape rule of :func:`fft_arm`; 'gemm'
    forces the GEMM arm, 'fft' asserts the FFT arm.  fold shapes only
    the float64 GEMM arm (the float32 one folds every even nbin,
    _gemm_weights).  CUDA float32/float64 tensors only.  dft_precision is
    checked and computes FP32-accurate products (three TF32 products) in
    every dft_precision setting: the FFT arm in FP32, the GEMM arm's
    float32 on the tensor cores with each product split into three TF32
    products.  At an odd channel count with a batch, each subint is
    padded with one zero channel on the FFT arm (_odd_batch), so its bits
    do not depend on its neighbours."""
    name = "fused_cross_spectrum_cuda"
    check_dft_precision(precision)
    if port.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors")
    dt = port.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64, got {dt}")
    for t, tname in ((model, "model"), (w, "w")):
        if t.device != port.device or t.dtype != dt:
            raise ValueError(f"{name}: {tname} must be {dt} on "
                             f"{port.device}")
    if port.dim() not in (2, 3) or not port.is_contiguous():
        raise ValueError(f"{name}: port must be a contiguous (nchan, nbin) "
                         "or (B, nchan, nbin)")
    if not (model.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: model and w must be contiguous")
    nchan, nbin = port.shape[-2], port.shape[-1]
    K = int(nharm)
    batch = port.shape[:-2]
    M = port.numel() // nbin
    if model.shape == (nchan, nbin):
        Mm, m_mod = nchan, nchan
    elif model.shape == port.shape:
        Mm, m_mod = M, M
    else:
        raise ValueError(f"{name}: model shape {tuple(model.shape)} is "
                         f"neither (nchan, nbin) nor the port's "
                         f"{tuple(port.shape)}")
    if w.shape == (nchan, K):
        w_mod = nchan
    elif w.shape == batch + (nchan, K):
        w_mod = M
    else:
        raise ValueError(f"{name}: w shape {tuple(w.shape)} is neither "
                         f"({nchan}, {K}) nor the port's batch + "
                         f"({nchan}, {K})")
    arm = _resolve_arm(arm, nbin, K, name)
    if _odd_batch(arm, batch, nchan):
        Xr, Xi, o2 = fused_cross_spectrum_cuda(
            _pad_chan(port), _pad_chan(model), _pad_chan(w), K,
            precision=precision, fold=fold, want_m2=want_m2, arm=arm)
        keep = (slice(None),) * (Xr.dim() - 2) + (slice(0, nchan),)
        return (Xr[keep].contiguous(), Xi[keep].contiguous(),
                o2[keep].contiguous() if want_m2
                else o2[..., :nchan].contiguous())
    dts = _dtype_str(dt)
    lib = build_kernels()
    sfx = "f32" if dt == torch.float32 else "f64"
    stream = torch.cuda.current_stream(port.device).cuda_stream

    mr = torch.empty((Mm, K), dtype=dt, device=port.device)
    mi = torch.empty_like(mr)
    Xr = torch.empty(batch + (nchan, K), dtype=dt, device=port.device)
    Xi = torch.empty_like(Xr)
    o2 = torch.empty(batch + ((nchan, K) if want_m2 else (nchan,)),
                     dtype=dt, device=port.device)
    outs = (Xr.data_ptr(), Xi.data_ptr(), o2.data_ptr(), int(bool(want_m2)))
    if arm == "fft":
        tw, = device_weights("fft", port.device, nbin, dts)
        _check(getattr(lib, f"ppt_fcs_fft_spectrum_{sfx}")(
            model.data_ptr(), Mm, nbin, tw.data_ptr(), K, mr.data_ptr(),
            mi.data_ptr(), stream), "fused_cross_spectrum FFT spectrum")
        _count("fused_cross_spectrum", arm, want_m2)
        _check(getattr(lib, f"ppt_fcs_fft_cross_{sfx}")(
            port.data_ptr(), M, nbin, tw.data_ptr(), K, mr.data_ptr(),
            mi.data_ptr(), m_mod, w.data_ptr(), w_mod, *outs, stream),
            "fused_cross_spectrum FFT cross")
        _count("fused_cross_spectrum", arm, want_m2)
        return Xr, Xi, o2
    Wc, Ws, sgn, L, fold = _gemm_weights(fold, port.device, nbin, dts, K)
    _check(getattr(lib, f"ppt_fcs_spectrum_{sfx}")(
        model.data_ptr(), Mm, nbin, Wc.data_ptr(), Ws.data_ptr(),
        sgn.data_ptr(), L, K, int(fold), mr.data_ptr(), mi.data_ptr(),
        stream), "fused_cross_spectrum spectrum")
    _count("fused_cross_spectrum", arm, want_m2)
    _check(getattr(lib, f"ppt_fcs_cross_{sfx}")(
        port.data_ptr(), M, nbin, Wc.data_ptr(), Ws.data_ptr(),
        sgn.data_ptr(), L, K, int(fold), mr.data_ptr(), mi.data_ptr(),
        m_mod, w.data_ptr(), w_mod, *outs, stream),
        "fused_cross_spectrum cross")
    _count("fused_cross_spectrum", arm, want_m2)
    return Xr, Xi, o2


# ---------------------------------------------------------------------------
# B2: the decode-fused form for sub-byte packed raw rows

def _packed_geometry(code, nbin, name):
    """(nbit, bytes per channel) of a packed code, refusing what the
    per-channel byte tiling cannot carry (the JAX kernel's messages)."""
    from .decode import PACKED_BITS

    nbit = PACKED_BITS.get(code)
    if nbit is None:
        raise ValueError(f"{name}: packed sub-byte codes only (got "
                         f"{code!r})")
    if (nbin * nbit) % 8 != 0:
        raise ValueError(f"{name}: nbin*nbit must be byte-aligned per "
                         f"channel (nbin={nbin}, nbit={nbit})")
    return nbit, (nbin * nbit) // 8


def fused_decode_cross_spectrum(raw, scl, offs, model, w, nharm, *, code,
                                nbin, precision=None, fold=None,
                                block=None):
    """Sub-byte packed rows -> bit-plane unpack -> affine decode ->
    min-window baseline -> the Parseval rows and the windowed
    cross-spectrum, never materializing the decoded portrait.

    raw: (..., nchan, bpc) uint8, each channel's packed bytes a row
    (bpc = nbin * nbit / 8); scl/offs: (..., nchan) DAT_SCL/DAT_OFFS;
    model: (nchan, nbin) shared template; w: (..., nchan, nharm) or
    shared (nchan, nharm) weights sliced to the harmonic window, whose
    dtype is the compute dtype.  code: 'p1' | 'p2' | 'p4'.  Returns
    (Xr, Xi, S0, pwr, x0): the cross-spectrum triple, the mean-removed
    time-domain power (with the Nyquist term for even nbin) and the
    channel sum of the decoded, baselined samples.

    CUDA tensors run the hand-written kernel; CPU tensors the plain
    version.  block only shapes the plain version's tiling; fold as
    :func:`fused_cross_spectrum`'s (on CUDA it shapes only the float64
    GEMM arm)."""
    if raw.device.type == "cuda":
        return fused_decode_cross_spectrum_cuda(
            raw, scl, offs, model, w, nharm, code=code, nbin=nbin,
            precision=precision, fold=fold)
    if raw.device.type != "cpu":
        raise ValueError(f"fused_decode_cross_spectrum: unsupported "
                         f"device {raw.device}")
    return fused_decode_cross_spectrum_ref(
        raw, scl, offs, model, w, nharm, code=code, nbin=nbin,
        precision=precision, fold=fold, block=block)


def fused_decode_cross_spectrum_ref(raw, scl, offs, model, w, nharm, *,
                                    code, nbin, precision=None, fold=None,
                                    block=None):
    """The plain PyTorch version: decode_stokes_I on the rows, then
    fused_cross_spectrum_ref, then the Parseval rows with
    fit.portrait._parseval_Sd's per-channel operations."""
    from .decode import decode_stokes_I

    _packed_geometry(code, nbin, "fused_decode_cross_spectrum_ref")
    dt = w.dtype
    x = decode_stokes_I(raw.reshape(raw.shape[:-2] + (-1,)), scl, offs, dt,
                        code=code, nbin=nbin)
    Xr, Xi, S0 = fused_cross_spectrum_ref(x, model.to(dt), w, nharm,
                                          precision=precision, fold=fold,
                                          block=block)
    x0 = torch.sum(x, dim=-1)
    mu = x0 / nbin
    pwr = nbin * torch.sum((x - mu[..., None]) ** 2, dim=-1)
    if nbin % 2 == 0:
        sgn = torch.tensor((-1.0) ** np.arange(nbin), dtype=dt,
                           device=x.device)
        pwr = pwr + torch.sum(x * sgn, dim=-1) ** 2
    return Xr, Xi, S0, pwr, x0


def _packed_args(raw, scl, offs, code, nbin, dt, name):
    """Checked (nbit, bpc, M, scl, offs) of a CUDA packed-row call."""
    nbit, bpc = _packed_geometry(code, nbin, name)
    if raw.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64, got {dt}")
    if raw.dtype != torch.uint8 or raw.dim() < 2 \
            or raw.shape[-1] != bpc or not raw.is_contiguous():
        raise ValueError(f"{name}: raw must be a contiguous uint8 "
                         f"(..., nchan, {bpc}) tensor; got {raw.dtype} "
                         f"{tuple(raw.shape)}")
    rows = raw.shape[:-1]
    out = []
    for t, tname in ((scl, "scl"), (offs, "offs")):
        if t.shape != rows or t.device != raw.device:
            raise ValueError(f"{name}: {tname} must be {tuple(rows)} on "
                             f"{raw.device}; got {tuple(t.shape)}")
        out.append(t.to(dt).contiguous())
    return nbit, bpc, raw.numel() // bpc, out[0], out[1]


def fused_decode_cross_spectrum_cuda(raw, scl, offs, model, w, nharm, *,
                                     code, nbin, precision=None, fold=None,
                                     arm=None):
    """The hand-written Hopper kernel (csrc/fused_decode_cross_spectrum.cu).

    FFT arm (:func:`fft_arm`): two launches per call, the template's
    spectrum (B1's FFT spectrum launch) and one kernel that decodes a
    block of rows in shared memory, takes their baselines, Parseval rows
    and FFTs there and forms the cross-spectrum and S0.  GEMM arm: three
    launches, the per-row stats (baseline, x0, pwr), B1's GEMM spectrum
    launch for the template, and the GEMM that decodes the rows as it
    stages them.  arm None takes the shape rule; 'gemm' forces the GEMM
    arm, 'fft' asserts the FFT arm.  fold shapes only the float64 GEMM
    arm, as B1's.
    CUDA tensors only; the compute dtype (w's) is float32 or float64;
    dft_precision as B1's (FP32-accurate products); an odd channel count
    with a batch is padded as B1's (_odd_batch)."""
    name = "fused_decode_cross_spectrum_cuda"
    dt = w.dtype
    nbit, bpc, M, scl, offs = _packed_args(raw, scl, offs, code, nbin, dt,
                                           name)
    check_dft_precision(precision)
    nchan = raw.shape[-2]
    batch = raw.shape[:-2]
    K = int(nharm)
    if model.shape != (nchan, nbin) or model.dtype != dt \
            or model.device != raw.device or not model.is_contiguous():
        raise ValueError(f"{name}: model must be a contiguous {dt} "
                         f"({nchan}, {nbin}) tensor on {raw.device}")
    if w.device != raw.device or not w.is_contiguous():
        raise ValueError(f"{name}: w must be contiguous on {raw.device}")
    if w.shape == (nchan, K):
        w_mod = nchan
    elif w.shape == batch + (nchan, K):
        w_mod = M
    else:
        raise ValueError(f"{name}: w shape {tuple(w.shape)} is neither "
                         f"({nchan}, {K}) nor the rows' batch + "
                         f"({nchan}, {K})")
    arm = _resolve_arm(arm, nbin, K, name)
    if _odd_batch(arm, batch, nchan):
        outs = fused_decode_cross_spectrum_cuda(
            _pad_chan(raw), _pad_chan(scl, -1), _pad_chan(offs, -1),
            _pad_chan(model), _pad_chan(w), K, code=code, nbin=nbin,
            precision=precision, fold=fold, arm=arm)
        keep = (slice(None),) * (outs[0].dim() - 2) + (slice(0, nchan),)
        return (outs[0][keep].contiguous(), outs[1][keep].contiguous(),
                *(o[..., :nchan].contiguous() for o in outs[2:]))
    dts = _dtype_str(dt)
    lib = build_kernels()
    sfx = "f32" if dt == torch.float32 else "f64"
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    dev = raw.device
    kname = "fused_decode_cross_spectrum"
    x0 = torch.empty(batch + (nchan,), dtype=dt, device=dev)
    pwr = torch.empty_like(x0)
    mr = torch.empty((nchan, K), dtype=dt, device=dev)
    mi = torch.empty_like(mr)
    Xr = torch.empty(batch + (nchan, K), dtype=dt, device=dev)
    Xi = torch.empty_like(Xr)
    S0 = torch.empty(batch + (nchan,), dtype=dt, device=dev)
    win = baseline_window(nbin)
    if arm == "fft":
        tw, = device_weights("fft", dev, nbin, dts)
        _check(getattr(lib, f"ppt_fcs_fft_spectrum_{sfx}")(
            model.data_ptr(), nchan, nbin, tw.data_ptr(), K, mr.data_ptr(),
            mi.data_ptr(), stream), f"{kname} FFT spectrum")
        _count(kname, arm)
        _check(getattr(lib, f"ppt_fdcs_fft_{sfx}")(
            raw.data_ptr(), M, nbin, bpc, nbit, win, scl.data_ptr(),
            offs.data_ptr(), tw.data_ptr(), K, mr.data_ptr(), mi.data_ptr(),
            nchan, w.data_ptr(), w_mod, Xr.data_ptr(), Xi.data_ptr(),
            S0.data_ptr(), x0.data_ptr(), pwr.data_ptr(), stream),
            f"{kname} FFT")
        _count(kname, arm)
        return Xr, Xi, S0, pwr, x0
    Wc, Ws, sgn, L, fold = _gemm_weights(fold, dev, nbin, dts, K)
    base = torch.empty(M, dtype=dt, device=dev)
    _check(getattr(lib, f"ppt_fdcs_stats_{sfx}")(
        raw.data_ptr(), M, nbin, bpc, nbit, win, scl.data_ptr(),
        offs.data_ptr(), base.data_ptr(), x0.data_ptr(), pwr.data_ptr(),
        stream), f"{kname} stats")
    _count(kname, arm)
    _check(getattr(lib, f"ppt_fcs_spectrum_{sfx}")(
        model.data_ptr(), nchan, nbin, Wc.data_ptr(), Ws.data_ptr(),
        sgn.data_ptr(), L, K, int(fold), mr.data_ptr(), mi.data_ptr(),
        stream), f"{kname} spectrum")
    _count(kname, arm)
    _check(getattr(lib, f"ppt_fdcs_cross_{sfx}")(
        raw.data_ptr(), M, nbin, bpc, nbit, scl.data_ptr(),
        offs.data_ptr(), base.data_ptr(), Wc.data_ptr(), Ws.data_ptr(),
        sgn.data_ptr(), L, K, int(fold), mr.data_ptr(), mi.data_ptr(),
        nchan, w.data_ptr(), w_mod, Xr.data_ptr(), Xi.data_ptr(),
        S0.data_ptr(), stream), f"{kname} cross")
    _count(kname, arm)
    return Xr, Xi, S0, pwr, x0


def decode_rows_cuda(raw, scl, offs, base, *, code, nbin, dtype):
    """The samples B2 stages (both arms decode with the same device
    function), written out: (..., nchan, bpc) packed rows ->
    (..., nchan, nbin) x = s scl + offs - base in ``dtype``, by the
    kernel's own decode.  A check of the kernel against the plain
    decode; the fused path never calls it, and it counts no launch."""
    name = "decode_rows_cuda"
    nbit, bpc, M, scl, offs = _packed_args(raw, scl, offs, code, nbin,
                                           dtype, name)
    base = base.to(dtype).contiguous()
    if base.numel() != M:
        raise ValueError(f"{name}: base needs one value per row ({M})")
    out = torch.empty(raw.shape[:-1] + (nbin,), dtype=dtype,
                      device=raw.device)
    lib = build_kernels()
    sfx = "f32" if dtype == torch.float32 else "f64"
    _check(getattr(lib, f"ppt_fdcs_decode_{sfx}")(
        raw.data_ptr(), M, nbin, bpc, nbit, scl.data_ptr(), offs.data_ptr(),
        base.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(raw.device).cuda_stream), name)
    return out
