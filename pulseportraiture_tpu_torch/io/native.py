"""ctypes loader for the native SUBINT decode kernels (native/).

The C++ source ``native/ppt_native.cpp`` is shared with the JAX
package; this loader builds it lazily with g++ into the port's own
build directory (``build/native/`` at the repository root, listed in
.gitignore), never next to the source.  Every entry point degrades
gracefully to the pure-numpy path in ``psrfits.read_archive`` when no
compiler or binary is available, so the package stays importable on
any host.  Plain ctypes over an ``extern "C"`` surface.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "ppt_native.cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "native")
_SO = os.path.join(_BUILD_DIR, "libppt_native.so")

# DATA-column sample types, matching the enum in ppt_native.cpp
CODE_I16BE, CODE_U8, CODE_F32BE, CODE_I8 = 0, 1, 2, 3
_TFORM_CODE = {"I": CODE_I16BE, "B": CODE_U8, "E": CODE_F32BE}

_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build under a temporary name and rename: a concurrent loader
    # (another test worker) never sees a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_SO) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
            ):
                _build()
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.SubprocessError):
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f8p = ctypes.POINTER(ctypes.c_double)
        lib.ppt_decode_fused.restype = ctypes.c_int
        lib.ppt_decode_fused.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, f8p, f8p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.ppt_gather_f.restype = ctypes.c_int
        lib.ppt_gather_f.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, f8p,
        ]
        _lib = lib
        return _lib


def available():
    return _load() is not None


def decode_fused(raw, nrows, row_stride, col_off, tform_code, npol, nchan,
                 nbin, scl=None, offs=None, dtype=np.float64):
    """Decode the DATA column from raw bintable bytes and apply
    DAT_SCL/DAT_OFFS in one fused, threaded pass.

    raw: bytes/buffer of the table payload; scl/offs: (nrows, npol*nchan)
    float64 or None.  Returns (nrows, npol, nchan, nbin) in ``dtype``
    (float32 or float64).  Raises ValueError for unsupported sample
    types; returns None if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    if tform_code not in _TFORM_CODE:
        raise ValueError(f"unsupported DATA TFORM code {tform_code!r}")
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError("dtype must be float32 or float64")
    ngrp = npol * nchan
    rawbuf = np.frombuffer(raw, np.uint8)
    out = np.empty((nrows, npol, nchan, nbin), dtype)

    def f8ptr(a):
        if a is None:
            return None
        a = np.ascontiguousarray(a, np.float64)
        if a.size != nrows * ngrp:
            raise ValueError(
                f"scale/offset size {a.size} != nrows*npol*nchan "
                f"{nrows * ngrp}")
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    s = f8ptr(scl)
    o = f8ptr(offs)
    rc = lib.ppt_decode_fused(
        rawbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nrows, row_stride, col_off, ngrp, nbin,
        s[1] if s else None, o[1] if o else None,
        _TFORM_CODE[tform_code],
        1 if dtype == np.dtype(np.float64) else 0,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise RuntimeError(f"ppt_decode_fused failed with code {rc}")
    return out
