"""Per-device capability record and the tuning DB's backend key
(counterpart of pulseportraiture_tpu/tune/capability.py).

- :func:`backend_fingerprint` is the stable identity of a device:
  ``"<type>:<device name>:torch-<version>"``.  The tuning DB
  (tune/store.py) is keyed by it, so winners measured on one card and
  torch build are never applied to another; a DB the JAX package wrote
  carries a ``jax-`` fingerprint and is refused here.
- :func:`capability_record` derives a :class:`CapabilityRecord` once per
  fingerprint and caches it: the static fields from the device table,
  plus three cheap measured probes on the record's device (the dispatch
  floor, a 256 x 256 float32 matmul and a 64 x 512 ``torch.fft.rfft``).
  The probes time library calls on purpose: they measure the device,
  they are not ports of a kernel.
- :func:`capability_summary` is the JSON-safe subset a serving host
  reports over the ``stat`` wire (``ToaServer.stats()["capability"]``).

:data:`KNOB_POLARITY` and :func:`resolve_auto` are the ones in
device.py, re-exported: the port has one tri-state resolver.
"""

import math
import threading
import time
from typing import NamedTuple, Optional

import torch

from ..device import KNOB_POLARITY, resolve_auto, resolve_device

__all__ = ["KNOB_POLARITY", "CapabilityRecord", "backend_fingerprint",
           "capability_record", "capability_summary", "resolve_auto"]


class CapabilityRecord(NamedTuple):
    """What one device can do and what it measures (one per fingerprint
    per process).  The ``*_s`` / ``*_gflops`` fields are None until
    :func:`capability_record` runs with ``probe=True`` (the default)."""

    fingerprint: str
    platform: str           # torch device type: 'cuda' or 'cpu'
    device_kind: str        # torch.cuda.get_device_name, or 'cpu'
    n_devices: int
    kernels_loaded: bool    # the port's CUDA kernels built and loaded
    preferred_cross_dtype: str   # cross-spectrum accumulation dtype
    subbyte_unpack: bool    # sub-byte samples decoded on the device (B2)
    sm: Optional[str]       # CUDA compute capability, e.g. 'sm_90'
    torch_version: str
    cuda_version: Optional[str]
    dispatch_floor_s: Optional[float]   # measured per-dispatch floor
    matmul_gflops: Optional[float]      # 256 x 256 float32 matmul probe
    dft_gflops: Optional[float]         # 64 x 512 rfft probe

    def wire_summary(self):
        """The JSON-safe subset a serving host reports over the ``stat``
        wire: the JAX summary's keys (with ``kernels_loaded`` for its
        ``pallas_available``) and the keys the port's wire carried
        before (``sm``, ``torch``, ``cuda``)."""
        return {"fingerprint": self.fingerprint,
                "platform": self.platform,
                "device_kind": self.device_kind,
                "n_devices": self.n_devices,
                "kernels_loaded": self.kernels_loaded,
                "matmul_gflops": self.matmul_gflops,
                "sm": self.sm,
                "torch": self.torch_version,
                "cuda": self.cuda_version}


def _device_kind(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def backend_fingerprint(device=None):
    """Stable identity of ``device`` (None: the default CUDA device):
    device type + device name + torch version.  The tuning DB key:
    winners measured on one fingerprint are refused on any other."""
    dev = resolve_device(device)
    return f"{dev.type}:{_device_kind(dev)}:torch-{torch.__version__}"


def _kernels_loaded():
    """Whether the CUDA kernels are already built and loaded in this
    process (reading it never triggers a build)."""
    from ..ops import fused

    return fused._lib is not None


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _probe_dispatch_floor(dev, nrun=3, K=4):
    """Min-of-N slope of a trivial dispatch: the per-dispatch floor in
    seconds (profiling.devtime's estimator, inlined)."""
    x = torch.zeros(8, dtype=torch.float32, device=dev)
    y = x + 1.0
    _sync(dev)
    best = None
    for _ in range(nrun):
        t0 = time.perf_counter()
        y = x + 1.0
        _sync(dev)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        y = x
        for _ in range(K):
            y = y + 1.0
        _sync(dev)
        tK = time.perf_counter() - t0
        slope = (tK - t1) / (K - 1)
        if slope <= 0.0:
            slope = tK / K
        best = slope if best is None else min(best, slope)
    del y
    return best


def _min_wall(fn, dev, nrun=3):
    fn()
    _sync(dev)
    best = None
    for _ in range(nrun):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def _probe_matmul_gflops(dev, n=256, nrun=3):
    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    best = _min_wall(lambda: a @ a, dev, nrun)
    return (2.0 * n ** 3 / max(best, 1e-9)) / 1e9


def _probe_dft_gflops(dev, nchan=64, nbin=512, nrun=3):
    x = torch.ones((nchan, nbin), dtype=torch.float32, device=dev)
    best = _min_wall(lambda: torch.fft.rfft(x, dim=-1), dev, nrun)
    flops = 5.0 * nchan * nbin * math.log2(max(nbin, 2))
    return (flops / max(best, 1e-9)) / 1e9


_cache_lock = threading.Lock()
_cached = {}   # fingerprint -> CapabilityRecord


def capability_record(probe=True, device=None):
    """The process-wide :class:`CapabilityRecord` of ``device`` (None:
    the default CUDA device), derived once per fingerprint and cached.
    ``probe=False`` skips the timing probes on a cold cache (fields stay
    None); a later ``probe=True`` call replaces the cached record with a
    probed one."""
    dev = resolve_device(device)
    fp = backend_fingerprint(dev)
    with _cache_lock:
        rec = _cached.get(fp)
    if rec is not None and (rec.dispatch_floor_s is not None or not probe):
        loaded = _kernels_loaded()
        if rec.kernels_loaded != loaded:   # built since the record
            rec = rec._replace(kernels_loaded=loaded)
            with _cache_lock:
                _cached[fp] = rec
        return rec
    cuda = dev.type == "cuda"
    if cuda:
        major, minor = torch.cuda.get_device_capability(dev)
        sm, n_devices = f"sm_{major}{minor}", torch.cuda.device_count()
    else:
        sm, n_devices = None, 1
    rec = CapabilityRecord(
        fingerprint=fp,
        platform=dev.type,
        device_kind=_device_kind(dev),
        n_devices=n_devices,
        kernels_loaded=_kernels_loaded(),
        # the kernels accumulate the cross-spectrum in float32 on the
        # card; the CPU keeps the float64 reference spelling
        preferred_cross_dtype="complex64" if cuda else "complex128",
        subbyte_unpack=cuda,
        sm=sm,
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda,
        dispatch_floor_s=_probe_dispatch_floor(dev) if probe else None,
        matmul_gflops=_probe_matmul_gflops(dev) if probe else None,
        dft_gflops=_probe_dft_gflops(dev) if probe else None,
    )
    with _cache_lock:
        _cached[fp] = rec
    return rec


def capability_summary(device=None):
    """JSON-safe record summary for the stat wire (static fields only on
    a cold cache: a stat handler must not pay probe latency)."""
    return capability_record(probe=False, device=device).wire_summary()
