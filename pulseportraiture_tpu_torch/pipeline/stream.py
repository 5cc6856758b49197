"""Cross-archive streaming TOA measurement, the campaign driver (counterpart of pulseportraiture_tpu/pipeline/stream.py).

GetTOAs fits one archive at a time.  This driver POOLS usable subints
across archives into shape buckets, keyed by (nchan, nbin, channel
frequencies, effective fit flags, payload kind), and fires one batched
fit per full bucket:

- archive IO runs ahead of the consumer on prefetch threads;
- full buckets are dealt round-robin across ``stream_devices`` (default:
  every visible CUDA device), each with a bounded in-flight queue of at
  most ``max_inflight`` dispatches; the host drains whichever device's
  oldest dispatch is ready, and ``.tim`` checkpoints are written in
  archive order, so output does not depend on the device count;
- in raw mode the host never decodes the data: the undecoded DATA
  column (int16, bytes, float32, or sub-byte NBIT=1/2/4 samples PACKED)
  ships to the device, and one bucket program decodes, baselines,
  estimates noise, S/N, nu_fit (and with scat_guess='auto' the tau
  seeds), and fits.  Sub-byte buckets of a run without scattering and
  with a harmonic window take the decode-fused stage (ops.fused kernel
  B2 on a CUDA device), which re-decodes the packed bytes inside the
  fit's DFT; every other bucket runs B1 on the decoded portrait, in its
  want_m2 form on the scattering lane;
- scattering runs (fit_scat, a tau seed, an instrumental response)
  route every bucket to the scatter-shaped engine: the complex-free
  scatter lane (fit.portrait.fast_scatter_fit_batched) where
  config.use_fast_fit resolves on, the complex engine otherwise;
- each device runs a COPY worker (stack, pin, host->device copy on a
  side CUDA stream) double-buffered against its FIT worker (the bucket
  program on its own CUDA stream), _DevicePipeline.

Archives the raw lane cannot carry (tscrunch, misaligned sub-byte pol
planes, packed + FITS-scaled columns, sub-byte + channel padding) fall
back to the host-decoded lane, as in the JAX package.

stream_narrowband_TOAs runs the same executor with a per-channel lane:
one TOA per usable channel (fit.phase_shift, or with fit_scat the
complex engine over single-channel portraits).

Channel zapping and the post-fit quality cut (quality/): with
``zap_inline`` the raw bucket program cuts channels on the noise levels
it computed (quality.excision.zap_keep_mask) before the S/N, the nu_fit
seed and the fit (B1 or B2) read the mask, and the decoded lane cuts at
prepare; ``zap_channels`` applies offline lists at load
(quality.zap_bunch); ``postfit_cut`` appends each bucket's per-channel
post-fit bad mask (quality.postfit) to its packed result.

The trace plane (telemetry.py): ``telemetry=`` (a path, a shared
Tracer, or None for config.telemetry_path) records the JAX package's
events: per-dispatch ``dispatch``/``dispatched``/``drain`` paired by a
trace-global seq (several executors may share one trace), the copy
stage's ``h2d_start``/``h2d_done`` with the codec's accounting,
per-archive prepare/skip/done/checkpoint records, fit quality, the
zap lanes' proposals, and ``run_end``.  Timestamps are taken only
around calls that already block.

The lossless transport codec (io/blockcodec.py,
config.transport_compress): the copy worker may ship an int16/byte
payload as packed narrower residuals plus per-subint minima, unpacked
exactly by the bucket program (ops.decode.decode_transport) before
the sample decode; such a bucket always takes B1 on the decoded
portrait, never the decode-fused B2.

The executor's service mode (``service=True``) is what the serving
loop (serve/server.ToaServer) runs on: one executor lives for the
process, each admitted archive brings its request's lane
(``admit(..., lane=)``), partial buckets launch on a deadline
(``flush_stale``), and the ``on_launch``/``on_archive_done`` hooks let
the owner demultiplex completions.  Every dispatch pads a partial
bucket to ``nsub_batch`` rows with copies of its first subint, as in the
JAX package, so a subint's dispatch has the same shape whichever
subints share its bucket; the pad rows reach no owner.
"""

import concurrent.futures as cf
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import config
from ..config import Dconst, scattering_alpha
from ..device import resolve_auto, resolve_device
from ..fit.portrait import (FitFlags, estimate_tau_batch, fast_fit_batched,
                            fast_fit_batched_packed,
                            fast_scatter_fit_batched, fit_portrait_batch,
                            fit_portrait_batch_fast, resolve_fit_fused,
                            resolve_harmonic_window, use_bf16_cross_spectrum,
                            use_fast_fit_default, use_scatter_compensated,
                            warn_bf16_high_snr)
from ..io.blockcodec import (CostModel, encode_rows, probe_width,
                             resolve_transport_compress)
from ..io.psrfits import read_archive
from ..io.tim import TOA, write_TOAs
from ..obs.metrics import record_h2d
from ..ops.decode import (PACKED_BITS, RAW_CODES, decode_stokes_I,
                          decode_transport)
from ..ops.fourier import (CHANNEL_ROW_BLOCK, irfft_mm, irfft_mm_invariant,
                           rfft_mm, rfft_mm_invariant, use_dft_fold)
from ..ops.noise import get_noise_PS, get_SNR
from ..telemetry import NULL_TRACER, finite, log, resolve_tracer
from ..utils.bunch import DataBunch
from .models import TemplateModel
from .toas import (DEFAULT_IR_DICT, _is_metafile, _iter_archives,
                   _read_metafile, _validate_scat_guess,
                   build_instrumental_response_FT, delta_dm_stats,
                   doppler_corrected_DM_GM, effective_fit_flags,
                   load_for_toas, scat_seed_tau0, scat_time_flags,
                   scattering_toa_flags, snr_weighted_nu_fit)

__all__ = ["stream_wideband_TOAs", "stream_narrowband_TOAs",
           "make_wideband_lane", "make_narrowband_lane",
           "checkpoint_completed", "parse_shape_key",
           "sanitize_checkpoint", "resolve_stream_devices", "bucket_pad_to",
           "CKPT_STALENESS_HORIZON"]

# Per-archive completion sentinel in incremental .tim checkpoints: a
# comment line appended AFTER an archive's TOA lines, so the last
# sentinel marks the last durably complete archive and everything after
# it is a torn tail, dropped on resume.
_DONE_PREFIX = "C ppt-done "

# Once the oldest archive with undispatched subints lags this many
# prepared archives behind, every pending bucket is force-flushed, so an
# archive stuck in a rare-shape bucket cannot defer the in-order
# checkpoint writes of everything after it.  The trigger depends only on
# the fill sequence, never on completion timing or the device count.
CKPT_STALENESS_HORIZON = 8



def checkpoint_completed(path):
    """Archive paths (absolute) recorded complete in a .tim checkpoint
    (empty for a missing file).  A sentinel counts only when its line
    is newline-terminated: a truncated final line is part of the torn
    tail."""
    if not path or not os.path.exists(path):
        return set()
    with open(path) as f:
        return {os.path.abspath(line[len(_DONE_PREFIX):].strip())
                for line in f
                if line.startswith(_DONE_PREFIX) and line.endswith("\n")}


def sanitize_checkpoint(path):
    """Truncate a .tim checkpoint after its last completion sentinel,
    dropping the partial tail an interrupted writer left, atomically
    (temp file + os.replace).  Returns the completed-archive set."""
    if not path or not os.path.exists(path):
        return set()
    with open(path) as f:
        lines = f.readlines()
    last = -1
    done = set()
    for i, line in enumerate(lines):
        if line.startswith(_DONE_PREFIX) and line.endswith("\n"):
            last = i
            done.add(os.path.abspath(line[len(_DONE_PREFIX):].strip()))
    if last + 1 < len(lines):
        tmp = path + ".ppt-sanitize"
        with open(tmp, "w") as f:
            f.writelines(lines[:last + 1])
        os.replace(tmp, path)
    return done


class _Bucket:
    """Pending subints sharing one (layout, flags, kind) key.

    kind 'dec': rows are host-decoded float ports with host noise,
    nu_fit and theta0.  kind 'raw': rows are undecoded wire samples
    (raw_code, ops.decode.RAW_CODES) with per-channel scl/offs;
    everything downstream happens in the bucket program.  pol_sum rows
    carry the two summand pols of an AA+BB/Coherence archive."""

    def __init__(self, freqs, nbin, modelx, flags, kind="dec",
                 ir_FT=None, raw_code="i16", pol_sum=False,
                 col_scaled=False):
        self.freqs = freqs          # (nchan,)
        self.nbin = int(nbin)
        self.modelx = modelx        # (nchan, nbin) host template
        self.flags = flags          # effective FitFlags tuple
        self.kind = kind
        self.ir_FT = ir_FT          # (nchan, nharm) host response or None
        self.raw_code = raw_code
        self.pol_sum = bool(pol_sum)
        self.col_scaled = bool(col_scaled)
        self._hwin = None
        self._hwin_key = object()   # never equals a config value
        self.ports = []             # 'dec': (nchan, nbin) float
        self.raw = []               # 'raw': wire samples or packed bytes
        self.scl = []
        self.offs = []
        self.tscal = []
        self.tzero = []
        self.dedisp = []            # 'raw': (DM, nu0) to re-disperse by
        self.noise = []             # 'dec'
        self.masks = []
        self.Ps = []
        self.nu_fits = []           # 'dec'
        self.theta0 = []            # 'dec'
        self.DM_guess = []          # 'raw'
        self.dfs = []
        self.owners = []            # (archive_index, isub)
        self.key = None             # the executor's bucket key
        self.lane = None            # the lane that prepared its subints

    def harmonic_window(self, device=None):
        """The template's harmonic window for a fit on ``device``,
        derived once per bucket per (config.fit_harmonic_window value,
        device) (a host rfft of the template); where it resolves to no
        window, every harmonic through the fused kernels on CUDA
        (fit.portrait.full_spectrum_window)."""
        key = (config.fit_harmonic_window, str(device))
        if key != self._hwin_key:
            self._hwin = resolve_harmonic_window(None, self.modelx,
                                                 self.nbin, device)
            self._hwin_key = key
        return self._hwin

    def __len__(self):
        return len(self.owners)

    def clear(self):
        for lst in (self.ports, self.raw, self.scl, self.offs, self.tscal,
                    self.tzero, self.dedisp, self.noise, self.masks,
                    self.Ps, self.nu_fits, self.theta0, self.DM_guess,
                    self.dfs, self.owners):
            lst.clear()


def _bucket_shape(b):
    """A bucket's shape string: layout x payload kind (raw buckets name
    their wire sample type, pol reduction and column scaling) x
    effective flag bits, e.g. '512x2048:raw:p2:11000'.  The trace's
    dispatch key and the manifest utils/device.warmup_from_manifest
    reads: :func:`parse_shape_key` is its inverse."""
    shape = f"{len(b.freqs)}x{b.nbin}:{b.kind}"
    if b.kind == "raw":
        shape += f":{b.raw_code}"
        if b.pol_sum:
            shape += ":sum2"
        if b.col_scaled:
            shape += ":tz"
    if b.flags:
        shape += ":" + "".join("1" if f else "0" for f in b.flags)
    return shape


def parse_shape_key(shape):
    """Inverse of :func:`_bucket_shape`: the bucket geometry (nchan,
    nbin, kind, raw_code, pol_sum, col_scaled, flags) of a dispatch
    shape string; flags is None for flagless (narrowband) shapes.
    Raises ValueError on anything it cannot round-trip."""
    parts = shape.split(":")
    try:
        nchan, nbin = (int(v) for v in parts[0].split("x"))
        kind = parts[1]
    except (ValueError, IndexError):
        raise ValueError(f"unparseable dispatch shape {shape!r}")
    if kind not in ("raw", "dec") or nchan < 1 or nbin < 1:
        raise ValueError(f"unparseable dispatch shape {shape!r}")
    raw_code, pol_sum, col_scaled, flags = "i16", False, False, None
    for tok in parts[2:]:
        if kind == "raw" and tok == "sum2":
            pol_sum = True
        elif kind == "raw" and tok == "tz":
            col_scaled = True
        elif kind == "raw" and tok in RAW_CODES:
            raw_code = tok
        elif tok and set(tok) <= {"0", "1"}:
            flags = tuple(c == "1" for c in tok)
        else:
            raise ValueError(
                f"unknown token {tok!r} in dispatch shape {shape!r}")
    return dict(nchan=nchan, nbin=nbin, kind=kind, raw_code=raw_code,
                pol_sum=pol_sum, col_scaled=col_scaled, flags=flags)


def bucket_pad_to(nchan, device):
    """config.bucket_pad resolved to a bucket layout's channel count:
    False (default) keeps it exact; 'auto' pads on CUDA devices; True
    always pads to the next power of two (masked pad channels add
    nothing to any fit sum)."""
    v = config.bucket_pad
    if isinstance(v, str) and v.strip().lower() != "auto":
        raise ValueError(f"config.bucket_pad must be False, 'auto' or "
                         f"True; got {v!r}")
    v = resolve_auto("bucket_pad", v, device, label="config.bucket_pad")
    if not v or nchan <= 1:
        return int(nchan)
    return 1 << (int(nchan) - 1).bit_length()


def resolve_stream_devices(value=None):
    """The torch devices buckets are dealt across.

    None reads config.stream_devices; 'auto' means every visible CUDA
    device (and raises when there is none: the CPU is only ever asked
    for, as ``['cpu']``); an int N the first N CUDA devices (an error
    when N exceeds the count, never a silent clamp); a sequence of
    devices passes through device.resolve_device."""
    if value is None:
        value = config.stream_devices
    if isinstance(value, str):
        if value.strip().lower() == "auto":
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if n == 0:
                raise RuntimeError(
                    "stream_devices='auto': no CUDA device is available; "
                    "pass stream_devices=['cpu'] (or device='cpu') to "
                    "stream on the CPU")
            return [torch.device("cuda", i) for i in range(n)]
        try:
            value = int(value)
        except ValueError:
            raise ValueError(
                "stream_devices must be 'auto', a positive device count, "
                f"or a device sequence; got {value!r}")
    if isinstance(value, (int, np.integer)):
        n = int(value)
        if n < 1:
            raise ValueError(f"stream_devices must be >= 1, got {n}")
        have = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n > have:
            raise ValueError(f"stream_devices={n} exceeds the {have} "
                             "visible CUDA device(s)")
        return [torch.device("cuda", i) for i in range(n)]
    devs = []
    for d in value:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if not devs:
        raise ValueError("stream_devices: empty device sequence")
    return devs


class _StreamExecutor:
    """The campaign scaffolding: archive iteration with prefetch and
    skip-and-continue, bucket fill and flush, the per-device bounded
    in-flight queues, per-archive completion, in-order .tim checkpoints
    with completion sentinels, and resume.  A LANE supplies the physics
    as four hooks:

      prepare(iarch, datafile, d, ok) -> (m, per_subint) or None
          m: what TOA assembly needs; per_subint: [(bucket_key,
          bucket_factory, fill)], fill(b) appends one subint and its
          (iarch, isub) owner.  None skips the archive.
      launch(bucket, pipeline, seq) -> (handle, owners, extra) or None
          admits one dispatch into the device's _DevicePipeline and
          clears the bucket; handle is the fit-stage Future.
      scatter(out, owners, extra, results): one dispatch's packed host
          output -> per-owner records.
      assemble(m, results) -> tuple whose first element is the TOA list
          (what the checkpoint writes).

    The per-device in-flight bound is exact: a queue never holds more
    than max_inflight dispatches.  Drains take ready dispatches first,
    on whichever device they finished; when every queue is full the
    host waits for the first completion among the oldest dispatches.
    Checkpoints are written in ARCHIVE order, so .tim content does not
    depend on completion order or device count.

    The feeding interface: run() calls ``admit()`` per archive of a
    fixed list; ``flush_stale()`` launches partial buckets past a
    deadline, ``flush_all``/``drain_all``/``finalize`` end a stream, and
    the ``on_launch(seq, owners, pad)`` / ``on_archive_done(iarch, m,
    out)`` hooks let an owner demultiplex completions.  A long-lived
    owner (serve/server.ToaServer) builds ONE executor with
    ``service=True`` and no datafiles, keeps it warm across requests
    (the device pipelines, their streams and workers, the allocator's
    cached blocks and the FFT plans survive), and passes each admit its
    request's ``lane``: lanes ride the buckets and the in-flight
    records, so subints of different requests share a dispatch
    whenever their bucket keys match.  In service mode the executor
    keeps no per-archive lists that grow with the requests served; the
    owner calls ``forget()`` as archives complete."""

    def __init__(self, lane, datafiles, loader, nsub_batch,
                 max_inflight=None, prefetch=True, tim_out=None,
                 resume=False, skip_archives=None, quiet=False,
                 stream_devices=None, tracer=None, pipeline_depth=None,
                 service=False):
        from ..utils.device import enable_compile_cache

        # the kernels' shared build directory (config.compile_cache_dir /
        # PPT_COMPILE_CACHE); a no-op when unset
        enable_compile_cache()
        self.lane = lane
        self.nsub_batch = int(nsub_batch)
        if max_inflight is None:
            max_inflight = config.stream_max_inflight
        self.max_inflight = max(1, int(max_inflight))
        if pipeline_depth is None:
            pipeline_depth = config.stream_pipeline_depth
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.prefetch = prefetch
        self.tim_out = tim_out
        self.quiet = quiet
        self.tracer = NULL_TRACER if tracer is None else tracer
        done = {os.path.abspath(f) for f in (skip_archives or ())}
        if tim_out:
            if resume:
                done |= sanitize_checkpoint(tim_out)
            else:
                # a fresh checkpoint: a rerun must not append onto a
                # previous campaign's lines
                open(tim_out, "w").close()
        if done:
            n0 = len(datafiles)
            datafiles = [f for f in datafiles
                         if os.path.abspath(f) not in done]
            if n0 > len(datafiles):
                if self.tracer.enabled:
                    self.tracer.emit("resume_skip",
                                     n_skipped=n0 - len(datafiles),
                                     n_remaining=len(datafiles))
                log(f"Resuming: {n0 - len(datafiles)} archive(s) already "
                    f"complete in checkpoints, {len(datafiles)} to go",
                    quiet=quiet)
        self.datafiles = datafiles
        self.loader = loader
        self.service = bool(service)
        self.on_launch = None        # hook(seq, owners, pad) per dispatch
        self.on_archive_done = None  # hook(iarch, m, out) per assembly
        self.devices = resolve_stream_devices(stream_devices)
        self.buckets = {}
        self._bucket_t0 = {}  # bucket key -> first pending fill (mono s)
        self._lane_by_iarch = {}
        self.results = {}
        self.meta = []
        self.meta_by_iarch = {}
        self.remaining = {}
        self.assembled = {}
        self.in_flight = [deque() for _ in self.devices]
        # one copy->fit pipeline per device; the closure tells its copy
        # worker whether an EARLIER dispatch of the same device was still
        # unfinished when the copy started (the link hidden behind
        # compute).  Seqs are trace-global and monotonic (the tracer's,
        # or the NULL tracer's own counter), so "earlier" holds across
        # executors sharing one trace.
        self.pipelines = [
            _DevicePipeline(dev, i, self.pipeline_depth, self.tracer,
                            (lambda seq, q=self.in_flight[i]: any(
                                r[3] < seq
                                and not _StreamExecutor._head_ready(r)
                                for r in list(q))))
            for i, dev in enumerate(self.devices)]
        self._rr = 0
        # iarch -> subints not yet launched; entries leave at zero
        self.undispatched = {}
        self._prep_idx = {}  # iarch -> prepared-archive sequence number
        self.nfit = 0
        self.fit_duration = 0.0      # blocked on dispatch completion
        self.scatter_duration = 0.0  # host-side unpack of results
        self.devices_used = set()
        self.peak_inflight = 0
        self.dispatch_shapes = {}    # bucket shape string -> dispatches
        self.dispatch_counts = [0] * len(self.devices)
        # (shape, idev) pairs dispatched; an owner may add the shapes a
        # warmup pass dispatched (utils/device.warmup_from_manifest)
        self._warm = set()
        self._ckpt_order = []
        self._ckpt_next = 0

    def _checkpoint(self, m, out):
        write_TOAs(out[0], outfile=self.tim_out, append=True)
        with open(self.tim_out, "a") as fh:
            fh.write(_DONE_PREFIX + os.path.abspath(m.datafile) + "\n")

    def _ckpt_flush(self):
        """Write completed archives to the checkpoint strictly in
        archive order."""
        if not self.tim_out:
            return
        while self._ckpt_next < len(self._ckpt_order):
            ia = self._ckpt_order[self._ckpt_next]
            if ia not in self.assembled:
                break
            m, out = self.meta_by_iarch[ia], self.assembled[ia]
            self._checkpoint(m, out)
            if self.tracer.enabled:
                # lag: archives PREPARED after this one by the time its
                # in-order write landed (the straggler signal)
                self.tracer.emit(
                    "ckpt_flush", iarch=ia, datafile=m.datafile,
                    n_toas=len(out[0]),
                    lag=len(self._ckpt_order) - 1 - self._prep_idx[ia])
            self._ckpt_next += 1

    @staticmethod
    def _head_ready(rec):
        """True when draining this record will not block: the fit
        future resolved AND the device work behind its result finished
        (the fit worker returns once the work is enqueued)."""
        h = rec[0]
        if not h.done():
            return False
        if h.exception() is not None:
            return True  # the drain propagates the failure
        return h.result().ready()

    def _drain_head(self, idev):
        """Drain device idev's oldest dispatch (blocking on it)."""
        t0 = time.time()
        handle, owners, extra, seq, lane = self.in_flight[idev].popleft()
        out = handle.result().wait()
        wait_s = time.time() - t0
        self.fit_duration += wait_s
        t1 = time.time()
        lane.scatter(out, owners, extra, self.results)
        scat_s = time.time() - t1
        self.scatter_duration += scat_s
        tr = self.tracer
        if tr.enabled:
            # timestamps only around the two calls above, which block
            # regardless of telemetry: no extra host sync
            tr.emit("drain", seq=seq, device=idev, wait_s=round(wait_s, 6),
                    scatter_s=round(scat_s, 6))
            # per-TOA quality of this dispatch (the wideband lane's
            # dict-shaped results; finite() maps NaN to JSON null)
            snrs, gofs, nfevs = [], [], []
            for ow in owners:
                r = self.results.get(ow)
                if isinstance(r, dict) and "snr" in r:
                    snrs.append(finite(r["snr"], 3))
                    gofs.append(finite(float(r["chi2"])
                                       / max(float(r["dof"]), 1.0), 4))
                    nfevs.append(int(r["nfeval"]))
            if snrs:
                tr.emit("quality", seq=seq, snr=snrs, gof=gofs, nfev=nfevs)
        touched = set()
        for iarch, _ in owners:
            if iarch in self.remaining:
                self.remaining[iarch] -= 1
            touched.add(iarch)
        for ia in touched:
            # assemble completed archives at once (host memory stays
            # O(bucket)); the checkpoint write still waits for order
            if self.remaining.get(ia) == 0 and ia not in self.assembled:
                m = self.meta_by_iarch[ia]
                out = self._lane_by_iarch.get(ia, self.lane).assemble(
                    m, self.results)
                self.assembled[ia] = out
                if tr.enabled:
                    tr.emit("archive_done", iarch=ia, datafile=m.datafile)
                for isub in m.ok:
                    self.results.pop((ia, int(isub)), None)
                self._ckpt_flush()
                if self.on_archive_done is not None:
                    # the owner's demux hook, on the draining thread,
                    # after the per-subint records folded, so the owner
                    # may forget() the archive
                    self.on_archive_done(ia, m, out)

    def _drain_ready(self):
        """Drain every dispatch that has finished, oldest first per
        device, without blocking.  Returns the count."""
        n = 0
        for idev, q in enumerate(self.in_flight):
            while q and self._head_ready(q[0]):
                self._drain_head(idev)
                n += 1
        return n

    def _drain_any(self):
        """Drain at least one dispatch: everything ready first, else the
        FIRST completion among the per-device oldest dispatches
        (unresolved futures through cf.wait, resolved ones whose device
        work still runs through a ~1 ms event poll)."""
        while True:
            if self._drain_ready():
                return
            heads = [q[0][0] for q in self.in_flight if q]
            if not heads:
                return
            futs = [h for h in heads if not h.done()]
            if futs:
                cf.wait(futs, return_when=cf.FIRST_COMPLETED, timeout=0.05)
            else:
                time.sleep(0.001)

    def _pick_device(self):
        """Next round-robin device with in-flight room, or None."""
        ndev = len(self.devices)
        for k in range(ndev):
            idev = (self._rr + k) % ndev
            if len(self.in_flight[idev]) < self.max_inflight:
                self._rr = (idev + 1) % ndev
                return idev
        return None

    def _flush(self, b):
        if len(b) == 0:
            return
        self._drain_ready()
        idev = self._pick_device()
        while idev is None:
            self._drain_any()
            idev = self._pick_device()
        tr = self.tracer
        # seq comes from the TRACER: several executors may share one
        # trace (stream_ipta_campaign), and the report pairs dispatch,
        # h2d and drain events by seq; assigned before launch so the
        # copy stage stamps its h2d events with it
        seq = tr.next_seq()
        shape = _bucket_shape(b)  # before launch clears the bucket
        n_subints = len(b)
        self._bucket_t0.pop(b.key, None)  # the deadline clock resets
        lane = b.lane if b.lane is not None else self.lane
        rec = lane.launch(b, self.pipelines[idev], seq)
        if rec is None:
            return
        self.nfit += 1
        self.dispatch_shapes[shape] = self.dispatch_shapes.get(shape, 0) + 1
        self.dispatch_counts[idev] += 1
        self.devices_used.add(idev)
        for ia, _ in rec[1]:
            if ia in self.undispatched:
                self.undispatched[ia] -= 1
                if self.undispatched[ia] == 0:
                    del self.undispatched[ia]
        q = self.in_flight[idev]
        # seq at index 3 (the copy-overlap closure reads r[3]); the lane
        # that launched the bucket scatters its result
        q.append(rec + (seq, lane))
        self.peak_inflight = max(self.peak_inflight, len(q))
        if self.on_launch is not None:
            # the owner's hook: this dispatch's owners and pad rows
            self.on_launch(seq, rec[1], (-len(rec[1])) % self.nsub_batch)
        if tr.enabled:
            # cold = first dispatch of this bucket shape on this device:
            # its fit pays the kernels' first launch there (module load,
            # FFT plans, allocator growth)
            cold = (shape, idev) not in self._warm
            self._warm.add((shape, idev))
            tr.emit("dispatch", seq=seq, device=idev, shape=shape,
                    n=n_subints, queue_depth=len(q), cold=cold)
            tr.counter("dispatches")
            tr.counter(f"dispatches_dev{idev}")
            tr.gauge_max("peak_inflight", len(q))
            # fires on the fit worker once the copy and the bucket
            # program's enqueue finished (the tracer is thread-safe)
            rec[0].add_done_callback(
                lambda f, seq=seq, idev=idev: tr.emit(
                    "dispatched", seq=seq, device=idev))

    @property
    def h2d_bytes(self):
        """Total bytes the copy stages shipped host -> device."""
        return sum(pl.h2d_bytes for pl in self.pipelines)

    @property
    def h2d_logical_bytes(self):
        """Total bytes behind those copies without the transport codec
        (equal to h2d_bytes when it never engaged)."""
        return sum(pl.h2d_logical_bytes for pl in self.pipelines)

    @property
    def codec_duration(self):
        """Total seconds the copy stages spent probing and encoding
        for the transport codec."""
        return sum(pl.codec_s for pl in self.pipelines)

    @property
    def h2d_duration(self):
        """Total seconds the copy stages spent moving bytes."""
        return sum(pl.h2d_s for pl in self.pipelines)

    @property
    def h2d_overlap_duration(self):
        """Seconds of copy time that ran while an earlier fit of the
        same device was unfinished."""
        return sum(pl.h2d_overlap_s for pl in self.pipelines)

    def _shutdown(self, wait):
        for pl in self.pipelines:
            pl.shutdown(wait)

    def admit(self, iarch, datafile, d, ok, lane=None):
        """Prepare one loaded archive through ``lane`` (default: the
        executor's own) and fill its subints into the shared buckets,
        flushing any that reaches nsub_batch.  Returns the number of
        per-subint entries, or None when the lane skipped the archive
        (it emitted the typed archive_skip)."""
        lane = self.lane if lane is None else lane
        tr = self.tracer
        t_prep = time.time()
        prep = lane.prepare(iarch, datafile, d, ok)
        if prep is None:
            tr.counter("archives_skipped")
            return None
        m, per_subint = prep
        if not self.service:
            # run()'s finalize order and the in-order checkpoint ledger;
            # a serving owner keeps its own per-request order
            self.meta.append(m)
            self._ckpt_order.append(iarch)
            self._prep_idx[iarch] = len(self._ckpt_order) - 1
        self.meta_by_iarch[iarch] = m
        self._lane_by_iarch[iarch] = lane
        self.remaining[iarch] = len(ok)
        self.undispatched[iarch] = len(per_subint)
        if tr.enabled:
            tr.emit("archive_prepare", iarch=iarch, datafile=datafile,
                    n_ok=len(ok), n_subints=len(per_subint),
                    prep_s=round(time.time() - t_prep, 6))
            tr.counter("archives_prepared")
        for key, factory, fill in per_subint:
            b = self.buckets.get(key)
            if b is None:
                b = self.buckets[key] = factory()
                b.key = key
                b.lane = lane
            fill(b)
            if key not in self._bucket_t0 and len(b):
                # the deadline clock: when the bucket's oldest pending
                # subint arrived (flush_stale); reset on every flush
                self._bucket_t0[key] = time.monotonic()
            if len(b) >= self.nsub_batch:
                self._flush(b)
        return len(per_subint)

    def flush_all(self):
        """Launch every non-empty bucket."""
        for b in self.buckets.values():
            if len(b):
                self._flush(b)

    def flush_stale(self, max_age_s):
        """The serving loop's deadline: launch each partially filled
        bucket whose oldest pending subint has waited at least
        ``max_age_s`` seconds (a bucket dispatches when full or when
        its head has waited long enough).  Returns the buckets
        flushed."""
        if not self._bucket_t0:
            return 0
        now = time.monotonic()
        n = 0
        for key, t0 in list(self._bucket_t0.items()):
            if now - t0 < max_age_s:
                continue
            b = self.buckets.get(key)
            if b is not None and len(b):
                self._flush(b)
                n += 1
            else:
                self._bucket_t0.pop(key, None)
        return n

    def oldest_bucket_age(self):
        """Seconds the oldest pending bucket entry has waited, or None
        when no bucket holds work (what a serving loop sleeps
        against)."""
        if not self._bucket_t0:
            return None
        return time.monotonic() - min(self._bucket_t0.values())

    def drain_all(self):
        """Block until every in-flight dispatch has drained."""
        while any(self.in_flight):
            self._drain_any()

    def assemble_leftover(self, iarch):
        """Assemble an archive that never completed through the drain
        (e.g. a lane admitting fewer entries than ok subints);
        idempotent."""
        if iarch in self.assembled:
            return self.assembled[iarch]
        m = self.meta_by_iarch[iarch]
        out = self._lane_by_iarch.get(iarch, self.lane).assemble(
            m, self.results)
        self.assembled[iarch] = out
        if self.tracer.enabled:
            self.tracer.emit("archive_done", iarch=iarch,
                             datafile=m.datafile)
        if self.on_archive_done is not None:
            self.on_archive_done(iarch, m, out)
        return out

    def forget(self, iarch):
        """Drop one archive's bookkeeping after its owner consumed the
        assembly: what keeps a service-mode executor's memory O(live
        requests), not O(requests ever served)."""
        self.meta_by_iarch.pop(iarch, None)
        self.assembled.pop(iarch, None)
        self.remaining.pop(iarch, None)
        self._lane_by_iarch.pop(iarch, None)
        self.undispatched.pop(iarch, None)
        self._prep_idx.pop(iarch, None)

    def finalize(self):
        """Late assemblies in archive order, then the final in-order
        checkpoint flush."""
        for m in self.meta:
            self.assemble_leftover(m.iarch)
        self._ckpt_flush()

    def run(self):
        # a failed dispatch or assembly must not leave a worker thread
        # grinding through queued copies while the exception propagates
        try:
            tr = self.tracer
            for iarch, (datafile, d) in enumerate(
                    _iter_archives(self.datafiles, self.loader,
                                   self.prefetch)):
                if isinstance(d, Exception):
                    tr.emit("archive_skip", datafile=datafile,
                            reason=str(d))
                    tr.counter("archives_skipped")
                    log(f"Skipping {datafile}: {d}", level="warn")
                    continue
                ok = np.asarray(d.ok_isubs, int)
                if d.nsub == 0 or len(ok) == 0:
                    tr.emit("archive_skip", datafile=datafile,
                            reason="no subints to fit")
                    tr.counter("archives_skipped")
                    log(f"No subints to fit in {datafile}; skipping.",
                        level="warn")
                    continue
                if self.admit(iarch, datafile, d, ok) is None:
                    continue
                # checkpoint-staleness horizon, counted in PREPARED
                # archives
                head_d = min(self.undispatched, default=None)
                if head_d is not None and \
                        self._prep_idx[iarch] - self._prep_idx[head_d] \
                        >= CKPT_STALENESS_HORIZON:
                    if tr.enabled:
                        tr.emit(
                            "force_flush",
                            datafile=self.meta_by_iarch[head_d].datafile,
                            lag=self._prep_idx[iarch]
                            - self._prep_idx[head_d])
                        tr.counter("force_flushes")
                    self.flush_all()
            self.flush_all()
            self.drain_all()
        except BaseException:
            self._shutdown(wait=False)
            raise
        self._shutdown(wait=True)
        self.finalize()
        return self.meta, self.assembled


def _load_raw(f, device):
    """Raw streaming load: undecoded DATA samples plus the per-archive
    metadata TOA assembly needs.  npol == 1 ships as-is; an IQUV archive
    ships its Stokes-I plane (a host index, no extra bytes); any other
    multi-pol state ships its two summand pols (decoded and baselined
    per pol on the device, then summed).  read_archive(decode=False)
    refuses the layouts the raw lane cannot carry (ValueError), and the
    caller falls back to the decoded lane."""
    arch = read_archive(f, decode=False)
    if arch.raw_code in PACKED_BITS \
            and bucket_pad_to(arch.nchan, device) != arch.nchan:
        # channel padding has no byte-aligned meaning inside a packed
        # bit stream
        raise ValueError(
            f"{f}: sub-byte raw payloads cannot channel-pad "
            f"(config.bucket_pad); decoding on host instead")
    if arch.npol == 1 or arch.get_state() == "Stokes":
        raw = arch.raw_data[:, 0]
        scl = arch.raw_scl[:, 0]
        offs = arch.raw_offs[:, 0]
        pol_sum = False
    else:
        raw = arch.raw_data[:, :2]
        scl = arch.raw_scl[:, :2]
        offs = arch.raw_offs[:, :2]
        pol_sum = True
    weights = arch.get_weights()
    weights_norm = np.where(weights == 0.0, 0.0, 1.0)
    nsub = arch.nsub
    ok_isubs = np.compress(weights_norm.mean(axis=1),
                           np.arange(nsub)).astype(int)
    from ..io.telescopes import telescope_code

    return DataBunch(
        raw_mode=True, raw=raw, scl=scl, offs=offs,
        raw_code=arch.raw_code, pol_sum=pol_sum,
        tscal=arch.raw_tscal, tzero=arch.raw_tzero,
        weights=weights, ok_isubs=ok_isubs,
        nsub=nsub, nchan=arch.nchan, nbin=arch.nbin,
        freqs=arch.freqs_table, Ps=arch.folding_periods(),
        epochs=arch.epochs(), subtimes=list(arch.tsubints),
        doppler_factors=arch.doppler_factors(),
        DM=arch.get_dispersion_measure(),
        dmc=bool(arch.get_dedispersed()),
        dedisp_nu=arch.dedispersion_ref_freq(),
        nu0=arch.get_centre_frequency(), bw=arch.get_bandwidth(),
        backend=arch.get_backend_name(),
        frontend=arch.get_receiver_name(),
        backend_delay=arch.get_backend_delay(),
        telescope=arch.get_telescope(),
        telescope_code=telescope_code(arch.get_telescope()))


def _raw_decode(raw, scl, offs, nbin, ft, redisp=False, redisp_turns=None,
                dft_fold=None, code="i16", pol_sum=False, tscal=None,
                tzero=None, pack_w=None, vmin=None):
    """Stage 1 of a raw bucket: the transport codec's unpack when the
    copy stage shipped a width-reduced payload (``pack_w`` bits per
    residual plus the per-subint minima ``vmin``; ops.decode
    .decode_transport, exact), sample decode (ops.decode), min-window
    baseline, the Stokes-I pol reduction, and for dedispersed-on-disk
    archives the re-dispersion by the stored DM (a matmul-DFT phasor
    rotation by host-wrapped turns; the convention of
    io/psrfits.rotate_phase(amps, -delays))."""
    if pack_w is not None:
        nchan = scl.shape[-1]
        shape = (raw.shape[0],) + ((2, nchan, nbin) if pol_sum
                                   else (nchan, nbin))
        raw = decode_transport(raw, pack_w, vmin, shape, ft)
    x = decode_stokes_I(raw, scl, offs, ft, code=code, pol_sum=pol_sum,
                        nbin=nbin, tscal=tscal, tzero=tzero)
    if redisp:
        k = torch.arange(nbin // 2 + 1, dtype=ft, device=x.device)
        ang = -2.0 * np.pi * redisp_turns.to(ft)[..., None] * k
        c, s = torch.cos(ang), torch.sin(ang)
        # one GEMM shape on CUDA whatever the bucket's size, so a
        # subint's rotated rows have the same bits alone or in a batch
        # (ROADMAP C8); the CPU keeps the JAX package's matmul DFT
        if x.device.type == "cuda":
            Xr, Xi = rfft_mm_invariant(x, fold=dft_fold,
                                       block=CHANNEL_ROW_BLOCK)
            x = irfft_mm_invariant(Xr * c - Xi * s, Xr * s + Xi * c, nbin,
                                   block=CHANNEL_ROW_BLOCK)
        else:
            Xr, Xi = rfft_mm(x, fold=dft_fold)
            x = irfft_mm(Xr * c - Xi * s, Xr * s + Xi * c, nbin)
    return x


def _raw_noise(x, ft):
    """Power-spectrum noise of every decoded row, clamped to tiny."""
    return torch.clamp(get_noise_PS(x), min=torch.finfo(ft).tiny)


def _raw_stats(x, cmask, freqs, ft, noise=None):
    """Stage 2 of a raw bucket: power-spectrum noise, equivalent-width
    S/N, and the S/N-weighted nu_fit seed (host mirror:
    pipeline.toas.snr_weighted_nu_fit).  Returns (noise, snr, nu_fit).
    ``noise`` given lets the inline zap reuse the noise it cut on while
    the S/N and nu_fit derive from the post-zap mask, the order an
    offline-zapped archive's load gives."""
    if noise is None:
        noise = _raw_noise(x, ft)
    snr = get_SNR(x, noise) * cmask
    w_nf = torch.clamp(snr, min=0.0) * freqs[None, :] ** -2.0
    den = torch.sum(w_nf * freqs[None, :] ** -2.0, dim=1)
    nu_fit = torch.sqrt(torch.sum(w_nf, dim=1)
                        / torch.where(den > 0, den, torch.ones_like(den)))
    nu_fit = torch.where(torch.isfinite(nu_fit) & (nu_fit > 0), nu_fit,
                         torch.mean(freqs)).to(ft)
    return noise, snr, nu_fit


def _postfit_bad_mask(x, r, noise, cmask, modelx, freqs, Ps, dfs, bary,
                      fit_DM, nbin):
    """The stream's twin of GetTOAs.get_channels_to_zap's per-subint
    residual (reference pptoas.py:1266-1343) over a whole bucket: the
    model rotated onto the dispersed data at each subint's fitted (phi,
    DM) in one batched call, scaled per channel, the per-channel reduced
    chi^2, and the iterative cut (quality.postfit.postfit_cut_mask).
    Returns the (nb, nchan) bool bad mask.

    The DM offline rotation uses is GetTOAs' DMs, the doppler-corrected
    value (DM_fit * df when barycentred and the RUN's fit_DM is set),
    divided back by df in the rotation; the multiply-then-divide is kept
    as the JAX package keeps it."""
    from ..ops.rotation import rotate_portrait
    from ..quality.postfit import postfit_cut_mask

    ft = x.dtype
    df = dfs.to(ft) if bary else torch.ones_like(Ps)
    DM = r.DM.to(ft)
    DM_corr = DM * df if (bary and fit_DM) else DM
    aligned = rotate_portrait(
        modelx, -r.phi.to(ft)[:, None], -(DM_corr / df)[:, None],
        Ps[:, None], freqs, r.nu_DM.to(ft)[:, None])
    nz = torch.where(noise > 0, noise, torch.ones_like(noise))
    resid = x - r.scales.to(ft)[..., None] * aligned
    chan_rchi2 = torch.sum(resid ** 2, dim=-1) / nz ** 2 / max(nbin - 1, 1)
    return postfit_cut_mask(chan_rchi2, r.channel_snrs.to(ft),
                            r.snr.to(ft), cmask > 0)


def _raw_fit_fn(nchan, nbin, flags, max_iter, ft, x_bf16, device,
                redisp=False, want_flux=False, nharm_eff=None,
                seed_derotate=True, raw_code="i16", pol_sum=False,
                col_scaled=False, log10_tau=False, tau_mode="none",
                use_fast=True, use_ir=False, compensated=False,
                zap_nstd=None, postfit=None, pack_w=None):
    """The raw bucket program for one bucket's geometry: decode ->
    baseline -> noise -> S/N -> nu_fit -> tau seeds -> fit -> one packed
    (nfield, nb) result, so a bucket costs one copy of wire bytes and
    one small pull.  Eager PyTorch: no jit and no program cache.

    tau_mode: 'none' (no scattering), 'neutral' (the half-bin seed),
    'explicit' (a (tau_s, nu, alpha) triple passed at run time) or
    'auto' (estimate_tau_batch on the decoded bucket, on the device).
    Any mode but 'none', a fitted tau/alpha, log10_tau or a response
    (use_ir) makes the bucket a scattering one: the complex-free scatter
    lane (fit.portrait.fast_scatter_fit_batched, B1 in its want_m2 form
    when fit_fused resolves True) with use_fast, else the complex
    engine (fit.portrait.fit_portrait_batch).

    Without scattering, as in the JAX package with "fit_fused resolved
    True on this device" in place of its Pallas mode: sub-byte packed
    buckets with a harmonic window, byte-aligned channels, and no pol
    sum, column scaling or re-dispersion take the DECODE-FUSED fit
    (fit.portrait.fast_fit_batched_packed, B2), which re-decodes the
    packed bytes inside the DFT stage; the stats above still decode
    once, since the noise and S/N need the time-domain portrait.  Every
    other bucket fits the decoded portrait (fit.portrait
    .fast_fit_batched, B1 when fit_fused resolves True).  The returned
    function carries the choice as ``run.decode_fused``.  ``pack_w``
    (not None: the transport codec engaged for this dispatch) unpacks
    the payload first and, as in the JAX package, never takes the
    decode-fused fit: B2 reads wire samples, not codec residuals.

    zap_nstd (not None) runs the inline cut: the iterative median +
    zap_nstd*std cut (quality.excision.zap_keep_mask) on the noise
    levels, whose kept mask zeroes ``cmask`` before the S/N, the nu_fit
    seed, the tau seeds and the fit (B1 or B2) read it; two rows follow
    the result fields, the channels cut per subint ('nzap') and the
    passes that flagged ('zap_iter').  postfit ((bary, fit_DM) of the
    run, or None) appends nchan rows of the post-fit bad mask
    (_postfit_bad_mask)."""
    scat_engine = bool(flags[3] or flags[4] or log10_tau
                       or tau_mode != "none" or use_ir)
    compensated = bool(compensated) and scat_engine
    if compensated:
        x_bf16 = False
    if not use_fast:
        nharm_eff = None  # the complex engine is never band-limited
        seed_derotate = True
    fit_fused = resolve_fit_fused(nharm_eff, device) if use_fast else False
    dft_fold = use_dft_fold(device)
    nbit = PACKED_BITS.get(raw_code)
    decode_fused = bool(
        fit_fused and use_fast and not scat_engine and nbit is not None
        and (nbin * nbit) % 8 == 0 and not pol_sum and not col_scaled
        and not redisp and pack_w is None and nharm_eff is not None)
    fit_flags = FitFlags(*flags)
    keys = _result_keys(flags)

    def run(raw, scl, offs, cmask, modelx, freqs, Ps, DMg, nu_out, alpha0,
            redisp_turns, tscal=None, tzero=None, tau_args=(0.0, 1.0, 0.0),
            ir_r=None, ir_i=None, dfs=None, vmin=None):
        x = _raw_decode(raw, scl, offs, nbin, ft, redisp=redisp,
                        redisp_turns=redisp_turns, dft_fold=dft_fold,
                        code=raw_code, pol_sum=pol_sum,
                        tscal=tscal if col_scaled else None,
                        tzero=tzero if col_scaled else None,
                        pack_w=pack_w, vmin=vmin)
        nzap = zap_iter = None
        if zap_nstd is None:
            noise, snr, nu_fit = _raw_stats(x, cmask, freqs, ft)
        else:
            from ..quality.excision import zap_keep_mask

            noise = _raw_noise(x, ft)
            keep, zap_iter = zap_keep_mask(noise, cmask > 0, zap_nstd)
            pre = torch.sum(cmask, dim=1)
            cmask = cmask * keep.to(ft)
            nzap = pre - torch.sum(cmask, dim=1)
            _, snr, nu_fit = _raw_stats(x, cmask, freqs, ft, noise=noise)
        nb = x.shape[0]
        zeros = torch.zeros(nb, dtype=ft, device=x.device)
        if tau_mode == "none":
            tau0 = zeros
        elif tau_mode == "neutral":
            tau0 = torch.full_like(zeros, 0.5 / nbin)
        elif tau_mode == "explicit":
            tau_s, tau_nu, tau_a = tau_args
            tau0 = ((tau_s / Ps) * (nu_fit / tau_nu) ** tau_a).to(ft)
        else:  # auto
            tau0 = estimate_tau_batch(x, modelx, noise, cmask).to(ft)
        th3 = (torch.log10(torch.clamp(tau0, min=1e-12)) if log10_tau
               else tau0)
        theta0 = torch.stack([zeros, DMg.to(ft), zeros, th3,
                              torch.full_like(zeros, alpha0)], dim=1)
        nu_out_arr = torch.full_like(zeros, nu_out)
        if decode_fused:
            bpc = (nbin * nbit) // 8
            r = fast_fit_batched_packed(
                raw.reshape(nb, nchan, bpc), scl, offs, modelx, noise,
                cmask, freqs, Ps, nu_fit, nu_out_arr, theta0,
                raw_code=raw_code, nbin=nbin, fit_flags=fit_flags,
                max_iter=max_iter, nharm_eff=nharm_eff,
                seed_derotate=seed_derotate, x_bf16=x_bf16,
                dft_fold=dft_fold)
        elif use_fast and not scat_engine:
            r = fast_fit_batched(
                x, modelx, noise, cmask, freqs, Ps, nu_fit, nu_out_arr,
                theta0, fit_flags=fit_flags, max_iter=max_iter,
                seed_derotate=seed_derotate, x_bf16=x_bf16,
                nharm_eff=nharm_eff, dft_fold=dft_fold,
                fit_fused=fit_fused)
        elif use_fast:
            r = fast_scatter_fit_batched(
                x, modelx, noise, cmask, freqs, Ps, nu_fit, nu_out_arr,
                theta0, ir_r if use_ir else None,
                ir_i if use_ir else None, fit_flags=fit_flags,
                log10_tau=log10_tau, max_iter=max_iter,
                compensated=compensated, x_bf16=x_bf16,
                nharm_eff=nharm_eff, seed_derotate=seed_derotate,
                dft_fold=dft_fold, fit_fused=fit_fused)
        else:
            r = fit_portrait_batch(
                x, modelx, noise, freqs, Ps, nu_fit, nu_out=nu_out_arr,
                theta0=theta0, fit_flags=fit_flags, chan_masks=cmask,
                log10_tau=log10_tau, max_iter=max_iter,
                use_scatter=scat_engine,
                ir_FT=torch.complex(ir_r, ir_i) if use_ir else None,
                compensated=compensated, device=x.device)
        fields = [getattr(r, k).to(ft) for k in keys]
        if want_flux:
            fields += list(_flux_rows(r.scales.to(ft), r.scale_errs.to(ft),
                                      torch.mean(modelx, dim=-1), cmask,
                                      freqs))
        if nzap is not None:
            fields += [nzap, zap_iter.to(ft)]
        packed = torch.stack(fields)
        if postfit is not None:
            bad = _postfit_bad_mask(x, r, noise, cmask, modelx, freqs, Ps,
                                    dfs, postfit[0], postfit[1], nbin)
            packed = torch.cat([packed, bad.T.to(ft)], dim=0)
        return packed

    run.decode_fused = decode_fused
    return run


_RESULT_KEYS = ("phi", "phi_err", "DM", "DM_err", "nu_DM", "snr",
                "chi2", "dof", "nfeval", "return_code")


def _result_keys(flags):
    """Per-subint result fields to pull for a bucket's flag set."""
    keys = _RESULT_KEYS
    if flags[2]:
        keys = keys + ("GM", "GM_err")
    if flags[3]:
        keys = keys + ("tau", "tau_err", "alpha", "alpha_err", "nu_tau")
    return keys


def _raw_rows(bucket):
    """Snapshot a raw bucket's per-subint rows on the caller's thread
    (the bucket is cleared right after launch, so the copy stage must
    never read it) plus the re-dispersion flag."""
    rows = (list(bucket.raw), list(bucket.scl), list(bucket.offs))
    dedisp = np.asarray(bucket.dedisp)  # (n, 2)
    redisp = bool(np.any(dedisp[:, 0] != 0.0))
    return rows, dedisp, redisp


def _stack_rows(rows, dedisp, redisp, Ps, freqs):
    """Stack snapshotted raw rows into the dispatch payload and compute
    the re-dispersion turns on the host in float64, wrapped to
    [-0.5, 0.5) before the float32 device trig.  Runs on the COPY
    worker."""
    raw = np.stack(rows[0])
    scl = np.stack(rows[1])
    offs = np.stack(rows[2])
    if redisp:
        freqs_h = np.asarray(freqs, np.float64)
        turns = (Dconst * dedisp[:, :1] / Ps[:, None]) * (
            freqs_h[None, :] ** -2.0 - dedisp[:, 1:] ** -2.0)
        turns = (turns + 0.5) % 1.0 - 0.5
    else:
        turns = np.zeros((len(rows[0]), 1))
    return raw, scl, offs, turns


class _Result:
    """A dispatch's packed result: a host tensor whose device -> host
    copy was enqueued on the fit stream, and the event that marks it
    done (None on the CPU, where the result is final)."""

    def __init__(self, host, event=None):
        self.host = host
        self.event = event

    def ready(self):
        return self.event is None or self.event.query()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _DevicePipeline:
    """The two-stage host -> device dispatch pipeline of ONE device.

    Stage 1, the COPY worker, runs the bucket's copy closure: it stacks
    the payload and moves each array through :meth:`put` (pinned host
    buffer, non_blocking copy on the pipeline's copy stream), then waits
    for its own copies, which frees the pinned buffers and times the
    link.  Stage 2, the FIT worker, runs the bucket program on the
    pipeline's fit stream: the copied tensors are marked as used there
    (``record_stream``, so the caching allocator cannot hand their
    memory to the copy stream while the fit still reads it), the packed
    result is copied back into pinned memory on the same stream, and an
    event marks it done; the executor's readiness test is
    ``event.query()``.  A semaphore of ``depth`` buckets gates
    admission: 1 serializes copy and fit, 2 (default) double-buffers
    bucket N+1's copy against bucket N's fit.  Output is identical for
    any depth.  On the CPU both stages run synchronously on the two
    worker threads.

    Telemetry: ``h2d_start`` fires on the copy worker as a bucket's
    move begins (``overlap``: an earlier dispatch of this device was
    unfinished) and ``h2d_done`` carries the shipped and logical bytes,
    the copy wall (up to and including the copy stream's own
    synchronize, so the real link time) and the codec's wall and
    decision.  The per-pipeline transport cost model (``cost``) learns
    the link from every copy and the codec from every full encode, and
    every copy is accounted in the process-global metrics registry
    (obs.metrics.record_h2d: the link-stall fraction that
    ToaServer.metrics() reports).

    The pipeline lives as long as its executor: a serving loop's copy
    and fit workers, streams and events serve every request.  Each
    worker enters the pipeline's device and stream per bucket; the
    pinned staging buffers (``put``) and the pinned result buffers come
    from PyTorch's caching host allocator, which reuses a freed block
    once the stream work recorded against it finished, so a long-lived
    server's pinned memory does not grow with the requests served."""

    def __init__(self, device, idev, depth, tracer, inflight_fn):
        self.device = torch.device(device)
        self.idev = idev
        self.depth = max(1, int(depth))
        self.tracer = tracer
        self._inflight_fn = inflight_fn
        self._sem = threading.BoundedSemaphore(self.depth)
        self.copy_ex = ThreadPoolExecutor(max_workers=1)
        self.fit_ex = ThreadPoolExecutor(max_workers=1)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(self.device)
            self.fit_stream = torch.cuda.Stream(self.device)
        self.h2d_bytes = 0
        self.h2d_logical_bytes = 0
        self.h2d_s = 0.0
        self.h2d_overlap_s = 0.0
        self.codec_s = 0.0
        self.cost = CostModel()
        self._nbytes = 0
        self._codec = {}

    def note_codec(self, bytes_logical, codec_s, decision):
        """Called by a copy closure (on the copy worker) that ran the
        transport codec: the bytes the copy would have shipped without
        it, the probe/encode wall and the decision ('engaged', 'cost'
        or 'ratio')."""
        self._codec = {"bytes_logical": int(bytes_logical),
                       "codec_s": float(codec_s), "codec": decision}

    def put(self, a, dtype=None):
        """Copy one host array to the device (on the copy worker),
        counting its bytes."""
        arr = np.ascontiguousarray(np.asarray(a) if dtype is None
                                   else np.asarray(a, dtype))
        self._nbytes += arr.nbytes
        t = torch.from_numpy(arr)
        if not self.cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def submit(self, copy_fn, fit_fn, seq):
        """Admit one bucket: ``copy_fn() -> dev_args`` on the copy
        worker, then ``fit_fn(*dev_args) -> packed device tensor`` on
        the fit worker.  Returns the fit Future (resolving to a
        _Result).  Blocks only while ``depth`` buckets occupy the
        pipeline."""
        self._sem.acquire()
        copy_fut = self.copy_ex.submit(self._run_copy, copy_fn, seq)
        return self.fit_ex.submit(self._run_fit, copy_fut, fit_fn)

    def _run_copy(self, copy_fn, seq):
        tr = self.tracer
        overlap = bool(self._inflight_fn(seq))
        if tr.enabled:
            tr.emit("h2d_start", seq=seq, device=self.idev,
                    overlap=overlap)
        self._nbytes = 0
        self._codec = {}
        t0 = time.perf_counter()
        if self.cuda:
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.copy_stream):
                dev_args = copy_fn()
            self.copy_stream.synchronize()
        else:
            dev_args = copy_fn()
        dt = time.perf_counter() - t0
        nbytes = self._nbytes
        logical = self._codec.get("bytes_logical", nbytes)
        codec_s = self._codec.get("codec_s", 0.0)
        self.h2d_bytes += nbytes
        self.h2d_logical_bytes += logical
        self.h2d_s += dt
        self.codec_s += codec_s
        if overlap:
            self.h2d_overlap_s += dt
        # the cost model learns THIS link from every copy (shipped bytes
        # over the copy wall, stacking included: conservative)
        self.cost.observe_link(nbytes, dt)
        record_h2d(nbytes, dt, overlap)
        if tr.enabled:
            ev = dict(seq=seq, device=self.idev, bytes=int(nbytes),
                      h2d_s=round(dt, 6), overlap=overlap,
                      bytes_logical=int(logical),
                      codec_s=round(codec_s, 6))
            if self._codec.get("codec") is not None:
                # the cost-model decision ledger: 'engaged' | 'cost'
                # (model declined) | 'ratio' (payload incompressible)
                ev["codec"] = self._codec["codec"]
            tr.emit("h2d_done", **ev)
        return dev_args

    def _run_fit(self, copy_fut, fit_fn):
        try:
            dev_args = copy_fut.result()
            if not self.cuda:
                return _Result(fit_fn(*dev_args))
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.fit_stream):
                for t in dev_args:
                    if isinstance(t, torch.Tensor):
                        t.record_stream(self.fit_stream)
                out = fit_fn(*dev_args)
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.fit_stream)
            return _Result(host, ev)
        finally:
            # release on ANY exit (a failed copy included): the
            # semaphore is what unblocks the submitting thread
            self._sem.release()

    def shutdown(self, wait):
        self.copy_ex.shutdown(wait=wait, cancel_futures=not wait)
        self.fit_ex.shutdown(wait=wait, cancel_futures=not wait)


def _launch(bucket, nu_ref_DM, max_iter, nsub_batch, pipeline,
            want_flux=False, alpha0=0.0, seq=0, log10_tau=False,
            tau_mode="none", tau_args=(0.0, 1.0, 0.0), zap_nstd=None,
            postfit=None):
    """Launch ONE dispatch for a bucket's pending subints through
    ``pipeline`` and return its in-flight record without waiting for
    the device.  The batch is padded to a multiple of nsub_batch with
    copies of the bucket's first subint, as in the JAX package: no
    row's fit depends on another's, so a subint's result is the same
    whichever subints share its dispatch, and padding makes that
    dispatch the same shape too (a served request's bucket-mates are
    other requests' subints, a one-shot run's are pad rows), so the
    kernels' launch configurations, and with them the float32 results,
    cannot differ.  The pad rows are made on the device from the copied
    first row (_pad_rows), so the link carries the real rows only; the
    record's owners are the real rows only.
    Buckets run in float32 where config.use_fast_fit
    resolves on for the device, in float64 through the complex engine
    otherwise (float32 again on CUDA: fit.portrait.fit_portrait_batch).
    zap_nstd: the inline cut of a raw bucket (_raw_fit_fn; decoded
    buckets were cut at prepare); postfit: (bary, fit_DM) of the run for
    the post-fit cut's rows, or None."""
    n = len(bucket)
    if n == 0:
        return None
    device = pipeline.device
    nrows = n + (-n) % nsub_batch
    masks_rows = list(bucket.masks)
    Ps = np.asarray(bucket.Ps)
    # doppler factors ride only when the post-fit cut rotates by the
    # doppler-corrected DM
    dfs = np.asarray(bucket.dfs) if postfit is not None else None
    flags = FitFlags(*bucket.flags)
    keys = _result_keys(flags)
    if want_flux:
        keys = keys + ("flux", "flux_err", "flux_ref_freq")
    if zap_nstd is not None and bucket.kind == "raw":
        keys = keys + ("nzap", "zap_iter")
    nu_out = -1.0 if nu_ref_DM is None else float(nu_ref_DM)
    modelx, freqs = bucket.modelx, bucket.freqs
    ir_FT = bucket.ir_FT
    use_fast = use_fast_fit_default(device)
    # only the fast lanes band-limit; the complex engine never does
    hwin = bucket.harmonic_window(device) if use_fast else None
    ft, ft_np = ((torch.float32, np.float32) if use_fast
                 else (torch.float64, np.float64))
    put = pipeline.put

    if bucket.kind == "raw":
        rows, dedisp, redisp = _raw_rows(bucket)
        DMg = np.asarray(bucket.DM_guess)
        col_scaled = bucket.col_scaled
        tscal_h = np.asarray(bucket.tscal) if col_scaled else None
        tzero_h = np.asarray(bucket.tzero) if col_scaled else None
        use_ir = ir_FT is not None
        raw_fn_args = (
            (len(np.asarray(freqs)), bucket.nbin,
             tuple(bool(f) for f in bucket.flags), int(max_iter), ft,
             use_bf16_cross_spectrum(), device),
            dict(redisp=redisp, want_flux=want_flux, nharm_eff=hwin,
                 # all-zero DM guesses make the CCF seed's derotation
                 # the identity, so the fit skips that pass
                 seed_derotate=bool(np.any(DMg != 0.0)),
                 raw_code=bucket.raw_code, pol_sum=bucket.pol_sum,
                 col_scaled=col_scaled, log10_tau=log10_tau,
                 tau_mode=tau_mode, use_fast=use_fast, use_ir=use_ir,
                 compensated=use_scatter_compensated(), zap_nstd=zap_nstd,
                 postfit=postfit))
        # the transport codec: the copy worker decides per dispatch (the
        # payload's dynamic range and the live link and codec rates are
        # known only there) and ``sel`` carries the width to the fit
        # stage, which runs strictly after this bucket's copy.  Packed
        # sub-byte codes are already minimal and float32 payloads carry
        # no integer residuals: integer wire types only.
        compress_mode = resolve_transport_compress()
        can_compress = (compress_mode is not False
                        and bucket.raw_code in ("i16", "u8", "i8"))
        sel = {}
        if use_ir:
            # the response ships as two real arrays, cut to the window
            ir_src = np.asarray(ir_FT)
            if hwin is not None:
                ir_src = ir_src[..., :hwin]
            ir_r_h, ir_i_h = ir_src.real, ir_src.imag

        def copy():
            raw, scl, offs, turns = _stack_rows(rows, dedisp, redisp, Ps,
                                                freqs)
            masks = np.stack(masks_rows)
            payload, vmin_h = raw, None
            if can_compress:
                t0c = time.perf_counter()
                vmin_w, w = probe_width(raw)
                decision = "ratio"  # no width below the wire dtype
                if w is not None:
                    shipped_est = raw.shape[0] * (
                        (raw.size // raw.shape[0]) * w // 8 + 4)
                    if compress_mode is True or \
                            pipeline.cost.predict(raw.nbytes, shipped_est):
                        payload = encode_rows(raw, vmin_w, w)
                        vmin_h = vmin_w
                        sel["pack"] = int(w)
                        decision = "engaged"
                    else:
                        decision = "cost"
                codec_s = time.perf_counter() - t0c
                if "pack" in sel:
                    # learn the encode rate from full encodes only (a
                    # probe-only pass would flatter the model)
                    pipeline.cost.observe_codec(raw.nbytes, codec_s)
            n0 = pipeline._nbytes
            # the payload and its vmin sidecar first, so the shipped
            # payload splits off the shared arguments for the logical
            # bytes below
            payload_d = put(payload)
            vmin_d = put(vmin_h, ft_np) if vmin_h is not None else None
            shipped_payload = pipeline._nbytes - n0
            args = (payload_d, put(scl, ft_np), put(offs, ft_np),
                    put(masks, ft_np), put(modelx, ft_np),
                    put(freqs, ft_np), put(Ps, ft_np), put(DMg, ft_np),
                    put(turns, ft_np),
                    put(tscal_h, ft_np) if col_scaled else None,
                    put(tzero_h, ft_np) if col_scaled else None,
                    put(ir_r_h, ft_np) if use_ir else None,
                    put(ir_i_h, ft_np) if use_ir else None,
                    put(dfs, ft_np) if dfs is not None else None, vmin_d)
            if can_compress:
                # what the dispatch would have shipped uncompressed: only
                # the payload and its sidecar differ between the lanes
                shipped = pipeline._nbytes - n0
                pipeline.note_codec(shipped - shipped_payload + raw.nbytes,
                                    codec_s, decision)
            return args

        def fit(raw_d, scl_d, offs_d, masks_d, modelx_d, freqs_d, Ps_d,
                DMg_d, turns_d, tscal_d, tzero_d, ir_r_d, ir_i_d, dfs_d,
                vmin_d):
            raw_d, scl_d, offs_d, masks_d, Ps_d, DMg_d, turns_d, \
                tscal_d, tzero_d, dfs_d, vmin_d = (
                    _pad_rows(t, nrows) for t in (
                        raw_d, scl_d, offs_d, masks_d, Ps_d, DMg_d,
                        turns_d, tscal_d, tzero_d, dfs_d, vmin_d))
            # the copy stage has resolved by now: a compressed payload
            # selects the width-keyed program
            fn = _raw_fit_fn(*raw_fn_args[0], **raw_fn_args[1],
                             pack_w=sel.get("pack"))
            return fn(raw_d, scl_d, offs_d, masks_d, modelx_d, freqs_d,
                      Ps_d, DMg_d, nu_out, alpha0, turns_d, tscal_d,
                      tzero_d, tau_args=tau_args, ir_r=ir_r_d, ir_i=ir_i_d,
                      dfs=dfs_d, vmin=vmin_d)
    else:
        ports_rows = list(bucket.ports)
        noise_rows = list(bucket.noise)
        nu_fit = np.asarray(bucket.nu_fits)
        theta0 = np.stack(bucket.theta0)
        # scattering (fitted, a fixed nonzero or log10 tau seed in a
        # degenerate group of a scattering run, or a response) routes to
        # the scatter-shaped engine
        scat = bool(flags[3] or flags[4] or log10_tau
                    or np.any(theta0[:, 3] != 0.0) or ir_FT is not None)

        def copy():
            return (put(np.stack(ports_rows), ft_np), put(modelx, ft_np),
                    put(np.stack(noise_rows), ft_np), put(freqs, ft_np),
                    put(Ps, ft_np), put(nu_fit, ft_np),
                    put(theta0, ft_np), put(np.stack(masks_rows), ft_np),
                    put(dfs, ft_np) if dfs is not None else None)

        def fit(ports_d, modelx_d, noise_d, freqs_d, Ps_d, nu_fit_d,
                theta0_d, masks_d, dfs_d):
            ports_d, noise_d, Ps_d, nu_fit_d, theta0_d, masks_d, dfs_d = (
                _pad_rows(t, nrows) for t in (ports_d, noise_d, Ps_d,
                                              nu_fit_d, theta0_d, masks_d,
                                              dfs_d))
            if use_fast:
                r = fit_portrait_batch_fast(
                    ports_d, modelx_d, noise_d, freqs_d, Ps_d, nu_fit_d,
                    nu_out=nu_ref_DM, theta0=theta0_d, fit_flags=flags,
                    chan_masks=masks_d, max_iter=max_iter,
                    log10_tau=log10_tau, ir_FT=ir_FT, use_scatter=scat,
                    harmonic_window=hwin if hwin is not None else False,
                    device=device)
            else:
                r = fit_portrait_batch(
                    ports_d, modelx_d, noise_d, freqs_d, Ps_d, nu_fit_d,
                    nu_out=nu_ref_DM, theta0=theta0_d, fit_flags=flags,
                    chan_masks=masks_d, log10_tau=log10_tau,
                    max_iter=max_iter, ir_FT=ir_FT, device=device)
            fields = [getattr(r, k).to(ft) for k in _result_keys(flags)]
            if want_flux:
                fields += list(_flux_rows(r.scales.to(ft),
                                          r.scale_errs.to(ft),
                                          torch.mean(modelx_d, dim=-1),
                                          masks_d, freqs_d))
            packed = torch.stack(fields)
            if postfit is not None:
                bad = _postfit_bad_mask(ports_d, r, noise_d, masks_d,
                                        modelx_d, freqs_d, Ps_d, dfs_d,
                                        postfit[0], postfit[1],
                                        int(ports_d.shape[-1]))
                packed = torch.cat([packed, bad.T.to(ft)], dim=0)
            return packed

    handle = pipeline.submit(copy, fit, seq)
    rec = (handle, list(bucket.owners), keys)
    bucket.clear()
    return rec


def _pad_rows(t, nrows):
    """A per-subint device tensor (subints on dim 0) padded to ``nrows``
    rows with copies of its first row; None passes through."""
    if t is None or t.shape[0] == nrows:
        return t
    pad = t[:1].expand((nrows - t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat([t, pad])


def _flux_rows(scales, scale_errs, means, cmask, freqs):
    """(flux, flux_err, flux_ref_freq) per subint, on the device: the
    error-weighted mean of the model channel means times the fitted
    scales (pipeline/toas.weighted_mean semantics: a plain mean and an
    infinite error when no channel has a positive error)."""
    fx = means[None, :] * scales
    fe = torch.abs(means)[None, :] * scale_errs
    good = (fe > 0.0) & (cmask > 0.0)
    one = torch.ones_like(fe)
    w = torch.where(good, 1.0 / torch.where(good, fe, one) ** 2.0,
                    torch.zeros_like(fe))
    wsum = w.sum(dim=1)
    ok = wsum > 0.0
    wsafe = torch.where(ok, wsum, torch.ones_like(wsum))
    nmask = torch.clamp(cmask.sum(dim=1), min=1.0)
    flux = torch.where(ok, (fx * w).sum(dim=1) / wsafe,
                       (fx * cmask).sum(dim=1) / nmask)
    flux_err = torch.where(ok, wsafe ** -0.5,
                           torch.full_like(wsafe, float("inf")))
    ffreq = torch.where(ok, (freqs[None, :] * w).sum(dim=1) / wsafe,
                        (freqs[None, :] * cmask).sum(dim=1) / nmask)
    return flux, flux_err, ffreq


def _assemble_archive(m, results, modelfile, fit_DM, bary,
                      addtnl_toa_flags, log10_tau=False, alpha_fitted=False,
                      nu_ref_tau=None, fit_GM=False, print_flux=False,
                      print_phase=False, quiet=False, quality_flags=False):
    """The TOA objects and DeltaDM statistics of one archive from the
    scattered fit results."""
    toas, dDMs, dDM_errs = [], [], []
    for j, isub in enumerate(m.ok):
        r = results.get((m.iarch, int(isub)))
        if r is None:
            continue
        P = m.Ps[j]
        phi = float(r["phi"])
        toa_mjd = m.epochs[j].add_seconds(phi * P + m.backend_delay)
        df = m.dfs[j] if bary else 1.0
        DM_j, GM_j = doppler_corrected_DM_GM(
            float(r["DM"]), float(r.get("GM", 0.0)), df, fit_DM, "GM" in r,
            bary)
        flags = {}
        if fit_GM:
            flags["gm"] = GM_j
            flags["gm_err"] = float(r.get("GM_err", 0.0))
        if "tau" in r:
            # GetTOAs' flag assembly, with the -nu_tau re-reference
            flags.update(scattering_toa_flags(
                float(r["tau"]), float(r["tau_err"]), float(r["nu_tau"]),
                float(r["alpha"]), float(r.get("alpha_err", 0.0)), P, df,
                log10_tau, alpha_fitted, nu_ref_tau=nu_ref_tau))
        flags.update({
            "be": m.backend, "fe": m.frontend,
            "f": f"{m.frontend}_{m.backend}",
            "nbin": int(m.nbin), "nch": int(m.nchan),
            "subint": int(isub), "tobs": m.subtimes[j],
            "tmplt": str(modelfile), "snr": float(r["snr"]),
            "gof": float(r["chi2"] / max(float(r["dof"]), 1.0)),
        })
        # the packed result carries only the total S/N: snr/sqrt(nchan)
        # underestimates the channel S/N, so the warning is never false
        warn_bf16_high_snr(float(r["snr"]) / max(m.nchan, 1) ** 0.5,
                           quiet=quiet)
        if print_phase:
            flags["phs"] = phi
            flags["phs_err"] = float(r["phi_err"])
        if print_flux:
            flags["flux"] = float(r["flux"])
            flags["flux_err"] = float(r["flux_err"])
            flags["flux_ref_freq"] = float(r["flux_ref_freq"])
        if quality_flags:
            flags["nfev"] = int(r["nfeval"])
            flags["chi2"] = float(r["chi2"])
        flags.update(addtnl_toa_flags)
        DM_out = DM_j if fit_DM else None
        DM_err_out = float(r["DM_err"]) if fit_DM else None
        toas.append(TOA(
            m.datafile, float(r["nu_DM"]), toa_mjd,
            float(r["phi_err"]) * P * 1e6, m.telescope, m.telescope_code,
            DM_out, DM_err_out, flags))
        if fit_DM:
            dDMs.append(DM_j - m.DM0_arch)
            dDM_errs.append(DM_err_out)
    mean, err = delta_dm_stats(dDMs, dDM_errs)
    return toas, mean, err


def _collect_wideband(meta, assembled):
    """TOAs and per-archive DeltaDM statistics in archive order."""
    TOA_list = []
    order, DM0s, means, errs = [], [], [], []
    for m in meta:
        toas, mean, err = assembled[m.iarch]
        TOA_list.extend(toas)
        order.append(m.datafile)
        DM0s.append(m.DM0_arch)
        means.append(mean)
        errs.append(err)
    return TOA_list, order, DM0s, means, errs


def _zap_decoded(d, ok, masks, nstd, device, tracer, datafile):
    """The decoded lane's inline cut at prepare: ``masks`` (nok, nchan)
    times the kept mask of the median cut on the archive's host noise
    levels, through the torch lane on ``device`` or the numpy oracle as
    the zap_device knob resolves there.  Emits the archive's
    ``zap_propose`` (and ``zap_apply`` when it cut anything)."""
    from ..quality.excision import zap_keep_device, zap_keep_np
    from .zap import resolve_zap_device

    noise = np.asarray(d.noise_stds[ok, 0])
    use_dev = resolve_zap_device(None, device)
    t0 = time.perf_counter()
    if use_dev:
        keep, iters = zap_keep_device(noise, masks > 0, nstd, device=device)
    else:
        keep, iters = zap_keep_np(noise, masks > 0, nstd)
    wall = time.perf_counter() - t0
    n_cut = int(masks.sum() - (masks * keep).sum())
    if tracer.enabled:
        tracer.emit("zap_propose", datafile=datafile, n_channels=n_cut,
                    n_iter=int(np.max(iters, initial=0)),
                    device=bool(use_dev), wall_s=round(wall, 6))
        if n_cut:
            tracer.emit("zap_apply", datafile=datafile, n_channels=n_cut)
    return masks * keep


def make_wideband_lane(modelfile, nsub_batch=256, fit_DM=True, fit_GM=False,
                       nu_ref_DM=None, nu_ref_tau=None, DM0=None, bary=True,
                       tscrunch=False, fit_scat=False, log10_tau=True,
                       scat_guess=None, fix_alpha=False, max_iter=25,
                       print_flux=False, print_phase=False,
                       instrumental_response_dict=None, addtnl_toa_flags={},
                       quiet=False, quality_flags=False, zap_inline=False,
                       zap_nstd=None, zap_channels=None, postfit_cut=False,
                       device=None, tracer=None, key_prefix=()):
    """The wideband physics lane and archive loader for a template and
    option set: returns ``(lane, loader)``, the lane supplying
    _StreamExecutor's prepare/launch/scatter/assemble hooks.  A lane is
    a value: a serving loop builds one per (template, options) pair and
    feeds every lane into one executor.  ``device`` (default cuda) is
    where the template is built and where the 'auto' knobs (fast fit,
    fused lane, bucket padding, the zap lane) resolve.  ``nsub_batch``:
    the row count a partial bucket's dispatch pads to.  ``key_prefix``
    namespaces the lane's bucket keys, so buckets of different
    templates with the same layout never share a dispatch while
    requests with the same template and options always can.  Options
    as stream_wideband_TOAs; the lane's ``postfit_zaps`` collects the
    post-fit cut's lists.  ``tracer`` receives the lane's typed
    archive_skip and the zap lanes' zap_propose/zap_apply events."""
    from ..quality.excision import zap_bunch
    from .zap import resolve_zap_nstd

    tracer = NULL_TRACER if tracer is None else tracer
    dev = resolve_device(device)
    # inline zap: raw buckets cut inside the bucket program, decoded
    # archives at prepare; zap_channels applies offline lists at load
    zap_nstd_run = resolve_zap_nstd(zap_nstd) if zap_inline else None
    # the post-fit cut's rotation needs the run's barycentring and fit_DM
    postfit_run = (bool(bary), bool(fit_DM)) if postfit_cut else None
    zap_map = {os.path.abspath(k): v
               for k, v in (zap_channels or {}).items()}
    ird = {**DEFAULT_IR_DICT, **(instrumental_response_dict or {})}
    if len(ird["wids"]) != len(ird["irf_types"]):
        raise ValueError(
            "instrumental_response_dict: wids and irf_types must pair "
            f"up (got {len(ird['wids'])} widths, "
            f"{len(ird['irf_types'])} kinds)")
    use_ir = bool(ird["wids"] or ird["DM-smear"])
    ir_cache = {}  # response signature -> (nchan, nharm) host kernel
    scat_guess = _validate_scat_guess(scat_guess, fit_scat)
    if not fit_scat:
        log10_tau = False
    model = TemplateModel(modelfile, quiet=quiet, device=dev)
    # scattering baked into the template makes the portrait depend on
    # the folding period, so such templates key buckets by P too
    p_dependent = model.has_scattering()
    default_alpha = float(model.gauss.alpha if model.is_gaussian
                          else scattering_alpha)
    # the tau seeding mode of both lanes
    if scat_guess is not None and not isinstance(scat_guess, str):
        tau_mode = "explicit"
        tau_args = tuple(float(v) for v in scat_guess)
        alpha0_run = tau_args[2]
    else:
        tau_mode = ("auto" if fit_scat and scat_guess == "auto"
                    else "neutral" if fit_scat else "none")
        tau_args, alpha0_run = (0.0, 1.0, 0.0), default_alpha
    # the host-decoded lane loads in the fit's dtype
    load_dtype = np.float32 if use_fast_fit_default(dev) else np.float64

    def _loader(f):
        if not tscrunch:
            try:
                # raw lane: undecoded wire samples straight to the device
                return _apply_zap_map(f, _load_raw(f, dev))
            except (ValueError, KeyError):
                pass
        return _apply_zap_map(f, load_for_toas(f, tscrunch=tscrunch,
                                               quiet=True, dtype=load_dtype))

    def _apply_zap_map(f, d):
        """Offline zap lists as in-memory weight zaps at load: the same
        as loading an archive whose DAT_WTS were zeroed
        (quality.zap_bunch)."""
        z = zap_map.get(os.path.abspath(f))
        if z is not None and sum(len(c) for c in z):
            zap_bunch(d, z)
            if tracer.enabled:
                # on the prefetch threads: the tracer is thread-safe
                tracer.emit("zap_apply", datafile=f,
                            n_channels=sum(len(c) for c in z))
        return d

    class _WidebandLane:
        """The wideband physics hooks for _StreamExecutor."""

        def __init__(self):
            # {datafile: {subint: [bad channels]}} with postfit_cut: the
            # stream's counterpart of GetTOAs.get_channels_to_zap's lists
            self.postfit_zaps = {}

        def prepare(self, iarch, datafile, d, ok):
            nchan, nbin = d.nchan, d.nbin
            freqs0 = np.asarray(d.freqs[0], float)
            P_mean = float(np.mean(d.Ps[ok]))
            # config.bucket_pad: pad the DEVICE layout to the next power
            # of two with zero-weight channels repeating the last
            # channel's frequency; host statistics and TOA flags keep
            # the true nchan
            pad_c = bucket_pad_to(nchan, dev) - nchan
            freqs_b = (np.concatenate([freqs0, np.full(pad_c, freqs0[-1])])
                       if pad_c else freqs0)
            try:
                modelx = model.portrait(freqs_b, nbin, P=P_mean)
            except ValueError as e:
                # a typed archive_skip, so the report names the mismatch
                tracer.emit("archive_skip", datafile=datafile,
                            reason=str(e))
                log(f"Skipping {datafile}: {e}", level="warn")
                return None
            base_key = key_prefix + (nchan + pad_c, nbin, freqs_b.tobytes())
            if p_dependent:
                base_key += (round(P_mean, 12),)
            DM_stored = float(d.DM)
            DM0_arch = DM_stored if DM0 is None else float(DM0)
            DM_guess = DM_stored if DM_stored != 0.0 else DM0_arch
            # the response of this layout, built once per signature;
            # DM smearing makes it archive-specific, so it joins the key
            ir_FT = None
            if use_ir:
                ir_sig = ((nchan + pad_c, nbin, freqs_b.tobytes(),
                           tuple(ird["wids"]), tuple(ird["irf_types"]))
                          + ((round(DM_guess, 9), round(P_mean, 12))
                             if ird["DM-smear"] else ()))
                if ir_sig not in ir_cache:
                    ir_cache[ir_sig] = build_instrumental_response_FT(
                        ird, freqs_b, nbin, DM_guess, P_mean,
                        bw=d.get("bw", 0.0))
                ir_FT = ir_cache[ir_sig]
                base_key += (ir_sig[3:],)
            masks = np.asarray(d.weights[ok] > 0.0, float)
            raw_mode = bool(d.get("raw_mode", False))
            if zap_nstd_run is not None and not raw_mode and len(ok):
                # decoded-lane inline zap: cut BEFORE any mask-derived
                # quantity (nu_fit seed, tau seeds, flag demotion), as an
                # offline-zapped archive's load would
                masks = _zap_decoded(d, ok, masks, zap_nstd_run, dev,
                                     tracer, datafile)
            masks_b = (np.pad(masks, ((0, 0), (0, pad_c))) if pad_c
                       else masks)
            # keep only what TOA assembly needs, not the data cube
            m = DataBunch(
                datafile=datafile, iarch=iarch, ok=ok, DM0_arch=DM0_arch,
                nbin=nbin, nchan=nchan,
                epochs=[d.epochs[isub] for isub in ok],
                Ps=[float(d.Ps[isub]) for isub in ok],
                dfs=[float(d.doppler_factors[isub]) for isub in ok],
                subtimes=[float(d.subtimes[isub]) for isub in ok],
                backend_delay=d.backend_delay, backend=d.backend,
                frontend=d.frontend, telescope=d.telescope,
                telescope_code=d.telescope_code)
            nchx = masks.sum(axis=1).astype(int)
            if not raw_mode:
                ports = np.asarray(d.subints[ok, 0])
                noise = np.asarray(d.noise_stds[ok, 0], float)
                snrs_chan = np.asarray(d.SNRs[ok, 0], float) * masks
                nu_fit_arr = snr_weighted_nu_fit(snrs_chan, freqs0)
                # tau/alpha seeds from the true layout (GetTOAs' helper)
                tau0, alpha0 = scat_seed_tau0(
                    scat_guess, fit_scat, len(ok), nbin, P_mean,
                    nu_fit_arr, default_alpha, ports=ports,
                    modelx=modelx[:nchan], noise=noise, masks=masks,
                    device=dev)
                if pad_c:
                    # edge-replicated data and noise: masked channels
                    # must carry ordinary finite noise
                    ports = np.pad(ports, ((0, 0), (0, pad_c), (0, 0)),
                                   mode="edge")
                    noise = np.pad(noise, ((0, 0), (0, pad_c)),
                                   mode="edge")
            base_flags = (True, bool(fit_DM), bool(fit_GM), bool(fit_scat),
                          bool(fit_scat and not fix_alpha))
            kind = "raw" if raw_mode else "dec"
            # raw payloads bucket by wire sample type, pol reduction and
            # column-scaling presence: each is its own decode stage
            raw_code = str(d.get("raw_code") or "i16")
            pol_sum = bool(d.get("pol_sum", False))
            col_scaled = raw_mode and (d.get("tscal") is not None
                                       or d.get("tzero") is not None)
            tscal_val = float(d.get("tscal") or 1.0) if raw_mode else 1.0
            tzero_val = float(d.get("tzero") or 0.0) if raw_mode else 0.0
            per_subint = []
            for j, isub in enumerate(ok):
                # degenerate-geometry demotion, as GetTOAs does
                eff_flags = effective_fit_flags(nchx[j], base_flags)
                key = base_key + (eff_flags, kind)
                if raw_mode:
                    key += (raw_code, pol_sum, col_scaled)

                def factory(freqs_b=freqs_b, nbin=nbin, modelx=modelx,
                            eff_flags=eff_flags, kind=kind, ir_FT=ir_FT,
                            raw_code=raw_code, pol_sum=pol_sum,
                            col_scaled=col_scaled):
                    return _Bucket(freqs_b, nbin, modelx, eff_flags,
                                   kind=kind, ir_FT=ir_FT,
                                   raw_code=raw_code, pol_sum=pol_sum,
                                   col_scaled=col_scaled)

                def fill(b, j=j, isub=int(isub), d=d, masks_b=masks_b,
                         DM_guess=DM_guess, raw_mode=raw_mode, iarch=iarch,
                         pad_c=pad_c, col_scaled=col_scaled,
                         tscal_val=tscal_val, tzero_val=tzero_val):
                    if raw_mode:
                        raw_row = d.raw[isub]
                        scl_row = d.scl[isub]
                        offs_row = d.offs[isub]
                        if col_scaled:
                            b.tscal.append(tscal_val)
                            b.tzero.append(tzero_val)
                        if pad_c:
                            # pad channels REPLICATE the edge channel
                            # (samples and scl/offs), so their device
                            # noise estimate is ordinary and finite
                            raw_row = np.pad(
                                raw_row, [(0, 0)] * (raw_row.ndim - 2)
                                + [(0, pad_c), (0, 0)], mode="edge")
                            scl_row = np.pad(
                                scl_row, [(0, 0)] * (scl_row.ndim - 1)
                                + [(0, pad_c)], mode="edge")
                            offs_row = np.pad(
                                offs_row, [(0, 0)] * (offs_row.ndim - 1)
                                + [(0, pad_c)], mode="edge")
                        b.raw.append(raw_row)
                        b.scl.append(scl_row)
                        b.offs.append(offs_row)
                        b.DM_guess.append(DM_guess)
                        # dedispersed on disk: the device program
                        # restores the stored DM's delays before fitting
                        b.dedisp.append(
                            (float(d.DM) if d.get("dmc") else 0.0,
                             float(d.get("dedisp_nu")
                                   or d.get("nu0", 0.0) or 0.0)))
                    else:
                        th = np.zeros(5)
                        th[1] = DM_guess
                        th[3] = (np.log10(max(tau0[j], 1e-12))
                                 if log10_tau else tau0[j])
                        th[4] = alpha0
                        b.ports.append(ports[j])
                        b.noise.append(noise[j])
                        b.nu_fits.append(float(nu_fit_arr[j]))
                        b.theta0.append(th)
                    b.masks.append(masks_b[j])
                    b.Ps.append(float(d.Ps[isub]))
                    b.dfs.append(float(d.doppler_factors[isub]))
                    b.owners.append((iarch, isub))

                per_subint.append((key, factory, fill))
            return m, per_subint

        def launch(self, b, pipeline, seq):
            return _launch(b, nu_ref_DM, max_iter, nsub_batch, pipeline,
                           want_flux=print_flux, alpha0=alpha0_run, seq=seq,
                           log10_tau=log10_tau, tau_mode=tau_mode,
                           tau_args=tau_args, zap_nstd=zap_nstd_run,
                           postfit=postfit_run)

        def scatter(self, out, owners, keys, results):
            nk = len(keys)
            for i, owner in enumerate(owners):
                res = {k: out[j, i] for j, k in enumerate(keys)}
                if out.shape[0] > nk:
                    # the post-fit cut's per-channel bad mask
                    res["postfit_bad"] = out[nk:, i]
                results[owner] = res

        def assemble(self, m, results):
            if zap_nstd_run is not None and tracer.enabled:
                # the raw buckets' inline cut: per-subint counts and
                # passes came back in the packed 'nzap'/'zap_iter' rows
                # (decoded archives emitted theirs at prepare); wall_s is
                # 0: the cut runs inside the fit dispatch
                rows = [r for r in (results.get((m.iarch, int(isub)))
                                    for isub in m.ok)
                        if isinstance(r, dict) and "nzap" in r]
                if rows:
                    nz = sum(int(r["nzap"]) for r in rows)
                    tracer.emit(
                        "zap_propose", datafile=m.datafile,
                        n_channels=int(nz),
                        n_iter=max(int(r["zap_iter"]) for r in rows),
                        device=True, wall_s=0.0)
                    if nz:
                        tracer.emit("zap_apply", datafile=m.datafile,
                                    n_channels=int(nz))
            if postfit_run is not None:
                # ppzap-style {subint: [channels]} lists; TOAs unchanged
                zaps = {}
                for isub in m.ok:
                    r = results.get((m.iarch, int(isub)))
                    if r is not None and "postfit_bad" in r:
                        zaps[int(isub)] = [int(c) for c in np.flatnonzero(
                            r["postfit_bad"][:m.nchan] > 0)]
                self.postfit_zaps[m.datafile] = zaps
                if tracer.enabled:
                    tracer.emit(
                        "zap_propose", datafile=m.datafile,
                        n_channels=sum(len(v) for v in zaps.values()),
                        n_iter=0, device=True, wall_s=0.0)
            return _assemble_archive(
                m, results, modelfile, fit_DM, bary, addtnl_toa_flags,
                log10_tau=log10_tau,
                alpha_fitted=bool(fit_scat and not fix_alpha),
                nu_ref_tau=nu_ref_tau, fit_GM=fit_GM, print_flux=print_flux,
                print_phase=print_phase, quiet=quiet,
                quality_flags=quality_flags)

    return _WidebandLane(), _loader


def stream_wideband_TOAs(datafiles, modelfile, nsub_batch=256, fit_DM=True,
                         fit_GM=False, nu_ref_DM=None, nu_ref_tau=None,
                         DM0=None, bary=True, tscrunch=False,
                         fit_scat=False, log10_tau=True, scat_guess=None,
                         fix_alpha=False, max_iter=25, prefetch=True,
                         max_inflight=None, print_flux=False,
                         print_phase=False, instrumental_response_dict=None,
                         addtnl_toa_flags={}, tim_out=None, quiet=False,
                         resume=False, skip_archives=None,
                         stream_devices=None, telemetry=None,
                         quality_flags=False, pipeline_depth=None,
                         zap_inline=False, zap_nstd=None, zap_channels=None,
                         postfit_cut=False, device=None):
    """Measure wideband (phi, DM[, GM, tau, alpha]) TOAs for many
    archives with cross-archive batched dispatches.

    Options follow the JAX package's stream_wideband_TOAs.  Devices:
    ``stream_devices`` ('auto' = every visible CUDA device, an int N the
    first N, or a device sequence such as ['cpu'] or ['cpu', 'cpu']);
    when it is None, ``device`` alone (e.g. device='cpu') names the one
    device, and with neither config.stream_devices applies.  There is
    no CPU fallback: with no card the CUDA default raises.

    fit_scat/log10_tau/scat_guess/fix_alpha follow GetTOAs.get_TOAs
    (scat_guess: (tau_s, nu, alpha), 'auto' for the data-driven seed on
    the device, or None for the neutral half bin); nu_ref_tau
    re-references the reported tau; instrumental_response_dict as
    GetTOAs.instrumental_response_dict.  Scattering buckets take the
    complex-free scatter lane where config.use_fast_fit resolves on,
    the complex engine otherwise.

    telemetry: the JSONL event trace of the run -- a path (a new trace
    is written there), a telemetry.Tracer to share (how
    stream_ipta_campaign threads one trace through every pulsar), or
    None to follow config.telemetry_path (default off; PPT_TELEMETRY /
    pptoas --telemetry set it).  Tracing adds no host sync and changes
    no TOA.

    zap_inline=True runs the ppzap median algorithm inline: raw buckets
    cut on the noise levels the bucket program computed on the device
    (quality.excision.zap_keep_mask) and zero the flagged channels'
    masks before the S/N, the nu_fit seed and the fit (B1, or B2 on the
    decode-fused lane) read them; decoded-lane archives cut at prepare,
    before any mask-derived quantity.  The TOAs equal those of
    zap_channels= with the same lists, with two edges: a subint the cut
    empties keeps its (all-masked) TOA row where an offline-zapped load
    would drop the subint, and a raw-lane subint cut down to <= 2 usable
    channels keeps its pre-zap fit-flag group.  zap_nstd: the threshold
    in stds (None = config.zap_nstd / PPT_ZAP_NSTD); read only with
    zap_inline.

    zap_channels: {archive path: [subint][channel indices]} of offline
    lists (e.g. pipeline.zap.get_zap_channels) applied as in-memory
    weight zaps at load (quality.zap_bunch), the same as loading an
    archive whose DAT_WTS were zeroed.

    postfit_cut=True runs the model-based post-fit cut in every bucket
    program (the residual's per-channel reduced chi^2 and the channel
    S/N, GetTOAs.get_channels_to_zap's recipe) and returns its lists as
    ``postfit_zaps``: {archive path: {subint: [channel indices]}}.
    TOAs are not changed.

    tim_out: .tim checkpoint; each archive's TOA lines are appended as
    soon as all its subints are fitted, in archive order, each archive
    followed by a completion sentinel.  resume=True drops the torn tail
    after the last sentinel and skips completed archives.

    Returns a DataBunch: TOA_list (archive order), order, DM0s,
    DeltaDM_means, DeltaDM_errs, fit_duration, scatter_duration, nfit,
    devices_used, peak_inflight, dispatch_shapes ({bucket shape: number
    of dispatches}), h2d_bytes (shipped), h2d_bytes_logical (what would
    have shipped without the transport codec), codec_duration,
    h2d_duration, h2d_overlap_duration, wall and postfit_zaps ({}
    without postfit_cut)."""
    if isinstance(datafiles, str):
        datafiles = (_read_metafile(datafiles) if _is_metafile(datafiles)
                     else [datafiles])
    else:
        datafiles = list(datafiles)
    if stream_devices is None and device is not None:
        stream_devices = [device]
    tracer, own_tracer = resolve_tracer(telemetry,
                                        run="stream_wideband_TOAs")
    t_start = time.time()
    try:
        # inside the try: a failing constructor (bad options or devices,
        # a corrupt checkpoint) still closes an owned trace
        devices = resolve_stream_devices(stream_devices)
        lane, loader = make_wideband_lane(
            modelfile, nsub_batch=nsub_batch, fit_DM=fit_DM, fit_GM=fit_GM,
            nu_ref_DM=nu_ref_DM, nu_ref_tau=nu_ref_tau, DM0=DM0, bary=bary,
            tscrunch=tscrunch, fit_scat=fit_scat, log10_tau=log10_tau,
            scat_guess=scat_guess, fix_alpha=fix_alpha, max_iter=max_iter,
            print_flux=print_flux, print_phase=print_phase,
            instrumental_response_dict=instrumental_response_dict,
            addtnl_toa_flags=addtnl_toa_flags, quiet=quiet,
            quality_flags=quality_flags, zap_inline=zap_inline,
            zap_nstd=zap_nstd, zap_channels=zap_channels,
            postfit_cut=postfit_cut, device=devices[0], tracer=tracer)
        ex = _StreamExecutor(lane, datafiles, loader, nsub_batch,
                             max_inflight=max_inflight, prefetch=prefetch,
                             tim_out=tim_out, resume=resume,
                             skip_archives=skip_archives, quiet=quiet,
                             stream_devices=devices, tracer=tracer,
                             pipeline_depth=pipeline_depth)
        meta, assembled = ex.run()
        TOA_list, order, DM0s, means, errs = _collect_wideband(meta,
                                                               assembled)
        wall = time.time() - t_start
        n = len(TOA_list)
        log(f"streamed {n} TOAs from {len(order)} archives in {wall:.2f} s "
            f"({ex.nfit} dispatches across {len(ex.devices_used)} "
            f"device(s), {ex.fit_duration:.2f} s blocked on devices, "
            f"{ex.scatter_duration:.2f} s in host scatter, "
            f"{n / max(wall, 1e-9):.1f} TOAs/s end to end)", quiet=quiet,
            tracer=tracer)
        _emit_run_end(tracer, "stream_wideband_TOAs", ex, n, len(order),
                      wall)
    finally:
        if own_tracer:
            tracer.close()
    return DataBunch(TOA_list=TOA_list, order=order, DM0s=DM0s,
                     DeltaDM_means=means, DeltaDM_errs=errs,
                     fit_duration=ex.fit_duration,
                     scatter_duration=ex.scatter_duration, nfit=ex.nfit,
                     devices_used=len(ex.devices_used),
                     peak_inflight=ex.peak_inflight,
                     dispatch_shapes=dict(ex.dispatch_shapes),
                     h2d_bytes=int(ex.h2d_bytes),
                     h2d_bytes_logical=int(ex.h2d_logical_bytes),
                     codec_duration=ex.codec_duration,
                     h2d_duration=ex.h2d_duration,
                     h2d_overlap_duration=ex.h2d_overlap_duration,
                     wall=wall, postfit_zaps=lane.postfit_zaps)


def _emit_run_end(tracer, driver, ex, n_toas, n_archives, wall):
    """A stream driver's ``run_end`` rollup (the JAX package's fields)."""
    if not tracer.enabled:
        return
    tracer.emit("run_end", driver=driver, n_toas=n_toas,
                n_archives=n_archives, nfit=ex.nfit,
                peak_inflight=ex.peak_inflight,
                max_inflight=ex.max_inflight,
                pipeline_depth=ex.pipeline_depth,
                fit_s=round(ex.fit_duration, 6),
                scatter_s=round(ex.scatter_duration, 6),
                h2d_s=round(ex.h2d_duration, 6),
                h2d_bytes=int(ex.h2d_bytes),
                h2d_bytes_logical=int(ex.h2d_logical_bytes),
                codec_s=round(ex.codec_duration, 6),
                h2d_overlap_s=round(ex.h2d_overlap_duration, 6),
                wall_s=round(wall, 6),
                devices_used=len(ex.devices_used),
                dispatches_per_device=ex.dispatch_counts)


# ---------------------------------------------------------------------------
# narrowband streaming: per-channel fits at campaign scale

_NB_KEYS = ("phase", "phase_err", "snr", "gof")
_NB_SCAT_KEYS = _NB_KEYS + ("tau", "tau_err")


def _nb_fit_fields(x, modelx, noise, cmask, freqs, Ps, ft, nbin, fit_scat,
                   log10_tau, tau_mode, max_iter, tau_args=(0.0, 1.0, 0.0)):
    """The per-channel fit fields of one narrowband bucket, shared by
    the raw and the host-decoded lanes: fit_phase_shift_batch without
    scattering, else the complex engine on (nb * nchan) single-channel
    portraits with (phi, tau) free (GetTOAs.get_narrowband_TOAs' path).
    Returns (phase, phase_err, snr, gof[, tau, tau_err]), each (nb,
    nchan)."""
    from ..fit.phase_shift import fit_phase_shift_batch

    nb, nchan = x.shape[0], x.shape[1]
    if not fit_scat:
        r = fit_phase_shift_batch(x, modelx, noise, device=x.device)
        return (r.phase, r.phase_err, r.snr, r.red_chi2)
    n = nb * nchan
    flat_freqs = freqs.expand(nb, nchan).reshape(n, 1)
    flat_P = Ps.repeat_interleave(nchan)
    if tau_mode == "auto":
        # the broadband estimate per subint, scaled to each channel with
        # the default index
        tau_sub = estimate_tau_batch(x, modelx, noise, cmask)
        tau_seed = (tau_sub[:, None] * (freqs[None, :] / torch.mean(freqs))
                    ** scattering_alpha).reshape(n)
    elif tau_mode == "explicit":
        tau_s, tau_nu, tau_a = tau_args
        tau_seed = (tau_s / flat_P) * (flat_freqs[:, 0] / tau_nu) ** tau_a
    else:
        tau_seed = torch.full((n,), 0.5 / nbin, dtype=ft, device=x.device)
    th0 = torch.zeros((n, 5), dtype=ft, device=x.device)
    th0[:, 3] = (torch.log10(torch.clamp(tau_seed, min=1e-12)) if log10_tau
                 else tau_seed)
    r = fit_portrait_batch(
        x.reshape(n, 1, nbin),
        modelx.expand(nb, nchan, nbin).reshape(n, 1, nbin),
        noise.reshape(n, 1), flat_freqs, flat_P, flat_freqs[:, 0],
        theta0=th0, fit_flags=FitFlags(True, False, False, True, False),
        chan_masks=cmask.reshape(n, 1), log10_tau=log10_tau,
        max_iter=max_iter, device=x.device)
    dof = torch.clamp(r.dof, min=1.0)
    return tuple(v.reshape(nb, nchan) for v in (
        r.phi, r.phi_err, r.snr, r.chi2 / dof, r.tau, r.tau_err))


def _raw_nb_fn(nbin, fit_scat, log10_tau, tau_mode, max_iter, ft, device,
               redisp=False, raw_code="i16", pol_sum=False,
               col_scaled=False, zap_nstd=None):
    """The raw narrowband bucket program: the plain sample decode
    (_raw_decode, shared with the wideband program: sample types,
    sub-byte unpack, column scaling, the pol reduction, re-dispersion),
    the power-spectrum noise, then _nb_fit_fields.  Returns one packed
    (nfield, nb, nchan) tensor.  zap_nstd (not None) runs the inline cut
    on the noise (quality.excision.zap_keep_mask), zeroes the cut
    channels in ``cmask`` and appends the (nb, nchan) kept mask as a
    last field, from which assembly drops the cut channels' TOAs; each
    channel's fit reads only its own row, so the surviving TOAs equal
    those of an offline zap of the same lists."""
    dft_fold = use_dft_fold(device)

    def run(raw, scl, offs, cmask, modelx, freqs, Ps, redisp_turns,
            tscal=None, tzero=None, tau_args=(0.0, 1.0, 0.0)):
        x = _raw_decode(raw, scl, offs, nbin, ft, redisp=redisp,
                        redisp_turns=redisp_turns, dft_fold=dft_fold,
                        code=raw_code, pol_sum=pol_sum,
                        tscal=tscal if col_scaled else None,
                        tzero=tzero if col_scaled else None)
        noise = _raw_noise(x, ft)
        keep = None
        if zap_nstd is not None:
            from ..quality.excision import zap_keep_mask

            keep, _ = zap_keep_mask(noise, cmask > 0, zap_nstd)
            cmask = cmask * keep.to(ft)
        fields = list(_nb_fit_fields(x, modelx, noise, cmask, freqs, Ps, ft,
                                     nbin, fit_scat, log10_tau, tau_mode,
                                     max_iter, tau_args))
        if keep is not None:
            fields.append(keep)
        return torch.stack([f.to(ft) for f in fields])

    return run


def _launch_nb(b, pipeline, seq, fit_scat, log10_tau, tau_mode, tau_args,
               max_iter, zap_nstd=None):
    """Launch one narrowband dispatch through ``pipeline`` (the rows of
    a partial bucket only: no served request shares a narrowband
    bucket) and return its in-flight
    record.  float32 where config.use_fast_fit resolves on for the
    device, float64 otherwise."""
    if len(b) == 0:
        return None
    device = pipeline.device
    ft, ft_np = ((torch.float32, np.float32) if use_fast_fit_default(device)
                 else (torch.float64, np.float64))
    put = pipeline.put
    masks_rows = list(b.masks)
    Ps = np.asarray(b.Ps)
    modelx, freqs, nbin = b.modelx, b.freqs, b.nbin
    if b.kind == "raw":
        rows, dedisp, redisp = _raw_rows(b)
        col_scaled = b.col_scaled
        tscal_h = np.asarray(b.tscal) if col_scaled else None
        tzero_h = np.asarray(b.tzero) if col_scaled else None
        fn = _raw_nb_fn(nbin, fit_scat, log10_tau, tau_mode, max_iter, ft,
                        device, redisp=redisp, raw_code=b.raw_code,
                        pol_sum=b.pol_sum, col_scaled=col_scaled,
                        zap_nstd=zap_nstd)

        def copy():
            raw, scl, offs, turns = _stack_rows(rows, dedisp, redisp, Ps,
                                                freqs)
            return (put(raw), put(scl, ft_np), put(offs, ft_np),
                    put(np.stack(masks_rows), ft_np), put(modelx, ft_np),
                    put(freqs, ft_np), put(Ps, ft_np), put(turns, ft_np),
                    put(tscal_h, ft_np) if col_scaled else None,
                    put(tzero_h, ft_np) if col_scaled else None)

        def fit(*dev_args):
            return fn(*dev_args, tau_args=tau_args)
    else:
        ports_rows = list(b.ports)
        noise_rows = list(b.noise)

        def copy():
            return (put(np.stack(ports_rows), ft_np), put(modelx, ft_np),
                    put(np.stack(noise_rows), ft_np),
                    put(np.stack(masks_rows), ft_np), put(freqs, ft_np),
                    put(Ps, ft_np))

        def fit(*dev_args):
            return torch.stack([f.to(ft) for f in _nb_fit_fields(
                *dev_args, ft, nbin, fit_scat, log10_tau, tau_mode,
                max_iter, tau_args)])

    rec = (pipeline.submit(copy, fit, seq), list(b.owners), None)
    b.clear()
    return rec


def make_narrowband_lane(modelfile, fit_scat=False, log10_tau=True,
                         scat_guess=None, tscrunch=False, max_iter=25,
                         print_phase=False, addtnl_toa_flags={}, quiet=False,
                         zap_inline=False, zap_nstd=None, device=None,
                         tracer=None):
    """The narrowband physics lane and archive loader for a template and
    option set: ``(lane, loader)`` for _StreamExecutor, as
    make_wideband_lane.  log10_tau only matters with fit_scat;
    zap_inline/zap_nstd as stream_narrowband_TOAs."""
    from .zap import resolve_zap_nstd

    tracer = NULL_TRACER if tracer is None else tracer
    dev = resolve_device(device)
    zap_nstd_run = resolve_zap_nstd(zap_nstd) if zap_inline else None
    scat_guess = _validate_scat_guess(scat_guess, fit_scat)
    if fit_scat and not log10_tau and scat_guess is None:
        raise ValueError(
            "stream_narrowband_TOAs: log10_tau=False needs scat_guess")
    if not fit_scat:
        log10_tau = False
    model = TemplateModel(modelfile, quiet=quiet, device=dev)
    p_dependent = model.has_scattering()
    if scat_guess is not None and not isinstance(scat_guess, str):
        tau_mode = "explicit"
        tau_args = tuple(float(v) for v in scat_guess)
    else:
        tau_mode = ("auto" if fit_scat and scat_guess == "auto"
                    else "neutral" if fit_scat else "none")
        tau_args = (0.0, 1.0, 0.0)
    keys = _NB_SCAT_KEYS if fit_scat else _NB_KEYS
    if zap_nstd_run is not None:
        # raw buckets append the kept mask; a decoded bucket's packed
        # result is one row shorter and zip() leaves the key out
        keys = keys + ("keep",)
    load_dtype = np.float32 if use_fast_fit_default(dev) else np.float64

    def _loader(f):
        if not tscrunch:
            try:
                return _load_raw(f, dev)
            except (ValueError, KeyError):
                pass
        return load_for_toas(f, tscrunch=tscrunch, quiet=True,
                             dtype=load_dtype)

    class _NarrowbandLane:
        """The narrowband physics hooks for _StreamExecutor."""

        def prepare(self, iarch, datafile, d, ok):
            nchan, nbin = d.nchan, d.nbin
            freqs0 = np.asarray(d.freqs[0], float)
            P_mean = float(np.mean(d.Ps[ok]))
            try:
                modelx = model.portrait(freqs0, nbin, P=P_mean)
            except ValueError as e:
                tracer.emit("archive_skip", datafile=datafile,
                            reason=str(e))
                log(f"Skipping {datafile}: {e}", level="warn")
                return None
            raw_mode = bool(d.get("raw_mode", False))
            raw_code = str(d.get("raw_code") or "i16")
            pol_sum = bool(d.get("pol_sum", False))
            col_scaled = raw_mode and (d.get("tscal") is not None
                                       or d.get("tzero") is not None)
            tscal_val = float(d.get("tscal") or 1.0) if raw_mode else 1.0
            tzero_val = float(d.get("tzero") or 0.0) if raw_mode else 0.0
            masks = np.asarray(d.weights[ok] > 0.0, float)
            if zap_nstd_run is not None and not raw_mode and len(ok):
                # decoded-lane inline zap: cut before the usable-channel
                # lists are derived, so assembly emits the TOAs an
                # offline-zapped load would
                masks = _zap_decoded(d, ok, masks, zap_nstd_run, dev,
                                     tracer, datafile)
            key = (nchan, nbin, freqs0.tobytes(),
                   "raw" if raw_mode else "dec")
            if raw_mode:
                key += (raw_code, pol_sum, col_scaled)
            if p_dependent:
                key += (round(P_mean, 12),)
            m = DataBunch(
                datafile=datafile, iarch=iarch, ok=ok, nbin=nbin,
                freqs0=freqs0,
                okc=[np.flatnonzero(masks[j] > 0) for j in range(len(ok))],
                epochs=[d.epochs[isub] for isub in ok],
                Ps=[float(d.Ps[isub]) for isub in ok],
                subtimes=[float(d.subtimes[isub]) for isub in ok],
                backend_delay=d.backend_delay, backend=d.backend,
                frontend=d.frontend, telescope=d.telescope,
                telescope_code=d.telescope_code)

            def factory():
                return _Bucket(freqs0, nbin, modelx, (),
                               kind="raw" if raw_mode else "dec",
                               raw_code=raw_code, pol_sum=pol_sum,
                               col_scaled=col_scaled)

            def fill(b, j, isub):
                if raw_mode:
                    b.raw.append(d.raw[isub])
                    b.scl.append(d.scl[isub])
                    b.offs.append(d.offs[isub])
                    if col_scaled:
                        b.tscal.append(tscal_val)
                        b.tzero.append(tzero_val)
                    # dedispersed on disk: the bucket program restores
                    # the stored DM's delays (REF_FREQ honoured)
                    b.dedisp.append(
                        (float(d.DM) if d.get("dmc") else 0.0,
                         float(d.get("dedisp_nu") or d.get("nu0", 0.0)
                               or 0.0)))
                else:
                    b.ports.append(np.asarray(d.subints[isub, 0]))
                    b.noise.append(np.asarray(d.noise_stds[isub, 0], float))
                b.masks.append(masks[j])
                b.Ps.append(float(d.Ps[isub]))
                b.owners.append((iarch, isub))

            return m, [(key, factory,
                        lambda b, j=j, isub=int(isub): fill(b, j, isub))
                       for j, isub in enumerate(ok)]

        def launch(self, b, pipeline, seq):
            return _launch_nb(b, pipeline, seq, fit_scat, log10_tau,
                              tau_mode, tau_args, max_iter,
                              zap_nstd=zap_nstd_run)

        def scatter(self, out, owners, extra, results):
            for i, owner in enumerate(owners):
                results[owner] = out[:, i]  # (nfield, nchan)

        def assemble(self, m, results):
            toas = []
            n_cut = 0
            saw_keep = False
            for j, isub in enumerate(m.ok):
                r = results.get((m.iarch, int(isub)))
                if r is None:
                    continue
                vals = dict(zip(keys, r))
                saw_keep = saw_keep or "keep" in vals
                P = m.Ps[j]
                for ichan in m.okc[j]:
                    if "keep" in vals and not vals["keep"][ichan] > 0:
                        # cut by the raw bucket's inline zap
                        n_cut += 1
                        continue
                    flags = {
                        "be": m.backend, "fe": m.frontend,
                        "f": f"{m.frontend}_{m.backend}",
                        "nbin": int(m.nbin), "subint": int(isub),
                        "chan": int(ichan), "tobs": m.subtimes[j],
                        "tmplt": str(modelfile),
                        "snr": float(vals["snr"][ichan]),
                        "gof": float(vals["gof"][ichan]),
                    }
                    if fit_scat:
                        flags.update(scat_time_flags(
                            float(vals["tau"][ichan]),
                            float(vals["tau_err"][ichan]), P, log10_tau))
                        flags["scat_ref_freq"] = float(m.freqs0[ichan])
                    if print_phase:
                        flags["phs"] = float(vals["phase"][ichan])
                        flags["phs_err"] = float(vals["phase_err"][ichan])
                    flags.update(addtnl_toa_flags)
                    toas.append(TOA(
                        m.datafile, float(m.freqs0[ichan]),
                        m.epochs[j].add_seconds(
                            float(vals["phase"][ichan]) * P
                            + m.backend_delay),
                        float(vals["phase_err"][ichan]) * P * 1e6,
                        m.telescope, m.telescope_code, None, None, flags))
            if saw_keep and tracer.enabled:
                # the raw buckets' inline cut, one proposal per archive
                # (decoded archives emitted theirs at prepare)
                tracer.emit("zap_propose", datafile=m.datafile,
                            n_channels=n_cut, n_iter=0, device=True,
                            wall_s=0.0)
                if n_cut:
                    tracer.emit("zap_apply", datafile=m.datafile,
                                n_channels=n_cut)
            return (toas,)

    return _NarrowbandLane(), _loader


def stream_narrowband_TOAs(datafiles, modelfile, nsub_batch=64,
                           fit_scat=False, log10_tau=True, scat_guess=None,
                           tscrunch=False, max_iter=25, prefetch=True,
                           max_inflight=None, print_phase=False,
                           addtnl_toa_flags={}, tim_out=None, quiet=False,
                           resume=False, skip_archives=None,
                           stream_devices=None, telemetry=None,
                           pipeline_depth=None, zap_inline=False,
                           zap_nstd=None, device=None):
    """Campaign-scale narrowband TOAs: one TOA per usable channel of
    every subint (GetTOAs.get_narrowband_TOAs semantics, fit_scat
    included), with stream_wideband_TOAs' raw-lane loads, bucketing,
    per-device copy -> fit pipelines, in-order checkpoints and resume.
    Raw buckets decode on the device (the plain decode; no kernel of the
    port runs on this lane, as no Pallas kernel does in the JAX
    package); archives the raw lane refuses go through the host-decoded
    lane with the same fits.  Devices as stream_wideband_TOAs.
    zap_inline=True runs the ppzap median noise cut inline: raw buckets
    cut on the noise the bucket program computed on the device, decoded
    archives at prepare, and no TOA is emitted for a cut channel; the
    surviving channels' TOAs equal an unzapped run's.  zap_nstd: the
    threshold in stds (None = config.zap_nstd / PPT_ZAP_NSTD); read only
    with zap_inline.  telemetry as stream_wideband_TOAs (the narrowband
    copy stage never runs the transport codec, as in the JAX package).
    Returns a DataBunch(TOA_list, order, fit_duration,
    scatter_duration, nfit, devices_used, peak_inflight,
    dispatch_shapes, h2d_bytes, h2d_bytes_logical, h2d_duration,
    h2d_overlap_duration, wall)."""
    if isinstance(datafiles, str):
        datafiles = (_read_metafile(datafiles) if _is_metafile(datafiles)
                     else [datafiles])
    else:
        datafiles = list(datafiles)
    if stream_devices is None and device is not None:
        stream_devices = [device]
    tracer, own_tracer = resolve_tracer(telemetry,
                                        run="stream_narrowband_TOAs")
    t_start = time.time()
    try:
        devices = resolve_stream_devices(stream_devices)
        lane, loader = make_narrowband_lane(
            modelfile, fit_scat=fit_scat, log10_tau=log10_tau,
            scat_guess=scat_guess, tscrunch=tscrunch, max_iter=max_iter,
            print_phase=print_phase, addtnl_toa_flags=addtnl_toa_flags,
            quiet=quiet, zap_inline=zap_inline, zap_nstd=zap_nstd,
            device=devices[0], tracer=tracer)
        ex = _StreamExecutor(lane, datafiles, loader, nsub_batch,
                             max_inflight=max_inflight, prefetch=prefetch,
                             tim_out=tim_out, resume=resume,
                             skip_archives=skip_archives, quiet=quiet,
                             stream_devices=devices, tracer=tracer,
                             pipeline_depth=pipeline_depth)
        meta, assembled = ex.run()
        TOA_list, order = [], []
        for m in meta:
            TOA_list.extend(assembled[m.iarch][0])
            order.append(m.datafile)
        wall = time.time() - t_start
        n = len(TOA_list)
        log(f"streamed {n} narrowband TOAs from {len(order)} archives in "
            f"{wall:.2f} s ({ex.nfit} dispatches across "
            f"{len(ex.devices_used)} device(s), {ex.fit_duration:.2f} s "
            f"blocked on devices, {n / max(wall, 1e-9):.1f} TOAs/s end to "
            "end)", quiet=quiet, tracer=tracer)
        _emit_run_end(tracer, "stream_narrowband_TOAs", ex, n, len(order),
                      wall)
    finally:
        if own_tracer:
            tracer.close()
    return DataBunch(TOA_list=TOA_list, order=order,
                     fit_duration=ex.fit_duration,
                     scatter_duration=ex.scatter_duration, nfit=ex.nfit,
                     devices_used=len(ex.devices_used),
                     peak_inflight=ex.peak_inflight,
                     dispatch_shapes=dict(ex.dispatch_shapes),
                     h2d_bytes=int(ex.h2d_bytes),
                     h2d_bytes_logical=int(ex.h2d_logical_bytes),
                     h2d_duration=ex.h2d_duration,
                     h2d_overlap_duration=ex.h2d_overlap_duration,
                     wall=wall)
