"""The per-request result codec and the durable ``.tim`` primitives
(counterpart of pulseportraiture_tpu/serve/codec.py).

- :func:`encode_result` / :func:`decode_result`: the JSON-safe
  per-request DataBunch codec (an MJD ships as an exact (int day, f64
  frac) pair; flag values keep the bool/int/float/str distinction the
  ``.tim`` formatting branches on, numpy scalars narrowed to builtins).
- :func:`roundtrip_result`: encode, JSON bytes, decode: what the
  socket transport does to a result, which ``InProcTransport`` repeats.
- :func:`write_tim_result`: writes a request's ``.tim`` from a result,
  byte-identical to the server's own demux (truncate, then per-archive
  TOA lines and a completion sentinel), atomically; the result cache
  stores entries through it, and the router writes the codec lane's,
  hedges' and failover replacements' ``.tim`` files through it.
- :func:`copy_tim_atomic`: the cache hit path's atomic byte copy.
- :func:`tim_complete` / :func:`read_tim_result`: a ``.tim`` that
  carries a completion sentinel for every request datafile is a
  durable result; ``read_tim_result`` recovers it (the router's
  exactly-once failover collects such a request from its file instead
  of fitting it again).  The recovered TOAs
  re-serialize byte-identically, but the in-memory DeltaDM statistics
  are not in the file: the recovered DataBunch carries ``DM0s=[None
  ...]``, NaN DeltaDM_means/errs and ``recovered_from_tim=True``.
"""

import json
import math
import numbers
import os

import numpy as np

from ..utils.bunch import DataBunch

__all__ = ["encode_result", "decode_result", "roundtrip_result",
           "iter_archive_toas",
           "write_tim_result", "copy_tim_atomic", "tim_complete",
           "read_tim_result"]


def _flag_value(v):
    """Narrow a flag value to what JSON round-trips: the
    bool/int/float/str distinction matters downstream (.tim
    formatting branches on it), and numpy scalars (incl. np.bool_,
    which json.dumps rejects outright) must narrow to the builtin."""
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return float(v)
    return v


def _encode_toa(t):
    # MJD ships as (int day, float64 frac) — json round-trips float64
    # by shortest-repr exactly, so epoch precision survives the wire
    return {"archive": t.archive, "frequency": float(t.frequency),
            "mjd": [int(t.MJD.day), float(t.MJD.frac)],
            "toa_error": float(t.TOA_error), "telescope": t.telescope,
            "telescope_code": t.telescope_code,
            "dm": None if t.DM is None else float(t.DM),
            "dm_error": (None if t.DM_error is None
                         else float(t.DM_error)),
            "flags": {k: _flag_value(v) for k, v in t.flags.items()}}


def _decode_toa(d):
    from ..io.tim import TOA
    from ..utils.mjd import MJD

    day, frac = d["mjd"]
    return TOA(d["archive"], d["frequency"], MJD(int(day), float(frac)),
               d["toa_error"], d["telescope"], d["telescope_code"],
               DM=d["dm"], DM_error=d["dm_error"], flags=d["flags"])


def encode_result(res):
    """Per-request DataBunch (serve/server._maybe_complete's shape) ->
    a JSON-safe dict."""
    return {"toas": [_encode_toa(t) for t in res.TOA_list],
            "order": list(res.order),
            "DM0s": [None if v is None else float(v)
                     for v in res.DM0s],
            "DeltaDM_means": [float(v) for v in res.DeltaDM_means],
            "DeltaDM_errs": [float(v) for v in res.DeltaDM_errs],
            "tim_out": res.tim_out, "n_skipped": int(res.n_skipped)}


def decode_result(d):
    return DataBunch(TOA_list=[_decode_toa(t) for t in d["toas"]],
                     order=list(d["order"]), DM0s=list(d["DM0s"]),
                     DeltaDM_means=list(d["DeltaDM_means"]),
                     DeltaDM_errs=list(d["DeltaDM_errs"]),
                     tim_out=d["tim_out"],
                     n_skipped=int(d["n_skipped"]))


# ---------------------------------------------------------------------------
# .tim writers
# ---------------------------------------------------------------------------

def roundtrip_result(res):
    """Encode -> JSON bytes -> decode, exactly what the socket lane does
    (InProcTransport rides it, so both transports return the same result
    shapes and the codec runs wherever the router does)."""
    return decode_result(json.loads(
        json.dumps(encode_result(res), separators=(",", ":"))))


def iter_archive_toas(result):
    """Split ``result.TOA_list`` into per-archive runs following
    ``result.order`` — the inverse of ``_collect_wideband``'s
    concatenation.  Relies on the demux invariant that TOA.archive is
    the submitted datafile path and each archive's TOAs are contiguous
    in request-archive order; refuses adjacent duplicate order entries
    (the grouping would be ambiguous)."""
    toas = list(result.TOA_list)
    i = 0
    prev = object()
    for datafile in result.order:
        if datafile == prev:
            raise ValueError(
                f"result order lists {datafile!r} twice in a row — "
                "per-archive TOA grouping is ambiguous")
        prev = datafile
        j = i
        while j < len(toas) and toas[j].archive == datafile:
            j += 1
        yield datafile, toas[i:j]
        i = j
    if i != len(toas):
        raise ValueError(
            f"{len(toas) - i} TOA(s) name archives missing from the "
            "result order — the payload does not demux")


def write_tim_result(result, tim_out):
    """Write a request's ``.tim`` from its result, byte-identical to
    the server's demux (per-archive TOA lines + completion sentinel,
    through the same write_TOAs path).  The write is atomic (temp file
    + os.replace): a reader, a crash or a concurrent writer on the
    same path never sees a torn file from this writer."""
    from ..io.tim import write_TOAs
    from ..pipeline.stream import _DONE_PREFIX

    tmp = tim_out + ".tmp~"
    open(tmp, "w").close()
    for datafile, toas in iter_archive_toas(result):
        write_TOAs(toas, outfile=tmp, append=True)
        with open(tmp, "a") as fh:
            fh.write(_DONE_PREFIX + os.path.abspath(datafile) + "\n")
    os.replace(tmp, tim_out)
    return tim_out


def copy_tim_atomic(src, dst):
    """Byte-copy a durable ``.tim`` (or any completed payload file) to
    ``dst`` with the same temp-then-``os.replace`` discipline as
    :func:`write_tim_result`.  The result-cache hit path serves stored
    entries through this — a hit's output is the stored bytes EXACTLY,
    never a re-serialization, so hit == fresh fit at the byte level
    holds by construction rather than by round-trip proof."""
    tmp = dst + ".tmp~"
    with open(src, "rb") as fin, open(tmp, "wb") as fout:
        while True:
            chunk = fin.read(1 << 20)
            if not chunk:
                break
            fout.write(chunk)
    os.replace(tmp, dst)
    return dst


# ---------------------------------------------------------------------------
# durable .tim results
# ---------------------------------------------------------------------------

def tim_complete(tim_out, datafiles):
    """True when the ``.tim`` at ``tim_out`` carries a completion
    sentinel for EVERY request datafile — the request's fit work is
    durable and must not be re-dispatched.  Sentinel parsing (incl.
    the torn-tail rule) is the stream checkpointer's
    ``checkpoint_completed``, so the two consumers of the format
    cannot drift.  A request that skipped archives writes fewer
    sentinels and reads as incomplete here."""
    from ..pipeline.stream import checkpoint_completed

    done = checkpoint_completed(tim_out)
    return bool(done) and all(os.path.abspath(str(f)) in done
                              for f in datafiles)


def read_tim_result(tim_out):
    """Recover a per-request result from its durable ``.tim`` (the
    result cache's hit path).

    The recovered TOAs re-serialize byte-identically (every numeric
    field round-trips through its .tim formatting; flags come back as
    the verbatim strings toa_string writes verbatim), so the ``.tim``
    product is exact.  The DeltaDM summary is NOT in the file: DM0s
    are None, DeltaDM_means/errs NaN, and ``recovered_from_tim=True``
    marks the bunch."""
    from ..io.tim import TOA
    from ..pipeline.stream import _DONE_PREFIX
    from ..timing.tim import read_tim
    from ..utils.mjd import MJD

    TOA_list, order = [], []
    run_lines = []
    with open(tim_out) as fh:
        for line in fh:
            if line.startswith(_DONE_PREFIX):
                datafile = line[len(_DONE_PREFIX):].strip()
                run = read_tim(run_lines)
                if run:
                    # order entries must match TOA.archive (the
                    # SUBMITTED path — iter_archive_toas groups on it);
                    # the sentinel's abspath only covers 0-TOA archives
                    datafile = run[0].archive
                for tt in run:
                    flags = dict(tt.flags)
                    flags.pop("pp_dm", None)
                    flags.pop("pp_dme", None)
                    TOA_list.append(TOA(
                        tt.archive, tt.frequency,
                        MJD(tt.mjd_int, tt.mjd_frac), tt.error_us,
                        tt.site, tt.site, DM=tt.dm,
                        DM_error=tt.dm_err, flags=flags))
                order.append(datafile)
                run_lines = []
            else:
                run_lines.append(line)
    if run_lines and any(ln.strip() for ln in run_lines):
        raise ValueError(
            f"{tim_out}: trailing TOA lines with no completion "
            "sentinel — the file is not a completed request "
            "checkpoint")
    n = len(order)
    return DataBunch(TOA_list=TOA_list, order=order, DM0s=[None] * n,
                     DeltaDM_means=[math.nan] * n,
                     DeltaDM_errs=[math.nan] * n, tim_out=tim_out,
                     n_skipped=0, recovered_from_tim=True)
