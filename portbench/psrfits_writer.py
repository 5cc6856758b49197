"""A PSRFITS fold-mode writer for the benchmark's pool.

The FITS card and binary-table code is a reduced copy of the port's plain
NumPy writer (``pulseportraiture_tpu_torch/io/fitsio.py``: ``_format_value``,
``_format_card``, ``_write_header``, ``write_bintable``), so the files the
benchmark makes do not change when the program's writer does.  The header
keys are the ones the port's reader uses for a fold-mode archive with int16
``DATA``, ``DAT_SCL`` and ``DAT_OFFS``.
"""

import math

import numpy as np

BLOCK = 2880
CARDLEN = 80


def _format_value(value):
    if isinstance(value, bool):
        return "T".rjust(20) if value else "F".rjust(20)
    if isinstance(value, (int, np.integer)):
        return str(int(value)).rjust(20)
    if isinstance(value, (float, np.floating)):
        v = float(value)
        if v != v or math.isinf(v):
            raise ValueError(f"non-finite header value: {v}")
        s = repr(v)
        if len(s) > 20:
            s = f"{v:.13E}"
        return s.rjust(20)
    s = str(value).replace("'", "''")
    return ("'" + s.ljust(8) + "'").ljust(20)


def _format_card(key, value):
    card = key.ljust(8) + "= " + _format_value(value)
    return card[:CARDLEN].ljust(CARDLEN)


def _write_header(f, cards):
    out = bytearray()
    for card in cards:
        out += _format_card(*card).encode("ascii")
    out += b"END".ljust(CARDLEN)
    out += b" " * ((-len(out)) % BLOCK)
    f.write(bytes(out))


def _pad_block(f, nbytes):
    pad = (-nbytes) % BLOCK
    if pad:
        f.write(b"\x00" * pad)


def _tform(arr):
    code = {"i2": "I", "f4": "E", "f8": "D"}[
        arr.dtype.newbyteorder("=").str[1:]]
    return f"{int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1}{code}"


def write_bintable(f, name, columns, header_cards=(), tdims=None):
    """One BINTABLE HDU; ``columns`` maps a name to an array whose first
    axis is the row, ``tdims`` a name to its TDIM (FITS order)."""
    tdims = tdims or {}
    names = list(columns)
    nrows = len(columns[names[0]])
    fields, cards = [], []
    for i, cname in enumerate(names, 1):
        arr = columns[cname]
        be = ">" + arr.dtype.newbyteorder("=").str[1:]
        fields.append((f"f{i}", be, arr.shape[1:]) if arr.ndim > 1
                      else (f"f{i}", be))
        cards.append((f"TTYPE{i}", cname))
        cards.append((f"TFORM{i}", _tform(arr)))
        if cname in tdims:
            cards.append((f"TDIM{i}",
                          "(" + ",".join(str(d) for d in tdims[cname])
                          + ")"))
    dt = np.dtype(fields)
    rec = np.empty(nrows, dtype=dt)
    for i, cname in enumerate(names, 1):
        rec[f"f{i}"] = columns[cname]
    head = [("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
            ("NAXIS1", dt.itemsize), ("NAXIS2", nrows), ("PCOUNT", 0),
            ("GCOUNT", 1), ("TFIELDS", len(names))]
    head += cards + [("EXTNAME", name)] + list(header_cards)
    _write_header(f, head)
    raw = rec.tobytes()
    f.write(raw)
    _pad_block(f, len(raw))


def write_fold_archive(f, q, scl, offs, freqs, period_s, tsub_s, start,
                       meta):
    """One fold-mode archive into the binary file ``f``: ``q`` (nsub,
    nchan, nbin) int16 samples, ``scl``/``offs`` (nsub, nchan) float32,
    ``freqs`` (nchan,) MHz, one folding period for every subint,
    ``start`` = (STT_IMJD, STT_SMJD, STT_OFFS) and the subint centres at
    (i + 1/2) tsub_s after it.  ``meta``: source, telescope, frontend,
    backend, centre_mhz, bw_mhz and dm.  The archive is marked
    barycentred (PPTBARY), so every Doppler factor is 1, and not
    dedispersed."""
    nsub, nchan, nbin = q.shape
    imjd, smjd, soffs = start
    _write_header(f, [
        ("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0), ("EXTEND", True),
        ("FITSTYPE", "PSRFITS"), ("OBS_MODE", "PSR"),
        ("SRC_NAME", meta["source"]), ("TELESCOP", meta["telescope"]),
        ("FRONTEND", meta["frontend"]), ("BACKEND", meta["backend"]),
        ("BE_DELAY", 0.0), ("OBSFREQ", float(meta["centre_mhz"])),
        ("OBSBW", float(meta["bw_mhz"])), ("OBSNCHAN", nchan),
        ("STT_IMJD", int(imjd)), ("STT_SMJD", int(smjd)),
        ("STT_OFFS", float(soffs)), ("PPTBARY", True)])
    cols = {
        "TSUBINT": np.full(nsub, float(tsub_s)),
        "OFFS_SUB": (np.arange(nsub) + 0.5) * float(tsub_s),
        "PERIOD": np.full(nsub, float(period_s)),
        "DAT_FREQ": np.broadcast_to(np.asarray(freqs, np.float64),
                                    (nsub, nchan)),
        "DAT_WTS": np.ones((nsub, nchan), np.float32),
        "DAT_OFFS": np.asarray(offs, np.float32),
        "DAT_SCL": np.asarray(scl, np.float32),
        "DATA": np.asarray(q, np.int16).reshape(nsub, 1, nchan, nbin),
    }
    write_bintable(f, "SUBINT", cols, header_cards=[
        ("POL_TYPE", "INTEN"), ("NBIN", nbin), ("NCHAN", nchan),
        ("NPOL", 1), ("NSBLK", 1), ("INT_TYPE", "TIME"),
        ("CHAN_BW", float(meta["bw_mhz"]) / nchan),
        ("DM", float(meta["dm"])), ("DEDISP", False)],
        tdims={"DATA": (nbin, nchan, 1)})
