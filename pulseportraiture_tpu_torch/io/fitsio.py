"""Minimal FITS codec (read + write), dependency-free.

The reference reaches PSRFITS through the PSRCHIVE C++ bindings
(reference pplib.py:51, load_data pplib.py:2749).  This framework has
no PSRCHIVE and no astropy, so it carries its own small FITS engine:
2880-byte blocks, 80-char header cards, primary HDUs and BINTABLE
extensions — everything PSRFITS fold-mode archives need, nothing more.

Reading returns numpy arrays (big-endian decoded to native); writing
produces standard-conforming files that astropy/PSRCHIVE can open.
A faster C++ decoder for the hot SUBINT path lives in `native/`; this
module is the reference implementation and the writer.
"""

import math
from collections import OrderedDict

import numpy as np

BLOCK = 2880
CARDLEN = 80


class TruncatedFits(ValueError):
    """A FITS file ended mid-header or mid-data: the bytes on disk are
    shorter than the structure the headers promise.  The classic cause
    is reading a file that is STILL BEING WRITTEN (an observatory
    watch-folder racing the telescope backend), so this error is typed
    and marked retryable — the ingest driver catches it and re-admits
    the file once its size stabilizes instead of poisoning the source.
    A torn file that never completes keeps raising; it is still a
    loud ValueError for every non-ingest caller."""

    retryable = True

# TFORM letter -> (numpy big-endian dtype, bytes per element)
_TFORM2DTYPE = {
    "L": ("u1", 1),  # logical, stored as 'T'/'F' bytes
    "B": ("u1", 1),
    "I": (">i2", 2),
    "J": (">i4", 4),
    "K": (">i8", 8),
    "E": (">f4", 4),
    "D": (">f8", 8),
    "C": (">c8", 8),
    "M": (">c16", 16),
}


class Header:
    """Ordered FITS header: keeps card order, dict-style access by key."""

    def __init__(self, cards=None):
        # list of (key, value, comment); COMMENT/HISTORY may repeat
        self.cards = list(cards) if cards else []

    def __contains__(self, key):
        return any(k == key for k, _, _ in self.cards)

    def __getitem__(self, key):
        for k, v, _ in self.cards:
            if k == key:
                return v
        raise KeyError(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key, value):
        comment = ""
        if isinstance(value, tuple):
            value, comment = value
        for i, (k, _, c) in enumerate(self.cards):
            if k == key:
                self.cards[i] = (key, value, comment or c)
                return
        self.cards.append((key, value, comment))

    def append(self, key, value, comment=""):
        self.cards.append((key, value, comment))

    def keys(self):
        return [k for k, _, _ in self.cards]


class HDU:
    """One header-data unit.  `data` is None, an ndarray (image), or an
    OrderedDict of column name -> ndarray (bintable, rows-first).

    For bintables, `raw` keeps the undecoded table payload and
    `layout` maps column name -> (byte_offset, tform_code, repeat) so
    callers (the native SUBINT fast path) can decode columns straight
    from the wire bytes; columns listed in a reader's `defer` set are
    left as None in `data` and must be fetched through these.
    `col_scaling` maps column name -> (TSCAL, TZERO) for every numeric
    column carrying a nontrivial FITS scaling (e.g. the signed-byte
    convention 'B' + TZERO=-128); decoded columns have it applied
    already, deferred columns must apply it themselves."""

    def __init__(self, header, data=None, name="", raw=None, layout=None,
                 col_scaling=None):
        self.header = header
        self.data = data
        self.name = name or header.get("EXTNAME", "")
        self.raw = raw
        self.layout = layout or {}
        self.col_scaling = col_scaling or {}

    @property
    def row_stride(self):
        return int(self.header.get("NAXIS1", 0))


# --------------------------------------------------------------------------
# Card parsing / formatting
# --------------------------------------------------------------------------

def _parse_value(raw):
    s = raw.strip()
    if not s:
        return None
    if s[0] == "'":  # string: '' escapes a quote
        end = 1
        out = []
        while end < len(s):
            if s[end] == "'":
                if end + 1 < len(s) and s[end + 1] == "'":
                    out.append("'")
                    end += 2
                    continue
                break
            out.append(s[end])
            end += 1
        return "".join(out).rstrip()
    if s == "T":
        return True
    if s == "F":
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s.replace("D", "E").replace("d", "e"))
    except ValueError:
        return s


def _parse_card(card):
    key = card[:8].strip()
    if key in ("COMMENT", "HISTORY", "") or card[8:10] != "= ":
        return key, None, card[8:].strip()
    rest = card[10:]
    # split value / comment at first '/' outside a quoted string
    in_str = False
    i = 0
    while i < len(rest):
        c = rest[i]
        if c == "'":
            in_str = not in_str
        elif c == "/" and not in_str:
            break
        i += 1
    value = _parse_value(rest[:i])
    comment = rest[i + 1:].strip() if i < len(rest) else ""
    return key, value, comment


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
    # string
    s = str(value).replace("'", "''")
    return ("'" + s.ljust(8) + "'").ljust(20)


def _format_card(key, value, comment):
    if key in ("COMMENT", "HISTORY", ""):
        card = key.ljust(8) + str(comment)
    elif value is None:
        card = key.ljust(8) + (" " + comment if comment else "")
    else:
        card = key.ljust(8) + "= " + _format_value(value)
        if comment:
            card += " / " + comment
    return card[:CARDLEN].ljust(CARDLEN)


# --------------------------------------------------------------------------
# Reading
# --------------------------------------------------------------------------

def _read_header(buf, off):
    cards = []
    while True:
        block = buf[off:off + BLOCK]
        if len(block) < BLOCK:
            raise TruncatedFits(
                f"truncated FITS header: block at offset {off} holds "
                f"{len(block)} of {BLOCK} bytes")
        off += BLOCK
        done = False
        for i in range(0, BLOCK, CARDLEN):
            card = block[i:i + CARDLEN].decode("ascii", "replace")
            if card.startswith("END") and card[3:].strip() == "":
                done = True
                break
            if card.strip() == "":
                continue
            cards.append(_parse_card(card))
        if done:
            return Header(cards), off


def parse_tform(tform):
    """'2048E' -> (2048, 'E', extra). Variable-length 'P'/'Q' unsupported."""
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    return repeat, code, tform[i + 1:]


def _table_dtype(header):
    tfields = header["TFIELDS"]
    names, fields = [], []
    for n in range(1, tfields + 1):
        name = str(header[f"TTYPE{n}"]).strip()
        repeat, code, _ = parse_tform(str(header[f"TFORM{n}"]))
        if code == "A":
            fields.append((f"f{n}", f"S{repeat}"))
        elif code == "X":
            fields.append((f"f{n}", "u1", ((repeat + 7) // 8,)))
        elif code in _TFORM2DTYPE:
            dt, _ = _TFORM2DTYPE[code]
            fields.append((f"f{n}", dt, (repeat,)) if repeat != 1 else (f"f{n}", dt))
        else:
            raise ValueError(f"unsupported TFORM code {code!r}")
        names.append(name)
    return names, np.dtype(fields)


def apply_column_scaling(col, tscal, tzero):
    """Physical values TZERO + TSCAL*stored.  Integer columns with an
    integral pure offset stay integral (the FITS signed/unsigned
    conventions: 'B'+TZERO=-128 -> signed byte, 'I'+TZERO=32768 ->
    unsigned 16-bit); anything else promotes to float64."""
    if col.dtype.kind in "iu" and tscal == 1.0 \
            and float(tzero).is_integer():
        return col.astype(np.int64) + int(tzero)
    return col.astype(np.float64) * tscal + tzero


def _data_size(header):
    naxis = header.get("NAXIS", 0)
    if naxis == 0:
        return 0
    size = abs(header.get("BITPIX", 8)) // 8
    for i in range(1, naxis + 1):
        size *= header[f"NAXIS{i}"]
    size *= header.get("GCOUNT", 1)
    size += header.get("PCOUNT", 0)
    return size


def _read_hdu(buf, off, defer=()):
    header, off = _read_header(buf, off)
    size = _data_size(header)
    raw = buf[off:off + size]
    if len(raw) < size:
        # a short DATA payload would otherwise surface as an opaque
        # np.frombuffer count mismatch far from the real cause
        raise TruncatedFits(
            f"truncated FITS data: HDU at offset {off} promises "
            f"{size} bytes, file holds {len(raw)}")
    off += ((size + BLOCK - 1) // BLOCK) * BLOCK
    xt = str(header.get("XTENSION", "")).strip()
    data = None
    layout = None
    if xt == "BINTABLE":
        names, dt = _table_dtype(header)
        nrows = header["NAXIS2"]
        # the row stride must equal the summed field widths — decoding
        # a table whose NAXIS1 disagrees would read every row after
        # the first from the wrong offset (silent misparse), so refuse
        if int(header["NAXIS1"]) != dt.itemsize:
            raise ValueError(
                f"BINTABLE NAXIS1={header['NAXIS1']} != "
                f"{dt.itemsize} bytes implied by the TFORM columns")
        rec = np.frombuffer(raw, dtype=dt, count=nrows)
        data = OrderedDict()
        layout = {}
        col_scaling = {}
        for i, name in enumerate(names):
            fname = f"f{i + 1}"
            repeat, code, _ = parse_tform(str(header[f"TFORM{i + 1}"]))
            layout[name] = (int(dt.fields[fname][1]), code, repeat)
            tscal = float(header.get(f"TSCAL{i + 1}", 1.0) or 1.0)
            tzero = float(header.get(f"TZERO{i + 1}", 0.0) or 0.0)
            scaled = (tscal != 1.0 or tzero != 0.0) and code not in "AX"
            if scaled:
                col_scaling[name] = (tscal, tzero)
            if name in defer:
                data[name] = None
                continue
            col = rec[fname]
            tdim = header.get(f"TDIM{i + 1}")
            if tdim:
                shape = tuple(int(x) for x in str(tdim).strip("() ").split(","))
                col = col.reshape((nrows,) + shape[::-1])
            if col.dtype.kind in "iufc":
                col = col.astype(col.dtype.newbyteorder("="))
            if scaled:
                col = apply_column_scaling(col, tscal, tzero)
            data[name] = col
        return HDU(header, data, raw=raw, layout=layout,
                   col_scaling=col_scaling), off
    if size and header.get("NAXIS", 0) > 0:
        bitpix = header["BITPIX"]
        dt = {8: "u1", 16: ">i2", 32: ">i4", 64: ">i8",
              -32: ">f4", -64: ">f8"}[bitpix]
        shape = tuple(header[f"NAXIS{i}"]
                      for i in range(header["NAXIS"], 0, -1))
        data = np.frombuffer(raw, dtype=dt).reshape(shape)
        data = data.astype(np.dtype(dt).newbyteorder("="))
    return HDU(header, data), off


def scan_fits(path):
    """Walk a FITS file's HDU boundaries WITHOUT decoding any data —
    the cheap completeness probe the ingest driver runs before handing
    an archive to the loaders.  Raises :class:`TruncatedFits` when the
    bytes on disk end before the structure the headers promise (the
    half-written-file signature); returns the HDU count otherwise.
    Costs header parsing only, so it is safe to run on every poll."""
    with open(path, "rb") as f:
        buf = f.read()
    n = 0
    off = 0
    while off < len(buf):
        if not buf[off:off + BLOCK].strip():
            break
        header, off = _read_header(buf, off)
        size = _data_size(header)
        if len(buf) < off + size:
            raise TruncatedFits(
                f"truncated FITS data: HDU {n} at offset {off} "
                f"promises {size} bytes, file holds {len(buf) - off}")
        off += ((size + BLOCK - 1) // BLOCK) * BLOCK
        n += 1
    if n == 0:
        raise TruncatedFits(f"{path}: no complete HDU")
    return n


def read_fits(path, defer=()):
    """Read a FITS file -> list of HDU.

    Column names in `defer` are not decoded in bintables (left None in
    `hdu.data`); fetch them from `hdu.raw`/`hdu.layout` — used by the
    native SUBINT fast path to avoid a second pass over the big DATA
    column."""
    with open(path, "rb") as f:
        buf = f.read()
    hdus = []
    off = 0
    while off < len(buf):
        if not buf[off:off + BLOCK].strip():
            break
        hdu, off = _read_hdu(buf, off, defer=defer)
        hdus.append(hdu)
    return hdus


# --------------------------------------------------------------------------
# Writing
# --------------------------------------------------------------------------

def _write_header(f, cards):
    out = bytearray()
    for key, value, comment in cards:
        out += _format_card(key, value, comment).encode("ascii")
    out += b"END".ljust(CARDLEN)
    pad = (-len(out)) % BLOCK
    out += b" " * pad
    f.write(bytes(out))


def _pad_block(f, nbytes):
    pad = (-nbytes) % BLOCK
    if pad:
        f.write(b"\x00" * pad)


def write_primary(f, header_cards):
    cards = [("SIMPLE", True, "file conforms to FITS standard"),
             ("BITPIX", 8, ""), ("NAXIS", 0, ""),
             ("EXTEND", True, "")]
    cards += header_cards
    _write_header(f, cards)


def _column_tform(arr, ncols_shape):
    kind = arr.dtype.kind
    if kind == "S":
        return f"{arr.dtype.itemsize}A", None
    code = {"u1": "B", "i2": "I", "i4": "J", "i8": "K",
            "f4": "E", "f8": "D"}[arr.dtype.newbyteorder("=").str[1:]]
    repeat = int(np.prod(ncols_shape)) if ncols_shape else 1
    return f"{repeat}{code}", code


def write_bintable(f, name, columns, header_cards=(), tdims=None, units=None):
    """columns: OrderedDict name -> ndarray with shape (nrows, ...).
    tdims: optional {colname: shape-tuple (FITS order, fastest first)}."""
    tdims = tdims or {}
    units = units or {}
    names = list(columns)
    nrows = len(next(iter(columns.values()))) if columns else 0
    fields = []
    cards = []
    for i, cname in enumerate(names, 1):
        arr = np.ascontiguousarray(columns[cname])
        if len(arr) != nrows:
            raise ValueError(f"column {cname}: row count mismatch")
        elem_shape = arr.shape[1:]
        tform, code = _column_tform(arr, elem_shape)
        if arr.dtype.kind == "S":
            fields.append((f"f{i}", arr.dtype.str))
        else:
            be = ">" + arr.dtype.newbyteorder("=").str[1:]
            fields.append((f"f{i}", be, elem_shape) if elem_shape
                          else (f"f{i}", be))
        cards.append((f"TTYPE{i}", cname, ""))
        cards.append((f"TFORM{i}", tform, ""))
        if cname in units:
            cards.append((f"TUNIT{i}", units[cname], ""))
        if cname in tdims:
            dim = ",".join(str(d) for d in tdims[cname])
            cards.append((f"TDIM{i}", f"({dim})", ""))
    dt = np.dtype(fields)
    rec = np.zeros(nrows, dtype=dt)
    for i, cname in enumerate(names, 1):
        arr = np.ascontiguousarray(columns[cname])
        if arr.dtype.kind == "S":
            rec[f"f{i}"] = arr
        else:
            rec[f"f{i}"] = arr.reshape(nrows, -1).reshape(
                rec[f"f{i}"].shape)
    head = [("XTENSION", "BINTABLE", "binary table extension"),
            ("BITPIX", 8, ""), ("NAXIS", 2, ""),
            ("NAXIS1", dt.itemsize, "bytes per row"),
            ("NAXIS2", nrows, "number of rows"),
            ("PCOUNT", 0, ""), ("GCOUNT", 1, ""),
            ("TFIELDS", len(names), "")]
    head += cards
    head += [("EXTNAME", name, "")]
    head += list(header_cards)
    _write_header(f, head)
    raw = rec.tobytes()
    f.write(raw)
    _pad_block(f, len(raw))


def get_hdu(hdus, name):
    for h in hdus:
        if str(h.name).strip() == name:
            return h
    raise KeyError(f"no HDU named {name!r}")
