"""Lossless block codec and transport cost model of the stream's raw
copy stage (counterpart of pulseportraiture_tpu/io/blockcodec.py, a
NumPy copy).

An optional, LOSSLESS width reduction of integer raw payloads in the
bitshuffle tradition (Masui et al. 2015), restricted to a fixed-size
transform the device inverts inside the bucket program:

- **Encode (host, here):** a dispatch's stacked integer payload is
  scanned per subint row for its dynamic range; when every row's span
  fits a bit width narrower than the wire dtype (1/2/4/8 of 8- or
  16-bit samples), the payload ships as MSB-first packed ``w``-bit
  residuals plus one per-row minimum: an int16 payload whose rows span
  < 16 levels ships 4x fewer bytes.
- **Decode (device, ops/decode.decode_transport):** the bit-plane
  unpack the sub-byte NBIT lane uses (ops/decode.unpack_bitplanes),
  plus one add of the per-row minimum.  Every integer involved is
  below 2**24, so the decode is exact in float32 and the ``.tim``
  output is identical compressed or not.

The **cost model** decides per dispatch whether compressing pays: the
copy stage feeds it the link rate it measured on its own copies and
the codec rate of its own encodes, and ``predict`` compares the
predicted codec wall against the predicted link saving.
``config.transport_compress`` picks the policy: False = never,
'auto' = the cost model, True = always when the payload is
compressible (the deterministic A/B arm).
"""

import numpy as np

__all__ = ["probe_width", "encode_rows", "decode_rows", "CostModel",
           "resolve_transport_compress"]

# widths the device unpack supports (8 ships plain u8 residuals)
_WIDTHS = (1, 2, 4, 8)


def resolve_transport_compress(value=None):
    """Resolve a transport_compress knob value (None reads config) to
    False / 'auto' / True, loud on anything else."""
    from .. import config

    if value is None:
        value = getattr(config, "transport_compress", False)
    if value in (False, True, "auto"):
        return value
    raise ValueError(
        "transport_compress must be False, 'auto' or True; got "
        f"{value!r}")


def probe_width(arr):
    """Scan an integer payload's dynamic range: (nb, ...) ->
    (vmin (nb,) float32, width or None).

    width is the narrowest supported bit width holding every row's
    (value - row min) residual, or None when no width below the wire
    dtype's helps (the common full-range-quantized archive) or the
    per-row sample count does not pack to whole bytes."""
    if arr.dtype.kind not in "iu":
        return None, None
    flat = arr.reshape(arr.shape[0], -1)
    nsamp = flat.shape[1]
    vmin = flat.min(axis=1)
    # widen BEFORE subtracting: a full-range int16 span (~60000)
    # overflows int16 arithmetic and would falsely read as tiny
    span = int((flat.max(axis=1).astype(np.int64)
                - vmin.astype(np.int64)).max(initial=0))
    native = arr.dtype.itemsize * 8
    for w in _WIDTHS:
        if w >= native:
            return None, None
        if span < (1 << w) and nsamp % (8 // w) == 0:
            return vmin.astype(np.float32), w
    return None, None


def encode_rows(arr, vmin, width):
    """Pack integer payload residuals at ``width`` bits, MSB-first:
    (nb, ...) + per-row vmin -> (nb, nbytes) uint8.  The exact inverse
    is ops/decode.decode_transport (device) or :func:`decode_rows`
    (host oracle)."""
    flat = arr.reshape(arr.shape[0], -1)
    # residuals fit a byte by the probe_width contract (w <= 8), but
    # the SUBTRACTION must run widened — int16 - int16 can overflow
    v = (flat.astype(np.int32)
         - np.asarray(vmin, np.int32)[:, None]).astype(np.uint8)
    if width == 8:
        return v
    per = 8 // width
    grp = v.reshape(v.shape[0], v.shape[1] // per, per)
    out = np.zeros(grp.shape[:2], np.uint8)
    for j in range(per):
        out |= (grp[:, :, j] & ((1 << width) - 1)) \
            << np.uint8((per - 1 - j) * width)
    return out


def decode_rows(packed, vmin, width, shape, dtype):
    """Host-side inverse of :func:`encode_rows` (the codec round-trip
    oracle the property tests pin the device decode against)."""
    if width == 8:
        v = packed.astype(np.int64)
    else:
        per = 8 // width
        shifts = (np.arange(per - 1, -1, -1) * width).astype(np.uint8)
        v = ((packed[:, :, None] >> shifts) & ((1 << width) - 1))
        v = v.reshape(packed.shape[0], -1).astype(np.int64)
    nsamp = int(np.prod(shape[1:], dtype=int))
    v = v[:, :nsamp] + np.asarray(vmin, np.int64)[:, None]
    return v.reshape(shape).astype(dtype)


class CostModel:
    """Per-pipeline (per-device) transport cost model.

    ``observe_link`` feeds it each copy's shipped bytes/seconds (the
    same numbers the ``h2d_done`` event records); ``observe_codec``
    each encode's logical bytes/seconds.  ``predict`` answers "would
    compressing this payload have saved wall?": predicted codec wall
    (logical_bytes / codec rate) vs predicted link savings
    (bytes saved / link rate).  Until a link copy has been measured it
    always answers False — 'auto' must never speculate on an unknown
    link (the never-engages-at-a-loss gate)."""

    #: seed codec rate [bytes/s]: numpy bit-packing is memory-bound;
    #: a deliberately conservative figure so the first engagement
    #: decision under-promises (it re-learns from real encodes).
    CODEC_BPS_SEED = 300e6
    _ALPHA = 0.5  # EWMA weight of the newest observation

    def __init__(self):
        self.link_bps = None
        self.codec_bps = self.CODEC_BPS_SEED

    def _ewma(self, old, new):
        return new if old is None else \
            (1.0 - self._ALPHA) * old + self._ALPHA * new

    def observe_link(self, nbytes, seconds):
        if nbytes > 0 and seconds > 0:
            self.link_bps = self._ewma(self.link_bps, nbytes / seconds)

    def observe_codec(self, nbytes, seconds):
        if nbytes > 0 and seconds > 0:
            self.codec_bps = self._ewma(self.codec_bps,
                                        nbytes / seconds)

    def predict(self, logical_bytes, shipped_bytes):
        """True when compressing logical->shipped bytes is predicted
        to win wall time on this link."""
        if self.link_bps is None or shipped_bytes >= logical_bytes:
            return False
        saving_s = (logical_bytes - shipped_bytes) / self.link_bps
        codec_s = logical_bytes / self.codec_bps
        return saving_s > codec_s
