"""On-device PSRFITS sample decode (counterpart of pulseportraiture_tpu/ops/decode.py).

The streaming campaign lane ships the UNDECODED DATA column payload to
the device and decodes it there: the bit-plane unpack of sub-byte
packed samples, the affine sample reconstruction per TFORM sample type
(with general FITS column TSCAL/TZERO scaling), the min-window baseline
and the polarization reduction to Stokes I.  Same codes, same operation
order as the JAX package, so the two decode the same bytes to the same
values (integer unpack exactly; the float affine to rounding).

Sample-type codes (``RAW_CODES``): 'i16' int16, 'u8' unsigned byte,
'i8' signed byte stored unsigned with TZERO=-128, 'f32' float32, and
'p1'/'p2'/'p4' sub-byte packed unsigned samples (MSB-first per byte).
"""

import torch

from .noise import min_window_baseline

__all__ = ["RAW_CODES", "PACKED_BITS", "unpack_bitplanes", "decode_transport",
           "affine_decode", "decode_stokes_I"]

RAW_CODES = ("i16", "u8", "i8", "f32", "p1", "p2", "p4")

# packed sub-byte codes -> bits per sample
PACKED_BITS = {"p1": 1, "p2": 2, "p4": 4}


def unpack_bitplanes(packed, nbit, nsamp):
    """Unpack MSB-first ``nbit``-wide samples from a packed byte
    payload: (..., nbytes) uint8 -> (..., nsamp) uint8 sample values.
    Within each byte the FIRST sample occupies the most significant
    bits; ``nsamp`` trims trailing byte padding."""
    if nbit not in (1, 2, 4):
        raise ValueError(f"unpack_bitplanes: nbit must be 1, 2 or 4, "
                         f"got {nbit}")
    per = 8 // nbit
    mask = (1 << nbit) - 1
    shifts = torch.arange(per - 1, -1, -1, device=packed.device,
                          dtype=torch.uint8) * nbit
    samples = (packed[..., :, None] >> shifts) & mask
    samples = samples.reshape(packed.shape[:-1]
                              + (packed.shape[-1] * per,))
    return samples[..., :nsamp]


def decode_transport(packed, pack_w, vmin, shape, ft):
    """The transport codec's device stage (io/blockcodec): (nb, nbytes)
    uint8 residuals packed at ``pack_w`` bits (8: one residual per
    byte) plus the per-subint minima ``vmin`` (nb,) -> the original
    integer samples of ``shape`` (nb, ...) as ``ft``.  Every residual is
    below 2**8 and every sample below 2**24, so the result is exact in
    float32."""
    nsamp = 1
    for n in shape[1:]:
        nsamp *= int(n)
    v = packed if pack_w == 8 else unpack_bitplanes(packed, pack_w, nsamp)
    v = v[:, :nsamp].reshape(tuple(shape)).to(ft)
    return v + vmin.to(ft).reshape((-1,) + (1,) * (len(shape) - 1))


def _bcast_row(v, x):
    """Broadcast a per-subint (nb,) vector against x (nb, ..., nbin)."""
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


def affine_decode(raw, scl, offs, ft, code="i16", tscal=None, tzero=None):
    """Physical amplitudes ``x * scl + offs`` per channel in dtype
    ``ft``: the signed-byte bias removed first for code 'i8', general
    column scaling (tscal/tzero, per-subint scalars) applied before
    DAT_SCL/DAT_OFFS.  raw: (..., nchan, nbin) sample values (packed
    codes unpacked first); scl/offs: (..., nchan)."""
    if code not in RAW_CODES:
        raise ValueError(f"unknown raw sample code {code!r}; "
                         f"known: {RAW_CODES}")
    x = raw.to(ft)
    if code == "i8":
        x = x - 128.0
    if tscal is not None:
        x = x * _bcast_row(tscal.to(ft), x) + _bcast_row(tzero.to(ft), x)
    return x * scl.to(ft)[..., None] + offs.to(ft)[..., None]


def decode_stokes_I(raw, scl, offs, ft, code="i16", pol_sum=False,
                    nbin=None, tscal=None, tzero=None):
    """The full decode stage of a raw bucket: sub-byte unpack (packed
    codes), affine decode, min-window baseline subtraction, and the
    two-pol reduction to Stokes I.

    pol_sum=False: raw is (nb, nchan, nbin), or (nb, plane_bytes)
    packed bytes.  pol_sum=True: raw is (nb, 2, nchan, nbin) (or
    (nb, 2, plane_bytes) packed), decoded and baselined PER POL, then
    summed.  ``nbin`` is required for packed codes."""
    nbit = PACKED_BITS.get(code)
    if nbit is not None:
        if nbin is None:
            raise ValueError(
                f"decode_stokes_I: packed code {code!r} needs nbin "
                "for the unpack geometry")
        nchan = scl.shape[-1]
        raw = unpack_bitplanes(raw, nbit, nchan * nbin)
        raw = raw.reshape(raw.shape[:-1] + (nchan, nbin))
    x = affine_decode(raw, scl, offs, ft, code=code, tscal=tscal,
                      tzero=tzero)
    x = x - min_window_baseline(x)[..., None]
    if pol_sum:
        if x.dim() < 4:
            raise ValueError(
                f"pol_sum needs a (nb, 2, nchan, nbin) payload; got "
                f"shape {tuple(x.shape)}")
        x = x[..., 0, :, :] + x[..., 1, :, :]
    return x
