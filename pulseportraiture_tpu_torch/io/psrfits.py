"""PSRFITS fold-mode archives without PSRCHIVE.

The reference delegates all archive access to the PSRCHIVE C++ library
(reference pplib.py:51; load_data pplib.py:2749-2915).  Here the same
capabilities are implemented natively on top of the in-repo FITS codec
(`fitsio.py`): an `Archive` class with the PSRCHIVE-verb API the
reference leans on (dedisperse, remove_baseline, scrunches, state
conversion), `load_data` returning the identical 36-key DataBunch, and
writers for creating/cloning archives (reference pplib.py:3146-3299).

All transforms here are host-side float64 numpy — archive I/O is a
streaming/setup stage, not the TPU hot path.  The hot path receives
plain arrays from the DataBunch.
"""

from collections import OrderedDict

import numpy as np

from ..config import Dconst
from ..utils.bunch import DataBunch
from ..utils.mjd import MJD
from . import fitsio, native
from .telescopes import telescope_code

SECPERDAY = 86400.0


# --------------------------------------------------------------------------
# numpy kernels used at load time (device-free mirrors of ops/)
# --------------------------------------------------------------------------

def _as_float(x):
    """float64 view/cast, except float32 input stays float32 (the
    streaming loader's reduced-precision mode)."""
    x = np.asarray(x)
    return x if x.dtype == np.float32 else np.asarray(x, np.float64)


def noise_std_ps(data, frac=0.25):
    """Off-pulse noise std from the top-``frac`` power spectrum (numpy
    mirror of ops.noise.get_noise_PS; reference pplib.py:2312-2338)."""
    data = _as_float(data)
    nbin = data.shape[-1]
    X = np.fft.rfft(data, axis=-1)
    kc = int((1.0 - frac) * X.shape[-1])
    power = np.abs(X[..., kc:]) ** 2.0
    return np.sqrt(power.mean(axis=-1) / nbin)


def profile_snr(profile, noise=None, fudge=3.25):
    """Equivalent-width S/N (numpy mirror of ops.noise.get_SNR;
    reference pplib.py:2376-2395)."""
    p = _as_float(profile)
    p = p - np.median(p, axis=-1, keepdims=True)
    if noise is None:
        noise = noise_std_ps(p)
    noise = np.maximum(np.asarray(noise, np.float64), 1e-30)
    # f64-accumulated sums: the equivalent-width ratio is a difference
    # of large sums even in the f32 loader mode
    psum = np.abs(p.sum(axis=-1, dtype=np.float64))
    peak = np.maximum(np.abs(p).max(axis=-1), 1e-30)
    weq = np.maximum(psum / peak, 1.0)
    return psum / (noise * np.sqrt(weq)) / fudge


def rotate_phase(data, turns):
    """Rotate (..., nbin) profiles **backward** by ``turns`` rotations
    via the rFFT phasor — positive turns moves features to earlier
    phase, matching the reference's rotate convention
    (pplib.py:2427-2515)."""
    data = np.asarray(data, np.float64)
    nbin = data.shape[-1]
    k = np.arange(nbin // 2 + 1)
    turns = np.asarray(turns, np.float64)[..., None]
    phasor = np.exp(2.0j * np.pi * k * turns)
    return np.fft.irfft(np.fft.rfft(data, axis=-1) * phasor, n=nbin, axis=-1)


def dm_delays(DM, P, freqs, nu_ref):
    """Dispersion delay in rotations of each channel relative to
    nu_ref: Dconst * DM * (nu^-2 - nu_ref^-2) / P."""
    freqs = np.asarray(freqs, np.float64)
    return Dconst * DM * (freqs ** -2.0 - float(nu_ref) ** -2.0) / P


def baseline_window_stats(profiles, frac=0.15, need_var=True):
    """(mean, var) of the quietest duty-cycle window of each profile —
    the PSRCHIVE 'minimum window' baseline estimator used by
    remove_baseline / baseline_stats.

    Circular rolling windows via f64-accumulated cumulative sums (one
    O(nbin) pass for means, one more for squares when need_var) —
    equivalent to an FFT-correlation formulation but much cheaper on
    host, which matters because this runs per archive load in
    streaming campaigns.  need_var=False (remove_baseline) skips the
    squares pass and returns var=None."""
    p = _as_float(profiles)
    nbin = p.shape[-1]
    w = max(1, int(round(frac * nbin)))

    def _windowed_means(x):
        # circular window sums from one cumsum: the first nbin-w+1
        # windows are direct differences; wrapped windows add the total
        cs = np.cumsum(x, axis=-1, dtype=np.float64)
        total = cs[..., -1:]
        out = np.empty_like(cs)
        out[..., 0] = cs[..., w - 1]
        out[..., 1:nbin - w + 1] = (cs[..., w:] - cs[..., :nbin - w])
        i = np.arange(nbin - w + 1, nbin)
        out[..., nbin - w + 1:] = (total - cs[..., i - 1]
                                   + cs[..., i + w - 1 - nbin])
        return out / w  # mean of window starting at bin i (circular)

    means = _windowed_means(p)
    imin = means.argmin(axis=-1)
    mean = np.take_along_axis(means, imin[..., None], axis=-1)[..., 0]
    if not need_var:
        return mean, None
    sq_means = _windowed_means(p * p)
    var = np.take_along_axis(sq_means, imin[..., None], axis=-1)[..., 0] \
        - mean ** 2
    return mean, np.maximum(var, 0.0)


# --------------------------------------------------------------------------
# Polyco evaluation
# --------------------------------------------------------------------------

def polyco_phase_freq(polyco_rows, epoch_mjd):
    """Evaluate (phase, spin frequency [Hz]) at epoch_mjd from the
    nearest tempo polyco block.  Standard tempo convention:
    PHASE = REF_PHS + DT*60*F0 + C1 + C2*DT + C3*DT^2 + ... (DT in
    minutes from REF_MJD)."""
    ref_mjds = np.asarray(polyco_rows["REF_MJD"], np.float64).ravel()
    i = int(np.abs(ref_mjds - epoch_mjd).argmin())
    dt_min = (epoch_mjd - ref_mjds[i]) * 1440.0
    f0 = float(np.asarray(polyco_rows["REF_F0"]).ravel()[i])
    ref_phs = float(np.asarray(polyco_rows["REF_PHS"]).ravel()[i])
    coeff = np.asarray(polyco_rows["COEFF"], np.float64)
    coeff = coeff[i].ravel() if coeff.ndim > 1 else coeff
    powers = dt_min ** np.arange(len(coeff))
    phase = ref_phs + dt_min * 60.0 * f0 + float(np.dot(coeff, powers))
    dcoef = coeff[1:] * np.arange(1, len(coeff))
    freq = f0 + float(np.dot(dcoef, dt_min ** np.arange(len(dcoef)))) / 60.0
    return phase, freq


# --------------------------------------------------------------------------
# Archive
# --------------------------------------------------------------------------

class Archive:
    """A PSRFITS fold-mode archive held in memory.

    Mirrors the slice of the PSRCHIVE Archive API the reference uses
    (SURVEY §2.2 L1): metadata getters, state conversion, de/dedisperse,
    baseline removal, t/p/f-scrunch, data access, weights, clone/unload.
    Data layout: amps[nsub, npol, nchan, nbin] float64 (scales/offsets
    already applied), weights[nsub, nchan] float64.
    """

    def __init__(self, primary, subint_header, amps, weights, freqs,
                 tsubints, offs_subs, periods, psrparam=None, polyco=None,
                 par_angs=None, filename=""):
        self.primary = primary
        self.subint_header = subint_header
        # float64 canonical; float32 preserved (streaming loader mode)
        self.amps = _as_float(amps)
        self.weights = np.asarray(weights, np.float64)
        self.freqs_table = np.asarray(freqs, np.float64)  # (nsub, nchan)
        self.tsubints = np.asarray(tsubints, np.float64)
        self.offs_subs = np.asarray(offs_subs, np.float64)
        self.periods = np.asarray(periods, np.float64)
        self.psrparam = list(psrparam) if psrparam else []
        self.polyco = polyco
        self._par_angs_from_file = par_angs is not None
        self.par_angs = (np.asarray(par_angs, np.float64)
                         if par_angs is not None
                         else np.zeros(len(self.amps)))
        self.filename = filename

    # -- metadata ----------------------------------------------------------
    @property
    def nsub(self):
        return self.amps.shape[0]

    @property
    def npol(self):
        return self.amps.shape[1]

    @property
    def nchan(self):
        return self.amps.shape[2]

    @property
    def nbin(self):
        return self.amps.shape[3]

    def get_source(self):
        return str(self.primary.get("SRC_NAME", "")).strip()

    def get_telescope(self):
        return str(self.primary.get("TELESCOP", "")).strip()

    def get_receiver_name(self):
        return str(self.primary.get("FRONTEND", "")).strip()

    def get_backend_name(self):
        return str(self.primary.get("BACKEND", "")).strip()

    def get_backend_delay(self):
        return float(self.primary.get("BE_DELAY", 0.0) or 0.0)

    def get_centre_frequency(self):
        return float(self.primary.get("OBSFREQ", self.freqs_table.mean()))

    def get_bandwidth(self):
        return float(self.primary.get("OBSBW",
                                      self.subint_header.get("CHAN_BW", 0.0)
                                      * self.nchan))

    def get_dispersion_measure(self):
        """Pulsar DM [pc cm^-3]: the SUBINT 'DM' card, falling back to
        the PSRPARAM ephemeris DM and last to 'CHAN_DM' (a file from a
        coherent-dedispersion backend may carry only that; note the
        standard SUBINT template writes CHAN_DM=0.0 unconditionally,
        so a zero CHAN_DM must never shadow the ephemeris)."""
        dm = getattr(self, "_dm_override", None)
        if dm is not None:
            return dm
        dm = self.subint_header.get("DM")
        # a 0.0 DM card is AUTHORITATIVE on a dedispersed file with no
        # coherent-dedispersion record (e.g. an averaged template
        # archive: "fully dedispersed, zero residual DM") but means
        # unset-as-zero on raw data (the standard SUBINT template
        # writes DM unconditionally) and on coherent-backend files
        # (nonzero CHAN_DM: the applied DM is recorded there) — those
        # fall through to the ephemeris/CHAN_DM chain
        if dm in (0.0, 0) and self.get_dedispersed() \
                and self.get_chan_dm() == 0.0:
            return 0.0
        if dm in (None, 0.0, 0, "*"):
            dm = _param_value(self.psrparam, "DM")
        if dm in (None, 0.0, 0, "*"):
            dm = self.subint_header.get("CHAN_DM")
        try:
            return float(dm or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def get_chan_dm(self):
        """The 'CHAN_DM' SUBINT card: the DM of the backend's
        within-channel (coherent) dedispersion — NOT the inter-channel
        subint rotation that DEDISP records (0 when absent)."""
        try:
            return float(self.subint_header.get("CHAN_DM", 0.0) or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def dedispersion_ref_freq(self):
        """Reference frequency of the on-disk inter-channel
        dedispersion delays: the SUBINT 'REF_FREQ' card when present,
        else the centre frequency."""
        try:
            rf = float(self.subint_header.get("REF_FREQ", 0.0) or 0.0)
        except (TypeError, ValueError):
            rf = 0.0
        return rf if rf > 0.0 else self.get_centre_frequency()

    def set_dispersion_measure(self, DM):
        # the in-memory override makes set(0.0)/get round-trip exactly
        # (a 0.0 DM *card* alone is ambiguous on real files — the
        # standard template writes it unset-as-zero — so the card
        # fallback chain above treats it as missing)
        self._dm_override = float(DM)
        self.subint_header["DM"] = float(DM)

    def get_dedispersed(self):
        return bool(self.subint_header.get("DEDISP", 0))

    def get_state(self):
        pol = str(self.subint_header.get("POL_TYPE", "AA+BB")).strip()
        return {"IQUV": "Stokes", "AA+BB": "PPQQ",
                "AABBCRCI": "Coherence",
                "INTEN": "Intensity"}.get(pol, pol)

    def start_time(self):
        return MJD(int(self.primary.get("STT_IMJD", 50000)),
                   (float(self.primary.get("STT_SMJD", 0))
                    + float(self.primary.get("STT_OFFS", 0.0))) / SECPERDAY)

    def epochs(self):
        """Mid-subint epochs as MJD objects: STT_* + OFFS_SUB.

        The SUBINT 'EPOCHS' convention card is honored: for every
        convention PSRCHIVE writes ('MIDTIME', 'VALID', 'STT_MJD')
        OFFS_SUB is the offset of the subint centre from the file
        start, so the arithmetic is shared — the card records the
        *phase-alignment* guarantee (whether the polyco was evaluated
        at these epochs), not a different time base.  An unrecognized
        convention raises rather than silently misdating TOAs."""
        conv = str(self.subint_header.get("EPOCHS",
                                          "MIDTIME")).strip().upper()
        if conv not in ("", "MIDTIME", "VALID", "STT_MJD"):
            raise ValueError(
                f"{self.filename}: unrecognized SUBINT EPOCHS "
                f"convention {conv!r} (known: MIDTIME, VALID, STT_MJD)")
        t0 = self.start_time()
        return [t0.add_seconds(float(s)) for s in self.offs_subs]

    def folding_periods(self):
        """Per-subint folding period [s]: polyco if present, else the
        stored PERIOD column values."""
        if self.polyco is not None:
            eps = [e.to_float() for e in self.epochs()]
            return np.array(
                [1.0 / polyco_phase_freq(self.polyco, e)[1] for e in eps])
        return self.periods.copy()

    def _source_coords(self):
        """(RA, DEC) [deg] from primary cards or PSRPARAM, else None."""
        from ..utils import ephem

        ra = self.primary.get("RA")
        dec = self.primary.get("DEC")
        if not ra or not dec:
            ra = _coord_param(self.psrparam, "RAJ")
            dec = _coord_param(self.psrparam, "DECJ")
        if not ra or not dec:
            return None
        try:
            return ephem.parse_ra(ra), ephem.parse_dec(dec)
        except ValueError:
            return None

    def _site_itrf(self):
        """Observatory ITRF (x, y, z) [m]: ANT_X/Y/Z primary cards when
        present, else the telescope-name lookup table; None if unknown
        or the 'telescope' is the barycentre."""
        from ..utils import ephem

        try:
            xyz = [float(self.primary[k]) for k in
                   ("ANT_X", "ANT_Y", "ANT_Z")]
            if any(v != 0.0 for v in xyz):
                return np.asarray(xyz, np.float64)
        except (KeyError, TypeError, ValueError):
            pass
        return ephem.telescope_itrf(self.get_telescope())

    def doppler_factors(self):
        """nu_source/nu_observed per subint (reference pplib.py:2795-
        2805, PSRCHIVE ephemeris convention: > 1 for increasing
        distance).  Computed from the analytic barycentric Earth-
        velocity model in utils/ephem.py when source coordinates are
        known; 1.0 for explicitly barycentred archives (PPTBARY card,
        written by the synthetic-archive generator), barycentre 'site'
        codes, or archives with no coordinates."""
        from ..utils import ephem

        if self.primary.get("PPTBARY"):
            return np.ones(self.nsub)
        # any barycentre alias (SSB, BAT, BARYCENTER, '@', ...) — the
        # site-code table canonicalizes them all to tempo code '@'
        tel = str(self.get_telescope())
        if tel.upper() in ("@", "BAT") or telescope_code(tel) == "@":
            return np.ones(self.nsub)
        coords = self._source_coords()
        if coords is None:
            return np.ones(self.nsub)
        mjds = np.array([e.to_float() for e in self.epochs()])
        return ephem.doppler_factors(mjds, coords[0], coords[1],
                                     self._site_itrf())

    def parallactic_angles(self):
        """Per-subint parallactic angle [deg]: the PAR_ANG SUBINT
        column when the file carries one, else computed from the site
        geometry (reference pplib.py:2806-2808 via PSRCHIVE 'fix
        pointing'), else zeros."""
        from ..utils import ephem

        if self._par_angs_from_file:
            return self.par_angs.copy()
        coords = self._source_coords()
        site = self._site_itrf()
        if coords is None or site is None:
            return np.zeros(self.nsub)
        mjds = np.array([e.to_float() for e in self.epochs()])
        return ephem.parallactic_angles(mjds, coords[0], coords[1], site)

    def get_weights(self):
        return self.weights.copy()

    def integration_length(self):
        return float(self.tsubints.sum())

    # -- state transforms (in-place, PSRCHIVE verbs) -----------------------
    def convert_state(self, state):
        """In-place polarization state conversion (reference load_data's
        convert_state option, pplib.py:2782-2814, where PSRCHIVE does
        the work).  Supported: anything -> Intensity (pscrunch), and
        Coherence (AABBCRCI) -> Stokes via the van Straten (2004)
        relations in the feed basis named by the FD_POLN primary card:

          linear  (X, Y): I = AA+BB, Q = AA-BB, U = 2 CR, V = 2 CI
          circular(L, R): I = AA+BB, V = AA-BB, Q = 2 CR, U = 2 CI

        PPQQ (AA+BB with no cross terms) cannot reach full Stokes —
        the cross-hand information does not exist in the file."""
        if state == self.get_state():
            return
        if state == "Intensity":
            self.pscrunch()
            return
        if state == "Stokes" and self.get_state() == "Coherence":
            if self.npol != 4:
                raise ValueError(
                    f"Coherence state with npol={self.npol}; need 4 "
                    "(AA, BB, CR, CI)")
            aa, bb, cr, ci = (self.amps[:, i] for i in range(4))
            basis = str(self.primary.get("FD_POLN", "LIN")).strip().upper()
            I = aa + bb
            if basis.startswith("CIRC"):
                V = aa - bb
                Q = 2.0 * cr
                U = 2.0 * ci
            else:  # LIN (default, like PSRCHIVE for missing FD_POLN)
                Q = aa - bb
                U = 2.0 * cr
                V = 2.0 * ci
            self.amps = np.stack([I, Q, U, V], axis=1)
            self.subint_header["POL_TYPE"] = "IQUV"
            return
        raise ValueError(
            f"unsupported state conversion {self.get_state()!r} -> "
            f"{state!r}")

    def pscrunch(self):
        if self.npol == 1:
            self.subint_header["POL_TYPE"] = "INTEN"
            return
        pol = str(self.subint_header.get("POL_TYPE", "AA+BB")).strip()
        if pol == "IQUV":
            self.amps = self.amps[:, :1]
        else:  # AA+BB (or anything summable in the first two pols)
            self.amps = self.amps[:, :2].sum(axis=1, keepdims=True)
        self.subint_header["POL_TYPE"] = "INTEN"
        self.subint_header["NPOL"] = 1

    def dedisperse(self):
        if not self.get_dedispersed():
            self._rotate_dm(-1.0)
            self.subint_header["DEDISP"] = True
            # record the reference so dededisperse undoes exactly this
            # rotation (CHAN_DM is NOT touched — it records the
            # backend's coherent dedispersion, a different operation)
            self.subint_header["REF_FREQ"] = self.get_centre_frequency()

    def dededisperse(self):
        if self.get_dedispersed():
            self._rotate_dm(+1.0)
            self.subint_header["DEDISP"] = False

    def _rotate_dm(self, sign):
        """sign=-1 removes dispersion delays (dedisperse), +1 restores
        them; reference semantics: rotate_portrait is 'virtually
        identical to arch.dedisperse()' (reference pplib.py:2526).

        Undoing an on-disk dedispersion (sign=+1) honors the REF_FREQ
        card (the reference the delays were computed against); the DM
        is the archive DM in both directions — CHAN_DM records the
        backend's within-channel coherent dedispersion, a different
        operation that subint rotation must not conflate."""
        DM = self.get_dispersion_measure()
        nu0 = (self.dedispersion_ref_freq() if sign > 0
               else self.get_centre_frequency())
        if DM == 0.0:
            return
        Ps = self.folding_periods()
        for isub in range(self.nsub):
            delays = dm_delays(DM, Ps[isub], self.freqs_table[isub], nu0)
            # rotate_phase rotates backward by +turns; removing a delay
            # of d rotations means rotating backward by d.
            self.amps[isub] = rotate_phase(self.amps[isub], sign * -delays)

    def remove_baseline(self):
        mean, _ = baseline_window_stats(self.amps, need_var=False)
        self.amps -= mean.astype(self.amps.dtype)[..., None]

    def baseline_stats(self):
        return baseline_window_stats(self.amps)

    def tscrunch(self):
        if self.nsub == 1:
            return
        w = self.weights  # (nsub, nchan)
        wsum = np.maximum(w.sum(axis=0), 1e-30)  # (nchan,)
        amps = np.einsum("spcb,sc->pcb", self.amps, w) / wsum[:, None]
        self.amps = amps[None]
        total = self.tsubints.sum()
        # duration-weighted central epoch offset
        mid = float((self.offs_subs * self.tsubints).sum()
                    / max(self.tsubints.sum(), 1e-30))
        self.freqs_table = self.freqs_table.mean(axis=0, keepdims=True)
        self.weights = w.sum(axis=0, keepdims=True)
        self.tsubints = np.array([total])
        self.offs_subs = np.array([mid])
        self.periods = np.array([self.folding_periods().mean()])
        self.par_angs = self.par_angs.mean(keepdims=True)

    def fscrunch(self):
        if self.nchan == 1:
            return
        w = self.weights  # (nsub, nchan)
        wsum = np.maximum(w.sum(axis=1), 1e-30)  # (nsub,)
        amps = np.einsum("spcb,sc->spb", self.amps, w) / wsum[:, None, None]
        fmean = (self.freqs_table * w).sum(axis=1) / wsum
        self.amps = amps[:, :, None, :]
        self.freqs_table = fmean[:, None]
        self.weights = wsum[:, None]
        self.subint_header["NCHAN"] = 1

    # -- data --------------------------------------------------------------
    def get_data(self):
        return self.amps.copy()

    def set_data(self, amps):
        amps = _as_float(amps)
        if amps.ndim != 4:
            raise ValueError("amps must be [nsub, npol, nchan, nbin]")
        self.amps = amps.copy()

    def set_weights(self, weights):
        self.weights = np.broadcast_to(
            np.asarray(weights, np.float64),
            (self.nsub, self.nchan)).copy()

    def clone(self):
        import copy
        arch = Archive(
            primary=fitsio.Header(list(self.primary.cards)),
            subint_header=fitsio.Header(list(self.subint_header.cards)),
            amps=self.amps.copy(), weights=self.weights.copy(),
            freqs=self.freqs_table.copy(), tsubints=self.tsubints.copy(),
            offs_subs=self.offs_subs.copy(), periods=self.periods.copy(),
            psrparam=list(self.psrparam),
            polyco=copy.deepcopy(self.polyco),
            par_angs=self.par_angs.copy(), filename=self.filename)
        arch._par_angs_from_file = self._par_angs_from_file
        return arch

    def unload(self, path, nbit=16, levels=None, dither=None):
        write_archive_file(path, self, nbit=nbit, levels=levels,
                           dither=dither)

    def refresh(self):
        """Reload from disk if this archive came from a file."""
        if self.filename:
            fresh = read_archive(self.filename)
            self.__dict__.update(fresh.__dict__)


# --------------------------------------------------------------------------
# Reading
# --------------------------------------------------------------------------

def read_archive(path, dtype=np.float64, decode=True):
    """Parse a PSRFITS fold-mode file into an Archive (scales, offsets
    applied; weights kept separate).

    dtype: float64 (canonical) or float32 — the streaming campaign
    loader decodes straight to f32, halving host memory traffic for
    data that feeds the f32 fast fit anyway.

    decode=False (raw streaming mode): requires a DATA column in one
    of the raw-transportable sample types — int16 (TFORM 'I'),
    unsigned byte ('B'), signed byte ('B' + the FITS TZERO=-128
    convention), float32 ('E'), or sub-byte packed samples ('B' with
    an NBIT=1/2/4 card, MSB-first per the PSRFITS convention).  The
    Archive's ``amps`` becomes a read-only zero placeholder and the
    undecoded samples are attached as ``raw_data`` — (nsub, npol,
    nchan, nbin) in the native-endian wire dtype, or (nsub, npol,
    plane_bytes) PACKED bytes for sub-byte NBIT (row byte-pad already
    trimmed; each pol plane must byte-align, i.e. nchan*nbin*NBIT
    divisible by 8) — with ``raw_scl``/``raw_offs`` (nsub, npol,
    nchan) float32 and ``raw_code`` naming the sample type for the
    device decode (ops/decode.RAW_CODES; packed codes 'p1'/'p2'/'p4').
    General FITS column scaling (TSCAL/TZERO beyond the signed-byte
    convention) attaches as ``raw_tscal``/``raw_tzero`` scalars the
    device decode applies before DAT_SCL/DAT_OFFS, in the exact host
    order.  The streaming driver ships all of this to the accelerator
    and decodes there, cutting host->device bytes 2x (int16) to 32x
    (2-bit packed) vs decoded float64.

    Coverage matrix (raw mode ships -> device decodes):

      =========================  ==========  =======================
      DATA layout                raw_code    bytes vs decoded f64
      =========================  ==========  =======================
      TFORM 'I' int16            'i16'       4x fewer
      TFORM 'B' unsigned byte    'u8'        8x fewer
      TFORM 'B' + TZERO=-128     'i8'        8x fewer
      TFORM 'E' float32          'f32'       2x fewer
      NBIT=4 packed              'p4'        16x fewer
      NBIT=2 packed              'p2'        32x fewer
      NBIT=1 packed              'p1'        64x fewer
      any above + TSCAL/TZERO    (same)      (same; 2 extra scalars)
      =========================  ==========  =======================

    Raises ValueError for the remaining unrepresentable layouts
    (sub-byte planes that do not byte-align, packed + FITS-scaled
    columns, or config.raw_subbyte = False — the escape hatch forcing
    the decoded lane); the caller falls back to decoding.

    When the native decoder (io/native.py) is available, the DATA
    column is decoded straight from the wire bytes with DAT_SCL /
    DAT_OFFS fused in (one threaded pass, no float64 intermediates);
    otherwise the pure-numpy path below is the reference behavior."""
    dtype = np.dtype(dtype).type
    use_native = native.available() and decode
    defer = ("DATA",) if (use_native or not decode) else ()
    hdus = fitsio.read_fits(path, defer=defer)
    primary = hdus[0].header
    obs_mode = str(primary.get("OBS_MODE", "PSR")).strip().upper()
    if obs_mode in ("SEARCH", "SRCH"):
        # a SEARCH-mode SUBINT table holds unfolded filterbank samples
        # (NSBLK time samples per row, no PERIOD) — silently misparsing
        # it as folded profiles would produce garbage TOAs
        raise ValueError(
            f"{path}: OBS_MODE={obs_mode} is a search-mode PSRFITS "
            "file (unfolded time samples); fold it first (e.g. with "
            "dspsr) — only fold-mode archives carry profiles to time")
    try:
        subint = fitsio.get_hdu(hdus, "SUBINT")
    except KeyError:
        raise ValueError(f"{path}: no SUBINT HDU (not a fold-mode archive)")
    cols = subint.data
    hdr = subint.header
    nchan = int(hdr.get("NCHAN", 0)) or cols["DAT_FREQ"].shape[-1]
    npol = int(hdr.get("NPOL", 1))
    nsub = int(hdr.get("NAXIS2", 0)) or len(cols["DAT_FREQ"])
    scl = np.asarray(cols.get("DAT_SCL",
                              np.ones((nsub, npol * nchan))),
                     np.float64).reshape(nsub, npol, nchan)
    offs = np.asarray(cols.get("DAT_OFFS",
                               np.zeros((nsub, npol * nchan))),
                      np.float64).reshape(nsub, npol, nchan)
    _SAMP_BYTES = {"I": 2, "B": 1, "E": 4}
    # a FITS-scaled DATA column (TSCAL/TZERO — e.g. the signed-byte
    # convention) must go through the scaling-aware numpy path: the
    # raw int16 transport and the native kernel read stored values
    data_scaling = subint.col_scaling.get("DATA")
    raw_data = None
    raw_code = None
    raw_tscal = raw_tzero = None
    if not decode:
        col_off, code, repeat = subint.layout["DATA"]
        nbin = int(hdr.get("NBIN", 0)) or repeat // (npol * nchan)
        nbit = int(hdr.get("NBIT", 8) or 8)
        # wire dtype + device sample code per TFORM (ops/decode).  'B'
        # with the FITS signed-byte convention (TSCAL 1, TZERO -128)
        # ships as-is and the device decode removes the bias exactly;
        # any OTHER TSCAL/TZERO scaling ships its two scalars and the
        # device decode applies them before DAT_SCL/DAT_OFFS, in the
        # exact host order.
        wire = {"I": (">i2", np.int16, "i16"),
                "B": ("u1", np.uint8, "u8"),
                "E": (">f4", np.float32, "f32")}.get(code)
        if code == "B" and data_scaling is not None \
                and float(data_scaling[0]) == 1.0 \
                and float(data_scaling[1]) == -128.0:
            wire = ("u1", np.uint8, "i8")
            data_scaling = None
        if code == "B" and nbit in (1, 2, 4):
            # sub-byte packed samples ship PACKED (raw codes
            # 'p1'/'p2'/'p4'); the device unpacks the bit planes
            # inside the fused program (ops/decode.unpack_bitplanes).
            # Per-pol slicing on host is a byte index, so each pol
            # plane must byte-align; the row byte-pad is trimmed here.
            from .. import config as _cfg

            if not _cfg.raw_subbyte:
                raise ValueError(
                    f"{path}: sub-byte raw transport disabled "
                    "(config.raw_subbyte = False); decode on host instead")
            per = 8 // nbit
            plane = nchan * nbin
            row_bytes = (npol * plane + per - 1) // per
            if (data_scaling is not None or plane % per != 0
                    or repeat != row_bytes
                    or not int(hdr.get("NBIN", 0))
                    or col_off + row_bytes > subint.row_stride
                    or len(subint.raw) < nsub * subint.row_stride):
                raise ValueError(
                    f"{path}: NBIT={nbit} DATA column is FITS-scaled, "
                    "inconsistent, or its pol planes do not "
                    "byte-align; raw streaming mode cannot ship it "
                    "packed")
            rows = np.frombuffer(subint.raw, np.uint8)[
                : nsub * subint.row_stride].reshape(nsub,
                                                    subint.row_stride)
            plane_bytes = plane // per
            col = np.ascontiguousarray(
                rows[:, col_off:col_off + npol * plane_bytes])
            raw_data = col.reshape(nsub, npol, plane_bytes)
            raw_code = f"p{nbit}"
            amps = np.broadcast_to(np.float32(0.0),
                                   (nsub, npol, nchan, nbin))
        else:
            if wire is not None and data_scaling is not None:
                # general TSCAL/TZERO: stored values ship as-is plus
                # the two column-scaling scalars
                raw_tscal = float(data_scaling[0])
                raw_tzero = float(data_scaling[1])
                data_scaling = None
            samp = np.dtype(wire[0]).itemsize if wire else 0
            if (wire is None or npol * nchan * nbin != repeat
                    or data_scaling is not None
                    or col_off + repeat * samp > subint.row_stride
                    or len(subint.raw) < nsub * subint.row_stride):
                raise ValueError(
                    f"{path}: raw streaming mode needs a consistent "
                    "int16/byte/float32 (or packed NBIT) DATA column")
            rows = np.frombuffer(subint.raw, np.uint8)[
                : nsub * subint.row_stride].reshape(nsub,
                                                    subint.row_stride)
            col = np.ascontiguousarray(
                rows[:, col_off:col_off + repeat * samp])
            # one byteswap/memcpy pass; no float decode anywhere on
            # host
            raw_data = col.view(wire[0]).astype(wire[1]).reshape(
                nsub, npol, nchan, nbin)
            raw_code = wire[2]
            amps = np.broadcast_to(np.float32(0.0), raw_data.shape)
    elif use_native:
        col_off, code, repeat = subint.layout["DATA"]
        nbin = int(hdr.get("NBIN", 0)) or repeat // (npol * nchan)
        samp = _SAMP_BYTES.get(code)
        # the C kernel has no bounds checks: validate the header-derived
        # geometry against the actual column layout before handing it
        # raw bytes (an inconsistent NBIN card must error like the numpy
        # reshape does, not read past the column)
        consistent = (
            samp is not None
            and data_scaling is None
            and npol * nchan * nbin == repeat
            and col_off + repeat * samp <= subint.row_stride
            and len(subint.raw) >= nsub * subint.row_stride
        )
        amps = native.decode_fused(
            subint.raw, nsub, subint.row_stride, col_off, code,
            npol, nchan, nbin, scl=scl, offs=offs,
            dtype=dtype) if consistent else None
    else:
        amps = None
    if amps is None:  # pure-numpy reference path
        if cols["DATA"] is None:
            # deferred but native decode declined: decode the DATA
            # column from the already-read table bytes
            col_off, code, repeat = subint.layout["DATA"]
            samp_dt = {"I": ">i2", "B": "u1", "E": ">f4",
                       "D": ">f8", "J": ">i4"}[code]
            width = repeat * np.dtype(samp_dt).itemsize
            rows = np.frombuffer(subint.raw, np.uint8)[
                : nsub * subint.row_stride].reshape(nsub, subint.row_stride)
            col = np.ascontiguousarray(
                rows[:, col_off:col_off + width]).view(samp_dt)
            if data_scaling is not None:
                col = fitsio.apply_column_scaling(col, *data_scaling)
            cols["DATA"] = col.astype(dtype)
        nbin = int(hdr.get("NBIN", 0)) or cols["DATA"].shape[-1]
        data_col = np.asarray(cols["DATA"])
        nbit = int(hdr.get("NBIT", 8) or 8)
        if nbit in (1, 2, 4):
            # sub-byte packed samples (search-era backends; PSRFITS
            # packs MSB-first within each byte, each ROW padded to
            # whole bytes) — unpack to unsigned sample values and trim
            # the row pad; DAT_SCL/DAT_OFFS restore the physics
            row_samp = npol * nchan * nbin
            per = 8 // nbit
            row_bytes = (row_samp + per - 1) // per
            if data_col.size != nsub * row_bytes:
                raise ValueError(
                    f"NBIT={nbit} DATA column holds {data_col.size} "
                    f"bytes; expected {nsub} rows x {row_bytes}")
            b = data_col.reshape(nsub, row_bytes).astype(np.uint8)
            mask = (1 << nbit) - 1
            shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * nbit
            samples = (b[:, :, None] >> shifts[None, None, :]) & mask
            data_col = samples.reshape(nsub, row_bytes * per)[:, :row_samp]
        raw = np.asarray(data_col, dtype).reshape(
            nsub, npol, nchan, nbin)
        amps = raw * scl[..., None].astype(dtype) \
            + offs[..., None].astype(dtype)
    weights = np.asarray(cols.get("DAT_WTS", np.ones((nsub, nchan))),
                         np.float64).reshape(nsub, nchan)
    freqs = np.asarray(cols["DAT_FREQ"], np.float64).reshape(nsub, nchan)
    tsub = np.asarray(cols.get("TSUBINT", np.ones(nsub)),
                      np.float64).ravel()
    offs_sub = np.asarray(cols.get("OFFS_SUB", np.zeros(nsub)),
                          np.float64).ravel()
    par_ang = (np.asarray(cols["PAR_ANG"], np.float64).ravel()
               if "PAR_ANG" in cols else None)

    psrparam = []
    try:
        pp = fitsio.get_hdu(hdus, "PSRPARAM")
        col = next(iter(pp.data.values()))
        psrparam = [
            (r.decode("ascii", "replace") if isinstance(r, bytes) else str(r))
            .strip() for r in np.asarray(col).ravel()]
    except (KeyError, StopIteration):
        pass

    polyco = None
    try:
        polyco = fitsio.get_hdu(hdus, "POLYCO").data
    except KeyError:
        pass

    if "PERIOD" in cols:
        periods = np.asarray(cols["PERIOD"], np.float64).ravel()
    elif polyco is not None:
        periods = np.zeros(nsub)  # computed from polyco on demand
    else:
        f0 = _param_value(psrparam, "F0")
        periods = np.full(nsub, 1.0 / f0 if f0 else 1.0)

    arch = Archive(primary, hdr, amps, weights, freqs, tsub, offs_sub,
                   periods, psrparam=psrparam, polyco=polyco,
                   par_angs=par_ang, filename=str(path))
    if raw_data is not None:
        arch.raw_data = raw_data
        arch.raw_code = raw_code
        arch.raw_scl = scl.astype(np.float32)
        arch.raw_offs = offs.astype(np.float32)
        arch.raw_tscal = raw_tscal
        arch.raw_tzero = raw_tzero
    if polyco is not None and "PERIOD" not in cols:
        arch.periods = arch.folding_periods()
    return arch


def _param_value(lines, key):
    for line in lines:
        parts = line.split()
        if parts and parts[0] == key:
            try:
                return float(parts[1].replace("D", "E"))
            except (IndexError, ValueError):
                return None
    return None


def _coord_param(lines, key):
    """RAJ/DECJ string from PSRPARAM lines: a single 'hh:mm:ss.s' (or
    decimal) token, or space-separated sexagesimal 'hh mm ss.s' (three
    tokens, distinguished from a trailing fit-flag/error by the first
    two being integers)."""
    for line in lines:
        parts = line.split()
        if parts and parts[0] == key and len(parts) > 1:
            if (len(parts) >= 4 and ":" not in parts[1]
                    and parts[1].lstrip("+-").isdigit()
                    and parts[2].isdigit()):
                try:
                    float(parts[3])
                    return " ".join(parts[1:4])
                except ValueError:
                    pass
            return parts[1]
    return None


def parse_parfile(path_or_lines):
    """Parse a tempo-style parfile into {PARAM: string value}."""
    if isinstance(path_or_lines, (list, tuple)):
        lines = path_or_lines
    else:
        with open(path_or_lines) as f:
            lines = f.readlines()
    out = OrderedDict()
    for line in lines:
        parts = line.split()
        if len(parts) >= 2 and not line.strip().startswith("#"):
            out[parts[0]] = parts[1]
    return out


# --------------------------------------------------------------------------
# Writing
# --------------------------------------------------------------------------

def write_archive_file(path, arch, nbit=16, levels=None, dither=None):
    """Serialize an Archive to a PSRFITS fold-mode file (16-bit scaled
    DATA by default; PSRPARAM/POLYCO HDUs preserved).

    nbit: DATA sample width.  16 (default, byte-stable): scaled int16.
    8: scaled unsigned bytes.  1/2/4: sub-byte packed samples,
    MSB-first with the PSRFITS row byte-pad and an NBIT card — the
    search/fold-era layout the raw streaming lane ships packed.
    levels: quantize to this many amplitude levels instead of the full
    2**nbit range (must fit the width) — what a coarsely-quantizing
    backend stores, and the corpus knob the transport-compression
    bench uses (a 4-level byte column packs 4x).
    dither: a numpy Generator to quantize with rectangular dither (one
    uniform draw in [-1/2, 1/2) of a level added before rounding), which
    makes the mean of each quantized sample the unquantized value: a
    coarse quantizer's nonlinearity then adds noise instead of
    distorting the profile.  Not for the exact int16 path."""
    nsub, npol, nchan, nbin = arch.amps.shape
    if nbit not in (1, 2, 4, 8, 16):
        raise ValueError(f"write_archive_file: nbit must be one of "
                         f"1, 2, 4, 8, 16; got {nbit}")
    # the signed int16 container holds q in [0, 32767]; past that the
    # unsigned quantized values would wrap negative silently
    max_levels = 2 ** 15 if nbit == 16 else 2 ** nbit
    if levels is not None and not 2 <= int(levels) <= max_levels:
        raise ValueError(
            f"write_archive_file: levels={levels} does not fit "
            f"nbit={nbit} (need 2 <= levels <= {max_levels})")
    lo = arch.amps.min(axis=-1)
    hi = arch.amps.max(axis=-1)
    nbit_card = None
    if nbit == 16 and levels is None:
        # the historical exact path — golden archives stay
        # byte-identical: per-(sub, pol, chan) scaling to int16
        offs = 0.5 * (hi + lo)
        scl = np.maximum((hi - lo) / 65530.0, 1e-30)
        data = np.round((arch.amps - offs[..., None]) / scl[..., None])
        data = np.clip(data, -32768, 32767).astype(">i2")
    else:
        # unsigned quantization to `span` levels: q in [0, span],
        # DAT_SCL/DAT_OFFS restore the physics exactly like any
        # integer-quantized archive
        span = float((levels or 2 ** nbit) - 1)
        offs = lo
        scl = np.maximum((hi - lo) / span, 1e-30)
        y = (arch.amps - offs[..., None]) / scl[..., None]
        if dither is not None:
            y = y + dither.uniform(-0.5, 0.5, y.shape)
        q = np.clip(np.round(y), 0, span)
        if nbit == 16:
            data = q.astype(">i2")
        elif nbit == 8:
            data = q.astype("u1")
        else:
            # MSB-first packing, each ROW padded to whole bytes (the
            # PSRFITS convention readers trim)
            per = 8 // nbit
            row_samp = npol * nchan * nbin
            row_bytes = (row_samp + per - 1) // per
            flat = q.astype(np.uint8).reshape(nsub, row_samp)
            padded = np.zeros((nsub, row_bytes * per), np.uint8)
            padded[:, :row_samp] = flat
            grp = padded.reshape(nsub, row_bytes, per)
            data = np.zeros((nsub, row_bytes), np.uint8)
            for j in range(per):
                data |= (grp[:, :, j] & ((1 << nbit) - 1)) \
                    << np.uint8((per - 1 - j) * nbit)
            nbit_card = nbit

    cols = OrderedDict()
    cols["TSUBINT"] = arch.tsubints.astype(">f8")
    cols["OFFS_SUB"] = arch.offs_subs.astype(">f8")
    cols["PERIOD"] = arch.periods.astype(">f8")
    if arch.par_angs.any() or arch._par_angs_from_file:
        # an all-zero placeholder column would shadow the geometric
        # computation in Archive.parallactic_angles() on re-read
        cols["PAR_ANG"] = arch.par_angs.astype(">f8")
    cols["DAT_FREQ"] = arch.freqs_table.astype(">f8")
    cols["DAT_WTS"] = arch.weights.astype(">f4")
    cols["DAT_OFFS"] = offs.reshape(nsub, npol * nchan).astype(">f4")
    cols["DAT_SCL"] = scl.reshape(nsub, npol * nchan).astype(">f4")
    cols["DATA"] = data

    hdr_cards = [(k, v, c) for (k, v, c) in arch.subint_header.cards
                 if not k.startswith(("TTYPE", "TFORM", "TDIM", "TUNIT"))
                 and k not in ("XTENSION", "BITPIX", "NAXIS", "NAXIS1",
                               "NAXIS2", "PCOUNT", "GCOUNT", "TFIELDS",
                               "EXTNAME")]
    hdr = fitsio.Header(hdr_cards)
    hdr["NBIN"] = nbin
    hdr["NCHAN"] = nchan
    hdr["NPOL"] = npol
    hdr["NSBLK"] = 1
    hdr["INT_TYPE"] = "TIME"
    hdr["DEDISP"] = bool(arch.get_dedispersed())
    if nbit_card is not None:
        hdr["NBIT"] = nbit_card

    prim_cards = [(k, v, c) for (k, v, c) in arch.primary.cards
                  if k not in ("SIMPLE", "BITPIX", "NAXIS", "EXTEND")]

    with open(path, "wb") as f:
        fitsio.write_primary(f, prim_cards)
        if arch.psrparam:
            width = max(max(len(s) for s in arch.psrparam), 8)
            par = np.array([s.ljust(width).encode("ascii")
                            for s in arch.psrparam], dtype=f"S{width}")
            fitsio.write_bintable(f, "PSRPARAM",
                                  OrderedDict(PARAM=par))
        if arch.polyco is not None:
            pcols = OrderedDict()
            for k, v in arch.polyco.items():
                v = np.asarray(v)
                if v.dtype.kind in "iufc":
                    v = v.astype(">" + v.dtype.newbyteorder("=").str[1:])
                pcols[k] = v
            fitsio.write_bintable(f, "POLYCO", pcols)
        fitsio.write_bintable(
            f, "SUBINT", cols,
            header_cards=[(k, v, c) for (k, v, c) in hdr.cards],
            # a packed DATA column is a flat byte run per row — its
            # sample geometry lives in the NBIT/NBIN/NCHAN/NPOL cards,
            # not a TDIM (which would misdescribe the byte count)
            tdims=({} if nbit_card is not None
                   else {"DATA": (nbin, nchan, npol)}))


def new_archive(amps, freqs, Ps, epochs_mjd, tsubints, weights=None,
                DM=0.0, dedispersed=True, source="FAKE", telescope="GBT",
                frontend="LBAND", backend="SYNTH", nu0=None, bw=None,
                state="Intensity", psrparam=None, be_delay=0.0):
    """Create an Archive from arrays (reference write_archive,
    pplib.py:3189-3299, without the PSRCHIVE 'ASP' cloning hack).

    amps: [nsub, npol, nchan, nbin]; freqs: (nchan,) or (nsub, nchan);
    epochs_mjd: list of MJD (mid-subint); tsubints: (nsub,) seconds.
    """
    amps = np.asarray(amps, np.float64)
    if amps.ndim == 3:
        amps = amps[:, None]
    nsub, npol, nchan, nbin = amps.shape
    freqs = np.asarray(freqs, np.float64)
    if freqs.ndim == 1:
        freqs = np.broadcast_to(freqs, (nsub, nchan)).copy()
    Ps = np.broadcast_to(np.asarray(Ps, np.float64), (nsub,)).copy()
    tsubints = np.broadcast_to(np.asarray(tsubints, np.float64),
                               (nsub,)).copy()
    if weights is None:
        weights = np.ones((nsub, nchan))
    weights = np.broadcast_to(np.asarray(weights, np.float64),
                              (nsub, nchan)).copy()
    if nu0 is None:
        nu0 = float(freqs.mean())
    if bw is None:
        df = np.diff(np.sort(freqs[0]))
        bw = float((df.mean() if len(df) else 1.0) * nchan)

    t0 = epochs_mjd[0].add_seconds(-0.5 * float(tsubints[0]))
    stt_smjd = int(t0.frac * SECPERDAY)
    stt_offs = t0.frac * SECPERDAY - stt_smjd
    offs_subs = np.array([e - t0 for e in epochs_mjd]) * SECPERDAY

    primary = fitsio.Header([
        ("FITSTYPE", "PSRFITS", "FITS definition for pulsar data"),
        ("OBS_MODE", "PSR", "fold mode"),
        ("SRC_NAME", source, ""),
        ("TELESCOP", telescope, ""),
        ("FRONTEND", frontend, ""),
        ("BACKEND", backend, ""),
        ("BE_DELAY", float(be_delay), "backend delay [s]"),
        ("OBSFREQ", float(nu0), "center frequency [MHz]"),
        ("OBSBW", float(bw), "bandwidth [MHz]"),
        ("OBSNCHAN", nchan, ""),
        ("STT_IMJD", t0.day, "start MJD (int)"),
        ("STT_SMJD", stt_smjd, "start second"),
        ("STT_OFFS", stt_offs, "start fractional second"),
    ])
    subint_header = fitsio.Header([
        ("POL_TYPE", {"Intensity": "INTEN", "Stokes": "IQUV",
                      "PPQQ": "AA+BB"}.get(state, state), ""),
        ("NBIN", nbin, ""), ("NCHAN", nchan, ""), ("NPOL", npol, ""),
        ("CHAN_BW", bw / nchan, "channel bandwidth [MHz]"),
        ("DM", float(DM), "dispersion measure [pc cm^-3]"),
        ("DEDISP", bool(dedispersed), "data dedispersed?"),
    ])
    return Archive(primary, subint_header, amps, weights, freqs,
                   tsubints, offs_subs, Ps, psrparam=psrparam)


def unload_new_archive(amps, arch, path, DM=None, dmc=0, weights=None,
                       quiet=False):
    """Clone ``arch``, overwrite amplitudes/weights/DM, write to
    ``path`` (reference unload_new_archive, pplib.py:3146-3186)."""
    new = arch.clone() if isinstance(arch, Archive) else read_archive(arch)
    amps = np.asarray(amps, np.float64)
    if amps.ndim == 2:
        amps = amps[None, None]
    elif amps.ndim == 3:
        amps = amps[:, None]
    new.set_data(amps)
    if DM is not None:
        new.set_dispersion_measure(DM)
    new.subint_header["DEDISP"] = bool(dmc)
    if weights is not None:
        new.set_weights(weights)
    new.unload(path)
    if not quiet:
        print(f"Unloaded {path}.")


# --------------------------------------------------------------------------
# load_data — the reference's universal ingest (pplib.py:2749-2915)
# --------------------------------------------------------------------------

def load_data(filename, state=None, dedisperse=False, dededisperse=False,
              tscrunch=False, pscrunch=False, fscrunch=False,
              rm_baseline=True, flux_prof=False, refresh_arch=False,
              return_arch=True, quiet=False, dtype=np.float64):
    """Load a PSRFITS archive into the 36-key DataBunch the whole
    framework consumes.  Same signature, keys, and semantics as the
    reference's load_data (pplib.py:2749-2915), implemented without
    PSRCHIVE.  dtype float32 decodes/processes the data cube in single
    precision (streaming campaign mode)."""
    arch = read_archive(filename, dtype=dtype)
    source = arch.get_source()
    if not quiet:
        print(f"\nReading data from {filename} on source {source}...")
    telescope = arch.get_telescope()
    tcode = telescope_code(telescope)
    frontend = arch.get_receiver_name()
    backend = arch.get_backend_name()
    backend_delay = arch.get_backend_delay()
    if state is not None:
        arch.convert_state(state)
    if dedisperse:
        arch.dedisperse()
    if dededisperse:
        arch.dededisperse()
    DM = arch.get_dispersion_measure()
    dmc = arch.get_dedispersed()
    if rm_baseline:
        arch.remove_baseline()
    if tscrunch:
        arch.tscrunch()
    nsub = arch.nsub
    integration_length = arch.integration_length()
    doppler_factors = arch.doppler_factors()
    parallactic_angles = arch.parallactic_angles()
    if pscrunch:
        arch.pscrunch()
    state = arch.get_state()
    npol = arch.npol
    if fscrunch:
        arch.fscrunch()
    nu0 = arch.get_centre_frequency()
    bw = arch.get_bandwidth()
    nchan = arch.nchan
    freqs = arch.freqs_table.copy()
    nbin = arch.nbin
    phases = (np.arange(nbin) + 0.5) / nbin
    subints = arch.get_data()
    Ps = arch.folding_periods()
    epochs = arch.epochs()
    subtimes = list(arch.tsubints)
    weights = arch.get_weights()
    weights_norm = np.where(weights == 0.0, 0.0, 1.0)
    noise_stds = noise_std_ps(subints)  # (nsub, npol, nchan)
    ok_isubs = np.compress(weights_norm.mean(axis=1),
                           np.arange(nsub)).astype(int)
    ok_ichans = [np.compress(weights_norm[isub],
                             np.arange(nchan)).astype(int)
                 for isub in range(nsub)]
    # read-only broadcast view — materializing this (nsub, npol, nchan,
    # nbin) cube would copy ~100 MB per campaign archive for a 0/1 mask
    masks = np.broadcast_to(weights_norm[:, None, :, None],
                            (nsub, npol, nchan, nbin))
    SNRs = profile_snr(subints, noise_stds)
    # the rest ignores npol (reference behavior: pscrunch for summaries)
    summary = arch.clone()
    summary.pscrunch()
    if flux_prof:
        fp = summary.clone()
        fp.dedisperse()
        fp.tscrunch()
        flux_prof = fp.get_data().mean(axis=3)[0][0]
    else:
        flux_prof = np.array([])
    summary.tscrunch()
    summary.fscrunch()
    prof = summary.get_data()[0, 0, 0]
    _, base_var = summary.baseline_stats()
    prof_noise = float(np.sqrt(base_var[0, 0, 0]))
    prof_SNR = float(profile_snr(prof))
    nchanx = np.array([len(x) for x in ok_ichans]).mean() if nsub else 0
    nsubx = len(ok_isubs)
    if not quiet:
        P = Ps[0] * 1000.0 if len(Ps) else 0.0
        print(f"\tP [ms]             = {P:.3f}\n"
              f"\tDM [cm**-3 pc]     = {DM:.6f}\n"
              f"\tcenter freq. [MHz] = {nu0:.4f}\n"
              f"\tbandwidth [MHz]    = {bw:.1f}\n"
              f"\t# bins in prof     = {nbin}\n"
              f"\t# channels         = {nchan}\n"
              f"\t# chan (mean)      = {int(nchanx)}\n"
              f"\t# subints          = {nsub}\n"
              f"\t# unzapped subint  = {nsubx}\n"
              f"\tpol'n state        = {state}\n")
    if refresh_arch:
        arch.refresh()
    if not return_arch:
        arch = None
    return DataBunch(
        arch=arch, backend=backend, backend_delay=backend_delay, bw=bw,
        doppler_factors=doppler_factors, DM=DM, dmc=dmc, epochs=epochs,
        filename=str(filename), flux_prof=flux_prof, freqs=freqs,
        frontend=frontend, integration_length=integration_length,
        masks=masks, nbin=nbin, nchan=nchan, noise_stds=noise_stds,
        npol=npol, nsub=nsub, nu0=nu0, ok_ichans=ok_ichans,
        ok_isubs=ok_isubs, parallactic_angles=parallactic_angles,
        phases=phases, prof=prof, prof_noise=prof_noise,
        prof_SNR=prof_SNR, Ps=Ps, SNRs=SNRs, source=source, state=state,
        subints=subints, subtimes=subtimes, telescope=telescope,
        telescope_code=tcode, weights=weights)
