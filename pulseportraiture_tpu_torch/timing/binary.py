"""Binary-pulsar orbital delay models (ELL1 and BT) with closed-form
partials — the timing subsystem's physics layer (counterpart of
pulseportraiture_tpu/timing/binary.py).

Most IPTA millisecond pulsars are binaries, so the wideband GLS fit
(timing/gls.py) needs the orbital Roemer delay and its parameter
derivatives for the design matrix.  Two parameterizations cover the
MSP population the paper's flagship scenario targets (SURVEY §2/§7,
PAPER.md §timing):

* **ELL1** (Lange et al. 2001, eq. A6): small-eccentricity orbits
  parameterized by (PB, A1, TASC, EPS1=e·sinω, EPS2=e·cosω) —
  numerically stable where ω is undefined (e → 0), which is almost
  every recycled pulsar.  First-order-in-e Roemer delay:

      Δ_R = x·[ sinΦ + (κ/2)·sin2Φ − (η/2)·cos2Φ ],
      Φ = 2π·[ (t−TASC)/PB − (PBDOT/2)·((t−TASC)/PB)² ],
      x = A1 + XDOT·(t−TASC),  η = EPS1 + EPS1DOT·(t−TASC),
      κ = EPS2 + EPS2DOT·(t−TASC).

* **BT** (Blandford & Teukolsky 1976): full Keplerian orbits
  (PB, A1, T0, ECC, OM).  Mean anomaly M → eccentric anomaly E by a
  fixed-iteration Newton solve of Kepler's equation (the iteration
  count is static; 12 Newton steps converge to f64 round-off for
  e ≤ 0.95), then

      Δ_R = x·sinω·(cosE − e) + x·cosω·√(1−e²)·sinE.

Every delay function exists twice, deliberately:

* a **torch float64 op** (``ell1_delay_and_partials`` /
  ``bt_delay_and_partials``) on ``device`` (default cuda): fixed-shape
  array math; the GLS linearization calls it with an explicit
  ``device="cpu"`` (timing/gls.py says why);
* a **host NumPy oracle** (``ell1_delay_np`` / ``bt_delay_np``) — the
  digit-parity reference the tests gate against, and what the synth
  injection uses (synth/archive.py stays host NumPy).

Partials are CLOSED FORM (no autodiff): tempo's classic derivative
set, in per-second units internally — callers converting to parfile
units (PB/TASC/T0 in days) multiply the corresponding partials by
SECPERDAY.  Shapiro/relativistic terms (SINI, M2, H3/H4/STIG, GAMMA,
OMDOT, ...) are NOT modeled here; timing/gls.py refuses parfiles that
carry them.
"""

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["BinaryParams", "parse_binary", "binary_delay_np",
           "binary_delay_and_partials",
           "ell1_delay_np", "ell1_delay_and_partials",
           "bt_delay_np", "bt_delay_and_partials",
           "SUPPORTED_BINARY_MODELS", "KEPLER_NEWTON_ITERS"]

SECPERDAY = 86400.0
SUPPORTED_BINARY_MODELS = ("ELL1", "BT")

# Newton iterations for Kepler's equation in the BT model: a fixed
# count, so the op's work never depends on the data; 12
# quadratically-converging steps from E0 = M reach f64 round-off for
# any e <= 0.95.
KEPLER_NEWTON_ITERS = 12


# ---------------------------------------------------------------------------
# Parfile parsing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BinaryParams:
    """Parsed orbital elements in parfile units.

    kind: 'ELL1' | 'BT'.  tref_int/tref_frac: the epoch the orbit is
    referenced to (TASC for ELL1, T0 for BT) split digit-exactly into
    (int MJD, fractional day) — one f64 MJD would cost ~µs of orbital
    phase over a long campaign.  pb [days], a1 [lt-s], eps1/eps2
    dimensionless, om [deg], pbdot dimensionless (s/s), xdot [lt-s/s],
    eps1dot/eps2dot [1/s].
    """

    kind: str
    pb: float
    a1: float
    tref_int: int
    tref_frac: float
    eps1: float = 0.0
    eps2: float = 0.0
    ecc: float = 0.0
    om: float = 0.0
    pbdot: float = 0.0
    xdot: float = 0.0
    eps1dot: float = 0.0
    eps2dot: float = 0.0

    @property
    def param_names(self):
        """Fit-parameter names, in design-column order."""
        if self.kind == "ELL1":
            return ("PB", "A1", "TASC", "EPS1", "EPS2")
        return ("PB", "A1", "T0", "ECC", "OM")

    def dt_seconds(self, mjd_int, mjd_frac):
        """Seconds since the orbital reference epoch, precision-split:
        the integer-day difference and the fractional-day difference
        are reduced separately so a 50 000-day MJD never rounds the
        sub-second part."""
        mjd_int = np.asarray(mjd_int, np.int64)
        mjd_frac = np.asarray(mjd_frac, np.float64)
        return ((mjd_int - self.tref_int) * SECPERDAY
                + (mjd_frac - self.tref_frac) * SECPERDAY)


def _fget(par, key, default=None):
    v = par.get(key, default)
    if v is None:
        return None
    return float(str(v).replace("D", "E").replace("d", "e"))


def parse_binary(par):
    """Parse the binary model out of a parfile mapping.

    Returns None when the parfile carries no binary keys at all, a
    BinaryParams when it carries a complete supported (ELL1 or BT)
    element set, and raises a loud ValueError on anything in between:
    an unsupported BINARY model name, a partial element set (the
    likeliest hand-edit failure mode), or mixed ELL1/BT keys without a
    BINARY line to disambiguate.  Keys this model family does NOT
    implement (Shapiro, relativistic terms) are the caller's to refuse
    — see timing/gls.py _UNMODELED_BINARY_KEYS.
    """
    if not hasattr(par, "get"):
        return None
    kind = par.get("BINARY")
    ell1_keys = [k for k in ("TASC", "EPS1", "EPS2") if par.get(k) is not None]
    bt_keys = [k for k in ("T0", "ECC", "E", "OM") if par.get(k) is not None]
    have_any = (kind is not None or ell1_keys or bt_keys
                or par.get("PB") is not None or par.get("A1") is not None)
    if not have_any:
        return None
    if kind is not None:
        kind = str(kind).strip().upper()
        if kind not in SUPPORTED_BINARY_MODELS:
            raise ValueError(
                f"timing/binary: BINARY model {kind!r} is not "
                f"implemented — supported models are "
                f"{'/'.join(SUPPORTED_BINARY_MODELS)} (DD/T2/DDK-class "
                "orbits need tempo2/PINT)")
    else:
        # infer from the element set; refuse ambiguity loudly
        if ell1_keys and bt_keys:
            raise ValueError(
                "timing/binary: parfile mixes ELL1 keys "
                f"({', '.join(ell1_keys)}) and BT keys "
                f"({', '.join(bt_keys)}) without a BINARY line — add "
                "'BINARY ELL1' or 'BINARY BT'")
        if ell1_keys:
            kind = "ELL1"
        elif bt_keys:
            kind = "BT"
        else:
            raise ValueError(
                "timing/binary: parfile carries PB/A1 but neither an "
                "ELL1 (TASC/EPS1/EPS2) nor a BT (T0/ECC/OM) element "
                "set — the orbit is underspecified")

    pb = _fget(par, "PB")
    a1 = _fget(par, "A1")
    missing = [k for k, v in (("PB", pb), ("A1", a1)) if v is None]
    if kind == "ELL1":
        tref = par.get("TASC")
        if tref is None:
            missing.append("TASC")
    else:
        tref = par.get("T0")
        if tref is None:
            missing.append("T0")
    if missing:
        raise ValueError(
            f"timing/binary: incomplete {kind} binary parfile — "
            f"missing {', '.join(sorted(missing))} (a partial orbit "
            "would be silently mistimed; complete it or remove every "
            "binary key)")
    if pb <= 0:
        raise ValueError(f"timing/binary: PB must be positive, got {pb}")

    # digit-exact reference-epoch split (same stance as tim.read_tim)
    tref_s = str(tref)
    if "." in tref_s and "E" not in tref_s.upper():
        day_s, frac_s = tref_s.split(".", 1)
        tref_int, tref_frac = int(day_s), float("0." + frac_s)
    else:
        tref_f = float(tref_s.replace("D", "E").replace("d", "e"))
        tref_int = int(tref_f // 1.0)
        tref_frac = tref_f - tref_int

    kw = dict(kind=kind, pb=pb, a1=a1, tref_int=tref_int,
              tref_frac=tref_frac,
              pbdot=_fget(par, "PBDOT", 0.0) or 0.0,
              xdot=(_fget(par, "XDOT", None)
                    if par.get("XDOT") is not None
                    else _fget(par, "A1DOT", 0.0)) or 0.0)
    if kind == "ELL1":
        kw.update(eps1=_fget(par, "EPS1", 0.0) or 0.0,
                  eps2=_fget(par, "EPS2", 0.0) or 0.0,
                  eps1dot=_fget(par, "EPS1DOT", 0.0) or 0.0,
                  eps2dot=_fget(par, "EPS2DOT", 0.0) or 0.0)
    else:
        ecc = _fget(par, "ECC")
        if ecc is None:
            ecc = _fget(par, "E", 0.0) or 0.0
        if not 0.0 <= ecc < 0.95:
            raise ValueError(
                "timing/binary: BT eccentricity must sit in [0, 0.95) "
                f"for the fixed-iteration Kepler solve, got {ecc}")
        kw.update(ecc=ecc, om=_fget(par, "OM", 0.0) or 0.0)
    return BinaryParams(**kw)


# ---------------------------------------------------------------------------
# ELL1 (Lange et al. 2001)
# ---------------------------------------------------------------------------

def _ell1_core(xp, dt, pb_s, a1, eps1, eps2, pbdot, xdot,
               eps1dot, eps2dot):
    """Shared ELL1 math over an array module xp (numpy or torch):
    returns (delay, partials wrt (pb_s, a1, tasc_s, eps1, eps2)), all
    in seconds (per second / per lt-s / per unit-eps)."""
    u = dt / pb_s  # orbits since TASC
    phi = 2.0 * np.pi * (u - 0.5 * pbdot * u * u)
    x = a1 + xdot * dt
    eta = eps1 + eps1dot * dt
    kap = eps2 + eps2dot * dt
    s1, c1 = xp.sin(phi), xp.cos(phi)
    s2, c2 = 2.0 * s1 * c1, 1.0 - 2.0 * s1 * s1  # sin2Φ, cos2Φ exactly
    shape = s1 + 0.5 * kap * s2 - 0.5 * eta * c2
    delay = x * shape
    # dΔ/dΦ, then the chain through Φ's PB and TASC dependence
    ddelay_dphi = x * (c1 + kap * c2 + eta * s2)
    dphi_dpb = -2.0 * np.pi * (u / pb_s) * (1.0 - pbdot * u)
    dphi_dtasc = -2.0 * np.pi * (1.0 / pb_s) * (1.0 - pbdot * u)
    d_pb = ddelay_dphi * dphi_dpb
    d_a1 = shape
    # TASC also enters through dt in x(t), η(t), κ(t); those secular
    # terms are second-order tiny but free to carry exactly
    d_tasc = (ddelay_dphi * dphi_dtasc
              - xdot * shape
              - x * (0.5 * eps2dot * s2 - 0.5 * eps1dot * c2))
    d_eps1 = -0.5 * x * c2
    d_eps2 = 0.5 * x * s2
    return delay, (d_pb, d_a1, d_tasc, d_eps1, d_eps2)


def ell1_delay_np(dt, pb_s, a1, eps1, eps2, pbdot=0.0, xdot=0.0,
                  eps1dot=0.0, eps2dot=0.0):
    """Host-NumPy oracle: ELL1 Roemer delay [s] at dt seconds past
    TASC.  pb_s in SECONDS (callers convert from parfile days)."""
    dt = np.asarray(dt, np.float64)
    return _ell1_core(np, dt, pb_s, a1, eps1, eps2, pbdot, xdot,
                      eps1dot, eps2dot)[0]


def _t64(dt, device):
    """dt as a float64 tensor on the resolved ``device`` (a tensor's
    own device when none is given)."""
    from ..device import resolve_device

    if isinstance(dt, torch.Tensor):
        if device is None:
            device = dt.device
        return dt.to(dtype=torch.float64, device=resolve_device(device))
    return torch.as_tensor(np.asarray(dt, np.float64), dtype=torch.float64,
                           device=resolve_device(device))


def _stack(parts, dt):
    return torch.stack([torch.broadcast_to(
        torch.as_tensor(p, dtype=torch.float64, device=dt.device),
        dt.shape) for p in parts])


def ell1_delay_and_partials(dt, pb_s, a1, eps1, eps2, pbdot=0.0,
                            xdot=0.0, eps1dot=0.0, eps2dot=0.0,
                            device=None):
    """float64 torch op on ``device`` (default cuda): (delay [s],
    partials (5, n) wrt (pb_s, a1, tasc_s, eps1, eps2))."""
    dt = _t64(dt, device)
    delay, parts = _ell1_core(torch, dt, pb_s, a1, eps1, eps2, pbdot,
                              xdot, eps1dot, eps2dot)
    return delay, _stack(parts, dt)


# ---------------------------------------------------------------------------
# BT (Blandford & Teukolsky 1976)
# ---------------------------------------------------------------------------

def _kepler_E_np(M, ecc):
    """Newton-solve E − e·sinE = M with the same fixed iteration count
    as the torch op, so oracle and device agree to round-off."""
    E = np.array(M, np.float64, copy=True)
    for _ in range(KEPLER_NEWTON_ITERS):
        E = E - (E - ecc * np.sin(E) - M) / (1.0 - ecc * np.cos(E))
    return E


def _bt_core(xp, E, dt, pb_s, a1, ecc, om_rad, pbdot, xdot):
    """Shared BT math given the solved eccentric anomaly E: returns
    (delay, partials wrt (pb_s, a1, t0_s, ecc, om_rad))."""
    sE, cE = xp.sin(E), xp.cos(E)
    so, co = np.sin(om_rad), np.cos(om_rad)
    rt = np.sqrt(1.0 - ecc * ecc)  # ecc is a host scalar < 0.95
    x = a1 + xdot * dt
    delay = x * so * (cE - ecc) + x * co * rt * sE
    # dΔ/dE, then E's dependence on (M, e): dE/dM = 1/(1−e·cosE),
    # dE/de|_M = sinE/(1−e·cosE)
    ddelay_dE = -x * so * sE + x * co * rt * cE
    dE_dM = 1.0 / (1.0 - ecc * cE)
    u = dt / pb_s
    dM_dpb = -2.0 * np.pi * (u / pb_s) * (1.0 - pbdot * u)
    dM_dt0 = -2.0 * np.pi * (1.0 / pb_s) * (1.0 - pbdot * u)
    d_pb = ddelay_dE * dE_dM * dM_dpb
    d_a1 = so * (cE - ecc) + co * rt * sE
    d_t0 = ddelay_dE * dE_dM * dM_dt0 - xdot * d_a1
    d_ecc = (ddelay_dE * dE_dM * sE          # through E at fixed M
             - x * so                         # explicit −e term
             - x * co * sE * (ecc / rt))      # through √(1−e²)
    d_om = x * co * (cE - ecc) - x * so * rt * sE
    return delay, (d_pb, d_a1, d_t0, d_ecc, d_om)


def bt_delay_np(dt, pb_s, a1, ecc, om_deg, pbdot=0.0, xdot=0.0):
    """Host-NumPy oracle: BT Roemer delay [s] at dt seconds past T0."""
    dt = np.asarray(dt, np.float64)
    u = dt / pb_s
    M = 2.0 * np.pi * (u - 0.5 * pbdot * u * u)
    E = _kepler_E_np(M, ecc)
    om_rad = np.deg2rad(om_deg)
    return _bt_core(np, E, dt, pb_s, a1, ecc, om_rad, pbdot, xdot)[0]


def bt_delay_and_partials(dt, pb_s, a1, ecc, om_deg, pbdot=0.0,
                          xdot=0.0, device=None):
    """float64 torch op on ``device`` (default cuda): (delay [s],
    partials (5, n) wrt (pb_s, a1, t0_s, ecc, om_rad)).  Kepler's
    equation is solved by KEPLER_NEWTON_ITERS Newton steps, a fixed
    count as in the JAX package's lax.fori_loop."""
    dt = _t64(dt, device)
    u = dt / pb_s
    M = 2.0 * np.pi * (u - 0.5 * pbdot * u * u)
    E = M
    for _ in range(KEPLER_NEWTON_ITERS):
        E = E - (E - ecc * torch.sin(E) - M) / (1.0 - ecc * torch.cos(E))
    om_rad = np.deg2rad(om_deg)
    delay, parts = _bt_core(torch, E, dt, pb_s, a1, ecc, om_rad, pbdot,
                            xdot)
    return delay, _stack(parts, dt)


# ---------------------------------------------------------------------------
# Dispatch by BinaryParams
# ---------------------------------------------------------------------------

def binary_delay_np(bp, mjd_int, mjd_frac):
    """Delay [s] at the given epochs for a parsed BinaryParams — the
    host-NumPy lane (synth injection, oracles)."""
    dt = bp.dt_seconds(mjd_int, mjd_frac)
    if bp.kind == "ELL1":
        return ell1_delay_np(dt, bp.pb * SECPERDAY, bp.a1, bp.eps1,
                             bp.eps2, bp.pbdot, bp.xdot, bp.eps1dot,
                             bp.eps2dot)
    return bt_delay_np(dt, bp.pb * SECPERDAY, bp.a1, bp.ecc, bp.om,
                       bp.pbdot, bp.xdot)


def binary_delay_and_partials(bp, mjd_int, mjd_frac, device=None):
    """(delay [s], partials (5, n)) through the torch ops on ``device``
    (default cuda), float64, with the PB and TASC/T0 partials converted
    to PARFILE units (per day), and the BT ω partial converted to per
    degree — ready to drop into the GLS design matrix as
    d(delay)/d(param) columns.

    Column order matches ``bp.param_names``.
    """
    dt = bp.dt_seconds(mjd_int, mjd_frac)
    if bp.kind == "ELL1":
        delay, parts = ell1_delay_and_partials(
            dt, bp.pb * SECPERDAY, bp.a1, bp.eps1, bp.eps2, bp.pbdot,
            bp.xdot, bp.eps1dot, bp.eps2dot, device=device)
        scale = [SECPERDAY, 1.0, SECPERDAY, 1.0, 1.0]
    else:
        delay, parts = bt_delay_and_partials(
            dt, bp.pb * SECPERDAY, bp.a1, bp.ecc, bp.om, bp.pbdot,
            bp.xdot, device=device)
        scale = [SECPERDAY, 1.0, SECPERDAY, 1.0, np.pi / 180.0]
    scale = torch.tensor(scale, dtype=torch.float64, device=parts.device)
    return delay, parts * scale[:, None]
