"""Host-side low-precision astronomical ephemerides.

Provides the two site-geometry quantities the reference obtained from
PSRCHIVE's ephemeris engine and that PSRFITS itself does not store:

- per-subint barycentric Doppler factors (reference pplib.py:2795-2805:
  ``doppler_factor = nu_source/nu_observed = sqrt((1+beta)/(1-beta))``
  with beta = v/c and v > 0 for increasing distance), used by the
  pipeline as DM *= df, GM *= df**3 (reference pptoas.py:583-591);
- per-subint parallactic angles (reference pplib.py:2806-2808, via
  PSRCHIVE's ``fix pointing``).

Accuracy budget: the Doppler correction is a ~1e-4 relative effect on
DM, so an Earth-velocity model good to ~10 m/s (|v| ~ 30 km/s ->
3e-4 relative) leaves a < 1e-7 relative DM error — far below TOA
noise.  The model used here is the two-body EMB orbit from the
low-precision solar-position series (mean elements + equation of
centre), precessed to J2000, differentiated analytically by central
difference, plus the Earth-rotation term at the site.  Everything is
plain vectorized NumPy on host: this runs once per archive load, is
not a hot path, and must not touch the accelerator.
"""

import math
import re

import numpy as np

__all__ = [
    "parse_ra", "parse_dec", "radec_unit_vector", "itrf_to_geodetic",
    "gmst_rad", "earth_ssb_velocity_kms", "site_rotation_velocity_kms",
    "doppler_factors", "parallactic_angles", "telescope_itrf",
]

C_KMS = 299792.458          # speed of light [km/s]
AU_KM = 1.495978707e8       # astronomical unit [km]
OMEGA_EARTH = 7.2921150e-5  # Earth sidereal rotation rate [rad/s]
SECPERDAY = 86400.0
# WGS84
_WGS84_A = 6378.137         # equatorial radius [km]
_WGS84_F = 1.0 / 298.257223563

# Mean obliquity of the ecliptic at J2000 [rad]
_EPS0 = math.radians(23.43929111)

# ITRF (x, y, z) [m] for common observatories, keyed by the canonical
# tempo2 site name used in io/telescopes.py.  Values are the published
# tempo2 observatories.dat coordinates (public constants; the numbers
# ARE the spec).  Used only when the archive carries no ANT_X/Y/Z.
_TELESCOPE_ITRF_M = {
    "gbt": (882589.65, -4924872.32, 3943729.348),
    "arecibo": (2390490.0, -5564764.0, 1994727.0),
    "pks": (-4554231.5, 2816759.1, -3454036.3),
    "jb": (3822626.04, -154105.65, 5086486.04),
    "jbmk2": (3822846.76, -153802.28, 5086285.9),
    "eff": (4033949.5, 486989.4, 4900430.8),
    "ncy": (4324165.81, 165927.11, 4670132.83),
    "wsrt": (3828445.659, 445223.6, 5064921.5677),
    "fast": (-1668557.0, 5506838.0, 2744934.0),
    "gmrt": (1656342.3, 5797947.77, 2073243.16),
    "chime": (-2059166.313, -3621302.972, 4814304.113),
    "vla": (-1601192.0, -5041981.4, 3554871.4),
    "srt": (4865182.766, 791922.689, 4035137.174),
    "hart": (5085442.78, 2668263.483, -2768697.034),
    "hobart": (-3950077.96, 2522377.31, -4311667.52),
    "meerkat": (5109360.133, 2006852.586, -3238948.127),
    "lofar": (3826577.462, 461022.624, 5064892.526),
    "mwa": (-2559454.08, 5095372.14, -2849057.18),
    "lwa1": (-1602196.6, -5042313.47, 3553971.51),
    "utr-2": (3307865.236, 2487350.541, 4836939.784),
}


def telescope_itrf(name):
    """ITRF (x, y, z) [m] for a telescope name/alias, or None.
    Prefers a TEMPO2 runtime's observatory table, then the builtin."""
    if not name:
        return None
    from ..io.telescopes import canonical_name, tempo2_itrf

    xyz = tempo2_itrf(name)
    if xyz is None:
        canon = canonical_name(name)
        key = (canon or str(name)).lower()
        xyz = _TELESCOPE_ITRF_M.get(key)
    return np.asarray(xyz, np.float64) if xyz is not None else None


# -- angles -----------------------------------------------------------------

_SEXA = re.compile(r"^([+-]?)(\d+)[:h ](\d+)[:m ]([\d.]+)s?$")


def _parse_sexagesimal(s):
    s = str(s).strip()
    m = _SEXA.match(s)
    if m is None:
        return float(s)  # already decimal
    sign = -1.0 if m.group(1) == "-" else 1.0
    d, mi, se = float(m.group(2)), float(m.group(3)), float(m.group(4))
    return sign * (d + mi / 60.0 + se / 3600.0)


def parse_ra(s):
    """RA 'hh:mm:ss.s' (or decimal degrees) -> degrees."""
    v = _parse_sexagesimal(s)
    return v * 15.0 if _SEXA.match(str(s).strip()) else v


def parse_dec(s):
    """DEC '+dd:mm:ss.s' (or decimal degrees) -> degrees."""
    return _parse_sexagesimal(s)


def radec_unit_vector(ra_deg, dec_deg):
    """J2000 equatorial unit vector toward (RA, DEC)."""
    ra = math.radians(float(ra_deg))
    dec = math.radians(float(dec_deg))
    return np.array([
        math.cos(dec) * math.cos(ra),
        math.cos(dec) * math.sin(ra),
        math.sin(dec),
    ])


def itrf_to_geodetic(xyz_m):
    """ITRF (x, y, z) [m] -> (geodetic latitude [rad], east longitude
    [rad], height [km]) on WGS84 (Bowring's closed-form iteration)."""
    x, y, z = (float(v) / 1000.0 for v in xyz_m)  # km
    a, f = _WGS84_A, _WGS84_F
    b = a * (1.0 - f)
    e2 = f * (2.0 - f)
    ep2 = e2 / (1.0 - e2)
    p = math.hypot(x, y)
    lon = math.atan2(y, x)
    theta = math.atan2(z * a, p * b)
    lat = math.atan2(z + ep2 * b * math.sin(theta) ** 3,
                     p - e2 * a * math.cos(theta) ** 3)
    n = a / math.sqrt(1.0 - e2 * math.sin(lat) ** 2)
    h = p / math.cos(lat) - n
    return lat, lon, h


def gmst_rad(mjd_ut):
    """Greenwich mean sidereal time [rad] at UT MJD (IAU 1982; ~0.1 s
    accuracy — ample for 0.1-degree parallactic angles and mm/s site
    velocities)."""
    mjd = np.asarray(mjd_ut, np.float64)
    d = mjd - 51544.5  # days since J2000.0
    gmst_deg = 280.46061837 + 360.98564736629 * d
    t = d / 36525.0
    gmst_deg = gmst_deg + (0.000387933 - t / 38710000.0) * t * t
    return np.deg2rad(np.mod(gmst_deg, 360.0))


# -- Earth barycentric velocity --------------------------------------------

def _emb_position_au(mjd_tt):
    """EMB heliocentric position [AU], J2000 equatorial frame.

    Low-precision solar series (mean longitude + equation of centre,
    ~0.01 deg), precessed from the mean equinox of date to J2000."""
    t = (np.asarray(mjd_tt, np.float64) - 51544.5) / 36525.0
    L0 = 280.46646 + 36000.76983 * t + 0.0003032 * t * t
    M = np.deg2rad(357.52911 + 35999.05029 * t - 0.0001537 * t * t)
    e = 0.016708634 - 0.000042037 * t
    C = ((1.914602 - 0.004817 * t - 0.000014 * t * t) * np.sin(M)
         + (0.019993 - 0.000101 * t) * np.sin(2.0 * M)
         + 0.000289 * np.sin(3.0 * M))
    lam_sun = L0 + C                       # Sun true longitude, of date
    nu = M + np.deg2rad(C)                 # true anomaly
    R = 1.000001018 * (1.0 - e * e) / (1.0 + e * np.cos(nu))  # [AU]
    # precess longitude of date -> J2000 (general precession 5029"/cy)
    lam = np.deg2rad(lam_sun - 1.39697137 * t)
    # Earth is opposite the Sun; ecliptic latitude ~< 1.2" ignored
    x_ecl = -R * np.cos(lam)
    y_ecl = -R * np.sin(lam)
    ce, se = math.cos(_EPS0), math.sin(_EPS0)
    return np.stack(
        [x_ecl, y_ecl * ce, y_ecl * se], axis=-1)


def earth_ssb_velocity_kms(mjd_tt):
    """Earth barycentric velocity [km/s], J2000 equatorial, at TT MJD
    (UTC is fine: a 69 s timescale offset moves the velocity by mm/s).

    Central difference of the analytic EMB orbit.  Omits the Sun's
    barycentric motion (~13 m/s) and the Earth-Moon wobble (~13 m/s):
    both are < 1e-3 of |v| and contribute < 1e-7 relative DM error.
    Returns shape (..., 3)."""
    dt = 0.02  # days
    mjd = np.asarray(mjd_tt, np.float64)
    dpos = _emb_position_au(mjd + dt) - _emb_position_au(mjd - dt)
    return dpos * (AU_KM / (2.0 * dt * SECPERDAY))


def site_rotation_velocity_kms(mjd_ut, xyz_itrf_m):
    """Observatory velocity [km/s] from Earth rotation, J2000
    equatorial frame: omega x r with r the ITRF position rotated to the
    celestial frame by GMST (polar motion / nutation ~0.1 m/s ignored).
    Returns shape (..., 3)."""
    g = gmst_rad(mjd_ut)
    x, y = float(xyz_itrf_m[0]) / 1000.0, float(xyz_itrf_m[1]) / 1000.0
    cg, sg = np.cos(g), np.sin(g)
    # r_cel = Rz(gmst) r_itrf; v = omega ez x r_cel
    rx = x * cg - y * sg
    ry = x * sg + y * cg
    vx = -OMEGA_EARTH * ry
    vy = OMEGA_EARTH * rx
    return np.stack([vx, vy, np.zeros_like(vx)], axis=-1)


def doppler_factors(mjd_utc, ra_deg, dec_deg, xyz_itrf_m=None):
    """Barycentric Doppler factor nu_source/nu_observed per epoch.

    df = sqrt((1+beta)/(1-beta)), beta = v_r/c with v_r the line-of-
    sight velocity of the observatory away from the source (reference
    convention, pplib.py:2795-2805).  mjd_utc may be an array."""
    n_hat = radec_unit_vector(ra_deg, dec_deg)
    v = earth_ssb_velocity_kms(mjd_utc)
    if xyz_itrf_m is not None:
        v = v + site_rotation_velocity_kms(mjd_utc, xyz_itrf_m)
    beta = -(v @ n_hat) / C_KMS  # receding > 0
    return np.sqrt((1.0 + beta) / (1.0 - beta))


def parallactic_angles(mjd_utc, ra_deg, dec_deg, xyz_itrf_m):
    """Parallactic angle [deg] per epoch at an ITRF site.

    q = atan2(sin H, tan(lat) cos(dec) - sin(dec) cos H), H the local
    hour angle — the standard alt-az formula, matching PSRCHIVE's
    pointing computation (reference pplib.py:2806-2808) to well under
    0.1 deg for UT1-UTC < 1 s."""
    lat, lon_east, _ = itrf_to_geodetic(xyz_itrf_m)
    ra = math.radians(float(ra_deg))
    dec = math.radians(float(dec_deg))
    lst = gmst_rad(mjd_utc) + lon_east
    H = lst - ra
    q = np.arctan2(np.sin(H),
                   math.tan(lat) * math.cos(dec)
                   - math.sin(dec) * np.cos(H))
    return np.rad2deg(q)
