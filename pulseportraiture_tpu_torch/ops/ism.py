"""ISM scattering/refraction helper quantities (counterpart of
pulseportraiture_tpu/ops/ism.py, a NumPy copy).

Capability parity with the reference's ISM helpers: mean_C2N and the
frequency-dependent delta-DM prediction (reference pplib.py:1221-1248,
Foster, Fairhead & Backer 1991; Cordes & Shannon 2010), and the
"discrete cloud" GM <-> DMc conversions (reference pptoaslib.py:93-121,
Lam et al. 2016).

These are scalar host-side convenience formulas (no hot path); plain
float math so they work on python scalars and numpy arrays alike.
"""

import numpy as np

# speed of light expressed as [cm/s] / [cm/kpc] (reference pptoaslib.py:105)
_C_KPC = 3e10 / 3.1e21
# 1 AU expressed in kpc (reference uses 4.8e-9 kpc/AU, pptoaslib.py:106)
_AU_KPC = 4.8e-9


def mean_C2N(nu, D, bw_scint):
    """Mean turbulence strength C_N^2 [m^-20/3] from the scintillation
    bandwidth (Foster, Fairhead & Backer 1991; reference pplib.py:1221).

    nu [MHz], D distance [kpc], bw_scint scintillation bandwidth [MHz].
    """
    return 2e-14 * nu ** (11 / 3.0) * D ** (-11 / 6.0) * bw_scint ** (-5 / 6.0)


def dDM(D, D_screen, nu, bw_scint):
    """Predicted frequency-dependent delta-DM [cm^-3 pc] from a thin
    scattering screen (Cordes & Shannon 2010; reference pplib.py:1235).

    D pulsar distance [kpc], D_screen Earth-screen distance [kpc],
    nu [MHz], bw_scint scintillation bandwidth at nu [MHz].
    """
    SM = mean_C2N(nu, D, bw_scint) * D  # scattering measure [m^-20/3 kpc]
    return 10**4.45 * SM * D_screen ** (5 / 6.0) * nu ** (-11 / 6.0)


def GM_from_DMc(DMc, D, a_perp):
    """Geometric delay factor GM from a discrete cloud of dispersion
    measure DMc (Lam et al. 2016; reference pptoaslib.py:93-106).

    The resulting pulse delay is Dconst**2 * GM * nu**-4.
    DMc [cm^-3 pc], D Earth-cloud distance [kpc], a_perp transverse
    scale [AU].
    """
    return DMc**2 * (_C_KPC * D) / (2.0 * (a_perp * _AU_KPC) ** 2)


def DMc_from_GM(GM, D, a_perp):
    """Discrete-cloud DM giving geometric delay factor GM — the exact
    inverse of GM_from_DMc.

    The reference's version (pptoaslib.py:109-121) mis-places a
    parenthesis (`2*a_perp*(4.8e-9)**2` instead of
    `2*(a_perp*4.8e-9)**2`) and so does not invert GM_from_DMc; this
    implementation is the consistent inverse (a documented defect fix).
    """
    return np.sqrt(GM * 2.0 * (a_perp * _AU_KPC) ** 2 / (_C_KPC * D))
