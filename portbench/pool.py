"""The cell's pool of archives: the same work on every seed.

A configuration fixes the shapes (channels, bins, subints, band, period,
DM, template); a traffic mix fixes the number of archives and, one entry
per archive, the injected phase, DM offset and scattering, and the S/N of
every subint.  The seed draws only the white noise.  The pool is made on
the device in a few large calls, quantized to int16 with DAT_SCL and
DAT_OFFS as a fold-mode backend stores it, and kept on the host: the
program reads it as PSRFITS through its own loader, the reference from
these arrays.
"""

import contextlib
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from . import psrfits_writer
from .reference import DCONST, read_gmodel, template_ft


@dataclass
class Pool:
    q: np.ndarray        # (narchive, nsub, nchan, nbin) int16
    scl: np.ndarray      # (narchive, nsub, nchan) float32
    offs: np.ndarray     # (narchive, nsub, nchan) float32
    freqs: np.ndarray    # (nchan,) MHz
    phase: np.ndarray    # (narchive,) injected phase [rot] at centre_mhz
    dm: np.ndarray       # (narchive,) injected DM [pc cm^-3]
    tau_rot: np.ndarray  # (narchive,) scattering time [rot] at freqs[0]
    alpha: np.ndarray    # (narchive,) scattering index
    scat: bool
    template: dict
    template_path: str
    centre_mhz: float
    bw_mhz: float
    period_s: float
    tsub_s: float
    start: tuple         # (STT_IMJD, STT_SMJD, STT_OFFS)
    header_dm: float
    meta: dict

    @property
    def narchive(self):
        return self.q.shape[0]

    @property
    def nsub(self):
        return self.q.shape[1]

    @property
    def nbin(self):
        return self.q.shape[-1]

    def tau_rot_at(self, a, nu):
        """Archive a's injected scattering time [rot] at nu [MHz]."""
        return float(self.tau_rot[a]
                     * (nu / self.freqs[0]) ** self.alpha[a])


def channel_freqs(centre_mhz, bw_mhz, nchan):
    """Channel centres of a band of nchan equal channels."""
    return (centre_mhz - 0.5 * bw_mhz
            + (np.arange(nchan) + 0.5) * bw_mhz / nchan)


def make_pool(cfg, traffic, seed, device):
    """The pool of configuration ``cfg`` under traffic ``traffic``, its
    noise drawn from ``seed`` on ``device``."""
    nchan, nbin, nsub = cfg["nchan"], cfg["nbin"], cfg["nsub_per_archive"]
    freqs = channel_freqs(cfg["centre_mhz"], cfg["bw_mhz"], nchan)
    narch = len(traffic["phase_rot"])
    scat = traffic.get("scattering") is not None
    sc = traffic.get("scattering") or {}
    tau_rot = np.asarray(sc.get("tau_bins_at_bottom", [0.0] * narch),
                         float) / nbin
    alpha = np.asarray(sc.get("alpha", [-4.0] * narch), float)
    phase = np.asarray(traffic["phase_rot"], float)
    dm = cfg["dm"] + np.asarray(traffic["ddm"], float)
    P = float(cfg["period_s"])
    gm = read_gmodel(cfg["template_path"])
    nharm = nbin // 2 + 1
    M = template_ft(gm, freqs, nharm, device)
    f = torch.as_tensor(freqs, dtype=torch.float64, device=device)
    k = torch.arange(nharm, dtype=torch.float64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    q = np.empty((narch, nsub, nchan, nbin), np.int16)
    scl = np.empty((narch, nsub, nchan), np.float32)
    offs = np.empty((narch, nsub, nchan), np.float32)
    for a in range(narch):
        t = phase[a] + (DCONST * dm[a] / P) * (f ** -2.0
                                               - cfg["centre_mhz"] ** -2.0)
        ang = -2.0 * math.pi * t[:, None] * k
        S = M * torch.complex(torch.cos(ang), torch.sin(ang))
        if scat:
            u = 2.0 * math.pi * k * (tau_rot[a] * (f / freqs[0])
                                     ** alpha[a])[:, None]
            S = S / torch.complex(torch.ones_like(u), u)
        sig = torch.fft.irfft(S, n=nbin)
        # matched-filter S/N of every subint at unit noise
        sig = sig * (traffic["snr"] / sig.pow(2).sum().sqrt())
        x = torch.randn((nsub, nchan, nbin), generator=gen, device=device,
                        dtype=torch.float32)
        x += sig.to(torch.float32)
        hi = x.amax(dim=-1).double()
        lo = x.amin(dim=-1).double()
        o = 0.5 * (hi + lo)
        s = ((hi - lo) / 65530.0).clamp(min=1e-30)
        qa = torch.round((x.double() - o[..., None]) / s[..., None])
        q[a] = qa.clamp(-32768, 32767).to(torch.int16).cpu().numpy()
        scl[a] = s.to(torch.float32).cpu().numpy()
        offs[a] = o.to(torch.float32).cpu().numpy()
        del x, qa
    return Pool(q=q, scl=scl, offs=offs, freqs=freqs, phase=phase, dm=dm,
                tau_rot=tau_rot, alpha=alpha, scat=scat, template=gm,
                template_path=cfg["template_path"],
                centre_mhz=float(cfg["centre_mhz"]),
                bw_mhz=float(cfg["bw_mhz"]), period_s=P,
                tsub_s=float(cfg["tsub_s"]),
                start=(int(cfg["start_mjd"]), int(cfg["start_second"]), 0.0),
                header_dm=float(cfg["dm"]),
                meta={"source": cfg["source_name"],
                      "telescope": cfg["telescope"],
                      "frontend": cfg["frontend"],
                      "backend": cfg["backend"],
                      "centre_mhz": cfg["centre_mhz"],
                      "bw_mhz": cfg["bw_mhz"], "dm": cfg["dm"]})


@contextlib.contextmanager
def _archive_file(a):
    """A path for one archive's bytes: an in-memory file (Linux's
    memfd), so nothing reaches a disk."""
    fd = os.memfd_create(f"portbench-archive-{a}")
    try:
        yield fd, f"/proc/self/fd/{fd}"
    finally:
        os.close(fd)


def load_through(pool, loader):
    """Write every archive as PSRFITS and read it back through ``loader``
    (the port's lane loader).  Returns [(datafile, loaded), ...]."""
    loaded = []
    for a in range(pool.narchive):
        with _archive_file(a) as (fd, path):
            with os.fdopen(os.dup(fd), "wb") as f:
                psrfits_writer.write_fold_archive(
                    f, pool.q[a], pool.scl[a], pool.offs[a], pool.freqs,
                    pool.period_s, pool.tsub_s, pool.start, pool.meta)
            d = loader(path)
        loaded.append((f"pool-archive-{a}.fits", d))
    return loaded
