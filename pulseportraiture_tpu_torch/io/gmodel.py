"""The `.gmodel` text format: frequency-evolving Gaussian-component
models (grammar documented in the reference's examples/example.gmodel;
reader/writer parity: reference pplib.py:2931-3057).

Round-trips through the in-memory GaussianModel dataclass
(models/gaussian.py); generation at given (phases, freqs, P) runs the
torch portrait generator in float64 on the caller's device.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..models.gaussian import GaussianModel, gen_gaussian_portrait

# flat parameter vector layout, matching the on-disk column order:
# [dc, tau, (loc, mloc, wid, mwid, amp, mamp) * ngauss]


def model_to_flat(model):
    """GaussianModel -> (params, fit_flags) flat vectors of length
    2 + 6*ngauss (tau in seconds)."""
    ngauss = model.ngauss
    params = np.zeros(2 + 6 * ngauss)
    flags = np.zeros(2 + 6 * ngauss, int)
    params[0], params[1] = model.dc, model.tau
    ff = model.fit_flags
    flags[0] = int(ff.get("dc", 0))
    flags[1] = int(ff.get("tau", 0))
    for i in range(ngauss):
        params[2 + 6 * i: 8 + 6 * i] = [
            model.locs[i], model.mlocs[i], model.wids[i],
            model.mwids[i], model.amps[i], model.mamps[i]]
        flags[2 + 6 * i: 8 + 6 * i] = [
            int(f[i]) for f in (
                ff.get("locs", np.zeros(ngauss)),
                ff.get("mlocs", np.zeros(ngauss)),
                ff.get("wids", np.zeros(ngauss)),
                ff.get("mwids", np.zeros(ngauss)),
                ff.get("amps", np.zeros(ngauss)),
                ff.get("mamps", np.zeros(ngauss)))]
    return params, flags


def model_from_flat(name, code, nu_ref, params, fit_flags, alpha,
                    fit_alpha=0):
    """Flat vectors -> GaussianModel."""
    params = np.asarray(params, float)
    fit_flags = np.asarray(fit_flags, int)
    ngauss = (len(params) - 2) // 6
    comp = params[2:].reshape(ngauss, 6)
    cflags = fit_flags[2:].reshape(ngauss, 6)
    return GaussianModel(
        name=name, code=code, nu_ref=float(nu_ref),
        dc=float(params[0]), tau=float(params[1]), alpha=float(alpha),
        locs=comp[:, 0].copy(), mlocs=comp[:, 1].copy(),
        wids=comp[:, 2].copy(), mwids=comp[:, 3].copy(),
        amps=comp[:, 4].copy(), mamps=comp[:, 5].copy(),
        fit_flags={
            "dc": int(fit_flags[0]), "tau": int(fit_flags[1]),
            "alpha": int(fit_alpha),
            "locs": cflags[:, 0].copy(), "mlocs": cflags[:, 1].copy(),
            "wids": cflags[:, 2].copy(), "mwids": cflags[:, 3].copy(),
            "amps": cflags[:, 4].copy(), "mamps": cflags[:, 5].copy()})


def write_gmodel(model, filename, append=False, quiet=False):
    """Serialize a GaussianModel to the .gmodel text grammar
    (reference write_model, pplib.py:2931-2968)."""
    params, flags = model_to_flat(model)
    lines = [f"MODEL   {model.name}",
             f"CODE    {model.code}",
             f"FREQ    {model.nu_ref:.5f}",
             f"DC     {params[0]: .8f} {flags[0]:d}",
             f"TAU    {params[1]: .8f} {flags[1]:d}",
             f"ALPHA  {model.alpha: .3f}      "
             f"{int(model.fit_flags.get('alpha', 0)):d}"]
    for i in range(model.ngauss):
        vals = params[2 + 6 * i: 8 + 6 * i]
        ffs = flags[2 + 6 * i: 8 + 6 * i]
        pairs = "  ".join(f"{v: .8f} {f:d}" for v, f in zip(vals, ffs))
        lines.append(f"COMP{i + 1:02d} {pairs}")
    with open(filename, "a" if append else "w") as f:
        f.write("\n".join(lines) + "\n")
    if not quiet:
        print(f"{filename} written.")


def read_gmodel(modelfile, quiet=False):
    """Parse a .gmodel file -> GaussianModel (reference read_model
    read-only path, pplib.py:2971-3057; tolerates comments/blank
    lines/trailing comments the same way)."""
    name, code, nu_ref = "unknown", "000", None
    dc = tau = 0.0
    fit_dc = fit_tau = 0
    alpha, fit_alpha = 0.0, 0
    comps = []
    if not quiet:
        print(f"Reading model from {modelfile}...")
    with open(modelfile) as f:
        for line in f:
            info = line.split()
            if not info:
                continue
            key = info[0]
            try:
                if key == "MODEL":
                    name = info[1]
                elif key == "CODE":
                    code = info[1]
                elif key == "FREQ":
                    nu_ref = float(info[1])
                elif key == "DC":
                    dc, fit_dc = float(info[1]), int(info[2])
                elif key == "TAU":
                    tau, fit_tau = float(info[1]), int(info[2])
                elif key == "ALPHA":
                    alpha, fit_alpha = float(info[1]), int(info[2])
                elif key.startswith("COMP") and not key.startswith("#"):
                    vals = [float(x) for x in info[1::2][:6]]
                    ffs = [int(x) for x in info[2::2][:6]]
                    comps.append((vals, ffs))
            except (IndexError, ValueError):
                continue
    if nu_ref is None:
        raise ValueError(f"{modelfile}: no FREQ line — not a .gmodel file")
    ngauss = len(comps)
    params = np.zeros(2 + 6 * ngauss)
    flags = np.zeros(2 + 6 * ngauss, int)
    params[:2] = dc, tau
    flags[:2] = fit_dc, fit_tau
    for i, (vals, ffs) in enumerate(comps):
        params[2 + 6 * i: 8 + 6 * i] = vals
        flags[2 + 6 * i: 8 + 6 * i] = ffs
    return model_from_flat(name, code, nu_ref, params, flags, alpha,
                           fit_alpha)


def gen_gmodel_portrait(model, phases, freqs, P=None, quiet=True,
                        device=None):
    """Build the model portrait at the given phase-bin count and
    frequencies, in float64 on ``device`` (tau on disk is seconds and
    needs P when non-zero).  Returns a host numpy (nchan, nbin) array."""
    nbin = len(np.atleast_1d(phases))
    if model.tau != 0.0 and P is None:
        raise ValueError("need period P for non-zero scattering TAU")
    dev = resolve_device(device)
    freqs_t = torch.as_tensor(np.atleast_1d(np.asarray(freqs, float)),
                              dtype=torch.float64, device=dev)
    port = gen_gaussian_portrait(
        model.params(dev), freqs_t, model.nu_ref, nbin, P=P,
        code=model.code, scattered=model.tau != 0.0)
    if not quiet:
        print(f"Model Name: {model.name}: {model.ngauss} components, "
              f"{nbin} bins, {len(np.atleast_1d(freqs))} channels, "
              f"referenced at {model.nu_ref:.3f} MHz.")
    return port.cpu().numpy()
