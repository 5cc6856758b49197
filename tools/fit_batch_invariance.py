#!/usr/bin/env python3
"""Whether a float32 scattering fit's result depends on the batch it
runs in, and which step makes it so.

    python3 tools/fit_batch_invariance.py [--device cuda|cpu] [--work DIR]

Writes an 8-subint scattered archive like chip_smoke.py's scattering
branch of the scale-out path (512 x 2048 on cuda, 64 x 512 on cpu) into
DIR (default build/fit_batch_invariance) and prints one JSON line per
check:

- "fit": the fast scattering lane (phi, DM, tau, alpha free, log10 tau)
  on the 8 subints in batches of 1, 2, 4 and 8, with the harmonic window
  ('auto') and without; the largest |value - batch of 8| over each
  value's error, the function evaluations and the return codes;
- one step at a time, row 0 in a batch of 1 against the same row in a
  batch of 8, bit for bit: B1 (both forms, cuda only), torch.fft.rfft,
  torch.sum over the last axis, the einsum and matmul shapes of the
  scattering lane's Hessian and gradient, and one _cgh_scatter call;
- "fit calls": the lane's own _cgh_scatter calls for subint 0 fitted
  alone and in the batch of 8, call by call: the first call whose
  inputs or outputs differ, and which of them.

Prints the card's name and power limit first.
"""

import argparse
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NSUB = 8
BATCH_KEYS = ("ports", "noise_stds", "P", "nu_fit", "theta0", "chan_masks")


def make_inputs(work, device, nchan, nbin):
    """The scattered archive's fit inputs (float32 numpy) and the
    template's harmonic window."""
    import numpy as np

    import chip_smoke as C
    from pulseportraiture_tpu_torch.fit.portrait import \
        resolve_harmonic_window
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.pipeline.models import TemplateModel
    from pulseportraiture_tpu_torch.pipeline.toas import (
        load_for_toas, snr_weighted_nu_fit)
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "scat.fits")
    gmodel = os.path.join(work, "model.gmodel")
    model = default_test_model(1500.0)
    write_gmodel(model, gmodel, quiet=True)
    make_fake_pulsar(model, C.PAR, outfile=path, nsub=NSUB, nchan=nchan,
                     nbin=nbin, nu0=1500.0, bw=800.0, tsub=60.0,
                     phase=C.PHI_INJ, dDM=C.DDM_INJ, t_scat=C.T_SCAT,
                     alpha=C.ALPHA_INJ, start_MJD=MJD(55700, 0.1),
                     noise_stds=C.NOISE_SCAT_I16, dedispersed=False,
                     quiet=True, rng=np.random.default_rng(C.SEED + 200),
                     device=device)
    d = load_for_toas(path)
    ok = np.asarray(d.ok_isubs, int)
    freqs = np.asarray(d.freqs[0], float)
    P = np.asarray(d.Ps[ok], float)
    masks = np.asarray(d.weights[ok] > 0.0, np.float32)
    theta0 = np.zeros((len(ok), 5))
    theta0[:, 1] = float(d.DM)
    theta0[:, 3] = math.log10(0.5 * C.T_SCAT / float(np.mean(P)))
    theta0[:, 4] = -4.0
    mp = np.asarray(TemplateModel(gmodel, device=device).portrait(
        freqs, d.nbin, P=float(np.mean(P))), np.float32)
    inp = dict(ports=np.asarray(d.subints[ok, 0], np.float32), models=mp,
               noise_stds=np.asarray(d.noise_stds[ok, 0], np.float32),
               freqs=freqs.astype(np.float32), P=P.astype(np.float32),
               nu_fit=snr_weighted_nu_fit(np.asarray(d.SNRs[ok, 0]) * masks,
                                          freqs).astype(np.float32),
               theta0=theta0.astype(np.float32), chan_masks=masks)
    return inp, resolve_harmonic_window("auto", mp, nbin)


def fit(inp, sl, K, device):
    """The scattering lane on subints ``sl`` (window K, or none)."""
    import torch

    from pulseportraiture_tpu_torch.fit.portrait import (
        FitFlags, fit_portrait_batch_fast)

    a = {k: torch.as_tensor(v[sl] if k in BATCH_KEYS else v).to(device)
         for k, v in inp.items()}
    return fit_portrait_batch_fast(
        a["ports"], a["models"], a["noise_stds"], a["freqs"], a["P"],
        a["nu_fit"], theta0=a["theta0"], chan_masks=a["chan_masks"],
        fit_flags=FitFlags(True, True, False, True, True), log10_tau=True,
        max_iter=60, harmonic_window=False if K is None else K,
        device=device)


def same(name, a1, a8):
    """Print whether row 0 of a batch of 1 equals it in a batch of 8."""
    import torch

    a1, a8 = a1.detach(), a8.detach()
    if a1.is_complex():
        a1, a8 = torch.view_as_real(a1), torch.view_as_real(a8)
    d = float((a1.double() - a8.double()).abs().max())
    s = float(a8.double().abs().max())
    print(json.dumps(dict(step=name, bitwise=bool(torch.equal(a1, a8)),
                          max_abs=d, rel=d / max(s, 1e-300))))


def fits_by_batch(inp, K, device):
    import torch

    ref = fit(inp, slice(0, NSUB), K, device)
    for bs in (1, 2, 4, NSUB):
        rs = [fit(inp, slice(lo, lo + bs), K, device)
              for lo in range(0, NSUB, bs)]
        worst = {}
        for k in ("phi", "DM", "tau", "alpha"):
            dv = torch.cat([getattr(r, k) for r in rs]) - getattr(ref, k)
            if k == "phi":
                dv = (dv + 0.5) % 1.0 - 0.5
            worst[k] = float((dv.abs() / getattr(ref, k + "_err")).max())
        print(json.dumps(dict(
            step="fit", window=K, batch=bs, max_over_err=worst,
            nfeval=torch.cat([r.nfeval for r in rs]).tolist(),
            nfeval_8=ref.nfeval.tolist(),
            codes=torch.cat([r.return_code for r in rs]).tolist())))


def steps(inp, K, device):
    import torch

    import pulseportraiture_tpu_torch.fit.portrait as FP
    from pulseportraiture_tpu_torch.ops import fused as F

    nchan, nbin = inp["ports"].shape[1:]
    K = K or nbin // 2 + 1
    g = torch.Generator().manual_seed(5)

    def rnd(*shape, uniform=False):
        f = torch.rand if uniform else torch.randn
        return f(*shape, generator=g).to(device)

    port = torch.as_tensor(inp["ports"]).to(device)
    model = torch.as_tensor(inp["models"]).to(device)
    if torch.device(device).type == "cuda":
        w = rnd(NSUB, nchan, K, uniform=True)
        for m2 in (False, True):
            o8 = F.fused_cross_spectrum(port, model, w, K, want_m2=m2)
            o1 = F.fused_cross_spectrum(port[:1], model, w[:1], K,
                                        want_m2=m2)
            for i, (x1, x8) in enumerate(zip(o1, o8)):
                same(f"B1 want_m2={m2} output {i}", x1[0], x8[0])
    same("torch.fft.rfft", torch.fft.rfft(port[:1], dim=-1)[0],
         torch.fft.rfft(port, dim=-1)[0])
    x = rnd(NSUB, nchan, K)
    same("torch.sum(-1) of (B, nchan, K)", torch.sum(x[:1], -1)[0],
         torch.sum(x, -1)[0])
    y = rnd(NSUB, nchan)
    same("torch.sum(-1) of (B, nchan)", torch.sum(y[:1], -1)[0],
         torch.sum(y, -1)[0])
    A = rnd(NSUB, 5, nchan)
    same("einsum bn,bin,bjn->bij",
         torch.einsum("bn,bin,bjn->bij", y[:1], A[:1], A[:1])[0],
         torch.einsum("bn,bin,bjn->bij", y, A, A)[0])
    same("matmul (B, 5, n) @ (B, n, 1)",
         torch.matmul(A[:1], y[:1, :, None])[0],
         torch.matmul(A, y[..., None])[0])
    th = torch.as_tensor(inp["theta0"]).to(device)
    fr = torch.as_tensor(inp["freqs"]).to(device)
    nu = torch.as_tensor(inp["nu_fit"]).to(device)
    Xr, Xi = rnd(NSUB, nchan, K), rnd(NSUB, nchan, K)
    M2 = rnd(NSUB, nchan, K, uniform=True)
    cv, gv = rnd(NSUB, nchan) * 1e-3, torch.zeros(NSUB, nchan).to(device)
    r8 = FP._cgh_scatter(th, Xr, Xi, M2, fr, nu, cv, gv, True)
    r1 = FP._cgh_scatter(th[:1], Xr[:1], Xi[:1], M2[:1], fr, nu[:1],
                         cv[:1], gv[:1], True)
    for i, nm in enumerate(("f", "grad", "hess")):
        same(f"_cgh_scatter {nm}", r1[i][0], r8[i][0])
    same("_cgh_scatter C", r1[3][0][0], r8[3][0][0])
    same("_cgh_scatter S", r1[3][1][0], r8[3][1][0])


def fit_calls(inp, K, device):
    import torch

    import pulseportraiture_tpu_torch.fit.portrait as FP

    orig = FP._cgh_scatter
    logs = {}
    for bs in (1, NSUB):
        rec = []

        def spy(theta, Xr, Xi, M2, freqs, nu_fit, cvec, gvec, log10_tau,
                compensated=False, _rec=rec):
            out = orig(theta, Xr, Xi, M2, freqs, nu_fit, cvec, gvec,
                       log10_tau, compensated=compensated)
            _rec.append(dict(theta=theta[0].cpu(), Xr=Xr[0].cpu(),
                             Xi=Xi[0].cpu(), M2=M2[0].cpu(),
                             cvec=cvec[0].cpu(), f=out[0][0].cpu(),
                             g=out[1][0].cpu(), H=out[2][0].cpu()))
            return out
        FP._cgh_scatter = spy
        try:
            fit(inp, slice(0, bs), K, device)
        finally:
            FP._cgh_scatter = orig
        logs[bs] = rec
    first = None
    for i, (a, b) in enumerate(zip(logs[1], logs[NSUB])):
        diff = [k for k in a if not torch.equal(a[k], b[k])]
        if diff:
            first = dict(call=i, differ=diff, rel={
                k: float((a[k].double() - b[k].double()).abs().max()
                         / max(float(b[k].double().abs().max()), 1e-300))
                for k in diff})
            break
    print(json.dumps(dict(step="fit calls", window=K,
                          ncalls=[len(logs[1]), len(logs[NSUB])],
                          first_difference=first)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work", default=os.path.join(
        ROOT, "build", "fit_batch_invariance"))
    args = ap.parse_args(argv)
    import torch

    from pulseportraiture_tpu_torch.ops import fused as F

    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        F.build_kernels()
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    nchan, nbin = (512, 2048) if cuda else (64, 512)
    inp, K = make_inputs(args.work, args.device, nchan, nbin)
    print(f"{NSUB} subints x {nchan} x {nbin} float32, window K={K}")
    for k in (K, None):
        fits_by_batch(inp, k, args.device)
    steps(inp, K, args.device)
    for k in (K, None):
        fit_calls(inp, k, args.device)


if __name__ == "__main__":
    main()
