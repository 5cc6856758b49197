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
  ('auto') and without; whether every FitResult field has the batch of
  8's bits, the largest |value - batch of 8| over each value's error,
  the function evaluations and the return codes;
- one step at a time, row 0 alone against the same row in batches of
  STEP_BATCHES, bit for bit: torch.fft.rfft, torch.sum over either
  axis, the CCF's irfft_mm, the einsum and matmul shapes of the old
  Hessian and gradient, torch.linalg.solve_ex / inv_ex, the 5 x 5
  products of the packaging, and their fixed-order replacements
  (fit.portrait.chan_sum, _bmm, _quad); then B1 (both forms, cuda only)
  and one _cgh_scatter call, row 0 in a batch of 1 against a batch of 8;
- "fit calls": the lane's own _cgh_scatter calls for subint 0 fitted
  alone and in the batch of 8, call by call: the first call whose
  inputs or outputs differ, and which of them.

- "time" (cuda): the lane's warm wall on a bucket of TIME_BATCH
  subints (the 8 tiled), the median of 3 calls; "time path": the
  scattering path's warm library call as chip_smoke.py's phase_scatter
  times it (time_path), with its peak allocated memory; "time main" and
  "time stream": the main path's fast fit by stage and the stream
  path's warm library call (time_main).  --time runs only these,
  against the package of the checkout the script lies in (so a copy of
  the script in another checkout, given the same --work, times that
  checkout's package on the same archives).

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
# the per-step checks' batch sizes, and the timed bucket
STEP_BATCHES = (1, 2, 8, 64)
TIME_BATCH = 256
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


def invariant(name, fn, *arrays):
    """Print, for each batch size b of STEP_BATCHES, whether row 0 of
    fn over the first b rows of ``arrays`` equals row 0 of fn over the
    first row alone, bit for bit (every output of fn)."""
    import torch

    def rows(b):
        out = fn(*[a[:b] for a in arrays])
        out = out if isinstance(out, tuple) else (out,)
        return [torch.view_as_real(o[0]) if o.is_complex() else o[0]
                for o in out]

    one = rows(1)
    bitwise, rel = {}, {}
    for b in STEP_BATCHES[1:]:
        got = rows(b)
        bitwise[b] = all(torch.equal(x, y) for x, y in zip(one, got))
        rel[b] = max(float((x.double() - y.double()).abs().max())
                     / max(float(y.double().abs().max()), 1e-300)
                     for x, y in zip(one, got))
    print(json.dumps(dict(step=name, bitwise=bitwise, rel=rel)))


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
        bitwise = all(torch.equal(torch.cat([getattr(r, k) for r in rs]),
                                  getattr(ref, k))
                      for k in ref._fields)
        print(json.dumps(dict(
            step="fit", window=K, batch=bs, bitwise=bitwise,
            max_over_err=worst,
            nfeval=torch.cat([r.nfeval for r in rs]).tolist(),
            nfeval_8=ref.nfeval.tolist(),
            codes=torch.cat([r.return_code for r in rs]).tolist())))


def steps(inp, K, device):
    """The lane's operations one at a time on random inputs of its
    shapes (invariant(): row 0 alone against row 0 in batches of
    STEP_BATCHES), then B1 and one _cgh_scatter call at batches of 1
    and 8 on the archive's rows."""
    import torch

    import pulseportraiture_tpu_torch.fit.portrait as FP
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.ops.fourier import irfft_mm

    nchan, nbin = inp["ports"].shape[1:]
    K = K or nbin // 2 + 1
    nb = STEP_BATCHES[-1]
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
    x = rnd(nb, nchan, nbin)
    invariant("torch.fft.rfft (B, nchan, nbin)",
              lambda a: torch.fft.rfft(a, dim=-1), x)
    invariant("torch.sum(-1) of (B, nchan, nbin)",
              lambda a: torch.sum(a, -1), x)
    del x
    x = rnd(nb, nchan, K)
    invariant("torch.sum(-1) of (B, nchan, K)", lambda a: torch.sum(a, -1),
              x)
    invariant("torch.sum(-1) of (B, nchan/2, K)",
              lambda a: torch.sum(a, -1), x[:, :nchan // 2].contiguous())
    invariant("torch.sum(-2) of (B, nchan, K)", lambda a: torch.sum(a, -2),
              x)
    invariant("irfft_mm of (B, K) to 2 nbin lags",
              lambda a, b: irfft_mm(a, b, n=2 * nbin), x[:, 0], x[:, 1])
    y = rnd(nb, nchan)
    invariant("torch.sum(-1) of (B, nchan)", lambda a: torch.sum(a, -1), y)
    invariant("torch.sum(-1) of (B, 5)", lambda a: torch.sum(a, -1),
              y[:, :5].contiguous())
    A = rnd(nb, 5, nchan)
    invariant("einsum bn,bin,bjn->bij",
              lambda a, b: torch.einsum("bn,bin,bjn->bij", a, b, b), y, A)
    invariant("matmul (B, 5, n) @ (B, n, 1)",
              lambda a, b: torch.matmul(b, a[..., None]), y, A)
    H = rnd(nb, 5, 5)
    H = H @ H.transpose(-1, -2) + 5.0 * torch.eye(5, device=device)
    v = rnd(nb, 5)
    invariant("torch.linalg.solve_ex (B, 5, 5)",
              lambda a, b: torch.linalg.solve_ex(a, b)[0], H, v)
    invariant("torch.linalg.inv_ex (B, 5, 5)",
              lambda a: torch.linalg.inv_ex(a)[0], H)
    invariant("matmul (B, 5, 5) @ (B, 5, 5)",
              lambda a: a @ a.transpose(-1, -2), H)
    invariant("einsum bi,bij,bj->b",
              lambda a, b: torch.einsum("bi,bij,bj->b", b, a, b), H, v)
    invariant("fit.portrait.chan_sum of (B, 31, nchan)", FP.chan_sum,
              rnd(nb, 31, nchan))
    invariant("fit.portrait.chan_sum(-2) of (B, nchan, K)",
              lambda a: FP.chan_sum(a, -2), x)
    invariant("fit.portrait._bmm (B, 5, 5) @ (B, 5, 5)",
              lambda a: FP._bmm(a, a.transpose(-1, -2)), H)
    invariant("fit.portrait._quad", lambda a, b: FP._quad(b, a), H, v)
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


def timing(inp, K, device, nbatch, reps=3):
    """The scattering lane's warm wall on a bucket of ``nbatch`` subints
    (the archive's 8 tiled), device-resident: the median of ``reps``
    calls after one warm-up, each ended by a synchronize."""
    import time

    import numpy as np
    import torch

    tile = {k: np.concatenate([v] * (nbatch // NSUB)) if k in BATCH_KEYS
            else v for k, v in inp.items()}
    a = {k: torch.as_tensor(v).to(device) for k, v in tile.items()}
    walls = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        r = fit(a, slice(None), K, device)
        float(r.phi.sum())
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls[1:]))
    print(json.dumps(dict(step="time", window=K, batch=nbatch,
                          walls_s=walls, median_s=med,
                          fit_toas_per_s=nbatch / med)))


def time_path(work, device, reps=3):
    """The scattering path's warm library call, as chip_smoke.py's
    phase_scatter times it ('library, warm': stream_wideband_TOAs with
    fit_scat over its 4 int16 + 4 2-bit archives of 64 x 512 x 2048,
    loads and copies included): the median of ``reps`` calls after one
    warm-up.  The archives are written into ``work`` once and reused, so
    copies of the script in two checkouts time the same files."""
    import time

    import numpy as np
    import torch

    import chip_smoke as C
    from pulseportraiture_tpu_torch.pipeline import stream as S

    C.WORK = os.path.join(work, "path")
    meta = os.path.join(C.WORK, "scatter_meta.txt")
    gmodel = os.path.join(C.WORK, "model.gmodel")
    if not os.path.exists(meta):
        os.makedirs(C.WORK, exist_ok=True)
        meta, _, _, gmodel = C.scatter_archives(device)
    walls = []
    for i in range(reps + 1):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = S.stream_wideband_TOAs(meta, gmodel, nsub_batch=C.NSUB_BATCH,
                                     fit_scat=True, scat_guess="auto",
                                     print_phase=True, quality_flags=True,
                                     device=device, quiet=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls[1:]))
    print(json.dumps(dict(step="time path", ntoa=len(res.TOA_list),
                          walls_s=walls, median_s=med,
                          toas_per_s=len(res.TOA_list) / med,
                          peak_alloc_gib=torch.cuda.max_memory_allocated()
                          / 2.0**30,
                          h2d_s=res.h2d_duration, fit_s=res.fit_duration)))


def main_archives(work, device):
    """The main path's archive (chip_smoke.py's phase_main_path: 64 x
    512 x 2048 int16, its .gmodel) and the stream path's campaign beside
    it (stream_archives: 8 2-bit archives), written into ``work``/main
    once and reused.  Returns (metafile, .gmodel)."""
    import numpy as np

    import chip_smoke as C
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    C.WORK = os.path.join(work, "main")
    meta = os.path.join(C.WORK, "stream_meta.txt")
    gmodel = os.path.join(C.WORK, "model.gmodel")
    if not os.path.exists(meta):
        os.makedirs(C.WORK, exist_ok=True)
        model = default_test_model(1500.0)
        write_gmodel(model, gmodel, quiet=True)
        make_fake_pulsar(model, C.PAR, outfile=os.path.join(C.WORK,
                                                            "fake.fits"),
                         nsub=C.NSUB, nchan=C.NCHAN, nbin=C.NBIN,
                         nu0=1500.0, bw=800.0, tsub=60.0, phase=C.PHI_INJ,
                         dDM=C.DDM_INJ, start_MJD=MJD(55100, 0.1),
                         noise_stds=1.0, dedispersed=False, quiet=True,
                         rng=np.random.default_rng(C.SEED), device=device)
        meta, _, _, gmodel = C.stream_archives(device)
    return meta, gmodel


def time_main(work, device, reps=3):
    """The main path's fast fit and the stream path's warm library call:
    "time main" is chip_smoke.py's tune_attribution (phase 20 (a): the
    fast fit of the main archive's 64 subints, float32, the derived
    window, by stage: cross_spectrum, prepare, newton, and the whole
    call); "time stream" is phase_stream's 'library, warm' call
    (stream_wideband_TOAs over the 8 2-bit archives and the int16 one),
    the median of ``reps`` calls after one warm-up, with the peak of the
    allocated device memory over the timed calls."""
    import time

    import numpy as np
    import torch

    import chip_smoke as C
    from pulseportraiture_tpu_torch.pipeline import stream as S

    meta, gmodel = main_archives(work, device)
    att, b1 = C.tune_attribution(device)
    print(json.dumps(dict(step="time main", b1_launches=b1,
                          single_ms=att.single_s * 1e3,
                          **att.breakdown_ms(ndigits=4))))
    walls = []
    for i in range(reps + 1):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = S.stream_wideband_TOAs(meta, gmodel, nsub_batch=C.NSUB_BATCH,
                                     device=device, quiet=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls[1:]))
    print(json.dumps(dict(step="time stream", ntoa=len(res.TOA_list),
                          walls_s=walls, median_s=med,
                          toas_per_s=len(res.TOA_list) / med,
                          peak_alloc_gib=torch.cuda.max_memory_allocated()
                          / 2.0**30,
                          h2d_s=res.h2d_duration, fit_s=res.fit_duration)))


def fit_calls(inp, K, device):
    import torch

    import pulseportraiture_tpu_torch.fit.portrait as FP

    orig = FP._cgh_scatter
    logs = {}
    for bs in (1, NSUB):
        rec = []

        def spy(theta, Xr, Xi, M2, freqs, nu_fit, cvec, gvec, log10_tau,
                *args, _rec=rec, **kw):
            out = orig(theta, Xr, Xi, M2, freqs, nu_fit, cvec, gvec,
                       log10_tau, *args, **kw)
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
    ap.add_argument("--time", action="store_true",
                    help="only the timings (cuda)")
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
    if args.time:
        timing(inp, K, args.device, TIME_BATCH)
        time_path(args.work, args.device)
        time_main(args.work, args.device)
        return
    for k in (K, None):
        fits_by_batch(inp, k, args.device)
    steps(inp, K, args.device)
    for k in (K, None):
        fit_calls(inp, k, args.device)
    if cuda:
        timing(inp, K, args.device, TIME_BATCH)


if __name__ == "__main__":
    main()
