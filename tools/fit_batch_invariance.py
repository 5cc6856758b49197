#!/usr/bin/env python3
"""Whether a float32 fit's result depends on the batch it runs in, and
which step makes it so.

    python3 tools/fit_batch_invariance.py [--device cuda|cpu] [--work DIR]
        [--time | --c8 | --complex]

Writes an 8-subint scattered archive like chip_smoke.py's scattering
branch of the scale-out path (512 x 2048 on cuda, 64 x 512 on cpu; its
rows also as dithered 2-bit samples, chip_smoke.c8_inputs) into DIR
(default build/fit_batch_invariance) and prints one JSON line per
check.

--c8 (the lanes without a harmonic window, ROADMAP C8): each row of a
batch of 2, 8 and 64 against the same row alone, bit for bit, with the
largest relative gap, for B1 (S0, want_m2) and B2 at K = nbin/2 + 1,
estimate_tau_batch through B1 and through rfft_mm, the CCF seed, its
irfft_mm, rfft_mm, the re-dispersion rotation, and the invariant matmul
DFT at several row blocks (timed against one GEMM); the TF32 arms of
dft_precision against 'highest'; then chip_smoke.py's C8 lanes (fast,
packed 2-bit, scattering with scat_guess='auto') with and without the
window, the complex engine and narrowband, each subint in batches of 1,
2 and 4 against the batch of 8 (bit for bit, the gap of each differing
field); on cuda the unwindowed lanes and the tau seed timed with the
fused lane off and on, in turns.  --complex: only the complex engine's
and narrowband's steps (cuFFT's rfft and irfft, a complex sum, the
invariant DFT) and, on cuda, both lanes' walls through cuFFT and
through the invariant DFT.  --nb-scat: chip_smoke.py phase 11's
narrowband scattering comparison (GetTOAs against the stream) with the
complex engine's DFTs as shipped (float64 GEMMs), as float32 GEMMs and
as cuFFT.

Without a mode:

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
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NSUB = 8
# the per-step checks' batch sizes, and the timed bucket
STEP_BATCHES = (1, 2, 8, 64)
TIME_BATCH = 256
BATCH_KEYS = ("ports", "noise_stds", "P", "nu_fit", "theta0", "chan_masks",
              "raw", "scl", "offs")


def make_inputs(work, device, nchan, nbin):
    """The scattered archive's fit inputs (float32 numpy, and its rows as
    dithered 2-bit samples) and the template's harmonic window
    (chip_smoke.c8_inputs)."""
    import chip_smoke as C

    return C.c8_inputs(device, NSUB, nchan, nbin, work=work)


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


def invariant_rows(name, fn, *arrays, batches=STEP_BATCHES[1:], group=1):
    """Print, for each batch size b, whether every row of fn over the
    first b rows of ``arrays`` equals that row of fn over the row alone,
    bit for bit (every output of fn), and the largest relative gap.
    group: rows of ``arrays`` per output row group (a subint's channels
    when the arrays are flattened (B * nchan, ...) rows)."""
    import torch

    def outs(lo, hi):
        out = fn(*[a[lo:hi] for a in arrays])
        out = out if isinstance(out, tuple) else (out,)
        return [torch.view_as_real(o) if o.is_complex() else o for o in out]

    top = max(batches)
    alone = [outs(i * group, (i + 1) * group) for i in range(top)]
    bitwise, rel = {}, {}
    for b in batches:
        got = outs(0, b * group)
        ok, worst = True, 0.0
        for i in range(b):
            for x, y in zip(alone[i], got):
                y = y[i * group:(i + 1) * group] if group > 1 else y[i:i + 1]
                x = x if group > 1 else x[:1]
                ok = ok and torch.equal(x, y)
                worst = max(worst, float((x.double() - y.double()).abs().max())
                            / max(float(y.double().abs().max()), 1e-300))
        bitwise[b], rel[b] = ok, worst
    print(json.dumps(dict(step=name, bitwise=bitwise, rel=rel)), flush=True)


def tiled(inp, nb, seed=7):
    """The archive's subints tiled to nb rows, each tile with its own
    extra white noise (so no two rows are equal), as float32 numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for k, v in inp.items():
        if k in BATCH_KEYS or k in ("raw", "scl", "offs"):
            out[k] = np.concatenate([v] * (nb // NSUB))
        else:
            out[k] = v
    out["ports"] = (out["ports"] + rng.standard_normal(
        out["ports"].shape) * 0.1).astype(np.float32)
    return out


def c8_steps(inp, device, nbin):
    """The bucket-dependence of the unwindowed lanes' steps, each row
    against itself alone at batches of 2, 8 and 64: B1 (S0, want_m2) and
    B2 at K = nbin/2 + 1, the tau seed by both routes, the CCF seed's
    inverse DFT, the re-dispersion rotation, the invariant matmul DFT at
    several row blocks (with its time against one GEMM)."""
    import torch

    import chip_smoke as C
    import pulseportraiture_tpu_torch.fit.portrait as FP
    from pulseportraiture_tpu_torch.ops import fourier as FO
    from pulseportraiture_tpu_torch.ops import fused as F
    K = nbin // 2 + 1
    nb = STEP_BATCHES[-1]
    t = tiled(inp, nb)
    dev = device
    cuda = torch.device(dev).type == "cuda"
    port = torch.as_tensor(t["ports"]).to(dev)
    model = torch.as_tensor(t["models"]).to(dev)
    noise = torch.as_tensor(t["noise_stds"]).to(dev)
    masks = torch.as_tensor(t["chan_masks"]).to(dev)
    w = FP.make_weights(noise, nbin, masks)
    for m2 in (False, True):
        invariant_rows(f"B1 want_m2={m2} K={K}",
                       lambda p, ww: F.fused_cross_spectrum(
                           p.contiguous(), model, ww.contiguous(), K,
                           want_m2=m2), port, w)
    raw = torch.as_tensor(t["raw"]).to(dev)
    scl = torch.as_tensor(t["scl"]).to(dev)
    offs = torch.as_tensor(t["offs"]).to(dev)
    invariant_rows(f"B2 2-bit K={K}",
                   lambda r, a, b, ww: F.fused_decode_cross_spectrum(
                       r.contiguous(), a, b, model, ww.contiguous(), K,
                       code="p2", nbin=nbin), raw, scl, offs, w)
    del w
    for fused in (True, False):
        invariant_rows(f"estimate_tau_batch fit_fused={fused}",
                       lambda p, n, m: FP.estimate_tau_batch(
                           p, model, n, m, fit_fused=fused),
                       port, noise, masks)
    g = torch.Generator().manual_seed(11)
    Xr = torch.randn(nb, port.shape[1], K, generator=g).to(dev)
    Xi = torch.randn(nb, port.shape[1], K, generator=g).to(dev)
    cvec = (torch.randn(nb, port.shape[1], generator=g) * 1e-3).to(dev)
    DM0 = torch.randn(nb, generator=g).to(dev)
    invariant_rows("CCF seed _initial_phase_guess_real",
                   lambda a, b, c, d: FP._initial_phase_guess_real(
                       a, b, c, d, nbin=nbin), Xr, Xi, cvec, DM0)
    xr, xi = Xr[:, 0].contiguous(), Xi[:, 0].contiguous()
    invariant_rows("irfft_mm (B, K) to 2 nbin lags",
                   lambda a, b: FO.irfft_mm(a, b, n=2 * nbin), xr, xi)
    rows = port.reshape(-1, nbin)
    nchan = port.shape[1]
    invariant_rows("rfft_mm (B nchan, nbin)", lambda a: FO.rfft_mm(a),
                   rows, group=nchan, batches=(2, 8))
    turns = (torch.randn(nb, nchan, generator=g) * 0.1).to(dev)

    def redisp(x, tt):
        kk = torch.arange(K, dtype=x.dtype, device=x.device)
        ang = -2.0 * 3.141592653589793 * tt[..., None] * kk
        c, s = torch.cos(ang), torch.sin(ang)
        a, b = FO.rfft_mm_invariant(x, block=FO.CHANNEL_ROW_BLOCK)
        return FO.irfft_mm_invariant(a * c - b * s, a * s + b * c, nbin,
                                     block=FO.CHANNEL_ROW_BLOCK)
    invariant_rows(f"re-dispersion rotation (block {FO.CHANNEL_ROW_BLOCK})",
                   redisp, port, turns, batches=(2, 8))
    for block in (16, 64, 256, 1024):
        invariant_rows(f"irfft_mm_invariant block {block} (B, K) -> 2 nbin",
                       lambda a, b: FO.irfft_mm_invariant(
                           a, b, n=2 * nbin, block=block), xr, xi)
        if cuda:
            ms = C.median_ms(lambda: FO.irfft_mm_invariant(
                xr, xi, n=2 * nbin, block=block), n=10)
            print(json.dumps(dict(step="time irfft_mm_invariant",
                                  block=block, rows=nb, ms=ms)), flush=True)
    if cuda:
        ms = C.median_ms(lambda: FO.irfft_mm(xr, xi, n=2 * nbin), n=10)
        print(json.dumps(dict(step="time irfft_mm", rows=nb, ms=ms)),
              flush=True)
    for block in (256, 512, 1024, 4096):
        invariant_rows(f"rfft_mm_invariant block {block} (B nchan, nbin)",
                       lambda a: FO.rfft_mm_invariant(a, block=block),
                       rows, group=nchan, batches=(2, 8))
        for nsub in (1, 8, 64) if cuda else ():
            ms = C.median_ms(lambda: FO.rfft_mm_invariant(
                rows[:nsub * nchan], block=block), n=5)
            print(json.dumps(dict(step="time rfft_mm_invariant",
                                  block=block, rows=nsub * nchan, ms=ms)),
                  flush=True)
    for nsub in (1, 8, 64) if cuda else ():
        ms = C.median_ms(lambda: FO.rfft_mm(rows[:nsub * nchan]), n=5)
        print(json.dumps(dict(step="time rfft_mm", rows=nsub * nchan,
                              ms=ms)), flush=True)
    x = rows[:nchan * 8]
    ref = FO.rfft_mm(x, precision="highest")
    for prec in ("high", "default"):
        got = FO.rfft_mm(x, precision=prec)
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, ref))
        print(json.dumps(dict(step=f"rfft_mm precision={prec} vs highest",
                              rel=rel, tf32_after=torch.backends.cuda
                              .matmul.allow_tf32)), flush=True)


def complex_steps(inp, device, nbin):
    """Where the complex engine and narrowband depend on the batch:
    cuFFT's rfft and irfft and a complex last-axis torch.sum, row by row
    at batches of 2 and 8, and the invariant DFT the lanes take on CUDA
    (ops.fourier.rfft_c_rows / irfft_c_rows); then, on cuda, both lanes'
    walls with their DFTs through cuFFT (torch.fft patched in) and
    through the invariant DFT, in turns (on the CPU, whose lanes are
    torch.fft already, their bits through torch.fft)."""
    import torch

    import pulseportraiture_tpu_torch.fit.phase_shift as PS
    import pulseportraiture_tpu_torch.fit.portrait as FP
    from pulseportraiture_tpu_torch.ops import fourier as FO

    t = tiled(inp, 8)
    port = torch.as_tensor(t["ports"]).to(device)
    invariant_rows("rfft_c (B, nchan, nbin)", FO.rfft_c, port,
                   batches=(2, 8))
    X = FO.rfft_c(port)
    invariant_rows("irfft_c (B, nchan, K) to 8 nbin lags",
                   lambda a: FO.irfft_c(a, n=8 * nbin), X, batches=(2, 8))
    invariant_rows("irfft_c (B, K) to 2 nbin lags",
                   lambda a: FO.irfft_c(a, n=2 * nbin), X[:, 0].contiguous(),
                   batches=(2, 8))
    invariant_rows("torch.sum(-1) complex (B, nchan, K)",
                   lambda a: torch.sum(a, dim=-1), X, batches=(2, 8))
    invariant_rows("rfft_c_invariant (B, nchan, nbin)", FO.rfft_c_invariant,
                   port, batches=(2, 8))
    del X
    names = ("rfft_c_rows", "irfft_c_rows")
    saved = [(m, n, getattr(m, n)) for m in (FP, PS) for n in names]
    cufft = {"rfft_c_rows": lambda x, precision=None, block=None:
             FO.rfft_c(x, precision),
             "irfft_c_rows": lambda X, n=None, precision=None, block=None:
             FO.irfft_c(X, n, precision)}
    cuda = torch.device(device).type == "cuda"
    for arm in ("cufft", "invariant", "cufft", "invariant"):
        if arm == "cufft":
            for m, n, _ in saved:
                setattr(m, n, cufft[n])
        try:
            if cuda:
                lane_times(inp, device, arm)
            elif arm == "cufft":
                lane_fits(inp, None, device, only=("complex", "narrowband"),
                          label=" (torch.fft)")
        finally:
            for m, n, f in saved:
                setattr(m, n, f)


def nb_scat_dfts(work, device):
    """chip_smoke.py phase 11's narrowband scattering comparison (pptoas
    --narrowband --fit_scat --scat_guess auto through GetTOAs and
    through the stream on an 8-subint scattered archive: the largest
    |dTOA| over its error and the largest |d tau / tau| where a channel
    measures tau) with the complex engine's DFTs as shipped (the
    invariant DFT in float64, rounded once), as the same GEMMs in
    float32, and as cuFFT (torch.fft), each patched in for both runs."""
    import numpy as np
    import torch

    import chip_smoke as C
    import pulseportraiture_tpu_torch.fit.phase_shift as PS
    import pulseportraiture_tpu_torch.fit.portrait as FP
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.ops import fourier as FO
    from pulseportraiture_tpu_torch.synth import default_test_model

    C.WORK = os.path.join(work, "nb_scat")
    os.makedirs(C.WORK, exist_ok=True)
    gmodel = os.path.join(C.WORK, "model.gmodel")
    write_gmodel(default_test_model(1500.0), gmodel, quiet=True)
    sarch = C.nb_scatter_archive(device, C.NSUB_NB_SCAT)

    def f32_r(x, precision=None, block=None):
        return torch.complex(*FO.rfft_mm_invariant(
            x, fold=False, block=FO.CHANNEL_ROW_BLOCK))

    def f32_i(X, n=None, precision=None, block=None):
        return FO.irfft_mm_invariant(X.real.contiguous(),
                                     X.imag.contiguous(), n, block=block)

    variants = {
        "invariant float64": None, "invariant float32": (f32_r, f32_i),
        "cufft": (lambda x, precision=None, block=None: FO.rfft_c(x),
                  lambda X, n=None, precision=None, block=None:
                  FO.irfft_c(X, n))}
    names = ("rfft_c_rows", "irfft_c_rows")
    saved = [(m, n, getattr(m, n)) for m in (FP, PS) for n in names]
    for name, fns in variants.items():
        if fns is not None:
            for m, n, _ in saved:
                setattr(m, n, fns[names.index(n)])
        try:
            tims = {}
            for label, extra in (("gettoas", []), ("stream", ["--stream"])):
                tims[label] = os.path.join(C.WORK, f"{label}.tim")
                if os.path.exists(tims[label]):
                    os.remove(tims[label])
                C.run_cli(extra + ["--narrowband", "--fit_scat",
                                   "--scat_guess", "auto", "-d", sarch, "-m",
                                   gmodel, "-o", tims[label], "--quiet",
                                   "--print_phase", "--device", device],
                          label)
        finally:
            for m, n, f in saved:
                setattr(m, n, f)
        ref, got = C.read_tim(tims["gettoas"]), C.read_tim(tims["stream"])
        offs = max(C.tim_sigma_offset(ref[k], got[k]) for k in got)
        rows = np.asarray([[float(got[k]["flags"]["-scat_time"]),
                            float(ref[k]["flags"]["-scat_time"]),
                            float(ref[k]["flags"]["-log10_scat_time_err"])]
                           for k in got])
        dtau = np.abs(rows[:, 0] / rows[:, 1] - 1.0)
        measured = rows[:, 2] < C.NB_TAU_MEASURED
        print(json.dumps(dict(step="narrowband scattering", dft=name,
                              max_dtoa_sigma=offs,
                              max_dtau_measured=float(np.max(
                                  dtau[measured], initial=0.0)),
                              measured=int(measured.sum()),
                              toas=len(got))), flush=True)


def lane_times(inp, device, arm, nb=64, reps=3):
    """The complex engine's and narrowband's warm walls on nb tiled
    subints (the median of reps calls after one warm-up)."""
    import time

    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.fit.phase_shift import \
        fit_phase_shift_batch
    from pulseportraiture_tpu_torch.fit.portrait import (FitFlags,
                                                         fit_portrait_batch)

    t = tiled(inp, nb)
    a = {k: torch.as_tensor(v).to(device) for k, v in t.items()
         if k not in ("raw", "scl", "offs")}
    th = a["theta0"].clone()
    th[:, 3:] = 0.0
    calls = {
        "complex": lambda: fit_portrait_batch(
            a["ports"], a["models"], a["noise_stds"], a["freqs"], a["P"],
            a["nu_fit"], theta0=th, fit_flags=FitFlags(True, True),
            chan_masks=a["chan_masks"], device=device),
        "narrowband": lambda: fit_phase_shift_batch(
            a["ports"], a["models"], a["noise_stds"], device=device)}
    for name, fn in calls.items():
        ws = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ws.append(time.perf_counter() - t0)
        print(json.dumps(dict(step="time lane", lane=name, arm=arm,
                              batch=nb, median_s=float(np.median(ws[1:])))),
              flush=True)


def lane_fits(inp, K, device, only=None, label=""):
    """Each lane of chip_smoke's C8 gate plus the complex engine and
    narrowband: the NSUB subints in batches of 1, 2 and 4 against the
    batch of NSUB, bit for bit in every field, with the largest
    |value - batch| over its error for phi and DM."""
    import torch

    import chip_smoke as C
    from pulseportraiture_tpu_torch.fit.phase_shift import \
        fit_phase_shift_batch
    from pulseportraiture_tpu_torch.fit.portrait import (FitFlags,
                                                         fit_portrait_batch)

    def complex_fit(sl):
        a = {k: torch.as_tensor(v[sl] if k in BATCH_KEYS else v).to(device)
             for k, v in inp.items() if k not in ("raw", "scl", "offs")}
        th = a["theta0"].clone()
        th[:, 3:] = 0.0
        return fit_portrait_batch(
            a["ports"], a["models"], a["noise_stds"], a["freqs"], a["P"],
            a["nu_fit"], theta0=th, fit_flags=FitFlags(True, True),
            chan_masks=a["chan_masks"], device=device)

    def nb_fit(sl):
        return fit_phase_shift_batch(
            torch.as_tensor(inp["ports"][sl]).to(device),
            torch.as_tensor(inp["models"]).to(device),
            torch.as_tensor(inp["noise_stds"][sl]).to(device),
            device=device)

    lanes = [(lane, (lambda sl, lane=lane: C.c8_fit(lane, inp, sl, K,
                                                    device)))
             for lane in C.C8_LANES]
    if K is None:
        lanes += [("complex", complex_fit), ("narrowband", nb_fit)]
    for name, fn in lanes:
        if only is not None and name not in only:
            continue
        ref = fn(slice(0, NSUB))
        keys = list(ref._fields if hasattr(ref, "_fields") else ref.keys())
        get = (lambda r, k: getattr(r, k)) if hasattr(ref, "_fields") \
            else (lambda r, k: r[k])
        keys = [k for k in keys if isinstance(get(ref, k), torch.Tensor)
                and get(ref, k).dim() > 0]
        for bs in (1, 2, 4):
            rs = [fn(slice(lo, lo + bs)) for lo in range(0, NSUB, bs)]
            diff = sorted({k for k in keys if not torch.equal(
                torch.cat([get(r, k) for r in rs]), get(ref, k))})
            worst = {}
            gaps = {k: float((torch.cat([get(r, k) for r in rs]).double()
                              - get(ref, k).double()).abs().max()
                             / max(float(get(ref, k).double().abs().max()),
                                   1e-300)) for k in diff}
            for k, e in (("phi", "phi_err"), ("DM", "DM_err"),
                         ("phase", "phase_err")):
                if k in keys:
                    dv = torch.cat([get(r, k) for r in rs]) - get(ref, k)
                    if k in ("phi", "phase"):
                        dv = (dv + 0.5) % 1.0 - 0.5
                    worst[k] = float((dv.abs() / get(ref, e)).max())
            print(json.dumps(dict(step="lane", lane=name + label, window=K,
                                  batch=bs, bitwise=not diff, rel=gaps,
                                  max_over_err=worst)), flush=True)


def c8_timing(inp, K, device, reps=3):
    """The unwindowed lanes before and after (the same call with the
    fused lane off, the matmul DFT, and on, every harmonic through the
    kernels), and the tau seed by both routes, warm walls on tiled
    buckets: the median of ``reps`` calls after one warm-up."""
    import time

    import numpy as np
    import torch

    import chip_smoke as C
    from pulseportraiture_tpu_torch import config
    from pulseportraiture_tpu_torch.fit.portrait import estimate_tau_batch

    def wall(fn):
        ws = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ws.append(time.perf_counter() - t0)
        return float(np.median(ws[1:]))

    saved = config.fit_fused
    try:
        for lane, nb in (("fast", 64), ("scat_auto", 256)):
            t = tiled(inp, nb)
            for fused in (False, True, False, True):
                config.fit_fused = fused
                s = wall(lambda: C.c8_fit(lane, t, slice(None), None,
                                          device))
                print(json.dumps(dict(step="time unwindowed lane",
                                      lane=lane, batch=nb,
                                      fit_fused=fused, median_s=s)),
                      flush=True)
        config.fit_fused = saved
        t = tiled(inp, 256)
        a = {k: torch.as_tensor(t[k]).to(device)
             for k in ("ports", "models", "noise_stds", "chan_masks")}
        for fused in (False, True, False, True):
            ms = C.median_ms(lambda: estimate_tau_batch(
                a["ports"], a["models"], a["noise_stds"], a["chan_masks"],
                fit_fused=fused), n=5)
            print(json.dumps(dict(step="time estimate_tau_batch", batch=256,
                                  fit_fused=fused, ms=ms)), flush=True)
    finally:
        config.fit_fused = saved


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
    ap.add_argument("--complex", action="store_true",
                    help="only the complex engine's and narrowband's "
                         "steps, and both lanes on the invariant DFTs")
    ap.add_argument("--nb-scat", action="store_true",
                    help="only chip_smoke.py phase 11's narrowband "
                         "scattering comparison under three DFTs")
    ap.add_argument("--c8", action="store_true",
                    help="only the unwindowed lanes' checks and timings "
                         "(the kernels at K = nbin/2 + 1, the seeds, the "
                         "re-dispersion, the invariant matmul DFT, every "
                         "lane alone against its batch)")
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
    if args.nb_scat:
        nb_scat_dfts(args.work, args.device)
        return
    nchan, nbin = (512, 2048) if cuda else (64, 512)
    inp, K = make_inputs(args.work, args.device, nchan, nbin)
    print(f"{NSUB} subints x {nchan} x {nbin} float32, window K={K}")
    if args.complex:
        complex_steps(inp, args.device, nbin)
        return
    if args.c8:
        complex_steps(inp, args.device, nbin)
        c8_steps(inp, args.device, nbin)
        for k in (K, None):
            lane_fits(inp, k, args.device)
        if cuda:
            c8_timing(inp, K, args.device)
        return
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
