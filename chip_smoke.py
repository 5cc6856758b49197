#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives pulseportraiture_tpu_torch end to end on the card and fails
(non-zero exit, no result line) when any phase fails:

1. card: the GPU's name and power limit (nvidia-smi);
2. build: every kernel of the main path compiled from this checkout's
   sources (nvcc, sm_90a) into build/torch_kernels/;
3. kernels vs plain versions: each kernel against its plain PyTorch
   version on the card over a directed set of shapes, with the
   tolerance stated per case, plus the kernel's, the plain version's and
   a torch.matmul equivalent's median times at the main path's shapes,
   where each output is held to the same tolerance again;
4. main path: a 64-subint 512-channel x 2048-bin archive with injected
   (phi, dDM) from a seeded generator and a .gmodel template, measured
   by ``python -m pulseportraiture_tpu_torch.cli.pptoas`` (run in this
   process, so the kernels' launch counters can be read), then by the
   GetTOAs library call for the fit time; every TOA must recover the
   injected phase to |dphi| < 1e-4 rot, every return code must be in
   {0, 1, 2}, and every kernel of the path must have been launched.

The line before the last is one JSON object listing each kernel with
its launches on the main path, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when no CUDA device is available or the package is missing.
"""

import json
import math
import os
import runpy
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores and HBM3 bandwidth, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
PEAK_HBM_BYTES = 3.35e12

PAR = {"PSR": "J1744-1134", "RAJ": "17:44:29.4", "DECJ": "-11:34:54.6",
       "P0": 0.004074, "PEPOCH": 55000.0, "DM": 3.139}
NSUB, NCHAN, NBIN = 64, 512, 2048
PHI_INJ, DDM_INJ = 0.0123, 2.0e-4
SEED = 20261016


def log(msg):
    print(msg, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def median_ms(fn, n=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def cross_spectrum_case(name, nb, nchan, nbin, K, dtype, fold=False,
                        want_m2=False, per_element=False, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if nb is None else (nb,)
    port = torch.randn(lead + (nchan, nbin), generator=g, device="cuda",
                       dtype=dtype)
    mshape = lead + (nchan, nbin) if per_element else (nchan, nbin)
    model = torch.randn(mshape, generator=g, device="cuda", dtype=dtype)
    w = torch.rand(lead + (nchan, K), generator=g, device="cuda",
                   dtype=dtype) + 0.5
    return dict(name=name, port=port, model=model, w=w, K=K, fold=fold,
                want_m2=want_m2)


def library_equivalent(port, model, w, K, W):
    """One torch.matmul-based computation of the same function (the
    yardstick; the port never calls it)."""
    import torch

    D = torch.matmul(port, W)
    Mm = torch.matmul(model, W)
    dr, di = D[..., :K], D[..., K:]
    mr, mi = Mm[..., :K], Mm[..., K:]
    Xr = (dr * mr + di * mi) * w
    Xi = (di * mr - dr * mi) * w
    return Xr, Xi, torch.sum((mr * mr + mi * mi) * w, dim=-1)


def cross_spectrum_bound_ms(nb, nchan, nbin, K, itemsize, want_m2,
                            shared=True):
    """Least time for the function on this card: the larger of its
    bytes (port, model and per-element w read once, outputs written
    once) over HBM bandwidth and its fewest operations over the FP32
    (or FP64) peak.  The fewest operations giving the same outputs are a
    real FFT of every data and template row (2.5 nbin log2 nbin FLOPs
    each), not the kernel's matmul DFT, plus the epilogue."""
    rows = nb * nchan
    mrows = nchan if shared else rows
    flops = (2.5 * (rows + mrows) * nbin * math.log2(nbin)
             + 11.0 * rows * K)
    out = 2 * rows * K + (rows * K if want_m2 else rows)
    nbytes = itemsize * ((rows + mrows) * nbin + rows * K + out)
    peak = PEAK_FP32_FLOPS if itemsize == 4 else PEAK_FP64_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def dft_operations_ms(nb, nchan, nbin, K, itemsize, fold, shared=True):
    """Secondary figure: the kernel's own matmul-DFT FLOPs (direct arm:
    4 x rows x nbin x K; fold arm: over nbin/2 - 1 folded samples) over
    the FP32 (or FP64) peak, for the data rows and the template once."""
    L = nbin // 2 - 1 if fold else nbin
    rows = nb * nchan
    mrows = nchan if shared else rows
    peak = PEAK_FP32_FLOPS if itemsize == 4 else PEAK_FP64_FLOPS
    return 4.0 * (rows + mrows) * L * K / peak * 1e3


def phase_kernels():
    """Every kernel vs its plain version on the card over the directed
    set; raises on the first disagreement."""
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F

    f32, f64 = torch.float32, torch.float64
    cases = [
        cross_spectrum_case("production 64x512x2048 K=256", 64, 512, 2048,
                            256, f32),
        cross_spectrum_case("single subint 512x2048 K=256", None, 512,
                            2048, 256, f32, seed=1),
        cross_spectrum_case("ragged nchan=500", 2, 500, 2048, 256, f32,
                            seed=2),
        cross_spectrum_case("fold", 4, 512, 2048, 256, f32, fold=True,
                            seed=3),
        cross_spectrum_case("want_m2", 4, 512, 2048, 256, f32,
                            want_m2=True, seed=4),
        cross_spectrum_case("per-element models", 4, 512, 2048, 256, f32,
                            per_element=True, seed=5),
        cross_spectrum_case("K not a tile multiple", 3, 37, 256, 100, f32,
                            fold=True, want_m2=True, seed=6),
        cross_spectrum_case("f64 small", 3, 13, 128, 40, f64, seed=7),
        cross_spectrum_case("f64 small fold want_m2 per-element", 2, 13,
                            128, 40, f64, fold=True, want_m2=True,
                            per_element=True, seed=8),
    ]
    for c in cases:
        args = (c["port"], c["model"], c["w"], c["K"])
        kw = dict(fold=c["fold"], want_m2=c["want_m2"])
        got = F.fused_cross_spectrum_cuda(*args, **kw)
        ref = F.fused_cross_spectrum_ref(*args, **kw)
        torch.cuda.synchronize()
        f64case = c["port"].dtype == f64
        rtol = 1e-12 if f64case else 1e-5
        for g, r, part in zip(got, ref, ("Xr", "Xi", "o2")):
            if g.shape != r.shape or not torch.isfinite(g).all():
                raise AssertionError(f"{c['name']} {part}: shape "
                                     f"{tuple(g.shape)} vs "
                                     f"{tuple(r.shape)} or non-finite")
            err = float((g - r).abs().max())
            scale = float(r.abs().max())
            if not err <= rtol * scale:
                raise AssertionError(
                    f"{c['name']} {part}: max abs err {err:.3e} > "
                    f"{rtol:g} x max|ref| {scale:.3e}")
        log(f"kernel check ok: fused_cross_spectrum {c['name']} "
            f"(tol {'1e-12' if f64case else '1e-5'} x max|ref|)")



def phase_timing(K_main):
    """Kernel, plain-version and torch.matmul-equivalent median times at
    the main path's shape: 64 subints against one shared template with
    per-element weights, at the main path's harmonic window K_main and
    at the production K=256 of the directed set.  Each output is first
    held to the f32 tolerance (1e-5 x its max|ref|); raises otherwise."""
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.ops.fourier import device_weights

    f32 = torch.float32
    records = {}
    for K in sorted({256, K_main}):
        c = cross_spectrum_case(f"time K={K}", NSUB, NCHAN, NBIN, K, f32,
                                seed=10 + K)
        args = (c["port"], c["model"], c["w"], K)
        Wc, Ws = device_weights("rfft", c["port"].device, NBIN, "float32",
                                K)
        W = torch.cat([Wc, Ws], dim=1).contiguous()
        got = F.fused_cross_spectrum_cuda(*args)
        ref = F.fused_cross_spectrum_ref(*args)
        errs = []
        for g, r, part in zip(got, ref, ("Xr", "Xi", "S0")):
            e = float((g - r).abs().max())
            s = float(r.abs().max())
            if not (torch.isfinite(g).all() and e <= 1e-5 * s):
                raise AssertionError(
                    f"time K={K} {part}: max abs err {e:.3e} > 1e-5 x "
                    f"max|ref| {s:.3e} (or non-finite)")
            errs.append((e, s, part))
        err, scale, _ = max(errs)
        ms = median_ms(lambda: F.fused_cross_spectrum_cuda(*args))
        plain_ms = median_ms(lambda: F.fused_cross_spectrum_ref(*args))
        lib_ms = median_ms(lambda: library_equivalent(
            c["port"], c["model"], c["w"], K, W))
        ms2 = median_ms(lambda: F.fused_cross_spectrum_cuda(*args))
        fold_ms = median_ms(lambda: F.fused_cross_spectrum_cuda(
            *args, fold=True))
        bound, by = cross_spectrum_bound_ms(NSUB, NCHAN, NBIN, K, 4, False)
        direct_ops = dft_operations_ms(NSUB, NCHAN, NBIN, K, 4, False)
        fold_ops = dft_operations_ms(NSUB, NCHAN, NBIN, K, 4, True)
        log(f"timing fused_cross_spectrum {NSUB}x{NCHAN}x{NBIN} K={K} "
            f"f32: kernel {ms:.4f} ms (again {ms2:.4f}), plain "
            f"{plain_ms:.4f} ms, torch.matmul equivalent {lib_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({by}; rfft operations or bytes); "
            f"fold arm {fold_ms:.4f} ms; matmul-DFT operations alone "
            f"{direct_ops:.4f} ms direct, {fold_ops:.4f} ms fold; "
            + ", ".join(f"{p} max abs err {e:.3e} of max|ref| {s:.3e}"
                        for e, s, p in errs)
            + " (tol 1e-5 x max|ref| each)")
        records[K] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound, bound_by=by, max_abs_err=err,
                          max_abs_ref=scale)
        del c, args, got, ref
    return records


def expected_phase(nu):
    """Injected phase of the fake archive at frequency nu [MHz]: the
    achromatic injection plus the dispersive delay of DM + dDM at nu,
    minus the folding alignment at nu0 (the data are dispersed)."""
    from pulseportraiture_tpu_torch.config import Dconst

    P = PAR["P0"]
    e = (PHI_INJ + Dconst * (PAR["DM"] + DDM_INJ) * nu ** -2.0 / P
         - Dconst * PAR["DM"] * 1500.0 ** -2.0 / P)
    return (e + 0.5) % 1.0 - 0.5


def phase_main_path(device="cuda", nsub=NSUB, nchan=NCHAN, nbin=NBIN):
    import numpy as np
    import torch
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.pipeline import GetTOAs
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    os.makedirs(WORK, exist_ok=True)
    gmodel = os.path.join(WORK, "model.gmodel")
    arch = os.path.join(WORK, "fake.fits")
    tim = os.path.join(WORK, "toas.tim")
    model = default_test_model(1500.0)
    write_gmodel(model, gmodel, quiet=True)
    t0 = time.perf_counter()
    make_fake_pulsar(model, PAR, outfile=arch, nsub=nsub, nchan=nchan,
                     nbin=nbin, nu0=1500.0, bw=800.0, tsub=60.0,
                     phase=PHI_INJ, dDM=DDM_INJ, start_MJD=MJD(55100, 0.1),
                     noise_stds=1.0, dedispersed=False, quiet=True,
                     rng=np.random.default_rng(SEED), device=device)
    log(f"archive {nsub}x{nchan}x{nbin} written in "
        f"{time.perf_counter() - t0:.2f} s")
    if os.path.exists(tim):
        os.remove(tim)

    # the CLI, exactly as `python -m ... cli.pptoas`, in this process
    F.reset_kernel_launches()
    argv = sys.argv
    sys.argv = ["pptoas", "-d", arch, "-m", gmodel, "-o", tim, "--quiet",
                "--print_phase", "--quality_flags", "--device", device]
    t0 = time.perf_counter()
    try:
        runpy.run_module("pulseportraiture_tpu_torch.cli.pptoas",
                         run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise RuntimeError(f"pptoas exited with {e.code!r}")
    finally:
        sys.argv = argv
    sync(device)
    cli_s = time.perf_counter() - t0
    launches = F.kernel_launches()
    log(f"main path (pptoas CLI): {cli_s:.3f} s wall incl. load and "
        f"first use, kernel launches {launches}")
    if launches["fused_cross_spectrum"] < 1:
        raise AssertionError("the main path never launched the "
                             "fused_cross_spectrum kernel")

    with open(tim) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    if len(lines) != nsub:
        raise AssertionError(f"{len(lines)} TOAs for {nsub} subints")
    worst = 0.0
    subints = set()
    for tok in lines:
        flags = dict(zip(tok[5::2], tok[6::2]))
        nu = float(tok[1])
        phi = float(flags["-phs"])
        d = abs((phi - expected_phase(nu) + 0.5) % 1.0 - 0.5)
        worst = max(worst, d)
        subints.add(int(flags["-subint"]))
        if not all(math.isfinite(float(x)) for x in (tok[3], phi,
                                                     flags["-pp_dm"])):
            raise AssertionError(f"non-finite TOA line {tok}")
    if subints != set(range(nsub)):
        raise AssertionError("missing subints in the .tim")
    if not worst < 1e-4:
        raise AssertionError(f"phase recovery |dphi| = {worst:.3e} rot "
                             f">= 1e-4")
    log(f"phase recovery: max |dphi| = {worst:.3e} rot over {nsub} TOAs "
        f"(limit 1e-4)")

    # the library call, warm: fit time, return codes, counters again
    F.reset_kernel_launches()
    gt = GetTOAs(arch, gmodel, quiet=True, device=device)
    t0 = time.perf_counter()
    gt.get_TOAs(quiet=True)
    sync(device)
    lib_s = time.perf_counter() - t0
    lib_launches = F.kernel_launches()["fused_cross_spectrum"]
    if lib_launches < 1:
        raise AssertionError("GetTOAs never launched the kernel")
    rcs = np.asarray(gt.rcs[0])[gt.ok_isubs[0]]
    if not np.all(np.isin(rcs, (0, 1, 2))):
        raise AssertionError(f"return codes {sorted(set(rcs.tolist()))}")
    fit_s = gt.fit_durations[0]
    nfev = np.asarray(gt.nfevals[0])[gt.ok_isubs[0]]
    log(f"main path (GetTOAs, warm): fit {fit_s:.4f} s for {nsub} TOAs = "
        f"{nsub / fit_s:.1f} TOAs/s (fit), {nsub / lib_s:.1f} TOAs/s "
        f"incl. load, {lib_s:.3f} s wall; nfeval max {int(nfev.max())} "
        f"median {float(np.median(nfev))}; return codes "
        f"{sorted(set(rcs.tolist()))}; kernel launches {lib_launches}")

    # cost of the Newton loop's one host sync per trip
    x = torch.zeros(8, device=device, dtype=torch.bool)
    sync(device)
    ts = []
    for _ in range(50):
        t0 = time.perf_counter()
        bool(x.any())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    log(f"newton loop: {int(nfev.max())} trips, host sync round trip "
        f"{ts[len(ts) // 2] * 1e6:.1f} us each (median of 50, idle card)")
    return launches["fused_cross_spectrum"]


def phase_fit_profile(arch, gmodel, device="cuda"):
    """Where the fit's time goes on device-resident inputs: the
    fit_portrait_batch_fast call GetTOAs makes, minus the host staging,
    timed by host clock around a synchronized call, and one call under
    torch.profiler for the device's busy time by kernel."""
    import numpy as np
    import torch
    from pulseportraiture_tpu_torch.fit import portrait as FP
    from pulseportraiture_tpu_torch.fit.portrait import (
        FitFlags, fit_portrait_batch_fast)
    from pulseportraiture_tpu_torch.pipeline.models import TemplateModel
    from pulseportraiture_tpu_torch.pipeline.toas import (
        load_for_toas, snr_weighted_nu_fit)

    d = load_for_toas(arch)
    ok = np.asarray(d.ok_isubs, int)
    freqs0 = np.asarray(d.freqs[0], float)
    masks = np.asarray(d.weights[ok] > 0.0, float)
    tmpl = TemplateModel(gmodel, device=device).portrait(
        freqs0, d.nbin, P=float(np.mean(d.Ps[ok])))
    theta0 = np.zeros((len(ok), 5))
    theta0[:, 1] = float(d.DM)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    args = (dev(d.subints[ok, 0]), np.asarray(tmpl, np.float32),
            dev(d.noise_stds[ok, 0]), dev(freqs0), dev(d.Ps[ok]),
            dev(snr_weighted_nu_fit(np.asarray(d.SNRs[ok, 0]) * masks,
                                    freqs0)))
    kw = dict(theta0=dev(theta0), fit_flags=FitFlags(True, True),
              chan_masks=dev(masks), device=device)
    K = FP.resolve_harmonic_window(None, args[1], d.nbin)
    log(f"main-path harmonic window K={K}")
    fit_portrait_batch_fast(*args, **kw)
    sync(device)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        r = fit_portrait_batch_fast(*args, **kw)
        sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    fit_ms = times[2] * 1e3
    log(f"fit on device-resident inputs ({len(ok)} subints): "
        f"{fit_ms:.2f} ms median of 5 = {len(ok) / times[2]:.0f} TOAs/s; "
        f"nfeval max {int(r.nfeval.max())}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit_portrait_batch_fast(*args, **kw)
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dt_us = getattr(e, "self_device_time_total", None)
        if dt_us is None:
            dt_us = getattr(e, "self_cuda_time_total", 0.0)
        if dt_us > 0:
            rows.append((dt_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"profile: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"(idle share {1.0 - busy_ms / wall_ms:.3f}, profiler on)")
    for us, key, n in rows[:8]:
        log(f"  {us / 1e3:9.3f} ms  x{n:<4d} {key[:90]}")
    return K


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from pulseportraiture_tpu_torch.ops import fused as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    F.build_kernels(verbose=True)
    log(f"build: fused_cross_spectrum.cu compiled and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    phase_kernels()
    launches = phase_main_path()
    K = phase_fit_profile(os.path.join(WORK, "fake.fits"),
                          os.path.join(WORK, "model.gmodel"))
    if K is None:
        raise AssertionError("the main path derived no harmonic window, "
                             "so the fused kernel lane was not active")
    rec = phase_timing(K)[K]
    kernels = [{
        "name": "fused_cross_spectrum",
        "route": "cuda",
        "source": "pulseportraiture_tpu_torch/ops/csrc/"
                  "fused_cross_spectrum.cu",
        "replaces": "pulseportraiture_tpu/ops/fused.py:291",
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "max_abs_ref": rec["max_abs_ref"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
