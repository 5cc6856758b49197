#!/usr/bin/env python3
"""The scatter of TOA(aligned template) - TOA(.gmodel) about its mean, in
units of the TOA error, on the CPU: chip_smoke.py's main path and align
path (phases 4 and 13) at the chip check's widths (512 channels x 2048
bins) and a cut depth, with the card's routes forced (the float32 fast
fit, the fused lane through B1's plain version, the device accumulate)
and the epochs' noise scaled so that the aligned template's white noise
per bin equals the chip check's (NOISE_ALIGN / sqrt(NARCH_ALIGN x
NSUB_ALIGN)).  One run per seed, each with the main archive's TOAs
against the template aligned from that seed's epochs.

    python tools/align_toa_scatter.py [--nsub-main 16] [--nsub-align 8]
        [--seeds 4] [--work build/align_toa_scatter] [--controls]

Prints each run's align-path lines and, over all runs, the rms and the
largest scatter [sigma] per run.  --controls also times the last run's
main archive against two FITS templates in place of the aligned one:
the .gmodel portrait itself (noiseless) and the same plus white noise
of the aligned template's level per bin.
"""

import argparse
import io
import math
import os
import re
import sys
from contextlib import redirect_stdout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from pulseportraiture_tpu_torch import device as D  # noqa: E402

PAT = re.compile(r"scatter about it rms ([0-9.]+), max ([0-9.]+) sigma")


def scatter(tim):
    """(rms, max) of the scatter of tim's TOAs minus the .gmodel run's
    about their mean, in units of tim's TOA errors."""
    import numpy as np

    ref = C.read_tim(os.path.join(C.WORK, "toas.tim"))
    got = C.read_tim(tim)
    keys = sorted(ref)
    d = np.array([C.tim_offset_us(ref[k], got[k]) for k in keys])
    s = (d - d.mean()) / np.array([got[k]["err"] for k in keys])
    return float(np.sqrt(np.mean(s ** 2))), float(np.abs(s).max())


def controls(template_noise):
    """The main archive against the noiseless .gmodel portrait and the
    same with white noise of template_noise per bin, each written as a
    FITS template like ppalign's output (DM 0, dmc 1, unit weights)."""
    import numpy as np
    from pulseportraiture_tpu_torch.io.gmodel import gen_gmodel_portrait
    from pulseportraiture_tpu_torch.io.psrfits import (read_archive,
                                                       unload_new_archive)
    from pulseportraiture_tpu_torch.synth import default_test_model

    aligned = os.path.join(C.WORK, "aligned-0.fits")
    arch = read_archive(aligned)
    clean = gen_gmodel_portrait(default_test_model(1500.0),
                                np.arange(arch.nbin), arch.freqs_table[0],
                                P=C.PAR["P0"], device="cpu")
    rng = np.random.default_rng(C.SEED)
    for name, noise in (("noiseless", 0.0), ("noisy", template_noise)):
        port = clean + noise * rng.standard_normal(clean.shape)
        path = os.path.join(C.WORK, f"control-{name}.fits")
        unload_new_archive(port[None, None], arch, path, DM=0.0, dmc=1,
                           weights=np.ones((1, arch.nchan)), quiet=True)
        tim = os.path.join(C.WORK, f"control-{name}.tim")
        if os.path.exists(tim):
            os.remove(tim)
        with redirect_stdout(io.StringIO()):
            C.run_cli(["-d", os.path.join(C.WORK, "fake.fits"), "-m", path,
                       "-o", tim, "--quiet", "--device", "cpu"], name)
        r, m = scatter(tim)
        print(f"control: the .gmodel portrait {name} (white noise "
              f"{noise:.4f} per bin) as the template: scatter rms {r:.4f}, "
              f"max {m:.4f} sigma", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nsub-main", type=int, default=16)
    p.add_argument("--nsub-align", type=int, default=8)
    p.add_argument("--seeds", type=int, default=4)
    p.add_argument("--work", default=os.path.join(ROOT, "build",
                                                  "align_toa_scatter"))
    p.add_argument("--controls", action="store_true")
    args = p.parse_args(argv)
    # the card's routes on the CPU: 'auto' resolves on off CUDA
    for knob in ("fit_fused", "fast_fit", "device_f32", "align_device"):
        D.KNOB_POLARITY[knob] = "not_cuda"
    D.KNOB_POLARITY["dft_fold"] = "cuda"
    C.WORK = args.work
    C.ALIGN_TOA_SCATTER = math.inf
    template_noise = C.NOISE_ALIGN / math.sqrt(C.NARCH_ALIGN * C.NSUB_ALIGN)
    C.NOISE_ALIGN = template_noise * math.sqrt(C.NARCH_ALIGN
                                               * args.nsub_align)
    base = C.SEED
    rms, worst = [], []
    for j in range(args.seeds):
        C.SEED = base + 1000 * j
        buf = io.StringIO()
        with redirect_stdout(buf):
            try:
                C.phase_main_path(device="cpu", nsub=args.nsub_main)
            except AssertionError:
                pass  # its launch check needs the card; the .tim is written
            C.phase_align(device="cpu", nsub=args.nsub_align)
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("align path")]
        print(f"seed {C.SEED}:\n  " + "\n  ".join(lines), flush=True)
        r, m = map(float, PAT.search(buf.getvalue()).groups())
        rms.append(r)
        worst.append(m)
    if args.controls:
        controls(template_noise)
    total = math.sqrt(sum(r * r for r in rms) / len(rms))
    print(f"{args.seeds} runs of {args.nsub_main} TOAs, template noise "
          f"{template_noise:.4f} per bin (epochs at noise "
          f"{C.NOISE_ALIGN:.4f}): scatter rms {total:.4f} sigma, largest "
          f"per run {[round(m, 4) for m in worst]}")


if __name__ == "__main__":
    sys.exit(main())
