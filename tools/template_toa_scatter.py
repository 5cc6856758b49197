#!/usr/bin/env python3
"""The bounds of chip_smoke.py's template path (phase 14), on the CPU:
the main path and the template path (phases 4 and 14) at the chip
check's widths (512 channels x 2048 bins) and a cut depth of the main
archive, with the card's routes forced (the float32 fast fit, the fused
lane through B1's plain version, the batched LM lane).  One run per
seed, each with its own archives.

    python tools/template_toa_scatter.py [--nsub-main 16] [--seeds 2]
        [--work build/template_toa_scatter] [--threads 4]

Prints each run's template-path lines and, over all runs, the smallest
correlation of each built template with the clean .gmodel portrait and
the largest scatter [sigma] of TOA(built template) - TOA(.gmodel) about
its mean offset, per pptoas run.
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

CORR = re.compile(r"template path \((a\.gmodel|ppspline [^)]*)\).*?"
                  r"correlation with the clean \.gmodel portrait ([0-9.]+)")
SCAT = re.compile(r"template path \((pptoas[^)]*)\).*?scatter about it "
                  r"rms ([0-9.]+), max ([0-9.]+) sigma")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nsub-main", type=int, default=16)
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--work", default=os.path.join(
        ROOT, "build", "template_toa_scatter"))
    args = p.parse_args(argv)
    import torch

    torch.set_num_threads(args.threads)
    # the card's routes on the CPU: 'auto' resolves on off CUDA
    for knob in ("fit_fused", "fast_fit", "device_f32", "gauss_device"):
        D.KNOB_POLARITY[knob] = "not_cuda"
    D.KNOB_POLARITY["dft_fold"] = "cuda"
    C.WORK = args.work
    os.makedirs(C.WORK, exist_ok=True)
    C.TEMPLATE_CORR = {"gmodel": -math.inf, "spl": -math.inf}
    C.TEMPLATE_TOA_SCATTER = {"gmodel": math.inf, "spl": math.inf}
    base = C.SEED
    corr, scat = {}, {}
    for j in range(args.seeds):
        C.SEED = base + 1000 * j
        buf = io.StringIO()
        with redirect_stdout(buf):
            try:
                C.phase_main_path(device="cpu", nsub=args.nsub_main)
            except AssertionError:
                pass  # its launch check needs the card; the .tim is written
            C.phase_template(device="cpu", nsub=args.nsub_main)
        text = buf.getvalue()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("template", "  LM"))]
        print(f"seed {C.SEED}:\n  " + "\n  ".join(lines), flush=True)
        for name, c in CORR.findall(text):
            corr.setdefault(name, []).append(float(c))
        for name, r, m in SCAT.findall(text):
            scat.setdefault(name, []).append((float(r), float(m)))
    for name, cs in corr.items():
        print(f"{name}: correlation min {min(cs):.8f} (1 - corr "
              f"{1.0 - min(cs):.3e}) over {len(cs)} runs")
    for name, rm in scat.items():
        rms = math.sqrt(sum(r * r for r, _ in rm) / len(rm))
        print(f"{name}: scatter rms {rms:.4f} sigma, largest per run "
              f"{[round(m, 4) for _, m in rm]}")


if __name__ == "__main__":
    sys.exit(main())
