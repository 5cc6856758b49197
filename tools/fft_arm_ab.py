#!/usr/bin/env python3
"""Time the fused kernels' arms of two checkouts in turns on one card.

    python3 tools/fft_arm_ab.py --parent DIR [--rows fft|gemm|all]
        [--rounds 1] [--ptxas]

DIR holds another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  Each turn is a fresh process that imports
pulseportraiture_tpu_torch from its tree, builds that tree's kernels and
times, with CUDA events (median of 20 samples of 5 calls issued back to
back), all float32 on the same seeded inputs (one shared template,
per-element weights):
- the FFT-arm rows (``--rows fft``): B1's S0 form at 64 x 512 x 2048 (K =
  384 and 1025), its want_m2 form at 256 x 512 x 2048 (K = 384) and B2 on
  2-bit rows at 256 x 512 x 2048 (K = 384);
- the GEMM-arm rows (``--rows gemm``): B1's S0 form at 64 x 512 x 1022
  (2 7 73 bins, the GEMM arm by the shape rule) at K = 384 and 512, its
  want_m2 form at 256 x 512 x 1022 (K = 384), B2 on 2-bit rows at 256 x
  512 x 1032 (2^3 3 43, K = 384), and the GEMM arm forced at 2048 bins
  (S0 64 x 512, want_m2 256 x 512, K = 384).
``--rows all`` (the default) times both.  The turns run parent, this
tree, this tree, parent, ``--rounds`` times.  Prints one line per turn,
then one JSON object with every turn's times, the card's name and power
limit.  ``--ptxas`` also prints, from each tree's first turn (built with
ptxas's report), the registers, stack and spills of its FFT-arm and
GEMM-arm kernels.  Needs one CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, kernel, nb, nbin, K, want_m2, arm) by row set
SHAPES = {
    "fft": (("B1 S0 64x512x2048 K=384", "b1", 64, 2048, 384, False, None),
            ("B1 S0 64x512x2048 K=1025", "b1", 64, 2048, 1025, False, None),
            ("B1 want_m2 256x512x2048 K=384", "b1", 256, 2048, 384, True,
             None),
            ("B2 2-bit 256x512x2048 K=384", "b2", 256, 2048, 384, False,
             None)),
    "gemm": (("B1 S0 64x512x1022 K=384", "b1", 64, 1022, 384, False, None),
             ("B1 S0 64x512x1022 K=512", "b1", 64, 1022, 512, False, None),
             ("B1 want_m2 256x512x1022 K=384", "b1", 256, 1022, 384, True,
              None),
             ("B2 2-bit 256x512x1032 K=384", "b2", 256, 1032, 384, False,
              None),
             ("B1 S0 64x512x2048 K=384 GEMM arm forced", "b1", 64, 2048, 384,
              False, "gemm"),
             ("B1 want_m2 256x512x2048 K=384 GEMM arm forced", "b1", 256,
              2048, 384, True, "gemm"))}
NCHAN = 512


def median_ms(fn, n=20, warmup=3, reps=5):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def worker(tree, rows, ptxas=False):
    """Time the SHAPES of ``rows`` with the package of ``tree``; print one
    JSON line (after the build's ptxas report when ``ptxas``)."""
    sys.path.insert(0, tree)
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F

    if os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(F.__file__)))) != os.path.abspath(tree):
        raise SystemExit(f"imported {F.__file__}, not the tree {tree}")
    F.build_kernels(verbose=ptxas)
    out = {}
    for label, kern, nb, nbin, K, m2, arm in rows:
        g = torch.Generator(device="cuda").manual_seed(K + nb)
        model = torch.randn((NCHAN, nbin), generator=g, device="cuda")
        w = torch.rand((nb, NCHAN, K), generator=g, device="cuda") + 0.5
        if kern == "b1":
            port = torch.randn((nb, NCHAN, nbin), generator=g, device="cuda")
            call = (lambda p=port, m=model, w=w, K=K, m2=m2, a=arm:
                    F.fused_cross_spectrum_cuda(p, m, w, K, want_m2=m2,
                                                arm=a))
        else:
            raw = torch.randint(0, 256, (nb, NCHAN, nbin // 4), generator=g,
                                device="cuda", dtype=torch.uint8)
            scl = torch.rand((nb, NCHAN), generator=g, device="cuda") + 0.5
            offs = torch.randn((nb, NCHAN), generator=g, device="cuda")
            call = (lambda r=raw, s=scl, o=offs, m=model, w=w, K=K, n=nbin,
                    a=arm: F.fused_decode_cross_spectrum_cuda(
                        r, s, o, m, w, K, code="p2", nbin=n, arm=a))
        out[label] = median_ms(call)
        del call
    print(json.dumps(out), flush=True)


def ptxas_report(text):
    """The lines of a ptxas report that describe the FFT-arm and GEMM-arm
    kernels: each one's entry line and its stack/spill and register
    lines."""
    lines = text.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and ("fft_" in ln
                                                 or "fcs_" in ln):
            name = ln.split("'")[1]
            at = name.find("fft_") if "fft_" in name else name.find("fcs_")
            out.append(name[at:][:60])
            out += [x.strip() for x in lines[i + 1:i + 4]
                    if "stack frame" in x or "registers" in x]
    return out


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's directory")
    ap.add_argument("--rows", choices=("fft", "gemm", "all"), default="all")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        worker(a.worker, SHAPES["fft"] + SHAPES["gemm"] if a.rows == "all"
               else SHAPES[a.rows], a.ptxas)
        return 0
    if not a.parent:
        ap.error("--parent is required")
    import torch

    if not torch.cuda.is_available():
        print("fft_arm_ab: no CUDA device is available", file=sys.stderr)
        return 2
    trees = {"parent": os.path.abspath(a.parent), "change": HERE}
    turns, reported = [], set()
    for _ in range(a.rounds):
        for which in ("parent", "change", "change", "parent"):
            report = a.ptxas and which not in reported
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 trees[which], "--rows", a.rows]
                + (["--ptxas"] if report else []),
                cwd=trees[which], capture_output=True, text=True,
                timeout=900)
            if r.returncode != 0:
                print(r.stderr[-4000:], file=sys.stderr)
                return 1
            if report:
                reported.add(which)
                for ln in ptxas_report(r.stdout + r.stderr):
                    print(f"{which} ptxas: {ln}", flush=True)
            times = json.loads(r.stdout.strip().splitlines()[-1])
            turns.append({"tree": which, "ms": times})
            print(f"{which}: " + ", ".join(f"{k} {v:.4f} ms"
                                            for k, v in times.items()),
                  flush=True)
    print(json.dumps({"card": card_line(), "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
