#!/usr/bin/env python3
"""The stream campaign's wall under each identity-tier knob value the
autotuner may crown, one at a time, on one card.

    python3 tools/tune_knob_walls.py [--work DIR] [--reps N]

Reuses chip_smoke.py's stream campaign in DIR (default build/chip_smoke:
its stream_meta.txt, model.gmodel and archives, written by a chip_smoke
run; written here through chip_smoke.phase_main_path and stream_archives
when absent).  For each case (the defaults; stream_pipeline_depth 4 and
1; bucket_pad True; fused_block 32; lm_compact_every 8; the four
together) it runs ``pptoas --stream --telemetry`` in this process N
times (default 2) and prints one line per run: the wall, the trace's
run_end fit / copy seconds, copy bytes, peak in-flight buckets and
pipeline depth, and the caching allocator's reserved device memory.
Then the cost of the autotuner's shape probe: ``load_data`` of the
first archive (what the JAX CLI reads the shape class from) against the
SUBINT header the port reads.  Prints the card's name and power limit.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CASES = [
    ("defaults", {}),
    ("stream_pipeline_depth=4", {"stream_pipeline_depth": 4}),
    ("stream_pipeline_depth=1", {"stream_pipeline_depth": 1}),
    ("bucket_pad=True", {"bucket_pad": True}),
    ("fused_block=32", {"fused_block": 32}),
    ("lm_compact_every=8", {"lm_compact_every": 8}),
    ("all four", {"stream_pipeline_depth": 4, "bucket_pad": True,
                  "fused_block": 32, "lm_compact_every": 8}),
    ("defaults", {}),
]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work", default=os.path.join(ROOT, "build",
                                                  "chip_smoke"))
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args(argv)

    import torch

    import chip_smoke as C
    from pulseportraiture_tpu_torch import config
    from pulseportraiture_tpu_torch.io.fitsio import get_hdu, read_fits
    from pulseportraiture_tpu_torch.io.psrfits import load_data
    from pulseportraiture_tpu_torch.ops import fused as F

    torch.backends.cuda.matmul.allow_tf32 = False
    C.WORK = args.work
    os.makedirs(C.WORK, exist_ok=True)
    print(f"card: {C.card_line()}", flush=True)
    F.build_kernels()
    meta = os.path.join(C.WORK, "stream_meta.txt")
    gmodel = os.path.join(C.WORK, "model.gmodel")
    if not os.path.exists(meta):
        C.phase_main_path()
        meta, _, _, gmodel = C.stream_archives()
    defaults = {k: getattr(config, k) for k in CASES[-2][1]}
    for tag, overrides in CASES:
        for rep in range(args.reps):
            for k, v in {**defaults, **overrides}.items():
                setattr(config, k, v)
            tim = os.path.join(C.WORK, "knob_walls.tim")
            trace = os.path.join(C.WORK, "knob_walls.jsonl")
            if os.path.exists(tim):
                os.remove(tim)
            wall, _, _ = C.run_tool(
                "pptoas", ["--stream", "-d", meta, "-m", gmodel, "-o", tim,
                           "--quiet", "--device", "cuda", "--telemetry",
                           trace], tag)
            with open(trace) as f:
                end = [e for e in map(json.loads, f)
                       if e.get("type") == "run_end"][0]
            reserved = torch.cuda.memory_stats().get(
                "reserved_bytes.all.current", 0)
            print(f"{tag} run {rep}: {wall:.3f} s; fit_s {end['fit_s']} "
                  f"h2d_s {end['h2d_s']} h2d_bytes {end['h2d_bytes']} "
                  f"peak_inflight {end['peak_inflight']} pipeline_depth "
                  f"{end['pipeline_depth']}; reserved device memory "
                  f"{reserved / 2 ** 30:.1f} GiB", flush=True)
    for k, v in defaults.items():
        setattr(config, k, v)
    with open(meta) as f:
        first = f.readline().strip()
    t0 = time.perf_counter()
    d = load_data(first, quiet=True)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    sub = get_hdu(read_fits(first, defer=("DATA",)), "SUBINT").header
    t_head = time.perf_counter() - t0
    print(f"shape probe of {os.path.basename(first)} ({d.nchan} x "
          f"{d.nbin}; header {sub['NCHAN']} x {sub['NBIN']}): load_data "
          f"{t_load:.3f} s, SUBINT header {t_head:.4f} s")
    print(f"card: {C.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
