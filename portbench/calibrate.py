#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--dump DIR]

For each seed of ``--seeds``: the cell's pool, read through the port's
loader, admitted once at the cell's load (whole buckets of
the program's default size), drained, and every returned TOA compared
with the reference: the program's numbers, the lower readings.  For each
seed of ``--control-seeds``: the reference with one precision step lower
put in the program's place: the control's numbers, the upper
readings.  One JSON line per seed; set-up (the kernels' first use) is paid
once for all seeds.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--dump", default=None,
                    help="a directory to write each program seed's TOAs "
                    "and the reference's into (.npz), for a closer look")
    ap.add_argument("--fault-seeds", default="",
                    help="seeds on which the reference, put in the "
                    "program's place, is read with each planted fault")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.run import _fixed_caches

    _fixed_caches()
    import torch

    from portbench import harness
    from portbench.window import Campaign, default_nsub_batch

    device = "cuda:0"
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    faults = [int(s) for s in args.fault_seeds.split(",") if s]
    nsb = default_nsub_batch()
    warm = True
    for seed in seeds:
        t0 = time.perf_counter()
        _, _, _, traffic, limits, pool = harness.setup_cell(
            args.workload, seed, device)
        lane, loader = harness.program_lane(pool, traffic, device, nsb)
        camp = Campaign(pool, lane, harness.load_pool(pool, loader), device,
                        nsb)
        if warm:
            camp.run(passes=harness.WARM_PASSES)
            camp.results.clear()
            camp.admitted_toas = 0
            warm = False
        window_s = camp.run(passes=1)
        camp.close()
        camp.ex = None
        torch.cuda.empty_cache()
        numbers = harness.reference_numbers(pool, camp, device,
                                            dump=args.dump and os.path.join(
                                                args.dump, f"{seed}.npz"))
        print(json.dumps(harness.finite_json({
            "kind": "program", "seed": seed, "numbers": numbers,
            "correct": harness.compare.judge(numbers, limits)[0],
            "toas": camp.returned_toas(), "window_s": window_s,
            "seconds": time.perf_counter() - t0})), flush=True)
    for seed in controls:
        t0 = time.perf_counter()
        _, _, _, _, limits, pool = harness.setup_cell(args.workload, seed,
                                                      device)
        numbers = harness.reference_numbers(pool, None, device,
                                            control="lower")
        print(json.dumps(harness.finite_json({
            "kind": "control_lower", "seed": seed, "numbers": numbers,
            "correct": harness.compare.judge(numbers, limits)[0],
            "seconds": time.perf_counter() - t0})), flush=True)
    for seed in faults:
        _, _, _, _, limits, pool = harness.setup_cell(args.workload, seed,
                                                      device)
        for fault in harness.FAULTS:
            numbers = harness.reference_numbers(pool, None, device,
                                                fault=fault)
            print(json.dumps(harness.finite_json({
                "kind": f"fault_{fault}", "seed": seed, "numbers": numbers,
                "correct": harness.compare.judge(numbers, limits)[0]})),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
