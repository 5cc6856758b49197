#!/usr/bin/env python3
"""The benchmark's one command.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1> [--control lower]

run from the root of a checkout.  It makes the cell's pool of archives
from the seed on the card, reads it through the port's loader, warms up,
admits the pool to the port's stream executor for ``--seconds``, drains,
and checks every TOA returned against the plain reference.  Its last line
on standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``checks`` last: each compared number beside its limit);
the same numbers end standard error.  ``--control lower`` puts the
reference one precision step lower (reference.py), in the
program's place: a run that must
read ``correct: false``.

It exits non-zero with no result where torch sees no card, fewer cards
than the cell asks for, or the program is not in the checkout, and where
the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixed_caches():
    """The program's kernel builds and any Triton cache at fixed paths in
    the checkout, so only a checkout's first run builds."""
    base = os.path.join(ROOT, "build", "portbench")
    os.environ["PPT_COMPILE_CACHE"] = os.path.join(base, "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("lower",), default=None)
    args = ap.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, ROOT)
    import torch

    from portbench import cells
    from portbench.harness import finite_json, run_cell

    chips = cells.find_cell(cells.load_benchmark(ROOT),
                            args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {have}", file=sys.stderr)
        return 2
    result, rows = run_cell(args.workload, args.seed, args.seconds,
                            trace=bool(args.trace), device="cuda:0",
                            control=args.control, t_start=T_START)
    for name, value, limit in rows:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(finite_json(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
