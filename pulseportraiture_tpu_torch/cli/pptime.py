"""pptime: fleet-batched wideband GLS timing from .tim + parfiles on a
CUDA device (counterpart of pulseportraiture_tpu/cli/pptime.py).

The timing tail of the pipeline (pptoas -> .tim -> timing solution),
fleet-shaped: every pulsar's linearized system is bucketed by
power-of-two (rows, params) class and solved by one padded batched
call per bucket (timing/fleet.py), instead of one solve per pulsar.
Handles isolated and ELL1/BT binary parfiles (Keplerian elements
fitted; Shapiro/relativistic keys refused loudly).

Single pulsar:    pptime psr.tim psr.par [--device cuda|cpu]
Fleet:            pptime -j jobs.txt        # lines: <pulsar> <tim> <par>

Flag parity with the JAX CLI plus --device; --telemetry writes the
solves' timing_fit events and the fleet_end rollup to a JSONL trace.
"""

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="pptime", description=__doc__.splitlines()[0])
    p.add_argument("timfile", nargs="?", default=None,
                   help="Wideband .tim file (single-pulsar mode).")
    p.add_argument("parfile", nargs="?", default=None,
                   help="Parfile (single-pulsar mode).")
    p.add_argument("-j", "--jobs", default=None,
                   help="Fleet jobs file: one '<pulsar> <timfile> "
                        "<parfile>' line per pulsar (# comments ok).")
    p.add_argument("--fit-f1", action="store_true", default=False,
                   help="Also fit the spin-down term dF1.")
    p.add_argument("--no-fit-binary", dest="fit_binary",
                   action="store_false", default=True,
                   help="Model the parfile's binary orbit but hold "
                        "its elements fixed.")
    p.add_argument("--allow-wraps", action="store_true", default=False,
                   help="Accept per-TOA nearest-turn wrapping even "
                        "when phase connection looks lost.")
    p.add_argument("--epoch-gap", type=float, default=0.5,
                   help="DMX epoch grouping gap [days] (default 0.5).")
    p.add_argument("--gls-device", default=None,
                   choices=("off", "auto", "on"),
                   help="Route the fleet solve through the batched "
                        "device lane (default: config.gls_device / "
                        "PPT_GLS_DEVICE).")
    p.add_argument("--serial", action="store_true", default=False,
                   help="One solve dispatch per pulsar instead of one "
                        "per bucket (the bench A/B arm).")
    p.add_argument("--telemetry", default=None,
                   help="Append timing_fit/fleet_end events to this "
                        "JSONL trace.")
    p.add_argument("--json", action="store_true", default=False,
                   help="Print one JSON line per pulsar instead of "
                        "the table.")
    p.add_argument("--device", default="cuda",
                   help="torch device the batched solves run on. "
                        "[default=cuda]")
    p.add_argument("--quiet", action="store_true", default=False)
    return p


def _load_jobs(args, parser):
    """Resolve the fleet spec; anything malformed dies loudly BEFORE
    any file IO (SystemExit carries the message so tests can match)."""
    if args.jobs is not None:
        if args.timfile is not None or args.parfile is not None:
            raise SystemExit("pptime: pass -j/--jobs OR a single "
                             "timfile+parfile pair, not both")
        import os

        if not os.path.exists(args.jobs):
            raise SystemExit(f"pptime: jobs file not found: "
                             f"{args.jobs}")
        jobs = []
        with open(args.jobs) as fh:
            for lineno, line in enumerate(fh, 1):
                s = line.strip()
                if not s or s.startswith("#"):
                    continue
                parts = s.split()
                if len(parts) != 3:
                    raise SystemExit(
                        f"pptime: {args.jobs}:{lineno}: expected "
                        f"'<pulsar> <timfile> <parfile>', got {s!r}")
                jobs.append(tuple(parts))
        if not jobs:
            raise SystemExit(f"pptime: {args.jobs}: no jobs")
        return jobs
    if args.timfile is None or args.parfile is None:
        raise SystemExit("pptime: need a timfile and a parfile (or "
                         "-j jobs.txt)")
    import os

    name = os.path.basename(args.timfile)
    name = name[:-4] if name.endswith(".tim") else name
    return [(name, args.timfile, args.parfile)]


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    specs = _load_jobs(args, parser)

    from ..device import resolve_device
    from ..timing.fleet import TimingJob, fleet_gls_fit

    gls_device = {None: None, "off": False, "auto": "auto",
                  "on": True}[args.gls_device]
    jobs = [TimingJob(*spec) for spec in specs]
    fleet = fleet_gls_fit(
        jobs, fit_f1=args.fit_f1, fit_binary=args.fit_binary,
        epoch_gap_days=args.epoch_gap, allow_wraps=args.allow_wraps,
        gls_device=gls_device, batched=not args.serial,
        telemetry=args.telemetry, quiet=args.quiet,
        device=resolve_device(args.device))

    if args.json:
        import json

        for name in fleet.pulsars:
            r = fleet.results[name]
            print(json.dumps({
                "pulsar": name, "n_toas": int(len(r.time_resids_us)),
                "chi2": float(r.chi2), "dof": int(r.dof),
                "red_chi2": float(r.red_chi2),
                "wrms_us": float(r.wrms_us),
                "params": {k: float(v) for k, v in r.params.items()},
                "param_errs": {k: float(v)
                               for k, v in r.param_errs.items()},
                "dmx": [float(v) for v in r.dmx],
                "binary": (r.binary.kind if r.binary is not None
                           else None)}))
    else:
        for name in fleet.pulsars:
            r = fleet.results[name]
            orbit = f"  binary={r.binary.kind}" if r.binary else ""
            print(f"{name}: {len(r.time_resids_us)} TOAs, "
                  f"red-chi2 {r.red_chi2:.3f}, wrms "
                  f"{r.wrms_us:.4f} us, {len(r.dmx)} DMX "
                  f"epoch(s){orbit}")
            for k, v in r.params.items():
                print(f"    {k:>7s} {v:+.6e} +/- {r.param_errs[k]:.1e}")
    if not args.quiet and not args.json:
        lane = "device" if fleet.device else "host"
        print(f"{len(fleet.pulsars)} pulsar(s) in "
              f"{fleet.n_dispatches} solve dispatch(es) [{lane}"
              f"{', batched' if fleet.device and fleet.batched else ''}]"
              f" in {fleet.wall_s:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
