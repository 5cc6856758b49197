"""pptoas — measure wideband TOAs and DMs on the GPU.

The options of the JAX package's pptoas: GetTOAs per archive, or with
--stream the campaign lane (pipeline/stream.py) that pools subints
across the archives of a metafile into batched fits, both with the
scattering fits (--fit_scat); --narrowband (or --psrchive) measures one
TOA per channel instead, with or without --stream.  Templates are
.gmodel, spline (.spl/.npz) or PSRFITS files.  --telemetry writes a
JSONL trace of the wideband GetTOAs path or the --stream drivers (read
it with ``python -m pulseportraiture_tpu_torch.cli.pptrace report``);
--transport-compress switches the stream's lossless transport codec.
--autotune resolves this card's knob winners from the tuning DB
(--tune-db), sweeping the output-identical knob tier on the first
archive when the DB has no entry, before the campaign runs; the .tim is
byte-identical tuned or not.

    python -m pulseportraiture_tpu_torch.cli.pptoas -d archive.fits \\
        -m model.gmodel -o out.tim [--device cuda|cpu] [--narrowband]
    python -m pulseportraiture_tpu_torch.cli.pptoas --stream \\
        -d metafile -m model.spl -o out.tim [--stream-devices auto|N] \\
        [--autotune] [--tune-db tune.json]
"""

import argparse
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="pptoas", description=__doc__.splitlines()[0])
    p.add_argument("-d", "--datafiles", metavar="archive", required=True,
                   help="PSRFITS archive or metafile of archive names.")
    p.add_argument("-m", "--modelfile", metavar="model", required=True,
                   help=".gmodel, spline model, or PSRFITS template.")
    p.add_argument("-o", "--outfile", metavar="timfile", default=None,
                   help="Output .tim file (appends). [default=stdout]")
    p.add_argument("--device", default="cuda",
                   help="torch device the fits run on. [default=cuda]")
    p.add_argument("--narrowband", action="store_true", default=False,
                   help="Make narrowband (per-channel) TOAs instead.")
    p.add_argument("--stream", action="store_true", default=False,
                   help="Cross-archive batched dispatches for large "
                        "campaigns (wideband phi/DM fits only).")
    p.add_argument("--stream-devices", dest="stream_devices",
                   default=None, metavar="auto|N",
                   help="With --stream: CUDA devices to deal buckets "
                        "across, round-robin ('auto' = every visible "
                        "device, or a count). [default: "
                        "config.stream_devices; --device cpu streams on "
                        "the CPU]")
    p.add_argument("--pipeline-depth", dest="pipeline_depth",
                   default=None, type=int, metavar="N",
                   help="With --stream: buckets that may occupy a "
                        "device's copy -> fit pipeline at once (2 "
                        "double-buffers the host->device copy against "
                        "the running fit). [default: "
                        "config.stream_pipeline_depth]")
    p.add_argument("--transport-compress", dest="transport_compress",
                   default=None, metavar="off|auto|on",
                   help="With --stream: lossless transport codec for "
                        "int16/byte payloads (packed narrower residuals "
                        "+ per-subint minima, unpacked exactly on the "
                        "device): 'off', 'auto' (a cost model fed from "
                        "the measured link and codec rates decides per "
                        "dispatch) or 'on' (whenever a payload is "
                        "compressible).  .tim output is identical "
                        "either way. [default: "
                        "config.transport_compress]")
    p.add_argument("--compile-cache", dest="compile_cache",
                   default=None, metavar="DIR",
                   help="Shared build directory of the hand kernels: a "
                        "process that finds the library built there "
                        "loads it instead of running nvcc.  Also via "
                        "PPT_COMPILE_CACHE / config.compile_cache_dir. "
                        "[default: off, the checkout's "
                        "build/torch_kernels]")
    p.add_argument("--errfile", metavar="errfile", default=None,
                   help="Write fitted DM errors to this file (appends).")
    p.add_argument("-T", "--tscrunch", action="store_true", default=False,
                   help="tscrunch archives before measurement.")
    p.add_argument("-f", "--format", dest="format", default="ipta",
                   choices=("ipta", "princeton"),
                   help="Output TOA format.")
    p.add_argument("--nu_ref", dest="nu_ref_DM", default=None,
                   help="Output reference frequency [MHz]; 'inf' for "
                        "infinite. [default: zero-covariance frequency]")
    p.add_argument("--DM", dest="DM0", default=None, type=float,
                   help="Nominal DM [cm**-3 pc] for offset-DM reporting.")
    p.add_argument("--no_bary", dest="bary", action="store_false",
                   default=True, help="No Doppler correction of DM/GM.")
    p.add_argument("--one_DM", action="store_true", default=False,
                   help="Single (mean) DM value per epoch in the .tim.")
    p.add_argument("--fix_DM", dest="fit_DM", action="store_false",
                   default=True, help="Do not fit for DM.")
    p.add_argument("--fit_dt4", dest="fit_GM", action="store_true",
                   default=False, help="Fit nu**-4 'GM' delays.")
    p.add_argument("--fit_scat", action="store_true", default=False,
                   help="Fit scattering timescale and index per TOA.")
    p.add_argument("--no_logscat", dest="log10_tau", action="store_false",
                   default=True, help="Fit tau linearly, not log10(tau).")
    p.add_argument("--scat_guess", default=None,
                   help="'tau[s],freq[MHz],alpha' initial scattering "
                        "guess, or 'auto' to estimate it per subint from "
                        "the data's harmonic amplitude decay.")
    p.add_argument("--fix_alpha", action="store_true", default=False,
                   help="Hold the scattering index fixed (with --fit_scat).")
    p.add_argument("--nu_tau", dest="nu_ref_tau", default=None, type=float,
                   help="Output reference frequency [MHz] for tau.")
    p.add_argument("--print_phase", action="store_true", default=False,
                   help="Add -phs/-phs_err flags to TOA lines.")
    p.add_argument("--print_flux", action="store_true", default=False,
                   help="Add flux-estimate flags to TOA lines.")
    p.add_argument("--print_parangle", action="store_true", default=False,
                   help="Add parallactic-angle flags to TOA lines.")
    p.add_argument("--flags", default="",
                   help="Comma-separated extra TOA flag pairs k1,v1,k2,v2.")
    p.add_argument("--snr_cut", dest="snr_cutoff", default=0.0, type=float,
                   help="Minimum snr flag value for written TOAs.")
    p.add_argument("--showplot", action="store_true", default=False,
                   help="Save per-subint fit plots next to the archives "
                        "(accepted as the JAX CLI accepts it; refused "
                        "with --stream).")
    p.add_argument("--prefetch", action="store_true", default=False,
                   help="Overlap archive IO with fitting (long lists).")
    p.add_argument("--autotune", action="store_true", default=False,
                   help="Before the campaign, resolve this card's "
                        "measured knob winners from the tuning DB "
                        "(--tune-db / PPT_TUNE_DB); with no stored "
                        "entry, sweep the output-identical knob tier on "
                        "the first archive and persist the winners.  "
                        ".tim output is byte-identical tuned vs default.  "
                        "Also via PPT_AUTOTUNE.")
    p.add_argument("--tune-db", dest="tune_db", default=None,
                   metavar="PATH",
                   help="Persisted per-backend tuning DB (JSON, "
                        "tune/store.py).  A DB measured on a different "
                        "backend fingerprint (another card, torch build "
                        "or the JAX package) is refused with a warning.  "
                        "Also via PPT_TUNE_DB. [default: config.tune_db]")
    p.add_argument("--fit-fused", dest="fit_fused", default=None,
                   metavar="off|auto|on",
                   help="Fused DFT -> cross-spectrum kernel lane of the "
                        "fast fit (active only with the harmonic window): "
                        "'off', 'auto' (CUDA devices), 'on'. [default: "
                        "config.fit_fused]")
    p.add_argument("--bound", action="append", default=[],
                   metavar="PARAM:LO,HI",
                   help="Box bound on a fit parameter (repeatable): "
                        "PARAM in {phi,dm,gm,tau,alpha}; LO/HI are floats "
                        "or 'None' (open).  tau bounds are in "
                        "log10(rotations) under the default log-tau "
                        "fit.  A fit converging on a bound reports "
                        "return code 0.")
    p.add_argument("--telemetry", metavar="trace.jsonl", default=None,
                   help="Write a JSONL campaign trace (per-dispatch "
                        "device/queue/link records, per-archive events, "
                        "fit quality) of the wideband GetTOAs path or "
                        "the --stream drivers; read it with python -m "
                        "pulseportraiture_tpu_torch.cli.pptrace report. "
                        "[default: PPT_TELEMETRY / "
                        "config.telemetry_path]")
    p.add_argument("--quality_flags", action="store_true", default=False,
                   help="Add per-TOA -nfev/-chi2 fit-diagnostic flags.")
    p.add_argument("--quiet", action="store_true", default=False)
    # accepted for reference-script compatibility: --psrchive routes to
    # the narrowband TOAs, --method is ignored
    p.add_argument("--psrchive", action="store_true", default=False,
                   help=argparse.SUPPRESS)
    p.add_argument("--method", default=None, help=argparse.SUPPRESS)
    return p


_BOUND_PARAMS = {"phi": 0, "dm": 1, "gm": 2, "tau": 3, "alpha": 4}


def parse_bounds(specs):
    """--bound PARAM:LO,HI strings -> (5, 2) array or None."""
    if not specs:
        return None
    bounds = np.full((5, 2), (-np.inf, np.inf))
    for spec in specs:
        try:
            name, rng = spec.split(":")
            lo, hi = rng.split(",")
            idx = _BOUND_PARAMS[name.strip().lower()]
            lo_v = (-np.inf if lo.strip().lower() in ("none", "")
                    else float(lo))
            hi_v = (np.inf if hi.strip().lower() in ("none", "")
                    else float(hi))
        except (ValueError, KeyError):
            raise SystemExit(
                f"--bound: expected PARAM:LO,HI with PARAM in "
                f"{sorted(_BOUND_PARAMS)}; got {spec!r}")
        if np.isnan(lo_v) or np.isnan(hi_v):
            raise SystemExit(f"--bound: NaN bound in {spec!r}")
        if lo_v > hi_v:
            raise SystemExit(
                f"--bound: lower bound exceeds upper in {spec!r}")
        bounds[idx] = (lo_v, hi_v)
    return bounds


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .. import config

    stream_devices = _stream_options(args)
    nu_ref_DM = args.nu_ref_DM
    if nu_ref_DM is not None:
        nu_ref_DM = np.inf if str(nu_ref_DM).lower() == "inf" \
            else float(nu_ref_DM)
    nu_refs = None
    if nu_ref_DM is not None or args.nu_ref_tau is not None:
        nu_refs = (nu_ref_DM, args.nu_ref_tau)
    scat_guess = None
    if args.scat_guess:
        scat_guess = ("auto" if args.scat_guess.strip() == "auto"
                      else [float(x) for x in args.scat_guess.split(",")])
    addtnl = {}
    if args.flags:
        parts = args.flags.split(",")
        addtnl = dict(zip(parts[0::2], parts[1::2]))
    bounds = parse_bounds(args.bound)
    if bounds is not None and (args.stream or args.narrowband
                               or args.psrchive):
        raise SystemExit("--bound applies to the standard wideband "
                         "GetTOAs path (no --stream/--narrowband)")
    if args.fit_fused is not None:
        table = {"off": False, "auto": "auto", "on": True}
        v = str(args.fit_fused).lower()
        if v not in table:
            raise SystemExit("--fit-fused expected one of off/auto/on, "
                             f"got {args.fit_fused!r}")
        config.fit_fused = table[v]
    if args.compile_cache:
        # every lane builds the same kernels; also the config default,
        # so a helper process resolves the same directory
        from ..utils.device import enable_compile_cache

        config.compile_cache_dir = args.compile_cache
        enable_compile_cache(args.compile_cache)
    if args.quality_flags and args.narrowband:
        raise SystemExit("--quality_flags applies to the wideband "
                         "paths (per-channel lines already carry "
                         "-snr/-gof)")
    if (args.narrowband or args.psrchive) and not args.stream:
        if args.telemetry:
            raise SystemExit("--telemetry covers the wideband GetTOAs "
                             "path and the --stream drivers (use "
                             "--stream --narrowband for traced "
                             "per-channel campaigns)")
        if config.telemetry_path:
            # PPT_TELEMETRY set, but this path writes no trace: say so
            # rather than be silently inert
            from ..telemetry import log

            log("pptoas: telemetry_path is set but the non-stream "
                "narrowband path is untraced; use --stream "
                "--narrowband for a traced per-channel campaign",
                level="warn")

    # --autotune / --tune-db: this card's tuned knob winners are set
    # before any lane runs; when tuning is active the campaign shares the
    # tracer resolved here (tune events and campaign events, one trace)
    tune_tracer, tune_owned = _apply_autotune(args)
    if tune_owned:
        args.telemetry = tune_tracer
    try:
        return _run(args, nu_ref_DM, nu_refs, addtnl, stream_devices,
                    scat_guess, bounds)
    finally:
        if tune_owned:
            tune_tracer.close()


def _run(args, nu_ref_DM, nu_refs, addtnl, stream_devices, scat_guess,
         bounds):
    """The lane the flags select: the stream drivers or GetTOAs."""
    from ..io.tim import write_princeton_TOAs, write_TOAs
    from ..pipeline import GetTOAs

    if args.stream and args.narrowband:
        return _run_stream_narrowband(args, addtnl, stream_devices,
                                      scat_guess)
    if args.stream:
        return _run_stream(args, nu_ref_DM, addtnl, stream_devices,
                           scat_guess)

    gt = GetTOAs(args.datafiles, args.modelfile, quiet=args.quiet,
                 device=args.device)
    if args.narrowband or args.psrchive:
        gt.get_narrowband_TOAs(tscrunch=args.tscrunch,
                               fit_scat=args.fit_scat,
                               log10_tau=args.log10_tau,
                               scat_guess=scat_guess,
                               print_phase=args.print_phase,
                               addtnl_toa_flags=addtnl, quiet=args.quiet)
    else:
        gt.get_TOAs(tscrunch=args.tscrunch, nu_refs=nu_refs, DM0=args.DM0,
                    bary=args.bary, fit_DM=args.fit_DM, fit_GM=args.fit_GM,
                    fit_scat=args.fit_scat, log10_tau=args.log10_tau,
                    scat_guess=scat_guess, fix_alpha=args.fix_alpha,
                    print_phase=args.print_phase,
                    print_flux=args.print_flux,
                    print_parangle=args.print_parangle,
                    addtnl_toa_flags=addtnl, prefetch=args.prefetch,
                    quiet=args.quiet, bounds=bounds,
                    quality_flags=args.quality_flags,
                    telemetry=args.telemetry)
        if args.one_DM:
            gt.apply_one_DM()
    if args.format == "princeton":
        dDMs = [toa.DM - gt.DM0s[gt.order.index(toa.archive)]
                if toa.DM is not None else 0.0 for toa in gt.TOA_list]
        write_princeton_TOAs(gt.TOA_list, outfile=args.outfile, dDMs=dDMs)
        if args.errfile:
            with open(args.errfile, "a") as f:
                for toa in gt.TOA_list:
                    if toa.DM_error is not None:
                        f.write(f"{toa.DM_error:.5e}\n")
    else:
        write_TOAs(gt.TOA_list, SNR_cutoff=args.snr_cutoff,
                   outfile=args.outfile, append=True)
    return 0


def _stream_options(args):
    """The --stream flags' checks (the JAX pptoas's): the resolved
    stream_devices value, or None for the default."""
    if args.transport_compress is not None:
        if not args.stream:
            raise SystemExit("--transport-compress requires --stream "
                             "(the codec rides the streaming copy stage)")
        table = {"off": False, "auto": "auto", "on": True}
        v = str(args.transport_compress).lower()
        if v not in table:
            raise SystemExit("--transport-compress expected one of "
                             "off/auto/on, got "
                             f"{args.transport_compress!r}")
        from .. import config

        config.transport_compress = table[v]
    stream_devices = args.stream_devices
    if stream_devices is not None:
        if not args.stream:
            raise SystemExit("--stream-devices requires --stream")
        v = stream_devices.strip().lower()
        if v == "auto":
            stream_devices = "auto"
        else:
            try:
                stream_devices = int(v)
            except ValueError:
                raise SystemExit("--stream-devices: expected 'auto' or a "
                                 "positive count, got "
                                 f"{args.stream_devices!r}")
            if stream_devices < 1:
                raise SystemExit("--stream-devices: count must be >= 1, "
                                 f"got {stream_devices}")
    if args.pipeline_depth is not None:
        if not args.stream:
            raise SystemExit("--pipeline-depth requires --stream")
        if args.pipeline_depth < 1:
            raise SystemExit("--pipeline-depth: depth must be >= 1, got "
                             f"{args.pipeline_depth}")
    if args.stream and args.narrowband:
        if (args.psrchive or args.one_DM or args.print_flux
                or args.print_parangle or args.fit_GM or args.showplot):
            raise SystemExit(
                "--stream --narrowband supports per-channel (phi[, tau]) "
                "fits only (no psrchive/one_DM/flux/parangle/GM flags or "
                "plots)")
    elif args.stream and (args.psrchive or args.one_DM
                          or args.print_parangle or args.showplot):
        raise SystemExit("--stream supports the wideband (phi, DM[, GM, "
                         "scattering]), flux and phase campaign "
                         "configuration only (no psrchive/one_DM/parangle "
                         "flags or plots)")
    return stream_devices


def _tune_workload(args):
    """The --autotune sweep's workload: the FIRST archive through the
    streaming lane the campaign uses, on --device, returning the .tim
    bytes as the artifact the sweep's byte gate compares.  Every call
    builds a fresh executor, so each candidate's knobs reach the code.
    The shape class is the archive's (nchan, nbin), read from its SUBINT
    header: the JAX CLI loads the whole archive for it, which on a 64 x
    512 x 2048 archive costs a warm-DB run seconds."""
    import os
    import tempfile

    from ..io.fitsio import get_hdu, read_fits
    from ..pipeline.toas import _is_metafile, _read_metafile
    from ..tune import shape_class_for, tuned_config

    datafiles = args.datafiles
    if isinstance(datafiles, str):
        datafiles = (_read_metafile(datafiles)
                     if _is_metafile(datafiles) else [datafiles])
    first = datafiles[0]
    sub = get_hdu(read_fits(first, defer=("DATA",)), "SUBINT").header
    shape_class = shape_class_for(sub["NCHAN"], sub["NBIN"])
    tim = os.path.join(tempfile.mkdtemp(prefix="ppt_tune_"), "probe.tim")

    def run_fn(overrides):
        from ..pipeline.stream import (stream_narrowband_TOAs,
                                       stream_wideband_TOAs)

        stream = (stream_narrowband_TOAs if args.narrowband
                  else stream_wideband_TOAs)
        with tuned_config(overrides):
            stream([first], args.modelfile, tscrunch=args.tscrunch,
                   tim_out=tim, quiet=True, device=args.device)
        with open(tim, "rb") as fh:
            return fh.read()

    return run_fn, shape_class


def _apply_autotune(args):
    """Resolve the tuned knob winners before the campaign (--autotune /
    --tune-db): stored winners of this card's fingerprint apply
    directly; with --autotune and no stored entry the output-identical
    tier is swept on the first archive and the winners persisted.

    Returns ``(tracer, owned)``.  With tuning active and a trace asked
    for, ONE tracer is resolved here, so the tune_probe / tune_apply
    events land in the trace the campaign writes; the caller hands the
    lane the tracer object and closes it after."""
    from .. import config
    from ..telemetry import NULL_TRACER, resolve_tracer

    if args.tune_db is not None:
        config.tune_db = args.tune_db
    if args.autotune:
        config.autotune = True
    if not (config.autotune or config.tune_db):
        return NULL_TRACER, False
    tracer, owned = resolve_tracer(args.telemetry, run="pptoas")
    if config.autotune:
        from ..tune import ensure_tuned

        run_fn, shape_class = _tune_workload(args)
        ensure_tuned(run_fn, shape_class, tracer=tracer, device=args.device)
    else:
        # --tune-db alone applies stored winners and never sweeps: a
        # cold or foreign DB is a no-op (the store warns)
        from ..tune import apply_from_db

        apply_from_db(tracer=tracer, device=args.device)
    return tracer, owned


def _run_stream_narrowband(args, addtnl, stream_devices, scat_guess):
    """pptoas --stream --narrowband: per-channel TOAs over every archive
    named."""
    from ..io.tim import write_princeton_TOAs, write_TOAs
    from ..pipeline.stream import stream_narrowband_TOAs

    res = stream_narrowband_TOAs(
        args.datafiles, args.modelfile, fit_scat=args.fit_scat,
        log10_tau=args.log10_tau, scat_guess=scat_guess,
        tscrunch=args.tscrunch, stream_devices=stream_devices,
        device=args.device, pipeline_depth=args.pipeline_depth,
        print_phase=args.print_phase, addtnl_toa_flags=addtnl,
        telemetry=args.telemetry, quiet=args.quiet)
    if args.format == "princeton":
        write_princeton_TOAs(res.TOA_list, outfile=args.outfile,
                             dDMs=[0.0] * len(res.TOA_list))
    else:
        write_TOAs(res.TOA_list, SNR_cutoff=args.snr_cutoff,
                   outfile=args.outfile, append=True)
    return 0


def _run_stream(args, nu_ref_DM, addtnl, stream_devices, scat_guess):
    """pptoas --stream: the campaign lane over every archive named."""
    from ..io.tim import write_princeton_TOAs, write_TOAs
    from ..pipeline.stream import stream_wideband_TOAs

    res = stream_wideband_TOAs(
        args.datafiles, args.modelfile, fit_DM=args.fit_DM,
        fit_GM=args.fit_GM, print_flux=args.print_flux,
        print_phase=args.print_phase, nu_ref_DM=nu_ref_DM,
        nu_ref_tau=args.nu_ref_tau, DM0=args.DM0, bary=args.bary,
        tscrunch=args.tscrunch, fit_scat=args.fit_scat,
        log10_tau=args.log10_tau, scat_guess=scat_guess,
        fix_alpha=args.fix_alpha, addtnl_toa_flags=addtnl,
        stream_devices=stream_devices, device=args.device,
        pipeline_depth=args.pipeline_depth, telemetry=args.telemetry,
        quality_flags=args.quality_flags, quiet=args.quiet)
    if args.format == "princeton":
        dDMs = [toa.DM - res.DM0s[res.order.index(toa.archive)]
                if toa.DM is not None else 0.0 for toa in res.TOA_list]
        write_princeton_TOAs(res.TOA_list, outfile=args.outfile, dDMs=dDMs)
        if args.errfile:
            with open(args.errfile, "a") as f:
                for toa in res.TOA_list:
                    if toa.DM_error is not None:
                        f.write(f"{toa.DM_error:.5e}\n")
    else:
        write_TOAs(res.TOA_list, SNR_cutoff=args.snr_cutoff,
                   outfile=args.outfile, append=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
