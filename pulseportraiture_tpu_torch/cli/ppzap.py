"""ppzap: propose (and optionally apply) channel zaps, on a CUDA device
(counterpart of pulseportraiture_tpu/cli/ppzap.py).

    python -m pulseportraiture_tpu_torch.cli.ppzap -d archive.fits \\
        [-m model.gmodel] [-o paz.sh] [--apply] [--zap-device off|auto|on] \\
        [--device cuda|cpu]

Flag parity: reference ppzap.py:107-253.  The model-based path (-m) runs
GetTOAs and flags channels by reduced chi^2 / S-N
(GetTOAs.get_channels_to_zap); the model-less path runs the iterative
median algorithm on the channels' noise levels (pipeline/zap).  Beyond
the reference, --apply edits the archive weights directly, and
--telemetry writes the proposals' ``zap_propose`` and the applied zaps'
``zap_apply`` events to a JSONL trace.  --hist (model path) saves a
histogram of the fits' reduced chi^2 as <datafiles>.rchi2.png (needs
matplotlib).
"""

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppzap", description=__doc__.splitlines()[0])
    p.add_argument("-d", "--datafiles", required=True,
                   help="PSRFITS archive or metafile of archive names.")
    p.add_argument("-n", "--num_std", dest="nstd", type=float,
                   default=None,
                   help="Threshold [std] for the median algorithm "
                        "(default: config.zap_nstd / PPT_ZAP_NSTD).")
    p.add_argument("-N", "--norm", default=None,
                   choices=(None, "mean", "max", "prof", "rms", "abs"),
                   help="Normalize before the median algorithm.")
    p.add_argument("-m", "--modelfile", default=None,
                   help="Model file: use the fit-based zapping path.")
    p.add_argument("-T", "--tscrunch", action="store_true", default=False)
    p.add_argument("-S", "--SNR-threshold", dest="SNR_threshold",
                   type=float, default=8.0)
    p.add_argument("-R", "--rchi2-threshold", dest="rchi2_threshold",
                   type=float, default=1.3)
    p.add_argument("-o", "--outfile", default=None,
                   help="Write the paz commands to this file.")
    p.add_argument("--append", action="store_true", default=False,
                   help="Append to --outfile instead of overwriting.")
    p.add_argument("--modify", action="store_true", default=False,
                   help="Print paz -m (modify in place) commands.")
    p.add_argument("--apply", action="store_true", default=False,
                   help="Apply the zaps directly to the archives "
                        "(weight edits; no PSRCHIVE needed).")
    p.add_argument("--hist", action="store_true", default=False,
                   help="Save a channel red-chi2 histogram (model path).")
    p.add_argument("--zap-device", default=None,
                   choices=("off", "auto", "on"),
                   help="Run the zap cut as the batched torch program on "
                        "--device (default: config.zap_device / "
                        "PPT_ZAP_DEVICE, 'auto' = on CUDA devices; the "
                        "flagged lists are the same either way).")
    p.add_argument("--telemetry", metavar="trace.jsonl", default=None,
                   help="Write a JSONL trace of the zap proposals and "
                        "applications (default: PPT_TELEMETRY / "
                        "config.telemetry_path; read it with pptrace).")
    p.add_argument("--device", default="cuda",
                   help="torch device the fits and the device lane run "
                        "on. [default=cuda]")
    p.add_argument("--quiet", action="store_true", default=False)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..device import resolve_device
    from ..io.psrfits import load_data, noise_std_ps
    from ..pipeline.portrait import normalize_portrait
    from ..pipeline.toas import GetTOAs, _is_metafile, _read_metafile
    from ..pipeline.zap import apply_zaps, get_zap_channels, print_paz_cmds
    from ..telemetry import resolve_tracer

    device = resolve_device(args.device)
    if _is_metafile(args.datafiles):
        datafiles = _read_metafile(args.datafiles)
    else:
        datafiles = [args.datafiles]
    zap_device = (None if args.zap_device is None else
                  {"off": False, "auto": "auto", "on": True}[args.zap_device])
    tracer, own_tracer = resolve_tracer(args.telemetry, run="ppzap")
    try:
        if args.modelfile:
            gt = GetTOAs(datafiles, args.modelfile, quiet=True, device=device)
            gt.get_TOAs(tscrunch=args.tscrunch, quiet=True)
            zap_list = gt.get_channels_to_zap(
                SNR_threshold=args.SNR_threshold,
                rchi2_threshold=args.rchi2_threshold, zap_device=zap_device,
                telemetry=tracer)
            # aligned with gt.order (the archives that fitted)
            datafiles = list(gt.order)
            if args.hist:
                _rchi2_hist(gt.red_chi2s, args.rchi2_threshold,
                            args.datafiles + ".rchi2.png")
        else:
            zap_list = []
            for path in datafiles:
                d = load_data(path, dedisperse=False, dededisperse=True,
                              tscrunch=args.tscrunch, pscrunch=True,
                              quiet=True)
                if args.norm:
                    for isub in d.ok_isubs:
                        d.subints[isub, 0] = normalize_portrait(
                            d.subints[isub, 0], args.norm, device=device)
                        d.noise_stds[isub, 0] = noise_std_ps(
                            d.subints[isub, 0])
                zap_list.append(get_zap_channels(
                    d, nstd=args.nstd, zap_device=zap_device, device=device,
                    tracer=tracer))

        total = sum(sum(len(z) for z in arch) for arch in zap_list)
        if not args.quiet:
            print(f"{total} channel entries flagged.")
        print_paz_cmds(datafiles, zap_list, modify=args.modify,
                       outfile=args.outfile, quiet=args.quiet,
                       append=args.append)
        if args.apply:
            for iarch, path in enumerate(datafiles):
                apply_zaps(path, zap_list[iarch], quiet=args.quiet,
                           tracer=tracer)
    finally:
        if own_tracer:
            tracer.close()
    return 0


def _rchi2_hist(red_chi2s, threshold, path):
    """The --hist figure: the fits' finite reduced chi^2 values with the
    cut's threshold (the JAX ppzap's)."""
    import numpy as np

    from ..viz.plots import _pyplot

    plt = _pyplot()
    vals = np.concatenate([r[np.isfinite(r)] for r in
                           (np.asarray(x).ravel() for x in red_chi2s)])
    fig, ax = plt.subplots()
    ax.hist(vals, bins=30, color="0.3")
    ax.axvline(threshold, color="r")
    ax.set_xlabel(r"red-$\chi^2$")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


if __name__ == "__main__":
    sys.exit(main())
