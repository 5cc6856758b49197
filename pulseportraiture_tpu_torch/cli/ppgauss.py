"""ppgauss: fit an evolving Gaussian-component model on a CUDA device
(counterpart of pulseportraiture_tpu/cli/ppgauss.py).

    python -m pulseportraiture_tpu_torch.cli.ppgauss -d avg.fits \\
        [-M join.meta] [-I start.gmodel] [-o out.gmodel] [-e out.errs] \\
        [-j joinfile] [--niter n] [--fitloc] [--fixwid] [--fixamp] \\
        [--fitscat] [--fitalpha] [--mcode 000] [--fgauss] [--autogauss w] \\
        [--norm prof] [--max-ngauss N] [--gauss-device off|auto|on] \\
        [--lm-jacobian auto|analytic|ad] [--device cuda|cpu] [--verbose]

Flag parity: reference ppgauss.py:666-812.  --batch -M fleet.txt builds
one template per archive through the template factory
(pipeline/factory.py), as the JAX CLI does.  --figure saves the data /
model / residual figure (viz/, needs matplotlib).  The output .gmodel is
a template for ``pptoas -m``.
"""

import argparse
import sys

def build_parser():
    p = argparse.ArgumentParser(
        prog="ppgauss", description=__doc__.splitlines()[0])
    p.add_argument("-d", "--datafile", default=None,
                   help="PSRFITS archive to fit.")
    p.add_argument("-M", "--metafile", default=None,
                   help="Metafile of archives (JOIN fit across receivers).")
    p.add_argument("-I", "--improve", dest="modelfile", default=None,
                   help="Start from an existing .gmodel and improve it.")
    p.add_argument("-o", "--outfile", default=None,
                   help="Output model file name.")
    p.add_argument("-e", "--errfile", default=None,
                   help="Output parameter-error file name.")
    p.add_argument("-j", "--joinfile", default=None,
                   help="Joinfile with previously fitted JOIN parameters.")
    p.add_argument("-m", "--model_name", default=None)
    p.add_argument("--nu_ref", type=float, default=None,
                   help="Reference frequency [MHz] of the model.")
    p.add_argument("--bw", dest="bw_ref", type=float, default=None,
                   help="Bandwidth [MHz] of the reference profile slice.")
    p.add_argument("--tau", type=float, default=0.0,
                   help="Scattering timescale [bin].")
    p.add_argument("--fitloc", dest="fixloc", action="store_false",
                   default=True, help="Let component positions evolve.")
    p.add_argument("--fixwid", action="store_true", default=False,
                   help="Do not let widths evolve.")
    p.add_argument("--fixamp", action="store_true", default=False,
                   help="Do not let amplitudes evolve.")
    p.add_argument("--fitscat", dest="fixscat", action="store_false",
                   default=True, help="Fit a scattering timescale.")
    p.add_argument("--fitalpha", dest="fixalpha", action="store_false",
                   default=True, help="Fit the scattering index.")
    p.add_argument("--mcode", dest="model_code", default="000",
                   help="Three-digit evolution-function code.")
    p.add_argument("--niter", type=int, default=0,
                   help="Number of iterations after the initial fit.")
    p.add_argument("--fgauss", action="store_true", default=False,
                   help="Fix the first component as fiducial.")
    p.add_argument("--autogauss", dest="auto_gauss", type=float,
                   default=0.0,
                   help="Initial width [rot] of the trial components of "
                        "the automatic profile fit. [default=0.02]")
    p.add_argument("--norm", dest="normalize", default=None,
                   choices=(None, "mean", "max", "prof", "rms", "abs"))
    p.add_argument("--figure", default=False,
                   help="Save a residual plot to this file name.")
    p.add_argument("--batch", action="store_true", default=False,
                   help="Fleet mode: one template per archive of -M "
                        "(the template factory, batched across "
                        "archives).")
    p.add_argument("--max-ngauss", dest="max_ngauss", type=int,
                   default=8,
                   help="Trial component counts 1..N for the "
                        "breadth-first auto profile fit.")
    p.add_argument("--gauss-device", default=None,
                   help="LM lane of the profile trials: 'off' (serial, "
                        "one trial at a time), 'auto' (batched on CUDA "
                        "devices), 'on' (batched) [default: "
                        "config.gauss_device / PPT_GAUSS_DEVICE].")
    p.add_argument("--lm-jacobian", dest="lm_jacobian", default=None,
                   help="LM Jacobian source: 'auto' (analytic when the "
                        "model provides one), 'analytic' (require it), "
                        "'ad' (torch.func.jacfwd, the oracle) [default: "
                        "config.lm_jacobian / PPT_LM_JACOBIAN].")
    p.add_argument("--device", default="cuda",
                   help="torch device the fits run on. [default=cuda]")
    p.add_argument("--verbose", dest="quiet", action="store_false",
                   default=True)
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.datafile and not args.metafile:
        parser.error("need -d datafile or -M metafile")
    from .ppfactory import apply_lm_jacobian, parse_gauss_device

    gauss_device = None
    if args.gauss_device is not None:
        gauss_device = parse_gauss_device(args.gauss_device)
    apply_lm_jacobian(args.lm_jacobian)
    if args.max_ngauss < 1:
        raise SystemExit(f"--max-ngauss must be >= 1, got "
                         f"{args.max_ngauss}")
    if args.batch:
        return _batch(args, gauss_device)
    from ..device import resolve_device
    from ..pipeline.gauss import GaussPortrait
    from ..pipeline.portrait import reset_template_stats

    dev = resolve_device(args.device)
    reset_template_stats()
    datafile = args.metafile or args.datafile
    dp = GaussPortrait(datafile, joinfile=args.joinfile, quiet=args.quiet,
                       device=dev)
    if args.normalize:
        dp.normalize_portrait(args.normalize)
    dp.make_gaussian_model(
        modelfile=args.modelfile, ref_prof=(args.nu_ref, args.bw_ref),
        tau=args.tau, fixloc=args.fixloc, fixwid=args.fixwid,
        fixamp=args.fixamp, fixscat=args.fixscat, fixalpha=args.fixalpha,
        model_code=args.model_code, niter=args.niter,
        fiducial_gaussian=args.fgauss, auto_gauss=args.auto_gauss,
        writemodel=True, outfile=args.outfile or (datafile + ".gmodel"),
        writeerrfile=bool(args.errfile), errfile=args.errfile,
        model_name=args.model_name, residplot=args.figure or None,
        gauss_device=gauss_device, max_ngauss=args.max_ngauss,
        quiet=args.quiet)
    return 0


def _batch(args, gauss_device):
    """--batch: one template per archive of -M through the template
    factory; options the factory does not take exit rather than being
    dropped (each model is named per archive; JOIN/improve/reference-
    slice modes keep the single-archive mode)."""
    if not args.metafile:
        raise SystemExit("--batch requires -M metafile (one "
                         "archive per line)")
    for flag, val in (("-I/--improve", args.modelfile),
                      ("-o/--outfile", args.outfile),
                      ("-e/--errfile", args.errfile),
                      ("-j/--joinfile", args.joinfile),
                      ("-m/--model_name", args.model_name),
                      ("--nu_ref", args.nu_ref),
                      ("--bw", args.bw_ref),
                      ("--figure", args.figure or None)):
        if val is not None:
            raise SystemExit(
                f"{flag} is not supported with --batch (models "
                "are named per archive; use ppfactory -O for an "
                "output directory, or the single-archive mode)")
    from ..device import resolve_device
    from ..pipeline.factory import build_templates
    from ..pipeline.portrait import reset_template_stats
    from ..pipeline.toas import _read_metafile

    dev = resolve_device(args.device)
    reset_template_stats()
    build_templates(
        _read_metafile(args.metafile), kind="gauss",
        max_ngauss=args.max_ngauss, wid0=args.auto_gauss or 0.02,
        tau=args.tau, fixloc=args.fixloc, fixwid=args.fixwid,
        fixamp=args.fixamp, fixscat=args.fixscat, fixalpha=args.fixalpha,
        model_code=args.model_code, niter=args.niter,
        fiducial_gaussian=args.fgauss, normalize=args.normalize,
        gauss_device=gauss_device, quiet=args.quiet, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
