"""ppspline: build a PCA + B-spline model on a CUDA device (counterpart
of pulseportraiture_tpu/cli/ppspline.py).

    python -m pulseportraiture_tpu_torch.cli.ppspline -d avg.fits \\
        [-o out.spl] [-l name] [-a model.fits] [-N prof|None|mean|max|rms|abs] \\
        [-s] [-n max_ncomp] [-S snr] [-T rchi2_tol] [-k degree] [-f sfac] \\
        [-t knots] [--gauss-device off|auto|on] [--device cuda|cpu] [--quiet]

Flag parity: reference ppspline.py:291-397 (default norm 'prof', one
phase-shift fit per channel).  With -s, --gauss-device smooths the mean
profile by the template factory's Gaussian fit
(pipeline/factory.gauss_smooth_mean), as the JAX CLI does.  --plots
saves the eigenprofile and spline-projection figures next to the model
(viz/, needs matplotlib).  The output .spl is a template for ``pptoas
-m``.
"""

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppspline", description=__doc__.splitlines()[0])
    p.add_argument("-d", "--datafile", required=True,
                   help="PSRFITS archive (an averaged portrait).")
    p.add_argument("-o", "--modelfile", default=None,
                   help="Output model file name. [default=<datafile>.spl]")
    p.add_argument("-l", "--model_name", default=None)
    p.add_argument("-a", "--archive", default=None,
                   help="Also write the model reconstruction as a PSRFITS "
                        "archive with this name.")
    p.add_argument("-N", "--norm", default="prof",
                   choices=("None", "mean", "max", "prof", "rms", "abs"))
    p.add_argument("-s", "--smooth", action="store_true", default=False,
                   help="Wavelet-smooth the eigenvectors and mean.")
    p.add_argument("-n", "--max_ncomp", type=int, default=10)
    p.add_argument("-S", "--snr", dest="snr_cutoff", type=float,
                   default=150.0)
    p.add_argument("-T", "--rchi2_tol", type=float, default=0.1)
    p.add_argument("-k", "--degree", dest="k", type=int, default=3)
    p.add_argument("-f", "--sfac", type=float, default=1.0)
    p.add_argument("-t", "--knots", dest="max_nbreak", type=int,
                   default=None)
    p.add_argument("--plots", dest="make_plots", action="store_true",
                   default=False,
                   help="Save eigenprofile and spline-projection plots.")
    p.add_argument("--gauss-device", default=None,
                   help="With -s: smooth the MEAN profile by the template "
                        "factory's Gaussian fit instead of wavelets — "
                        "'off' (serial) | 'auto' | 'on' (batched) "
                        "engine; eigenprofiles keep wavelet smoothing. "
                        "[default: wavelet mean smoothing]")
    p.add_argument("--device", default="cuda",
                   help="torch device the model is built on. "
                        "[default=cuda]")
    p.add_argument("--quiet", action="store_true", default=False)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    gauss_device = None
    if args.gauss_device is not None:
        from .ppfactory import parse_gauss_device

        gauss_device = parse_gauss_device(args.gauss_device)
        if not args.smooth:
            # the flag selects the MEAN-smoothing lane, which only
            # exists under -s/--smooth: exit rather than smooth nothing
            raise SystemExit("--gauss-device requires -s/--smooth "
                             "(it selects the lane that smooths the "
                             "mean profile)")
    from ..device import resolve_device
    from ..pipeline.portrait import reset_template_stats
    from ..pipeline.spline import SplinePortrait

    dev = resolve_device(args.device)
    reset_template_stats()
    dp = SplinePortrait(args.datafile, quiet=args.quiet, device=dev)
    if args.norm and args.norm != "None":
        dp.normalize_portrait(args.norm)
    smooth_mean = None
    if args.gauss_device is not None:
        from ..pipeline.factory import gauss_smooth_mean

        smooth_mean = gauss_smooth_mean(dp, rchi2_tol=args.rchi2_tol,
                                        gauss_device=gauss_device)
    dp.make_spline_model(
        max_ncomp=args.max_ncomp, smooth=args.smooth,
        snr_cutoff=args.snr_cutoff, rchi2_tol=args.rchi2_tol, k=args.k,
        sfac=args.sfac, max_nbreak=args.max_nbreak,
        model_name=args.model_name, smooth_mean_prof=smooth_mean,
        quiet=args.quiet)
    outfile = args.modelfile or (args.datafile + ".spl")
    dp.write_model(outfile, quiet=args.quiet)
    if args.archive:
        dp.write_model_archive(args.archive, quiet=args.quiet)
    if args.make_plots:
        dp.show_eigenprofiles(show=False, savefig=outfile + ".eigen.png")
        if dp.ncomp:
            # writes <outfile>.proj.png and <outfile>.freq.png (the
            # reference's savefig convention)
            dp.show_spline_curve_projections(show=False, savefig=outfile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
