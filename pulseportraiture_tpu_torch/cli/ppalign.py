"""ppalign: iteratively align and average archives, on a CUDA device
(counterpart of pulseportraiture_tpu/cli/ppalign.py).

    python -m pulseportraiture_tpu_torch.cli.ppalign -M epochs.meta \\
        [-I init.fits | -g fwhm | -P] [-D] [-T] [-p] [-C snr] [-o out.fits] \\
        [-N norm] [-s] [-r rot | --place phase] [--niter n] \\
        [--align-device off|auto|on] [--device cuda|cpu] [--verbose]

Flag parity: reference ppalign.py:283-420, with the psradd/psrsmooth
subprocess steps replaced by the internal equivalents.  The output
archive (DM 0, dmc 1, unit weights) is a template for ``pptoas -m``.
"""

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppalign", description=__doc__.splitlines()[0])
    p.add_argument("-M", "--metafile", required=True,
                   help="Metafile of archives to average together.")
    p.add_argument("-I", "--init", dest="initial_guess", default=None,
                   help="Archive providing the initial alignment guess.")
    p.add_argument("-g", "--width", dest="fwhm", type=float, default=None,
                   help="Use a single-Gaussian template with this FWHM "
                        "[rot] as the initial guess.")
    p.add_argument("-D", "--no_DM", dest="fit_dm", action="store_false",
                   default=True, help="Align with phase only (no DM fit).")
    p.add_argument("-T", "--tscr", dest="tscrunch", action="store_true",
                   default=False, help="tscrunch archives first.")
    p.add_argument("-p", "--poln", dest="pscrunch", action="store_false",
                   default=True, help="Keep polarization (Stokes) data.")
    p.add_argument("-C", "--cutoff", dest="SNR_cutoff", type=float,
                   default=0.0, help="S/N cutoff for including archives.")
    p.add_argument("-o", "--outfile", default=None,
                   help="Output archive name. [default=<metafile>"
                        ".algnd.fits]")
    p.add_argument("-P", "--palign", action="store_true", default=False,
                   help="Initial template = unaligned sum of the archives "
                        "(internal psradd equivalent).")
    p.add_argument("-N", "--norm", default=None,
                   choices=(None, "mean", "max", "prof", "rms", "abs"),
                   help="Normalization applied to the final average.")
    p.add_argument("-s", "--smooth", action="store_true", default=False,
                   help="Wavelet-smooth the output average (internal "
                        "psrsmooth equivalent).")
    p.add_argument("-r", "--rot", dest="rot_phase", type=float,
                   default=0.0, help="Overall rotation of the output.")
    p.add_argument("--place", type=float, default=None,
                   help="Place the peak at this phase (overrides --rot).")
    p.add_argument("--niter", type=int, default=1,
                   help="Number of align/average iterations.")
    p.add_argument("--align-device", dest="align_device", default=None,
                   choices=("auto", "on", "off"),
                   help="Run the rotate-and-accumulate template update on "
                        "--device (split-real harmonic accumulate, float32 "
                        "on CUDA) instead of the float64 host loop.  auto "
                        "= on for CUDA devices.  [default: "
                        "config.align_device / PPT_ALIGN_DEVICE]")
    p.add_argument("--device", default="cuda",
                   help="torch device the fits and the device lane run "
                        "on. [default=cuda]")
    p.add_argument("--verbose", dest="quiet", action="store_false",
                   default=True)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..device import resolve_device
    from ..io.psrfits import read_archive
    from ..pipeline.align import (align_archives, gaussian_seed_portrait,
                                  psradd_archives, psrsmooth_archive)
    from ..pipeline.toas import _read_metafile

    dev = resolve_device(args.device)
    datafiles = _read_metafile(args.metafile)
    if args.initial_guess:
        init = args.initial_guess
    elif args.palign:
        init = psradd_archives(datafiles, quiet=True)
    elif args.fwhm:
        a0 = read_archive(datafiles[0])
        init = gaussian_seed_portrait(a0.nchan, a0.nbin, args.fwhm,
                                      device=dev)
    else:
        init = datafiles[0]
    outfile = args.outfile or (args.metafile + ".algnd.fits")
    adev = {None: None, "auto": "auto", "on": True,
            "off": False}[args.align_device]
    align_archives(datafiles, init, fit_dm=args.fit_dm,
                   tscrunch=args.tscrunch, pscrunch=args.pscrunch,
                   SNR_cutoff=args.SNR_cutoff, outfile=outfile,
                   norm=args.norm, rot_phase=args.rot_phase,
                   place=args.place, niter=args.niter, quiet=args.quiet,
                   align_device=adev, device=dev)
    if args.smooth:
        import os.path

        base, _ = os.path.splitext(outfile)
        psrsmooth_archive(outfile, base + ".sm.fits", device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
