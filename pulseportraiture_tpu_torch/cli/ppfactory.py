"""ppfactory: build templates for a whole fleet of pulsars on a CUDA
device, batching the Gaussian/spline LM fits across archives
(pipeline/factory.py; counterpart of
pulseportraiture_tpu/cli/ppfactory.py).  One archive per line in the
metafile, one template out per archive (this is NOT ppgauss's JOIN
metafile mode — multi-receiver fits keep ppgauss).

    python -m pulseportraiture_tpu_torch.cli.ppfactory -M fleet.txt \\
        [-O outdir] [--kind gauss|spline] [--max-ngauss N] [--niter n] \\
        [--mcode 000] [--fitloc] [--fixwid] [--fixamp] [--fitscat] \\
        [--fitalpha] [--norm prof] [--gauss-device off|auto|on] \\
        [--lm-jacobian auto|analytic|ad] [--device cuda|cpu] [--verbose]

Flag parity with the JAX CLI plus --device.  --telemetry writes the
factory's template_fit/template_job/factory_end events to a JSONL trace.
With the result cache on (--result-cache on|auto with --cache-dir, or
config.result_cache / cache_dir), each archive's built .gmodel/.spl is
stored in serve/cache's content-addressed store under
content_key([archive], the factory option vector), the JAX ppfactory's
key: a hit writes the stored bytes (temp file, then os.replace) and
skips that archive's build.  A blob either package stored serves the
other.
"""

import argparse
import os
import sys

from .ppserve import add_cache_flags, apply_cache_flags

GAUSS_DEVICE_CHOICES = ("off", "auto", "on")
_GAUSS_DEVICE_TABLE = {"off": False, "auto": "auto", "on": True}
LM_JACOBIAN_CHOICES = ("auto", "analytic", "ad")


def parse_gauss_device(value, error=None):
    """Strict --gauss-device parse shared by ppfactory/ppgauss/
    ppspline: 'off' | 'auto' | 'on' -> the config tri-state value;
    anything else exits before any file I/O.  error: accepted for the
    JAX package's signature and unused there too (the exit carries the
    message)."""
    v = str(value).lower()
    if v not in _GAUSS_DEVICE_TABLE:
        raise SystemExit(f"--gauss-device expected one of "
                         f"{'/'.join(GAUSS_DEVICE_CHOICES)}, got "
                         f"{value!r}")
    return _GAUSS_DEVICE_TABLE[v]


def parse_lm_jacobian(value, error=None):
    """Strict --lm-jacobian parse shared by ppfactory/ppgauss:
    'auto' | 'analytic' | 'ad' -> config.lm_jacobian; anything else
    exits before any file I/O.  error: as parse_gauss_device's."""
    v = str(value).lower()
    if v not in LM_JACOBIAN_CHOICES:
        raise SystemExit(f"--lm-jacobian expected one of "
                         f"{'/'.join(LM_JACOBIAN_CHOICES)}, got "
                         f"{value!r}")
    return v


def apply_lm_jacobian(value):
    """Apply a parsed --lm-jacobian to config (read by the LM per call,
    so setting the module value routes every LM fit of this process)."""
    if value is None:
        return None
    from .. import config

    config.lm_jacobian = parse_lm_jacobian(value)
    return config.lm_jacobian


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppfactory", description=__doc__.splitlines()[0])
    p.add_argument("-M", "--metafile", required=True,
                   help="Metafile: one archive per line, one template "
                        "per archive.")
    p.add_argument("-O", "--outdir", default=None,
                   help="Directory for the output model files "
                        "[default: next to each archive].")
    p.add_argument("--kind", default="gauss",
                   choices=("gauss", "spline"),
                   help="Template type for every job.")
    p.add_argument("--max-ngauss", type=int, default=8,
                   help="Trial component counts 1..N fit per pulsar "
                        "in one breadth-first call.")
    p.add_argument("--niter", type=int, default=0,
                   help="Portrait iterations after the initial fit.")
    p.add_argument("--mcode", dest="model_code", default="000",
                   help="Three-digit evolution-function code.")
    p.add_argument("--fitloc", dest="fixloc", action="store_false",
                   default=True, help="Let component positions evolve.")
    p.add_argument("--fixwid", action="store_true", default=False)
    p.add_argument("--fixamp", action="store_true", default=False)
    p.add_argument("--fitscat", dest="fixscat", action="store_false",
                   default=True, help="Fit a scattering timescale.")
    p.add_argument("--fitalpha", dest="fixalpha", action="store_false",
                   default=True, help="Fit the scattering index.")
    p.add_argument("--norm", dest="normalize", default=None,
                   choices=(None, "mean", "max", "prof", "rms", "abs"))
    p.add_argument("--gauss-device", default=None,
                   help="LM lane: 'off' (serial oracle), 'auto' "
                        "(batched on CUDA devices), 'on' (force batched) "
                        "[default: config.gauss_device].")
    p.add_argument("--lm-jacobian", dest="lm_jacobian", default=None,
                   help="LM Jacobian source: 'auto' (analytic when the "
                        "model provides one), 'analytic' (require it), "
                        "'ad' (torch.func.jacfwd, the oracle) "
                        "[default: config.lm_jacobian].")
    p.add_argument("--telemetry", default=None,
                   help="Write a JSONL event trace (template_fit per "
                        "bucket dispatch, template_job, factory_end).")
    add_cache_flags(p)
    p.add_argument("--device", default="cuda",
                   help="torch device the fits run on. [default=cuda]")
    p.add_argument("--verbose", dest="quiet", action="store_false",
                   default=True)
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    gauss_device = None
    if args.gauss_device is not None:
        gauss_device = parse_gauss_device(args.gauss_device)
    apply_lm_jacobian(args.lm_jacobian)
    if args.max_ngauss < 1:
        raise SystemExit(f"--max-ngauss must be >= 1, got "
                         f"{args.max_ngauss}")
    if args.niter < 0:
        raise SystemExit(f"--niter must be >= 0, got {args.niter}")
    if not os.path.exists(args.metafile):
        raise SystemExit(f"ppfactory: metafile not found: "
                         f"{args.metafile}")
    from ..pipeline.toas import _read_metafile

    files = _read_metafile(args.metafile)
    if not files:
        raise SystemExit(f"ppfactory: no archives listed in "
                         f"{args.metafile}")
    from ..device import resolve_device
    from ..pipeline.factory import build_templates
    from ..pipeline.portrait import reset_template_stats
    from ..serve.cache import content_key, resolve_result_cache

    dev = resolve_device(args.device)
    apply_cache_flags(args, "ppfactory")
    cache = resolve_result_cache()
    # the JAX ppfactory's option vector, field for field: any flag
    # change is a new key
    factory_opts = dict(
        kind=args.kind, max_ngauss=args.max_ngauss, niter=args.niter,
        model_code=args.model_code, fixloc=args.fixloc,
        fixwid=args.fixwid, fixamp=args.fixamp, fixscat=args.fixscat,
        fixalpha=args.fixalpha, normalize=args.normalize,
        gauss_device=gauss_device)
    ext = ".gmodel" if args.kind == "gauss" else ".spl"

    def outfile_for(f):
        # build_templates' own derivation
        if args.outdir:
            return os.path.join(args.outdir, os.path.basename(f) + ext)
        return f + ext

    build, keys, n_hits = list(files), {}, 0
    if cache is not None:
        if args.outdir:
            os.makedirs(args.outdir, exist_ok=True)
        build = []
        for f in files:
            try:
                keys[f] = content_key([f], factory_opts)
            except OSError:
                keys[f] = None  # unreadable: the build reports it
            blob = cache.get_blob(keys[f]) if keys[f] else None
            if blob is None:
                build.append(f)
                continue
            out = outfile_for(f)
            tmp = out + ".tmp~"
            with open(tmp, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, out)
            n_hits += 1
    reset_template_stats()
    if build:
        build_templates(
            build, kind=args.kind, outdir=args.outdir,
            max_ngauss=args.max_ngauss, niter=args.niter,
            model_code=args.model_code, fixloc=args.fixloc,
            fixwid=args.fixwid, fixamp=args.fixamp, fixscat=args.fixscat,
            fixalpha=args.fixalpha, normalize=args.normalize,
            gauss_device=gauss_device, telemetry=args.telemetry,
            quiet=args.quiet, device=dev)
    if cache is not None:
        for f in build:
            out = outfile_for(f)
            if keys.get(f) and os.path.exists(out):
                with open(out, "rb") as fh:
                    cache.put_blob(keys[f], fh.read())
        if not args.quiet:
            print(f"ppfactory: {n_hits}/{len(files)} template(s) "
                  "served from the result cache")
    return 0


if __name__ == "__main__":
    sys.exit(main())
