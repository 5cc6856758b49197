"""Shared helpers of the PyTorch port's parity tests (test_torch_*.py).

Importing this module pins torch to one intra-op thread: the suite runs
under several pytest-xdist workers, and torch's default thread pool per
worker would oversubscribe the host.  No tests live here.
"""

import contextlib
import json
from collections import Counter

import numpy as np
import torch

torch.set_num_threads(1)

# the pulsar of tests/test_pipeline_toas.py
PAR = {"PSR": "J1744-1134", "RAJ": "17:44:29.4", "DECJ": "-11:34:54.6",
       "P0": 0.004074, "PEPOCH": 55000.0, "DM": 3.139}


# the scale-out tests' batch: SCALE_NB subints fitted with a
# SCALE_K-harmonic window at 256 bins
SCALE_NB, SCALE_K, SCALE_P0 = 8, 128, 0.004074


def make_sharded_batch(seed=7, nb=SCALE_NB, nchan=16, nbin=256, tau=None):
    """The scale-out tests' batch (test_torch_parallel.py,
    test_torch_multiprocess.py): noisy dispersed portraits of the default
    model (injected phi and DM per subint, scattered when tau is given)
    against its clean template; channel 3 masked.  Returns (ports,
    model, noise, freqs, masks)."""
    from pulseportraiture_tpu_torch.config import Dconst
    from pulseportraiture_tpu_torch.io.gmodel import gen_gmodel_portrait
    from pulseportraiture_tpu_torch.synth import default_test_model

    rng = np.random.default_rng(seed)
    freqs = np.linspace(1150.0, 1850.0, nchan)
    model = gen_gmodel_portrait(default_test_model(1500.0), np.arange(nbin),
                                freqs, device="cpu")
    k = np.arange(nbin // 2 + 1)
    ports = np.empty((nb, nchan, nbin))
    for b in range(nb):
        t = 0.01 * b - 0.03 + Dconst * 3e-4 * (b - 4) / SCALE_P0 * (
            freqs**-2 - 1500.0**-2)
        spec = np.fft.rfft(model, axis=-1) * np.exp(-2j * np.pi * k
                                                     * t[:, None])
        if tau is not None:
            tn = tau * (freqs / 1500.0) ** -4.0
            spec = spec / (1.0 + 2j * np.pi * tn[:, None] * k)
        ports[b] = np.fft.irfft(spec, n=nbin, axis=-1)
    noise = np.full((nb, nchan), 0.2)
    ports += noise[..., None] * rng.standard_normal(ports.shape)
    masks = np.ones((nb, nchan))
    masks[:, 3] = 0.0
    return ports, model, noise, freqs, masks


SCALE_TAU = 0.004


def scale_inputs(name):
    """The batch and keywords of scale_calls' call ``name``: the fast
    and align calls on make_sharded_batch(), the scattering lane on a
    scattered one (tau, phi and DM free, log10 tau seeded at half a
    bin), the complex engine on seed 8's with per-subint templates.
    Returns (ports, models, noise, freqs, masks, keywords)."""
    ports, model, noise, freqs, masks = make_sharded_batch(
        seed=8 if name.startswith("complex") else 7,
        tau=SCALE_TAU if name.startswith("scat") else None)
    kw = {}
    if name.startswith("scat"):
        nb, _, nbin = ports.shape
        th0 = np.zeros((nb, 5))
        th0[:, 3] = np.log10(0.5 / nbin)
        th0[:, 4] = -4.0
        kw = dict(theta0=th0, log10_tau=True, max_iter=60,
                  fit_flags=(True, True, False, True, False))
    if name.startswith("complex"):
        model = np.broadcast_to(model, ports.shape).copy()
    return ports, model, noise, freqs, masks, kw


def scale_calls(P, FitFlags, asarray=np.asarray):
    """The scale-out calls of test_torch_multiprocess.py: (name, n_data,
    n_chan, call(mesh)), the 1 x 2 ones with shard_channels=True, through
    the parallel package P with its FitFlags and array constructor (the
    port's, or the JAX package's with jnp.asarray).  A call on a 1 x 1
    mesh is its world-size-1 reference."""
    def inputs(name):
        *arrays, kw = scale_inputs(name)
        if "fit_flags" in kw:
            kw["fit_flags"] = FitFlags(*kw["fit_flags"])
        return [asarray(a) for a in arrays], kw

    def fast(name, **extra):
        def call(mesh):
            (ports, model, noise, freqs, masks), kw = inputs(name)
            return P.fit_portrait_sharded_fast(
                mesh, ports, model, noise, freqs, SCALE_P0, 1500.0,
                chan_masks=masks, **kw, **extra)
        return call

    def complex_(mesh):
        (ports, model, noise, freqs, _), _ = inputs("complex")
        return P.fit_portrait_sharded(mesh, ports, model, noise, freqs,
                                      SCALE_P0, 1500.0, shard_channels=True)

    def align(**extra):
        def call(mesh):
            (ports, model, noise, freqs, masks), _ = inputs("align")
            return P.align_iteration_sharded(mesh, ports, model, noise,
                                             masks, freqs, SCALE_P0,
                                             **extra)
        return call

    chan = dict(shard_channels=True)
    return [("fit_2x1", 2, 1, fast("fit")),
            ("fit_1x2", 1, 2, fast("fit", **chan)),
            ("scat_1x2", 1, 2, fast("scat", **chan)),
            ("complex_1x2", 1, 2, complex_),
            ("align_2x1", 2, 1, align()),
            ("align_1x2", 1, 2, align(**chan))]


def trace_events(path):
    """The events of a JSONL trace (its first record, the manifest,
    dropped)."""
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()][1:]


def event_counts(path):
    """Event type -> count of a JSONL trace."""
    return Counter(ev["type"] for ev in trace_events(path))


def rel_err(got, ref):
    """max |got - ref| / max |ref| over a pair of arrays."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                  1e-300))


def tol_for(dtype):
    """The parity tolerance (relative to max |ref|) of a dtype: f64 1e-12
    (two frameworks' summation orders differ), f32 1e-5 (the JAX and
    torch matmuls differ by ~3e-5 absolute at unit inputs, measured)."""
    return 1e-12 if str(dtype).endswith("float64") else 1e-5


@contextlib.contextmanager
def saved_figures():
    """Under the Agg backend, collect every matplotlib Figure saved
    (Figure.savefig) inside the block: yields the list they land in."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    from matplotlib.figure import Figure

    figs = []
    save = Figure.savefig

    def spy(fig, *args, **kwargs):
        figs.append(fig)
        return save(fig, *args, **kwargs)

    Figure.savefig = spy
    try:
        yield figs
    finally:
        Figure.savefig = save


def image_arrays(fig):
    """The image arrays of a figure's axes, in axes order (float64)."""
    return [np.asarray(im.get_array(), np.float64)
            for ax in fig.axes for im in ax.get_images()]
