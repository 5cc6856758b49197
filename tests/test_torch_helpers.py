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
