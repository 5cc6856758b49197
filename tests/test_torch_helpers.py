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
