"""Multi-process campaign helpers at world size 1 (counterpart of
pulseportraiture_tpu/parallel/multihost.py).

Per-(archive, subint) fits are independent, so a campaign spreads over
processes by dealing its files round-robin (:func:`shard_files`) and
gathering only small per-pulsar summaries (:func:`process_allgather`).
The port runs these at one process: with no ``torch.distributed``
process group, or one of world size 1, every helper returns the JAX
package's single-process answer.  A process group of world size above 1
raises NotImplementedError naming ROADMAP A12 (scale-out): the sharded
campaign is not ported, and running silently as rank 0 of 1 would
repeat the whole campaign on every process.
"""

import numpy as np

__all__ = ["process_count", "process_index", "shard_files",
           "process_allgather"]


def _world():
    """(rank, world size) of this process: (0, 1) without a process
    group; NotImplementedError for a world size above 1."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    n = dist.get_world_size()
    if n > 1:
        raise NotImplementedError(
            f"torch.distributed is initialized with world size {n}: "
            "multi-process campaigns are not ported yet (ROADMAP A12)")
    return dist.get_rank(), n


def process_count():
    return _world()[1]


def process_index():
    return _world()[0]


def shard_files(datafiles, index=None, count=None):
    """This process's round-robin slice of a campaign file list
    (round-robin balances heterogeneous archive sizes without knowing
    them).  index/count default to this process's; explicit values
    give any process's slice."""
    if index is None or count is None:
        rank, world = _world()
        index = rank if index is None else index
        count = world if count is None else count
    return list(datafiles)[int(index)::int(count)]


def process_allgather(x):
    """Every process's small 1-D array, as a list (ragged lengths
    allowed).  At one process: [x] as float64."""
    x = np.atleast_1d(np.asarray(x, np.float64))
    _world()
    return [x]
