"""Multi-process scale-out on ``torch.distributed`` (counterpart of
pulseportraiture_tpu/parallel/multihost.py).

Per-(archive, subint) fits are independent, so a campaign spreads over
processes by dealing its files round-robin (:func:`shard_files`) and
gathering only small per-pulsar summaries (:func:`process_allgather`).
Within one fit program, the rank mesh of parallel/mesh.py splits a batch
over ranks (parallel/batch.py).  One process drives one device.

Recipe (one process per GPU, or per host on the CPU):

    from pulseportraiture_tpu_torch import parallel
    parallel.init_multihost("host0:29500", num_processes=N, process_id=i)
    mine = parallel.shard_files(datafiles)          # this rank's slice
    res = stream_wideband_TOAs(mine, model, tim_out=f"part{i}.tim")
    per_rank_dms = parallel.process_allgather(res.DeltaDM_means)

Without a process group every helper gives the one-process answer.

The backend is chosen up front by one rule (:func:`select_backend`):
NCCL when the ranks use CUDA and each rank on a host has a GPU of its
own, gloo otherwise (the CPU, or several ranks sharing one card); a
``backend=`` keyword overrides it.  Nothing retries on another backend.
Gloo's ``all_gather`` takes CPU tensors only, so every collective on a
small result goes through :func:`collective_tensor` (utils/collectives.py,
shared with the fit engines), which puts it on the host under gloo and
on the rank's card under NCCL.
"""

import os
import re
import socket

import numpy as np
import torch

from ..utils.collectives import (all_gather,  # noqa: F401
                                 all_reduce_sum, collective_tensor)

__all__ = ["init_multihost", "select_backend", "process_count",
           "process_index", "shard_files", "global_mesh",
           "process_allgather", "collective_tensor"]

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")


def _dist():
    import torch.distributed as dist

    return dist


def _initialized():
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _world():
    """(rank, world size) of this process: (0, 1) without a process
    group."""
    if not _initialized():
        return 0, 1
    dist = _dist()
    return dist.get_rank(), dist.get_world_size()


def select_backend(device_type, local_world_size, local_gpus):
    """The process group's backend: 'nccl' when the ranks run on CUDA and
    each of the ``local_world_size`` ranks on a host has its own of the
    host's ``local_gpus`` cards, else 'gloo' (the CPU, or ranks sharing a
    card: NCCL refuses two ranks on one GPU)."""
    if device_type == "cuda" and 1 <= int(local_world_size) <= int(
            local_gpus):
        return "nccl"
    return "gloo"


def _env_int(*names):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v.split("(")[0].split(",")[0])
    return None


def _slurm_first_host():
    """The first host of SLURM's node list ('n[01-04],m1' -> 'n01')."""
    nl = os.environ.get("SLURM_STEP_NODELIST") or os.environ.get(
        "SLURM_NODELIST") or os.environ.get("SLURM_JOB_NODELIST")
    if not nl:
        return None
    base, _, rest = nl.partition("[")
    if "," in base or not rest:
        return base.split(",")[0]
    return base + re.split(r"[-,\]]", rest)[0]


def _cluster_env():
    """(init_method, world size, rank) of a torchrun or SLURM launch
    found in the environment, else None."""
    env = os.environ
    if all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        addr = env.get("MASTER_ADDR") or _slurm_first_host()
        if addr is None:
            raise RuntimeError("init_multihost: a SLURM launch without "
                               "MASTER_ADDR or a node list")
        port = env.get("MASTER_PORT", "29500")
        return (f"tcp://{addr}:{port}", int(env["SLURM_NTASKS"]),
                int(env["SLURM_PROCID"]))
    return None


def _local_layout(host, world, rank):
    """(ranks on this host, this rank's index among them): the launcher's
    variables when set; else every rank on this host when the
    coordinator is local, one rank per host otherwise."""
    n = _env_int("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE")
    i = _env_int("LOCAL_RANK", "SLURM_LOCALID")
    if n is None:
        local = host is None or host in _LOCAL_HOSTS or host in (
            socket.gethostname(), socket.getfqdn())
        n = world if local else 1
    if i is None:
        i = rank % max(n, 1)
    return n, i


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, **kwargs):
    """Start this process's ``torch.distributed`` process group.

    Explicit arguments (``coordinator_address`` 'host:port',
    ``num_processes``, ``process_id``) start it over
    ``tcp://host:port``; any failure raises.  With none, a launch by
    torchrun (RANK, WORLD_SIZE, MASTER_ADDR) or SLURM (SLURM_PROCID,
    SLURM_NTASKS) is detected: the group starts and True is returned,
    and a failing bootstrap raises; on a plain machine nothing starts and
    False is returned.

    Keywords: ``backend`` overrides :func:`select_backend`; ``device``
    ('cuda', the default, or 'cpu') is the device the ranks use; the rest
    go to ``init_process_group`` (``timeout=`` among them).  Under NCCL
    the rank's card becomes the current CUDA device."""
    from datetime import timedelta

    backend = kwargs.pop("backend", None)
    device = torch.device(kwargs.pop("device", None) or "cuda")
    if "timeout" in kwargs and not isinstance(kwargs["timeout"],
                                              timedelta):
        kwargs["timeout"] = timedelta(seconds=float(kwargs["timeout"]))
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        found = _cluster_env()
        if found is None:
            return False
        init_method, world, rank = found
        host = os.environ.get("MASTER_ADDR")
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("init_multihost: pass coordinator_address, "
                             "num_processes and process_id together")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
        host = coordinator_address.rsplit(":", 1)[0].strip("[]")
    n_local, local_rank = _local_layout(host, world, rank)
    if backend is None:
        gpus = torch.cuda.device_count() if device.type == "cuda" else 0
        backend = select_backend(device.type, n_local, gpus)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_multihost: no CUDA device is available; "
                           "pass device='cpu' to run the ranks on the CPU")
    if backend == "nccl":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    _dist().init_process_group(backend=backend, init_method=init_method,
                               world_size=world, rank=rank, **kwargs)
    return True


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


def global_mesh(n_chan=1):
    """A ('data', 'chan') mesh over every rank of the process group
    (make_mesh: 1 x 1 at one process)."""
    from .mesh import make_mesh

    return make_mesh(n_chan=n_chan)


def process_allgather(x):
    """Every process's small 1-D array, as a list of float64 numpy arrays
    in rank order, each of its own length: the lengths are exchanged
    first and the payload NaN-padded to the longest (round-robin shards
    are ragged when the process count does not divide the file count).
    At one process: [x]."""
    x = np.atleast_1d(np.asarray(x, np.float64))
    if _world()[1] == 1:
        return [x]
    lens = [int(n) for n in all_gather(torch.tensor([len(x)],
                                                    dtype=torch.int64))]
    n_max = max(lens)
    if n_max == 0:
        return [np.zeros(0) for _ in lens]
    pad = np.full(n_max, np.nan)
    pad[:len(x)] = x
    g = all_gather(torch.from_numpy(pad))
    return [g[i].numpy()[:lens[i]].copy() for i in range(len(lens))]
