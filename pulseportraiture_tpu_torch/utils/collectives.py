"""The collectives on small tensors that the fit engines and the rank
mesh share (parallel/multihost.py re-exports them).

Gloo's ``all_gather`` takes CPU tensors only, so every collective goes
through :func:`collective_tensor`, which puts its tensor on the host
under gloo and on the rank's card under NCCL; the results come back on
the caller's device.  ``torch.distributed`` is imported when a
collective runs, so a one-process fit never loads it.
"""

import torch

__all__ = ["collective_tensor", "all_gather", "all_reduce_sum"]


def _dist():
    import torch.distributed as dist

    return dist


def collective_tensor(x):
    """``x`` where the process group's collectives take it: the host
    under gloo, the current CUDA device under NCCL."""
    if _dist().get_backend() == "nccl":
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x.cpu()


def all_gather(x, group=None):
    """torch.distributed.all_gather of equal-shaped tensors through
    collective_tensor: the list of every rank's ``x`` (of ``group``), in
    rank order, on x's device."""
    dist = _dist()
    t = collective_tensor(x.contiguous())
    out = [torch.empty_like(t)
           for _ in range(dist.get_world_size(group=group))]
    dist.all_gather(out, t, group=group)
    return [o.to(x.device) for o in out]


def all_reduce_sum(x, group=None):
    """Sum of ``x`` over the ranks of ``group``, on x's device."""
    t = collective_tensor(x.contiguous())
    _dist().all_reduce(t, op=_dist().ReduceOp.SUM, group=group)
    return t.to(x.device)
