"""The rank mesh (counterpart of pulseportraiture_tpu/parallel/mesh.py).

The workload's parallel axes are *batch* axes: (archive, subint) fits
are independent, and the only cross-channel coupling inside one fit is a
sum over channels.  The mesh is 2-D:

- ``data``: the archive/subint batch, split across ranks, gathered only
  at the end;
- ``chan``: the frequency channels of each portrait.

The JAX package's mesh is a grid of devices inside one program.  The
torch idiom is one process per device, so the port's mesh is a grid of
``torch.distributed`` RANKS: rank r sits at (r // n_chan, r % n_chan), as
device r does in the JAX mesh, and each axis has one process subgroup
per line of the grid (``dist.new_group``), through which the sharded
programs (parallel/batch.py) gather and reduce.  Without a process
group, or at world size 1, the mesh is 1 x 1 over this process's device
and needs no group.

A ``devices=`` list of several local devices is refused: one process
drives one device (ROADMAP C7).  ``torch.distributed.device_mesh`` is
not used: it starts a default process group from the environment and
fails at world size 1 without it.
"""

from dataclasses import dataclass, field

import torch

__all__ = ["Mesh", "make_mesh", "batch_sharding", "replicated", "Sharding"]

AXES = ("data", "chan")


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (n_data, n_chan) grid of ranks: ``shape``, this rank's
    ``coords`` (None outside the grid), its ``device`` (None: the
    entry points' default) and one process subgroup per axis holding
    this rank (``groups[axis]``; none at world size 1)."""

    shape: tuple
    rank: int
    world: int
    coords: tuple
    device: object = None
    groups: dict = field(default_factory=dict)

    axis_names = AXES

    @property
    def size(self):
        return self.shape[0] * self.shape[1]

    def axis_size(self, axis):
        return self.shape[AXES.index(axis)]

    def axis_index(self, axis):
        """This rank's coordinate along ``axis``."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is outside the "
                             f"{self.shape[0]}x{self.shape[1]} mesh")
        return self.coords[AXES.index(axis)]


def _devices_arg(devices):
    """The rank's device from a ``devices=`` list of at most one local
    device (None: the entry points' default)."""
    if devices is None:
        return None
    devices = list(devices)
    if len(devices) > 1:
        raise ValueError(
            f"make_mesh: {len(devices)} devices given to one process; the "
            "port runs one process per device: start one process per "
            "device (torchrun, or init_multihost in each) and pass each "
            "its own device")
    return torch.device(devices[0]) if devices else None


def make_mesh(n_data=None, n_chan=1, devices=None):
    """A ('data', 'chan') mesh over every rank of the process group (one
    rank without a group).  n_data None: world // n_chan.  devices: None
    or this rank's one device."""
    import torch.distributed as dist

    from .multihost import process_count, process_index

    device = _devices_arg(devices)
    world, rank = process_count(), process_index()
    if n_data is None:
        n_data = world // n_chan
    if not (n_data >= 1 and n_chan >= 1 and n_data * n_chan <= world):
        raise ValueError(f"mesh {n_data}x{n_chan} > {world} ranks")
    coords = (divmod(rank, n_chan) if rank < n_data * n_chan else None)
    groups = {}
    if world > 1:
        # every rank creates every subgroup, in the same order (a
        # collective call); each keeps the two that hold it
        for i in range(n_data):
            g = dist.new_group([i * n_chan + j for j in range(n_chan)])
            if coords is not None and coords[0] == i:
                groups["chan"] = g
        for j in range(n_chan):
            g = dist.new_group([i * n_chan + j for i in range(n_data)])
            if coords is not None and coords[1] == j:
                groups["data"] = g
    return Mesh(shape=(int(n_data), int(n_chan)), rank=rank, world=world,
                coords=coords, device=device, groups=groups)


@dataclass(frozen=True)
class Sharding:
    """Which array axis each mesh axis slices: ``spec[i]`` is 'data',
    'chan' or None (the axis is whole on every rank)."""

    mesh: Mesh
    spec: tuple

    def slices(self, shape):
        """This rank's slice of an array of ``shape``; a sliced axis must
        divide by its mesh axis (the JAX package refuses the same)."""
        out = []
        for n, ax in zip(shape, self.spec):
            if ax is None:
                out.append(slice(None))
                continue
            k = self.mesh.axis_size(ax)
            if n % k:
                raise ValueError(
                    f"an axis of length {n} does not divide over the "
                    f"mesh's {k} '{ax}' ranks")
            step = n // k
            i = self.mesh.axis_index(ax)
            out.append(slice(i * step, (i + 1) * step))
        return tuple(out)


def batch_sharding(mesh, ndim, chan_axis=None):
    """Leading axis over 'data', optionally axis ``chan_axis`` over
    'chan', the rest whole."""
    spec = [None] * ndim
    spec[0] = "data"
    if chan_axis is not None and chan_axis < ndim:
        spec[chan_axis] = "chan"
    return Sharding(mesh, tuple(spec))


def replicated(mesh):
    """Every axis whole on every rank."""
    return Sharding(mesh, ())
