"""The process mesh and the exchange layer of the port's parallel paths.

A :class:`Mesh` records one rank's place in an initialised
``torch.distributed`` world: the process group along each named axis, its
index there, its device and the world's backend.  Every collective of
``quisk_tpu_torch.parallel`` goes through :func:`ring_from_left`,
:func:`all_gather` or :func:`all_to_all`, which

- view complex tensors as (re, im) pairs on the wire: neither backend
  moves complex tensors;
- on a gloo mesh whose device is a card, copy to the host and back (gloo
  moves host tensors) and count the bytes staged; NCCL moves device
  tensors where they lie;
- count each call by kind in ``mesh.counts`` (``send``, ``recv``,
  ``all_gather``, ``all_to_all``; ``host_bytes`` for the staging), the
  counterpart of counting the collective ops in the reference's compiled
  program.

A point-to-point exchange needs a peer: along an axis of one rank
:func:`ring_from_left` makes no call.  The collectives are called at any
size, one rank included.

The backend is the caller's choice, made once when the world is
initialised (:func:`init_world`); nothing here switches backend or device.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import math

import torch
import torch.distributed as dist

from quisk_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh of ranks with named axes.

    ``groups[k]`` is the process group of the ranks that share this
    rank's coordinates on every axis but ``axes[k]``; ``coords[k]`` is this
    rank's index along ``axes[k]``; ``group`` spans the whole mesh.  A mesh
    of one rank may be built without a world (``group`` None) for code
    that only reads its shape."""

    axes: tuple
    shape: tuple
    coords: tuple
    groups: tuple
    group: object
    rank: int
    device: torch.device
    backend: str
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter, compare=False)

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axes.index(axis)]

    def group_of(self, axis: str):
        return self.groups[self.axes.index(axis)]


def init_world(init: str, rank: int, world: int, backend: str,
               device=None, timeout_s: float = 120.0) -> torch.device:
    """Initialise the default process group: ``init`` a ``file://`` or
    ``tcp://host:port`` URL, ``backend`` "gloo" or "nccl" (the caller's
    choice; NCCL needs the card).  A rank that waits longer than
    ``timeout_s`` on a peer raises.  Returns the rank's device."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL moves CUDA tensors: pass a CUDA device")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def make_mesh(n=None, axis="chan", device=None) -> Mesh | None:
    """This rank's mesh over the first ``n`` ranks of the initialised world
    (all of them by default).  ``n`` an int and ``axis`` a name give one
    axis; a tuple shape with a tuple of names gives a multi-axis mesh over
    the whole world, laid out by ``init_device_mesh`` (e.g. ``(2, 2)``,
    ``("chan", "time")``).  Every rank of the world must call it (groups
    are made collectively); a rank outside the first ``n`` gets None.
    ``device`` None means the card."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised "
                           "(init_world)")
    device = resolve_device(device)
    backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL moves CUDA tensors: pass a CUDA device")
    world, rank = dist.get_world_size(), dist.get_rank()
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    shape = ((world,) if n is None
             else (int(n),) if isinstance(n, int) else tuple(n))
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} does not match axes {axes}")
    if len(axes) == 1:
        if not 1 <= shape[0] <= world:
            raise ValueError(f"mesh of {shape[0]} ranks in a world of "
                             f"{world}")
        group = (dist.group.WORLD if shape[0] == world
                 else dist.new_group(list(range(shape[0]))))
        if rank >= shape[0]:
            return None
        groups, coords = (group,), (rank,)
    else:
        if math.prod(shape) != world:
            raise ValueError(f"a {shape} mesh needs a world of "
                             f"{math.prod(shape)}, not {world}")
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                              mesh_dim_names=axes)
        group = dist.group.WORLD
        groups = tuple(dm.get_group(a) for a in axes)
        coords = tuple(dm.get_local_rank(a) for a in axes)
    return Mesh(axes=axes, shape=shape, coords=coords, groups=groups,
                group=group, rank=rank, device=device, backend=backend)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (not counted: it moves no data)."""
    if mesh.world > 1:
        dist.barrier(group=mesh.group)


def _to_wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    w = torch.view_as_real(t) if t.is_complex() else t
    if mesh.backend == "gloo" and w.device.type != "cpu":
        w = w.cpu()
        mesh.counts["host_bytes"] += w.numel() * w.element_size()
    return w.contiguous()


def _from_wire(mesh: Mesh, w: torch.Tensor, like: torch.Tensor):
    if w.device != like.device:
        mesh.counts["host_bytes"] += w.numel() * w.element_size()
        w = w.to(like.device)
    return torch.view_as_complex(w.contiguous()) if like.is_complex() else w


def ring_from_left(mesh: Mesh, axis: str, t: torch.Tensor):
    """Send ``t`` to the next rank along ``axis`` and return what the
    previous rank sent (the first rank gets the last rank's: a ring).
    None, and no call, along an axis of one rank."""
    n = mesh.size(axis)
    if n == 1:
        return None
    i, g = mesh.index(axis), mesh.group_of(axis)
    w = _to_wire(mesh, t)
    buf = torch.empty_like(w)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, w, dist.get_global_rank(g, (i + 1) % n), g),
        dist.P2POp(dist.irecv, buf, dist.get_global_rank(g, (i - 1) % n),
                   g)])
    for r in reqs:
        r.wait()
    mesh.counts["send"] += 1
    mesh.counts["recv"] += 1
    return _from_wire(mesh, buf, t)


def all_gather(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """[n, *t.shape]: every rank's ``t`` along ``axis``, in index order."""
    w = _to_wire(mesh, t)
    parts = [torch.empty_like(w) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, w, group=mesh.group_of(axis))
    mesh.counts["all_gather"] += 1
    return _from_wire(mesh, torch.stack(parts), t)


def all_to_all(mesh: Mesh, axis: str, t: torch.Tensor, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Cut ``t`` into n equal pieces along ``split_dim``, send piece j to
    rank j along ``axis`` and concatenate what arrives along
    ``concat_dim`` in index order (``jax.lax.all_to_all`` with
    ``tiled=True``).  One call."""
    n = mesh.size(axis)
    split_dim %= t.dim()
    concat_dim %= t.dim()
    L = t.shape[split_dim]
    if L % n:
        raise ValueError(f"dim {split_dim} of length {L} does not split "
                         f"{n} ways")
    w = _to_wire(mesh, t).movedim(split_dim, 0)
    w = w.reshape(n, L // n, *w.shape[1:]).contiguous()
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.group_of(axis))
    mesh.counts["all_to_all"] += 1
    out = torch.cat(out.movedim(1, split_dim + 1).unbind(0), dim=concat_dim)
    return _from_wire(mesh, out, t)
