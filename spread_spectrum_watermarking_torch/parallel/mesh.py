"""Process groups, the (data, spatial) mesh, placement and collectives.

The JAX package runs one controller over a ``jax.sharding.Mesh`` and
``shard_map``. Here one process is one rank, and the ranks of the default
``torch.distributed`` process group form a 2-D ``DeviceMesh`` with dims
``("data", "spatial")``:

- axis ``data``: the image batch (DP);
- axis ``spatial``: the rows (or columns) of one large image (TP), used by
  the sharded DCT's all-to-all and the distributed top-k.

Every rank calls an entry point with the same global host input, as every
JAX process passes the same host array. :func:`place` puts only the rank's
own block on its device (the JAX ``NamedSharding``'s shard), zero-padding
on the host only that block; :func:`gather` rebuilds the global array from
the blocks, for tests and the bench.

The collectives of :class:`Mesh` are JAX's: ``lax.all_to_all`` is
``all_to_all_single`` on the spatial sub-group, ``psum`` is
``all_reduce(SUM)``, the candidate all-gather is ``all_gather``.

Backends follow the device the caller asks for: ``cuda`` is NCCL, one rank
per card (``cuda:{LOCAL_RANK}``), ``cpu`` is gloo. A failed NCCL init
raises; nothing falls back to gloo or to the CPU. One further pairing is
allowed on purpose: gloo ranks that compute on CUDA devices, which is how
several ranks share one card (NCCL refuses two ranks on one card). gloo
does not move CUDA tensors through every collective, so for that pairing
(:func:`via_host`) each collective copies its operand into a pinned host
buffer, runs on the host and copies the result back: a choice made by the
backend, not by catching an error.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


class Local(NamedTuple):
    """This rank's own block of a global array, in the layout an entry
    point returns it (``embed_corpus``'s padded blocks). Passed in place of
    the global array, it is used as it is instead of being placed."""

    tensor: torch.Tensor


def padded_size(size: int, n: int) -> int:
    """Smallest multiple of ``n`` that is >= ``size``."""
    return -(-size // n) * n


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` (``torchrun`` sets it; else
    the global rank), modulo the cards present, for ``"cuda"``; the device
    itself otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def multihost_initialize(*, device="cuda", backend: Optional[str] = None,
                         timeout: Optional[float] = None, **kwargs) -> None:
    """Join the default process group: ``dist.init_process_group`` with
    the backend ``device`` implies (:func:`default_backend`) unless
    ``backend`` is given.

    With no ``init_method`` or ``store`` in ``kwargs``, the rank, world
    size and rendezvous come from ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``, as ``torchrun`` sets them.
    ``timeout`` (seconds) bounds every collective. On a CUDA device the
    rank's card (:func:`rank_device`) becomes the current device.
    """
    backend = backend or default_backend(device)
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend=backend, **kwargs)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device))


def via_host(device: torch.device) -> bool:
    """Whether this rank's communication runs on pinned host copies of its
    tensors: gloo ranks that compute on a CUDA device."""
    return dist.get_backend() == "gloo" and device.type == "cuda"


def to_wire(t: torch.Tensor, host: bool) -> torch.Tensor:
    """``t`` as the backend sends it: contiguous, and with ``host`` (see
    :func:`via_host`) a copy in pinned host memory."""
    if not host:
        return t.contiguous()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def from_wire(t: torch.Tensor, device: torch.device,
              host: bool) -> torch.Tensor:
    """A tensor the backend received, back on the rank's ``device``."""
    return t.to(device) if host else t


class Mesh:
    """The ranks of the default process group as a (data, spatial) mesh.

    ``shape`` maps each axis to its size, as a JAX mesh's does; ``index``
    gives this rank's coordinate on an axis, ``group`` the sub-group of the
    ranks that differ from it only on that axis. ``device`` is the rank's
    device.
    """

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.backend = dist.get_backend()
        self.shape: Dict[str, int] = {
            DATA_AXIS: device_mesh.size(0), SPATIAL_AXIS: device_mesh.size(1)}
        self.via_host = via_host(device)

    def index(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def all_to_all(self, t: torch.Tensor, split_axis: int,
                   concat_axis: int, axis: str = SPATIAL_AXIS) -> torch.Tensor:
        """``lax.all_to_all(t, axis, split_axis, concat_axis, tiled=True)``:
        ``t`` is cut into ``n`` equal chunks along ``split_axis``, chunk
        ``j`` goes to the rank at index ``j``, and the chunks received are
        concatenated along ``concat_axis`` in the senders' order."""
        n = self.shape[axis]
        send = to_wire(torch.stack(t.chunk(n, dim=split_axis)),
                       self.via_host)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group(axis))
        recv = from_wire(recv, self.device, self.via_host)
        return torch.cat(recv.unbind(0), dim=concat_axis)

    def psum(self, t: torch.Tensor, axis: str = SPATIAL_AXIS) -> torch.Tensor:
        """``lax.psum``: the elementwise sum of ``t`` over the axis's ranks."""
        buf = (to_wire(t, True) if self.via_host
               else t.clone(memory_format=torch.contiguous_format))
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group(axis))
        return from_wire(buf, self.device, self.via_host)

    def all_gather(self, t: torch.Tensor,
                   axis: str = SPATIAL_AXIS) -> torch.Tensor:
        """Every rank's ``t`` on the axis, stacked in index order on a new
        leading dim."""
        send = to_wire(t, self.via_host)
        parts = [torch.empty_like(send) for _ in range(self.shape[axis])]
        dist.all_gather(parts, send, group=self.group(axis))
        return from_wire(torch.stack(parts), self.device, self.via_host)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device="cuda") -> Mesh:
    """A (data, spatial) mesh over the ranks of the default process group.

    ``shape=None`` puts every rank on the data axis, the default for batch
    workloads; ``(1, n)`` gives all ranks to one image, ``(2, n/2)`` both.
    Every rank must call it (the sub-groups are created collectively).
    ``device`` is the device type the ranks compute on (:func:`rank_device`).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "multihost_initialize first (or run under "
                           "torchrun or parallel.launch.run_ranks)")
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if shape is None:
        shape = (world, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks")
    # The mesh's device type is the one the backend communicates from.
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(mesh_type, shape,
                          mesh_dim_names=(DATA_AXIS, SPATIAL_AXIS))
    return Mesh(dm, rank_device(device))


def _host_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x)


def _block(x: torch.Tensor, dim: int, index: int, count: int,
           pad: bool) -> torch.Tensor:
    """Block ``index`` of ``count`` along ``dim``; with ``pad`` the dim is
    first zero-extended to a multiple of ``count`` (only this block is
    formed), else it must divide."""
    size = x.shape[dim]
    if not pad and size % count:
        raise ValueError(f"dim {dim} of size {size} does not divide over "
                         f"{count} ranks")
    b = padded_size(size, count) // count
    lo = min(index * b, size)
    hi = min(lo + b, size)
    part = x.narrow(dim, lo, hi - lo)
    if hi - lo == b:
        return part
    shape = list(x.shape)
    shape[dim] = b
    out = x.new_zeros(shape)
    out.narrow(dim, 0, hi - lo).copy_(part)
    return out


def place(x, mesh: Mesh, dims: Optional[Dict[int, str]] = None, *,
          pad: Sequence[int] = ()) -> torch.Tensor:
    """This rank's block of the global array ``x`` (numpy or a tensor, the
    same on every rank) on the rank's device: for each ``dim: axis`` of
    ``dims``, block ``mesh.index(axis)`` of ``mesh.shape[axis]`` along
    ``dim``; dims not listed are whole (replicated). A dim in ``pad`` is
    zero-extended to a multiple of its axis size, one block at a time, so
    the whole padded array is never formed; any other must divide, as a
    JAX ``NamedSharding`` requires. A :class:`Local` is returned as it is.
    """
    if isinstance(x, Local):
        return x.tensor
    t = _host_tensor(x)
    for dim, axis in (dims or {}).items():
        t = _block(t, dim, mesh.index(axis), mesh.shape[axis],
                   pad=dim in pad or dim - t.ndim in pad)
    return t.to(mesh.device)


def batch_sharding(mesh: Mesh):
    """The counterpart of JAX's ``batch_sharding``: a function that places
    a global array's leading (batch) axis over the data axis."""
    return lambda x: place(x, mesh, {0: DATA_AXIS})


def replicated(mesh: Mesh):
    """The counterpart of JAX's ``replicated``: a function that places the
    whole array on every rank."""
    return lambda x: place(x, mesh)


def gather(x: torch.Tensor, mesh: Mesh, dims: Dict[int, str]) -> torch.Tensor:
    """The global array from every rank's block: for each ``dim: axis``,
    the blocks of the axis's ranks concatenated along ``dim`` in index
    order. Blocks may differ in size along ``dim`` (a cropped edge block);
    every rank gets the result. For tests and the bench: the pipelines
    themselves never gather."""
    for dim, axis in dims.items():
        size = torch.tensor([x.shape[dim]], device=x.device)
        sizes = [int(s) for s in mesh.all_gather(size, axis)[:, 0]]
        big = max(sizes)
        if x.shape[dim] < big:
            shape = list(x.shape)
            shape[dim] = big - x.shape[dim]
            x = torch.cat([x, x.new_zeros(shape)], dim=dim)
        parts = mesh.all_gather(x, axis).unbind(0)
        x = torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                      dim=dim)
    return x
