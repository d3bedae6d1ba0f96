"""Device-mesh plumbing for sharded indices and distributed training
(counterpart of ``gulon_tpu/parallel/mesh.py``).

A :class:`Mesh` is a ``(rows x sub)`` grid of ``torch.device``s:

- ``"rows"``: the corpus axis; codes, norms and raw vectors shard here;
- ``"sub"``: the PQ subspace axis of codebook training (model parallel).

A row-sharded value is a Python list with one tensor per row shard, on
that shard's device (its ``sub = 0`` position), padded to a multiple of
the shard count as the JAX functions pad it. The grid may name one device
more than once: each position is then a logical shard, the counterpart of
the JAX tests' ``--xla_force_host_platform_device_count``; the CPU tests
use ``["cpu"] * 8`` and a single card can hold ``[cuda:0] * 4``.

Across processes (``torch.distributed``) every process holds the same full
host value and keeps only its own shards (``place_global``'s contract in
the JAX package): the grid is the concatenation of the processes' device
lists in rank order, positions owned by another process are ``None`` in a
sharded list, and the per-shard results meet in collectives.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

ROWS = "rows"
SUB = "sub"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(rows x sub)`` grid of devices, with the rank owning each
    position and the process group joining the ranks (None in one
    process)."""

    devices: np.ndarray  # [rows, sub] object array of torch.device
    owners: np.ndarray  # [rows, sub] int: the rank holding each position
    group: Optional[object] = None  # torch.distributed process group
    rank: int = 0

    @property
    def shape(self) -> dict:
        rows, sub = self.devices.shape
        return {ROWS: rows, SUB: sub}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def local_rows(self) -> List[int]:
        """The row shards this process holds, in shard order."""
        return [r for r in range(self.devices.shape[0]) if self.owners[r, 0] == self.rank]

    def row_device(self, r: int) -> torch.device:
        return self.devices[r, 0]

    @property
    def lead_device(self) -> torch.device:
        """Where merged results land: this process's first position."""
        flat = self.owners.reshape(-1)
        return self.devices.reshape(-1)[int(np.argmax(flat == self.rank))]

    @property
    def on_cuda(self) -> bool:
        """Whether this process's shards live on CUDA devices (the JAX
        package's "on a TPU")."""
        mine = self.devices[self.owners == self.rank]
        return all(d.type == "cuda" for d in mine)

    def flattened(self) -> "Mesh":
        """The same devices as a pure row mesh (``sub = 1``)."""
        return dataclasses.replace(
            self, devices=self.devices.reshape(-1, 1), owners=self.owners.reshape(-1, 1)
        )


def distributed_init(*, devices: Optional[Sequence] = None, backend: Optional[str] = None,
                     **kwargs) -> None:
    """Join a multi-process run (``torch.distributed.init_process_group``).

    ``devices`` are the devices this process's shards will live on
    (default: every visible CUDA device). The backend is NCCL when they
    are CUDA devices and gloo otherwise, unless ``backend`` names one
    (gloo lets several processes share one card, which NCCL refuses). The
    rest of ``kwargs`` goes to ``init_process_group``: nothing tells a
    process of its peers, so pass ``init_method="tcp://host:port"``,
    ``world_size`` and ``rank``. A no-op when the group is already up."""
    if dist.is_initialized():
        return
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    on_cuda = bool(devices) and all(d.type == "cuda" for d in devices)
    if backend is None:
        backend = "nccl" if on_cuda else "gloo"
    if on_cuda:
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend=backend, **kwargs)


def make_mesh(
    num_devices: Optional[int] = None,
    *,
    sub_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A ``(rows x sub)`` mesh over this process's ``devices`` (default:
    every visible CUDA device; raises without one), and in a
    ``torch.distributed`` run over every process's, in rank order.

    ``sub_parallel`` positions of each row go to the PQ-subspace axis;
    ``num_devices`` keeps the first that many. ``devices`` may name one
    device more than once (logical shards)."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices=[...] "
                "(for example ['cpu'] * 8) to shard on other devices"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    local = [torch.device(d) for d in devices]
    group, rank = None, 0
    everyone: List[Tuple[int, torch.device]] = [(0, d) for d in local]
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        group, rank = dist.group.WORLD, dist.get_rank()
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, [str(d) for d in local])
        everyone = [(r, torch.device(d)) for r, names in enumerate(gathered) for d in names]
    if num_devices is not None:
        everyone = everyone[:num_devices]
    n = len(everyone)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if n % sub_parallel != 0:
        raise ValueError(f"device count {n} not divisible by sub_parallel {sub_parallel}")
    grid = np.empty(n, dtype=object)
    grid[:] = [d for _, d in everyone]
    owners = np.array([r for r, _ in everyone], dtype=np.int64)
    shape = (n // sub_parallel, sub_parallel)
    owners = owners.reshape(shape)
    if group is not None:
        # the collectives gather equal parts from each process, in rank
        # order: each must hold the same number of whole rows of the grid
        per_rank = [int((owners[:, 0] == r).sum()) for r in range(dist.get_world_size())]
        whole = all(len(set(row)) == 1 for row in owners.tolist())
        if not whole or len(set(per_rank)) != 1 or per_rank[0] == 0:
            raise ValueError(
                f"each process must hold the same number of whole mesh rows, got {per_rank}"
            )
    return Mesh(devices=grid.reshape(shape), owners=owners, group=group, rank=rank)


def check_mesh(mesh) -> None:
    """``TypeError`` unless ``mesh`` is None or a :class:`Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a gulon_tpu_torch.parallel.Mesh (make_mesh), got {type(mesh)!r}"
        )


def num_row_shards(mesh: Mesh) -> int:
    return mesh.shape[ROWS]


def pad_rows_to_shards(array, mesh: Mesh, pad_value):
    """Pad axis 0 to a multiple of the row-shard count; returns ``(padded,
    n_pad)``, numpy for numpy input and a tensor for a tensor. Padded rows
    must be inert in the scan that reads them: callers pad norms with
    ``+inf`` so that padding never enters a top-k."""
    n = array.shape[0]
    n_pad = (-n) % num_row_shards(mesh)
    if not n_pad:
        return array, 0
    if isinstance(array, torch.Tensor):
        tail = array.new_full((n_pad,) + tuple(array.shape[1:]), pad_value)
        return torch.cat([array, tail]), n_pad
    pad_cfg = ((0, n_pad),) + ((0, 0),) * (array.ndim - 1)
    return np.pad(array, pad_cfg, constant_values=pad_value), n_pad


def shard_rows(array, mesh: Mesh, pad_value=0) -> list:
    """Pad and split ``array`` (numpy or tensor) into the mesh's row shards:
    one tensor per shard on its device, None for another process's."""
    padded, _ = pad_rows_to_shards(array, mesh, pad_value)
    if not isinstance(padded, torch.Tensor):
        padded = torch.from_numpy(np.require(padded, requirements=["C", "W"]))
    local_n = padded.shape[0] // num_row_shards(mesh)
    out = [None] * num_row_shards(mesh)
    for r in mesh.local_rows:
        out[r] = padded[r * local_n : (r + 1) * local_n].to(mesh.row_device(r))
    return out


def replicate(array, mesh: Mesh) -> list:
    """``array`` on every row shard's device: a list like
    :func:`shard_rows`'s, one copy per distinct device."""
    if not isinstance(array, torch.Tensor):
        array = torch.from_numpy(np.require(array, requirements=["C", "W"]))
    copies = {}
    out = [None] * num_row_shards(mesh)
    for r in mesh.local_rows:
        dev = mesh.row_device(r)
        if dev not in copies:
            copies[dev] = array.to(dev)
        out[r] = copies[dev]
    return out


def gather_shards(mesh: Mesh, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """Concatenate per-position tensors along ``dim`` in global mesh order,
    on the lead device: ``parts`` are this process's, in order; across
    processes they meet in one ``all_gather`` (equal shapes per process;
    gloo gathers CUDA tensors too, so several processes can share a
    card)."""
    lead = mesh.lead_device
    local = torch.cat([p.to(lead) for p in parts], dim=dim)
    if mesh.group is None:
        return local
    recv = [torch.empty_like(local) for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(recv, local.contiguous(), group=mesh.group)
    return torch.cat(recv, dim=dim)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the mesh's processes (``t`` itself in one
    process)."""
    if mesh.group is None:
        return t
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t
