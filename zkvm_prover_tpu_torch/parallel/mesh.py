"""Device meshes for sharded proving (the reference's `parallel/mesh.py`).

One controller drives a mesh of torch devices, as JAX's `shard_map` does on
one host. Axis conventions (SURVEY.md §2.3 mapping):

  "data"  — independent work: segments / chunks / sibling proofs (DP axis)
  "shard" — one large object sharded: NTT rows, Merkle leaves (TP/SP axis)

A mesh is an explicit (n_data, n_shard) grid of `torch.device`s. The list
may repeat a device: the repeats are logical devices, so one card runs a
4-shard mesh and the host runs an 8-shard one, as the reference's tests run
on 8 forced host devices. A sharded array (`Sharded`) is a list of
contiguous per-shard tensors, each on its mesh device, split along one axis
of a block shape. The collectives over the "shard" axis (`all_gather`,
`all_to_all`, `ppermute`) are device-to-device copies; on a host with
several cards they are peer copies. The sharded functions use the shard
devices of data row 0: none collects over "data", so nothing crosses
processes.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Devices laid out on the axes ("data", "shard")."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.grid = [[torch.device(d) for d in row] for row in grid]
        if not self.grid or len({len(r) for r in self.grid}) != 1 or not self.grid[0]:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.shape = {"data": len(self.grid), "shard": len(self.grid[0])}

    def devices(self) -> List[torch.device]:
        """The shard devices of data row 0, the ones every sharded function
        uses."""
        return list(self.grid[0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.grid})"


def _visible_cuda() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=[...] to lay a mesh on the host")
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


def make_mesh(n_shard: Optional[int] = None, n_data: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (n_data, n_shard) mesh over `devices` in order (default: the
    visible CUDA devices; the list may repeat a device)."""
    devs = [torch.device(d) for d in devices] if devices is not None else _visible_cuda()
    n_shard = n_shard or (len(devs) // n_data)
    if n_shard < 1 or n_shard * n_data > len(devs):
        raise ValueError(f"{n_data} x {n_shard} mesh needs more than {len(devs)} devices")
    return Mesh([devs[r * n_shard:(r + 1) * n_shard] for r in range(n_data)])


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Join a multi-process job; a no-op for one process. For more, this
    calls `torch.distributed.init_process_group` over `coordinator`
    (`tcp://host:port`), NCCL where every process has a card, else gloo.

    `make_pod_mesh` then lays "data" over processes and "shard" over each
    process's local cards: no sharded function collects over "data", so the
    collectives stay among one process's cards."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)


def make_pod_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """'data' over processes, 'shard' over this process's local devices
    (default: its visible CUDA devices). Device names are process-local, so
    every row names its own process's cards as this one names its own; a
    single process is a one-row mesh."""
    import torch.distributed as dist

    local = [torch.device(d) for d in devices] if devices is not None else _visible_cuda()
    n_proc = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return Mesh([list(local) for _ in range(n_proc)])


# ---------------------------------------------------------------------------
# sharded arrays
# ---------------------------------------------------------------------------


@dataclass
class Sharded:
    """A global array of shape `shape`, held as `parts`: its block view
    (`shape` reshaped to each part's rank) split contiguously along `axis`,
    part s on shard device s."""

    parts: List[torch.Tensor]
    axis: int
    shape: tuple

    def gather(self, device=None) -> torch.Tensor:
        """The global array, on `device` (default: shard 0's)."""
        dev = torch.device(device) if device is not None else self.parts[0].device
        return torch.cat([p.to(dev) for p in self.parts], dim=self.axis).reshape(self.shape)


def on(device):
    """Make `device` current for the kernels' C launches (a CUDA launch goes
    to the current device's context)."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def ext_on(v, device) -> torch.Tensor:
    """A field value (tensor, or Montgomery numpy / sequence) as an int32
    tensor on `device`."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.ascontiguousarray(v, dtype=np.uint32).view(np.int32)).to(device)


def split(mesh: Mesh, x: torch.Tensor, axis: int) -> Sharded:
    """Split x along `axis` into contiguous copies on the shard devices."""
    devs = mesh.devices()
    d = len(devs)
    if x.shape[axis] % d:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split {d} ways")
    step = x.shape[axis] // d
    parts = [x.narrow(axis, s * step, step).to(dev).contiguous() for s, dev in enumerate(devs)]
    return Sharded(parts, axis, tuple(x.shape))


def shard_rows(mesh: Mesh, x) -> Sharded:
    """Rows (axis 0) sharded over the 'shard' axis."""
    if isinstance(x, Sharded):
        x = x.gather()
    return split(mesh, torch.as_tensor(x), 0)


def shard_cols(mesh: Mesh, x) -> Sharded:
    """The trailing (column) axis sharded over the 'shard' axis."""
    if isinstance(x, Sharded):
        x = x.gather()
    x = torch.as_tensor(x)
    return split(mesh, x, x.dim() - 1)


def all_gather(parts: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
    """Every shard's tensor, copied to `device`."""
    return [p.to(device) for p in parts]


def all_to_all(parts: Sequence[torch.Tensor], devices: Sequence[torch.device],
               split_axis: int, concat_axis: int) -> List[torch.Tensor]:
    """Tiled all_to_all: part i is cut into D pieces along `split_axis`;
    shard j receives piece j of every part, concatenated along
    `concat_axis` in shard order."""
    d = len(parts)
    outs = []
    for j, dev in enumerate(devices):
        pieces = [p.chunk(d, dim=split_axis)[j].to(dev) for p in parts]
        outs.append(torch.cat(pieces, dim=concat_axis).contiguous())
    return outs


def ppermute(parts: Sequence[torch.Tensor], devices: Sequence[torch.device],
             perm: Sequence[tuple]) -> List[Optional[torch.Tensor]]:
    """out[dst] = parts[src] on dst's device for (src, dst) in perm; a shard
    that no pair names receives None (where the reference receives zeros)."""
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for src, dst in perm:
        out[dst] = parts[src].to(devices[dst])
    return out
