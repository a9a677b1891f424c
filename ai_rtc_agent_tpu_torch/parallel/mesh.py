"""The dp x tp x sp mesh over a torch.distributed world (counterpart of
ai_rtc_agent_tpu/parallel/mesh.py).

JAX drives every chip of its mesh from one process; torch.distributed runs
one process per GPU.  So the port's mesh is a layout of the world's ranks,
and each axis is a set of process groups:

  dp  data parallelism: a rank's slice of the global batch; gradients are
      averaged over its dp group
  tp  tensor parallelism: Megatron column/row shards of the UNet's kernels
      (parallel/sharding.py)
  sp  sequence parallelism: ring / Ulysses attention over the latent tokens
      (parallel/ring_attention.py)

Rank r sits at (d, t, s) with r = ((d*tp) + t)*sp + s, the order in which
the JAX ``make_mesh`` reshapes its device list to (dp, tp, sp).  A size-1
axis has no group and does no collective, so one process with no process
group runs the same code as a world of many.

Serving's session axis is the exception: :func:`device_mesh` is a dp mesh
of ``torch.device``s that one process drives (the batch scheduler's and
``--multipeer``'s shards).  Its shards need no collective (params
replicate, each shard's rows are independent), so it holds no process
group, and its ``devices`` are devices, not ranks.
"""

from __future__ import annotations

import socket
from contextlib import contextmanager
from dataclasses import dataclass, field
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils import env

AXES = ("dp", "tp", "sp")
DEFAULT_TIMEOUT_S = 120.0  # a dead peer fails a collective after this, never hangs it
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None, backend: str | None = None,
                     device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Bring up the default process group; a no-op when it is already up.
    -> this process's device.

    Without explicit arguments it takes torchrun's variables (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); with none of them it
    brings up a world of one process on a free loopback port.  ``device``
    defaults to ``cuda`` (``cuda:LOCAL_RANK``; raises without a card) with
    the NCCL backend; a CPU world asks for ``backend="gloo", device="cpu"``
    explicitly.  Every collective times out after ``timeout_s``."""
    dev = resolve_device(device)
    want = BACKENDS.get(dev.type)
    backend = backend or want
    if backend != want:
        raise ValueError(f"backend {backend!r} on {dev.type}: the port runs {want!r} there")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", env.dist_local_rank())
    if dist.is_initialized():
        return dev
    if rank is None:
        rank = env.dist_rank()
    if world_size is None:
        world_size = env.dist_world_size()
    rank, world_size = rank or 0, world_size or 1
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} not in a world of {world_size}")
    if init_method is None:
        addr, port = env.dist_master()
        if port is None:
            if world_size > 1:
                raise ValueError(f"a world of {world_size} needs MASTER_PORT or an init_method")
            port = _free_port()
        init_method = f"tcp://{addr}:{port}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=timeout_s))
    return dev


def shutdown_distributed():
    """Destroy the default process group (and every group of every mesh)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def host_count() -> int:
    """The world's process count (the JAX ``process_count``)."""
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclass
class Mesh:
    """This rank's view of a dp x tp x sp mesh.  ``devices`` holds the world
    ranks in mesh order; ``coords`` is this rank's (dp, tp, sp) index, None
    for a rank outside a mesh smaller than the world (it holds no group and
    must not step on the mesh)."""

    shape: dict
    devices: np.ndarray
    rank: int
    coords: dict | None
    groups: dict = field(default_factory=dict)  # axis -> ProcessGroup (size > 1 only)
    axis_names: tuple = AXES

    @property
    def member(self) -> bool:
        return self.coords is not None

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is outside the mesh {self.shape}")
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's ``axis``; None for a size-1 axis."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is outside the mesh {self.shape}")
        return self.groups.get(axis)


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The mesh over the first dp*tp*sp ranks of the world.  Every rank of
    the world must call it (group creation is collective), in the same
    order as every other mesh."""
    n = host_count()
    rank = dist.get_rank() if dist.is_initialized() else 0
    want = dp * tp * sp
    if want > n:
        raise ValueError(f"mesh dp*tp*sp={want} exceeds {n} available devices")
    devices = np.arange(want).reshape(dp, tp, sp)
    shape = {"dp": dp, "tp": tp, "sp": sp}
    coords = None
    if rank < want:
        d, t, s = (int(i) for i in np.argwhere(devices == rank)[0])
        coords = {"dp": d, "tp": t, "sp": s}
    groups = {}
    for a, axis in enumerate(AXES):
        if shape[axis] == 1:
            continue
        lines = np.moveaxis(devices, a, -1).reshape(-1, shape[axis])
        for line in lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks, timeout=timedelta(seconds=timeout_s))
            if rank in ranks:
                groups[axis] = g
    return Mesh(shape, devices, rank, coords, groups)


def device_mesh(dp: int, devices=None) -> Mesh:
    """A one-process dp mesh over ``devices`` (default ``cuda:0 ..
    cuda:dp-1``): shard d lives on ``devices[d]``.  Asking for more shards
    than there are devices raises the JAX text; nothing falls back to a
    smaller mesh.  An explicit list is taken as given, so ``["cpu",
    "cpu"]`` (the CPU's stand-in for JAX's forced host devices) and
    ``[cuda:0, cuda:0]`` (two shards on one card) are meshes too."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dp > n:
            raise ValueError(f"mesh dp*tp*sp={dp} exceeds {n} available devices")
        devices = [torch.device("cuda", d) for d in range(dp)]
    devices = [torch.device(d) for d in devices]
    if dp > len(devices):
        raise ValueError(f"mesh dp*tp*sp={dp} exceeds {len(devices)} available devices")
    grid = np.empty((dp, 1, 1), dtype=object)
    for d in range(dp):
        grid[d, 0, 0] = devices[d]
    return Mesh({"dp": dp, "tp": 1, "sp": 1}, grid, 0, {"dp": 0, "tp": 0, "sp": 0})


def auto_mesh(prefer: str = "dp") -> Mesh:
    """Every rank of the world on one axis (the common single-host layouts)."""
    sizes = {"dp": 1, "tp": 1, "sp": 1}
    sizes[prefer] = host_count()
    return make_mesh(**sizes)


_ACTIVE: list = []


@contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the current one (:func:`current_mesh`) inside the block."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh() -> Mesh | None:
    return _ACTIVE[-1] if _ACTIVE else None
