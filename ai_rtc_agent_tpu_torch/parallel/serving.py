"""Tensor- and sequence-parallel serving in lockstep: rank 0 drives, the
other ranks follow.

JAX serves a tp/sp mesh from one controller that drives every chip.
torch.distributed runs one process per GPU, so the port's stand-in is a
lockstep world: every rank builds the same pipeline on the same mesh
(``StreamDiffusionPipeline(mesh=...)``: the same params, tp shards, state
and captured step), rank 0 serves, and before every call that changes an
engine's state it sends the call to the other ranks, which make it in the
same order.  A step's collectives (the tp gathers and sums, the ring's
permutes) then meet across the ranks as they would inside one program.

* :class:`LockstepEngine` wraps rank 0's ``StreamEngine``.  A carried call
  (:data:`CARRIED`) is sent as ``(op, args, kwargs)`` over the world
  group, then made here; a step sends ``("step", shape)`` and then the
  frame as a uint8 tensor, from inside the engine's submit (its
  ``on_step`` hook, after the similarity filter: a skipped frame steps
  nowhere).  One lock orders the sends as rank 0 makes the calls.
* :func:`follow` runs on every other rank: it receives each call and
  makes it on its engine until ``close``.  Followers read no output back.
* A public engine call that is neither carried nor a local read
  (:data:`LOCAL`) raises on the wrapper, naming the call: a rank-0-only
  state change would desync the ranks.
* Every send and every collective has the world's timeout
  (``mesh.init_distributed``): when a follower dies, rank 0's next call
  raises within it and never hangs.
"""

from __future__ import annotations

import logging
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..tree import tree_map
from .mesh import host_count

logger = logging.getLogger(__name__)

# the engine calls that change state on every rank, in rank 0's order
CARRIED = frozenset({
    "prepare", "submit", "update_prompt", "update_t_index_list", "update_guidance",
    "update_controlnet_scale", "restart", "reset_cache_cadence", "install",
})
# rank 0's reads of its own step (no state of the other ranks changes)
LOCAL = frozenset({"fetch", "last_submit_was_skip"})


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _comm_device(engine) -> torch.device:
    """Where the world's backend takes its tensors: the card under NCCL,
    the host under gloo."""
    return engine.device if dist.get_backend() == "nccl" else torch.device("cpu")


def _send(op: str, *args, **kwargs):
    dist.broadcast_object_list([(op, args, kwargs)], src=0)


def _recv() -> tuple:
    box = [None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class LockstepEngine:
    """Rank 0's engine in a world of more than one rank (see the module
    docstring).  Attributes that are not calls (``cfg``, ``params``,
    ``state``, ``device``, ...) read through to the engine."""

    def __init__(self, engine):
        if world_rank() != 0:
            raise RuntimeError(f"LockstepEngine drives from rank 0, not rank {world_rank()}")
        self._engine = engine
        self._order = threading.RLock()  # sends in the order the calls run here
        self._closed = False
        engine.on_step = self._send_step

    def _send_step(self, frame_u8: np.ndarray):
        frame = torch.from_numpy(np.ascontiguousarray(frame_u8))
        _send("step", tuple(frame.shape))
        dist.broadcast(frame.to(_comm_device(self._engine)), src=0)

    def _carry(self, op: str, *args, **kwargs):
        with self._order:
            if self._closed:
                raise RuntimeError(f"{op}: the lockstep world is closed")
            if op == "install":  # the leaves travel by value, off rank 0's card
                # tpurtc: allow[device-transfer] -- an install's state leaves go to the host once to travel to the followers by value (control plane, not a frame)
                args = (tree_map(lambda a: a.detach().cpu(), args[0]), *args[1:])
            if op != "submit":  # a step sends itself from inside submit
                _send(op, *args, **kwargs)
            return getattr(self._engine, op)(*args, **kwargs)

    def __getattr__(self, name: str):
        attr = getattr(self._engine, name)
        if name in CARRIED:
            return lambda *args, **kwargs: self._carry(name, *args, **kwargs)
        if callable(attr) and not name.startswith("_") and name not in LOCAL:
            raise RuntimeError(
                f"StreamEngine.{name} is not carried to the other {host_count() - 1} rank(s) "
                "of the lockstep world: calling it on rank 0 alone would desync them")
        return attr

    @property
    def last_submit_was_skip(self) -> bool:
        return self._engine.last_submit_was_skip

    def __call__(self, frame_u8: np.ndarray) -> np.ndarray:
        return self.fetch(self.submit(frame_u8))

    def close(self):
        """End the followers' loops (idempotent)."""
        with self._order:
            if not self._closed:
                self._closed = True
                _send("close")


def follow(engine) -> int:
    """A follower rank's loop: make each call rank 0 sends, in order, on
    ``engine`` (this rank's engine of the same pipeline) until ``close``;
    -> the number of steps taken.  A lost rank 0 raises within the
    world's timeout."""
    if world_rank() == 0:
        raise RuntimeError("rank 0 drives the lockstep world; follow() runs on the others")
    device = _comm_device(engine)
    steps = 0
    while True:
        op, args, kwargs = _recv()
        if op == "close":
            logger.info("lockstep follower: closed after %d steps", steps)
            return steps
        if op == "step":
            frame = torch.empty(args[0], dtype=torch.uint8, device=device)
            dist.broadcast(frame, src=0)
            engine.follow_step(frame)
            steps += 1
        elif op in CARRIED:
            getattr(engine, op)(*args, **kwargs)
        else:
            raise RuntimeError(f"lockstep follower: rank 0 sent an unknown call {op!r}")
