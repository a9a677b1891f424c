"""Multi-peer batching: N concurrent streams stepped as one batch on one card
(counterpart of ai_rtc_agent_tpu/parallel/multipeer.py).

Each peer owns its stream state (prompt, ring buffer, stock, noise,
t-indices, guidance); the states are stacked on a leading slot axis and one
bucket step advances the active slots together:

    states: every leaf [P, ...]          (stream.engine.stack_states)
    frames: [k, H, W, 3] uint8           one per stepped slot
            [k, fbs, H, W, 3]            fbs consecutive frames per slot
    bucket step: the k slots' rows -> one k*B-row step -> their rows in place

Bucket sizes are powers of two; a bucket with fewer active slots than its
size repeats the last active slot at the tail, and only the real slots'
rows are written (the epilogue's ``k_real``, read from device memory).  On
the card each bucket size is one CUDA graph over static frame, slot and
count buffers (aot/cache.py), captured at prewarm on the stepping thread
and replayed for every occupancy of its size: the counterpart of the JAX
package's one executable per bucket.  The same bucket step serves
``MultiPeerEngine`` (fixed slots, ``--multipeer N``) and the continuous
batch scheduler (stream/scheduler.py).  This is BASELINE.json configs[4]
("Multi-peer WebRTC: N concurrent streams batched on one chip").

DeepCache (``unet_cache_interval`` >= 2) doubles the buckets: each size has
a capture and a cached step, one graph each, keyed (k, variant).  The peer
engine keeps the JAX engine's global cadence: every slot captures on the
same tick, and an install, a prompt or a t-index write makes the next
step a capture.

On a dp mesh (``mesh.device_mesh``: one process, dp devices) the slot
axis splits slot-major into :class:`Shard`s (parallel/sharding.py's
session-axis rules): each holds its own copy of the params on its device,
its slots' stacked rows, and its own bucket steps, which it steps at k/dp
rows; a step launches each shard's in turn from the calling thread, and
each shard's rows come back through its own readback
(:class:`ShardedReadback`).  No collective is needed: the rows are
independent.
"""

from __future__ import annotations

import logging
import threading
from contextlib import nullcontext
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..aot.cache import CapturedStep, GraphCache, stream_engine_key
from ..obs import devtel
from ..stream.engine import (
    StreamConfig,
    StreamEngine,
    StreamModels,
    install_row,
    make_session_step_fn,
    params_variant_extra,
    stack_states,
    stage_into,
    t_index_coeffs,
    unet_variants,
)
from ..tree import tree_map
from ..utils import env
from . import sharding as SH

logger = logging.getLogger(__name__)


class CapacityError(RuntimeError):
    """All slots are claimed (maps to HTTP 503 in the agent)."""


def bucket_sizes(capacity: int, include_capacity: bool = True, first: int = 1) -> list:
    """``first`` (the dp axis: every bucket splits evenly over the shards)
    doubled while below ``capacity``, then ``capacity`` itself unless
    ``include_capacity`` is False (--multipeer steps every slot at and above
    its largest bucket)."""
    sizes, b = [], first
    while b < capacity:
        sizes.append(b)
        b *= 2
    if include_capacity:
        sizes.append(capacity)
    return sizes


def bucket_for(sizes: list, n: int):
    """The smallest bucket that holds ``n`` sessions, or None."""
    return next((b for b in sizes if b >= n), None)


def pad_bucket(slots: list, k: int) -> list:
    """The bucket's k slots: the real ones, then the last one repeated."""
    return (list(slots) + [slots[-1]] * k)[:k]


class BucketStep:
    """gather -> step -> write back over a stacked slot state, in one
    session-batched step (``stream.engine.make_session_step_fn``), one
    :class:`~..aot.cache.CapturedStep` per bucket size.

    Each bucket size k has static buffers: frames [k,H,W,3] uint8 ([k,fbs,
    H,W,3] with frame_buffer_size fbs > 1), slots [k] int32 and the count
    of real sessions (an int32 scalar, which the epilogue reads).  ``graphs``
    (default: on a CUDA device) captures the bucket once, at its first use
    (``warm`` at prewarm) on the calling thread, and replays it per step;
    otherwise it steps eagerly over the same buffers.  With DeepCache each
    size has one step per variant (``variants``: capture, cached), each
    with its own buffers.  ``key(k, variant)`` names bucket k's step (the
    engine-key recipe)."""

    def __init__(self, models: StreamModels, cfg: StreamConfig, device, *, graphs=None,
                 key: Callable[[int, str], str] | None = None):
        self.variants = unet_variants(cfg)
        self._steps = {v: make_session_step_fn(models, cfg, unet_variant=v) for v in self.variants}
        self.device = device
        self.graphs = device.type == "cuda" if graphs is None else bool(graphs)
        self.graph_cache = GraphCache(self.graphs, device)
        self.key = key or (lambda k, v: f"sbucket-{k}:{v}")
        fbs = cfg.frame_buffer_size
        self._frame_shape = ((fbs,) if fbs > 1 else ()) + (cfg.height, cfg.width, 3)
        self._idx: dict = {}

    def index(self, pad: list) -> torch.Tensor:
        key = tuple(pad)
        idx = self._idx.get(key)
        if idx is None:
            if len(self._idx) > 512:
                self._idx.clear()
            idx = _upload(np.asarray(pad, np.int32), self.device)
            self._idx[key] = idx
        return idx

    def step_for(self, params, states, k: int, variant: str | None = None) -> CapturedStep:
        """Bucket k's step of ``variant`` (default: the first, full or
        capture) over ``states``, built (and captured) at its first use.
        Its buffers start blank with no real session, so the capture's
        warm-up steps write no slot."""
        variant = variant or self.variants[0]
        fn = self._steps[variant]

        def build():
            inputs = {
                "frames": torch.zeros((k, *self._frame_shape), dtype=torch.uint8,
                                      device=self.device),
                "slots": torch.zeros(k, dtype=torch.int32, device=self.device),
                "k_real": torch.zeros((), dtype=torch.int32, device=self.device),
            }
            return (lambda b: fn(params, states, b["frames"], b["slots"], b["k_real"]), inputs)

        return self.graph_cache.get(self.key(k, variant), build)

    def __call__(self, params, states, frames, slots: list, k: int, variant: str | None = None):
        """One step of bucket k (its ``variant``) for the real sessions
        ``slots``.  ``frames``:
        a host uint8 array [m,H,W,3] ([m,fbs,H,W,3]; staged from pinned
        memory straight into the static buffer) or device frames, one row
        per session; with m < k the last is repeated.  -> [k,H,W,3] uint8
        ([k,fbs,H,W,3]; the replay's output on the card); rows past
        ``len(slots)`` are padding."""
        step = self.step_for(params, states, k, variant)
        buf = step.inputs["frames"]
        m = len(frames)
        if isinstance(frames, np.ndarray):
            stage_into(buf[:m], frames)
        else:
            for row, f in zip(buf, frames):
                row.copy_(f.reshape(row.shape))
        if m < k:
            buf[m:].copy_(buf[m - 1:m].expand(k - m, *buf.shape[1:]))
        step.inputs["slots"].copy_(self.index(pad_bucket(slots, k)))
        step.inputs["k_real"].fill_(len(slots))
        return step.run()

    def warm(self, params, states, k: int, variant: str | None = None):
        """Get bucket k's ``variant`` ready before the first session's frame,
        writing no slot: with graphs, its capture (warm-up steps included);
        without, one eager step of blank frames with no real session in it."""
        step = self.step_for(params, states, k, variant)
        if not step.graph:
            step.inputs["k_real"].fill_(0)
            step.run()

    def status(self, keys) -> dict:
        """{bucket: captured} for the bucket keys ``{bucket: key}``."""
        done = self.graph_cache.status()
        return {b: done.get(key, False) for b, key in keys.items()}


def on_device(device):
    """The current CUDA device set to ``device`` inside the block (a kernel
    launch, an event record and a graph replay go to the current device's
    stream); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


class Shard:
    """One dp shard of a stacked slot state: ``index``, its ``device``, the
    ``params`` there, the ``slots`` it holds (a range, slot-major), their
    stacked rows ``states`` and its own bucket step."""

    __slots__ = ("index", "device", "params", "slots", "states", "bucket")

    def __init__(self, index: int, device, params, slots: range, states, bucket: BucketStep):
        self.index, self.device, self.params = index, device, params
        self.slots, self.states, self.bucket = slots, states, bucket


def shards_status(shards: list, keys: dict, dp: int) -> dict:
    """{(bucket size, variant) -> captured on every shard} for the bucket
    keys ``keys`` ({(k, variant): engine key}): each shard's step of bucket
    k is the step of its k/dp rows."""
    local = {(k // dp, v): key for (k, v), key in keys.items()}
    per = [sh.bucket.status(local) for sh in shards]
    return {(k, v): all(p[(k // dp, v)] for p in per) for k, v in keys}


def sync_devices(devices):
    """Wait for the queued work of each CUDA device in ``devices``."""
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def replicate(tree, device):
    """``tree`` on ``device``: the same tensors where they already are there,
    else a copy."""
    return tree_map(lambda a: a if a.device == device else a.to(device), tree)


def stage_rows(frames: np.ndarray, device) -> torch.Tensor:
    """Host uint8 frames -> the device: from pinned memory without blocking
    on the card, as they are on the CPU.  One of the two H2D paths of
    frames, so one of the two H2D meters (obs/devtel.py)."""
    devtel.note_h2d(frames.nbytes)
    return _upload(frames, device)


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Readback:
    """Rows of a step's output copied to the host: each into its own pinned
    buffer, one CUDA event after them all (the CPU: the rows themselves).
    Both planes over the bucket step read their rows through it, right
    after the step on its stream: the next replay overwrites the output."""

    def __init__(self, out: torch.Tensor, n: int):
        if out.device.type == "cuda":
            self.host = [torch.empty(out.shape[1:], dtype=out.dtype, pin_memory=True)
                         for _ in range(n)]
            for i, h in enumerate(self.host):
                h.copy_(out[i], non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = [out[i] for i in range(n)], None

    def done(self) -> bool:
        """The copies have landed (polled: never blocks)."""
        return self.event is None or self.event.query()

    def row(self, i: int) -> np.ndarray:
        """Row ``i`` on the host (each rider reads its row once: the D2H
        meter of obs/devtel.py counts it here)."""
        if self.event is not None:
            self.event.synchronize()
        out = self.host[i].numpy()
        devtel.note_d2h(out.nbytes)
        return out


class ShardedReadback:
    """The rows of one step over several shards, each from its own shard's
    :class:`Readback`: ``where[i]`` = (index into ``parts``, row) of entry i."""

    def __init__(self, parts: list, where: list):
        self.parts, self.where = parts, where

    def done(self) -> bool:
        return all(p.done() for p in self.parts)

    def row(self, i: int) -> np.ndarray:
        part, r = self.where[i]
        return self.parts[part].row(r)


class MultiPeerEngine:
    """Fixed-capacity peer-slot engine.

    Slots are pre-allocated; connect/disconnect claim and release them, and
    connect installs a fresh state.  Below capacity the active slots step
    through power-of-two buckets, so an 8-slot engine with one peer does
    one peer's work (MULTIPEER_BUCKETS=0 steps every slot every time); at
    and above the largest bucket every slot steps.  Runs on ``device`` (the
    card unless the caller asks for another).  DeepCache: the JAX global
    cadence over the (k, variant) steps (``_tick``).

    ``mesh`` (``mesh.device_mesh``) with dp > 1: the peers split slot-major
    over the dp shards (:class:`Shard`), and every step steps each shard's
    every slot (no buckets, as the JAX engine on a dp mesh steps the full
    batch); ``states`` is then per shard (``_shards``)."""

    def __init__(self, models: StreamModels, params, cfg: StreamConfig, encode_prompt: Callable,
                 max_peers: int, device=None, model_id: str = "", mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_peers = max_peers
        self.models = models
        self.params = params
        self.model_id = model_id
        self.mesh = mesh
        self.dp = mesh.size("dp") if mesh is not None else 1
        if self.dp > 1 and max_peers % self.dp:
            raise ValueError(f"max_peers ({max_peers}) must be a multiple of the dp axis "
                             f"({self.dp}) so the peer axis shards evenly")
        self._template = StreamEngine(models, params, cfg, encode_prompt, device=self.device,
                                      graphs=False)
        self.states = None  # stacked [P, ...]
        self.active = [False] * max_peers
        # guards the template engine during heavy state builds (text encode
        # + prepare), apart from any caller-level step lock
        self._heavy_lock = threading.Lock()
        self._cache_interval = cfg.unet_cache_interval if cfg.unet_cache_interval >= 2 else 0
        self._tick = 0
        self._bucket_sizes = bucket_sizes(max_peers, include_capacity=False) if self.dp == 1 else []
        keys = self.bucket_keys()
        self._use_buckets = self.dp == 1 and env.get_bool("MULTIPEER_BUCKETS", True)
        self._shards = None
        if self.dp > 1:
            self._shards = [
                Shard(d, dev, replicate(params, dev), SH.shard_slots(d, self.dp, max_peers), None,
                      BucketStep(models, cfg, dev, key=lambda k, v: keys[(k * self.dp, v)]))
                for d, dev in enumerate(SH.dp_devices(mesh))]
            self._bucket = self._shards[0].bucket  # its variants; every shard steps its own
        else:
            self._bucket = BucketStep(models, cfg, self.device, key=lambda k, v: keys[(k, v)])

    def _fresh_state(self, prompt: str, seed: int) -> dict:
        with self._heavy_lock:
            return self._template.build_state(prompt, seed=seed)

    def start(self, default_prompt: str = ""):
        rows = [self._fresh_state(default_prompt, seed=i) for i in range(self.max_peers)]
        if self._shards is None:
            self.states = stack_states(rows)
        else:
            for sh in self._shards:
                sh.states = replicate(stack_states(rows[sh.slots.start:sh.slots.stop]), sh.device)
        return self

    def _row(self, slot: int) -> tuple:
        """(the stacked state that holds ``slot``, its row there)."""
        if self._shards is None:
            return self.states, slot
        sh = self._shards[SH.slot_shard(slot, self.dp, self.max_peers)]
        return sh.states, slot - sh.slots.start

    # -- slot management --------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return self.active.count(False)

    def reserve(self) -> int:
        """Cheap slot claim (no model work)."""
        try:
            slot = self.active.index(False)
        except ValueError:
            raise CapacityError(f"all {self.max_peers} peer slots in use") from None
        self.active[slot] = True
        return slot

    def build_state(self, prompt: str, seed: int) -> dict:
        """The heavy half of connect: run it outside any lock that gates the
        step."""
        return self._fresh_state(prompt, seed=seed)

    def install(self, slot: int, state: dict):
        """Cheap slot-state write (the slot's rows, in place).  DeepCache: the
        fresh slot's deep cache is zeros, so the next step captures."""
        install_row(*self._row(slot), state)
        self._tick = 0
        logger.info("peer connected -> slot %d", slot)

    def connect(self, prompt: str, seed: int | None = None) -> int:
        slot = self.reserve()
        try:
            self.install(slot, self.build_state(prompt, seed=slot if seed is None else seed))
        except Exception:
            self.active[slot] = False
            raise
        return slot

    def disconnect(self, slot: int):
        """Release a slot; connect() installs a fresh state before reuse."""
        if not 0 <= slot < self.max_peers:
            raise ValueError(f"slot {slot} out of range [0, {self.max_peers})")
        self.active[slot] = False
        logger.info("peer disconnected <- slot %d", slot)

    def encode(self, prompt: str):
        """Heavy half of a prompt update (the text encoder)."""
        with self._heavy_lock:
            return self._template._encode(prompt)

    def apply_prompt(self, slot: int, cond, uncond, extras=None):
        """The cheap half: the pre-encoded embeddings into the slot's rows, in
        place.  SDXL's pooled embeds swap with them (the JAX package's
        round-1 defect kept the old prompt's)."""
        states, row = self._row(slot)
        states["cond"][row].copy_(cond)
        states["uncond"][row].copy_(uncond)
        if self.cfg.use_added_cond and extras and "pooled" in extras:
            states["added_text"][row].copy_(extras["pooled"])
        self._tick = 0  # DeepCache: no stale deep features under a new prompt

    def update_prompt(self, slot: int, prompt: str):
        self.apply_prompt(slot, *self.encode(prompt))

    def update_t_index(self, slot: int, t_index_list):
        """Per-peer t_index update: a coefficient swap in this slot's rows
        (the length is fixed)."""
        coeffs = t_index_coeffs(self.cfg, self._template.schedule, t_index_list, self.device)
        states, row = self._row(slot)
        for name, v in coeffs.items():
            states["coeffs"][name][row].copy_(v)
        self._tick = 0  # DeepCache: new timesteps -> the next step captures

    # -- active-count buckets ---------------------------------------------------

    def _bucket_for(self, n_active: int):
        """Smallest bucket covering ``n_active``, or None for the step of
        every slot."""
        if not self._use_buckets or n_active == 0:
            return None
        return bucket_for(self._bucket_sizes, n_active)

    def bucket_keys(self) -> dict:
        """{(bucket size, variant) -> engine key} for every step this engine
        takes: the JAX multipeer recipe (``peers``, with DeepCache
        ``variant``, w8 params ``quant``) for the step of every slot, plus
        ``sbucket`` for the buckets below it."""
        qextra = params_variant_extra(self.params)
        return {(k, v): stream_engine_key(self.model_id, self.cfg, peers=self.max_peers,
                                          **({} if k == self.max_peers else {"sbucket": k}),
                                          **({"variant": v} if v != "full" else {}), **qextra)
                for k in self._bucket_sizes + [self.max_peers] for v in unet_variants(self.cfg)}

    def graph_status(self) -> dict:
        """{(bucket size, variant) -> captured} (False throughout when
        stepping eagerly; on a dp mesh, captured on every shard)."""
        keys = self.bucket_keys()
        if self._shards is None:
            return self._bucket.status(keys)
        return shards_status(self._shards, keys, self.dp)

    def prewarm_buckets(self):
        """Capture every bucket size and variant, and the step of every
        slot, on the calling thread (the thread that will step them),
        writing no slot's state (eagerly: step each once): no peer's first
        frame pays a capture, a launch path's first use or a new thread's
        library handles.  The build scopes keep the JAX labels
        (``peers-<k>:full`` for the full or capture graph, ``:cached``)."""
        for k, v in self.bucket_keys():
            with devtel.compile_scope(f"peers-{k}:{'cached' if v == 'cached' else 'full'}"):
                if self._shards is None:
                    self._bucket.warm(self.params, self.states, k, v)
                for sh in self._shards or ():
                    with on_device(sh.device):
                        sh.bucket.warm(sh.params, sh.states, k // self.dp, v)
            logger.info("prewarmed multipeer bucket %d/%d (%s)", k, self.max_peers, v)
        sync_devices({sh.device for sh in self._shards or ()} or {self.device})

    # -- hot path ---------------------------------------------------------------

    def step_all(self, frames: np.ndarray) -> np.ndarray:
        """frames [P, H, W, 3] uint8 -> [P, H, W, 3] uint8 (all slots)."""
        return self.fetch(self.submit(frames))

    def submit(self, frames: np.ndarray):
        """Dispatch one step of the active slots (all slots at and above the
        largest bucket) without waiting for the device."""
        if self.states is None and (self._shards is None or self._shards[0].states is None):
            raise RuntimeError("call start() first")
        if frames.shape[0] != self.max_peers:
            raise ValueError(f"expected {self.max_peers} frame slots, got {frames.shape[0]}")
        active = [i for i, a in enumerate(self.active) if a]
        k = self._bucket_for(len(active))
        slots = active if k is not None else list(range(self.max_peers))
        k = k or self.max_peers
        variant = self._bucket.variants[0]
        if self._cache_interval:
            # the global cadence: every slot captures on the same tick
            if self._tick % self._cache_interval != 0:
                variant = "cached"
            self._tick += 1
        if self._shards is not None:
            return self._step_shards(frames, variant), slots
        out = self._bucket(self.params, self.states, frames[pad_bucket(slots, k)], slots, k,
                           variant)
        return Readback(out, len(slots)), slots

    def _step_shards(self, frames: np.ndarray, variant: str) -> ShardedReadback:
        """Every shard's every slot, shard after shard, each shard's peers'
        frames staged onto its own device."""
        per = self.max_peers // self.dp
        parts = []
        for sh in self._shards:
            with on_device(sh.device):
                out = sh.bucket(sh.params, sh.states, frames[sh.slots.start:sh.slots.stop],
                                list(range(per)), per, variant)
                parts.append(Readback(out, per))
        return ShardedReadback(parts, [(d, r) for d in range(self.dp) for r in range(per)])

    def fetch(self, pending) -> np.ndarray:
        """-> [P, H, W, 3] uint8; the rows of slots not stepped are zeros."""
        readback, slots = pending
        out = np.zeros((self.max_peers, self.cfg.height, self.cfg.width, 3), np.uint8)
        for i, s in enumerate(slots):
            out[s] = readback.row(i)
        return out
