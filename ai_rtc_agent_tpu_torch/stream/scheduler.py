"""Cross-session continuous batching: many sessions, one step on the card
(counterpart of ai_rtc_agent_tpu/stream/scheduler.py).

* Each session owns a slot of a stacked state ``[S, ...]`` (prompt
  embeddings, guidance and delta, coefficients, noise, stock, the latent
  ring), so sessions keep independent control planes: a prompt, t-index or
  guidance update touches one slot's rows.
* ``submit`` stages the frame on the device (from pinned memory, on the
  caller's thread) and enqueues it into the session's bounded coalescing
  window (a :class:`DeadlineQueue`; a shed frame's waiter resolves at once
  as passthrough, a ``ShedFrame``).
* One dispatcher thread drains every waiting session into ONE bucket step
  (parallel/multipeer.py ``BucketStep``) at the nearest power-of-two
  bucket: 32 attention launches and one epilogue launch whatever the
  occupancy.  Padding repeats the last session's row and writes nothing.
  It dispatches at once when every live session has a frame waiting or
  only one session is live; otherwise it waits out the window
  (BATCHSCHED_WINDOW_MS, 3 ms) from the oldest waiting frame and goes with
  who showed up.  At most PIPELINE_DEPTH steps are in flight.
* Each session's fetch resolves only its own row: the step's rows are
  copied to the host into separate pinned buffers, one CUDA event after
  them all.

Every step runs on the dispatcher thread (the JAX scheduler dispatches
inline on a submitter's thread when the batch is complete, which here
would put steps on whichever worker thread submitted).  The batches and
their order are the JAX scheduler's.  On the card each bucket size is one
CUDA graph (``BucketStep``), keyed by the JAX recipe (:meth:`bucket_keys`)
and captured by ``prewarm_buckets`` on the dispatcher thread before it
serves (BATCHSCHED_PREWARM; with it off, a bucket's first use captures
it there): the counterpart of the JAX scheduler's per-bucket executables.
A dispatch copies the waiting frames, the padded slot layout and the count
into the bucket's static buffers and replays it.

With frame_buffer_size fbs > 1 each session's window coalesces fbs
consecutive frames into one row of its slot ([k, fbs, H, W, 3]); each
frame's handle resolves to its own slice of the session's row (the JAX
scheduler's second batch axis).  The similarity filter stays fbs == 1 only.

The engine fault domain (resilience/engine_guard.py) attaches through
:meth:`attach_guard`: every bucket step then runs on the guard's runner
under its deadline and ends at its completion event, polled (a stalled
device trips the guard as a wedged launch does; nothing waits in an
unbounded synchronize).  A snapshot bank clones each live slot's rows after
a step (ENGINE_SNAPSHOT_EVERY_S); a trip quarantines the plane (frames
shed to passthrough, claims refused) and :meth:`rebuild_engine` builds new
static buffers and a new graph pool, restores every banked row bit for bit
and captures every bucket again.  The plane carries an epoch, bumped by a
rebuild: a step held past it (a fault, a stall) is dropped before it
replays, and the old plane stays alive until an event recorded after its
abandoned work has completed.  A session's claim or restart needs no
epoch of its own: it installs under the step lock, which a dispatch holds
until its step completes or trips the guard, and while the guard is not
armed claims are refused and restarts are the rebuild's.  The amortised step latency (dt / occupancy) feeds the
admission EWMA through :attr:`on_step`.

Outputs are a dedicated engine's for the same state row and frames
(tests/test_torch_scheduler.py on the CPU, chip_smoke.py phase 6 on the
card).

Live migration (:meth:`snapshot_session`, :meth:`restore_session`, the
JAX scheduler's schema 2): a session's state row goes out as the pytree
wire codec's blob (parallel/checkpoint.py, the JAX bytes) with its control
plane, and comes in written into a free slot in place (``install_row``:
the captured graphs read the stacked buffers' storage, so a leaf is never
rebound).  The row is gathered under the step lock, on the stepping
stream, into a fresh buffer (``states[..][slot]`` is a view the next
replay overwrites) and pulled to the host outside the lock.  A mismatched
schema, fingerprint or row, or a full slot pool, is refused before any
state is touched.  The fingerprint equals the JAX scheduler's for the same
configuration, so a JAX snapshot restores here and back.  The engine
guard's bank is refreshed on the device; at quarantine its rows go to the
host once and become full snapshot dicts (:meth:`capture_quarantine_snapshots`),
which a quarantined :meth:`snapshot_session` serves and the rebuild
restores from.

The dp session axis (``dp=`` over ``devices=``, BATCHSCHED_DP or MESH_SHAPE's dp):
one process drives dp devices (``parallel/mesh.device_mesh``), and the
stacked state splits slot-major into shards (parallel/sharding.py's
session-axis rules; ``max_sessions`` must be a multiple of dp).  Each
shard holds its own copy of the params on its device, its slots' rows and
its own bucket steps, captured per (k/dp, variant); a bucket step of size
k launches each shard's step that carries a rider, one after another from
the stepping thread, each shard's epilogue reading its own count of real
sessions from device memory, and each shard's rows come back through its
own readback.  The bucket sizes start at dp and double (the JAX sizes, so
the keys, which gain ``dp-N``, and the ``:dp<N>`` labels are the JAX
ones); a dispatch takes the smallest bucket whose k/dp rows hold its
busiest shard's riders (a rider always steps on its own shard, so no row
crosses devices), and a shard with no rider is not stepped.  A claim takes
a free slot on the least-loaded shard (ties to the lowest slot), a
session's frames are staged onto its own shard's device, and its /health
entry names its ``shard``.  Prewarm, installs, control writes, snapshots,
the bank and the guard's rebuild all work shard by shard.

The speed variants ride the same bucket steps, as in the JAX scheduler.
``QUANT_WEIGHTS=w8`` params serve unchanged (the dequant lives in the layer
primitives; the keys and the fingerprint gain ``quant``).  DeepCache
(``unet_cache_interval`` N >= 2) keeps a capture and a cached step per
bucket size, keyed (k, variant), both captured at prewarm, on one global
cadence: a bucket step captures when ``tick % N == 0`` or when any rider's
slot is uncaptured (installed, restored, recovered, or given a new prompt
or t-indices since its last capture: its deep-cache row is zeros or
stale), and the cached step runs otherwise.  A snapshot carries the
session's row with its deep cache and the cadence's ``cache_tick`` /
``cache_uncaptured``; a restored slot rides a capture first.

Per-session style adapters (``adapters=``, an adapters/ ``AdapterRegistry``
with a non-zero ``bank_rank``): the registry's bank shape (rank, target
set) is bound once at construction, and the stacked state gains an
``adapters`` subtree {target path: {"down": [S, R, in], "up": [S, out,
R]}} in the compute dtype, every slot born on the zero rows (bit for bit
the base model).  Each row of a bucket step meets its own session's factors
(stream/engine.py ``styled_runner``).  A claim's ``adapter=``, a session's
and the global :meth:`update_adapter` are checked against the registry
before any state is touched and written in place under the step lock (one
``copy_`` per factor into the slot's row), so the captured graphs read the
new style at their next replay and nothing is captured again; with
DeepCache a swap makes the slot uncaptured, as a prompt write does.  The
keys gain ``lrank-R``, the fingerprint ``adapter_rank`` and
``adapter_targets`` (the JAX digest), a snapshot the ``adapter`` name, and
its row carries the factors, so a styled session moves bit for bit.

A ControlNet configuration's rows carry the conditioning ring and scale
(``cnet_cond``, ``cnet_scale``; stream/engine.py), which a snapshot's row
carries as the JAX row does.  The fingerprint keeps the JAX keys, which
name no ControlNet, so a ControlNet row offered to a plain scheduler (or the
reverse) is refused by the row's structure, as the JAX scheduler refuses it.
"""

from __future__ import annotations

import base64
import binascii
import logging
import threading
import time
from collections import deque
from concurrent.futures import CancelledError, Future, InvalidStateError

import numpy as np
import torch

from .. import resolve_device
from ..adapters.registry import targets_digest
from ..aot.cache import adapter_key_extra, mesh_key_extra, stream_engine_key
from ..obs import devtel
from ..obs.trace import get_trace
from ..parallel import sharding as SH
from ..parallel.checkpoint import deserialize_pytree, serialize_pytree
from ..parallel.mesh import device_mesh
from ..parallel.multipeer import (
    BucketStep,
    CapacityError,
    Readback,
    Shard,
    ShardedReadback,
    bucket_for,
    bucket_sizes,
    on_device,
    replicate,
    shards_status,
    stage_rows,
    sync_devices,
)
from ..resilience import faults as _faults
from ..resilience.overload import DeadlineQueue, ShedFrame, shed_to_passthrough
from ..tree import tree_map
from ..utils import env
from .engine import (
    SimilarityFilter,
    StaleStepError,
    StreamEngine,
    coeff_state,
    install_row,
    params_variant_extra,
    stack_states,
    t_index_coeffs,
    unet_variants,
)
from .pipeline import (
    DEFAULT_DELTA,
    DEFAULT_GUIDANCE_SCALE,
    DEFAULT_PROMPT,
    coerce_frame,
    finish_output,
)

logger = logging.getLogger(__name__)

__all__ = ["BatchScheduler", "ScheduledSession", "CapacityError", "SESSION_SNAPSHOT_SCHEMA",
           "SnapshotMismatch"]

POLL_S = 2e-4  # the completion poll of a guarded step

# the layout of snapshot_session()/restore_session(): the JAX scheduler's
# version, so snapshots cross between the packages (the blob carries its own
# byte-layout version inside)
SESSION_SNAPSHOT_SCHEMA = 2


class SnapshotMismatch(ValueError):
    """A session snapshot does not fit this scheduler: another schema, model,
    geometry or variant fingerprint, or a state row whose structure, shape
    or dtype differs from the stacked state's.  Restore refuses; the source
    keeps serving."""


class _PendingFrame:
    """One enqueued frame: its waiter future, the staged device copy, the
    stamps the gauges read and the frame's trace (obs/trace.py)."""

    __slots__ = ("frame", "frame_dev", "future", "t_enq", "t_dispatch", "occupancy", "skipped",
                 "sub", "trace")

    def __init__(self, frame, trace=None):
        self.frame = frame  # host pixels (shed passthrough, similarity)
        self.trace = trace
        self.frame_dev = None  # [1,H,W,3] on the device
        self.future: Future = Future()
        self.t_enq = time.monotonic()
        self.t_dispatch: float | None = None
        self.occupancy = 0
        self.skipped = False
        self.sub = 0  # with fbs > 1: this frame's place in its session's row


class _DispatchedBatch:
    """One bucket step's readback; ``resolved`` flips at its first row, or
    once every rider's session is released (a closed connection fetches
    nothing), so that it stops counting as in flight."""

    __slots__ = ("readback", "t_dispatch", "riders", "resolved", "occupancy", "feed")

    def __init__(self, readback: Readback, t_dispatch: float, riders: list, feed: bool):
        self.readback = readback
        self.t_dispatch = t_dispatch
        self.riders = set(riders)  # the slots that rode it, until released
        self.resolved = False
        self.occupancy = len(riders)
        # False on a bucket's first use (its capture rode the step): no
        # capacity sample for the admission EWMA
        self.feed = feed


class ScheduledSession:
    """One claimed slot: the pipeline surface the track drives (``__call__``,
    ``submit``/``fetch``, ``submit_batch``/``fetch_batch``,
    ``update_prompt``, ``update_t_index_list``, ``update_guidance``,
    ``restart``) over the shared scheduler."""

    # the scheduler feeds the admission EWMA the amortised step latency
    # itself; the supervisor's wrapper must not feed the raw one too
    owns_step_signal = True

    def __init__(self, owner: "BatchScheduler", slot: int, session_key: str, prompt: str,
                 seed: int):
        self._owner = owner
        self.slot = slot
        self.session_key = session_key
        # the live control plane: restart() restores these
        self.prompt = prompt
        self.guidance_scale = owner.guidance_scale
        self.delta = owner.delta
        self.t_index_list = list(owner.t_index_list)
        self.adapter: str | None = None  # the style riding this slot's factor rows
        self._seed = seed
        self._released = False
        cfg = owner.cfg
        # per-session: one session's still scene never skips another's frames
        self._sim = (
            SimilarityFilter(cfg.similar_image_threshold, cfg.similar_image_max_skip, seed=0)
            if cfg.similar_image_filter else None
        )
        self._last_pending: _PendingFrame | None = None
        self._had_output = False
        self.frames_submitted = 0
        self.frames_skipped_similar = 0

    @property
    def frame_buffer_size(self) -> int:
        """fbs consecutive frames ride one step as one row of this slot (the
        track batches them through submit_batch)."""
        return self._owner.fbs

    def submit_batch(self, frames):
        """fbs consecutive frames -> their handles (one group of the slot)."""
        return [self.submit(f) for f in frames]

    def fetch_batch(self, handles, src_frames=None):
        """The outputs of a :meth:`submit_batch`, each its own slice of the
        session's row."""
        return [self.fetch(h, src_frames[i] if src_frames else None)
                for i, h in enumerate(handles)]

    @property
    def window_queue(self) -> DeadlineQueue:
        return self._owner._queues[self.slot]

    def submit(self, frame):
        """Coerce, stage and enqueue one frame; -> a handle for :meth:`fetch`.
        A similarity skip never enters the window: its handle resolves with
        the previous submit's output."""
        trace = get_trace(frame)
        if trace is None:
            return self._submit_arr(coerce_frame(frame, self._owner.height, self._owner.width))
        with trace.span("submit"):
            handle = self._submit_arr(
                coerce_frame(frame, self._owner.height, self._owner.width), trace)
        if handle.skipped:
            trace.mark("similar_skip")
        return handle

    def _submit_arr(self, arr: np.ndarray, trace=None) -> _PendingFrame:
        self.frames_submitted += 1
        last = self._last_pending
        if self._sim is not None and self._sim.should_skip(
            arr, have_output=self._had_output and last is not None
        ):
            self.frames_skipped_similar += 1
            p = _PendingFrame(arr, trace)
            p.skipped = True

            def copy(f, p=p):
                if f.cancelled():
                    p.future.cancel()
                elif f.exception() is not None:
                    p.future.set_exception(f.exception())
                else:
                    p.future.set_result(f.result())

            last.future.add_done_callback(copy)
            return p
        p = _PendingFrame(arr, trace)
        p.frame_dev = stage_rows(arr[None], self._owner._slot_device(self.slot))
        self._owner._enqueue(self.slot, p)
        if self._sim is not None:
            self._last_pending = p
        return p

    def fetch(self, handle: _PendingFrame, src_frame=None):
        """Resolve a handle to this session's output frame (its own row of
        the step it rode).  A shed frame comes back as the ``ShedFrame``.
        With a trace: ``batch_join`` (enqueue -> dispatch), ``engine_step``
        (dispatch -> the row resolved on the host: a replay returns at
        once, so the step ends at its readback's completion, never at the
        launch), the ``batch_k<occupancy>`` mark, ``fetch`` (the blocking
        resolve) and ``postprocess``."""
        trace = handle.trace
        if trace is None and src_frame is not None:
            trace = get_trace(src_frame)
        t0 = time.monotonic()
        try:
            out = handle.future.result(timeout=self._owner.fetch_timeout)
        except CancelledError:  # released with this frame queued
            return ShedFrame(handle.frame)
        if isinstance(out, ShedFrame):
            return out
        out = self._owner._resolve_row(*out, t0=t0)
        t1 = time.monotonic()
        if self._owner.fbs > 1:
            out = out[handle.sub]
        self._had_output = True
        if trace is not None:
            td = handle.t_dispatch
            if td is not None and not handle.skipped:
                # a similarity skip rode no step of its own: its marker says so
                trace.add_span("batch_join", handle.t_enq, td)
                trace.add_span("engine_step", td, t1)
                if handle.occupancy:
                    trace.mark(f"batch_k{handle.occupancy}")
            trace.add_span("fetch", t0, t1)
        return finish_output(out, src_frame, self._owner.safety_checker, trace=trace)

    def __call__(self, frame):
        return self.fetch(self.submit(frame), frame)

    # -- per-session control plane ----------------------------------------------

    def update_prompt(self, prompt: str):
        self._owner._apply_prompt(self.slot, self._owner._encode(prompt))
        self.prompt = prompt

    def update_t_index_list(self, t_index_list):
        self._owner._apply_t_index(self.slot, t_index_list)
        self.t_index_list = [int(t) for t in t_index_list]

    def update_guidance(self, guidance_scale=None, delta=None):
        g = None if guidance_scale is None else float(guidance_scale)
        d = None if delta is None else float(delta)
        self._owner._apply_guidance(self.slot, g, d)
        if g is not None:
            self.guidance_scale = g
        if d is not None:
            self.delta = d

    def update_adapter(self, name: str | None):
        """Swap this slot's style-adapter factor rows (``None``: back to the
        zero rows), in place; checked against the registry before any
        state is touched, and never a capture."""
        self._owner._apply_adapter(self.slot, name)
        self.adapter = name

    def restart(self):
        """A fresh stream state for this slot with the live prompt,
        guidance, delta, t-indices and adapter (the supervisor's recovery hook).
        While the engine guard holds the plane quarantined this is its
        rebuild's job (the banked row is restored bit for bit): report
        success, so that the session goes on serving passthrough."""
        if self._owner.quarantined:
            return
        state = self._owner._build_state(self.prompt, self.guidance_scale, self.delta,
                                         self._seed, self.t_index_list, self.adapter)
        self._owner._install(self.slot, state)

    def release(self):
        if not self._released:
            self._released = True
            self._owner.release(self.slot)

    def snapshot(self) -> dict:
        """/health's per-session scheduler view (the JAX keys)."""
        q = self.window_queue
        out = {
            "slot": self.slot,
            "frames_submitted": self.frames_submitted,
            "frames_skipped_similar": self.frames_skipped_similar,
            "window_depth": q.depth,
            "window_shed": q.shed_overflow + q.shed_stale,
        }
        if self._owner.dp > 1:
            out["shard"] = self._owner._slot_shard(self.slot)  # where its state row lives
        if self._owner._adapter_rank:
            # the style riding this slot's factor rows and the bank's rank
            out["adapter"] = self.adapter
            out["adapter_rank"] = self._owner._adapter_rank
        return out


class BatchScheduler:
    """Owns the stacked session states, the bucket step and the dispatcher;
    each connection claims a session (:meth:`claim`).  Runs on ``device``
    (the card unless the caller asks for another)."""

    # steps in flight: step N's readback overlaps step N+1's launch
    PIPELINE_DEPTH = 2

    def __init__(self, models, params, cfg, encode_prompt, *, model_id: str = "",
                 max_sessions: int | None = None, window_ms: float | None = None,
                 queue_bound: int | None = None, fetch_timeout: float = 120.0,
                 default_prompt: str = "", guidance_scale: float | None = None,
                 delta: float | None = None, schedule=None, prewarm: bool | None = None,
                 device=None, graphs: bool | None = None, safety_checker=None,
                 adapters=None, dp: int | None = None, devices=None):
        """``graphs`` (default: on a CUDA device): each bucket size steps by
        replaying its captured CUDA graph; False steps eagerly.
        ``dp`` (default BATCHSCHED_DP): the session axis's shards, over
        ``devices`` (default ``cuda:0 .. cuda:dp-1``; more shards than
        devices raises): ``mesh.device_mesh(dp, devices)``.
        ``safety_checker`` (a models/safety.py ``SafetyChecker``, or None)
        gates each rider's output at its fetch.  ``adapters`` (an
        adapters/ ``AdapterRegistry``, or None): the style catalog whose
        bank shape this scheduler binds; an empty one keeps the factors
        path off, the state and keys an adapterless build's."""
        self.device = resolve_device(device)
        self.fbs = int(cfg.frame_buffer_size)
        if self.fbs > 1 and cfg.similar_image_filter:
            raise ValueError(
                "the scheduler's consecutive-frame batching (fbs>1) is incompatible with the "
                "similarity filter: a skipped frame would desync the fbs group boundaries")
        self.cfg = cfg
        self.model_id = model_id
        self.height, self.width = cfg.height, cfg.width
        self.max_sessions = (env.get_int("BATCHSCHED_MAX_SESSIONS", 8)
                             if max_sessions is None else int(max_sessions))
        if self.max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        self.window_s = (env.get_float("BATCHSCHED_WINDOW_MS", 3.0)
                         if window_ms is None else float(window_ms)) / 1e3
        self.queue_bound = (env.get_int("BATCHSCHED_QUEUE_BOUND", 2 * self.fbs)
                            if queue_bound is None else int(queue_bound))
        if self.queue_bound < self.fbs:
            raise ValueError(
                f"queue_bound ({self.queue_bound}) must hold at least one fbs group "
                f"({self.fbs}) or no frame could ever dispatch")
        # the session axis: a trivial mesh keeps the single-device scheduler exactly
        dp = env.batchsched_dp() if dp is None else max(1, int(dp))
        self.mesh = device_mesh(dp, devices) if dp > 1 else None
        self.dp = dp
        if self.dp > 1 and self.max_sessions % self.dp != 0:
            raise ValueError(
                f"max_sessions ({self.max_sessions}) must be a multiple of the dp axis "
                f"({self.dp}) so the session axis shards evenly")
        self.fetch_timeout = fetch_timeout
        self.safety_checker = safety_checker
        # defaults for new sessions; the global update_* methods move them
        self.prompt = default_prompt or DEFAULT_PROMPT
        self.guidance_scale = DEFAULT_GUIDANCE_SCALE if guidance_scale is None else guidance_scale
        self.delta = DEFAULT_DELTA if delta is None else delta
        self.t_index_list = list(cfg.t_index_list)
        # style adapters: the bank's shape (rank, targets) is bound here, once
        self.adapters = adapters
        self._adapter_rank = int(adapters.bank_rank) if adapters is not None else 0
        self._adapter_targets = dict(adapters.targets) if self._adapter_rank else {}
        self.default_adapter: str | None = None  # the global /config default
        self.adapter_swaps_total = 0
        self.params = params
        # the admission feed: callable(dt_s, occupancy), dt amortised per session
        self.on_step = None
        self._template = StreamEngine(models, params, cfg, encode_prompt, schedule=schedule,
                                      device=self.device, graphs=False)
        S = self.max_sessions
        # every bucket is a multiple of dp: each shard steps k/dp rows
        self._bucket_sizes = bucket_sizes(S, first=self.dp)
        # DeepCache: the global cadence over the (k, variant) steps; the slots
        # whose deep-cache row must not be read until a capture carries them
        self._variants = unet_variants(cfg)
        self._cache_interval = cfg.unet_cache_interval if cfg.unet_cache_interval >= 2 else 0
        self._tick = 0
        self._uncaptured: set = set()
        self._shard_params = ([params] if self.dp == 1 else
                              [replicate(params, d) for d in SH.dp_devices(self.mesh)])
        self._graphs = graphs
        # (k, variant, shard) stepped or captured there (a cold step captures)
        self._warmed: set = set()
        # one template state, stacked: a claim installs its own before any
        # frame; the factor bank stacks with it, every slot on the zero rows
        template = self._template.build_state(self.prompt, guidance_scale=self.guidance_scale,
                                              delta=self.delta, seed=0)
        if self._adapter_rank:
            template["adapters"] = self._adapter_rows(None)
        self._shards = self._new_shards([template] * S)
        self.active = [False] * S
        self._sessions: dict = {}  # slot -> ScheduledSession
        self._queues = [DeadlineQueue(self.queue_bound, on_evict=self._evict) for _ in range(S)]
        self._heavy_lock = threading.Lock()  # the template engine (encode, prepare)
        self._step_lock = threading.Lock()  # the stacked states: steps, installs, writes
        self._lock = threading.Lock()  # slots, windows, batches in flight
        self._has_work = threading.Condition(self._lock)
        self._stop = False
        self._batches: deque = deque(maxlen=16)  # dispatched, for the in-flight count
        self._stats_lock = threading.Lock()
        self._occ: deque = deque(maxlen=512)
        self._waits: deque = deque(maxlen=512)
        self._occ_hist: dict = {}
        self.steps_total = 0
        # -- the engine fault domain (resilience/engine_guard.py) ---------------------
        self._guard = None
        self._fault_scope = _faults.scope("engine")
        # the plane's epoch: a step records it at dispatch and replays only
        # if it still holds, under the epoch lock (a rebuild bumps it)
        self._epoch = 0
        self._epoch_lock = threading.Lock()
        self._retired: list = []  # (event, old plane): alive until the event completes
        # snapshot bank: each live slot's rows cloned after a step, on a
        # cadence (<= 0 banks nothing; the rebuild then starts from each
        # session's control plane)
        self._snap_every_s = env.get_float("ENGINE_SNAPSHOT_EVERY_S", 5.0)
        self._snap_rows: dict = {}  # slot -> cloned state rows
        self._snap_ready: dict = {}  # shard -> the CUDA event after its bank's gather
        self._last_snap_t = 0.0
        self._quarantine_snaps: dict = {}  # session key -> banked snapshot dict, at the trip
        self._prewarm = env.get_bool("BATCHSCHED_PREWARM", True) if prewarm is None else prewarm
        self._started = threading.Event()
        self._start_error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="batchsched-dispatch", daemon=True)
        self._thread.start()
        self._started.wait()
        if self._start_error is not None:
            self._thread.join(timeout=10)
            raise self._start_error

    def _new_shards(self, rows: list) -> list:
        """The plane: each shard's stacked rows (``rows``: one state per slot),
        on its device, and its bucket step with its own static buffers and
        graph pool (a shard's step of k/dp rows keyed as bucket k)."""
        keys = self.bucket_keys()
        devices = [self.device] if self.dp == 1 else SH.dp_devices(self.mesh)
        shards = []
        for d, dev in enumerate(devices):
            slots = SH.shard_slots(d, self.dp, self.max_sessions)
            bucket = BucketStep(self._template.models, self.cfg, dev, graphs=self._graphs,
                                key=lambda k, v: keys[(k * self.dp, v)])
            shards.append(Shard(d, dev, self._shard_params[d], slots,
                                replicate(stack_states(rows[slots.start:slots.stop]), dev), bucket))
        return shards

    @property
    def states(self) -> dict:
        """The stacked state ``[S, ...]`` of a single-device scheduler (on a dp
        mesh each shard holds its own: :meth:`shard_states`)."""
        if self.dp > 1:
            raise RuntimeError(f"a dp={self.dp} scheduler's state is per shard: shard_states()")
        return self._shards[0].states

    @property
    def _bucket(self) -> BucketStep:
        if self.dp > 1:
            raise RuntimeError(f"a dp={self.dp} scheduler steps per shard")
        return self._shards[0].bucket

    def shard_states(self) -> list:
        """Each shard's stacked rows, in shard order (shard d holds the slots
        ``sharding.shard_slots(d, dp, max_sessions)``)."""
        return [sh.states for sh in self._shards]

    def _row(self, slot: int) -> tuple:
        """(the shard that holds ``slot``, its row there)."""
        sh = self._shards[self._slot_shard(slot)]
        return sh, slot - sh.slots.start

    def _slot_shard(self, slot: int) -> int:
        """slot -> its shard (slot-major; the JAX ``_slot_shard``): the one
        definition of a row's residence (staging, the bucket layout,
        /health, /metrics)."""
        return SH.slot_shard(slot, self.dp, self.max_sessions)

    def _slot_device(self, slot: int):
        """The device of the shard that holds ``slot``'s state row: where the
        session's frames are staged."""
        return self._shards[self._slot_shard(slot)].device

    @classmethod
    def from_pipeline(cls, pipeline, **kw) -> "BatchScheduler":
        """A scheduler serving what ``pipeline`` (a StreamDiffusionPipeline)
        serves: its weights, config, prompt encoder, schedule, device, graphs
        setting, safety checker and live prompt, guidance and delta as the
        defaults (``adapters=`` and the rest pass through)."""
        eng = pipeline.engine
        if eng.mesh is not None and any(n > 1 for n in eng.mesh.shape.values()):
            raise ValueError(
                "the batch scheduler owns its own session-axis (dp) mesh; an engine built on a "
                "tp/sp mesh keeps the shared-engine path (those axes shard the MODEL, not the "
                "sessions)")
        kw.setdefault("graphs", eng.graphs)
        return cls(eng.models, eng.params, pipeline.config, eng.encode_prompt,
                   model_id=pipeline.model_id, default_prompt=pipeline.prompt,
                   guidance_scale=pipeline.guidance_scale, delta=pipeline.delta,
                   schedule=eng.schedule, device=pipeline.device,
                   safety_checker=pipeline.safety_checker, **kw)

    # -- session lifecycle --------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return self.active.count(False)

    def claim(self, session_key: str | None = None, prompt: str | None = None,
              seed: int | None = None, adapter: str | None = None) -> ScheduledSession:
        """Claim a slot for a new connection; raises CapacityError when full
        or while the engine guard holds the plane quarantined (the agent
        answers 503 with Retry-After).  The state build runs outside the
        locks, so live sessions keep stepping.  ``adapter``: the session's
        style (default: :attr:`default_adapter`), checked against the
        registry before a slot is taken."""
        if self.quarantined:
            raise CapacityError("engine quarantined — rebuild in progress")
        adapter = self.default_adapter if adapter is None else adapter
        self._adapter_rows(adapter)  # an unknown name takes no slot
        with self._lock:
            slot = self._pick_slot_locked()
            self.active[slot] = True
        prompt = self.prompt if prompt is None else prompt
        seed = slot if seed is None else seed
        try:
            state = self._build_state(prompt, self.guidance_scale, self.delta, seed,
                                      self.t_index_list, adapter)
            sess = ScheduledSession(self, slot, session_key or f"slot-{slot}", prompt, seed)
            sess.adapter = adapter
            self._install(slot, state)
        except Exception:
            with self._lock:
                self.active[slot] = False
            raise
        with self._lock:
            self._sessions[slot] = sess
        logger.info("batchsched session claimed -> slot %d", slot)
        return sess

    def _pick_slot_locked(self) -> int:
        try:
            if self.dp > 1:
                # a free slot on the least-loaded shard (ties to the lowest
                # slot), so the live rows spread over the shards
                loads = [0] * self.dp
                for s, live in enumerate(self.active):
                    if live:
                        loads[self._slot_shard(s)] += 1
                return min((s for s, live in enumerate(self.active) if not live),
                           key=lambda s: (loads[self._slot_shard(s)], s))
            return self.active.index(False)
        except ValueError:
            raise CapacityError(f"all {self.max_sessions} scheduler session slots in use") from None

    def release(self, slot: int):
        if not 0 <= slot < self.max_sessions:
            raise ValueError(f"slot {slot} out of range [0, {self.max_sessions})")
        with self._has_work:
            self.active[slot] = False
            self._sessions.pop(slot, None)
            for b in self._batches:  # no fetch will come from this slot
                b.riders.discard(slot)
                if not b.riders and not b.resolved:
                    b.resolved = True
                    self._has_work.notify()
        q = self._queues[slot]
        while (got := q.pop()) is not None:
            got[0].future.cancel()
        logger.info("batchsched session released <- slot %d", slot)

    # -- live session migration (snapshot / restore) ----------------------------------

    def session(self, session_key: str) -> ScheduledSession | None:
        """The live session claimed under ``session_key``, or None."""
        for sess in list(self._sessions.values()):
            if sess.session_key == session_key:
                return sess
        return None

    def snapshot_fingerprint(self) -> dict:
        """What must match for a snapshot to restore here: the JAX
        scheduler's keys and values for the same configuration, the
        DeepCache interval, the params variant (w8) and a bound factor
        bank's rank and target digest included (an adapterless scheduler
        omits the adapter keys, as the JAX one does)."""
        fp = {
            "model_id": self.model_id,
            "height": self.height,
            "width": self.width,
            "fbs": self.fbs,
            "n_stages": int(self.cfg.n_stages),
            "dtype": str(self.cfg.torch_dtype).rsplit(".", 1)[-1],
            "unet_cache": int(self._cache_interval),
            "similar_filter": bool(self.cfg.similar_image_filter),
            "quant": str(params_variant_extra(self.params).get("quant", "")),
        }
        if self._adapter_rank:
            fp["adapter_rank"] = self._adapter_rank
            fp["adapter_targets"] = targets_digest(self._adapter_targets)
        return fp

    def snapshot_session(self, session_key: str) -> dict:
        """One live session for migration: its state row (the wire codec's
        blob, bit for bit) and its control plane, under the versioned
        schema.  While the guard holds the plane quarantined, the snapshot
        banked at the trip.  Frames still in the window stay here: this
        scheduler keeps serving until the client moves."""
        if self.quarantined:
            snap = self._quarantine_snaps.get(session_key)
            if snap is not None:
                return dict(snap)
            raise KeyError(f"no banked snapshot for quarantined session {session_key!r}")
        sess = self.session(session_key)
        if sess is None:
            raise KeyError(f"no live scheduler session {session_key!r}")
        with self._step_lock:
            if self._sessions.get(sess.slot) is not sess:
                # released between the lookup and the lock (its slot may be
                # another session's now): never pair two sessions' halves
                raise KeyError(f"session {session_key!r} released mid-export")
            # a fresh buffer on the stepping stream: the next replay writes
            # the slot's view, never this copy
            sh, i = self._row(sess.slot)
            row = tree_map(lambda a: a[i].clone(), sh.states)
            cache_tick, uncaptured = self._tick, sess.slot in self._uncaptured
        return self._row_snapshot(sess, tree_map(lambda a: a.cpu(), row), cache_tick, uncaptured)

    def _row_snapshot(self, sess: ScheduledSession, row: dict, cache_tick: int,
                      cache_uncaptured: bool) -> dict:
        """A session's full snapshot dict from a state row on the host (the
        live export and the quarantine bank).  The DeepCache cadence rides
        along for observability, as in the JAX snapshot: a restore marks
        the slot uncaptured whatever it says."""
        snap = {
            "schema": SESSION_SNAPSHOT_SCHEMA,
            "kind": "scheduler",
            "fingerprint": self.snapshot_fingerprint(),
            "session": sess.session_key,
            "prompt": sess.prompt,
            "guidance_scale": float(sess.guidance_scale),
            "delta": float(sess.delta),
            "t_index_list": [int(t) for t in sess.t_index_list],
            "seed": int(sess._seed),
            "had_output": bool(sess._had_output),
            "frames_submitted": int(sess.frames_submitted),
            "frames_skipped_similar": int(sess.frames_skipped_similar),
            "cache_tick": int(cache_tick),
            "cache_uncaptured": bool(cache_uncaptured),
            "adapter": sess.adapter,
            "state_b64": base64.b64encode(serialize_pytree(row)).decode("ascii"),
        }
        if sess._sim is not None:
            snap["similarity"] = sess._sim.export_state()
        return snap

    def _check_row(self, row):
        """Refuse a row whose structure, shape or dtype differs from one
        slot of the stacked state (the captured steps would misread it)."""
        def walk(got, want, path):
            if isinstance(want, dict):
                if not isinstance(got, dict) or sorted(got) != sorted(want):
                    keys = sorted(got) if isinstance(got, dict) else type(got).__name__
                    raise SnapshotMismatch(
                        f"state-row structure differs from this scheduler's stacked state at "
                        f"{path or 'the root'} ({keys} vs {sorted(want)})")
                for k in want:
                    walk(got[k], want[k], f"{path}/{k}")
                return
            wshape, wdtype = tuple(want.shape[1:]), want.dtype
            if not isinstance(got, torch.Tensor) or tuple(got.shape) != wshape or got.dtype != wdtype:
                desc = (f"{tuple(got.shape)}/{got.dtype}" if isinstance(got, torch.Tensor)
                        else type(got).__name__)
                raise SnapshotMismatch(
                    f"state-row leaf {path} {desc} does not match the compiled {wshape}/{wdtype}")

        walk(row, self._shards[0].states, "")

    def restore_session(self, snapshot: dict, session_key: str | None = None) -> ScheduledSession:
        """Install a migrated session: claim a slot and write the snapshot's
        row into it in place (no prepare: the stream resumes where the
        source froze it).  Refuses a mismatched schema, fingerprint or row
        (SnapshotMismatch) and a full pool or a quarantined plane
        (CapacityError) before any state is touched."""
        if self.quarantined:
            raise CapacityError("engine quarantined — rebuild in progress")
        if not isinstance(snapshot, dict):
            raise SnapshotMismatch("session snapshot must be an object")
        schema = snapshot.get("schema")
        if schema != SESSION_SNAPSHOT_SCHEMA:
            raise SnapshotMismatch(f"session-snapshot schema {schema!r} unsupported (this "
                                   f"build speaks {SESSION_SNAPSHOT_SCHEMA})")
        fp, want = snapshot.get("fingerprint"), self.snapshot_fingerprint()
        if fp != want:
            diffs = sorted(k for k in set(want) | set(fp or {})
                           if (fp or {}).get(k) != want.get(k))
            raise SnapshotMismatch(f"snapshot fingerprint mismatch on {diffs} "
                                   f"(snapshot {fp!r}, this scheduler {want!r})")
        try:
            row = deserialize_pytree(base64.b64decode(snapshot["state_b64"], validate=True))
            prompt = str(snapshot["prompt"])
            guidance = float(snapshot["guidance_scale"])
            delta = float(snapshot["delta"])
            t_index_list = [int(t) for t in snapshot["t_index_list"]]
            seed = int(snapshot.get("seed", 0))
            if len(t_index_list) != self.cfg.n_stages:
                raise ValueError(f"t_index_list length {len(t_index_list)} != compiled "
                                 f"n_stages {self.cfg.n_stages}")
            self._check_t_index(t_index_list)  # a bad list refuses now, not at a restart
        except (KeyError, IndexError, TypeError, ValueError, binascii.Error) as e:
            raise SnapshotMismatch(f"session snapshot unusable: {e}") from e
        self._check_row(row)
        with self._lock:
            slot = self._pick_slot_locked()
            self.active[slot] = True
        try:
            sess = ScheduledSession(self, slot, session_key or snapshot.get("session")
                                    or f"slot-{slot}", prompt, seed)
            sess.guidance_scale, sess.delta, sess.t_index_list = guidance, delta, t_index_list
            adapter = snapshot.get("adapter")
            sess.adapter = str(adapter) if adapter is not None else None
            sess._had_output = bool(snapshot.get("had_output", False))
            sess.frames_submitted = int(snapshot.get("frames_submitted", 0))
            sess.frames_skipped_similar = int(snapshot.get("frames_skipped_similar", 0))
            sim_state = snapshot.get("similarity")
            if sess._sim is not None and sim_state is not None:
                try:
                    sess._sim.restore_state(sim_state)
                except ValueError as e:
                    raise SnapshotMismatch(str(e)) from e
            self._install(slot, row)
        except Exception:
            with self._lock:
                self.active[slot] = False
            raise
        with self._lock:
            self._sessions[slot] = sess
        logger.info("batchsched session restored from snapshot -> slot %d (%s)", slot,
                    sess.session_key)
        return sess

    def _adapter_rows(self, name: str | None):
        """One session row of the factor bank for adapter ``name`` at the
        bound shape, on the device in the compute dtype (the zero rows for
        None), or None when no bank is bound.  Raises before any state is
        touched: an adapter asked of a scheduler with no registry, an
        unknown name, or an adapter that outgrew the bound rank."""
        if not self._adapter_rank:
            if name is not None:
                raise ValueError(f"adapter {name!r} requested but this scheduler has no adapter "
                                 "registry bound (set ADAPTER_DIR and restart)")
            return None
        return self.adapters.factor_rows(name, rank=self._adapter_rank,
                                         targets=self._adapter_targets,
                                         dtype=self.cfg.torch_dtype, device=self.device)

    def _build_state(self, prompt, guidance, delta, seed, t_index_list,
                     adapter: str | None = None) -> dict:
        rows = self._adapter_rows(adapter)  # checked before the heavy build
        with self._heavy_lock, devtel.expected_scope("sched-state-build"):
            state = self._template.build_state(prompt, guidance_scale=guidance, delta=delta,
                                               seed=seed)
            if tuple(t_index_list) != tuple(self.cfg.t_index_list):
                state["coeffs"] = coeff_state(self.cfg, self._template.schedule,
                                              tuple(t_index_list), self.device)
            if rows is not None:  # the row mirrors the stacked state's structure
                state["adapters"] = rows
            return state

    def _install(self, slot: int, state: dict):
        sh, i = self._row(slot)
        with self._step_lock, devtel.expected_scope("sched-slot-install"):
            install_row(sh.states, i, state)
            self._mark_uncaptured_locked(slot)

    def _mark_uncaptured_locked(self, *slots):
        """DeepCache: the slots' deep-cache rows are zeros or stale (an
        install, a restore, a recovery, a new prompt or new t-indices): the
        next bucket step captures, and so does any later one that carries
        one of them before a capture has (the caller holds the step lock)."""
        if self._cache_interval:
            self._tick = 0
            self._uncaptured.update(slots)

    def _encode(self, prompt: str):
        with self._heavy_lock, devtel.expected_scope("sched-prompt-encode"):
            return self._template._encode(prompt)

    def _apply_prompt(self, slot: int, encoded):
        """The slot's prompt embeddings (SDXL: and its pooled embeds),
        ``copy_`` into the stacked state the captured graphs read."""
        cond, uncond, extras = encoded
        sh, i = self._row(slot)
        with self._step_lock, devtel.expected_scope("sched-control-write"):
            sh.states["cond"][i].copy_(cond)
            sh.states["uncond"][i].copy_(uncond)
            if self.cfg.use_added_cond and "pooled" in extras:
                sh.states["added_text"][i].copy_(extras["pooled"])
            self._mark_uncaptured_locked(slot)

    def _check_t_index(self, t_index_list) -> dict:
        return t_index_coeffs(self.cfg, self._template.schedule, t_index_list, self.device)

    def _apply_t_index(self, slot: int, t_index_list):
        coeffs = self._check_t_index(t_index_list)
        sh, i = self._row(slot)
        with self._step_lock, devtel.expected_scope("sched-control-write"):
            for name, v in coeffs.items():
                sh.states["coeffs"][name][i].copy_(v)
            self._mark_uncaptured_locked(slot)

    def _apply_adapter(self, slot: int, name: str | None):
        """Swap one slot's factor rows in the stacked bank, in place: one
        ``copy_`` per factor into the slot's row under the step lock (every
        adapter has the bank's shape), so the captured graphs read it at
        their next replay.  ``None`` writes the zero rows back.  With
        DeepCache the slot's deep feature was made under the old style:
        the next step that carries it captures, as after a prompt write."""
        rows = self._adapter_rows(name)  # raises before any write
        if rows is None:
            raise ValueError("adapter hot-swap unavailable: no adapter registry bound (set "
                             "ADAPTER_DIR and restart)")
        sh, i = self._row(slot)
        with self._step_lock, devtel.expected_scope("sched-control-write"):
            bank = sh.states["adapters"]
            for path, f in rows.items():
                bank[path]["down"][i].copy_(f["down"])
                bank[path]["up"][i].copy_(f["up"])
            self.adapter_swaps_total += 1
            self._mark_uncaptured_locked(slot)

    def _apply_guidance(self, slot: int, guidance, delta):
        sh, i = self._row(slot)
        with self._step_lock, devtel.expected_scope("sched-control-write"):
            if guidance is not None:
                sh.states["guidance"][i].fill_(guidance)
            if delta is not None:
                sh.states["delta"][i].fill_(delta)

    # -- global control plane (POST /config: every live session, and the
    # default for future ones) ------------------------------------------------------

    def _live(self) -> list:
        with self._lock:
            return list(self._sessions.values())

    def update_prompt(self, prompt: str):
        encoded = self._encode(prompt)
        for sess in self._live():
            self._apply_prompt(sess.slot, encoded)
            sess.prompt = prompt
        self.prompt = prompt

    def update_t_index_list(self, t_index_list):
        self._check_t_index(t_index_list)  # a bad default fails now, not at the next claim
        for sess in self._live():
            sess.update_t_index_list(t_index_list)
        self.t_index_list = [int(t) for t in t_index_list]

    def update_guidance(self, guidance_scale=None, delta=None):
        g = None if guidance_scale is None else float(guidance_scale)
        d = None if delta is None else float(delta)
        for sess in self._live():
            sess.update_guidance(g, d)
        if g is not None:
            self.guidance_scale = g
        if d is not None:
            self.delta = d

    def update_adapter(self, name: str | None):
        """The global adapter swap (POST /config): every live session and
        the default of future claims; ``None`` clears to the zero rows.
        Checked once up front, so a bad name fails this call even with no
        live session, and a scheduler with no bank says why no swap can
        work here."""
        self._adapter_rows(name)
        if not self._adapter_rank:
            raise ValueError("adapter hot-swap unavailable: no adapter registry bound (set "
                             "ADAPTER_DIR and restart)")
        for sess in self._live():
            self._apply_adapter(sess.slot, name)
            sess.adapter = name
        self.default_adapter = name

    # -- the bucket step ------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        return bucket_for(self._bucket_sizes, n) or self._bucket_sizes[-1]

    def _bucket_for_slots(self, slots: list) -> int:
        """The bucket of a dispatch: on a dp mesh, the smallest whose k/dp
        rows per shard hold the riders of the busiest shard."""
        if self.dp == 1:
            return self._bucket_for(len(slots))
        loads = [0] * self.dp
        for s in slots:
            loads[self._slot_shard(s)] += 1
        return self._bucket_for(max(loads) * self.dp)

    def bucket_keys(self, model_id: str | None = None) -> dict:
        """{(bucket size k, unet variant) -> engine key}: the JAX scheduler's
        recipe (the stream key plus ``sbucket``/``sessions``; a DeepCache
        config keys a capture + cached pair per bucket, w8 params add
        ``quant-w8``, a bound factor bank ``lrank-R``, a dp mesh ``dp-N``)."""
        model_id = model_id or self.model_id
        extra = {**params_variant_extra(self.params), **mesh_key_extra(self.mesh),
                 **adapter_key_extra(self._adapter_rank)}
        return {(k, v): stream_engine_key(model_id, self.cfg, sbucket=k, sessions=self.max_sessions,
                                          **({"variant": v} if v != "full" else {}), **extra)
                for k in self._bucket_sizes for v in self._variants}

    def graph_status(self) -> dict:
        """{(bucket size, variant) -> captured} (False throughout when
        stepping eagerly; on a dp mesh, captured on every shard)."""
        return shards_status(self._shards, self.bucket_keys(), self.dp)

    def _bucket_label(self, k: int, variant: str) -> str:
        """The build watchdog's label of bucket k's variant (obs/devtel.py;
        the JAX spelling ``sbucket-<k>:<variant>``, then ``:r<R>`` with a
        bound factor bank and ``:dp<N>`` on a dp mesh)."""
        label = f"sbucket-{k}:{variant}"
        if self._adapter_rank:
            label = f"{label}:r{self._adapter_rank}"
        return f"{label}:dp{self.dp}" if self.dp > 1 else label

    def prewarm_buckets(self):
        """Capture every bucket size and variant on the calling thread,
        writing no session's state (``BucketStep.warm``; eagerly: step each
        once).  The scheduler calls it on its dispatcher thread at startup
        (a graph replays from any thread: the guard's runner steps them).
        Its builds are expected, in any phase: an operator's prewarm never
        breaches."""
        for k in self._bucket_sizes:
            for v in self._variants:
                with self._step_lock, devtel.compile_scope(self._bucket_label(k, v),
                                                           expected=True):
                    self._warm_shards(self._shards, k, v)
                logger.info("prewarmed batchsched bucket %d/%d (%s%s)", k, self.max_sessions, v,
                            f", dp={self.dp}" if self.dp > 1 else "")
        sync_devices(sh.device for sh in self._shards)

    def _warm_shards(self, shards: list, k: int, variant: str):
        """Bucket k's ``variant`` ready on every shard (each at k/dp rows)."""
        for sh in shards:
            with on_device(sh.device):
                sh.bucket.warm(sh.params, sh.states, k // self.dp, variant)
            self._warmed.add((k, variant, sh.index))

    # -- the engine fault domain (resilience/engine_guard.py) ------------------------

    def attach_guard(self, guard):
        """Route every bucket step through ``guard``: its deadline bounds the
        step up to its completion; while it is quarantined the scheduler
        sheds (passthrough) instead of dispatching and refuses claims."""
        self._guard = guard

    @property
    def quarantined(self) -> bool:
        g = self._guard
        return g is not None and g.quarantined

    def _maybe_bank_rows_locked(self):
        """Refresh the snapshot bank on the ENGINE_SNAPSHOT_EVERY_S cadence,
        after a step (the caller holds the step lock).  ``states[..][slot]``
        is a view the next replay overwrites, so the live rows are copied
        out (one gather per leaf, on the stepping stream after the step):
        the only copy a rebuild can restore from."""
        if self._guard is None or self._snap_every_s <= 0:
            return
        now = time.monotonic()
        if now - self._last_snap_t < self._snap_every_s:
            return
        self._last_snap_t = now
        slots = [slot for slot in list(self._sessions) if self.active[slot]]
        rows, ready = {}, {}
        for sh in self._shards:
            mine = [slot for slot in slots if slot in sh.slots]
            if not mine:
                continue
            with on_device(sh.device):
                # one gather per leaf (a fresh buffer), then each slot's rows as views of it
                index = sh.bucket.index([slot - sh.slots.start for slot in mine])
                bank = tree_map(lambda a, index=index: a.index_select(0, index), sh.states)
                rows.update({slot: tree_map(lambda a, i=i: a[i], bank)
                             for i, slot in enumerate(mine)})
                if sh.device.type == "cuda":
                    # the quarantine capture reads the bank behind this event,
                    # never behind the (possibly stalled) steps queued after it
                    ready[sh.index] = torch.cuda.Event()
                    ready[sh.index].record()
        self._snap_rows, self._snap_ready = rows, ready

    def _bank_to_host(self, rows: dict, ready, device) -> dict:
        """One banked slot's rows on the host (on the CPU they are).  On the
        card the copy runs on a side stream of the rows' ``device`` that
        waits only for the bank's gather."""
        if ready is None:
            return rows
        with torch.cuda.device(device):
            side = torch.cuda.Stream(device)
            side.wait_event(ready)
            with torch.cuda.stream(side):
                host = tree_map(lambda a: a.to("cpu", non_blocking=True), rows)
            side.synchronize()
        return host

    def capture_quarantine_snapshots(self) -> dict:
        """{session key: full snapshot dict} of the live sessions from the
        bank, frozen at quarantine entry (the guard calls this once, before
        any rebuild attempt): each banked row goes to the host once and
        becomes the dict a live export would give, and a quarantined
        :meth:`snapshot_session` serves it.  A session claimed after the
        last bank refresh has none and is rebuilt from its control plane;
        a row that cannot be read costs only its own session."""
        with self._lock:
            rows, ready = dict(self._snap_rows), self._snap_ready
            sessions = {slot: sess for slot, sess in self._sessions.items() if self.active[slot]}
            cache_tick, uncaptured = self._tick, set(self._uncaptured)
        self._use_device()
        snaps = {}
        for slot, sess in sessions.items():
            if slot not in rows:
                logger.warning("quarantine capture: slot %d has no banked row (claimed after "
                               "the last bank refresh): control-plane rebuild only", slot)
                continue
            try:
                sh = self._shards[self._slot_shard(slot)]
                host = self._bank_to_host(rows[slot], ready.get(sh.index), sh.device)
                snaps[sess.session_key] = self._row_snapshot(sess, host, cache_tick,
                                                             slot in uncaptured)
            except Exception:
                logger.exception("quarantine capture failed for slot %d (%s)", slot,
                                 sess.session_key)
        self._quarantine_snaps = snaps
        return snaps

    def rebuild_engine(self, snapshots: dict | None = None) -> int:
        """Quarantine recovery: a new plane (new stacked state buffers, a new
        bucket step with its own graph pool and static buffers) with every
        live slot restored from its banked snapshot's row bit for bit, or from
        its session's control plane without one; every bucket is captured
        again.  The attempt runs on the guard's runner (the thread that
        steps) under the cold deadline: behind a stalled device it times
        out instead of hanging.  -> the number of slots restored from the
        bank.  Raises on failure (the guard backs off and retries)."""
        snapshots = self._quarantine_snaps if snapshots is None else snapshots
        # no lock here (a step or an attempt stuck behind a stalled device may
        # hold one): a held step checks the epoch under the epoch lock, and
        # the plane is swapped under it
        self._epoch += 1
        epoch = self._epoch
        guard = self._guard
        if guard is None:
            exact = self._rebuild_plane(snapshots, epoch)
        else:
            exact = guard.run_bounded(lambda: self._rebuild_plane(snapshots, epoch),
                                      guard.cold_deadline_s, "engine rebuild")
        self._quarantine_snaps = {}
        logger.warning("batchsched engine rebuilt: %d/%d live slot(s) restored bit-exact from "
                       "the snapshot bank", exact, self.active.count(True))
        return exact

    def _rebuild_plane(self, snapshots: dict, epoch: int) -> int:
        self._use_device()
        with self._step_lock:
            per, exact, placeholder = [], 0, None
            for slot in range(self.max_sessions):
                sess = self._sessions.get(slot) if self.active[slot] else None
                if sess is None:
                    if placeholder is None:
                        placeholder = self._build_state(self.prompt, self.guidance_scale,
                                                        self.delta, slot, self.t_index_list)
                    per.append(placeholder)
                else:
                    row = self._banked_row(snapshots.get(sess.session_key), slot)
                    if row is None:
                        row = self._build_state(sess.prompt, sess.guidance_scale, sess.delta,
                                                sess._seed, sess.t_index_list, sess.adapter)
                    else:
                        exact += 1
                    per.append(row)
            shards = self._new_shards(per)  # new buffers: the banked rows copied in
            with self._epoch_lock:
                if self._epoch != epoch:
                    raise StaleStepError("a later rebuild attempt owns the plane")
                self._retire_plane()
                self._shards = shards
                self._warmed = set()
                # fresh deep caches (zeros, or banked rows): every slot captures first
                self._mark_uncaptured_locked(*range(self.max_sessions))
            with self._lock:  # batches of the old plane are nobody's to wait for
                self._batches = deque(maxlen=self._batches.maxlen)
            self._snap_rows, self._snap_ready, self._last_snap_t = {}, {}, 0.0
        if self._prewarm:
            for k in self._bucket_sizes:
                for v in self._variants:
                    with self._step_lock:
                        if self._epoch != epoch:
                            raise StaleStepError("a later rebuild attempt owns the plane")
                        with devtel.compile_scope(self._bucket_label(k, v), expected=True):
                            self._warm_shards(shards, k, v)
            sync_devices(sh.device for sh in shards)
        return exact

    def _banked_row(self, snap: dict | None, slot: int) -> dict | None:
        """The state row of a banked snapshot dict, or None (no snapshot, or
        one that does not decode or fit: the slot is rebuilt from its
        control plane)."""
        if snap is None:
            return None
        try:
            row = deserialize_pytree(base64.b64decode(snap["state_b64"]))
            self._check_row(row)
        except Exception:
            logger.exception("banked row unusable for slot %d: control-plane rebuild", slot)
            return None
        return tree_map(lambda a: a.to(self.device), row)

    def _retire_plane(self):
        """Keep the old plane (its graphs, pool, static and state buffers)
        alive until an event recorded now has completed: a replay already
        queued on the stream must not find its memory reused."""
        self._retired = [r for r in self._retired if not all(ev.query() for ev in r[0])]
        events = []
        for sh in self._shards:
            if sh.device.type == "cuda":
                with torch.cuda.device(sh.device):
                    events.append(torch.cuda.Event())
                    events[-1].record()
        if events:
            self._retired.append((events, self._shards))

    def _use_device(self):
        """The stepping thread's current device (a runner thread starts on
        device 0)."""
        if self.device.type == "cuda" and torch.cuda.current_device() != (self.device.index or 0):
            torch.cuda.set_device(self.device)

    @staticmethod
    def _evict(pending: _PendingFrame, reason: str):
        """A window shed this frame: its waiter resolves as passthrough now."""
        shed_to_passthrough(pending.future, pending.frame)

    def _enqueue(self, slot: int, pending: _PendingFrame):
        if self.quarantined:
            # no plane to step on: passthrough now, not a shed at the deadline
            self._evict(pending, "engine-quarantined")
            return
        self._queues[slot].push(pending, stamp=pending.t_enq)
        with self._has_work:
            self._has_work.notify()

    def _waiting_slots(self) -> list:
        """Slots with a full group waiting: one frame, or fbs consecutive ones."""
        return [s for s in range(self.max_sessions)
                if self.active[s] and self._queues[s].depth >= self.fbs]

    def _pop_group(self, slot: int):
        """The slot's fbs oldest frames (one with fbs == 1), or None."""
        group = []
        for _ in range(self.fbs):
            got = self._queues[slot].pop()
            if got is None:
                break
            group.append(got[0])
        return group or None

    def _in_flight(self, now: float) -> int:
        return sum(1 for b in self._batches if not b.resolved and now - b.t_dispatch < 60.0)

    def _next_entries_locked(self):
        """Wait until a batch should go (every live session has a frame, one
        session is live, or the window from the oldest waiting frame ran
        out, with fewer than PIPELINE_DEPTH steps in flight) and pop it:
        [(slot, pending)], or None at stop."""
        while not self._stop:
            waiting = self._waiting_slots()
            if self.quarantined:
                # no plane: shed what queued (passthrough at once) and idle
                # until the guard's rebuild re-arms
                for s in waiting:
                    while (group := self._pop_group(s)) is not None:
                        for p in group:
                            self._evict(p, "engine-quarantined")
                self._has_work.wait(timeout=0.1)
                continue
            if not waiting:
                self._has_work.wait(timeout=0.5)
                continue
            if self._in_flight(time.monotonic()) >= self.PIPELINE_DEPTH:
                # a rider's first row resolve frees a slot and notifies
                self._has_work.wait(timeout=0.05)
                continue
            live = self.active.count(True)
            if len(waiting) >= live or live <= 1 or self.window_s <= 0.0:
                break
            stamps = [t for t in (self._queues[s].oldest_stamp() for s in waiting) if t is not None]
            remain = min(stamps) + self.window_s - time.monotonic() if stamps else 0.0
            if remain <= 0.0:
                break
            self._has_work.wait(timeout=remain)
        if self._stop:
            return None
        entries = []
        for s in self._waiting_slots():
            group = self._pop_group(s)
            if group is not None:
                entries.append((s, group))
        return entries

    def _dispatch(self, entries):
        """One bucket step for ``entries`` ([(slot, its group of pending
        frames)]) and every rider's readback row.  The caller holds the step
        lock, taken before the entries were popped: a control-plane write
        that comes after the pop lands after this step, as it does in the
        JAX scheduler."""
        slots = [s for s, _ in entries]
        n = len(slots)
        k = self._bucket_for_slots(slots)
        t_disp = time.monotonic()
        frames = []
        for _, group in entries:
            for p in group:
                p.t_dispatch, p.occupancy = t_disp, n
            bufs = [p.frame_dev for p in group]
            # a short group (a release raced the pop) repeats its last frame
            bufs = (bufs + [bufs[-1]] * self.fbs)[: self.fbs]
            frames.append(bufs[0] if self.fbs == 1 else torch.cat(bufs))
        variant = self._next_variant_locked(slots)
        # warm only where every shard this step runs on has run it before
        warm_keys = {(k, variant, self._slot_shard(s)) for s in slots}
        feed = warm_keys <= self._warmed
        epoch = self._epoch

        def device_step() -> Readback:
            # on the guard's runner thread when one is attached; the fault
            # scope fires on the thread the step runs on, before the replay
            self._use_device()
            if self._fault_scope is not None:
                self._fault_scope.step()
            with self._epoch_lock:
                if self._epoch != epoch:
                    raise StaleStepError("the plane was rebuilt while this step was held")
                # a bucket built here (prewarm off, or a size it left out)
                # is a lazy build at dispatch: in the serving phase, a breach
                with devtel.compile_scope(self._bucket_label(k, variant)):
                    return self._step_shards(frames, slots, k, variant)

        def until_complete() -> Readback:
            # the guarded step ends at its completion event, polled: a
            # stalled device blows the deadline instead of blocking a thread
            readback = device_step()
            while not readback.done() and self._epoch == epoch:
                time.sleep(POLL_S)
            return readback

        try:
            if self._guard is None:
                readback = device_step()
            else:
                readback = self._guard.dispatch(until_complete, cold=not feed)
            self._warmed.update(warm_keys)
            batch = _DispatchedBatch(readback, t_disp, slots, feed)
        except Exception as e:
            if not self.quarantined:
                logger.exception("batchsched step failed (bucket %d, %d sessions)", k, n)
            for _, group in entries:
                for p in group:
                    try:
                        p.future.set_exception(e)
                    except InvalidStateError:
                        pass
            if not self.quarantined:
                # the guard owns the recovery of a trip (its rebuild restores
                # the bank); any other failure may have left rows half
                # written: every live session starts again from its control
                # plane, as the JAX scheduler recovers its donated state
                self._recover_states_locked(e)
            return
        self._maybe_bank_rows_locked()
        with self._has_work:
            # a rider released while this step ran fetches nothing (no claim
            # completes meanwhile: it needs the step lock, held here)
            batch.riders.intersection_update(self._sessions)
            batch.resolved = not batch.riders
            # tpurtc: allow[lock-discipline] -- _has_work is threading.Condition(self._lock): entering it takes self._lock, the lock the other writer (rebuild_engine) holds
            self._batches = deque((b for b in self._batches if not b.resolved),
                                  maxlen=self._batches.maxlen)
            self._batches.append(batch)
        with self._stats_lock:
            self.steps_total += 1
            self._occ.append(n)
            hist = dict(self._occ_hist)  # copy on write: snapshot() reads it unlocked
            hist[n] = hist.get(n, 0) + 1
            self._occ_hist = hist
            self._waits.extend(t_disp - p.t_enq for _, group in entries for p in group)
        for i, (_, group) in enumerate(entries):
            for fi, p in enumerate(group):
                p.sub = fi
                try:
                    p.future.set_result((batch, i))
                except InvalidStateError:
                    pass  # cancelled by a release

    def _step_shards(self, frames: list, slots: list, k: int, variant: str):
        """Bucket k's ``variant`` for the riders ``slots`` (their frames
        ``frames``): the single device's step, or each shard's step that
        carries riders at k/dp rows, one after another, each read back on
        its own device.  -> a Readback of the riders' rows, in order."""
        if self.dp == 1:
            sh = self._shards[0]
            return Readback(sh.bucket(sh.params, sh.states, frames, slots, k, variant), len(slots))
        parts, where = [], [None] * len(slots)
        for sh in self._shards:
            mine = [i for i, s in enumerate(slots) if s in sh.slots]
            if not mine:
                continue
            with on_device(sh.device):
                out = sh.bucket(sh.params, sh.states, [frames[i] for i in mine],
                                [slots[i] - sh.slots.start for i in mine], k // self.dp, variant)
                for r, i in enumerate(mine):
                    where[i] = (len(parts), r)
                parts.append(Readback(out, len(mine)))
        return ShardedReadback(parts, where)

    def _next_variant_locked(self, slots: list) -> str:
        """The variant of the bucket step carrying ``slots`` (the caller holds
        the step lock).  DeepCache, the JAX global cadence: the capture every
        Nth step, or whenever a rider's slot is uncaptured (a cached step
        over its zeroed or stale row would be wrong; an extra capture is only
        slower), the cached step otherwise."""
        if not self._cache_interval:
            return self._variants[0]
        capture = (self._tick % self._cache_interval == 0
                   or any(s in self._uncaptured for s in slots))
        self._tick += 1
        if capture:
            self._uncaptured.difference_update(slots)
        return "capture" if capture else "cached"

    def _recover_states_locked(self, cause):
        """After a failed step that was not the guard's: reinstall every live
        session's state from its control plane (the caller holds the step
        lock); every slot captures first.  Best effort: if the model itself
        is broken, the next step says so."""
        try:
            self._mark_uncaptured_locked(*range(self.max_sessions))
            for slot, sess in list(self._sessions.items()):
                if self.active[slot]:
                    sh, i = self._row(slot)
                    install_row(sh.states, i, self._build_state(
                        sess.prompt, sess.guidance_scale, sess.delta, sess._seed,
                        sess.t_index_list, sess.adapter))
            logger.warning("batchsched: rebuilt the live session rows after a failed step (%r)",
                           cause)
        except Exception:
            logger.exception("batchsched state recovery failed")

    def _resolve_row(self, batch: _DispatchedBatch, row: int,
                     t0: float | None = None) -> np.ndarray:
        """A rider's row of ``batch`` on the host.  The first resolve of a
        step frees its in-flight place and feeds :attr:`on_step` the step's
        cost per session (dispatch -> resolve, or the blocking wait when
        shorter: the wait overstates nothing when the fetch came late)."""
        try:
            out = batch.readback.row(row)
        except Exception:  # a failed readback frees its in-flight place as well
            self._first_resolve(batch)
            raise
        if self._first_resolve(batch) and batch.feed and self.on_step is not None:
            t1 = time.monotonic()
            dt = t1 - batch.t_dispatch if t0 is None else min(t1 - batch.t_dispatch, t1 - t0)
            try:
                self.on_step(dt / max(1, batch.occupancy), batch.occupancy)
            except Exception:
                logger.exception("batchsched on_step hook failed")
        return out

    def _first_resolve(self, batch: _DispatchedBatch) -> bool:
        if batch.resolved:
            return False
        with self._has_work:
            first, batch.resolved = not batch.resolved, True
            self._has_work.notify()
        return first

    def _run(self):
        try:
            if self._prewarm:
                self.prewarm_buckets()
        except BaseException as e:  # re-raised by the constructor
            self._start_error = e
            self._started.set()
            return
        self._started.set()
        while True:
            with self._has_work:
                entries = self._next_entries_locked()
                if entries:
                    self._step_lock.acquire()  # lock order: _lock, then _step_lock
            if entries is None:
                break
            if entries:
                try:
                    self._dispatch(entries)
                finally:
                    self._step_lock.release()
        for q in self._queues:  # drain on stop
            while (got := q.pop()) is not None:
                got[0].future.cancel()

    def close(self):
        with self._has_work:
            self._stop = True
            self._has_work.notify()
        self._thread.join(timeout=10)

    # -- observability --------------------------------------------------------------

    @staticmethod
    def _percentile(sorted_vals, frac):
        return sorted_vals[min(len(sorted_vals) - 1, int(len(sorted_vals) * frac))]

    def snapshot(self) -> dict:
        """/metrics gauges (the JAX scheduler's ``batchsched_*`` names)."""
        with self._stats_lock:
            occ, waits = sorted(self._occ), sorted(self._waits)
        out = {
            "batchsched_sessions": self.active.count(True),
            "batchsched_max_sessions": self.max_sessions,
            "batchsched_steps_total": self.steps_total,
            "batchsched_window_ms": round(1e3 * self.window_s, 3),
            "batchsched_dp": self.dp,
            "batchsched_fbs": self.fbs,
            "batchsched_occupancy_hist": {str(k): v for k, v in sorted(self._occ_hist.items())},
            "batchsched_graphs": {f"{k}:{v}": done
                                  for (k, v), done in self.graph_status().items()},
        }
        if self.dp > 1:
            # live sessions per shard: how evenly the session axis fills the mesh
            hist = {str(d): 0 for d in range(self.dp)}
            for s, live in enumerate(list(self.active)):
                if live:
                    hist[str(self._slot_shard(s))] += 1
            out["batchsched_shard_sessions"] = hist
        if occ:
            out["batchsched_occupancy_p50"] = self._percentile(occ, 0.5)
            out["batchsched_occupancy_max"] = occ[-1]
        if self._adapter_rank:
            # the style plane: live sessions on a non-zero bank, swaps so far
            out["adapter_sessions"] = sum(1 for s in list(self._sessions.values())
                                          if s.adapter is not None)
            out["adapter_swaps_total"] = self.adapter_swaps_total
            out["adapter_rank"] = self._adapter_rank
        if waits:
            out["batchsched_window_wait_ms_p50"] = round(1e3 * self._percentile(waits, 0.5), 3)
            out["batchsched_window_wait_ms_p99"] = round(1e3 * self._percentile(waits, 0.99), 3)
        return out

    def session_snapshots(self) -> dict:
        """{session key: its scheduler view} for /health."""
        return {sess.session_key: sess.snapshot() for sess in list(self._sessions.values())}
