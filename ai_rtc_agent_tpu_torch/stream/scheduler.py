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

Outputs are a dedicated engine's for the same state row and frames
(tests/test_torch_scheduler.py on the CPU, chip_smoke.py phase 6 on the
card).  frame_buffer_size > 1 through the scheduler, snapshot/restore,
the dp-sharded session axis, adapters, DeepCache and w8 are later slices.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import CancelledError, Future, InvalidStateError

import numpy as np
import torch

from .. import resolve_device
from ..aot.cache import stream_engine_key
from ..parallel.multipeer import (
    BucketStep,
    CapacityError,
    Readback,
    bucket_for,
    bucket_sizes,
    stage_rows,
)
from ..resilience.overload import DeadlineQueue, ShedFrame, shed_to_passthrough
from ..utils import env
from .engine import (
    SimilarityFilter,
    StreamEngine,
    coeff_state,
    install_row,
    stack_states,
    t_index_coeffs,
)
from .pipeline import (
    DEFAULT_DELTA,
    DEFAULT_GUIDANCE_SCALE,
    DEFAULT_PROMPT,
    coerce_frame,
    finish_output,
)

logger = logging.getLogger(__name__)

__all__ = ["BatchScheduler", "ScheduledSession", "CapacityError"]


class _PendingFrame:
    """One enqueued frame: its waiter future, the staged device copy and
    the stamps the gauges read."""

    __slots__ = ("frame", "frame_dev", "future", "t_enq", "t_dispatch", "occupancy", "skipped")

    def __init__(self, frame):
        self.frame = frame  # host pixels (shed passthrough, similarity)
        self.frame_dev = None  # [1,H,W,3] on the device
        self.future: Future = Future()
        self.t_enq = time.monotonic()
        self.t_dispatch: float | None = None
        self.occupancy = 0
        self.skipped = False


class _DispatchedBatch:
    """One bucket step's readback; ``resolved`` flips at its first row, or
    once every rider's session is released (a closed connection fetches
    nothing), so that it stops counting as in flight."""

    __slots__ = ("readback", "t_dispatch", "riders", "resolved")

    def __init__(self, readback: Readback, t_dispatch: float, riders: list):
        self.readback = readback
        self.t_dispatch = t_dispatch
        self.riders = set(riders)  # the slots that rode it, until released
        self.resolved = False


class ScheduledSession:
    """One claimed slot: the pipeline surface the track drives (``__call__``,
    ``submit``/``fetch``, ``update_prompt``, ``update_t_index_list``,
    ``update_guidance``, ``restart``) over the shared scheduler."""

    frame_buffer_size = 1

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
        self.frames_skipped_similar = 0

    @property
    def window_queue(self) -> DeadlineQueue:
        return self._owner._queues[self.slot]

    def submit(self, frame):
        """Coerce, stage and enqueue one frame; -> a handle for :meth:`fetch`.
        A similarity skip never enters the window: its handle resolves with
        the previous submit's output."""
        arr = coerce_frame(frame, self._owner.height, self._owner.width)
        last = self._last_pending
        if self._sim is not None and self._sim.should_skip(
            arr, have_output=self._had_output and last is not None
        ):
            self.frames_skipped_similar += 1
            p = _PendingFrame(arr)
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
        p = _PendingFrame(arr)
        p.frame_dev = stage_rows(arr[None], self._owner.device)
        self._owner._enqueue(self.slot, p)
        if self._sim is not None:
            self._last_pending = p
        return p

    def fetch(self, handle: _PendingFrame, src_frame=None):
        """Resolve a handle to this session's output frame (its own row of
        the step it rode).  A shed frame comes back as the ``ShedFrame``."""
        try:
            out = handle.future.result(timeout=self._owner.fetch_timeout)
        except CancelledError:  # released with this frame queued
            return ShedFrame(handle.frame)
        if isinstance(out, ShedFrame):
            return out
        out = self._owner._resolve_row(*out)
        self._had_output = True
        return finish_output(out, src_frame)

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

    def restart(self):
        """A fresh stream state for this slot with the live prompt,
        guidance, delta and t-indices."""
        state = self._owner._build_state(self.prompt, self.guidance_scale, self.delta,
                                         self._seed, self.t_index_list)
        self._owner._install(self.slot, state)

    def release(self):
        if not self._released:
            self._released = True
            self._owner.release(self.slot)


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
                 device=None, graphs: bool | None = None):
        """``graphs`` (default: on a CUDA device): each bucket size steps by
        replaying its captured CUDA graph; False steps eagerly."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model_id = model_id
        self.height, self.width = cfg.height, cfg.width
        self.max_sessions = (env.get_int("BATCHSCHED_MAX_SESSIONS", 8)
                             if max_sessions is None else int(max_sessions))
        if self.max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        self.window_s = (env.get_float("BATCHSCHED_WINDOW_MS", 3.0)
                         if window_ms is None else float(window_ms)) / 1e3
        self.queue_bound = (env.get_int("BATCHSCHED_QUEUE_BOUND", 2)
                            if queue_bound is None else int(queue_bound))
        if self.queue_bound < 1:
            raise ValueError(f"queue_bound ({self.queue_bound}) must hold a frame")
        self.fetch_timeout = fetch_timeout
        # defaults for new sessions; the global update_* methods move them
        self.prompt = default_prompt or DEFAULT_PROMPT
        self.guidance_scale = DEFAULT_GUIDANCE_SCALE if guidance_scale is None else guidance_scale
        self.delta = DEFAULT_DELTA if delta is None else delta
        self.t_index_list = list(cfg.t_index_list)
        self.params = params
        self._template = StreamEngine(models, params, cfg, encode_prompt, schedule=schedule,
                                      device=self.device, graphs=False)
        S = self.max_sessions
        self._bucket_sizes = bucket_sizes(S)
        self._bucket = BucketStep(models, cfg, self.device, graphs=graphs,  # raises for fbs > 1
                                  key=self.bucket_keys().__getitem__)
        # one template state, stacked: a claim installs its own before any frame
        self.states = stack_states([self._template.build_state(
            self.prompt, guidance_scale=self.guidance_scale, delta=self.delta, seed=0)] * S)
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
        self._prewarm = env.get_bool("BATCHSCHED_PREWARM", True) if prewarm is None else prewarm
        self._started = threading.Event()
        self._start_error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="batchsched-dispatch", daemon=True)
        self._thread.start()
        self._started.wait()
        if self._start_error is not None:
            self._thread.join(timeout=10)
            raise self._start_error

    @classmethod
    def from_pipeline(cls, pipeline, **kw) -> "BatchScheduler":
        """A scheduler serving what ``pipeline`` (a StreamDiffusionPipeline)
        serves: its weights, config, prompt encoder, schedule, device, graphs
        setting and live prompt, guidance and delta as the defaults."""
        eng = pipeline.engine
        kw.setdefault("graphs", eng.graphs)
        return cls(eng.models, eng.params, pipeline.config, eng.encode_prompt,
                   model_id=pipeline.model_id, default_prompt=pipeline.prompt,
                   guidance_scale=pipeline.guidance_scale, delta=pipeline.delta,
                   schedule=eng.schedule, device=pipeline.device, **kw)

    # -- session lifecycle --------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return self.active.count(False)

    def claim(self, session_key: str | None = None, prompt: str | None = None,
              seed: int | None = None) -> ScheduledSession:
        """Claim a slot for a new connection; raises CapacityError when full
        (the agent answers 503 with Retry-After).  The state build runs
        outside the locks, so live sessions keep stepping."""
        with self._lock:
            slot = self._pick_slot_locked()
            self.active[slot] = True
        prompt = self.prompt if prompt is None else prompt
        seed = slot if seed is None else seed
        try:
            state = self._build_state(prompt, self.guidance_scale, self.delta, seed,
                                      self.t_index_list)
            sess = ScheduledSession(self, slot, session_key or f"slot-{slot}", prompt, seed)
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

    def _build_state(self, prompt, guidance, delta, seed, t_index_list) -> dict:
        with self._heavy_lock:
            state = self._template.build_state(prompt, guidance_scale=guidance, delta=delta,
                                               seed=seed)
            if tuple(t_index_list) != tuple(self.cfg.t_index_list):
                state["coeffs"] = coeff_state(self.cfg, self._template.schedule,
                                              tuple(t_index_list), self.device)
            return state

    def _install(self, slot: int, state: dict):
        with self._step_lock:
            install_row(self.states, slot, state)

    def _encode(self, prompt: str):
        with self._heavy_lock:
            return self._template._encode(prompt)

    def _apply_prompt(self, slot: int, encoded):
        cond, uncond = encoded
        with self._step_lock:
            self.states["cond"][slot].copy_(cond)
            self.states["uncond"][slot].copy_(uncond)

    def _check_t_index(self, t_index_list) -> dict:
        return t_index_coeffs(self.cfg, self._template.schedule, t_index_list, self.device)

    def _apply_t_index(self, slot: int, t_index_list):
        coeffs = self._check_t_index(t_index_list)
        with self._step_lock:
            for name, v in coeffs.items():
                self.states["coeffs"][name][slot].copy_(v)

    def _apply_guidance(self, slot: int, guidance, delta):
        with self._step_lock:
            if guidance is not None:
                self.states["guidance"][slot].fill_(guidance)
            if delta is not None:
                self.states["delta"][slot].fill_(delta)

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

    # -- the bucket step ------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        return bucket_for(self._bucket_sizes, n) or self._bucket_sizes[-1]

    def bucket_keys(self, model_id: str | None = None) -> dict:
        """{bucket size -> engine key}: the JAX scheduler's recipe (the stream
        key plus ``sbucket``/``sessions``; the port has one UNet variant)."""
        model_id = model_id or self.model_id
        return {k: stream_engine_key(model_id, self.cfg, sbucket=k, sessions=self.max_sessions)
                for k in self._bucket_sizes}

    def graph_status(self) -> dict:
        """{bucket size -> captured} (False throughout when stepping eagerly)."""
        return self._bucket.status(self.bucket_keys())

    def prewarm_buckets(self):
        """Capture every bucket size on the calling thread, writing no
        session's state (``BucketStep.warm``; eagerly: step each once).  The
        scheduler calls it on its dispatcher thread at startup."""
        for k in self._bucket_sizes:
            with self._step_lock:
                self._bucket.warm(self.params, self.states, k)
            logger.info("prewarmed batchsched bucket %d/%d", k, self.max_sessions)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _evict(pending: _PendingFrame, reason: str):
        """A window shed this frame: its waiter resolves as passthrough now."""
        shed_to_passthrough(pending.future, pending.frame)

    def _enqueue(self, slot: int, pending: _PendingFrame):
        self._queues[slot].push(pending, stamp=pending.t_enq)
        with self._has_work:
            self._has_work.notify()

    def _waiting_slots(self) -> list:
        return [s for s in range(self.max_sessions) if self.active[s] and self._queues[s].depth]

    def _in_flight(self, now: float) -> int:
        return sum(1 for b in self._batches if not b.resolved and now - b.t_dispatch < 60.0)

    def _next_entries_locked(self):
        """Wait until a batch should go (every live session has a frame, one
        session is live, or the window from the oldest waiting frame ran
        out, with fewer than PIPELINE_DEPTH steps in flight) and pop it:
        [(slot, pending)], or None at stop."""
        while not self._stop:
            waiting = self._waiting_slots()
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
            got = self._queues[s].pop()
            if got is not None:
                entries.append((s, got[0]))
        return entries

    def _dispatch(self, entries):
        """One bucket step for ``entries`` and every rider's readback row.
        The caller holds the step lock, taken before the entries were
        popped: a control-plane write that comes after the pop lands after
        this step, as it does in the JAX scheduler."""
        slots = [s for s, _ in entries]
        n = len(slots)
        k = self._bucket_for(n)
        t_disp = time.monotonic()
        for _, p in entries:
            p.t_dispatch, p.occupancy = t_disp, n
        try:
            out = self._bucket(self.params, self.states, [p.frame_dev for _, p in entries],
                               slots, k)
            batch = _DispatchedBatch(Readback(out, n), t_disp, slots)
        except Exception as e:
            logger.exception("batchsched step failed (bucket %d, %d sessions)", k, n)
            for _, p in entries:
                try:
                    p.future.set_exception(e)
                except InvalidStateError:
                    pass
            return
        with self._has_work:
            # a rider released while this step ran fetches nothing (no claim
            # completes meanwhile: it needs the step lock, held here)
            batch.riders.intersection_update(self._sessions)
            batch.resolved = not batch.riders
            self._batches = deque((b for b in self._batches if not b.resolved),
                                  maxlen=self._batches.maxlen)
            self._batches.append(batch)
        with self._stats_lock:
            self.steps_total += 1
            self._occ.append(n)
            hist = dict(self._occ_hist)  # copy on write: snapshot() reads it unlocked
            hist[n] = hist.get(n, 0) + 1
            self._occ_hist = hist
            self._waits.extend(t_disp - p.t_enq for _, p in entries)
        for i, (_, p) in enumerate(entries):
            try:
                p.future.set_result((batch, i))
            except InvalidStateError:
                pass  # cancelled by a release

    def _resolve_row(self, batch: _DispatchedBatch, row: int) -> np.ndarray:
        try:
            return batch.readback.row(row)
        finally:  # a failed readback frees its in-flight place as well
            if not batch.resolved:
                with self._has_work:
                    batch.resolved = True
                    self._has_work.notify()

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
            "batchsched_dp": 1,
            "batchsched_fbs": 1,
            "batchsched_occupancy_hist": {str(k): v for k, v in sorted(self._occ_hist.items())},
            "batchsched_graphs": {str(k): v for k, v in self.graph_status().items()},
        }
        if occ:
            out["batchsched_occupancy_p50"] = self._percentile(occ, 0.5)
            out["batchsched_occupancy_max"] = occ[-1]
        if waits:
            out["batchsched_window_wait_ms_p50"] = round(1e3 * self._percentile(waits, 0.5), 3)
            out["batchsched_window_wait_ms_p99"] = round(1e3 * self._percentile(waits, 0.99), 3)
        return out
