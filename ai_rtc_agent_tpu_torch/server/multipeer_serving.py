"""Serve N concurrent peers off one batched engine (``--multipeer N``;
counterpart of ai_rtc_agent_tpu/server/multipeer_serving.py).

Each connection claims a slot of a ``MultiPeerEngine``
(parallel/multipeer.py); a coordinator thread batches one frame per active
slot into one step, and per-peer datachannel messages update only that
peer's prompt or t-indices.

* ``PeerPipeline`` is the pipeline surface the track drives (``__call__``,
  ``submit``/``fetch``, ``update_prompt``, ``update_t_index_list``), so the
  track layer is the same for single- and multi-peer serving.
* The coordinator owns the engine: steps, prompt swaps and slot installs
  happen under one lock.  It is the one thread that steps, and at startup
  it captures every bucket as a CUDA graph on the card (steps each once on
  the CPU; ``MultiPeerEngine.prewarm_buckets``), so no peer's first tick
  pays a capture or a new thread's first step.
* Each tick takes at most one queued frame per slot; an active slot with no
  new frame steps its last frame again and its output is dropped.  Each
  peer's frames wait in a bounded ``DeadlineQueue`` (the scheduler's) of
  OVERLOAD_PEER_QUEUE_BOUND frames (default 2, at least 1, as the JAX
  coordinator reads it): a peer that outpaces the step sheds its oldest
  queued frame, delivered as a ``ShedFrame`` (passthrough) so its recv
  never hangs, and counted in ``frames_shed``.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np

from .. import resolve_device
from ..models import registry
from ..parallel.multipeer import CapacityError, MultiPeerEngine
from ..resilience.overload import DeadlineQueue, ShedFrame, shed_to_passthrough
from ..stream.pipeline import DEFAULT_PROMPT, coerce_frame, finish_output, maybe_load_safety_checker
from ..utils import env

logger = logging.getLogger(__name__)

__all__ = ["MultiPeerPipeline", "PeerPipeline", "CapacityError"]


class PeerPipeline:
    """Per-peer view over the shared batched engine (one claimed slot)."""

    def __init__(self, owner: "MultiPeerPipeline", slot: int):
        self._owner = owner
        self.slot = slot
        self._released = False

    def submit(self, frame):
        return self._owner._enqueue(self.slot, coerce_frame(frame, self._owner.height,
                                                            self._owner.width))

    def fetch(self, handle: Future, src_frame=None):
        out = handle.result(timeout=self._owner.fetch_timeout)
        if isinstance(out, ShedFrame):
            return out
        return finish_output(out, src_frame, self._owner.safety_checker)

    def __call__(self, frame):
        return self.fetch(self.submit(frame), frame)

    def update_prompt(self, prompt: str):
        encoded = self._owner.engine.encode(prompt)  # outside the coordinator lock
        self._owner._control(lambda e: e.apply_prompt(self.slot, *encoded))

    def update_t_index_list(self, t_index_list):
        self._owner._control(lambda e: e.update_t_index(self.slot, t_index_list))

    def release(self):
        if not self._released:
            self._released = True
            self._owner.release(self.slot)


class MultiPeerPipeline:
    """Owns the MultiPeerEngine and the coordinator thread.  Runs on the
    card unless ``device`` says otherwise; ``params``: a ready param tree
    (otherwise the local snapshot's weights, or random weights from a fixed
    seed).  ``config``: any engine mode (full CFG, sequential, txt2img) the
    bucket steps run; ``controlnet`` (a model id or a snapshot dir): the
    ControlNet they condition on, as the JAX plane takes it.  The safety
    checker (SAFETY_CHECKER) gates each peer's output at its fetch, as on the
    single-peer path."""

    # steps in flight: step N's readback overlaps step N+1's launch
    PIPELINE_DEPTH = 2
    # frames queued per peer unless OVERLOAD_PEER_QUEUE_BOUND says otherwise:
    # one a step, one waiting for the next
    QUEUE_BOUND = 2

    def __init__(self, model_id: str = "stabilityai/sd-turbo", max_peers: int = 4, config=None,
                 prompt: str = DEFAULT_PROMPT, fetch_timeout: float = 120.0, device=None,
                 params: dict | None = None, controlnet: str | None = None):
        self.device = resolve_device(device)
        cfg = config or registry.default_stream_config(
            model_id, device=self.device, **({"use_controlnet": True} if controlnet else {}))
        bundle = registry.load_model_bundle(
            model_id, device=self.device, seed=0, attn_impl=cfg.attn_impl, params=params,
            controlnet=controlnet, latent_scale=cfg.latent_scale,
            annotator=cfg.annotator if cfg.use_controlnet else None)
        bundle.params = registry.cast_params(bundle.params, cfg.dtype)
        self.engine = MultiPeerEngine(bundle.stream_models, bundle.params, cfg,
                                      bundle.encode_prompt, max_peers=max_peers,
                                      device=self.device, model_id=model_id).start(prompt)
        self.config = cfg
        self.height, self.width = cfg.height, cfg.width
        self.max_peers = max_peers
        self.fetch_timeout = fetch_timeout
        self.safety_checker = maybe_load_safety_checker(model_id, device=self.device)
        self._lock = threading.Lock()  # the engine's state
        self._has_work = threading.Condition(self._lock)
        # bounded per-slot queues of (frame, Future): a peer that outpaces the
        # step sheds its oldest frame as passthrough instead of building latency
        self.queue_bound = max(1, env.get_int("OVERLOAD_PEER_QUEUE_BOUND", self.QUEUE_BOUND))
        self._queues = [DeadlineQueue(self.queue_bound, on_evict=self._evict)
                        for _ in range(max_peers)]
        self._last_frame = [np.zeros((cfg.height, cfg.width, 3), np.uint8) for _ in range(max_peers)]
        self._stop = False
        self._started = threading.Event()
        self._start_error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="multipeer-coordinator", daemon=True)
        self._thread.start()
        self._started.wait()
        if self._start_error is not None:
            self._thread.join(timeout=10)
            raise self._start_error

    # -- slot lifecycle -------------------------------------------------------------

    def claim(self, prompt: str | None = None) -> PeerPipeline:
        """Claim a slot for a new connection; raises CapacityError when full
        (the agent answers 503).  The state build runs outside the lock."""
        with self._lock:
            slot = self.engine.reserve()
        try:
            state = self.engine.build_state(DEFAULT_PROMPT if prompt is None else prompt, seed=slot)
        except Exception:
            with self._lock:
                self.engine.disconnect(slot)
            raise
        with self._lock:
            self.engine.install(slot, state)
            self._cancel_queued(slot)  # a late frame of the slot's last peer
            self._last_frame[slot] = np.zeros_like(self._last_frame[slot])
        return PeerPipeline(self, slot)

    def release(self, slot: int):
        with self._lock:
            self._cancel_queued(slot)
            self.engine.disconnect(slot)

    def _cancel_queued(self, slot: int):
        q = self._queues[slot]
        while (got := q.pop()) is not None:
            got[0][1].cancel()

    @property
    def frames_shed(self) -> int:
        """Frames every peer's queue has shed at its bound (/metrics'
        ``overload_peer_frames_shed``)."""
        return sum(q.shed_overflow for q in self._queues)

    @property
    def free_slots(self) -> int:
        with self._lock:
            return self.engine.free_slots

    # -- global control plane (POST /config: every active slot) ---------------------

    def update_prompt(self, prompt: str):
        encoded = self.engine.encode(prompt)
        with self._lock:
            for s, active in enumerate(self.engine.active):
                if active:
                    self.engine.apply_prompt(s, *encoded)

    def update_t_index_list(self, t_index_list):
        with self._lock:
            for s, active in enumerate(self.engine.active):
                if active:
                    self.engine.update_t_index(s, t_index_list)

    # -- coordinator ----------------------------------------------------------------

    @staticmethod
    def _evict(item, reason: str):
        """A peer's queue shed this frame: its waiter resolves as passthrough."""
        frame, fut = item
        shed_to_passthrough(fut, frame)

    def _enqueue(self, slot: int, frame: np.ndarray) -> Future:
        fut: Future = Future()
        self._queues[slot].push((frame, fut))
        with self._has_work:
            self._has_work.notify()
        return fut

    def _waiting(self) -> bool:
        return any(q.depth for q in self._queues)

    def _control(self, apply):
        """A per-peer engine write under the coordinator lock."""
        with self._lock:
            apply(self.engine)

    def _run(self):
        try:
            self.engine.prewarm_buckets()
        except BaseException as e:  # re-raised by the constructor
            self._start_error = e
            self._started.set()
            return
        self._started.set()
        # bound == PIPELINE_DEPTH: the pop below fires whenever the depth is
        # reached, so the deque can never exceed it
        inflight: deque = deque(maxlen=self.PIPELINE_DEPTH)  # (pending, futures)
        while True:
            with self._has_work:
                while not self._stop and not self._waiting() and not inflight:
                    self._has_work.wait(timeout=1.0)
                if self._stop:
                    for s in range(self.max_peers):
                        self._cancel_queued(s)
                    break
                # one frame per slot; the step is launched under the lock, the
                # readback waits outside it
                if self._waiting():
                    futs: list = [None] * self.max_peers
                    for s, q in enumerate(self._queues):
                        got = q.pop()
                        if got is not None:
                            (frame, fut), _ = got
                            # a copy: the caller may reuse its array, and an idle
                            # tick steps this frame again
                            self._last_frame[s] = np.array(frame, copy=True)
                            futs[s] = fut
                    try:
                        inflight.append((self.engine.submit(np.stack(self._last_frame)), futs))
                    except Exception as e:
                        logger.exception("multipeer step failed")
                        for fut in futs:
                            if fut is not None and not fut.cancelled():
                                fut.set_exception(e)
                more_queued = self._waiting()
            if inflight and (len(inflight) >= self.PIPELINE_DEPTH or not more_queued):
                pending, futs = inflight.popleft()
                try:
                    out = self.engine.fetch(pending)
                except Exception as e:
                    for fut in futs:
                        if fut is not None and not fut.cancelled():
                            fut.set_exception(e)
                    continue
                for s, fut in enumerate(futs):
                    if fut is not None:
                        try:
                            fut.set_result(out[s])
                        except InvalidStateError:
                            pass  # cancelled by a release
        for _, futs in inflight:  # drain on stop
            for fut in futs:
                if fut is not None:
                    fut.cancel()

    def close(self):
        with self._has_work:
            self._stop = True
            self._has_work.notify()
        self._thread.join(timeout=10)
