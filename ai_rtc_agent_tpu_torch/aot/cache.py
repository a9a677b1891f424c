"""Engine keys and captured steps — counterpart of ai_rtc_agent_tpu/aot/cache.py.

The JAX package never runs a step op by op: every step path is one compiled
executable with donated state, built before the first frame (its
``prewarm_buckets``) and keyed by one recipe (``engine_key``,
``stream_engine_key``, the scheduler's ``bucket_keys``).  The port's
counterpart is one CUDA graph per engine and per bucket size (a DeepCache
config: a capture and a cached graph each, keyed ``variant-capture`` /
``variant-cached``; w8 params add ``quant-w8``), captured at prewarm on the
thread that will step it and replayed per step:

* :func:`engine_key` / :func:`stream_engine_key`: the JAX recipe, copied
  (the port imports nothing of the JAX package), with the port's version.
* :class:`CapturedStep`: a step function over static input buffers.  The
  caller writes the step's inputs into ``inputs`` and calls :meth:`run`,
  which replays the graph (its output is the same tensor every time) or,
  without a graph, calls the function eagerly over the same buffers: the
  CPU path, and the eager A/B on the card (``graphs=False``).
* :class:`GraphCache`: an engine's captured steps by key, all captured into
  one memory pool.

These conditions make a replay right and safe to trace, and the engines
keep them:

* The graph reads and writes fixed addresses, so every state write lands
  in place (``copy_``/``fill_`` into the tensors the graph was captured
  over), and inputs reach the graph only through the static buffers.
* Graphs sharing a pool may reuse each other's freed intermediates, and a
  replay overwrites its own output: every replay, and each read of its
  output (the readback's device-to-host copy, queued right after it), runs
  on the one stream of the stepping threads (the default stream).
* The kernel wrappers' launch counters are plain ints that a replay does
  not move: a capture records each counter's delta and :meth:`run` adds it
  per replay (capture itself executes nothing, so it leaves them as they
  were).  A capture runs before sessions are admitted, or lazily on the
  one thread that steps its plane, so no other thread launches meanwhile.
* No garbage collection runs on the capturing thread while it captures: a
  graph freed there (a closed scheduler's: it and its engine guard refer to
  each other) would be destroyed mid-capture, which invalidates the
  capture.
* A captured graph keeps the graph it was instantiated from for as long as
  it lives (``keep_graph=True``, then :meth:`CapturedStep.capture`
  instantiates it).  torch otherwise destroys that source graph right after
  instantiating it, and then a graph's first launch in a profiler window,
  after enough graphs were built and destroyed in between, faulted inside
  CUPTI under ``cuGraphLaunch``; keeping the source graph removed the
  fault in every run since.  That CUPTI reads the freed source nodes there
  is inferred from those runs, not observed (ROADMAP §C.16, repaired).

What does not carry over: the JAX cache serializes executables to disk
(``jax.export``) and a later process adopts them.  A CUDA graph holds the
device addresses of one process and cannot be written out, so the cache
here lives in the process; the only on-disk part is ``build/``'s nvcc
libraries, cached by source digest (``ops/kernels/build.py``).

Device telemetry (obs/devtel.py) reads the cache under the JAX AOT cache's
names: every :meth:`GraphCache.get` is a hit or a miss, a miss is a build
(the capture on the card, the builder on the CPU) with its seconds, which
the build watchdog records, and after each build the inventory of every
live cache (:func:`inventory`) refreshes the entries and bytes gauges.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Callable

import torch

from .. import __version__
from ..obs import devtel
from ..ops.kernels import attention as _attention
from ..ops.kernels import fused_scheduler as _epilogue
from ..ops.kernels import norm as _norm

WARMUP_STEPS = 2  # eager runs on a side stream before a capture


def engine_key(model_id: str, mode: str, **attrs) -> str:
    """Human-readable engine key: model x mode x the sorted attributes x
    the package version (the JAX recipe)."""
    safe_model = model_id.replace("/", "--")
    parts = [f"engines--{safe_model}", f"mode-{mode}"]
    for k in sorted(attrs):
        parts.append(f"{k}-{attrs[k]}")
    parts.append(f"v-{__version__}")
    return "--".join(parts)


def stream_engine_key(model_id: str, cfg, **extra) -> str:
    """The key of a (model, stream config) pair, as the JAX package's
    ``stream_engine_key`` spells it: every flag that changes the step's
    graph is in it.  A bucket adds ``sbucket``/``sessions``, --multipeer
    ``peers``.

    As in the JAX recipe, sequential mode (``use_denoising_batch=False``)
    has no field of its own, and its batch size equals the denoising
    batch's.  That is safe here: a :class:`GraphCache` belongs to one
    engine, one scheduler's bucket step or one peer engine, each built over
    one config, so a sequential step and a denoising-batch step never meet
    in one cache, and every key stays the JAX spelling."""
    return engine_key(
        model_id,
        cfg.mode,
        batch=cfg.batch_size,
        hw=f"{cfg.height}x{cfg.width}",
        dtype=cfg.dtype,
        cfgtype=cfg.cfg_type,
        sched=cfg.scheduler,
        cnet=f"{int(cfg.use_controlnet)}{cfg.annotator if cfg.use_controlnet else ''}",
        fused=int(cfg.use_fused_epilogue),
        **({"dcache": cfg.unet_cache_interval} if cfg.unet_cache_interval >= 2 else {}),
        attn=cfg.attn_impl,
        **extra,
    )


def mesh_key_extra(mesh) -> dict:
    """Engine-key extras of a serving mesh (the JAX recipe): nothing for a
    trivial or absent mesh, so every single-device key stays as it was,
    and ``dp-N`` otherwise, so a sharded step never shares a key with the
    single-device one."""
    if mesh is None:
        return {}
    dp = mesh.shape.get("dp", 1)
    return {"dp": dp} if dp > 1 else {}


def adapter_key_extra(rank: int) -> dict:
    """Engine-key extras of the per-session LoRA factor bank (adapters/): an
    adapterless scheduler (bank rank 0) keeps every key as it was, and a
    bank keys on its padded rank, so a (k, variant, rank) graph never meets
    an adapterless one.  The rank is the only shape the bank adds: targets
    and adapter names live in the stacked state, so swaps leave the key."""
    rank = int(rank or 0)
    return {"lrank": rank} if rank > 0 else {}

def _launches() -> tuple:
    return _attention.launches, _epilogue.launches, _norm.launches


def _set_launches(counts: tuple):
    _attention.launches, _epilogue.launches, _norm.launches = counts


class CapturedStep:
    """``fn(inputs) -> out`` over the static buffers ``inputs`` (a dict of
    tensors on one device), replayed from one CUDA graph after
    :meth:`capture`, or called eagerly by :meth:`run` when ``graph`` is
    False (a CPU device steps eagerly only)."""

    def __init__(self, key: str, fn: Callable[[dict], torch.Tensor], inputs: dict, *,
                 graph: bool, pool=None):
        self.key = key
        self.fn = fn
        self.inputs = inputs
        self.device = next(iter(inputs.values())).device
        if graph and self.device.type != "cuda":
            raise ValueError(f"{key}: a CUDA graph needs a CUDA device, got {self.device}")
        self.graph = graph
        self.pool = pool
        self._cuda_graph = None
        self.out = None  # the replay's output (the same tensor every replay)
        self.launches = (0, 0)  # (attention, epilogue) launches per replay
        self.norm_launches = 0  # GroupNorm and LayerNorm kernel launches per replay
        self.capture_s = None

    @property
    def captured(self) -> bool:
        return self._cuda_graph is not None

    def capture(self):
        """Run ``fn`` WARMUP_STEPS times on a side stream (the first launch of
        each kernel sets its attributes, cuBLAS and cuDNN pick algorithms and
        workspaces), then capture one call into the graph, on the calling
        thread, with thread-local capture rules (other threads may stage
        frames meanwhile).  The warm-up runs execute: a caller whose step
        writes state restores it after.  A capture that fails raises."""
        if not self.graph:
            raise RuntimeError(f"{self.key}: this step runs eagerly (graph=False)")
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.fn(self.inputs)
        current.wait_stream(side)
        cuda_graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = _launches()
        # no garbage collection on this thread while it captures: an old
        # graph in a cycle (a closed scheduler's) freed here would be
        # destroyed mid-capture, which invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(cuda_graph, pool=self.pool, capture_error_mode="thread_local"):
                out = self.fn(self.inputs)
        finally:
            if collecting:
                gc.enable()
        cuda_graph.instantiate()  # keep_graph: the source graph lives as long as this one
        attn, epi, norm = (a - b for a, b in zip(_launches(), before))
        self.launches, self.norm_launches = (attn, epi), norm
        _set_launches(before)
        torch.cuda.synchronize(self.device)
        self._cuda_graph, self.out = cuda_graph, out
        self.capture_s = time.perf_counter() - t0
        return self

    def run(self) -> torch.Tensor:
        """One step over the current contents of ``inputs``."""
        if not self.graph:
            return self.fn(self.inputs)
        if self._cuda_graph is None:
            raise RuntimeError(f"{self.key}: not captured")
        self._cuda_graph.replay()
        attn, epi = self.launches
        _attention.launches += attn
        _epilogue.launches += epi
        _norm.launches += self.norm_launches
        return self.out


_LIVE = weakref.WeakSet()  # every GraphCache alive in the process


def inventory() -> tuple:
    """(steps held, bytes of their graph pools on the card) over every live
    :class:`GraphCache`: the ``aot_cache_entries``/``aot_cache_bytes``
    gauges.  Reads the allocator's snapshot, so it runs after a build, never
    per step."""
    caches = list(_LIVE)
    entries = sum(len(c._steps) for c in caches)
    pools = {tuple(c.pool) for c in caches if c.pool is not None}
    nbytes = 0
    if pools:
        nbytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if tuple(seg.get("segment_pool_id", ())) in pools)
    return entries, nbytes


def live_buffers() -> int:
    """The static buffers (inputs, and a captured step's output) of every
    step the live caches hold: the CPU's ``device_live_buffers``."""
    return sum(len(step.inputs) + (step.out is not None)
               for c in list(_LIVE) for step in list(c._steps.values()))


class GraphCache:
    """One engine's, scheduler's or peer engine's steps by engine key.  With
    ``graphs`` each is captured at its first :meth:`get` (at prewarm, on
    the thread that will step it), and all of them into one memory pool:
    they replay one at a time, in stream order."""

    def __init__(self, graphs: bool, device):
        if graphs and torch.device(device).type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}: the CPU steps eagerly")
        self.graphs = graphs
        self.pool = torch.cuda.graph_pool_handle() if graphs else None
        self._steps: dict = {}
        _LIVE.add(self)

    def get(self, key: str, build: Callable[[], tuple]) -> CapturedStep:
        """The step of ``key``; ``build() -> (fn, inputs)`` makes it at its
        first use, which captures it with ``graphs``."""
        step = self._steps.get(key)
        if step is not None:
            devtel.note_aot("hit")
            return step
        devtel.note_aot("miss")
        t0 = time.perf_counter()
        fn, inputs = build()
        step = CapturedStep(key, fn, inputs, graph=self.graphs, pool=self.pool)
        if self.graphs:
            step.capture()
        self._steps[key] = step
        devtel.note_aot("build", seconds=time.perf_counter() - t0, context=key,
                        inventory=inventory)
        return step

    def status(self) -> dict:
        """{key: captured} for every step built so far."""
        return {key: step.captured for key, step in self._steps.items()}

    def steps(self) -> dict:
        return dict(self._steps)
