"""The system under test, driven as the agent drives it.

Each session is a camera (camera.py) feeding the port's own processing
track, ``server/tracks.VideoStreamTrack``, with ``pipeline_depth`` frames in
flight and the overload plane's freshest-frame-wins ingest; the track's
pipeline is a ``ScheduledSession`` claimed from one ``BatchScheduler`` (the
agent's default serving engine, every bucket a captured CUDA graph),
behind a thin probe that times each ``submit`` and notes what each
``fetch`` returned.  A viewer loop per session awaits ``recv()``, as the
agent's WHEP sender does.  So the window drives server/tracks.py ->
stream/scheduler.py -> parallel/multipeer.BucketStep -> aot/cache.
CapturedStep -> the engine's session step -> ops/kernels; the network, the
codec and the session and HTTP layers are left out.

The harness sets none of the program's environment knobs: it builds the
model bundle from the benchmark's own weights (``params=``) and hands the
stream, the scheduler and the track the values that the configuration file
states, which are the agent's defaults (``stream_config``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import time
from dataclasses import dataclass, field

import numpy as np

from . import camera as CAM

DRAIN_S = 0.5  # after the viewers stop: longer than the steps they can leave in flight
SCHEDULER_KEYS = ("guidance_scale", "delta")  # stream settings that BatchScheduler takes


@dataclass
class SessionRecord:
    """What one session's probe and viewer saw."""

    submitted: list = field(default_factory=list)  # frame indices, in submit order
    submit_spans: list = field(default_factory=list)  # (monotonic start, seconds)
    failed: list = field(default_factory=list)  # (monotonic, frame index or None, why)
    returns: list = field(default_factory=list)  # (monotonic, frame index) of processed frames
    outputs: dict = field(default_factory=dict)  # frame index -> served uint8, the kept ones


class Probe:
    """The ScheduledSession as the track sees it, with the harness's own
    span around ``submit`` and a note of each ``fetch``'s frame."""

    def __init__(self, session, record: SessionRecord, keep, shed_type):
        self._session = session
        self.record = record
        self._keep = keep  # frame index -> keep its output for the check
        self._shed_type = shed_type
        self.last = None  # (frame index, processed) of the newest fetch

    @property
    def frame_buffer_size(self) -> int:
        return self._session.frame_buffer_size

    def submit(self, frame):
        t0 = time.monotonic()
        handle = self._session.submit(frame)
        self.record.submit_spans.append((t0, time.monotonic() - t0))
        self.record.submitted.append(frame.index)
        return handle

    def fetch(self, handle, src_frame=None):
        idx = src_frame.index
        try:
            out = self._session.fetch(handle, src_frame)
        except Exception as e:
            self.record.failed.append((time.monotonic(), idx, repr(e)))
            self.last = (idx, False)
            raise
        processed = not isinstance(out, self._shed_type)
        self.last = (idx, processed)
        if not processed:
            self.record.failed.append((time.monotonic(), idx, "shed"))
        elif self._keep(idx):
            self.record.outputs[idx] = np.array(out, copy=True)
        return out

    def __call__(self, frame):
        return self.fetch(self.submit(frame), frame)


@dataclass
class Served:
    """A run's results: the window, each session's record, the counters."""

    t0: float
    t1: float
    records: list
    cameras: list
    counters: dict
    memory_peak_bytes: int | None
    trace_host: tuple | None = None  # (open, close) on the monotonic clock
    trace_counters: tuple | None = None  # scheduler snapshots at open and close


def stream_config(s: dict):
    """The program's StreamConfig from a configuration's ``stream`` settings:
    every key that is one of its fields (a list as a tuple).  The keys the
    scheduler takes (SCHEDULER_KEYS) are left to ``build``; any other key is
    refused, not dropped."""
    from ai_rtc_agent_tpu_torch.stream.engine import StreamConfig

    fields = {f.name for f in dataclasses.fields(StreamConfig)}
    unknown = sorted(set(s) - fields - set(SCHEDULER_KEYS))
    if unknown:
        raise ValueError(f"stream settings that the program does not take: {', '.join(unknown)}")
    return StreamConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in s.items() if k in fields})


def build(cfg: dict, tree: dict, sessions: int, device):
    """The program: the model bundle over ``tree``, cast as the pipeline
    casts it, and a BatchScheduler of ``sessions`` slots with every bucket
    captured (prewarm)."""
    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    s, serving = cfg["stream"], cfg["serving"]
    scfg = stream_config(s)
    bundle = registry.load_model_bundle(cfg["model_id"], device=device, params=tree,
                                        attn_impl=scfg.attn_impl, latent_scale=scfg.latent_scale)
    params = registry.cast_params(bundle.params, scfg.dtype)
    return BatchScheduler(
        bundle.stream_models, params, scfg, bundle.encode_prompt, model_id=cfg["model_id"],
        max_sessions=sessions, window_ms=serving["window_ms"], queue_bound=serving["queue_bound"],
        guidance_scale=s["guidance_scale"], delta=s["delta"], prewarm=True, device=device,
        graphs=serving["graphs"] and str(device).startswith("cuda"), safety_checker=None, dp=1)


def replay_buckets(sched, n: int, height: int, width: int):
    """Step every bucket a cell of ``n`` sessions can use once, through
    throwaway sessions, before the cell's own are claimed: prewarm captures
    a bucket's graph but never replays it, and a graph's first replay pays
    its upload (a stall of a traffic's rare bucket inside the window) and
    inside a profiler window can stall CUPTI (ROADMAP §C.16).  For bucket k, k
    sessions are live; two one-rider steps are left unfetched, so the
    dispatcher holds (two steps in flight) until every live session has a
    frame waiting, and then steps all k together."""
    frame = np.zeros((height, width, 3), np.uint8)
    sizes, k = [], 1
    while k < n:
        sizes.append(k)
        k *= 2
    for k in sizes + [n]:
        sessions = [sched.claim(f"bench-warm-{k}-{i}", seed=i) for i in range(k)]
        try:
            if k == 1:
                sessions[0].fetch(sessions[0].submit(frame))
                continue
            held = []
            for s in sessions[:2]:  # two steps in flight, one rider each
                held.append((s, s.submit(frame)))
                time.sleep(0.05)
            rest = [(s, s.submit(frame)) for s in sessions]
            for s, h in held + rest:
                s.fetch(h)
        finally:
            for s in sessions:
                s.release()


def serve(sched, cfg: dict, traffic: dict, plan: list, scenes: list, keeps: list,
          seconds: float, t_start: float, profile=None, memory=None, say=None) -> Served:
    """Claim a session per plan entry, serve the cameras through the tracks,
    settle, measure ``seconds``, and stop every viewer.  ``profile``: a
    trace.Profiler to open for the window's last ``traffic["trace_s"]``;
    ``memory``: a callable giving the device's peak allocated bytes."""
    from ai_rtc_agent_tpu_torch.resilience.overload import OverloadControlPlane, ShedFrame
    from ai_rtc_agent_tpu_torch.server.tracks import VideoStreamTrack

    n = len(plan)
    replay_buckets(sched, n, cfg["stream"]["height"], cfg["stream"]["width"])
    records = [SessionRecord() for _ in range(n)]
    probes = []
    for i, p in enumerate(plan):
        sess = sched.claim(f"bench-{i}", prompt=p["prompt"], seed=p["noise_seed"])
        probes.append(Probe(sess, records[i], keeps[i], ShedFrame))
    overload = OverloadControlPlane()
    if say is not None:
        say(f"set-up: {time.monotonic() - t_start:.2f} s with {n} sessions claimed")
    return asyncio.run(_serve(sched, traffic, plan, scenes, probes, overload, seconds, profile,
                              memory, cfg["serving"]["pipeline_depth"], VideoStreamTrack))


async def _serve(sched, traffic, plan, scenes, probes, overload, seconds, profile, memory, depth,
                 track_type) -> Served:
    n = len(plan)
    start = time.monotonic() + 0.05
    cams = [CAM.Camera(scenes[i], traffic["camera_fps"], start, plan[i]["phase"])
            for i in range(n)]
    tracks = [track_type(cams[i], probes[i], pipeline_depth=depth, overload=overload)
              for i in range(n)]
    stop = asyncio.Event()

    async def viewer(i):
        rec, probe = probes[i].record, probes[i]
        while not stop.is_set():
            try:
                await tracks[i].recv()
            except Exception as e:  # counted where it happened (the probe) or here
                if probe.last is None or probe.last[1]:
                    rec.failed.append((time.monotonic(), None, repr(e)))
                await asyncio.sleep(0.01)
                continue
            idx, processed = probe.last
            if processed:
                rec.returns.append((time.monotonic(), idx))

    tasks = [asyncio.create_task(viewer(i)) for i in range(n)]
    settle_end = time.monotonic() + traffic["settle_s"]
    while time.monotonic() < settle_end or any(
            len(p.record.returns) < traffic["settle_frames"] for p in probes):
        if time.monotonic() > settle_end + 120.0:
            raise RuntimeError("sessions did not settle within 120 s of serving")
        if any(t.done() for t in tasks):
            [t.result() for t in tasks if t.done()]
        await asyncio.sleep(0.05)
    if memory is not None:
        memory(reset=True)
    t0 = time.monotonic()
    c0 = sched.snapshot()
    served = Served(t0, t0 + seconds, [p.record for p in probes], cams, {"t0": c0},
                    None)
    if profile is not None:  # the profiler closes with the window; it is read after
        await asyncio.sleep(max(0.0, served.t1 - traffic["trace_s"] - time.monotonic()))
        snap_open = sched.snapshot()
        profile.start()
    await asyncio.sleep(max(0.0, served.t1 - time.monotonic()))
    served.counters["t1"] = sched.snapshot()
    stop.set()
    done, pending = await asyncio.wait(tasks, timeout=60.0)
    for t in pending:
        t.cancel()
    for t in done:
        t.result()
    if profile is not None:
        # closed once the viewers have stopped and the steps they left in
        # flight have run, so that no graph launches while the profiler
        # stops; the window it reports still ends at the measured one's end
        await asyncio.sleep(DRAIN_S)
        profile.stop(t_close=served.t1)
        served.trace_host = (profile.t_open, profile.t_close)
        served.trace_counters = (snap_open, served.counters["t1"])
    if memory is not None:
        served.memory_peak_bytes = memory()
    return served


def release(sched):
    """Stop the scheduler's dispatcher and free the program's device memory."""
    sched.close()
    del sched
    gc.collect()
