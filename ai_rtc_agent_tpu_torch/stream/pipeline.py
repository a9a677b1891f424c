"""Pipeline façade — counterpart of ai_rtc_agent_tpu/stream/pipeline.py.

``StreamDiffusionPipeline(model_id)`` owns the model bundle and the engine
and exposes the serving surface: ``__call__`` (frame in, frame out),
``submit``/``fetch`` (frames in flight), ``update_prompt``,
``update_t_index_list``, ``update_guidance`` and ``restart``, plus the
surface the serving track drives: ``fetch(handle, src_frame)`` and
``postprocess`` (the source's pts and time_base carried to the output
frame), ``frame_buffer_size`` and ``submit_batch``/``fetch_batch``.

It runs on the card unless ``device="cpu"`` is passed, and raises without
one.  On the card the engine's step is captured as one CUDA graph when the
façade is built (the counterpart of the JAX pipeline adopting its AOT
engine at build) and replayed per frame (DeepCache: both graphs of the
pair, the first live frame a capture); ``restart`` and the ``update_*``
methods write the state in place, which the graphs read.  There is no
build-time probe with a fallback: a kernel that fails to build or launch,
or a capture that fails, raises.  A frame that carries a trace
(obs/trace.py) gets the JAX pipeline's spans: ``submit``, ``engine_step``
(on the pipelined path submit-end -> the readback resolved, stamped on the
host), ``fetch``, ``postprocess`` and the ``similar_skip`` mark.

``lora_dict`` (path -> scale) fuses LoRA files at load (models/lora.py);
``controlnet`` (a model id or a snapshot dir) adds the ControlNet branch,
as the JAX pipeline's does.
The safety checker (``use_safety_checker``, default the SAFETY_CHECKER
env) runs on every output after its readback, as in the JAX pipeline, and
on the same device as the pipeline; the batch scheduler and --multipeer
apply the pipeline's checker through :func:`finish_output`.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from .. import resolve_device
from ..media.frames import wrap_processed
from ..models import registry
from ..obs.trace import get_trace
from ..utils import env
from .engine import StreamConfig, StreamEngine

DEFAULT_PROMPT = "fireworks in the night sky"
DEFAULT_GUIDANCE_SCALE = 1.2
DEFAULT_DELTA = 1.0


class StreamDiffusionPipeline:
    def __init__(
        self,
        model_id: str = "stabilityai/sd-turbo",
        config: StreamConfig | None = None,
        prompt: str = DEFAULT_PROMPT,
        seed: int = 2,
        device=None,
        params: dict | None = None,
        graphs: bool | None = None,
        lora_dict: dict | None = None,
        use_safety_checker: bool | None = None,
        controlnet: str | None = None,
        mesh=None,
    ):
        """``params``: a ready param tree (e.g. ``bridge.params_from_jax`` of
        a JAX pipeline's); otherwise the local snapshot's weights, or random
        weights from a fixed seed.  ``graphs`` (default: on a CUDA device)
        captures the step now and replays it per frame; False steps eagerly
        (the A/B on the card).  ``controlnet``: a ControlNet model id or
        snapshot dir (the default config then conditions on it, with the
        config's annotator).  ``mesh``: a tp/sp serving mesh over the
        world's ranks (parallel/mesh.py ``make_mesh``), handed to the engine
        as the JAX pipeline hands it; every rank builds the pipeline alike,
        and in a world of more than one, rank 0's engine is wrapped in
        parallel/serving.py's ``LockstepEngine`` (the other ranks run
        ``serving.follow(pipeline.engine)``)."""
        self.device = resolve_device(device)
        self.model_id = model_id
        self.prompt = prompt
        self.guidance_scale = DEFAULT_GUIDANCE_SCALE
        self.delta = DEFAULT_DELTA
        self._seed = seed
        self.safety_checker = maybe_load_safety_checker(model_id, use_safety_checker,
                                                        device=self.device)
        cfg = config or registry.default_stream_config(
            model_id, device=self.device, **({"use_controlnet": True} if controlnet else {}))
        if cfg.use_controlnet and controlnet is None:
            raise ValueError("StreamConfig.use_controlnet=True requires a controlnet model id "
                             "(pass controlnet=... to StreamDiffusionPipeline)")
        bundle = registry.load_model_bundle(
            model_id, device=self.device, seed=0,
            attn_impl=cfg.attn_impl, params=params, lora_dict=lora_dict,
            controlnet=controlnet, latent_scale=cfg.latent_scale,
            annotator=cfg.annotator if cfg.use_controlnet else None,
        )
        bundle.params = registry.cast_params(bundle.params, cfg.dtype)
        self.bundle = bundle
        self.config = cfg
        self.t_index_list = list(cfg.t_index_list)
        self.engine = StreamEngine(
            models=bundle.stream_models,
            params=bundle.params,
            cfg=cfg,
            encode_prompt=bundle.encode_prompt,
            device=self.device,
            graphs=graphs,
            model_id=model_id,
            mesh=mesh,
        )
        self.engine.prepare(
            prompt=prompt, guidance_scale=self.guidance_scale, delta=self.delta, seed=seed
        )
        self.engine.capture()
        # DeepCache: both graphs are warm; the first live frame captures
        # (the JAX pipeline's probe resets the cadence after its warm-up)
        self.engine.reset_cache_cadence()
        if mesh is not None:
            from ..parallel import serving
            from ..parallel.mesh import host_count

            if host_count() > 1 and serving.world_rank() == 0:
                self.engine = serving.LockstepEngine(self.engine)

    def restart(self):
        """Re-prepare the engine in place (fresh stream state, same params),
        restoring the live prompt, guidance and delta.  A step submitted
        before the restart and held past it (a stall, an injected fault, a
        step the supervisor abandoned) is dropped, not replayed: the
        restart bumps the engine's epoch under its submit lock."""
        self.engine.restart(prompt=self.prompt, guidance_scale=self.guidance_scale,
                            delta=self.delta, seed=self._seed)

    # -- control plane --------------------------------------------------------

    def update_prompt(self, prompt: str):
        self.engine.update_prompt(prompt)
        self.prompt = prompt

    def update_t_index_list(self, t_index_list: Sequence[int]):
        self.engine.update_t_index_list(t_index_list)
        self.t_index_list = list(t_index_list)

    def update_guidance(self, guidance_scale=None, delta=None):
        g = None if guidance_scale is None else float(guidance_scale)
        d = None if delta is None else float(delta)
        self.engine.update_guidance(guidance_scale=g, delta=d)
        if g is not None:
            self.guidance_scale = g
        if d is not None:
            self.delta = d

    # -- frame path -------------------------------------------------------------

    def preprocess(self, frame) -> np.ndarray:
        return coerce_frame(frame, self.config.height, self.config.width)

    def postprocess(self, out_u8: np.ndarray, src_frame=None):
        """Attach the source frame's timing metadata when it carries any."""
        if src_frame is not None and hasattr(src_frame, "pts"):
            return wrap_processed(out_u8, src_frame)
        return out_u8

    def __call__(self, frame):
        trace = get_trace(frame)  # None (one getattr) unless a trace rides the frame
        if trace is None:
            return finish_output(self.engine(self.preprocess(frame)), frame, self.safety_checker)
        with trace.span("submit"):
            pre = self.preprocess(frame)
        with trace.span("engine_step"):  # the synchronous path: the whole step
            out = self.engine(pre)
            if self.safety_checker is not None:
                out = self.safety_checker(out)
        if self.engine.last_submit_was_skip:
            trace.mark("similar_skip")
        return finish_output(out, frame, trace=trace)

    def submit(self, frame):
        """Queue one frame without waiting; returns a handle for :meth:`fetch`."""
        trace = get_trace(frame)
        if trace is None:
            return self.engine.submit(self.preprocess(frame))
        with trace.span("submit"):  # host preprocess, staging and the replay's launch
            handle = self.engine.submit(self.preprocess(frame))
        if self.engine.last_submit_was_skip:
            trace.mark("similar_skip")
        return handle

    def fetch(self, handle, src_frame=None):
        """Resolve a :meth:`submit` handle; attaches ``src_frame``'s pts."""
        trace = get_trace(src_frame) if src_frame is not None else None
        if trace is None:
            return finish_output(self.engine.fetch(handle), src_frame, self.safety_checker)
        t0 = time.monotonic()
        out = self.engine.fetch(handle)
        t1 = time.monotonic()
        # fetch: the blocking resolve; engine_step: submit-end -> resolved
        # (stamped before the safety checker, as the JAX pipeline stamps it)
        trace.add_span("fetch", t0, t1)
        sub_end = trace.span_end("submit")
        trace.add_span("engine_step", sub_end if sub_end is not None else t0, t1)
        return finish_output(out, src_frame, self.safety_checker, trace=trace)

    # -- frame_buffer_size > 1: fbs consecutive frames in one step ----------------

    @property
    def frame_buffer_size(self) -> int:
        return self.config.frame_buffer_size

    def submit_batch(self, frames):
        """frames: a list of fbs frames -> one in-flight handle."""
        return self.engine.submit(np.stack([self.preprocess(f) for f in frames]))

    def fetch_batch(self, handle, src_frames=None):
        """Resolve a :meth:`submit_batch` handle -> a list of fbs frames, each
        with its source's pts."""
        out = self.engine.fetch(handle)  # [fbs, H, W, 3]
        if self.safety_checker is not None:
            out = self.safety_checker(out)
        return [
            finish_output(out[i], src_frames[i] if src_frames else None)
            for i in range(out.shape[0])
        ]


def finish_output(out_u8: np.ndarray, src_frame=None, safety_checker=None, trace=None):
    """The output contract every serving plane shares (the pipeline, the
    batch scheduler's sessions, --multipeer's peers): the safety checker
    on the pixels, then the source frame's pts (and trace) carried to the
    output, unless HW_ENCODE serving wants bare ndarrays; the
    ``postprocess`` span when a trace rides along."""
    if safety_checker is not None:
        out_u8 = safety_checker(out_u8)
    if env.hw_encode() or src_frame is None or not hasattr(src_frame, "pts"):
        return out_u8
    if trace is None:
        return wrap_processed(out_u8, src_frame)
    with trace.span("postprocess"):
        return wrap_processed(out_u8, src_frame)


def maybe_load_safety_checker(model_id: str, use: bool | None = None, device=None):
    """The NSFW gate shared by every serving plane, or None when it is off
    (``use=None``: the SAFETY_CHECKER env).  Weights from the model's
    snapshot's ``safety_checker/`` subfolder, else from a local snapshot of
    CompVis/stable-diffusion-safety-checker, else random (flags nothing)."""
    if use is None:
        use = env.get_bool("SAFETY_CHECKER", False)
    if not use:
        return None
    from ..models import loader
    from ..models.safety import SafetyChecker

    snap = registry.resolve_snapshot_dir(model_id)
    if not snap or not loader.find_safetensors(snap, "safety_checker"):
        snap = registry.resolve_snapshot_dir("CompVis/stable-diffusion-safety-checker") or snap
    return SafetyChecker.load(snap, device=device)


def coerce_frame(frame, h: int, w: int) -> np.ndarray:
    """ndarray or av.VideoFrame-like (``.to_ndarray(format="rgb24")``) ->
    [h,w,3] uint8, nearest-resized when the source size differs."""
    if hasattr(frame, "to_ndarray"):
        arr = frame.to_ndarray(format="rgb24")
    elif isinstance(frame, np.ndarray):
        arr = frame
    else:
        raise TypeError(f"invalid frame type: {type(frame)!r}")
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected HxWx3 uint8 RGB, got {arr.shape} {arr.dtype}")
    if arr.shape[:2] != (h, w):
        ys = (np.arange(h) * arr.shape[0] // h).clip(0, arr.shape[0] - 1)
        xs = (np.arange(w) * arr.shape[1] // w).clip(0, arr.shape[1] - 1)
        arr = arr[ys][:, xs]
    return arr
