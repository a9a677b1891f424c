"""The port's deploy preflight — counterpart of
ai_rtc_agent_tpu/assets/build_engines.py, with the JAX CLI's flags.

The JAX CLI AOT-compiles the stream step (and the ``--multipeer`` and batch
scheduler buckets) and serializes each executable into an engine cache that
serving adopts.  A CUDA graph holds the device addresses of one process and
cannot be written out, so the port captures its graphs at startup and has
no such cache; its deploy-time work is of another kind, and this CLI does
it ahead of serving, on the card that will serve:

* builds every ``csrc/*.cu`` kernel library with nvcc into ``build/`` (one
  nvcc per source, in parallel; a library already built from the same
  source is kept), so the first request pays no build;
* loads the bundle the agent would serve (``--lora path:scale`` fused,
  ``--controlnet``), cast as serving casts it;
* captures every step the deployment serves: the engine's (``full``, or
  the ``capture`` + ``cached`` pair under UNET_CACHE), every ``--peers N``
  bucket and every ``--sched-buckets S`` bucket of the batch scheduler, each
  keyed as serving keys it (``aot/cache.stream_engine_key`` plus the params
  variant: the JAX spelling);
* replays each once and requires the replay to equal the eager step from
  the same state, outputs and every state leaf bit for bit.

Every graph is freed when the CLI returns.  ``--cache-dir`` names the JAX
engine store and is refused.  With ``device="cpu"`` (the tests) nothing is
built or captured: each step runs eagerly once and the keys are the same.

Usage:
  python -m ai_rtc_agent_tpu_torch.assets.build_engines --model-id stabilityai/sd-turbo
  python -m ai_rtc_agent_tpu_torch.assets.build_engines --model-id lykon/dreamshaper-8 \\
      --lora ./models/civitai/studio-ghibli-style-lora.safetensors:1.0 --sched-buckets 8
"""

from __future__ import annotations

import argparse
import logging
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import resolve_device
from ..tree import tree_equal, tree_map

logger = logging.getLogger(__name__)

PROBE_PROMPT = "engine build probe"


def build_kernels():
    """Build and load every ``csrc/*.cu`` library, one nvcc per source in
    parallel, logging each one's seconds (about 0 if already built)."""
    from ..ops.kernels import build as KB

    sources = sorted(p.name for p in KB.CSRC_DIR.glob("*.cu"))

    def one(source):
        t0 = time.perf_counter()
        KB.load_library(source)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources)) as pool:
        seconds = dict(zip(sources, pool.map(one, sources)))
    for source, s in seconds.items():
        logger.info("kernel library %s ready in %.1fs", source, s)


def stream_config(model_id: str, controlnet: str | None, device):
    """The serving config of ``model_id`` on ``device`` (conditioned with a
    ControlNet), as the pipeline and the agent build it."""
    from ..models import registry

    return registry.default_stream_config(
        model_id, device=device, **({"use_controlnet": True} if controlnet else {}))


def load_bundle(model_id: str, lora_dict: dict | None, controlnet: str | None, device):
    """(bundle, config): the bundle the pipeline would serve (seed 0, the
    config's attention route, LoRAs fused, cast to the config's dtype)."""
    from ..models import registry

    cfg = stream_config(model_id, controlnet, device)
    bundle = registry.load_model_bundle(
        model_id, device=device, seed=0, attn_impl=cfg.attn_impl, lora_dict=lora_dict,
        controlnet=controlnet, latent_scale=cfg.latent_scale,
        annotator=cfg.annotator if cfg.use_controlnet else None)
    bundle.params = registry.cast_params(bundle.params, cfg.dtype)
    return bundle, cfg


def _frames(cfg, n: int | None) -> np.ndarray:
    """Seeded uint8 frames for a step: [fbs,H,W,3] (``n`` None) or
    [n,H,W,3] ([n,fbs,H,W,3] with fbs > 1)."""
    fbs = cfg.frame_buffer_size
    lead = (fbs,) if n is None else ((n, fbs) if fbs > 1 else (n,))
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (*lead, cfg.height, cfg.width, 3), dtype=np.uint8)


def _note(kind: str, key: str, seconds: float | None):
    if seconds is None:
        logger.info("%s %s stepped eagerly", kind, key)
    else:
        logger.info("%s %s captured in %.2fs, replay = eager bit for bit", kind, key, seconds)


def _require_equal(what: str, got: torch.Tensor, want: torch.Tensor, same_state: bool):
    same_out = torch.equal(got, want)
    if not (same_out and same_state):
        # tpurtc: allow[device-transfer] -- a failed check's message reads one scalar back; a passing preflight never does
        levels = (got.int() - want.int()).abs().max().item()
        raise RuntimeError(f"{what}: the replay differs from the eager step (outputs equal "
                           f"{same_out}, max {levels} levels; state equal {same_state})")


def engine_replay_equals_eager(eng, frames: np.ndarray | None = None) -> dict:
    """Each captured step of ``eng`` (both DeepCache variants) against its
    eager step from a copy of the same state and the uint8 ``frames``
    ([fbs,H,W,3]; default seeded): outputs and every state leaf bit for bit
    (raises RuntimeError otherwise); the state is put back after.  Without
    graphs each step just runs once.
    -> {key: capture seconds (None without graphs)}."""
    from ..stream.engine import install_state, stage_into

    out = {}
    with eng._submit_lock:
        steps = eng._static_steps_locked()
        saved = tree_map(lambda a: a.clone(), eng.state)
        for v, step in steps.items():
            frame = stage_into(step.inputs["frame"],
                               _frames(eng.cfg, None) if frames is None else frames)
            if eng.graphs:
                copy = tree_map(lambda a: a.clone(), saved)
                want = eng._steps[v](eng.params, copy, frame)[1].clone()
                got = step.run().clone()
                torch.cuda.synchronize(eng.device)
                _require_equal(step.key, got, want, tree_equal(eng.state, copy))
            else:
                step.run()
            install_state(eng.state, saved)
            out[step.key] = step.capture_s
            _note("engine", step.key, step.capture_s)
    return out


def bucket_replay_equals_eager(bucket, models, cfg, params, states, frames: np.ndarray,
                               slots: list, k: int, variant: str | None, what: str):
    """One step of the captured bucket step ``bucket`` (bucket ``k``, its
    ``variant``: DeepCache's capture or cached; None the first) against an
    eager bucket step over a copy of the same stacked ``states``, uint8
    ``frames`` and ``slots``: outputs and every state leaf bit for bit
    (raises RuntimeError naming ``what`` otherwise); the states are put
    back after.  The caller holds the step lock, if the states have one."""
    from ..parallel.multipeer import BucketStep
    from ..stream.engine import install_state

    saved = tree_map(lambda a: a.clone(), states)
    copy = tree_map(lambda a: a.clone(), states)
    eager = BucketStep(models, cfg, bucket.device, graphs=False)
    want = eager(params, copy, frames, slots, k, variant).clone()
    got = bucket(params, states, frames, slots, k, variant).clone()
    torch.cuda.synchronize(bucket.device)
    same_state = tree_equal(states, copy)
    install_state(states, saved)
    _require_equal(what, got, want, same_state)


def buckets_replay_equal_eager(bucket, models, cfg, params, states, keys: dict) -> dict:
    """Each bucket (k, variant) of ``keys`` ({(k, variant): key}, all
    captured) through :func:`bucket_replay_equals_eager`, k real sessions
    on slots 0..k-1 and seeded frames.  Without graphs nothing is compared
    (prewarm stepped each once).
    -> {key: capture seconds (None without graphs)}."""
    steps = bucket.graph_cache.steps()
    out = {}
    for (k, v), key in keys.items():
        if bucket.graphs:
            bucket_replay_equals_eager(bucket, models, cfg, params, states, _frames(cfg, k),
                                       list(range(k)), k, v, key)
        out[key] = steps[key].capture_s
        _note("bucket", key, out[key])
    return out


def _require_captured(what: str, status: dict, graphs: bool):
    if graphs and not all(status.values()):
        raise RuntimeError(f"{what}: buckets not captured: "
                           f"{sorted(kv for kv, done in status.items() if not done)}")


def build(
    model_id: str,
    lora_dict: dict | None = None,
    controlnet: str | None = None,
    device=None,
):
    """Build the kernels (on the card), load and cast the bundle, capture
    the engine's step (the DeepCache pair under UNET_CACHE) and hold each
    replay to its eager step.  -> (keys, bundle): keys is {engine key:
    capture seconds (None on the CPU)} in build order, the keys serving
    looks for; the bundle serves the other build functions."""
    from ..stream.engine import StreamEngine

    device = resolve_device(device)
    if device.type == "cuda":
        build_kernels()
    bundle, cfg = load_bundle(model_id, lora_dict, controlnet, device)
    engine = StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                          device=device, model_id=model_id)
    engine.prepare(PROBE_PROMPT)
    return engine_replay_equals_eager(engine), bundle


def build_multipeer(
    model_id: str,
    peers: int,
    lora_dict: dict | None = None,
    controlnet: str | None = None,
    bundle=None,
    device=None,
) -> dict:
    """Capture every bucket of the ``--multipeer N`` serving engine (the
    step of every slot keyed ``peers-N``, the buckets below it ``sbucket``;
    with UNET_CACHE the capture + cached pair of each) through its own
    ``prewarm_buckets``, so the keys cannot drift from serving's, and hold
    each replay to its eager step.  ``bundle``: an already loaded and cast
    bundle (``main`` reuses :func:`build`'s).  -> {key: capture seconds}."""
    from ..parallel.multipeer import MultiPeerEngine

    if bundle is None:
        bundle, cfg = load_bundle(model_id, lora_dict, controlnet, resolve_device(device))
    else:
        cfg = stream_config(model_id, controlnet, bundle.device)
    mp = MultiPeerEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                         max_peers=peers, device=bundle.device,
                         model_id=model_id).start(PROBE_PROMPT)
    mp.prewarm_buckets()
    _require_captured(f"multipeer peers={peers}", mp.graph_status(), mp._bucket.graphs)
    out = buckets_replay_equal_eager(mp._bucket, bundle.stream_models, cfg, mp.params,
                                     mp.states, mp.bucket_keys())
    logger.info("multipeer engine(s) ready for %s peers=%d", model_id, peers)
    return out


def build_scheduler_buckets(
    model_id: str,
    sessions: int,
    lora_dict: dict | None = None,
    controlnet: str | None = None,
    bundle=None,
    device=None,
) -> dict:
    """Capture the continuous batch scheduler's bucket geometries for
    ``sessions`` slots (one graph per power-of-two occupancy and variant,
    keyed ``sbucket-k, sessions-S``) through its own ``prewarm_buckets``
    and hold each replay to its eager step.  dp=1, as the JAX CLI pins:
    a BATCHSCHED_DP leaking into the CLI must not flip the keys to a
    sharded plane.  -> {key: capture seconds}."""
    from ..stream.scheduler import BatchScheduler

    if bundle is None:
        bundle, cfg = load_bundle(model_id, lora_dict, controlnet, resolve_device(device))
    else:
        cfg = stream_config(model_id, controlnet, bundle.device)
    sched = BatchScheduler(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                           model_id=model_id, max_sessions=sessions, prewarm=False,
                           device=bundle.device, dp=1)
    try:
        sched.prewarm_buckets()
        _require_captured(f"scheduler sessions={sessions}", sched.graph_status(),
                          sched._bucket.graphs)
        out = buckets_replay_equal_eager(sched._bucket, bundle.stream_models, cfg,
                                         sched.params, sched.states, sched.bucket_keys())
    finally:
        sched.close()
    logger.info("scheduler bucket engine(s) ready for %s sessions=%d", model_id, sessions)
    return out


def parse_args(argv=None):
    """-> (args, lora_dict): the JAX CLI's flags (``--lora path:scale``,
    repeatable; a spec without ``:`` fuses at scale 1.0) and ``--device``;
    ``--cache-dir`` is refused here, at parse time."""
    ap = argparse.ArgumentParser(description="Build the kernels and capture and check every "
                                             "graph a deployment serves, ahead of serving.")
    ap.add_argument("--model-id", default="stabilityai/sd-turbo")
    ap.add_argument(
        "--lora",
        action="append",
        default=[],
        help="path.safetensors:scale (repeatable)",
    )
    ap.add_argument("--cache-dir", default=None,
                    help="refused: the JAX engine store has no counterpart here")
    ap.add_argument(
        "--controlnet", default=None,
        help="ControlNet model id: captures the conditioned engine variant",
    )
    ap.add_argument(
        "--peers", type=int, default=0,
        help="also capture the --multipeer N serving engine's buckets (peers-N keys; "
             "with UNET_CACHE set, the capture+cached pair)",
    )
    ap.add_argument(
        "--sched-buckets", type=int, default=0, metavar="S",
        help="also capture the continuous batch scheduler's bucket geometries for S "
             "session slots (one graph per power-of-two occupancy)",
    )
    ap.add_argument("--device", default=None, help="cuda (default) or cpu (nothing captured)")
    args = ap.parse_args(argv)
    if args.cache_dir is not None:
        ap.error(f"--cache-dir {args.cache_dir}: the port has no engine store (a CUDA graph "
                 "holds one process's device addresses and cannot be written out); serving "
                 "captures its graphs at startup, and this preflight captures and checks them "
                 "on this card without storing anything")
    lora_dict = {}
    for spec in args.lora:
        path, _, scale = spec.rpartition(":")
        lora_dict[path or spec] = float(scale) if path else 1.0
    return args, lora_dict


def main(argv=None) -> dict:
    """The CLI.  -> {key: capture seconds (None on the CPU)} of every step
    captured and checked, in build order."""
    logging.basicConfig(level=logging.INFO)
    args, lora_dict = parse_args(argv)
    keys, bundle = build(args.model_id, lora_dict or None, args.controlnet, device=args.device)
    if args.peers:
        keys.update(build_multipeer(args.model_id, args.peers, controlnet=args.controlnet,
                                    bundle=bundle))
    if args.sched_buckets:
        keys.update(build_scheduler_buckets(args.model_id, args.sched_buckets,
                                            controlnet=args.controlnet, bundle=bundle))
    return keys


if __name__ == "__main__":
    main()
