"""The serving agent's HTTP layer over the port's pipeline (counterpart of
ai_rtc_agent_tpu/server/agent.py).

  POST/DELETE /whip[/{session}]   publish a stream (OBS, browser)
  POST/DELETE /whep[/{session}]   view the processed stream (on the native tier
                                  a viewer of the publisher's broadcast group)
  POST /broadcast/pull            {"owner_url": ...}: pull one copy of another
                                  agent's stream for viewers placed here
  POST /offer                     bidirectional browser session
  POST /config                    runtime prompt / t_index / guidance update
  GET  /                          liveness ("OK")
  GET  /health                    supervisor rollup, ladders, engine guard
  GET  /capacity                  sessions still admitted, Retry-After hint
  POST /drain                     {"action": "freeze" | "unfreeze"}
  GET  /metrics[?format=prom]     fps / latency / overload / scheduler / guard /
                                  flight / SLO / device telemetry gauges (JSON, or
                                  the Prometheus text exposition)
  GET/POST /debug/trace           the frame-trace window (+ the torch.profiler bridge)
  GET  /debug/flight              the flight recorder: index, ?session=, ?id=,
                                  ?journey=; &format=json|chrome|jsonl
  GET  /migrate/export?session=   one live session's snapshot (live migration)
  POST /migrate/import            {"token", "snapshot"}: restore and park it
  POST /admin/recycle             {"respawn": bool}: restart in place (handoff file)
  GET  /demo                      the bundled browser client for /offer

Each route maps a request onto a flow of ``server/sessions.py`` and its
answer onto the JAX agent's status codes: 201 with ``Location`` for WHIP
and WHEP, 400 for a wrong content type, undecodable body or bad JSON, 401
for WHEP without a publisher, 200/404 for a DELETE of a known/unknown
session, 503 with ``Retry-After`` when every session slot is claimed, the
admission gate refuses (pressure, a freeze, a drain), the engine guard
holds the plane quarantined or a WHEP viewer is past
``BROADCAST_MAX_VIEWERS``.  The router's journey headers are echoed in
the answers of /offer, /whip and /whep; a re-offer carrying
``X-Migrated-Session`` adopts a migrated session.  CORS allows all origins.

    python -m ai_rtc_agent_tpu_torch.server.agent --model-id stabilityai/sd-turbo
    WEBRTC_PROVIDER=native-rtp python -m ai_rtc_agent_tpu_torch.server.agent \\
        --model-id tiny-test --device cpu --udp-ports 40000,40001
    WEBRTC_PROVIDER=loopback python -m ai_rtc_agent_tpu_torch.server.agent \\
        --model-id tiny-test --device cpu
    ... --multipeer 2        # two peer slots stepped as one batch
    ... --mode txt2img       # generate from the prompt, ignore the pixels

The WebRTC provider is ``WEBRTC_PROVIDER`` (aiortc | native-rtp |
loopback); unset, aiortc, else the native tier (server/rtc_native.py: real
SDP, RTP/RTCP over UDP, ICE-lite + DTLS-SRTP) when its C++ runtime builds
and ``cryptography`` imports, else loopback.

Each /offer and /whip connection claims a session of the batch scheduler
(BATCHSCHED_MAX_SESSIONS slots, the default) or, with ``--multipeer N``, a
peer slot; ``BATCHSCHED=0`` serves every connection through one pipeline.

The pipeline runs on the card unless ``--device cpu`` is passed; without a
card, startup raises.  ``--profile-port`` parses as the JAX agent's does,
but only 0: the JAX flag starts jax.profiler's trace server, which torch
does not have; the port's profiler is the torch.profiler bridge of
``POST /debug/trace``.  This module and fleet/router.py are the port's
only modules that import aiohttp at module level.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import random
import types
from typing import List, Tuple

from aiohttp import web

from . import sessions

logger = logging.getLogger(__name__)


def patch_loop_datagram(local_ports: List[int]):
    """Bind every unbound UDP endpoint of the running loop to one of
    ``local_ports`` (an operator's firewall or serverless platform opens
    only those); an explicit port and ``local_addr=None`` pass through."""
    loop = asyncio.get_event_loop()
    if getattr(loop, "_patch_done", False):
        return

    old_create = loop.create_datagram_endpoint

    async def create_datagram_endpoint(
        self, protocol_factory, local_addr: Tuple[str, int] = None, **kwargs
    ):
        if local_addr and local_addr[1]:
            return await old_create(protocol_factory, local_addr=local_addr, **kwargs)
        if local_addr is None:
            return await old_create(protocol_factory, local_addr=None, **kwargs)
        ports = [int(p) for p in local_ports]
        random.shuffle(ports)
        last_exc = None
        for port in ports:
            try:
                ret = await old_create(protocol_factory, local_addr=(local_addr[0], port), **kwargs)
                logger.debug("create_datagram_endpoint chose port %s", port)
                return ret
            except OSError as exc:
                last_exc = exc
        if last_exc is not None:
            raise last_exc
        raise ValueError("local_ports must not be empty")

    loop.create_datagram_endpoint = types.MethodType(create_datagram_endpoint, loop)
    loop._patch_done = True


#: (method, path) of every route; ``sessions.route`` answers them all
ROUTES = (
    ("POST", "/whip"), ("DELETE", "/whip"), ("DELETE", "/whip/{session}"),
    ("POST", "/whep"), ("DELETE", "/whep"), ("DELETE", "/whep/{session}"),
    ("POST", "/broadcast/pull"), ("POST", "/offer"), ("POST", "/config"), ("GET", "/"),
    ("GET", "/health"), ("GET", "/capacity"), ("POST", "/drain"), ("GET", "/migrate/export"),
    ("POST", "/migrate/import"), ("POST", "/admin/recycle"), ("GET", "/metrics"),
    ("GET", "/debug/flight"), ("GET", "/debug/trace"), ("POST", "/debug/trace"),
    ("GET", "/demo"),
)


def _response(reply: sessions.Reply) -> web.Response:
    kwargs = {} if reply.body is None else {"text": reply.body}
    return web.Response(
        status=reply.status, content_type=reply.content_type, headers=reply.headers, **kwargs
    )


async def serve(request):
    """Every route: the request's method (HEAD as GET), path, query, headers
    and body to the session layer's route table (``sessions.route``)."""
    method = "GET" if request.method == "HEAD" else request.method
    return _response(await sessions.route(request.app, method, request.path, request.query,
                                          request.headers, await request.read()))


@web.middleware
async def cors_middleware(request, handler):
    """Allow-all CORS."""
    if request.method == "OPTIONS":
        resp = web.Response(status=200)
    else:
        resp = await handler(request)
    resp.headers.setdefault("Access-Control-Allow-Origin", "*")
    resp.headers.setdefault("Access-Control-Allow-Headers", "*")
    resp.headers.setdefault("Access-Control-Allow-Methods", "GET,POST,DELETE,OPTIONS")
    return resp


async def on_startup(app):
    if app["udp_ports"]:
        patch_loop_datagram(app["udp_ports"])
    await sessions.startup(app)


async def on_shutdown(app):
    await sessions.shutdown(app)


def build_app(
    model_id: str = "stabilityai/sd-turbo",
    pipeline=None,
    provider=None,
    fbs: int = 0,
    device=None,
    udp_ports=None,
    multipeer: int = 0,
    multipeer_pipeline=None,
    batch_scheduler=None,
    mode: str = "img2img",
    unet_cache: int = 0,
) -> web.Application:
    """``pipeline``, ``multipeer_pipeline``, ``batch_scheduler``: injectable
    for tests; built at startup when None, on ``device`` (the card unless
    ``"cpu"``), as ``sessions.startup`` says."""
    app = web.Application(middlewares=[cors_middleware])
    sessions.configure(app, model_id=model_id, pipeline=pipeline, provider=provider,
                       fbs=fbs, device=device, multipeer=multipeer,
                       multipeer_pipeline=multipeer_pipeline, batch_scheduler=batch_scheduler,
                       mode=mode, unet_cache=unet_cache)
    app["udp_ports"] = udp_ports
    app.on_startup.append(on_startup)
    app.on_shutdown.append(on_shutdown)
    for method, path in ROUTES:
        if method == "GET":
            app.router.add_get(path, serve)  # and HEAD, as aiohttp's add_get does
        else:
            app.router.add_route(method, path, serve)
    return app


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run the agent on the port's pipeline")
    parser.add_argument("--model-id", default="stabilityai/sd-turbo",
                        help="model id (sd15 / sd-turbo families, tiny-test), or a local HF "
                             "snapshot dir (unet/, text_encoder/, vae/, tokenizer/)")
    parser.add_argument("--port", default=8888, type=int, help="HTTP signaling port")
    parser.add_argument("--udp-ports", default=None, help="comma-separated UDP media ports")
    parser.add_argument("--fbs", default=0, type=int, metavar="N",
                        help="frame_buffer_size: N consecutive frames per step; 0 = per frame")
    parser.add_argument("--multipeer", default=0, type=int, metavar="N",
                        help="serve N peers, each with its own stream state, batched in one "
                             "step (503 past N)")
    parser.add_argument("--mode", default="img2img", choices=["img2img", "txt2img"],
                        help="txt2img ignores incoming pixels and generates from the prompt "
                             "each tick (reference txt2img dispatch, lib/wrapper.py:236-260)")
    parser.add_argument("--unet-cache", default=0, type=int, metavar="N",
                        help="DeepCache interval: full UNet every Nth frame, outermost-tier-only "
                             "between (the JAX package counts the cached step at ~0.54x the "
                             "FLOPs at 512^2; equivalent env UNET_CACHE=N); 0 = off")
    parser.add_argument("--log-level", default="INFO",
                        choices=["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"])
    parser.add_argument("--device", default=None,
                        help="torch device of the pipeline (default: the card; 'cpu' only when asked)")
    parser.add_argument("--profile-port", default=0, type=int,
                        help="0 only: the JAX agent's jax.profiler trace server has no torch "
                             "counterpart; trace through POST /debug/trace instead")
    args = parser.parse_args(argv)
    if args.profile_port:
        parser.error(f"--profile-port {args.profile_port}: the port has no profiler trace "
                     "server (the JAX agent's is jax.profiler's); its profiler is the "
                     "torch.profiler bridge of POST /debug/trace "
                     '({"action": "start", "jax_profiler_dir": DIR})')
    logging.basicConfig(level=args.log_level.upper())
    app = build_app(
        model_id=args.model_id,
        fbs=args.fbs,
        device=args.device,
        multipeer=args.multipeer,
        mode=args.mode,
        unet_cache=args.unet_cache,
        udp_ports=args.udp_ports.split(",") if args.udp_ports else None,
    )
    web.run_app(app, host="0.0.0.0", port=args.port)


if __name__ == "__main__":
    main()
