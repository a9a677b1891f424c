"""The fleet router over HTTP (counterpart of ai_rtc_agent_tpu/fleet/router.py):
an aiohttp application serving the routes of the framework-free core
(fleet/routing.py) with the JAX router's paths, statuses and bodies.  The
only module of ``fleet/`` that imports aiohttp at module level.

    python -m ai_rtc_agent_tpu_torch.fleet.router --port 8800
"""

from __future__ import annotations

import argparse
import logging

from aiohttp import web

from . import routing
from .registry import FleetRegistry
from .routing import Reply, Request
from .transport import Headers


def _response(reply: Reply) -> web.Response:
    if isinstance(reply.body, str):
        return web.Response(status=reply.status, text=reply.body,
                            content_type=reply.content_type, headers=reply.headers)
    return web.Response(status=reply.status, body=reply.body, headers=reply.headers)


def _handler(fn):
    async def handler(request: web.Request) -> web.Response:
        req = Request(request.method, dict(request.query), Headers(request.headers),
                      await request.read(), dict(request.match_info))
        return _response(await fn(request.app, req))

    return handler


def build_router_app(
    *,
    registry: FleetRegistry | None = None,
    events_handler=None,
    poll: bool = True,
    transport=None,
) -> web.Application:
    """The router application (``transport``: None opens an aiohttp one at
    startup)."""
    app = web.Application()
    routing.configure(app, registry=registry, events_handler=events_handler, poll=poll,
                      transport=transport)
    app.on_startup.append(routing.startup)
    app.on_cleanup.append(routing.cleanup)
    for method, path, fn in routing.ROUTES:
        if method == "GET":
            app.router.add_get(path, _handler(fn))  # and HEAD, as aiohttp's add_get does
        else:
            app.router.add_route(method, path, _handler(fn))
    return app


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run the fleet router")
    parser.add_argument("--port", default=8800, type=int, help="HTTP front-door port")
    parser.add_argument("--log-level", default="INFO",
                        choices=["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"])
    args = parser.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper())
    web.run_app(build_router_app(), host="0.0.0.0", port=args.port)


if __name__ == "__main__":
    main()
