"""How the fleet tier reaches its agents: one request interface, two ways.

The router's core (fleet/routing.py) and the poller (fleet/registry.py)
call ``await transport.request(method, url, ...)`` and read a
:class:`Response`; connection trouble (refused, reset, timed out) raises
:class:`TransportError`, the one exception they catch.

* :class:`AiohttpTransport`: HTTP over one shared aiohttp client session
  (imported when the transport is built: the card's machine has no
  aiohttp).
* :class:`InProcessTransport`: agents that live in this process as
  app-state mappings (server/sessions.py), addressed by their base URL;
  each request goes through the session layer's route table, the one the
  port's HTTP layer (server/agent.py) serves.  ``chip_smoke.py`` drives
  the fleet on the card through it.
"""

from __future__ import annotations

import asyncio
import json as _json
from dataclasses import dataclass, field
from urllib.parse import parse_qsl, urlsplit


class TransportError(Exception):
    """The agent could not be reached (refused, reset, timed out)."""


class Headers(dict):
    """A case-insensitive header mapping (lookups ignore case)."""

    def __init__(self, items=()):
        super().__init__()
        for k, v in dict(items).items():
            self[k] = v

    def __setitem__(self, key, value):
        super().__setitem__(key.lower(), value)

    def __getitem__(self, key):
        return super().__getitem__(key.lower())

    def __contains__(self, key):
        return super().__contains__(key.lower())

    def get(self, key, default=None):
        return super().get(key.lower(), default)


@dataclass
class Response:
    status: int
    headers: Headers = field(default_factory=Headers)
    body: bytes = b""

    def json(self):
        """The body as JSON; ``ValueError`` when it is not."""
        return _json.loads(self.body.decode("utf-8"))

    def text(self) -> str:
        return self.body.decode("utf-8", "replace")


class AiohttpTransport:
    """HTTP through one aiohttp ``ClientSession`` (``timeout_s``: each
    request's total, unless the call gives its own)."""

    def __init__(self, timeout_s: float):
        import aiohttp

        self._aiohttp = aiohttp
        self._session = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=timeout_s))

    async def request(self, method: str, url: str, *, data=None, json=None, params=None,
                      headers=None, timeout=None) -> Response:
        aiohttp = self._aiohttp
        kw = {}
        if timeout is not None:
            kw["timeout"] = aiohttp.ClientTimeout(total=timeout)
        try:
            async with self._session.request(method, url, data=data, json=json, params=params,
                                             headers=headers, **kw) as resp:
                body = await resp.read()
                return Response(resp.status, Headers(resp.headers), body)
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
            raise TransportError(str(e) or type(e).__name__) from e

    async def close(self):
        await self._session.close()


def _reply_response(reply) -> Response:
    """A session-layer ``Reply`` as the wire would carry it: a text body
    is UTF-8, a Content-Type named by the reply joins its headers."""
    headers = Headers(reply.headers)
    if reply.content_type is not None and "Content-Type" not in headers:
        headers["Content-Type"] = reply.content_type
    body = reply.body
    if body is None:
        body = b""
    elif isinstance(body, str):
        body = body.encode("utf-8")
    return Response(reply.status, headers, body)


class InProcessTransport:
    """Agents in this process: ``agents`` maps a base URL
    (``"inproc://agent-a"``) to its app-state.  A URL whose agent is gone
    (:meth:`remove`) raises :class:`TransportError`, as a dead process's
    socket would."""

    def __init__(self, agents: dict | None = None):
        self.agents: dict = dict(agents or {})

    def add(self, base_url: str, app):
        self.agents[base_url.rstrip("/")] = app

    def remove(self, base_url: str):
        self.agents.pop(base_url.rstrip("/"), None)

    async def request(self, method: str, url: str, *, data=None, json=None, params=None,
                      headers=None, timeout=None) -> Response:
        parts = urlsplit(url)
        base = f"{parts.scheme}://{parts.netloc}"
        app = self.agents.get(base)
        if app is None:
            raise TransportError(f"no agent at {base}")
        query = dict(params or {})
        if parts.query:
            query.update(parse_qsl(parts.query))
        body = data
        if json is not None:
            body = _json.dumps(json).encode("utf-8")
        coro = _dispatch(app, method.upper(), parts.path, query, Headers(headers or {}),
                         body if body is not None else b"")
        try:
            return await (coro if timeout is None else asyncio.wait_for(coro, timeout))
        except asyncio.TimeoutError as e:
            raise TransportError(f"{method} {url} timed out") from e

    async def close(self):
        pass


async def _dispatch(app, method: str, path: str, query: dict, headers: Headers,
                    body: bytes) -> Response:
    """One request to an in-process agent: its session layer's route table,
    the one its HTTP layer serves (server/sessions.py ``route``)."""
    from ..server import sessions

    return _reply_response(await sessions.route(app, method, path, query, headers, body))
