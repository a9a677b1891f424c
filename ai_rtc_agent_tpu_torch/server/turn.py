"""ICE/TURN servers for /offer (counterpart of ai_rtc_agent_tpu/server/turn.py).

Twilio ephemeral TURN credentials through one POST to the REST API, or an
``ICE_SERVERS`` JSON list.  Returns plain dicts shaped like RTCIceServer
keyword arguments, which aiortc and the loopback provider both take.
"""

from __future__ import annotations

import base64
import json
import logging
import random
import time

from ..utils import env

logger = logging.getLogger(__name__)

TWILIO_TOKEN_URL = "https://api.twilio.com/2010-04-01/Accounts/{sid}/Tokens.json"


class _TransientHttp(Exception):
    """5xx / transport trouble — worth another try under backoff."""


class RetryError(Exception):
    """All attempts exhausted; ``last`` carries the final exception."""

    def __init__(self, message: str, last: BaseException):
        super().__init__(message)
        self.last = last


def transient_retry(fn, retry_on: tuple, attempts: int = 3, base_delay_s: float = 0.5,
                    max_delay_s: float = 30.0, sleep=time.sleep, rng=random):
    """Call ``fn()`` until it returns or ``attempts`` calls have raised one of
    ``retry_on``; then raise :class:`RetryError`.  Full-jitter exponential
    backoff: the n-th delay is drawn from U[0, base * 2**n], capped, so a fleet
    retrying one shared service does not retry in step (the JAX package's
    ``transient_policy``)."""
    delay = base_delay_s
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if i + 1 == attempts:
                raise RetryError(f"failed after {attempts} attempt(s)", e) from e
        sleep(delay * rng.random())
        delay = min(max_delay_s, 2.0 * delay)


def get_twilio_token(http_post=None):
    """POST /Tokens.json with basic auth; returns the parsed token dict or None.

    ``http_post(url, headers) -> (status, json_dict)`` is injectable for
    tests; the default uses ``requests``.  Exceptions and 5xx retry under
    :func:`transient_retry`; a 4xx fails at once.
    """
    sid = env.get_str("TWILIO_ACCOUNT_SID")
    auth = env.get_str("TWILIO_AUTH_TOKEN")
    if sid is None or auth is None:
        return None
    url = TWILIO_TOKEN_URL.format(sid=sid)
    basic = base64.b64encode(f"{sid}:{auth}".encode()).decode()
    headers = {"Authorization": f"Basic {basic}"}
    if http_post is None:

        def http_post(u, h):
            import requests

            r = requests.post(u, headers=h, timeout=10)
            return r.status_code, r.json()

    def fetch():
        try:
            status, body = http_post(url, headers)
        except Exception as e:
            raise _TransientHttp(str(e)) from e
        if status in (200, 201):
            return body
        if status >= 500:
            raise _TransientHttp(f"twilio returned {status}")
        logger.error("twilio token request returned %s", status)
        return None

    try:
        return transient_retry(fetch, retry_on=(_TransientHttp,))
    except RetryError as e:
        logger.error("twilio token request failed: %s", e.last)
        return None


def get_ice_servers(http_post=None) -> list[dict]:
    """TURN server list: ``ICE_SERVERS`` (a JSON list of RTCIceServer-shaped
    dicts) when set, else Twilio's ``turn:`` servers, else none."""
    raw = env.get_str("ICE_SERVERS")
    if raw:
        try:
            servers = json.loads(raw)
            if isinstance(servers, list):
                return servers
            logger.error("ICE_SERVERS must be a JSON list, got %s", type(servers))
        except ValueError as e:
            logger.error("ICE_SERVERS is not valid JSON: %s", e)
        return []
    token = get_twilio_token(http_post)
    if token is None:
        return []
    servers = []
    for server in token.get("ice_servers", []):
        url = server.get("url", "")
        if url.startswith("turn:"):
            servers.append({
                "urls": [server.get("urls", url)],
                "username": server.get("username"),
                "credential": server.get("credential"),
            })
    return servers


def get_link_headers(ice_servers: list[dict]) -> list[str]:
    """WHIP ``Link`` headers for the ICE servers."""
    links = []
    for srv in ice_servers:
        url = srv["urls"][0]
        links.append(
            f'<{url}>; rel="ice-server"; username="{srv["username"]}"; '
            f'credential="{srv["credential"]}";'
        )
    return links
