"""ICE/TURN servers for /offer (counterpart of ai_rtc_agent_tpu/server/turn.py).

Twilio ephemeral TURN credentials through one POST to the REST API, or an
``ICE_SERVERS`` JSON list.  Returns plain dicts shaped like RTCIceServer
keyword arguments, which aiortc and the loopback provider both take.
"""

from __future__ import annotations

import base64
import json
import logging
import time

from ..resilience.retry import RetryError, transient_policy
from ..utils import env

logger = logging.getLogger(__name__)

TWILIO_TOKEN_URL = "https://api.twilio.com/2010-04-01/Accounts/{sid}/Tokens.json"


class _TransientHttp(Exception):
    """5xx / transport trouble — worth another try under backoff."""


def transient_retry(fn, retry_on: tuple, sleep=time.sleep, rng=None):
    """Call ``fn()`` under the shared transient policy (three full-jitter
    backed-off attempts, ``resilience/retry.py``); raises
    :class:`RetryError` when they are spent."""
    return transient_policy().run(fn, retry_on=retry_on, sleep=sleep, rng=rng,
                                  label="twilio token")


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
