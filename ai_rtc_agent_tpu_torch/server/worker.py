"""The worker sidecar (counterpart of ai_rtc_agent_tpu/server/worker.py):
it waits for the agent's health endpoint (60 s), publishes the agent's
connection info and remaining capacity (``/capacity``, with its process
nonce ``boot_id``) to ``WORKER_PUBLISH_URL`` (the fleet router's
``/fleet/register``), and holds the lease (``AGENT_TIMEOUT``), republishing
whenever the advertised capacity changes (``WORKER_REPUBLISH_S``).
Transient publish failures retry under the shared backoff; an HTTP 4xx is
terminal after one attempt.  Standard library HTTP only.

    python -m ai_rtc_agent_tpu_torch.server.worker --agent-port 8888

Env: WORKER_ID, PUBLIC_IP, PUBLIC_PORT, WORKER_PUBLISH_URL, AUTH_TOKEN,
AGENT_TIMEOUT, WORKER_REPUBLISH_S.
"""

from __future__ import annotations

import argparse
import http.client
import json
import logging
import os
import time
import urllib.error
import urllib.request

from ..resilience.retry import poll_policy, transient_policy
from ..utils import env

logger = logging.getLogger(__name__)

HEALTH_BUDGET_S = 60  # the agent gets 60 s to come up
POLL_INTERVAL_S = 1.0
PUBLISH_ATTEMPTS = 3


def check_server(url: str, budget_s: float = HEALTH_BUDGET_S) -> bool:
    """Poll the agent's health endpoint until OK or the budget is spent
    (the shared retry helper owns the schedule, resilience/retry.py)."""

    def probe():
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                if r.status != 200:
                    raise OSError(f"health returned {r.status}")
        except urllib.error.HTTPError as e:
            # a poll is the one place 4xx IS retryable: routes mount
            # after the socket opens, so early probes can 404 briefly
            raise OSError(f"health returned {e.code}") from e
        return True

    ok = poll_policy(budget_s, POLL_INTERVAL_S).run(
        probe,
        retry_on=(urllib.error.URLError, OSError),
        default=False,
        label="agent health",
    )
    if ok:
        logger.info("agent is up at %s", url)
    else:
        logger.error("agent did not come up within %.0fs", budget_s)
    return ok


class _PermanentPublishError(Exception):
    """Publish rejected with HTTP 4xx: re-POSTing the identical request
    cannot succeed, so it must not consume retry attempts."""


def default_publish(info: dict) -> bool:
    """POST connection info to WORKER_PUBLISH_URL (Bearer AUTH_TOKEN).
    Retries transient failures under the shared backoff policy; a
    permanent 4xx fails after exactly one attempt (urlopen raises
    HTTPError, a URLError, before the status check: without the explicit
    catch the retry would re-POST a 404 until the budget burned).
    Returns success."""
    url = env.get_str("WORKER_PUBLISH_URL")
    if not url:
        logger.info("no WORKER_PUBLISH_URL; connection info: %s", info)
        return True
    req = urllib.request.Request(
        url,
        data=json.dumps(info).encode(),
        headers={
            "Content-Type": "application/json",
            **(
                {"Authorization": f"Bearer {env.get_str('AUTH_TOKEN')}"}
                if env.get_str("AUTH_TOKEN")
                else {}
            ),
        },
    )

    def post():
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                if not 200 <= r.status < 300:
                    raise OSError(f"publish returned {r.status}")
                logger.info("published worker info (%d)", r.status)
        except urllib.error.HTTPError as e:
            if 400 <= e.code < 500:
                raise _PermanentPublishError(f"publish returned {e.code}") from e
            raise  # 5xx stays retryable (HTTPError is a URLError)
        return True

    try:
        ok = transient_policy(attempts=PUBLISH_ATTEMPTS).run(
            post,
            retry_on=(urllib.error.URLError, OSError),
            default=False,
            label="worker publish",
        )
    except _PermanentPublishError as e:
        logger.error("worker publish rejected (terminal): %s", e)
        return False
    if not ok:
        logger.warning("worker publish failed after %d attempts", PUBLISH_ATTEMPTS)
    return ok


def fetch_capacity(url: str) -> dict | None:
    """GET the agent's /capacity snapshot (remaining sessions + saturation
    — resilience/overload.py) so the orchestrator can weight placement by
    real headroom instead of a boolean "ready".  Best-effort: an agent
    without the endpoint (or a non-JSON answer) just means no capacity
    fields in the publish."""
    try:
        with urllib.request.urlopen(url, timeout=2) as r:
            body = json.loads(r.read().decode())
        return body if isinstance(body, dict) else None
    except (
        urllib.error.URLError,
        http.client.HTTPException,  # truncated/garbled response from a
        OSError,                    # box that is drowning — exactly when
        ValueError,                 # this endpoint gets queried
    ):
        return None


def handler(
    agent_port: int,
    publish=default_publish,
    sleep=time.sleep,
    clock=time.monotonic,
) -> int:
    """One worker job: await the agent, publish identity and capacity,
    hold the lease, republishing whenever the advertised (capacity,
    saturated, boot_id) changes on the ``WORKER_REPUBLISH_S`` cadence (a
    failed republish never abandons the lease; the next change tries
    again).  ``WORKER_REPUBLISH_S<=0`` holds the lease in one sleep.

    Returns 0 on success, 1 if the agent never became healthy, 2 if the
    connection info could not be published (a worker nobody can reach is
    useless — exit promptly so the orchestrator recycles it instead of
    burning the whole lease invisible)."""
    if not check_server(f"http://127.0.0.1:{agent_port}/", HEALTH_BUDGET_S):
        return 1
    cap_url = f"http://127.0.0.1:{agent_port}/capacity"
    info = {
        "worker_id": env.get_str("WORKER_ID", os.uname().nodename),
        "public_ip": env.get_str("PUBLIC_IP", ""),
        "public_port": env.get_str("PUBLIC_PORT", str(agent_port)),
        "status": "ready",
    }
    cap = fetch_capacity(cap_url)
    if cap is not None and "capacity" in cap:
        # remaining capacity, not a boolean: -1 = no structural bound
        info["capacity"] = cap.get("capacity")
        info["saturated"] = bool(cap.get("saturated", False))
    if cap is not None and cap.get("boot_id"):
        # the agent's process nonce: the registry bumps the epoch when it
        # changes (restart-in-place recycle behind the same address)
        info["boot_id"] = str(cap["boot_id"])
    ok = publish(info)
    if ok is False:  # None (no return value) counts as success
        return 2
    keep_alive = env.get_int("AGENT_TIMEOUT", 600)
    republish_s = env.get_float("WORKER_REPUBLISH_S", 5.0)
    logger.info("holding worker lease for %ds", keep_alive)
    if republish_s <= 0:
        sleep(keep_alive)
        return 0
    t_end = clock() + keep_alive
    last = (
        info.get("capacity"), info.get("saturated"), info.get("boot_id")
    )
    while True:
        remaining = t_end - clock()
        if remaining <= 0:
            break
        sleep(min(republish_s, remaining))
        if clock() >= t_end:
            break
        cap = fetch_capacity(cap_url)
        if cap is None or "capacity" not in cap:
            continue  # agent drowning or endpoint-less: keep the lease
        # boot_id joins the change detector: a recycled agent behind the
        # same port must republish so the registry can bump its epoch
        cur = (
            cap.get("capacity"), bool(cap.get("saturated", False)),
            str(cap["boot_id"]) if cap.get("boot_id") else info.get("boot_id"),
        )
        if cur == last:
            continue
        update = dict(info)
        update["capacity"], update["saturated"] = cur[0], cur[1]
        if cur[2]:
            update["boot_id"] = cur[2]
        if publish(update) is not False:
            last = cur  # a failed republish retries on the next change
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="serverless agent sidecar")
    ap.add_argument("--agent-port", type=int, default=8888)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return handler(args.agent_port)


if __name__ == "__main__":
    raise SystemExit(main())
