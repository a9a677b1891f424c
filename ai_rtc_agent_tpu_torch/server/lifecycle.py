"""Agent process lifecycle: restart-in-place and the spawn backends
(counterpart of ai_rtc_agent_tpu/server/lifecycle.py).

``POST /admin/recycle`` (server/sessions.py ``admin_recycle``) exports
every live session through the migration snapshot into a **handoff file**,
spawns the replacement and exits; the replacement imports the handoff at
startup, after its buckets are captured and before it reports healthy, and
announces each session with an ``AGENT_RECYCLED`` webhook that sends the
client back through the router to the same box.

Spawn backends (all blocking: callers run them off the event loop):

* **re-exec** (the default): the replacement runs this process's own
  command line (``python -m ai_rtc_agent_tpu_torch.server.agent ...``)
  with ``RECYCLE_HANDOFF`` pointing at the handoff file, inheriting stdio;
* **exec hook**: ``RECYCLE_EXEC_HOOK`` (or the autoscaler's
  ``AUTOSCALE_EXEC_HOOK``) runs an operator's shell command.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import time

from ..utils import env

logger = logging.getLogger(__name__)

HANDOFF_SCHEMA = 1


def handoff_path() -> str:
    """Where this process parks (or finds) its handoff: the
    ``RECYCLE_HANDOFF`` knob, else a pid-scoped file under the system
    temp dir (same box by construction — recycle never crosses hosts;
    cross-host moves are the migrate surface's job)."""
    p = env.get_str("RECYCLE_HANDOFF")
    if p:
        return p
    return os.path.join(
        tempfile.gettempdir(), f"rtc-recycle-{os.getpid()}.json"
    )


def write_handoff(path: str, sessions: list, meta: dict) -> None:
    """Single-writer JSON dump, atomic via rename so the replacement
    never reads a torn file."""
    data = {
        "schema": HANDOFF_SCHEMA,
        "written_at": time.time(),
        "sessions": sessions,
    }
    data.update(meta)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)


def read_handoff(path: str) -> dict | None:
    """Parse a handoff file; None on any defect (a replacement must
    boot clean rather than die on a torn/foreign file)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict) or data.get("schema") != HANDOFF_SCHEMA:
        return None
    return data


def consume_handoff(path: str) -> None:
    """Delete the handoff whatever the import outcome — a crash-looping
    replacement must not re-adopt a stale generation forever."""
    try:
        os.remove(path)
    except OSError:
        pass


def run_exec_hook(cmd: str | None, extra_env: dict | None = None) -> bool:
    """Fire an operator spawn command (detached; we never wait on it —
    the new process proves itself by registering + passing the prewarm
    probe, not by its exit code).  False when no hook is configured."""
    if not cmd:
        logger.warning("no exec hook configured — cannot spawn a process")
        return False
    hook_env = dict(os.environ)
    hook_env.update(extra_env or {})
    subprocess.Popen(cmd, shell=True, env=hook_env)
    return True


def reexec_argv() -> list:
    """This process's relaunch command.  Under ``python -m pkg.mod``,
    ``sys.argv[0]`` is the module's *file* path — re-running it as a
    script breaks the package's relative imports — so the ``-m`` form is
    reconstructed from ``__main__.__spec__`` (None for plain scripts)."""
    argv = [sys.executable] + sys.argv
    spec = getattr(sys.modules.get("__main__"), "__spec__", None)
    name = getattr(spec, "name", None)
    if name:
        if name.endswith(".__main__"):  # `-m pkg` runs pkg.__main__
            name = name[: -len(".__main__")]
        argv = [sys.executable, "-m", name] + sys.argv[1:]
    return argv


def respawn_reexec(handoff: str) -> int:
    """Re-exec this process's argv as the replacement (the subprocess
    backend): inherits stdio and cwd, carries ``RECYCLE_HANDOFF`` so the
    child adopts the parked sessions.  Returns the child pid."""
    child_env = dict(os.environ)
    child_env["RECYCLE_HANDOFF"] = handoff
    proc = subprocess.Popen(reexec_argv(), env=child_env, cwd=os.getcwd())
    logger.info("respawned replacement pid %d (argv re-exec)", proc.pid)
    return proc.pid


def spawn_replacement(handoff: str) -> bool:
    """The recycle spawn backend: ``RECYCLE_EXEC_HOOK`` when configured
    (real orchestrators), else argv re-exec (the subprocess/test tier)."""
    hook = env.get_str("RECYCLE_EXEC_HOOK")
    if hook:
        return run_exec_hook(hook, {"RECYCLE_HANDOFF": handoff})
    respawn_reexec(handoff)
    return True


def exit_process(code: int = 0):
    """Immediate exit for the recycled-away process: its sessions are
    already exported, and running the aiohttp shutdown path would tear
    them down loudly (StreamEnded volleys for sessions that are NOT
    ending) while delaying the port release the replacement may be
    retry-binding on."""
    os._exit(code)
