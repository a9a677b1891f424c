"""Fire-and-forget tasks and sync-or-async event handlers (counterpart of
ai_rtc_agent_tpu/utils/dispatch.py).

:func:`spawn` keeps a strong reference to the task until it is done (the
loop holds tasks weakly) and logs its exception from the done-callback.
:func:`fire_handler` calls a handler from synchronous teardown code and
schedules the coroutine when the handler is ``async``.
"""

from __future__ import annotations

import asyncio
import logging

logger = logging.getLogger(__name__)

#: strong refs to in-flight background tasks; the done-callback discards
_BACKGROUND: set = set()


def _reap(task) -> None:
    _BACKGROUND.discard(task)
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        logger.error("background task %s failed: %r", task.get_name(), exc, exc_info=exc)


def spawn(coro) -> "asyncio.Task":
    """Schedule ``coro`` fire-and-forget, keeping a reference until it is
    done and logging its failure.  Raises ``RuntimeError`` when no loop runs."""
    task = asyncio.ensure_future(coro)
    _BACKGROUND.add(task)
    task.add_done_callback(_reap)
    return task


def fire_handler(handler) -> None:
    """Call ``handler()``; if it returns a coroutine, schedule it on the
    running loop (or close it when no loop runs)."""
    if handler is None:
        return
    r = handler()
    if asyncio.iscoroutine(r):
        try:
            spawn(r)
        except RuntimeError:
            r.close()
