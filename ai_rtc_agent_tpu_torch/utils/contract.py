"""Contract-line plumbing shared by the port's measurement CLIs — the
port's copy of ai_rtc_agent_tpu/utils/contract.py.

Every measurement script must print exactly one JSON line on EVERY exit
path.  The finally-block pattern handles exceptions; this helper covers the
remaining hole: a SIGTERM from timeout(1) would otherwise kill the process
without running the finally block, losing the error detail of the attempt.
"""

from __future__ import annotations

import signal


def sigterm_to_exception(source: str = "driver timeout") -> None:
    """Install a SIGTERM handler that raises TimeoutError.

    The exception unwinds into the caller's ``except/finally`` so the
    contract line is still emitted.  The known limit: if the main thread is
    blocked inside a C call (a wedged device synchronise), the Python-level
    handler cannot run until that call returns; the caller's watchdog
    escalates to SIGKILL after a grace period for exactly that case.
    """

    def _raise(signum, frame):
        raise TimeoutError(f"SIGTERM ({source})")

    signal.signal(signal.SIGTERM, _raise)
