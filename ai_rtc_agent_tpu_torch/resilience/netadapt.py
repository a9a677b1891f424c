"""Network-adaptive quality ladder: RTCP-driven degradation, joined to the
compute overload plane (the port's copy of
ai_rtc_agent_tpu/resilience/netadapt.py).

resilience/overload.py makes *compute* overload a bounded, recoverable
state (admission, deadline queues, the skip→passthrough→freeze ladder).
This module is the *network* half: real viewers sit behind lossy Wi-Fi and congested uplinks,
and without adaptation a 10% loss burst produces PLI storms and stale
frames instead of a controlled quality reduction.  The signals already
exist — RFC 3550 loss fraction, cumulative loss and interarrival jitter
from the peer's Receiver Reports (media/rtcp.py), plus our own TX-side
feedback (NACK/PLI rates) — this module turns them into a per-session
**network rung**:

    normal → reduce_bitrate → reduce_resolution → raise_frame_skip
           → keyframe_throttle

with the same hysteresis discipline the compute ladder uses
(``NETADAPT_UP_TICKS`` consecutive lossy ticks escalate one rung,
``NETADAPT_DOWN_TICKS`` clean ticks de-escalate), ticked on the overload
control plane's cadence.  The ladder's principle inverts the compute
ladder's: **degrade quality before you degrade freshness**.  Network
pressure shrinks bitrate and resolution first; only the upper rungs
impose a frame-skip *floor* on the session's :class:`OverloadLadder`
(``set_net_floor`` — the effective rung is the max of compute and network
pressure), and the floor is clamped below passthrough so a bad network
can never freeze the engine output on its own.

Actuation flows through existing single-purpose surfaces:

* encoder bitrate/GOP via :meth:`H264Sink.reconfigure` →
  :meth:`H264Encoder.reconfigure` (the ONE blessed mutation path);
* resolution via the sink's decimation ``scale`` (the encoder restarts
  at the smaller geometry through its existing geometry-change path);
* keyframe cadence via :class:`KeyframeGovernor`: PLIs coalesce into at
  most one IDR per ``NETADAPT_PLI_COALESCE_MS`` window (a storm costs one
  IDR), and under sustained loss IDRs are *scheduled* from loss telemetry
  instead of granted per-PLI — the cadence receivers need to re-sync,
  chosen by us, not by the storm.

Everything is injectable (clock, ctor thresholds) and clockless-tickable,
so the whole ladder unit-tests without wall-clock sleeps, and the chaos
tier scripts sustained loss deterministically via the ``loss_burst``
fault profile (resilience/faults.py).
"""

from __future__ import annotations

import logging
import time

from .overload import Ewma

logger = logging.getLogger(__name__)

NET_RUNG_LABELS = (
    "normal",
    "reduce_bitrate",
    "reduce_resolution",
    "raise_frame_skip",
    "keyframe_throttle",
)
NET_RUNG_REDUCE_BITRATE = NET_RUNG_LABELS.index("reduce_bitrate")
NET_RUNG_REDUCE_RESOLUTION = NET_RUNG_LABELS.index("reduce_resolution")
NET_RUNG_RAISE_FRAME_SKIP = NET_RUNG_LABELS.index("raise_frame_skip")
NET_RUNG_KEYFRAME_THROTTLE = NET_RUNG_LABELS.index("keyframe_throttle")

# compute-ladder skip floor each network rung imposes (indexes into
# overload.RUNG_LABELS: 0=normal, 1=skip2, 2=skip4).  Deliberately capped
# below passthrough: the network ladder degrades QUALITY; freshness and
# engine bypass stay the compute ladder's call.
NET_SKIP_FLOOR = (0, 0, 0, 1, 2)


class KeyframeGovernor:
    """IDR budget for one outbound stream.

    Two inputs share one ``_last_idr`` stamp, so they coalesce into a
    single IDR stream:

    * :meth:`request` — feedback-driven (a PLI, or a NACK whose packets
      aged out of the retransmission cache).  Grants at most one IDR per
      ``coalesce_s`` window; everything else inside the window is counted
      as coalesced — a PLI storm from N viewers (or one hosed network)
      costs ONE keyframe.
    * :meth:`periodic_due` — telemetry-driven cadence (polled per outbound
      frame).  Under sustained loss the network ladder sets
      ``interval_s`` so receivers get a re-sync point on OUR schedule
      instead of asking per-frame; 0 disables.
    """

    def __init__(self, coalesce_s: float = 0.7, clock=time.monotonic):
        self.coalesce_s = coalesce_s
        self.interval_s = 0.0
        self._clock = clock
        self._last_idr: float | None = None
        self.granted = 0
        self.coalesced = 0

    def request(self) -> bool:
        """Feedback path: True exactly when the caller should force an IDR
        now; False when the request coalesces into the current window."""
        now = self._clock()
        if (
            self._last_idr is not None
            and now - self._last_idr < self.coalesce_s
        ):
            self.coalesced += 1
            return False
        self._last_idr = now
        self.granted += 1
        return True

    def periodic_due(self) -> bool:
        """Cadence path: True when the loss-driven IDR interval elapsed
        (shares the window stamp with :meth:`request`, so feedback and
        cadence never double-spend)."""
        if not self.interval_s:
            return False
        now = self._clock()
        if self._last_idr is not None and now - self._last_idr < self.interval_s:
            return False
        self._last_idr = now
        self.granted += 1
        return True


class NetworkAdaptLadder:
    """Per-session network rung with hysteresis.

    Feed it Receiver Report blocks about OUR outbound stream
    (:meth:`on_receiver_report`) and local TX feedback counts
    (:meth:`on_tx_feedback`); tick it on the overload control plane's
    cadence (:meth:`tick`).  Rung moves call ``on_rung(old, new)`` (the
    control plane's metrics/event-log hook), push the skip floor into the
    joined compute ladder, and hand the new actuation profile to
    ``apply(profile)`` (the peer connection's encoder/governor hook).
    """

    def __init__(
        self,
        session_id: str,
        *,
        up_after: int = 2,
        down_after: int = 12,
        loss_up: float = 0.08,
        loss_down: float = 0.02,
        base_bitrate: int = 3_000_000,
        min_bitrate: int = 250_000,
        bitrate_factor: float = 0.6,
        pli_coalesce_s: float = 0.7,
        rr_timeout_s: float = 6.0,
        feedback_burst: int = 8,
        compute_ladder=None,
        clock=time.monotonic,
        on_rung=None,
        apply=None,
    ):
        self.session_id = session_id
        self.up_after = max(1, up_after)
        self.down_after = max(1, down_after)
        self.loss_up = loss_up
        self.loss_down = loss_down
        self.base_bitrate = max(1, int(base_bitrate))
        self.min_bitrate = max(1, int(min_bitrate))
        self.bitrate_factor = min(0.95, max(0.05, bitrate_factor))
        self.pli_coalesce_s = pli_coalesce_s
        self.rr_timeout_s = rr_timeout_s
        self.feedback_burst = max(1, feedback_burst)
        self.compute_ladder = compute_ladder
        self._clock = clock
        self.on_rung = on_rung
        self.apply = apply
        self.rung = 0
        self._hot = 0
        self._cool = 0
        # slightly slower than the admission EWMAs (0.4): RRs arrive on the
        # report interval, not per frame, so each sample carries more weight
        self.loss_ewma = Ewma(alpha=0.3)
        self.jitter_ewma = Ewma(alpha=0.3)
        self._last_report_t: float | None = None
        # TX feedback accumulated since the last tick (NACKs weighted per
        # missing seq, PLIs per packet) — evidence of downlink loss from
        # peers that never send RRs
        self._fb_window = 0
        self.rr_reports = 0
        self._closed = False

    # -- signal feeds (RTCP inbound path / TX path, any thread) --------------

    def on_receiver_report(self, block: dict) -> None:
        """One RFC 3550 report block about OUR stream (caller selects the
        block whose ssrc matches — rtc_native._RtcpState does)."""
        if self._closed:
            return
        self.rr_reports += 1
        self._last_report_t = self._clock()
        # fraction_lost is an 8-bit fixed-point fraction (lost/expected*256)
        self.loss_ewma.update((block.get("fraction_lost", 0) & 0xFF) / 256.0)
        self.jitter_ewma.update(float(block.get("jitter", 0)))

    def on_tx_feedback(self, nacks: int = 0, plis: int = 0) -> None:
        if self._closed:
            return
        self._fb_window += int(nacks) + int(plis)

    # -- cadence (overload control plane tick task) --------------------------

    def _pressured(self) -> bool:
        return (
            self.loss_ewma.value >= self.loss_up
            or self._fb_window >= self.feedback_burst
        )

    def _clean(self) -> bool:
        return self.loss_ewma.value <= self.loss_down and self._fb_window == 0

    def tick(self) -> None:
        if self._closed:
            return
        # evidence decay: a peer that stopped reporting (left, or its RRs
        # are themselves being lost) must not pin quality down forever —
        # mirror the admission controller's stale-step-signal decay
        t = self._last_report_t
        if self.loss_ewma.value > 0.0 and (
            t is None or self._clock() - t > self.rr_timeout_s
        ):
            self.loss_ewma.value *= 0.8
        if self._pressured():
            self._hot += 1
            self._cool = 0
            if self._hot >= self.up_after and self.rung < NET_RUNG_KEYFRAME_THROTTLE:
                self._move(self.rung + 1)
                self._hot = 0
        elif self._clean():
            self._cool += 1
            self._hot = 0
            if self._cool >= self.down_after and self.rung > 0:
                self._move(self.rung - 1)
                self._cool = 0
        else:
            # hysteresis band (loss between the thresholds): hold the rung
            # and both streaks — de-escalation requires CONSECUTIVE clean
            # ticks, and elevated-but-under-threshold loss is not clean
            self._hot = 0
            self._cool = 0
        self._fb_window = 0

    def _move(self, new: int) -> None:
        old, self.rung = self.rung, new
        logger.warning(
            "session %s: network ladder %s -> %s (loss ewma %.3f)",
            self.session_id,
            NET_RUNG_LABELS[old],
            NET_RUNG_LABELS[new],
            self.loss_ewma.value,
        )
        if self.compute_ladder is not None:
            self.compute_ladder.set_net_floor(NET_SKIP_FLOOR[new])
        if self.on_rung is not None:
            try:
                self.on_rung(old, new)
            except Exception:
                logger.exception("netadapt on_rung handler failed")
        self._apply()

    def _apply(self) -> None:
        if self.apply is None:
            return
        try:
            self.apply(self.profile())
        except Exception:
            logger.exception(
                "session %s: netadapt actuation failed", self.session_id
            )

    # -- actuation profile ----------------------------------------------------

    def profile(self) -> dict:
        """The rung's actuation profile, applied through the blessed
        surfaces (H264Sink.reconfigure + KeyframeGovernor knobs)."""
        r = self.rung
        # floor at min_bitrate — unless the base itself (e.g. an operator
        # cap applied at runtime) already sits below it: degradation must
        # never raise the rate above what the operator asked for
        bitrate = max(
            min(self.min_bitrate, self.base_bitrate),
            int(self.base_bitrate * (self.bitrate_factor ** r)),
        )
        return {
            "rung": NET_RUNG_LABELS[r],
            "bitrate": bitrate,
            # encode-side decimation divisor; the encoder restarts at the
            # reduced geometry through its existing geometry-change path
            "scale": 2 if r >= NET_RUNG_REDUCE_RESOLUTION else 1,
            "skip_floor": NET_SKIP_FLOOR[r],
            # under loss, re-sync points come on OUR schedule (twice the
            # coalescing window; relaxed again at the throttle rung) —
            # not one per PLI
            "keyframe_interval_s": (
                0.0 if r == 0 else self.pli_coalesce_s * (4.0 if r >= 4 else 2.0)
            ),
            # the feedback window itself widens at the top rung: a storm
            # that persists buys even fewer IDRs
            "pli_coalesce_s": self.pli_coalesce_s
            * (4.0 if r >= NET_RUNG_KEYFRAME_THROTTLE else 1.0),
        }

    def snapshot(self) -> dict:
        return {
            "rung": self.rung,
            "label": NET_RUNG_LABELS[self.rung],
            "loss_ewma": round(self.loss_ewma.value, 4),
            "jitter_ewma": round(self.jitter_ewma.value, 1),
            "rr_reports": self.rr_reports,
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.compute_ladder is not None:
            self.compute_ladder.set_net_floor(0)
        self.rung = 0
