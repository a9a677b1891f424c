"""RTCP: sender/receiver reports and NACK loss recovery for the native tier
(the port's copy of ai_rtc_agent_tpu/media/rtcp.py).

Periodic sender reports for lip-sync and stats, receiver-report parsing
and NACK-driven retransmission; PLI lives in media/rtp.py:

  * make_sr / make_rr — RFC 3550 report packets (SR carries the NTP/RTP
    timestamp pair receivers use for lip-sync and clock mapping), with a
    minimal SDES CNAME so the compound is spec-shaped
  * make_nack — RFC 4585 generic NACK (transport-layer FB, FMT=1) with
    PID/BLP encoding of the lost sequence numbers
  * parse_compound — one walk over a compound RTCP datagram yielding
    every SR/RR/NACK/PLI with its fields, for both the server's inbound
    path and the tests' client side
  * RetransmissionCache — ring of recently-sent WIRE packets keyed by RTP
    seq.  Cached post-protection, so an SRTP retransmission is the
    original ciphertext (the receiver never saw the seq — its replay
    window accepts it; re-protecting would need ROC care for nothing)
"""

from __future__ import annotations

import struct
import time
from collections import OrderedDict

from ..utils import env

PT_SR = 200
PT_RR = 201
PT_SDES = 202
PT_RTPFB = 205  # transport-layer feedback (NACK is FMT 1)
PT_PSFB = 206  # payload-specific feedback (PLI is FMT 1)

NTP_EPOCH_OFFSET = 2208988800  # 1900 -> 1970


def report_interval_s() -> float:
    """SR/RR emission cadence for the native tier's report loop
    (rtc_native._sr_loop).  RFC 3550 suggests ~5 s for low-rate sessions;
    interactive video wants faster loss feedback — and the network
    adaptation ladder (resilience/netadapt.py) can react no faster than
    reports arrive, so the cadence is an operator knob
    (``RTCP_REPORT_INTERVAL_S``).  Floored at 200 ms so a typo cannot turn
    the report loop into a packet storm."""
    return max(0.2, env.get_float("RTCP_REPORT_INTERVAL_S", 2.0))


def is_rtcp(data: bytes) -> bool:
    """RFC 5761 s4 demux: version 2 + payload type in the full RTCP block
    (192-223: legacy FIR/NACK 192/193, SR..XR 200-207).  RTP can't land
    there — media PTs are 96-127, or 224-255 with the marker bit.  THE
    shared predicate: endpoint.classify, rtc_native and the test client
    all route on this one definition."""
    return len(data) >= 2 and (data[0] >> 6) == 2 and 192 <= data[1] <= 223


def _ntp_now(now: float | None = None) -> tuple:
    t = time.time() if now is None else now
    sec = int(t) + NTP_EPOCH_OFFSET
    frac = int((t - int(t)) * (1 << 32)) & 0xFFFFFFFF
    return sec & 0xFFFFFFFF, frac


def _sdes_cname(ssrc: int, cname: bytes = b"tpu-rtc-agent") -> bytes:
    item = struct.pack("!IBB", ssrc & 0xFFFFFFFF, 1, len(cname)) + cname
    item += b"\x00"  # item-list END
    while len(item) % 4:
        item += b"\x00"  # pad chunk to a 32-bit boundary
    words = len(item) // 4
    return struct.pack("!BBH", 0x81, PT_SDES, words) + item


def _report_block_bytes(blk: dict) -> bytes:
    return struct.pack(
        "!IIIIII",
        blk["ssrc"] & 0xFFFFFFFF,
        ((blk.get("fraction_lost", 0) & 0xFF) << 24)
        | (blk.get("cumulative_lost", 0) & 0xFFFFFF),
        blk.get("highest_seq", 0) & 0xFFFFFFFF,
        blk.get("jitter", 0) & 0xFFFFFFFF,
        0,  # LSR
        0,  # DLSR
    )


def make_sr(
    ssrc: int,
    rtp_ts: int,
    packet_count: int,
    octet_count: int,
    now: float | None = None,
    compound_sdes: bool = True,
    report_blocks: list | None = None,
) -> bytes:
    """Sender report: the NTP↔RTP timestamp pair + send counters, plus
    optional reception report blocks about inbound streams (RFC 3550
    s6.4.1 — how a bidirectional endpoint reports both directions in one
    packet)."""
    sec, frac = _ntp_now(now)
    blocks = report_blocks or []
    payload = (
        struct.pack("!I", ssrc & 0xFFFFFFFF)
        + struct.pack(
            "!IIIII",
            sec,
            frac,
            rtp_ts & 0xFFFFFFFF,
            packet_count & 0xFFFFFFFF,
            octet_count & 0xFFFFFFFF,
        )
        + b"".join(_report_block_bytes(b) for b in blocks)
    )
    sr = (
        struct.pack(
            "!BBH", 0x80 | len(blocks), PT_SR, len(payload) // 4
        )
        + payload
    )
    return sr + _sdes_cname(ssrc) if compound_sdes else sr


def make_rr(ssrc: int, media_ssrc: int, fraction_lost: int = 0,
            cumulative_lost: int = 0, highest_seq: int = 0,
            jitter: int = 0, compound_sdes: bool = True) -> bytes:
    """Receiver report with one report block (the shape browsers send),
    compounded with an SDES CNAME (RFC 3550 s6.1 requires every RTCP
    compound to carry one)."""
    block = _report_block_bytes(
        {
            "ssrc": media_ssrc,
            "fraction_lost": fraction_lost,
            "cumulative_lost": cumulative_lost,
            "highest_seq": highest_seq,
            "jitter": jitter,
        }
    )
    rr = struct.pack("!BBHI", 0x81, PT_RR, 7, ssrc & 0xFFFFFFFF) + block
    return rr + _sdes_cname(ssrc) if compound_sdes else rr


def make_nack(sender_ssrc: int, media_ssrc: int, seqs: list) -> bytes:
    """Generic NACK (RFC 4585 s6.2.1): PID + bitmask of 16 following."""
    seqs = sorted(set(s & 0xFFFF for s in seqs))
    fci = b""
    i = 0
    while i < len(seqs):
        pid = seqs[i]
        blp = 0
        j = i + 1
        while j < len(seqs) and 0 < ((seqs[j] - pid) & 0xFFFF) <= 16:
            blp |= 1 << (((seqs[j] - pid) & 0xFFFF) - 1)
            j += 1
        fci += struct.pack("!HH", pid, blp)
        i = j
    length = 2 + len(fci) // 4
    return (
        struct.pack("!BBH", 0x81, PT_RTPFB, length)
        + struct.pack("!II", sender_ssrc & 0xFFFFFFFF, media_ssrc & 0xFFFFFFFF)
        + fci
    )


def _parse_report_blocks(body: bytes, off: int, count: int) -> list:
    blocks = []
    for _ in range(count):
        if off + 24 > len(body):
            break
        bssrc, lost, hseq, jit, _lsr, _dlsr = struct.unpack_from(
            "!IIIIII", body, off
        )
        blocks.append(
            {
                "ssrc": bssrc,
                "fraction_lost": lost >> 24,
                "cumulative_lost": lost & 0xFFFFFF,
                "highest_seq": hseq,
                "jitter": jit,
            }
        )
        off += 24
    return blocks


def parse_compound(data: bytes) -> list:
    """Walk a compound RTCP datagram -> [dict] (unknown chunks skipped).

    Yields: {"type": "sr", ssrc, ntp_sec, ntp_frac, rtp_ts, packet_count,
    octet_count} / {"type": "rr", ssrc, blocks: [{ssrc, fraction_lost,
    cumulative_lost, highest_seq, jitter}]} / {"type": "nack", media_ssrc,
    seqs: [...]} / {"type": "pli", media_ssrc} — media_ssrc is which
    outbound stream the feedback is about (0 when the packet was too short
    to carry one; the PLI convention our own recovery path sends)."""
    out = []
    off = 0
    while off + 8 <= len(data):
        b0, pt = data[off], data[off + 1]
        # walk the full RTCP PT block; an UNKNOWN type inside it (XR 207,
        # legacy 192/193) is skipped, not a walk terminator — feedback
        # packets can trail it in the same compound
        if (b0 >> 6) != 2 or not (192 <= pt <= 223):
            break
        (length_words,) = struct.unpack_from("!H", data, off + 2)
        end = off + (length_words + 1) * 4
        if end > len(data):
            break
        body = data[off + 4 : end]
        fmt_or_rc = b0 & 0x1F
        if pt == PT_SR and len(body) >= 24:
            ssrc, sec, frac, rtp_ts, pc, oc = struct.unpack_from("!IIIIII", body, 0)
            out.append(
                {
                    "type": "sr",
                    "ssrc": ssrc,
                    "ntp_sec": sec,
                    "ntp_frac": frac,
                    "rtp_ts": rtp_ts,
                    "packet_count": pc,
                    "octet_count": oc,
                    "blocks": _parse_report_blocks(body, 24, fmt_or_rc),
                }
            )
        elif pt == PT_RR and len(body) >= 4:
            (ssrc,) = struct.unpack_from("!I", body, 0)
            out.append(
                {
                    "type": "rr",
                    "ssrc": ssrc,
                    "blocks": _parse_report_blocks(body, 4, fmt_or_rc),
                }
            )
        elif pt == PT_RTPFB and fmt_or_rc == 1 and len(body) >= 8:
            media_ssrc = struct.unpack_from("!I", body, 4)[0]
            seqs = []
            boff = 8
            while boff + 4 <= len(body):
                pid, blp = struct.unpack_from("!HH", body, boff)
                seqs.append(pid)
                for bit in range(16):
                    if blp & (1 << bit):
                        seqs.append((pid + bit + 1) & 0xFFFF)
                boff += 4
            out.append(
                {"type": "nack", "media_ssrc": media_ssrc, "seqs": seqs}
            )
        elif pt == PT_PSFB and fmt_or_rc == 1:
            media_ssrc = (
                struct.unpack_from("!I", body, 4)[0] if len(body) >= 8 else 0
            )
            out.append({"type": "pli", "media_ssrc": media_ssrc})
        off = end
    return out


class ReceiverStats:
    """Inbound-stream reception statistics (RFC 3550 appendix A.3/A.8):
    extended highest sequence (16-bit cycles), cumulative + interval loss,
    and interarrival jitter in RTP timestamp units — everything a report
    block needs.  Feed every received RTP packet via `received()`.

    Duplicate discipline: only FIRST-TIME packets count toward
    ``_received`` — a sliding bitmap over the last :data:`DUP_WINDOW` seqs
    below the extended highest marks what already arrived, so duplicated
    and replayed packets can no longer under-report loss (A.3 compares
    expected against *unique* receptions).  Late packets older than the
    window are treated as duplicates too (indistinguishable, and at >128
    packets late they are useless to a real-time stream anyway).

    SSRC re-lock: the stats lock onto the first stream seen,
    but if the locked stream goes silent while another SSRC keeps talking
    (:data:`RELOCK_AFTER` consecutive foreign packets with none from the
    locked stream) the stats re-lock onto the live stream — one stray
    probe datagram must not wedge reporting (and PLI targeting) onto a
    ghost for the whole session.
    """

    DUP_WINDOW = 128
    RELOCK_AFTER = 32

    def __init__(self, clock_rate: int = 90000):
        self.clock_rate = clock_rate
        self.ssrc = 0
        self._base_seq = None
        self._max_seq = 0
        self._cycles = 0
        self._received = 0
        self._jitter = 0.0
        self._last_transit = None
        # interval state for fraction_lost (reset at each report)
        self._expected_prior = 0
        self._received_prior = 0
        # bit i set = seq (ext_highest - i) already received
        self._seen_window = 0
        # consecutive foreign-SSRC packets since the locked stream last spoke
        self._foreign_run = 0
        self._foreign_ssrc = 0

    def _lock(self, ssrc: int, seq: int) -> None:
        self.ssrc = ssrc
        self._base_seq = seq
        self._max_seq = seq
        self._cycles = 0
        self._received = 0
        self._jitter = 0.0
        self._last_transit = None
        self._expected_prior = 0
        self._received_prior = 0
        self._seen_window = 1
        self._foreign_run = 0

    def received(self, pkt: bytes, arrival: float | None = None) -> None:
        if len(pkt) < 12:
            return
        seq = (pkt[2] << 8) | pkt[3]
        rtp_ts = int.from_bytes(pkt[4:8], "big")
        ssrc = int.from_bytes(pkt[8:12], "big")
        if self._base_seq is None:
            # lock onto the FIRST stream: an unauthenticated socket can see
            # stray RTP from other senders, and interleaving two seq spaces
            # would report the real publisher's stream as collapsing
            self._lock(ssrc, seq)
            self._received = 1
        elif ssrc != self.ssrc:
            # foreign stream: ignored, unless the locked stream has gone
            # silent while this one keeps talking — then re-lock (the lock
            # was probably won by a stray/probe datagram)
            if ssrc == self._foreign_ssrc:
                self._foreign_run += 1
            else:
                self._foreign_ssrc = ssrc
                self._foreign_run = 1
            if self._foreign_run >= self.RELOCK_AFTER:
                self._lock(ssrc, seq)
                self._received = 1
            return
        else:
            self._foreign_run = 0
            delta = (seq - self._max_seq) & 0xFFFF
            if delta == 0:
                return  # duplicate of the current highest
            if delta < 0x8000:  # in-order / ahead
                if seq < self._max_seq:
                    self._cycles += 1  # wrapped
                self._max_seq = seq
                self._seen_window = (
                    (self._seen_window << delta) | 1
                ) & ((1 << self.DUP_WINDOW) - 1)
            else:  # late / reordered / replayed
                back = (self._max_seq - seq) & 0xFFFF
                if back >= self.DUP_WINDOW or (self._seen_window >> back) & 1:
                    return  # duplicate (or too old to tell)
                self._seen_window |= 1 << back
            self._received += 1
        # interarrival jitter (A.8): difference of relative transit times,
        # in 32-bit MODULAR arithmetic — float subtraction would turn the
        # sender's rtp_ts wrap (~13h at 90kHz) into a ~3000s jitter spike
        t = time.monotonic() if arrival is None else arrival
        arrival_rtp = int(t * self.clock_rate) & 0xFFFFFFFF
        transit = (arrival_rtp - rtp_ts) & 0xFFFFFFFF
        if self._last_transit is not None:
            d = (transit - self._last_transit) & 0xFFFFFFFF
            if d >= 1 << 31:
                d = (1 << 32) - d
            self._jitter += (d - self._jitter) / 16.0
        self._last_transit = transit

    @property
    def ext_highest_seq(self) -> int:
        return ((self._cycles << 16) | self._max_seq) & 0xFFFFFFFF

    def report_block(self) -> dict | None:
        """-> report-block dict for make_sr/make_rr, or None before any
        packet arrived.  Resets the fraction-lost interval."""
        if self._base_seq is None:
            return None
        expected = self.ext_highest_seq - self._base_seq + 1
        lost = max(0, expected - self._received)
        exp_int = expected - self._expected_prior
        rec_int = self._received - self._received_prior
        self._expected_prior = expected
        self._received_prior = self._received
        fraction = 0
        if exp_int > 0 and exp_int > rec_int:
            fraction = min(255, ((exp_int - rec_int) << 8) // exp_int)
        return {
            "ssrc": self.ssrc,
            "fraction_lost": fraction,
            "cumulative_lost": min(lost, 0xFFFFFF),
            "highest_seq": self.ext_highest_seq,
            "jitter": int(self._jitter),
        }


class RetransmissionCache:
    """Ring of the last ``size`` sent packets, keyed by RTP seq.  Stores
    WIRE bytes (post-SRTP) so a NACK answer is a pure resend."""

    def __init__(self, size: int = 512):
        self.size = size
        self._d: OrderedDict = OrderedDict()

    def add(self, plain_rtp: bytes, wire: bytes) -> None:
        if len(plain_rtp) < 4:
            return
        seq = (plain_rtp[2] << 8) | plain_rtp[3]
        self._d[seq] = wire
        self._d.move_to_end(seq)
        while len(self._d) > self.size:
            self._d.popitem(last=False)

    def get(self, seq: int):
        return self._d.get(seq & 0xFFFF)

    def __len__(self):
        return len(self._d)
