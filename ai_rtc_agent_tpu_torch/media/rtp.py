"""RTP packetization: native RFC 6184 wrappers + the batched host plane (the
port's copy of ai_rtc_agent_tpu/media/rtp.py).

Three packetizers share one wire format (byte-identical output, pinned by
tests/test_torch_media.py against the JAX package):

* :class:`RtpPacketizer` — ctypes wrapper over native/rtp.cpp.  Emits
  memoryviews into a rotating buffer pool.
* :class:`PyRtpPacketizer` — pure-python *per-packet* reference: one
  ``struct.pack`` per fragment.  The no-native fallback.
* :class:`BatchedRtpPacketizer` — the vectorized frame-granular path:
  fragments a whole access unit into a preallocated pool slot with a
  header template + numpy fills (no per-packet ``struct.pack``, no
  per-packet allocation) and emits a list of memoryviews.

:class:`RtpHeaderRewriter` is the broadcast plane's per-viewer pass over
one packetized frame: SSRC, seq and ts patched in a pooled copy.

Pool contract (all three): a frame's packet views stay valid until the
pool wraps — i.e. for the next ``pool_slots - 1`` ``packetize`` calls.
Consumers that hold packets longer (retransmission caches, queues) copy;
the send path consumes each frame before the next is packetized.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import native
from ..utils import env

MAX_AU = 1 << 22  # 4 MiB access-unit bound

RTP_HEADER = 12
FU_A = 28
STAP_A = 24


def _pool_slots_default() -> int:
    return max(2, env.get_int("HOST_PLANE_POOL_SLOTS", 4))


class _BufferPool:
    """Rotating pool of lazily-grown bytearrays (one acquire per frame).

    acquire() returns (bytearray, numpy view, memoryview) — the views are
    built once per growth, not per frame."""

    def __init__(self, slots: int, initial: int = 1 << 16):
        self._slots = [self._make(initial) for _ in range(max(2, slots))]
        self._i = 0

    @staticmethod
    def _make(size: int):
        ba = bytearray(size)
        return (ba, np.frombuffer(ba, np.uint8), memoryview(ba))

    def acquire(self, need: int):
        self._i = (self._i + 1) % len(self._slots)
        slot = self._slots[self._i]
        if len(slot[0]) < need:
            slot = self._slots[self._i] = self._make(max(need, 2 * len(slot[0])))
        return slot


def split_nals(au) -> list[tuple[int, int]]:
    """Annex-B -> [(payload_start, payload_end)] per NAL, matching the
    native scanner byte-for-byte (3- and 4-byte start codes; a payload
    trailing zero before a 3-byte code is absorbed into the start code
    exactly as native/rtp.cpp's next_start does)."""
    bounds = []
    n = len(au)
    i = au.find(b"\x00\x00\x01")
    while i != -1:
        start = i + 3
        j = au.find(b"\x00\x00\x01", start)
        if j == -1:
            end = n
        else:
            end = j - 1 if au[j - 1] == 0 else j
        if end > start:
            bounds.append((start, end))
        i = j
    return bounds


class RtpPacketizer:
    """Native packetizer; output views ride a rotating pool (see module
    docstring for the validity contract)."""

    def __init__(self, ssrc: int = 0x1234, payload_type: int = 96, mtu: int = 1200,
                 pool_slots: int | None = None):
        self._lib = native.load()
        if self._lib is None:
            raise RuntimeError("native media runtime unavailable")
        self._p = self._lib.tr_rtp_packetizer_create(ssrc, payload_type, mtu)
        self._mtu = mtu if mtu > 64 else 1200
        self._pool = _BufferPool(pool_slots or _pool_slots_default())

    def packetize(self, access_unit, timestamp: int) -> list:
        if not isinstance(access_unit, (bytes, bytearray)):
            access_unit = bytes(access_unit)
        data = np.frombuffer(access_unit, np.uint8)
        if data.size > MAX_AU:
            raise RuntimeError("packetize overflow")
        # EXACT native output size from the same NAL split the C side
        # performs: single NAL = 4-byte length prefix + 12-byte header +
        # payload; FU-A = 18 bytes of framing per fragment + payload-1.
        # An undersized heuristic here would make tr_rtp_packetize fail
        # AFTER consuming seqs (permanent mid-AU seq gap on the wire).
        chunk = max(1, self._mtu - RTP_HEADER - 2)
        need = 64
        for s, e in split_nals(access_unit):
            ln = e - s
            if ln <= self._mtu - RTP_HEADER:
                need += 16 + ln
            else:
                need += 18 * (-(-(ln - 1) // chunk)) + ln - 1
        buf, arr, mv = self._pool.acquire(need)
        n = self._lib.tr_rtp_packetize(
            self._p,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            data.size,
            timestamp & 0xFFFFFFFF,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(buf),
        )
        if n < 0:
            raise RuntimeError("packetize overflow")
        out, off = [], 0
        while off < n:
            ln = struct.unpack_from("!I", buf, off)[0]
            off += 4
            out.append(mv[off : off + ln])
            off += ln
        return out

    def close(self):
        if self._p:
            self._lib.tr_rtp_packetizer_destroy(self._p)
            self._p = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PyRtpPacketizer:
    """Per-packet pure-python packetizer (one struct.pack per fragment).

    Byte-identical to the native packetizer for single-NAL and FU-A;
    with ``stap_a=True`` consecutive small NALs (SPS+PPS) aggregate into
    RFC 6184 STAP-A packets — the aggregation rule is shared with
    :class:`BatchedRtpPacketizer` so the two stay wire-identical on all
    three paths."""

    def __init__(self, ssrc: int = 0x1234, payload_type: int = 96, mtu: int = 1200,
                 stap_a: bool = False):
        self.ssrc = ssrc
        self.payload_type = payload_type
        self.mtu = mtu if mtu > 64 else 1200
        self.stap_a = stap_a
        self.seq = 0

    def _hdr(self, marker: bool) -> bytes:
        h = struct.pack(
            "!BBHII",
            0x80,
            (0x80 if marker else 0) | self.payload_type,
            self.seq,
            self._ts,
            self.ssrc,
        )
        self.seq = (self.seq + 1) & 0xFFFF
        return h

    def packetize(self, access_unit, timestamp: int) -> list[bytes]:
        au = access_unit if isinstance(access_unit, (bytes, bytearray)) else bytes(
            access_unit
        )
        nals = split_nals(au)
        if not nals:
            return []
        self._ts = timestamp & 0xFFFFFFFF
        max_payload = self.mtu - RTP_HEADER
        groups = plan_aggregates(au, nals, max_payload) if self.stap_a else [
            [b] for b in nals
        ]
        out = []
        for gi, group in enumerate(groups):
            last_group = gi + 1 == len(groups)
            if len(group) > 1:  # STAP-A aggregate
                nal_bytes = bytearray([stap_header(au, group)])
                for s, e in group:
                    nal_bytes += struct.pack("!H", e - s) + au[s:e]
                out.append(self._hdr(last_group) + bytes(nal_bytes))
                continue
            s, e = group[0]
            ln = e - s
            if ln <= max_payload:
                out.append(self._hdr(last_group) + au[s:e])
                continue
            nal_hdr = au[s]
            fu_ind = (nal_hdr & 0xE0) | FU_A
            pos, rem, first = s + 1, ln - 1, True
            while rem > 0:
                chunk = min(rem, max_payload - 2)
                final = chunk == rem
                fu_hdr = (
                    (0x80 if first else 0)
                    | (0x40 if final else 0)
                    | (nal_hdr & 0x1F)
                )
                out.append(
                    self._hdr(last_group and final)
                    + bytes((fu_ind, fu_hdr))
                    + au[pos : pos + chunk]
                )
                pos += chunk
                rem -= chunk
                first = False
        return out

    def close(self):
        pass


def stap_header(au, group) -> int:
    """STAP-A NAL octet: F = OR of member F bits, NRI = max member NRI
    (RFC 6184 s5.7.1), type 24."""
    f, nri = 0, 0
    for s, _e in group:
        f |= au[s] & 0x80
        nri = max(nri, au[s] & 0x60)
    return f | nri | STAP_A


def plan_aggregates(au, nals, max_payload: int) -> list[list[tuple[int, int]]]:
    """Greedy left-to-right STAP-A grouping: consecutive NALs whose
    aggregate (1-byte STAP header + 2-byte size per NAL) fits the MTU
    payload; groups of one stay single-NAL/FU-A.  Shared by the python
    and batched packetizers so their wire output matches."""
    groups: list[list[tuple[int, int]]] = []
    cur: list[tuple[int, int]] = []
    cur_size = 1  # STAP-A NAL header octet
    for s, e in nals:
        ln = e - s
        if ln <= 0xFFFF and cur_size + 2 + ln <= max_payload:
            cur.append((s, e))
            cur_size += 2 + ln
            continue
        if cur:
            groups.append(cur)
        if ln + 1 + 2 <= max_payload and ln <= 0xFFFF:
            cur, cur_size = [(s, e)], 1 + 2 + ln
        else:
            groups.append([(s, e)])
            cur, cur_size = [], 1
    if cur:
        groups.append(cur)
    return groups


class BatchedRtpPacketizer:
    """Frame-granular vectorized packetizer: one pool-slot acquire per access unit, headers written with
    numpy fills from a 12-byte template, FU-A payload laid out with two
    bulk copies per NAL.  ``packetize`` emits memoryviews into the slot
    (validity: until the pool wraps — see module docstring)."""

    def __init__(self, ssrc: int = 0x1234, payload_type: int = 96, mtu: int = 1200,
                 stap_a: bool = False, pool_slots: int | None = None):
        self.ssrc = ssrc
        self.payload_type = payload_type
        self.mtu = mtu if mtu > 64 else 1200
        self.stap_a = stap_a
        self.seq = 0
        self._pool = _BufferPool(pool_slots or _pool_slots_default())
        # ts+ssrc header template (bytes 4..12); ssrc is fixed for life
        self._tpl = bytearray(8)
        struct.pack_into("!I", self._tpl, 4, ssrc & 0xFFFFFFFF)
        self._hdr14 = bytearray(14)  # per-NAL FU-A header template
        self._hdr14[0] = 0x80

    def packetize(self, access_unit, timestamp: int) -> list:
        au = access_unit if isinstance(access_unit, (bytes, bytearray)) else bytes(
            access_unit
        )
        nals = split_nals(au)
        if not nals:
            return []
        struct.pack_into("!I", self._tpl, 0, timestamp & 0xFFFFFFFF)
        mtu = self.mtu
        max_payload = mtu - RTP_HEADER
        chunk = max_payload - 2
        groups = plan_aggregates(au, nals, max_payload) if self.stap_a else None

        # layout pass: (is_fua, s, e, base_offset, n_fragments) per unit
        plans = []
        need = 0
        if groups is None:
            for s, e in nals:
                ln = e - s
                if ln <= max_payload:
                    plans.append((0, s, e, need, 1))
                    need += RTP_HEADER + ln
                else:
                    k = -(-(ln - 1) // chunk)
                    plans.append((1, s, e, need, k))
                    need += k * mtu  # fixed stride = 14 + chunk = mtu
        else:
            for group in groups:
                if len(group) > 1:
                    size = RTP_HEADER + 1 + sum(2 + e - s for s, e in group)
                    plans.append((2, group, None, need, 1))
                    need += size
                else:
                    s, e = group[0]
                    ln = e - s
                    if ln <= max_payload:
                        plans.append((0, s, e, need, 1))
                        need += RTP_HEADER + ln
                    else:
                        k = -(-(ln - 1) // chunk)
                        plans.append((1, s, e, need, k))
                        need += k * mtu

        buf, np_buf, mv = self._pool.acquire(need)
        np_au = np.frombuffer(au, np.uint8)
        tpl = self._tpl
        pt = self.payload_type
        seq = self.seq
        out = []
        last_i = len(plans) - 1
        for pi, (kind, s, e, base, k) in enumerate(plans):
            last_unit = pi == last_i
            if kind != 1:
                if kind == 0:
                    payload = au[s:e]
                else:  # STAP-A: assemble the aggregate payload
                    group = s
                    parts = [bytes((stap_header(au, group),))]
                    for gs, ge in group:
                        parts.append(struct.pack("!H", ge - gs))
                        parts.append(au[gs:ge])
                    payload = b"".join(parts)
                end = base + RTP_HEADER + len(payload)
                buf[base] = 0x80
                buf[base + 1] = (0x80 if last_unit else 0) | pt
                buf[base + 2] = (seq >> 8) & 0xFF
                buf[base + 3] = seq & 0xFF
                buf[base + 4 : base + 12] = tpl
                buf[base + 12 : end] = payload
                out.append(mv[base:end])
                seq = (seq + 1) & 0xFFFF
                continue
            # FU-A: k fragments at stride mtu.  Bulk payload placement is
            # two numpy copies; the 14-byte headers are one template
            # slice-assign per fragment (C memcpy — numpy's per-op
            # overhead swamps 14-byte writes on small-core hosts).
            nal_hdr = au[s]
            payload_len = e - s - 1
            tail = payload_len - (k - 1) * chunk
            blk = np_buf[base : base + k * mtu].reshape(k, mtu)
            if k > 1:
                blk[: k - 1, 14 : 14 + chunk] = np_au[
                    s + 1 : s + 1 + (k - 1) * chunk
                ].reshape(k - 1, chunk)
            blk[k - 1, 14 : 14 + tail] = np_au[s + 1 + (k - 1) * chunk : e]
            hdr14 = self._hdr14
            hdr14[1] = pt
            hdr14[4:12] = tpl
            hdr14[12] = (nal_hdr & 0xE0) | FU_A
            hdr14[13] = nal_hdr & 0x1F
            off = base
            last_frag = k - 1
            for i in range(k):
                buf[off : off + 14] = hdr14
                buf[off + 2] = (seq >> 8) & 0xFF
                buf[off + 3] = seq & 0xFF
                seq = (seq + 1) & 0xFFFF
                if i < last_frag:
                    out.append(mv[off : off + mtu])
                else:
                    out.append(mv[off : off + 14 + tail])
                off += mtu
            buf[base + 13] |= 0x80  # FU start bit
            last_off = base + last_frag * mtu
            buf[last_off + 13] |= 0x40  # FU end bit
            if last_unit:
                buf[last_off + 1] |= 0x80  # RTP marker on the AU's last packet
        self.seq = seq
        return out

    def close(self):
        pass


def _seq_lt(a: int, b: int) -> bool:
    """RFC 1889 sequence-number comparison with 16-bit wraparound."""
    return ((a - b) & 0xFFFF) > 0x8000


class RtpHeaderRewriter:
    """Per-viewer TX leg of the broadcast fan-out plane (server/broadcast.py).

    A :class:`BroadcastGroup` packetizes each access unit ONCE; every
    additional viewer then costs only this pass: one bulk copy of the
    frame's packets into a pooled slot plus a vectorized numpy patch of
    the three per-viewer header fields — SSRC (this viewer's stream
    identity), sequence number (this viewer's own continuous space, so
    per-viewer SRTP index estimation keeps its consecutive-seq fast
    path) and timestamp (per-viewer random offset, RFC 3550 s5.1).
    Everything else — marker bit, FU-A framing, STAP-A layout, payload
    bytes — is preserved by the copy, so the output is byte-identical
    to a dedicated per-viewer packetize except those fields
    (tests/test_torch_broadcast.py pins this for all three packet shapes,
    and the bytes against the JAX package's).

    ``payload_type=None`` keeps the source PT; a viewer whose offer
    negotiated a different H264 payload number sets its own and the
    pass patches byte 1 (marker bit preserved).

    Pool contract: same as the packetizers — a frame's rewritten views
    stay valid until this rewriter's pool wraps (``pool_slots - 1``
    further ``rewrite`` calls); holders copy.
    """

    def __init__(self, ssrc: int, payload_type: int | None = None,
                 seq0: int = 0, ts_offset: int = 0,
                 pool_slots: int | None = None):
        self.ssrc = ssrc & 0xFFFFFFFF
        self.payload_type = payload_type
        self.seq = seq0 & 0xFFFF
        self.ts_offset = ts_offset & 0xFFFFFFFF
        self._pool = _BufferPool(pool_slots or _pool_slots_default())
        self._ssrc_b = np.frombuffer(
            struct.pack("!I", self.ssrc), np.uint8
        ).copy()
        self.frames = 0  # rewrites served (monotonic, for group stats)

    def aligned(self, pkts) -> bool:
        """True when :meth:`rewrite` will take the identity fast path for
        these packets: the viewer patches nothing (same SSRC, source PT,
        zero ts offset) and its seq cursor matches the source's — so the
        source views ARE this viewer's wire packets.  Groups whose live
        and replay traffic share one packetizer (AU mode) keep every
        viewer aligned forever; a frame-mode viewer desyncs at its first
        GOP replay and copies from then on."""
        if self.payload_type is not None or self.ts_offset:
            return False
        b0 = pkts[0]
        return (self.seq == ((b0[2] << 8) | b0[3])
                and self.ssrc == struct.unpack_from("!I", b0, 8)[0])

    def plan(self, pkts) -> tuple:
        """Shared per-frame precomputation: the joined wire bytes and the
        packet-start offsets are identical for EVERY viewer rewriting this
        frame, so the group computes them once and passes the plan to each
        :meth:`rewrite` call instead of paying the gather per viewer."""
        n = len(pkts)
        offs = np.empty(n, np.intp)
        need = 0
        for i, p in enumerate(pkts):
            offs[i] = need
            need += len(p)
        return b"".join(pkts), offs, need

    def rewrite(self, pkts, plan=None) -> list:
        """One frame's (or one replayed AU's) packets -> this viewer's
        wire packets.  Accepts pooled memoryviews; emits pooled
        memoryviews from OUR pool (the source views are only read).

        Identity fast path: every WHEP viewer of a group shares the
        publisher's SSRC and payload type (rtc_native's fixed OUT_SSRC),
        so a viewer whose sequence space is still aligned with the source
        packetizer (joined live, never served a GOP replay) needs no
        rewrite at all — the source views are returned as-is and only the
        seq cursor advances.  A replay desyncs the cursor and the viewer
        drops to the copying path for good."""
        n = len(pkts)
        if n == 0:
            return []
        if self.aligned(pkts):
            self.seq = (self.seq + n) & 0xFFFF
            self.frames += 1
            return pkts if isinstance(pkts, list) else list(pkts)
        if plan is None:
            plan = self.plan(pkts)
        joined, offs, need = plan
        buf, np_buf, mv = self._pool.acquire(need)
        # ONE C-level gather instead of n slice assignments: at fan-out
        # packet counts the per-iteration buffer-protocol overhead of
        # per-packet copies dwarfs the actual byte moving
        buf[:need] = joined
        v = offs[:n]
        # sequence: this viewer's own continuous space, vectorized
        seqs = (self.seq + np.arange(n, dtype=np.int64)) & 0xFFFF
        np_buf[v + 2] = seqs >> 8
        np_buf[v + 3] = seqs & 0xFF
        self.seq = (self.seq + n) & 0xFFFF
        # timestamp: all packets of an AU share one, read once from the
        # source header and shifted by the viewer's stream offset
        ts = (struct.unpack_from("!I", pkts[0], 4)[0] + self.ts_offset) & 0xFFFFFFFF
        np_buf[v + 4] = (ts >> 24) & 0xFF
        np_buf[v + 5] = (ts >> 16) & 0xFF
        np_buf[v + 6] = (ts >> 8) & 0xFF
        np_buf[v + 7] = ts & 0xFF
        ssrc_b = self._ssrc_b
        np_buf[v + 8] = ssrc_b[0]
        np_buf[v + 9] = ssrc_b[1]
        np_buf[v + 10] = ssrc_b[2]
        np_buf[v + 11] = ssrc_b[3]
        if self.payload_type is not None:
            np_buf[v + 1] = (np_buf[v + 1] & 0x80) | self.payload_type
        self.frames += 1
        out = []
        off = 0
        for p in pkts:
            ln = len(p)
            out.append(mv[off:off + ln])
            off += ln
        return out

    def close(self):
        pass


class RtpReorderBuffer:
    """Minimal jitter/reorder stage ahead of the depacketizer.

    Real UDP reorders packets; FU-A reassembly (native/rtp.cpp) assumes
    in-order delivery.  This buffer releases packets in sequence order,
    drops late duplicates, and on a gap older than ``window`` buffered
    packets declares the missing packet lost and resumes from the earliest
    buffered one (real-time: never stall waiting for a retransmit that
    will not come).
    """

    def __init__(self, window: int = 32):
        self.window = window
        self._buf: dict[int, bytes] = {}
        self._next: int | None = None

    def push(self, packet: bytes) -> list[bytes]:
        if len(packet) < 4:
            return []
        seq = (packet[2] << 8) | packet[3]
        if self._next is None:
            self._next = seq
        if _seq_lt(seq, self._next):
            return []  # late duplicate / already-released
        if seq == self._next:
            # in-order fast path (the 99% case): release without storing,
            # so a pooled memoryview from the batched RX drain passes
            # through zero-copy
            out = [packet]
            self._next = (self._next + 1) & 0xFFFF
            while self._next in self._buf:
                out.append(self._buf.pop(self._next))
                self._next = (self._next + 1) & 0xFFFF
            return out
        # out-of-order: the packet is HELD across calls — stabilize pooled
        # views (the drain pool recycles; bytes stay valid forever)
        if not isinstance(packet, (bytes, bytearray)):
            packet = bytes(packet)
        self._buf[seq] = packet
        out = []
        if len(self._buf) > self.window:
            # declare the gap lost: resume from the earliest buffered seq
            self._next = min(self._buf, key=lambda s: (s - self._next) & 0xFFFF)
            while self._next in self._buf:
                out.append(self._buf.pop(self._next))
                self._next = (self._next + 1) & 0xFFFF
        return out


class RtpDepacketizer:
    def __init__(self):
        self._lib = native.load()
        if self._lib is None:
            raise RuntimeError("native media runtime unavailable")
        self._d = self._lib.tr_rtp_depacketizer_create()
        self._buf = np.empty(MAX_AU, np.uint8)

    def push(self, packet: bytes):
        """Feed one RTP packet; returns a completed (annex-B AU, timestamp)
        or None."""
        data = np.frombuffer(packet, np.uint8)
        ready = self._lib.tr_rtp_depacketize(
            self._d, data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), data.size
        )
        if not ready:
            return None
        ts = ctypes.c_uint32(0)
        n = self._lib.tr_rtp_get_au(
            self._d,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._buf.size,
            ctypes.byref(ts),
        )
        if n < 0:
            return None
        return self._buf[:n].tobytes(), ts.value

    def close(self):
        if self._d:
            self._lib.tr_rtp_depacketizer_destroy(self._d)
            self._d = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# RTCP PLI (Picture Loss Indication, RFC 4585 section 6.3.1)
# ---------------------------------------------------------------------------
# The keyframe-recovery control message: a receiver that dropped an
# undecodable AU asks the sender for an immediate IDR.  12 bytes:
# V=2|P=0|FMT=1, PT=206 (PSFB), length=2, sender SSRC, media SSRC.

PLI_PT = 206


def make_pli(sender_ssrc: int = 0, media_ssrc: int = 0) -> bytes:
    import struct

    return struct.pack("!BBH", 0x81, PLI_PT, 2) + struct.pack(
        "!II", sender_ssrc & 0xFFFFFFFF, media_ssrc & 0xFFFFFFFF
    )


def is_pli(data: bytes) -> bool:
    """True when an RTCP datagram CONTAINS a PSFB/PLI packet.

    Browsers send compound RTCP (RFC 3550 mandates the compound start with
    SR/RR), so a Chrome PLI typically arrives as RR+PSFB — walk the
    compound instead of testing only the first packet."""
    off = 0
    while off + 8 <= len(data):
        b0, pt = data[off], data[off + 1]
        # every chunk must look like RTCP: version 2 AND payload type in
        # the RTCP range.  RTP can never satisfy the PT gate (our PTs are
        # 96-127, or 224-255 with the marker bit), so the walk cannot
        # wander into compressed video payload bytes and false-positive.
        if (b0 >> 6) != 2 or not (200 <= pt <= 206):
            return False
        if pt == PLI_PT and (b0 & 0x1F) == 1 and off + 12 <= len(data):
            return True
        length_words = struct.unpack_from("!H", data, off + 2)[0]
        off += (length_words + 1) * 4
    return False
