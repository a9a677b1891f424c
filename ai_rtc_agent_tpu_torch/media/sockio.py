"""Coalesced UDP socket I/O for the host media plane (the port's copy of
ai_rtc_agent_tpu/media/sockio.py).

The per-packet tier paid one ``transport.sendto`` (and so one event-loop
hop) per FU-A fragment and one ``recvfrom`` allocation per inbound
datagram.  This module is the batching layer under the frame-granular
TX/RX paths:

* ``BatchSender`` flushes a whole frame's packet batch in one call —
  ``sendmmsg(2)`` through ctypes where the libc has it (one syscall per
  frame), a tight non-blocking ``sock.sendto`` loop otherwise.  The
  mmsghdr/iovec scaffolding is allocated once and reused every frame;
  MTU-sized packets are staged through a contiguous copy pool whose
  iovec base pointers are precomputed, so the per-frame cost is slot
  memcpys plus one ``struct.pack_into`` per packet — per-packet ctypes
  object churn only ever pays for oversized/exotic buffers.
* ``DatagramDrain`` empties every ready datagram from a non-blocking
  socket into a rotating pool of preallocated buffers (``recvfrom_into``
  — no per-packet payload allocation), so the asyncio loop pays one
  callback per *burst*, not one per packet.  recvmmsg is deliberately
  not used: per-message sockaddr decoding costs what the extra syscalls
  do, and the allocation win is already captured by the pool.

Both paths are pure host-side plumbing: no asyncio imports, callers own
the loop integration (server/rtc_native.py, media/rtp_client.py).
"""

from __future__ import annotations

import ctypes
import errno
import logging
import os
import socket
import struct

from ..utils import env

logger = logging.getLogger(__name__)


def dup_raw_socket(sock):
    """A real ``socket.socket`` over a dup'd fd of an asyncio transport's
    UDP socket.  asyncio wraps transport sockets in TransportSocket,
    which deprecates direct I/O (recvfrom_into/sendto) — the dup shares
    the kernel socket but has an independent lifetime the caller owns
    (close it on teardown).  None when the fd cannot be duplicated."""
    try:
        fd = os.dup(sock.fileno())
    except (OSError, AttributeError, ValueError):
        return None
    try:
        raw = socket.socket(sock.family, sock.type, sock.proto, fileno=fd)
    except OSError:
        os.close(fd)
        return None
    raw.setblocking(False)
    return raw


# Linux's SO_RCVBUFFORCE, which Python's socket module does not always name
_SO_RCVBUFFORCE = getattr(socket, "SO_RCVBUFFORCE", 33)


def set_rcvbuf(sock, nbytes: int) -> int:
    """Ask for a ``nbytes`` receive buffer on ``sock``: past
    ``net.core.rmem_max`` where the process may (SO_RCVBUFFORCE), else up
    to it.  -> the size the kernel granted (it doubles the request)."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, _SO_RCVBUFFORCE, nbytes)
    except OSError:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, nbytes)
    return sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)


class _iovec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p), ("iov_len", ctypes.c_size_t)]


class _msghdr(ctypes.Structure):
    _fields_ = [
        ("msg_name", ctypes.c_void_p),
        ("msg_namelen", ctypes.c_uint32),
        ("msg_iov", ctypes.POINTER(_iovec)),
        ("msg_iovlen", ctypes.c_size_t),
        ("msg_control", ctypes.c_void_p),
        ("msg_controllen", ctypes.c_size_t),
        ("msg_flags", ctypes.c_int),
    ]


class _mmsghdr(ctypes.Structure):
    _fields_ = [("msg_hdr", _msghdr), ("msg_len", ctypes.c_uint)]


# per-packet staging slot in BatchSender's contiguous copy pool — covers
# MTU-sized media datagrams; anything larger rides the zero-copy pin path
_POOL_SLOT = 2048
_IOV_SIZE = ctypes.sizeof(_iovec)
# iovec is {void *iov_base; size_t iov_len} — two native words, written
# as indexed stores into a "Q"-cast view of the array's buffer (ctypes
# attribute assignment goes through descriptor machinery that costs ~1µs
# per field; a cast-memoryview store is an order of magnitude cheaper).
# Only when the native word layout matches the ctypes one (any sane LP64
# libc; a mismatch silently disables the copy-pool path, never corrupts)
_FAST_IOV = (
    struct.calcsize("QQ") == _IOV_SIZE
    and ctypes.sizeof(ctypes.c_void_p) == 8
)


class _sockaddr_in(ctypes.Structure):
    _fields_ = [
        ("sin_family", ctypes.c_uint16),
        ("sin_port", ctypes.c_uint16),
        ("sin_addr", ctypes.c_uint8 * 4),
        ("sin_zero", ctypes.c_uint8 * 8),
    ]


_sendmmsg = None
_sendmmsg_tried = False


def sendmmsg_fn():
    """The libc sendmmsg symbol, or None (non-Linux libc, lookup failure)."""
    global _sendmmsg, _sendmmsg_tried
    if _sendmmsg_tried:
        return _sendmmsg
    _sendmmsg_tried = True
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        fn = libc.sendmmsg
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(_mmsghdr),
            ctypes.c_uint,
            ctypes.c_int,
        ]
        _sendmmsg = fn
    except (OSError, AttributeError):
        _sendmmsg = None
    return _sendmmsg


class BatchSender:
    """Send a list of datagrams in one flush, reusing the ctypes arrays.

    ``send(sock, pkts, addr)`` returns the number of packets handed to
    the kernel.  ``addr=None`` means the socket is connected.  When the
    send buffer fills mid-batch the remainder goes through ``fallback``
    (the asyncio transport's buffered sendto) when given, else it is
    dropped — real-time media prefers a gap over a latency queue.

    Note: bypassing the transport means a batch can overtake datagrams
    the transport itself has buffered (only happens after EAGAIN, which
    UDP sockets essentially never return before the batch path has
    already fallen back).  RTP tolerates reordering by design.
    """

    def __init__(self, use_sendmmsg: bool | None = None):
        if use_sendmmsg is None:
            use_sendmmsg = env.get_bool("HOST_PLANE_SENDMMSG", True)
        self._enabled = bool(use_sendmmsg) and sendmmsg_fn() is not None
        self._fn = sendmmsg_fn() if self._enabled else None
        self._cap = 0
        self._hdrs = None
        self._iovs = None
        self._iov_list: list = []  # flat element wrappers (ctypes element
        self._mhdr_list: list = []  # access materializes a new object —
        self._cap_addr = None  # cache them once per growth, not per frame)
        self._sa = _sockaddr_in()
        # contiguous copy pool backing the fast path: iov_base targets are
        # stable slot addresses, so a frame's flush is slot memcpys + one
        # (base, len) pack per packet instead of per-packet ctypes objects
        self._pool_ref = None  # keeps the from_buffer export alive
        self._pool_base = 0
        self._pool_mv: memoryview | None = None
        self._iov_mv: memoryview | None = None
        self._hdr0_ref = None  # byref(hdrs[0]), cached per growth
        self._last_addr = None  # (host, port) the sockaddr currently holds
        self._sa_ptr = ctypes.cast(
            ctypes.byref(self._sa), ctypes.c_void_p
        ).value  # stable for the object's lifetime
        self._sa_len = ctypes.sizeof(self._sa)
        # multi-destination state (send_grouped): per-entry msg_name
        # values as plain ints (delta-written: a stable audience pays no
        # ctypes attribute write after its first burst) and a bounded
        # (host, port) -> pinned sockaddr cache
        self._entry_name: list = []
        self._addr_cache: dict = {}
        self._last_spans = None  # the grouped layout already in the headers

    def _ensure(self, n: int, name_ptr, name_len) -> None:
        if n <= self._cap and name_ptr == self._cap_addr:
            return
        if n > self._cap:
            cap = max(n, 2 * self._cap, 32)
            self._hdrs = (_mmsghdr * cap)()
            self._iovs = (_iovec * cap)()
            self._iov_list = [self._iovs[i] for i in range(cap)]
            self._mhdr_list = [self._hdrs[i].msg_hdr for i in range(cap)]
            for i, mh in enumerate(self._mhdr_list):
                mh.msg_iov = ctypes.pointer(self._iov_list[i])
                mh.msg_iovlen = 1
            if _FAST_IOV:
                pool = bytearray(cap * _POOL_SLOT)
                self._pool_ref = (ctypes.c_char * len(pool)).from_buffer(pool)
                self._pool_base = ctypes.addressof(self._pool_ref)
                self._pool_mv = memoryview(pool)
                self._iov_mv = memoryview(
                    (ctypes.c_char * (cap * _IOV_SIZE)).from_buffer(self._iovs)
                ).cast("B").cast("Q")
            self._hdr0_ref = ctypes.byref(self._hdrs[0])
            self._entry_name = [None] * cap
            self._cap = cap
        # destination rarely changes per sender: write msg_name once
        for mh in self._mhdr_list:
            mh.msg_name = name_ptr
            mh.msg_namelen = name_len
        self._entry_name = [name_ptr] * self._cap
        self._cap_addr = name_ptr
        self._last_spans = None  # the uniform rewrite invalidated the layout

    def _fill_pool(self, pkts, entry0: int = 0) -> bool:
        """Fast-path frame staging: copy every packet into its pool slot
        (slots indexed from ``entry0``) and pack its iovec in place.
        False when any packet outgrows the slot (caller falls back to the
        pin path for the whole frame — the iovecs written so far are
        fully overwritten there)."""
        if self._pool_mv is None:
            return False
        pool_mv, iov_mv, base = self._pool_mv, self._iov_mv, self._pool_base
        slot = _POOL_SLOT
        off = entry0 * slot
        q = 2 * entry0  # word index into the "Q"-cast iovec view: 2/entry
        try:
            for pkt in pkts:
                ln = len(pkt)
                if ln > slot:
                    return False
                pool_mv[off:off + ln] = pkt
                iov_mv[q] = base + off
                iov_mv[q + 1] = ln
                off += slot
                q += 2
        except (TypeError, ValueError):  # non-contiguous/exotic buffer
            return False
        return True

    @staticmethod
    def _pin(pkt, refs):
        """-> (address, length) of pkt's buffer, pinned via refs."""
        if isinstance(pkt, bytes):
            ref = ctypes.c_char_p(pkt)  # no copy; holds the bytes alive
            refs.append(ref)
            return ctypes.cast(ref, ctypes.c_void_p).value, len(pkt)
        try:
            ref = (ctypes.c_ubyte * len(pkt)).from_buffer(pkt)
        except (TypeError, ValueError):  # read-only / exotic buffer
            ref = ctypes.c_char_p(bytes(pkt))
            refs.append(ref)
            return ctypes.cast(ref, ctypes.c_void_p).value, len(pkt)
        refs.append(ref)
        return ctypes.addressof(ref), len(pkt)

    def send(self, sock, pkts, addr=None, fallback=None) -> int:
        n = len(pkts)
        if n == 0:
            return 0
        fn = self._fn
        if fn is None:
            return self._loop_send(sock, pkts, addr, fallback)
        name_ptr, name_len = None, 0
        if addr is not None:
            if addr != self._last_addr:  # sockaddr reused until it changes
                try:
                    packed = socket.inet_aton(addr[0])
                except OSError:
                    # non-IPv4 destination: the tight loop handles it
                    return self._loop_send(sock, pkts, addr, fallback)
                sa = self._sa
                sa.sin_family = socket.AF_INET
                sa.sin_port = socket.htons(addr[1])
                ctypes.memmove(sa.sin_addr, packed, 4)
                self._last_addr = addr if isinstance(addr, tuple) else None
            # the struct is reused in place, so a changed addr needs no
            # msg_name rewrite — the pointer is stable
            name_ptr = self._sa_ptr
            name_len = self._sa_len
        self._ensure(n, name_ptr, name_len)
        refs: list = []
        if not self._fill_pool(pkts):
            # oversized datagram (or exotic struct layout): the zero-copy
            # pin path handles arbitrary sizes at per-packet ctypes cost
            pin = self._pin
            iovs = self._iov_list
            for i, pkt in enumerate(pkts):
                base, ln = pin(pkt, refs)
                iov = iovs[i]
                iov.iov_base = base
                iov.iov_len = ln
        fd = sock.fileno()
        sent = 0
        while sent < n:
            r = fn(
                fd,
                self._hdr0_ref if sent == 0
                else ctypes.byref(self._hdrs[sent]),
                n - sent,
                0,
            )
            if r < 0:
                e = ctypes.get_errno()
                if e == errno.EINTR:
                    continue
                if e not in (errno.EAGAIN, errno.EWOULDBLOCK):
                    logger.debug("sendmmsg errno %d; per-packet fallback", e)
                return sent + self._loop_send(sock, pkts[sent:], addr, fallback)
            sent += r
        return sent

    # -- multi-destination burst (the broadcast fan-out) ---------------------

    _ADDR_CACHE_MAX = 4096  # pinned sockaddrs (≈ viewer audience bound)

    def _sockaddr_for(self, addr):
        """(host, port) -> (ptr, len) of a pinned sockaddr_in, or None for
        non-IPv4.  Cached per destination — an audience's sockaddrs are
        packed once, not once per frame."""
        hit = self._addr_cache.get(addr)
        if hit is not None:
            return hit
        try:
            packed = socket.inet_aton(addr[0])
        except OSError:
            return None
        sa = _sockaddr_in()
        sa.sin_family = socket.AF_INET
        sa.sin_port = socket.htons(addr[1])
        ctypes.memmove(sa.sin_addr, packed, 4)
        if len(self._addr_cache) >= self._ADDR_CACHE_MAX:
            self._addr_cache.clear()  # churny audience: re-pack, stay bounded
        entry = (
            sa,  # keeps the struct alive while cached
            ctypes.cast(ctypes.byref(sa), ctypes.c_void_p).value,
            ctypes.sizeof(sa),
        )
        self._addr_cache[addr] = entry
        return entry

    def send_grouped(self, sock, batches, fallback=None) -> int:
        """One sendmmsg burst across MULTIPLE destinations: ``batches``
        is ``[(pkts, addr), ...]`` — the broadcast fan-out's whole-
        audience flush (every viewer's rewritten frame in one syscall).
        Per-entry destinations ride each mmsghdr's ``msg_name``; for a
        stable audience the pointers are delta-written, so steady-state
        cost is the same slot memcpys as :meth:`send`.  Returns packets
        handed to the kernel.  Non-IPv4 destinations, oversized packets
        or a missing libc sendmmsg fall back per batch."""
        fn = self._fn
        if fn is None:
            sent = 0
            for pkts, addr in batches:
                sent += self._loop_send(sock, pkts, addr, fallback)
            return sent
        flat: list = []
        # (start, end, name_ptr, name_len, addr, dup_start) per batch;
        # dup_start >= 0 marks a batch whose pkts LIST is the same object
        # as an earlier batch's (broadcast identity fast path: aligned
        # viewers share the source views) — its iovecs are word-copied
        # from that batch's, no byte is staged twice
        spans: list = []
        seen: dict = {}  # id(pkts) -> first batch's start (refs held by
        deferred: list = []  # `batches` for the duration of this call)
        for pkts, addr in batches:
            if not pkts:
                continue
            sa = self._sockaddr_for(addr) if addr is not None else None
            if addr is not None and sa is None:
                deferred.append((pkts, addr))
                continue
            ptr, ln = (sa[1], sa[2]) if sa is not None else (None, 0)
            start = len(flat)
            flat.extend(pkts)  # C-speed — no per-packet Python loop
            spans.append((start, len(flat), ptr, ln, addr,
                          seen.setdefault(id(pkts), start)))
        sent = 0
        n = len(flat)
        if n:
            if n > self._cap:  # growth only — names are delta-written below
                self._ensure(n, None, 0)
            refs: list = []
            iov_mv = self._iov_mv
            staged = self._pool_mv is not None
            if staged:
                for start, end, _ptr, _ln, _addr, dup in spans:
                    if dup != start:  # shared views: copy iovec words
                        q0, q1 = 2 * start, 2 * end
                        s0 = 2 * dup
                        iov_mv[q0:q1] = iov_mv[s0:s0 + (q1 - q0)]
                    elif not self._fill_pool(flat[start:end], start):
                        staged = False
                        break
            if not staged:
                pin = self._pin
                iovs = self._iov_list
                for i, pkt in enumerate(flat):
                    base, ln = pin(pkt, refs)
                    iov = iovs[i]
                    iov.iov_base = base
                    iov.iov_len = ln
            if spans != self._last_spans:
                # delta-write per entry; a stable audience (same batch
                # layout burst after burst) skips the whole per-packet
                # loop on the spans comparison above
                names = self._entry_name
                mhdrs = self._mhdr_list
                for start, end, ptr, ln, _addr, _dup in spans:
                    for i in range(start, end):
                        if names[i] != ptr:
                            mh = mhdrs[i]
                            mh.msg_name = ptr
                            mh.msg_namelen = ln
                            names[i] = ptr
                self._last_spans = spans
            self._cap_addr = -1  # uniform-destination send() must rewrite
            fd = sock.fileno()
            while sent < n:
                r = fn(
                    fd,
                    self._hdr0_ref if sent == 0
                    else ctypes.byref(self._hdrs[sent]),
                    n - sent,
                    0,
                )
                if r < 0:
                    e = ctypes.get_errno()
                    if e == errno.EINTR:
                        continue
                    if e not in (errno.EAGAIN, errno.EWOULDBLOCK):
                        logger.debug(
                            "grouped sendmmsg errno %d; per-packet fallback", e
                        )
                    for start, end, _ptr, _ln, addr, _dup in spans:
                        lo = max(start, sent)
                        if lo < end:
                            sent += self._loop_send(
                                sock, flat[lo:end], addr, fallback
                            )
                    break
                sent += r
        for pkts, addr in deferred:
            sent += self._loop_send(sock, pkts, addr, fallback)
        return sent

    @staticmethod
    def _loop_send(sock, pkts, addr, fallback) -> int:
        sent = 0
        try:
            if addr is None:
                for pkt in pkts:
                    sock.send(pkt)
                    sent += 1
            else:
                for pkt in pkts:
                    sock.sendto(pkt, addr)
                    sent += 1
        except (BlockingIOError, InterruptedError, OSError):
            if fallback is not None:
                for pkt in pkts[sent:]:
                    fallback(pkt, addr)
                return len(pkts)
        return sent


class CoalescedFlush:
    """One frame-batch flusher bound to an asyncio datagram transport.

    Owns the transport's dup'd raw socket (see :func:`dup_raw_socket`),
    a reusable :class:`BatchSender`, and the fallback semantics: when the
    raw path is unavailable or the kernel pushes back mid-batch, packets
    go through the transport's own buffered ``sendto``.  The three TX
    sites (secure pump, plain pump, client) share exactly this lifecycle
    — bind() after the transport exists, flush() per frame, close() on
    teardown (releases only OUR dup'd fd, never the transport's)."""

    def __init__(self, use_sendmmsg: bool | None = None):
        self._sender = BatchSender(use_sendmmsg)
        self._transport = None
        self.sock = None

    def bind(self, transport) -> None:
        self._transport = transport
        get_info = getattr(transport, "get_extra_info", None)
        wrapped = get_info("socket") if get_info is not None else None
        self.sock = dup_raw_socket(wrapped) if wrapped is not None else None

    def _fallback(self, pkt, addr) -> None:
        if addr is None:
            self._transport.sendto(pkt)
        else:
            self._transport.sendto(pkt, addr)

    def flush(self, pkts, addr=None) -> None:
        if not pkts or self._transport is None:
            return
        if self.sock is None:
            for pkt in pkts:
                self._fallback(pkt, addr)
            return
        self._sender.send(self.sock, pkts, addr, fallback=self._fallback)

    def flush_grouped(self, batches) -> None:
        """Multi-destination flush: ``batches`` = [(pkts, addr), ...], the
        broadcast fan-out's whole-audience burst (one sendmmsg for every
        viewer's copy of the frame, server/broadcast.py)."""
        if not batches or self._transport is None:
            return
        if self.sock is None:
            for pkts, addr in batches:
                for pkt in pkts:
                    self._fallback(pkt, addr)
            return
        self._sender.send_grouped(self.sock, batches, fallback=self._fallback)

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
            self.sock = None


class DatagramDrain:
    """Batch-drain a non-blocking UDP socket through pooled buffers.

    ``drain(sock, cb)`` calls ``cb(view, addr)`` for every datagram that
    is already queued, where ``view`` is a memoryview into a rotating
    pool slot: valid during the callback and for the next ``slots - 1``
    datagrams — anything that holds a packet longer (reorder buffers,
    fault-injected delayed delivery, DTLS reassembly) must copy, which
    the callers do (server/rtc_native.py materializes non-RTP kinds).
    """

    MTU = 2048  # covers media (<=1500) and DTLS handshake flights

    def __init__(self, slots: int | None = None, max_per_drain: int | None = None,
                 mtu: int | None = None):
        if slots is None:
            slots = env.get_int("HOST_PLANE_RX_POOL_SLOTS", 32)
        if mtu is None:
            mtu = env.get_int("HOST_PLANE_RX_MTU", self.MTU)
        self._bufs = [bytearray(max(576, mtu)) for _ in range(max(2, slots))]
        self._views = [memoryview(b) for b in self._bufs]
        self._i = 0
        self.truncated = 0  # oversized datagrams dropped (see drain())
        if max_per_drain is None:
            max_per_drain = env.get_int("HOST_PLANE_RX_DRAIN_MAX", 64)
        self.max_per_drain = max(1, max_per_drain)

    def drain(self, sock, cb) -> int:
        n = 0
        bufs, views = self._bufs, self._views
        slots = len(bufs)
        i = self._i
        trunc_flag = getattr(socket, "MSG_TRUNC", 0)
        for _ in range(self.max_per_drain):
            try:
                # recvmsg_into (not recvfrom_into): the flags word tells
                # us when a datagram outgrew the pool slot — a truncated
                # packet must be DROPPED, not delivered corrupt (SRTP
                # would reject it anyway; plain RTP would poison the AU)
                nbytes, _anc, flags, addr = sock.recvmsg_into((bufs[i],))
            except (BlockingIOError, InterruptedError):
                break
            except OSError:  # socket closed under us mid-drain
                break
            if flags & trunc_flag:
                self.truncated += 1
                if self.truncated == 1:
                    logger.warning(
                        "drain dropped a datagram larger than the %d-byte "
                        "pool slot (raise HOST_PLANE_RX_MTU)", len(bufs[i])
                    )
                continue
            view = views[i][:nbytes]
            i = (i + 1) % slots
            n += 1
            cb(view, addr)
        self._i = i
        return n
