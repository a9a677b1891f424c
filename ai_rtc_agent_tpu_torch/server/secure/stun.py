"""STUN (RFC 5389) messages + the ICE-lite binding responder.

The port's copy of ai_rtc_agent_tpu/server/secure/stun.py.  A full ICE
agent is
overkill for a server with a public host candidate: RFC 8445 s2.5 defines
**ICE-lite** — answer binding requests, never originate checks — which is
what every SFU-shaped deployment (and this agent) actually needs.  The
browser (full agent) does the connectivity checking; we authenticate its
requests with the short-term credential (our ice-pwd), reply with
XOR-MAPPED-ADDRESS, and latch the peer's source address for media.

Wire format pinned by RFC 5769 test vectors in tests/test_secure_stun.py.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets
import struct
import zlib

MAGIC_COOKIE = 0x2112A442
HEADER_LEN = 20

BINDING_REQUEST = 0x0001
BINDING_SUCCESS = 0x0101
BINDING_ERROR = 0x0111

ATTR_MAPPED_ADDRESS = 0x0001
ATTR_USERNAME = 0x0006
ATTR_MESSAGE_INTEGRITY = 0x0008
ATTR_ERROR_CODE = 0x0009
ATTR_XOR_MAPPED_ADDRESS = 0x0020
ATTR_PRIORITY = 0x0024
ATTR_USE_CANDIDATE = 0x0025
ATTR_FINGERPRINT = 0x8028
ATTR_ICE_CONTROLLED = 0x8029
ATTR_ICE_CONTROLLING = 0x802A

FINGERPRINT_XOR = 0x5354554E  # "STUN"


def is_stun(datagram: bytes) -> bool:
    """RFC 7983 demux: first byte 0-3, plus the magic cookie check."""
    return (
        len(datagram) >= HEADER_LEN
        and datagram[0] < 4
        and struct.unpack_from("!I", datagram, 4)[0] == MAGIC_COOKIE
    )


class StunMessage:
    def __init__(
        self,
        message_type: int,
        transaction_id: bytes | None = None,
        attributes: list | None = None,
    ):
        self.message_type = message_type
        self.transaction_id = transaction_id or secrets.token_bytes(12)
        # list of (attr_type, value-bytes), order preserved (integrity and
        # fingerprint computations depend on it)
        self.attributes = attributes if attributes is not None else []

    def get(self, attr_type: int) -> bytes | None:
        for t, v in self.attributes:
            if t == attr_type:
                return v
        return None

    # -- encode ---------------------------------------------------------

    def _encode(self, attrs: list) -> bytes:
        body = b""
        for t, v in attrs:
            body += struct.pack("!HH", t, len(v)) + v
            if len(v) % 4:
                body += b"\x00" * (4 - len(v) % 4)
        return (
            struct.pack(
                "!HHI", self.message_type, len(body), MAGIC_COOKIE
            )
            + self.transaction_id
            + body
        )

    def encode(
        self, integrity_key: bytes | None = None, fingerprint: bool = True
    ) -> bytes:
        """Serialize, optionally appending MESSAGE-INTEGRITY then
        FINGERPRINT (RFC 5389 s15.4-15.5: each is computed over the message
        with the length field adjusted to include the attribute being
        computed)."""
        attrs = list(self.attributes)
        if integrity_key is not None:
            # length must cover the upcoming 24-byte integrity attribute
            probe = self._encode(attrs + [(ATTR_MESSAGE_INTEGRITY, b"\x00" * 20)])
            mac = hmac.new(
                integrity_key, probe[: len(probe) - 24], hashlib.sha1
            ).digest()
            attrs.append((ATTR_MESSAGE_INTEGRITY, mac))
        if fingerprint:
            probe = self._encode(attrs + [(ATTR_FINGERPRINT, b"\x00" * 4)])
            crc = (
                zlib.crc32(probe[: len(probe) - 8]) & 0xFFFFFFFF
            ) ^ FINGERPRINT_XOR
            attrs.append((ATTR_FINGERPRINT, struct.pack("!I", crc)))
        return self._encode(attrs)

    # -- decode ---------------------------------------------------------

    @classmethod
    def decode(cls, data: bytes) -> "StunMessage":
        if len(data) < HEADER_LEN:
            raise ValueError("short STUN message")
        mtype, length, cookie = struct.unpack_from("!HHI", data, 0)
        if cookie != MAGIC_COOKIE:
            raise ValueError("bad magic cookie")
        if HEADER_LEN + length != len(data):
            # exact-size only: on UDP a datagram IS one message; trailing
            # bytes would ride outside every integrity computation
            raise ValueError("STUN length mismatch")
        txid = data[4 + 4 : HEADER_LEN]
        attrs: list = []
        off = HEADER_LEN
        end = HEADER_LEN + length
        while off + 4 <= end:
            t, alen = struct.unpack_from("!HH", data, off)
            off += 4
            if off + alen > end:
                raise ValueError("truncated STUN attribute")
            attrs.append((t, data[off : off + alen]))
            off += alen + ((4 - alen % 4) % 4)
        return cls(mtype, txid, attrs)

    def verify_integrity(self, key: bytes, raw: bytes) -> bool:
        """Check MESSAGE-INTEGRITY over the raw datagram (RFC 5389 s15.4:
        HMAC-SHA1 over the message up to — not including — the integrity
        attribute, with the header length rewritten to end just after it)."""
        mac = self.get(ATTR_MESSAGE_INTEGRITY)
        if mac is None:
            return False
        off = HEADER_LEN
        while off + 4 <= len(raw):
            t, alen = struct.unpack_from("!HH", raw, off)
            if t == ATTR_MESSAGE_INTEGRITY:
                adjusted = struct.pack(
                    "!HH", self.message_type, off - HEADER_LEN + 24
                ) + raw[4:off]
                expect = hmac.new(key, adjusted, hashlib.sha1).digest()
                return hmac.compare_digest(expect, mac)
            off += 4 + alen + ((4 - alen % 4) % 4)
        return False

    # -- address helpers ------------------------------------------------

    def xor_mapped_address(self) -> tuple | None:
        v = self.get(ATTR_XOR_MAPPED_ADDRESS)
        if v is None or len(v) < 8:
            return None
        family = v[1]
        port = struct.unpack_from("!H", v, 2)[0] ^ (MAGIC_COOKIE >> 16)
        if family == 0x01:
            raw = struct.unpack_from("!I", v, 4)[0] ^ MAGIC_COOKIE
            host = ".".join(str((raw >> s) & 0xFF) for s in (24, 16, 8, 0))
            return host, port
        return None

    @staticmethod
    def xor_address_value(host: str, port: int) -> bytes:
        packed = struct.unpack("!I", bytes(int(p) for p in host.split(".")))[0]
        return struct.pack(
            "!BBHI",
            0,
            0x01,
            port ^ (MAGIC_COOKIE >> 16),
            packed ^ MAGIC_COOKIE,
        )


def random_ice_string(length: int) -> str:
    """ice-char alphabet (RFC 8445 s5.3: alnum + '+' '/')."""
    alphabet = (
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"
    )
    return "".join(
        alphabet[b % len(alphabet)] for b in os.urandom(length)
    )


class IceLiteResponder:
    """Answers STUN binding requests on the media socket (ICE-lite).

    The full agent (browser) sends Binding Requests with USERNAME
    "ourfrag:theirfrag" and MESSAGE-INTEGRITY keyed on OUR ice-pwd
    (RFC 8445 s7.2.2).  We verify, reply with XOR-MAPPED-ADDRESS, and
    report the first USE-CANDIDATE-authenticated source as the latched
    peer address (nomination)."""

    def __init__(self, ufrag: str | None = None, pwd: str | None = None):
        self.ufrag = ufrag or random_ice_string(4)
        self.pwd = pwd or random_ice_string(22)
        self.remote_ufrag: str | None = None
        self.remote_pwd: str | None = None
        self.nominated_addr: tuple | None = None
        self.seen_addr: tuple | None = None

    def set_remote(self, ufrag: str | None, pwd: str | None) -> None:
        self.remote_ufrag = ufrag
        self.remote_pwd = pwd

    def handle(self, datagram: bytes, addr: tuple) -> bytes | None:
        """Process one STUN datagram; returns the reply to send (or None).

        Unauthenticated or malformed requests get no reply (RFC 5389
        s10.1.2 allows 400/401 responses; silence is the
        drop-hostile-traffic choice for a media port)."""
        try:
            msg = StunMessage.decode(datagram)
        except ValueError:
            return None
        if msg.message_type != BINDING_REQUEST:
            return None  # ICE-lite: we never sent a request, ignore responses
        fp = msg.get(ATTR_FINGERPRINT)
        if fp is not None:
            # RFC 5389 s7.3: a present FINGERPRINT must validate — it is
            # the only attribute outside MESSAGE-INTEGRITY's coverage, so
            # skipping the check would let corrupted/forged trailers ride
            # an otherwise-authenticated message (found by fuzzing)
            expect = (
                zlib.crc32(datagram[: len(datagram) - 8]) & 0xFFFFFFFF
            ) ^ FINGERPRINT_XOR
            if len(fp) != 4 or struct.unpack("!I", fp)[0] != expect:
                return None
        username = msg.get(ATTR_USERNAME)
        authenticated = False
        if username is not None:
            local = username.split(b":", 1)[0].decode("utf-8", "replace")
            if local != self.ufrag:
                return None
            if not msg.verify_integrity(self.pwd.encode(), datagram):
                return None
            authenticated = True
        # only AUTHENTICATED requests may steer where media goes — a
        # credential-less probe still gets its XOR-MAPPED-ADDRESS reply
        # (plain-STUN keepalives) but must never latch the peer address,
        # or any spoofed datagram could redirect the stream
        if authenticated:
            self.seen_addr = addr
            if msg.get(ATTR_USE_CANDIDATE) is not None or self.nominated_addr is None:
                self.nominated_addr = addr
        resp = StunMessage(BINDING_SUCCESS, msg.transaction_id)
        resp.attributes.append(
            (
                ATTR_XOR_MAPPED_ADDRESS,
                StunMessage.xor_address_value(addr[0], addr[1]),
            )
        )
        return resp.encode(
            integrity_key=self.pwd.encode() if username is not None else None
        )
