"""SRTP / SRTCP: AES128_CM_HMAC_SHA1_80 (RFC 3711) and AEAD AES-128-GCM
(RFC 7714 — the profile Chrome's libwebrtc prefers; single-pass crypto,
~2x cheaper per packet than CM+HMAC).

The port's copy of ai_rtc_agent_tpu/server/secure/srtp.py.  aiortc keeps
SRTP in libsrtp's C bindings; here it is Python over ``cryptography``'s C
primitives (one AEAD pass over <=1200 bytes per packet).

Key derivation is pinned by the RFC 3711 B.3 test vectors in
tests/test_secure_srtp.py; profile negotiation + keying lengths by the
openssl interop in tests/test_secure_dtls.py.
"""

from __future__ import annotations

import hashlib
import hmac
import struct

import numpy as np
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

AUTH_TAG_LEN = 10  # HMAC-SHA1-80
SRTCP_INDEX_LEN = 4
_MASK128 = (1 << 128) - 1

LABEL_RTP_ENCRYPTION = 0x00
LABEL_RTP_AUTH = 0x01
LABEL_RTP_SALT = 0x02
LABEL_RTCP_ENCRYPTION = 0x03
LABEL_RTCP_AUTH = 0x04
LABEL_RTCP_SALT = 0x05


def _aes_ecb(key: bytes, block: bytes) -> bytes:
    enc = Cipher(algorithms.AES(key), modes.ECB()).encryptor()
    return enc.update(block) + enc.finalize()


def _aes_ctr(key: bytes, iv16: bytes, data: bytes) -> bytes:
    enc = Cipher(algorithms.AES(key), modes.CTR(iv16)).encryptor()
    return enc.update(data) + enc.finalize()


def kdf(master_key: bytes, master_salt: bytes, label: int, out_len: int) -> bytes:
    """AES-CM key derivation (RFC 3711 s4.3.1, kdr=0 so index/kdr = 0):
    x = label||0^48  XOR  master_salt, keystream = AES-CM(master_key, x)."""
    salt_int = int.from_bytes(master_salt, "big")  # 112-bit
    x = salt_int ^ (label << 48)
    iv = (x << 16).to_bytes(16, "big")
    return _aes_ctr(master_key, iv, b"\x00" * out_len)


class SrtpContext:
    """One direction of an SRTP session (one master key/salt).

    protect()/unprotect() handle SRTP packets; protect_rtcp()/
    unprotect_rtcp() handle the (encrypted, E=1) SRTCP variant the PLI
    keyframe-recovery channel rides on (server/rtc_native.py)."""

    def __init__(self, master_key: bytes, master_salt: bytes):
        if len(master_key) != 16 or len(master_salt) != 14:
            raise ValueError("AES128_CM needs a 16-byte key + 14-byte salt")
        self.session_key = kdf(master_key, master_salt, LABEL_RTP_ENCRYPTION, 16)
        self.session_auth = kdf(master_key, master_salt, LABEL_RTP_AUTH, 20)
        self.session_salt = kdf(master_key, master_salt, LABEL_RTP_SALT, 14)
        self.rtcp_key = kdf(master_key, master_salt, LABEL_RTCP_ENCRYPTION, 16)
        self.rtcp_auth = kdf(master_key, master_salt, LABEL_RTCP_AUTH, 20)
        self.rtcp_salt = kdf(master_key, master_salt, LABEL_RTCP_SALT, 14)
        # rollover counter state per SSRC: ssrc -> [roc, highest_seq_seen]
        self._roc: dict = {}
        self._rtcp_index = 0  # our outbound SRTCP index (31-bit)
        # replay protection (RFC 3711 s3.3.2, a MUST): 64-deep sliding
        # window over the 48-bit packet index, per SSRC; one more for SRTCP
        self._replay: dict = {}  # ssrc -> [max_index, mask]
        self._rtcp_replay = [-1, 0]
        # cached primitives: per-packet Cipher/HMAC
        # CONSTRUCTION was the dominant python cost at streaming rates —
        # key the objects once per context, copy/reuse per packet
        self._aes = algorithms.AES(self.session_key)
        self._rtcp_aes = algorithms.AES(self.rtcp_key)
        self._hmac_base = hmac.new(self.session_auth, b"", hashlib.sha1)
        self._rtcp_hmac_base = hmac.new(self.rtcp_auth, b"", hashlib.sha1)
        # ECB over precomputed counter blocks IS the CTR keystream: one
        # stateless encryptor serves every protect_frame call (never
        # finalized; each 16-byte block is independent)
        self._ecb = Cipher(self._aes, modes.ECB()).encryptor()
        self._salt_int = int.from_bytes(self.session_salt, "big")
        self._scratch = bytearray(0)  # counter blocks + payload staging

    # -- packet index (RFC 3711 s3.3.1 + appendix A) --------------------

    def _estimate_index(self, ssrc: int, seq: int, update: bool) -> int:
        roc, s_l = self._roc.get(ssrc, (0, None))
        if s_l is None:
            v = roc
        elif s_l < 32768:
            v = roc - 1 if (seq - s_l > 32768) else roc
        else:
            v = roc + 1 if (s_l - seq > 32768) else roc
        v = max(v, 0)
        if update:
            if s_l is None:
                self._roc[ssrc] = (roc, seq)
            elif v > roc:
                self._roc[ssrc] = (v, seq)
            elif v == roc and seq > s_l:
                self._roc[ssrc] = (roc, seq)
            # v == roc-1: late packet from the previous rollover — no update
        return (v << 16) | seq

    @staticmethod
    def _replay_check(state: list, index: int) -> None:
        """state = [max_index, mask]; raises on replay, else records."""
        mx, mask = state
        if index > mx:
            shift = index - mx
            state[0] = index
            state[1] = 1 if shift >= 64 else ((mask << shift) | 1) & (
                0xFFFFFFFFFFFFFFFF
            )
            return
        diff = mx - index
        if diff >= 64 or (mask >> diff) & 1:
            raise ValueError("SRTP replayed packet")
        state[1] = mask | (1 << diff)

    def _keystream_iv(self, salt: bytes, ssrc: int, index: int) -> bytes:
        salt_int = int.from_bytes(salt, "big")
        iv = (salt_int << 16) ^ (ssrc << 64) ^ (index << 16)
        return (iv & ((1 << 128) - 1)).to_bytes(16, "big")

    # -- SRTP ------------------------------------------------------------

    @staticmethod
    def _payload_offset(pkt: bytes) -> int:
        """RTP header length: 12 + 4*CC (+ extension if X set)."""
        if len(pkt) < 12:
            raise ValueError("short RTP packet")
        off = 12 + 4 * (pkt[0] & 0x0F)
        if pkt[0] & 0x10:  # extension
            if len(pkt) < off + 4:
                raise ValueError("truncated RTP extension")
            ext_words = struct.unpack_from("!H", pkt, off + 2)[0]
            off += 4 + 4 * ext_words
        if off > len(pkt):
            raise ValueError("truncated RTP packet")
        return off

    def _frame_indexes(self, pkts) -> list[tuple[int, int, int]]:
        """One pass of (ssrc, seq, index) for a frame's packets.

        The packetizer emits consecutive seqs on one SSRC, so after the
        first packet's full RFC 3711 index estimation the rest are
        ``index0 + i`` with a single ROC-state write at the end; any
        packet that breaks the pattern falls back to per-packet
        estimation (identical state transitions either way)."""
        p0 = pkts[0]
        ssrc0 = struct.unpack_from("!I", p0, 8)[0]
        seq0 = struct.unpack_from("!H", p0, 2)[0]
        index0 = self._estimate_index(ssrc0, seq0, update=True)
        metas = [(ssrc0, seq0, index0)]
        run = True
        for i, pkt in enumerate(pkts[1:], 1):
            ssrc = struct.unpack_from("!I", pkt, 8)[0]
            seq = struct.unpack_from("!H", pkt, 2)[0]
            if run and ssrc == ssrc0 and seq == ((seq0 + i) & 0xFFFF):
                metas.append((ssrc, seq, index0 + i))
            else:
                run = False
                metas.append((ssrc, seq, self._estimate_index(ssrc, seq, True)))
        if run and len(pkts) > 1:
            last_index = index0 + len(pkts) - 1
            self._roc[ssrc0] = (last_index >> 16, last_index & 0xFFFF)
        return metas

    def protect_frame(self, pkts) -> list:
        """SRTP-protect all fragments of one access unit in a single
        pass: per-packet IVs precomputed together, ONE AES call for the
        whole frame's CTR keystream (ECB over the precomputed counter
        blocks), one numpy XOR, and per-packet tags from the pre-keyed
        HMAC.  Byte-identical to N x legacy ``protect`` (pinned by
        tests/test_host_plane.py).  Accepts bytes or memoryviews;
        returns freshly-allocated bytearrays the caller owns."""
        if not pkts:
            return []
        metas = self._frame_indexes(pkts)
        offs, plens, bases = [], [], []
        total = 0  # counter blocks across the frame
        for pkt in pkts:
            off = self._payload_offset(pkt)
            plen = len(pkt) - off
            offs.append(off)
            plens.append(plen)
            bases.append(total)
            total += (plen + 15) >> 4
        need = total * 32  # [counter blocks | staged payloads]
        if len(self._scratch) < need:
            self._scratch = bytearray(max(need, 4096))
        scratch = self._scratch
        np_s = np.frombuffer(scratch, np.uint8)
        blocks = np_s[: total * 16].reshape(total, 16)
        stage = np_s[total * 16 : total * 32]
        stage_mv = memoryview(scratch)[total * 16 : total * 32]
        salt16 = self._salt_int << 16
        ctr = np.arange(0, dtype=np.uint32)
        for pkt, (ssrc, _seq, index), off, plen, base in zip(
            pkts, metas, offs, plens, bases
        ):
            nb = (plen + 15) >> 4
            iv = (salt16 ^ (ssrc << 64) ^ (index << 16)) & _MASK128
            b = blocks[base : base + nb]
            b[:, :14] = np.frombuffer(iv.to_bytes(16, "big"), np.uint8)[:14]
            if len(ctr) < nb:
                ctr = np.arange(max(nb, 256), dtype=np.uint32)
            b[:, 14] = ctr[:nb] >> 8
            b[:, 15] = ctr[:nb] & 0xFF
            stage_mv[base * 16 : base * 16 + plen] = pkt[off:]
        ks = self._ecb.update(memoryview(scratch)[: total * 16])
        np.bitwise_xor(stage, np.frombuffer(ks, np.uint8), out=stage)
        out = []
        auth = self.session_auth
        for pkt, (ssrc, _seq, index), off, plen, base in zip(
            pkts, metas, offs, plens, bases
        ):
            # wire = header | encrypted payload | tag; the ROC rides the
            # tag input after the ciphertext (RFC 3711 s4.2), staged in
            # the tag's slot so hmac runs over ONE contiguous buffer
            wire = bytearray(off + plen + AUTH_TAG_LEN)
            wire[:off] = pkt[:off]
            wire[off : off + plen] = stage_mv[base * 16 : base * 16 + plen]
            struct.pack_into("!I", wire, off + plen, index >> 16)
            tag = hmac.digest(auth, memoryview(wire)[: off + plen + 4], "sha1")
            wire[off + plen :] = tag[:AUTH_TAG_LEN]
            # freshly-built, exclusively-owned: hand out the bytearray
            # itself (send/cache consumers take any buffer; a bytes()
            # here would re-copy every packet of the hot path)
            out.append(wire)
        return out

    def protect(self, pkt: bytes) -> bytes:
        """Per-packet API: thin wrapper over the frame path."""
        return self.protect_frame((pkt,))[0]

    def _protect_legacy(self, pkt: bytes) -> bytes:
        """The pre-batching per-packet path (fresh cipher + HMAC per
        packet).  Kept verbatim as the baseline for
        scripts/host_plane_bench.py and the wire-compat pins — not used
        by the serving path."""
        ssrc = struct.unpack_from("!I", pkt, 8)[0]
        seq = struct.unpack_from("!H", pkt, 2)[0]
        index = self._estimate_index(ssrc, seq, update=True)
        off = self._payload_offset(pkt)
        iv = self._keystream_iv(self.session_salt, ssrc, index)
        enc = pkt[:off] + _aes_ctr(self.session_key, iv, pkt[off:])
        roc = index >> 16
        tag = hmac.new(
            self.session_auth, enc + struct.pack("!I", roc), hashlib.sha1
        ).digest()[:AUTH_TAG_LEN]
        return enc + tag

    def unprotect(self, pkt: bytes) -> bytes:
        if len(pkt) < 12 + AUTH_TAG_LEN:
            raise ValueError("short SRTP packet")
        if not isinstance(pkt, (bytes, bytearray)):
            pkt = bytes(pkt)  # pooled RX views: stabilize once up front
        enc, tag = pkt[:-AUTH_TAG_LEN], pkt[-AUTH_TAG_LEN:]
        ssrc = struct.unpack_from("!I", enc, 8)[0]
        seq = struct.unpack_from("!H", enc, 2)[0]
        index = self._estimate_index(ssrc, seq, update=False)
        h = self._hmac_base.copy()
        h.update(enc)
        h.update(struct.pack("!I", index >> 16))
        if not hmac.compare_digest(h.digest()[:AUTH_TAG_LEN], tag):
            raise ValueError("SRTP auth failure")
        # replay check only after the tag verified (unauthenticated noise
        # must not advance the window)
        self._replay_check(self._replay.setdefault(ssrc, [-1, 0]), index)
        self._estimate_index(ssrc, seq, update=True)
        off = self._payload_offset(enc)
        iv = self._keystream_iv(self.session_salt, ssrc, index)
        dec = Cipher(self._aes, modes.CTR(iv)).encryptor()
        return enc[:off] + dec.update(enc[off:]) + dec.finalize()

    # -- SRTCP (RFC 3711 s3.4) -------------------------------------------

    def protect_rtcp(self, pkt: bytes) -> bytes:
        if len(pkt) < 8:
            raise ValueError("short RTCP packet")
        ssrc = struct.unpack_from("!I", pkt, 4)[0]
        self._rtcp_index = (self._rtcp_index + 1) & 0x7FFFFFFF
        index = self._rtcp_index
        iv = self._keystream_iv(self.rtcp_salt, ssrc, index)
        enc_c = Cipher(self._rtcp_aes, modes.CTR(iv)).encryptor()
        enc = pkt[:8] + enc_c.update(pkt[8:]) + enc_c.finalize()
        e_index = struct.pack("!I", index | 0x80000000)  # E=1: encrypted
        h = self._rtcp_hmac_base.copy()
        h.update(enc)
        h.update(e_index)
        return enc + e_index + h.digest()[:AUTH_TAG_LEN]

    def unprotect_rtcp(self, pkt: bytes) -> bytes:
        if len(pkt) < 8 + SRTCP_INDEX_LEN + AUTH_TAG_LEN:
            raise ValueError("short SRTCP packet")
        if not isinstance(pkt, (bytes, bytearray)):
            pkt = bytes(pkt)
        tag = pkt[-AUTH_TAG_LEN:]
        e_index = pkt[-(AUTH_TAG_LEN + SRTCP_INDEX_LEN) : -AUTH_TAG_LEN]
        enc = pkt[: -(AUTH_TAG_LEN + SRTCP_INDEX_LEN)]
        h = self._rtcp_hmac_base.copy()
        h.update(enc)
        h.update(e_index)
        if not hmac.compare_digest(h.digest()[:AUTH_TAG_LEN], tag):
            raise ValueError("SRTCP auth failure")
        raw_index = struct.unpack("!I", e_index)[0]
        index = raw_index & 0x7FFFFFFF
        self._replay_check(self._rtcp_replay, index)
        if not raw_index & 0x80000000:  # E=0: payload was never encrypted
            return enc
        ssrc = struct.unpack_from("!I", enc, 4)[0]
        iv = self._keystream_iv(self.rtcp_salt, ssrc, index)
        dec = Cipher(self._rtcp_aes, modes.CTR(iv)).encryptor()
        return enc[:8] + dec.update(enc[8:]) + dec.finalize()


PROFILE_AES128_CM_SHA1_80 = 0x0001
PROFILE_AEAD_AES_128_GCM = 0x0007

# per-profile (master key bytes, master salt bytes) — sets the RFC 5764
# exporter length 2*(key+salt)
PROFILE_KEYING = {
    PROFILE_AES128_CM_SHA1_80: (16, 14),
    PROFILE_AEAD_AES_128_GCM: (16, 12),
}


class AeadSrtpContext:
    """One direction of an AEAD SRTP session (RFC 7714, AES-128-GCM).

    Same interface as :class:`SrtpContext`; the AEAD tag covers header AND
    payload in one pass (no separate HMAC), IVs are salt-XOR of
    (ssrc, roc, seq) per s8.1/s9.1."""

    TAG_LEN = 16

    def __init__(self, master_key: bytes, master_salt: bytes):
        if len(master_key) != 16 or len(master_salt) != 12:
            raise ValueError("AEAD_AES_128_GCM needs a 16-byte key + 12-byte salt")
        # RFC 7714 s12: same AES-CM KDF, labels 0/2 (rtp) and 3/5 (rtcp);
        # the 96-bit master salt is right-padded with 16 zero bits to the
        # KDF's 112-bit salt input.  NOTE: no independent SRTP-AEAD
        # implementation exists in this image to cross-validate the KDF
        # against (openssl interop covers only the DTLS keying export), so
        # the DTLS layer keeps AES128_CM_SHA1_80 FIRST in its preference
        # order until a real peer validates this profile end-to-end.
        kdf_salt = master_salt + b"\x00\x00"
        self.session_key = kdf(master_key, kdf_salt, LABEL_RTP_ENCRYPTION, 16)
        self.session_salt = kdf(master_key, kdf_salt, LABEL_RTP_SALT, 12)
        self.rtcp_key = kdf(master_key, kdf_salt, LABEL_RTCP_ENCRYPTION, 16)
        self.rtcp_salt = kdf(master_key, kdf_salt, LABEL_RTCP_SALT, 12)
        self._aead = AESGCM(self.session_key)
        self._aead_rtcp = AESGCM(self.rtcp_key)
        self._salt_int = int.from_bytes(self.session_salt, "big")
        self._roc: dict = {}
        self._rtcp_index = 0
        self._replay: dict = {}
        self._rtcp_replay = [-1, 0]

    _estimate_index = SrtpContext._estimate_index
    _replay_check = staticmethod(SrtpContext._replay_check)
    _payload_offset = staticmethod(SrtpContext._payload_offset)
    _frame_indexes = SrtpContext._frame_indexes

    def _iv(self, salt: bytes, ssrc: int, roc: int, seq: int) -> bytes:
        # 96-bit layout (s8.1): 00 00 | ssrc | roc | seq, XOR session salt
        raw = (ssrc << 48) | ((roc & 0xFFFFFFFF) << 16) | (seq & 0xFFFF)
        return (raw ^ int.from_bytes(salt, "big")).to_bytes(12, "big")

    def protect_frame(self, pkts) -> list[bytes]:
        """Frame-granular AEAD protect: indexes and IVs computed in one
        pass; the AEAD itself is per-packet (GCM needs one seal per
        distinct nonce) but rides the ONE cached AESGCM object.
        Byte-identical to N x ``protect``."""
        if not pkts:
            return []
        metas = self._frame_indexes(pkts)
        out = []
        seal = self._aead.encrypt
        salt_int = self._salt_int
        for pkt, (ssrc, seq, index) in zip(pkts, metas):
            off = self._payload_offset(pkt)
            raw = (ssrc << 48) | (((index >> 16) & 0xFFFFFFFF) << 16) | seq
            iv = (raw ^ salt_int).to_bytes(12, "big")
            hdr = bytes(pkt[:off])
            payload = pkt[off:]
            if not isinstance(payload, bytes):
                payload = bytes(payload)
            out.append(hdr + seal(iv, payload, hdr))
        return out

    def protect(self, pkt: bytes) -> bytes:
        return self.protect_frame((pkt,))[0]

    def unprotect(self, pkt: bytes) -> bytes:
        if len(pkt) < 12 + self.TAG_LEN:
            raise ValueError("short SRTP packet")
        if not isinstance(pkt, (bytes, bytearray)):
            pkt = bytes(pkt)
        ssrc = struct.unpack_from("!I", pkt, 8)[0]
        seq = struct.unpack_from("!H", pkt, 2)[0]
        index = self._estimate_index(ssrc, seq, update=False)
        off = self._payload_offset(pkt)
        iv = self._iv(self.session_salt, ssrc, index >> 16, seq)
        try:
            pt = self._aead.decrypt(iv, pkt[off:], pkt[:off])
        except Exception:
            raise ValueError("SRTP auth failure")
        self._replay_check(self._replay.setdefault(ssrc, [-1, 0]), index)
        self._estimate_index(ssrc, seq, update=True)
        return pkt[:off] + pt

    def protect_rtcp(self, pkt: bytes) -> bytes:
        if len(pkt) < 8:
            raise ValueError("short RTCP packet")
        ssrc = struct.unpack_from("!I", pkt, 4)[0]
        self._rtcp_index = (self._rtcp_index + 1) & 0x7FFFFFFF
        index = self._rtcp_index
        e_index = struct.pack("!I", index | 0x80000000)
        iv = self._rtcp_iv(ssrc, index)
        # AAD = RTCP header || E+index trailer (RFC 7714 s9.2)
        ct = self._aead_rtcp.encrypt(iv, pkt[8:], pkt[:8] + e_index)
        return pkt[:8] + ct + e_index

    def unprotect_rtcp(self, pkt: bytes) -> bytes:
        if len(pkt) < 8 + SRTCP_INDEX_LEN + self.TAG_LEN:
            raise ValueError("short SRTCP packet")
        if not isinstance(pkt, (bytes, bytearray)):
            pkt = bytes(pkt)
        e_index = pkt[-SRTCP_INDEX_LEN:]
        enc = pkt[8:-SRTCP_INDEX_LEN]
        raw_index = struct.unpack("!I", e_index)[0]
        index = raw_index & 0x7FFFFFFF
        ssrc = struct.unpack_from("!I", pkt, 4)[0]
        iv = self._rtcp_iv(ssrc, index)
        try:
            if raw_index & 0x80000000:  # E=1: encrypted + authenticated
                pt = self._aead_rtcp.decrypt(iv, enc, pkt[:8] + e_index)
            else:
                # E=0 (RFC 7714 s9.3): authenticated-only — the GCM tag
                # (GMAC) trails a PLAINTEXT payload, which rides as AAD
                pt = enc[: -self.TAG_LEN]
                self._aead_rtcp.decrypt(
                    iv, enc[-self.TAG_LEN :], pkt[:8] + pt + e_index
                )
        except Exception:
            raise ValueError("SRTCP auth failure")
        self._replay_check(self._rtcp_replay, index)
        return pkt[:8] + pt

    def _rtcp_iv(self, ssrc: int, index: int) -> bytes:
        raw = (
            b"\x00\x00"
            + struct.pack("!I", ssrc)
            + b"\x00\x00"
            + struct.pack("!I", index)
        )
        return bytes(a ^ b for a, b in zip(raw, self.rtcp_salt))


def keying_material_length(profile: int) -> int:
    key, salt = PROFILE_KEYING[profile]
    return 2 * (key + salt)


def derive_srtp_contexts(
    keying_material: bytes,
    is_server: bool,
    profile: int = PROFILE_AES128_CM_SHA1_80,
) -> tuple:
    """Split the DTLS-SRTP exporter output (RFC 5764 s4.2:
    client_key || server_key || client_salt || server_salt) into
    (tx_context, rx_context) for our role, sized and typed by profile."""
    key_len, salt_len = PROFILE_KEYING[profile]
    need = 2 * (key_len + salt_len)
    if len(keying_material) < need:
        raise ValueError(f"need {need} bytes of keying material")
    ck = keying_material[0:key_len]
    sk = keying_material[key_len : 2 * key_len]
    cs = keying_material[2 * key_len : 2 * key_len + salt_len]
    ss = keying_material[2 * key_len + salt_len : need]
    cls = (
        AeadSrtpContext
        if profile == PROFILE_AEAD_AES_128_GCM
        else SrtpContext
    )
    client, server = cls(ck, cs), cls(sk, ss)
    # the server SENDS with the server write key and receives client-keyed
    # packets (and vice versa)
    return (server, client) if is_server else (client, server)
