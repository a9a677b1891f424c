"""The port's secure tier (server/secure/: ICE-lite STUN, SRTP/SRTCP, DTLS
1.2, SCTP datachannels) against the JAX package's, on the CPU.

* STUN messages and the ICE-lite responder's answers, SRTP/SRTCP packets
  of both profiles for the same keys: equal byte for byte.
* A DTLS handshake completes between the port's endpoint and the JAX one in
  both roles, and both ends export the same SRTP keying material; an SCTP
  association opens a datachannel across the two implementations.
* Through the port's agent, with the JAX secure client of
  tests/secure_client.py (the browser's side): encrypted media makes a
  round trip, a datachannel config message reaches the session's
  pipeline, and a sha-384 fingerprint gets the JAX agent's 400.

Timing fences (the JAX tier's rate and soak tests) are not mirrored here.
"""

import asyncio
import struct

import numpy as np
import pytest

pytest.importorskip("cryptography")

from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from _torch_threads import few_torch_threads  # noqa: E402,F401  (autouse)
from ai_rtc_agent_tpu.server import agent as JA  # noqa: E402
from ai_rtc_agent_tpu.server import rtc_native as JRN  # noqa: E402
from ai_rtc_agent_tpu.server.secure import dtls as JD  # noqa: E402
from ai_rtc_agent_tpu.server.secure import sctp as JSCTP  # noqa: E402
from ai_rtc_agent_tpu.server.secure import srtp as JSRTP  # noqa: E402
from ai_rtc_agent_tpu.server.secure import stun as JSTUN  # noqa: E402
from ai_rtc_agent_tpu_torch.media.frames import VideoFrame  # noqa: E402
from ai_rtc_agent_tpu_torch.media.plane import H264RingSource, H264Sink  # noqa: E402
from ai_rtc_agent_tpu_torch.server import agent as PA  # noqa: E402
from ai_rtc_agent_tpu_torch.server import rtc_native as PRN  # noqa: E402
from ai_rtc_agent_tpu_torch.server.secure import dtls as PD  # noqa: E402
from ai_rtc_agent_tpu_torch.server.secure import sctp as PSCTP  # noqa: E402
from ai_rtc_agent_tpu_torch.server.secure import srtp as PSRTP  # noqa: E402
from ai_rtc_agent_tpu_torch.server.secure import stun as PSTUN  # noqa: E402
from secure_client import SecureTestPeer, secure_offer  # noqa: E402

SIZE = 64


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("WARMUP_FRAMES", "0")
    monkeypatch.setenv("SUPERVISOR", "0")
    for name in ("HW_ENCODE", "NVENC", "WEBRTC_PROVIDER"):
        monkeypatch.delenv(name, raising=False)


# -- STUN -------------------------------------------------------------------------------

def _binding_request(mod, ufrag, pwd, tid, use_candidate=True):
    msg = mod.StunMessage(mod.BINDING_REQUEST, transaction_id=tid)
    msg.attributes.append((mod.ATTR_USERNAME, f"{ufrag}:clientfrag".encode()))
    msg.attributes.append((mod.ATTR_PRIORITY, struct.pack("!I", 12345)))
    if use_candidate:
        msg.attributes.append((mod.ATTR_USE_CANDIDATE, b""))
    return msg.encode(integrity_key=pwd.encode())


@pytest.mark.parametrize("use_candidate", [True, False])
def test_stun_messages_and_ice_lite_answers_match_jax(use_candidate):
    tid = bytes(range(12))
    raws = [_binding_request(m, "srvu", "serverpassword0123456789", tid, use_candidate)
            for m in (PSTUN, JSTUN)]
    assert raws[0] == raws[1]
    replies = []
    for mod in (PSTUN, JSTUN):
        resp = mod.IceLiteResponder(ufrag="srvu", pwd="serverpassword0123456789")
        replies.append((resp.handle(raws[0], ("198.51.100.9", 50000)), resp.nominated_addr))
        assert resp.handle(_binding_request(mod, "srvu", "wrong", tid), ("1.2.3.4", 5)) is None
    assert replies[0] == replies[1] and replies[0][0] is not None
    back = PSTUN.StunMessage.decode(replies[0][0])
    assert back.xor_mapped_address() == ("198.51.100.9", 50000)
    assert PSTUN.StunMessage.xor_address_value("10.0.0.1", 3478) == \
        JSTUN.StunMessage.xor_address_value("10.0.0.1", 3478)


# -- SRTP / SRTCP ------------------------------------------------------------------------

def _rtp(seq, ssrc=0x1234, size=300, pt=102, seed=0):
    payload = np.random.default_rng(seed + seq).integers(0, 256, size, dtype=np.uint8).tobytes()
    return struct.pack("!BBHII", 0x80, pt, seq & 0xFFFF, 3000 * seq, ssrc) + payload


PROFILES = {"cm_sha1_80": PSRTP.PROFILE_AES128_CM_SHA1_80,
            "aead_aes_128_gcm": PSRTP.PROFILE_AEAD_AES_128_GCM}


@pytest.mark.parametrize("profile", list(PROFILES))
@pytest.mark.parametrize("is_server", [True, False], ids=["server", "client"])
def test_srtp_and_srtcp_bytes_match_jax(profile, is_server):
    prof = PROFILES[profile]
    assert prof == getattr(JSRTP, {"cm_sha1_80": "PROFILE_AES128_CM_SHA1_80",
                                   "aead_aes_128_gcm": "PROFILE_AEAD_AES_128_GCM"}[profile])
    km = np.random.default_rng(3).integers(0, 256, PSRTP.keying_material_length(prof),
                                           dtype=np.uint8).tobytes()
    (ptx, prx), (jtx, jrx) = (PSRTP.derive_srtp_contexts(km, is_server, prof),
                              JSRTP.derive_srtp_contexts(km, is_server, prof))
    pkts = [_rtp(s) for s in list(range(65530, 65536)) + list(range(0, 6))]  # a rollover
    assert [ptx.protect(p) for p in pkts[:6]] == [jtx.protect(p) for p in pkts[:6]]
    frame = [memoryview(p) for p in pkts[6:]]
    assert [bytes(w) for w in ptx.protect_frame(frame)] == [bytes(w) for w in jtx.protect_frame(frame)]
    rtcp = struct.pack("!BBHI", 0x80, 200, 6, 0x1234) + bytes(20)
    assert ptx.protect_rtcp(rtcp) == jtx.protect_rtcp(rtcp)
    # the other direction: the JAX sender's packets open with the port's receiver
    (_, peer_rx), (peer_tx, _) = (PSRTP.derive_srtp_contexts(km, not is_server, prof),
                                  JSRTP.derive_srtp_contexts(km, is_server, prof))
    assert [peer_rx.unprotect(peer_tx.protect(p)) for p in pkts] == pkts
    assert prx.unprotect_rtcp(JSRTP.derive_srtp_contexts(km, not is_server, prof)[0]
                              .protect_rtcp(rtcp)) == rtcp


def test_srtp_kdf_matches_jax():
    key, salt = bytes(range(16)), bytes(range(100, 114))
    for label in range(6):
        assert PSRTP.kdf(key, salt, label, 16) == JSRTP.kdf(key, salt, label, 16)


# -- DTLS and SCTP across the two implementations ------------------------------------------

def _pump(server, client, max_rounds=400):
    """Datagrams between two sans-IO endpoints until both are established."""
    inflight = [("s", d) for d in client.start()]
    for _ in range(max_rounds):
        if not inflight:
            break
        to, dgram = inflight.pop(0)
        target, back = (server, "c") if to == "s" else (client, "s")
        inflight.extend((back, d) for d in target.handle_datagram(dgram))
    return server, client


@pytest.mark.parametrize("server_mod,client_mod", [(PD, JD), (JD, PD)],
                         ids=["port server, jax client", "jax server, port client"])
def test_dtls_handshake_across_implementations(server_mod, client_mod):
    s_cert, c_cert = server_mod.generate_certificate("srv"), client_mod.generate_certificate("cli")
    server = server_mod.DtlsEndpoint("server", s_cert, request_client_cert=True,
                                     verify_fingerprint=c_cert.fingerprint)
    client = client_mod.DtlsEndpoint("client", c_cert, verify_fingerprint=s_cert.fingerprint)
    _pump(server, client)
    assert server.established and client.established, (server.failed, client.failed)
    assert server.srtp_profile == client.srtp_profile
    assert server.export_srtp_keying_material() == client.export_srtp_keying_material()
    # application data, client to server
    for d in client.send_application_data(b"hello from the client"):
        server.handle_datagram(d)
    assert server.recv_application_data() == [b"hello from the client"]


@pytest.mark.parametrize("server_mod,client_mod", [(PSCTP, JSCTP), (JSCTP, PSCTP)],
                         ids=["port server, jax client", "jax server, port client"])
def test_sctp_datachannel_across_implementations(server_mod, client_mod):
    got = []
    server = server_mod.SctpAssociation(
        "server", on_channel=lambda ch: None,
        on_message=lambda ch, msg: got.append((ch.label, msg)))
    client = client_mod.SctpAssociation("client")

    def deliver(pkts, to):
        queue = [(to, p) for p in pkts]
        while queue:
            who, p = queue.pop(0)
            target, other = (server, client) if who == "s" else (client, server)
            queue.extend(("c" if who == "s" else "s", r) for r in target.handle_packet(p))

    deliver(client.start(), "s")
    assert client.established and server.established
    ch, pkts = client.open_channel("config")
    deliver(pkts, "s")
    assert ch.readyState == "open"
    deliver(ch.send('{"prompt": "a lighthouse"}'), "s")
    assert got == [("config", '{"prompt": "a lighthouse"}')]


# -- through the port's agent ---------------------------------------------------------------

class Recorder:
    """Invert the frame; record runtime config calls."""

    def __init__(self):
        self.prompts = []

    def __call__(self, frame):
        arr = frame if isinstance(frame, np.ndarray) else frame.to_ndarray()
        return 255 - arr

    def update_prompt(self, p):
        self.prompts.append(p)

    def update_t_index_list(self, t):
        pass


async def _agent(mod, rtc, pipeline):
    provider = rtc.NativeRtpProvider(default_width=SIZE, default_height=SIZE, use_h264=False)
    app = mod.build_app(pipeline=pipeline, provider=provider)
    http = TestClient(TestServer(app))
    await http.start_server()
    return app, http


def test_encrypted_media_round_trips_through_the_port_agent():
    """/offer -> authenticated STUN -> DTLS 1.2 (the JAX client's certificate
    and fingerprint checks) -> SRTP-protected NullCodec frames up, the
    processed frames back under SRTP, each bit for bit."""
    async def go():
        app, http = await _agent(PA, PRN, Recorder())
        peer = await SecureTestPeer("browser-shaped-client").open_socket()
        sink = H264Sink(SIZE, SIZE, use_h264=False, payload_type=102)
        back = H264RingSource(SIZE, SIZE, use_h264=False)
        frames = [np.random.default_rng(i).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
                  for i in range(8)]
        got = {}
        try:
            r = await http.post("/offer", json={"room_id": "secure", "offer": {
                "sdp": secure_offer(peer.cert.fingerprint), "type": "offer"}})
            assert r.status == 200
            await peer.establish((await r.json())["sdp"])
            for i, arr in enumerate(frames + frames[-1:]):
                f = VideoFrame.from_ndarray(arr)
                f.pts = 3000 * i
                peer.send_rtp(sink.consume(f))
                for _ in range(3000):  # up to 30 s a frame on a loaded box
                    await asyncio.sleep(0.01)
                    peer.drain_into(back)
                    while (item := back.poll()) is not None:
                        got[item[1]] = item[0].copy()
                    if i < 1 or 3000 * (i - 1) in got:
                        break
            metrics = await (await http.get("/metrics")).json()
            return got, frames, metrics
        finally:
            sink.close()
            back.close()
            peer.close()
            await http.close()

    got, frames, metrics = asyncio.run(go())
    for i, arr in enumerate(frames[:-1]):
        assert np.array_equal(got[3000 * i], 255 - arr), i
    assert metrics["secure_sessions_total"] >= 1


def test_datachannel_config_reaches_the_port_agent():
    async def go():
        pipe = Recorder()
        app, http = await _agent(PA, PRN, pipe)
        peer = await SecureTestPeer("dc-client").open_socket()
        try:
            r = await http.post("/whip", data=secure_offer(peer.cert.fingerprint, direction="sendonly",
                                                           datachannel=True),
                                headers={"Content-Type": "application/sdp"})
            assert r.status == 201
            await peer.establish(await r.text())
            ch = await peer.open_datachannel("config")
            peer.dc_send(ch, '{"prompt": "a stained glass owl"}')
            for _ in range(600):
                await peer.drain_dc(0.05)
                if pipe.prompts:
                    break
            metrics = await (await http.get("/metrics")).json()
            return pipe.prompts, metrics
        finally:
            peer.close()
            await http.close()

    prompts, metrics = asyncio.run(go())
    assert prompts == ["a stained glass owl"]
    assert metrics["datachannels_total"] == 1 and metrics["datachannel_messages_total"] == 1


def test_sha384_offer_gets_the_jax_400():
    async def go(mod, rtc):
        app, http = await _agent(mod, rtc, Recorder())
        try:
            offer = secure_offer("AA:" * 47 + "AA").replace("sha-256", "sha-384")
            r = await http.post("/whip", data=offer, headers={"Content-Type": "application/sdp"})
            return r.status, await r.text(), len(app["pcs"])
        finally:
            await http.close()

    got, want = asyncio.run(go(PA, PRN)), asyncio.run(go(JA, JRN))
    assert got == want and got[0] == 400 and "sha-256" in got[1] and got[2] == 0
