"""The broadcast fan-out plane (server/broadcast.py, the per-viewer header
rewrite of media/rtp.py, the grouped burst of media/sockio.py) of the port
against the JAX package's, on the CPU.

Each scenario of tests/test_broadcast.py runs on both packages (the ``pkg``
fixture, one case per root): the rewrite's wire identity for the three
packet shapes, header-only patching, the identity fast path and its desync,
the shared gather plan, pooled views under the fault injector, the GOP
cache's membership, stabilization and overflow, the PLI storm (one replay,
no engine or encoder work), group fan-out with PT patching, the grouped
``sendmmsg`` burst's iovec reuse and name rewriting, and the /whep viewer
cap with its gauges.  Left out: the GOP cache's IDR boundary detection,
which ``test_gop_cache_policy_matches_jax`` of tests/test_torch_media.py
already holds across the packages (NullCodec, NAL 5 and NAL 1 AUs).

Across the packages: the port's rewritten bytes equal the JAX package's for
the same packets, and a secure (DTLS-SRTP) WHEP viewer joins its publisher's
group and receives the processed frames under SRTP on both.
"""

import asyncio
import importlib
import json
import socket
from types import SimpleNamespace

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

ROOTS = {"jax": "ai_rtc_agent_tpu", "torch": "ai_rtc_agent_tpu_torch"}

rng = np.random.default_rng(17)


def _load(root: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    rtp = mod("media.rtp")
    return SimpleNamespace(
        root=root, native=mod("media.native"), NullCodec=mod("media.codec").NullCodec,
        GopCache=mod("media.gop").GopCache, BatchedRtpPacketizer=rtp.BatchedRtpPacketizer,
        RtpHeaderRewriter=rtp.RtpHeaderRewriter, RtpReorderBuffer=rtp.RtpReorderBuffer,
        RtpDepacketizer=rtp.RtpDepacketizer, split_nals=rtp.split_nals,
        BatchSender=mod("media.sockio").BatchSender, faults=mod("resilience.faults"),
        BroadcastGroup=mod("server.broadcast").BroadcastGroup, agent=mod("server.agent"),
        rtc_native=mod("server.rtc_native"), rtp_client=mod("media.rtp_client"),
        frames=mod("media.frames"), plane=mod("media.plane"),
    )


@pytest.fixture(params=list(ROOTS), ids=list(ROOTS))
def pkg(request):
    return _load(ROOTS[request.param])


def _mkau(sizes, sc=4):
    au = b""
    for i, s in enumerate(sizes):
        code = b"\x00\x00\x00\x01" if (i % 2 == 0 or sc == 4) else b"\x00\x00\x01"
        au += (code + bytes([0x65 if s > 200 else 0x67])
               + rng.integers(0, 256, s - 1, dtype=np.uint8).tobytes())
    return au


def _traw_idr(pkg, n=64):
    """A NullCodec-tier access unit (all intra: an IDR boundary)."""
    return b"\x00\x00\x00\x01" + pkg.NullCodec.MAGIC + bytes(range(256))[:n]


def _delta_au(n=64):
    """A non-IDR H264 AU (NAL type 1, a coded slice of a non-IDR picture)."""
    return b"\x00\x00\x00\x01" + bytes([0x61]) + b"\x42" * n


SHAPES = [(_mkau([31]), False), (_mkau([31, 5001]), False), (_mkau([9, 12, 3000, 7, 8]), True)]
SHAPE_IDS = ["single-nal", "fu-a", "stap-a"]


# -- the header rewrite's wire identity -------------------------------------------------

@pytest.mark.parametrize("au,stap", SHAPES, ids=SHAPE_IDS)
def test_rewrite_wire_identity(pkg, au, stap):
    """A rewritten frame equals a dedicated packetize of the same AU byte for
    byte: SSRC, seq space, ts offset and PT are the only fields a viewer
    owns; marker bits, FU-A framing and STAP-A layout go through the copy."""
    src = pkg.BatchedRtpPacketizer(ssrc=0x5EED, payload_type=96, stap_a=stap)
    ded = pkg.BatchedRtpPacketizer(ssrc=0xBEEF, payload_type=102, stap_a=stap)
    ded.seq = 777
    rw = pkg.RtpHeaderRewriter(ssrc=0xBEEF, payload_type=102, seq0=777, ts_offset=1234)
    for i in range(3):  # seq continuity across frames too
        ts = 9000 + i * 3000
        pkts = src.packetize(au, ts)
        want = ded.packetize(au, (ts + 1234) & 0xFFFFFFFF)
        got = rw.rewrite(pkts)
        assert [bytes(p) for p in got] == [bytes(p) for p in want], i
    assert rw.seq == ded.seq


def test_rewrite_touches_only_header_fields(pkg):
    """With seq, ts, SSRC and PT masked on both sides, source and rewritten
    packets are equal byte for byte."""
    src = pkg.BatchedRtpPacketizer(ssrc=0x5EED, payload_type=96)
    rw = pkg.RtpHeaderRewriter(ssrc=0xBEEF, payload_type=102, seq0=9, ts_offset=7)
    pkts = src.packetize(_mkau([31, 5001]), 12345)
    out = rw.rewrite(pkts)
    for a, b in zip(pkts, out):
        a, b = bytearray(bytes(a)), bytearray(bytes(b))
        for buf in (a, b):
            buf[1] = buf[1] & 0x80  # PT (the marker bit kept)
            buf[2:12] = bytes(10)  # seq + ts + ssrc
        assert a == b


def test_rewrite_identity_fast_path_and_desync(pkg):
    """An aligned viewer (same SSRC and PT, its seq cursor at the source's)
    gets the source views back with no copy; a desynced cursor drops it to
    the copying path for good."""
    src = pkg.BatchedRtpPacketizer(ssrc=0x5EED, payload_type=96)
    rw = pkg.RtpHeaderRewriter(ssrc=0x5EED, seq0=src.seq)
    for i in range(2):
        pkts = src.packetize(_mkau([31, 3000]), i * 3000)
        assert rw.aligned(pkts)
        out = rw.rewrite(pkts)
        assert all(o is p for o, p in zip(out, pkts))  # the very objects
        assert rw.seq == src.seq  # the cursor advanced in lockstep
    rw.seq = (rw.seq + 5) & 0xFFFF  # a GOP replay desyncs the cursor
    pkts = src.packetize(_mkau([31]), 9000)
    assert not rw.aligned(pkts)
    out = rw.rewrite(pkts)
    assert out[0] is not pkts[0]
    assert bytes(out[0])[4:] == bytes(pkts[0])[4:]  # ts + ssrc + payload equal
    assert bytes(out[0])[2:4] != bytes(pkts[0])[2:4]  # its own seq space


def test_rewrite_plan_shared_across_viewers(pkg):
    """fan_out computes plan() once a frame; each copying viewer given it
    writes the bytes of a rewrite on its own."""
    src = pkg.BatchedRtpPacketizer(ssrc=0x5EED, payload_type=96)
    pkts = src.packetize(_mkau([31, 5001, 12]), 3000)
    a = pkg.RtpHeaderRewriter(ssrc=0xA, seq0=1)
    b = pkg.RtpHeaderRewriter(ssrc=0xB, seq0=2, ts_offset=99)
    a2 = pkg.RtpHeaderRewriter(ssrc=0xA, seq0=1)
    b2 = pkg.RtpHeaderRewriter(ssrc=0xB, seq0=2, ts_offset=99)
    plan = a.plan(pkts)
    assert [bytes(p) for p in a.rewrite(pkts, plan)] == [bytes(p) for p in a2.rewrite(pkts)]
    assert [bytes(p) for p in b.rewrite(pkts, plan)] == [bytes(p) for p in b2.rewrite(pkts)]


def test_rewrite_pooled_views_survive_fault_injector(pkg):
    """Rewritten views pushed through a reorder plan (the reorder buffer
    holds packets while the rewriter's 2-slot pool wraps) still reassemble
    every AU byte for byte."""
    if pkg.native.load() is None:
        pytest.skip("native lib unavailable (depacketizer half)")
    faults = pkg.faults
    plan = faults.FaultPlan(
        # start=1: the first packet passes clean so the reorder buffer syncs
        # its cursor to the true seq0; every later pair is swapped
        specs=(faults.FaultSpec(target="rx", kind="reorder", p=1.0, start=1),),
        seed=3,
    )
    faults.activate(plan)
    try:
        scope = faults.scope("rx")
        src = pkg.BatchedRtpPacketizer(ssrc=0x5EED, mtu=600, pool_slots=2)
        rw = pkg.RtpHeaderRewriter(ssrc=0x7777, seq0=0, pool_slots=2)
        rb = pkg.RtpReorderBuffer()
        d = pkg.RtpDepacketizer()
        aus = [_mkau([31, 5001]), _mkau([1400, 40]), _mkau([2000]),
               _mkau([12, 13, 1200, 9], sc=3)]
        # a trailing AU: the scope may end a burst still holding the last
        # packet; only the first len(aus) outputs are asserted
        feed = aus + [_mkau([25])]
        got = []
        try:
            for ci, au in enumerate(feed):
                for p in rw.rewrite(src.packetize(au, 1000 + ci)):
                    for data, _delay in scope.apply(p):
                        for pkt in rb.push(data):
                            r = d.push(pkt)
                            if r is not None:
                                got.append(r)
        finally:
            d.close()
        assert scope.stats["reorder"] > 0  # the plan fired
        want = [(b"".join(b"\x00\x00\x00\x01" + au[s:e] for s, e in pkg.split_nals(au)), 1000 + ci)
                for ci, au in enumerate(aus)]
        assert [(bytes(a), ts) for a, ts in got[:len(aus)]] == want
    finally:
        faults.deactivate()


@pytest.mark.parametrize("au,stap", SHAPES, ids=SHAPE_IDS)
def test_rewritten_bytes_match_jax(au, stap):
    """The same source packets through each package's rewriter (a copying
    viewer with its own PT and ts offset, a second sharing its gather plan,
    an aligned one) give the same bytes, frame after frame."""
    outs = []
    for root in ROOTS.values():
        p = _load(root)
        src = p.BatchedRtpPacketizer(ssrc=0x5EED, payload_type=96, stap_a=stap)
        views = [p.RtpHeaderRewriter(ssrc=0xBEEF, payload_type=111, seq0=65530, ts_offset=4321),
                 p.RtpHeaderRewriter(ssrc=0xC0DE, seq0=3),
                 p.RtpHeaderRewriter(ssrc=0x5EED, seq0=src.seq)]
        frames = []
        for i in range(3):
            pkts = src.packetize(au, 0xFFFFF000 + 3000 * i)
            plan = views[0].plan(pkts)
            frames.append([[bytes(x) for x in rw.rewrite(pkts, None if rw.aligned(pkts) else plan)]
                           for rw in views])
        outs.append((frames, [rw.seq for rw in views]))
    assert outs[0] == outs[1]


# -- the GOP cache ----------------------------------------------------------------------

def test_gop_cache_gop_membership_and_stabilization(pkg):
    c = pkg.GopCache(max_aus=16)
    idr = _traw_idr(pkg)
    assert not c.add(_delta_au(), 0)  # mid-GOP, no IDR yet: stays empty
    assert c.aus == 0
    assert c.add(idr, 100)
    c.add(_delta_au(), 200)
    c.add(_delta_au(), 300)
    assert c.aus == 3 and c.idrs == 1
    # a new IDR starts a new GOP: the old one is gone
    assert c.add(idr, 400)
    assert c.aus == 1 and c.idrs == 2
    assert c.snapshot() == [(idr, 400)]
    # add() keeps bytes: this IDR view becomes the new GOP head, then its
    # backing is scribbled
    backing = bytearray(idr)
    c.add(memoryview(backing), 500)
    backing[:] = b"\x00" * len(backing)
    assert c.snapshot() == [(idr, 500)]


def test_gop_cache_overflow_clears_whole_and_rearms(pkg):
    idr = _traw_idr(pkg)
    c = pkg.GopCache(max_aus=3)
    c.add(idr, 0)
    c.add(_delta_au(), 1)
    c.add(_delta_au(), 2)
    assert c.aus == 3 and c.overflows == 0
    c.add(_delta_au(), 3)  # the 4th AU: the GOP outgrew the cache
    assert c.aus == 0 and c.overflows == 1  # cleared whole
    c.add(_delta_au(), 4)  # still mid-GOP: stays empty
    assert c.aus == 0
    assert c.add(idr, 5)  # the next boundary re-arms
    assert c.aus == 1

    b = pkg.GopCache(max_bytes=len(idr) + 10)
    b.add(idr, 0)
    b.add(_delta_au(), 1)  # the byte bound exceeded
    assert b.aus == 0 and b.overflows == 1


# -- BroadcastGroup: fan-out and the PLI storm --------------------------------------------

def _counts(group):
    snap = group.stats.stage_snapshot_us()
    return {k: v for k, v in snap.items() if k.endswith("_total")}


def _rx_sock():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.setblocking(False)
    return rx


def test_pli_storm_one_idr_zero_engine_steps(pkg):
    """A PLI storm from 16 viewers: exactly one granted re-sync (a GOP cache
    replay) and no engine or encoder work (no sink exists, the upstream
    escalation hook is never called)."""
    async def go():
        group = pkg.BroadcastGroup("pub", width=8, height=8, coalesce_s=60.0)
        await group.start()  # AU mode: no track, no sink, no engine
        engine_calls = []
        group.idr_fallback = lambda: engine_calls.append(1)
        rx = _rx_sock()
        try:
            group.feed_au(_traw_idr(pkg), 0)
            group.feed_au(_delta_au(), 3000)
            for i in range(16):
                group.add_viewer(f"v{i}", addr=rx.getsockname())
            assert group.viewer_count == 16
            replays0 = _counts(group).get("broadcast_gop_replays_total", 0)
            granted0 = group.governor.granted
            for i in range(16):
                group.on_viewer_pli(viewer_id=f"v{i}")
            c = _counts(group)
            assert group.governor.granted - granted0 == 1
            assert c.get("broadcast_gop_replays_total", 0) - replays0 == 1
            assert c.get("broadcast_pli_coalesced_total", 0) == 15
            assert c.get("broadcast_pli_total", 0) == 16
            assert group._sink is None
            assert c.get("broadcast_encoder_idr_total", 0) == 0
            assert engine_calls == []
        finally:
            rx.close()
            await group.close()

    asyncio.run(go())


async def _drain(rx, n):
    got = []
    for _ in range(100):
        try:
            while True:
                got.append(rx.recv(4096))
        except BlockingIOError:
            if len(got) >= n:
                break
            await asyncio.sleep(0.01)
    return got


def test_group_fan_out_delivers_and_patches_pt(pkg):
    """AU-mode fan-out: each viewer's wire bytes equal a dedicated
    packetizer's in that viewer's own seq and PT space; the join replay and
    the live traffic are one continuous stream per viewer."""
    async def go():
        group = pkg.BroadcastGroup("pub", width=8, height=8, coalesce_s=60.0)
        await group.start()
        rxs = [_rx_sock(), _rx_sock()]
        idr = _traw_idr(pkg)
        try:
            group.feed_au(idr, 0)  # arms the cache (group seq 0)
            group.add_viewer("plain", addr=rxs[0].getsockname())
            group.add_viewer("pt102", addr=rxs[1].getsockname(), payload_type=102)
            # each join replayed the cached GOP (group seq 1, then 2); one
            # live AU now (group seq 3)
            group.feed_au(_delta_au(), 3000)
            # "plain" joined at group seq 1, aligned through its replay,
            # then in its own seq space: a dedicated packetizer from seq 1
            ref = pkg.BatchedRtpPacketizer(ssrc=0x5EED, payload_type=96)
            ref.seq = 1
            want_plain = [bytes(p) for p in ref.packetize(idr, 0)]
            want_plain += [bytes(p) for p in ref.packetize(_delta_au(), 3000)]
            # "pt102" joined one replay later (seq 2) with its own PT: the
            # copying path throughout
            ded = pkg.BatchedRtpPacketizer(ssrc=0x5EED, payload_type=102)
            ded.seq = 2
            want_pt = [bytes(p) for p in ded.packetize(idr, 0)]
            want_pt += [bytes(p) for p in ded.packetize(_delta_au(), 3000)]
            got_plain = await _drain(rxs[0], len(want_plain))
            got_pt = await _drain(rxs[1], len(want_pt))
            assert got_plain == want_plain
            assert got_pt == want_pt
            assert all(g[1] & 0x7F == 102 for g in got_pt)
            snap = group.snapshot()
            assert snap["viewers"] == 2 and snap["gop_idrs"] == 1
        finally:
            for rx in rxs:
                rx.close()
            await group.close()

    asyncio.run(go())


# -- the grouped sendmmsg burst ---------------------------------------------------------

def _drain_sync(rx, n):
    return asyncio.run(_drain(rx, n))


def test_send_grouped_duplicate_batch_iovec_reuse(pkg):
    """Aligned viewers hand send_grouped the same packet list object: every
    destination still gets full, correct bytes (the duplicates' iovecs are
    word-copied from the first staging), and the next burst's new bytes do
    not leak the previous staging."""
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.setblocking(False)
    rx1, rx2, rx3 = _rx_sock(), _rx_sock(), _rx_sock()
    try:
        sender = pkg.BatchSender(use_sendmmsg=True)
        shared = [b"A" * 100, b"B" * 700, b"C" * 33]
        other = [b"D" * 50]
        batches = [(shared, rx1.getsockname()), (shared, rx2.getsockname()),
                   (other, rx3.getsockname())]
        assert sender.send_grouped(tx, batches) == 7
        assert _drain_sync(rx1, 3) == shared
        assert _drain_sync(rx2, 3) == shared
        assert _drain_sync(rx3, 1) == other
        # the same layout, new bytes: the span check skips only the
        # msg_name writes, never the staging of the bytes
        shared2 = [b"x" * 100, b"y" * 700, b"z" * 33]
        batches2 = [(shared2, rx1.getsockname()), (shared2, rx2.getsockname()),
                    (other, rx3.getsockname())]
        assert sender.send_grouped(tx, batches2) == 7
        assert _drain_sync(rx1, 3) == shared2
        assert _drain_sync(rx2, 3) == shared2
    finally:
        for s in (tx, rx1, rx2, rx3):
            s.close()


def test_send_grouped_then_uniform_send_rewrites_names(pkg):
    """A grouped burst leaves per-entry msg_names behind; the next
    one-destination send() must not spray packets at old viewer addresses."""
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.setblocking(False)
    rx1, rx2 = _rx_sock(), _rx_sock()
    try:
        sender = pkg.BatchSender(use_sendmmsg=True)
        sender.send_grouped(tx, [([b"g" * 20], rx1.getsockname()),
                                 ([b"h" * 20], rx2.getsockname())])
        _drain_sync(rx1, 1), _drain_sync(rx2, 1)
        pkts = [b"u%d" % i * 10 for i in range(4)]
        assert sender.send(tx, pkts, rx1.getsockname()) == 4
        assert _drain_sync(rx1, 4) == pkts
        assert _drain_sync(rx2, 0) == []
    finally:
        for s in (tx, rx1, rx2):
            s.close()


# -- /whep: viewers join the group, within the viewer cap ---------------------------------

class InvertPipeline:
    def __call__(self, frame):
        arr = frame if isinstance(frame, np.ndarray) else frame.to_ndarray()
        return 255 - arr


def _sdp(data):
    return {"data": data, "headers": {"Content-Type": "application/sdp"}}


def test_whep_broadcast_viewer_cap_and_gauges(pkg, monkeypatch):
    """The viewer's admission is BROADCAST_MAX_VIEWERS (503 with Retry-After
    past it), never an engine slot; /capacity, /health and /metrics carry
    the audience's gauges; a closed viewer frees its place."""
    if pkg.native.load() is None:
        pytest.skip("native lib unavailable")
    monkeypatch.setenv("WARMUP_FRAMES", "0")
    monkeypatch.setenv("BROADCAST_MAX_VIEWERS", "1")

    async def go():
        provider = pkg.rtc_native.NativeRtpProvider(use_h264=pkg.native.h264_available())
        app = pkg.agent.build_app(pipeline=InvertPipeline(), provider=provider)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/whip", **_sdp(json.dumps(
                {"native_rtp": True, "video": True, "width": 64, "height": 64})))
            assert r.status == 201

            def whep_offer(port):
                return json.dumps({"native_rtp": True, "video": False,
                                   "client_addr": ["127.0.0.1", port]})

            r = await client.post("/whep", **_sdp(whep_offer(39001)))
            assert r.status == 201
            loc = r.headers["Location"]
            groups = app["state"]["broadcast_groups"]
            assert sum(g.viewer_count for g in groups.values()) == 1
            r = await client.post("/whep", **_sdp(whep_offer(39002)))
            assert r.status == 503
            assert r.headers["Retry-After"] == "2"
            for path in ("/capacity", "/health"):
                b = (await (await client.get(path)).json())["broadcast"]
                assert b["broadcast_viewers"] == 1
                assert b["broadcast_max_viewers"] == 1
                assert b["broadcast_viewer_slots_free"] == 0
            m = await (await client.get("/metrics")).json()
            assert m["broadcast"]["broadcast_viewers"] == 1
            r = await client.delete(loc)  # closing the viewer frees its place
            assert r.status == 200
            r = await client.post("/whep", **_sdp(whep_offer(39003)))
            assert r.status == 201
        finally:
            await client.close()

    asyncio.run(go())


def test_secure_viewer_joins_the_group_and_receives_srtp(pkg, monkeypatch):
    """A DTLS-SRTP WHEP viewer of a plain native publisher joins the
    publisher's group (no sink of its own) and decodes, under SRTP, the
    frames the group encoded once: each the publisher's frame processed."""
    pytest.importorskip("cryptography")
    if pkg.native.load() is None:
        pytest.skip("native lib unavailable")
    from secure_client import SecureTestPeer, secure_offer

    monkeypatch.setenv("WARMUP_FRAMES", "0")
    monkeypatch.setenv("SUPERVISOR", "0")
    size = 64
    frames = [np.random.default_rng(40 + i).integers(0, 256, (size, size, 3), dtype=np.uint8)
              for i in range(6)]

    async def go():
        provider = pkg.rtc_native.NativeRtpProvider(default_width=size, default_height=size,
                                                    use_h264=False)
        app = pkg.agent.build_app(pipeline=InvertPipeline(), provider=provider)
        http = TestClient(TestServer(app))
        await http.start_server()
        pub = await pkg.rtp_client.NativeRtpClient(size, size, use_h264=False).open()
        peer = await SecureTestPeer("secure-viewer").open_socket()
        back = pkg.plane.H264RingSource(size, size, use_h264=False)
        got = {}
        try:
            r = await http.post("/whip", **_sdp(pub.offer_envelope()))
            assert r.status == 201
            await pub.connect(json.loads(await r.text())["server_port"])
            r = await http.post("/whep", **_sdp(secure_offer(peer.cert.fingerprint,
                                                             direction="recvonly")))
            assert r.status == 201
            await peer.establish(await r.text())
            (viewer,) = app["state"]["whep_pcs"].values()
            (group,) = app["state"]["broadcast_groups"].values()
            for i, arr in enumerate(frames):
                pub.send(arr, i)
                for _ in range(3000):
                    await asyncio.sleep(0.01)
                    pub.drain()
                    peer.drain_into(back)
                    while (item := back.poll()) is not None:
                        got[item[1]] = item[0].copy()
                    if len(got) > i:
                        break
            return got, viewer._sink, group.viewer_count, group.frames
        finally:
            back.close()
            peer.close()
            pub.close()
            await http.close()

    got, sink, viewers, fanned = asyncio.run(go())
    assert sink is None and viewers == 1 and fanned >= len(frames)
    step = 90_000 // 30
    assert sorted(got) == [step * i for i in range(len(frames))]
    for i, arr in enumerate(frames):
        assert np.array_equal(got[step * i], 255 - arr), i
