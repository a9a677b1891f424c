"""The port's media plane (ai_rtc_agent_tpu_torch/media/, the network ladder
of resilience/) against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through each module and
its JAX counterpart, and the outputs must be equal byte for byte: RTP
packets of the native, per-packet Python and batched packetizers (single
NALU, FU-A, STAP-A), the access units the depacketizer and reorder buffer
give back from shuffled and lossy packet orders, NullCodec's round trip,
H.264 through each ``H264Sink``/``H264RingSource``, RTCP SR/RR/NACK/PLI
bytes and their parse, reception statistics, the datagrams ``BatchSender``
and ``DatagramDrain`` deliver, the latest-wins ring, the GOP cache and the
netadapt ladder's rungs for one sequence of receiver reports.  The port's
C++ runtime is its own build of native/*.cpp (into build/); the JAX side
loads native/libtpurtc.so.
"""

import socket
import time

import numpy as np
import pytest

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.media import codec as JC
from ai_rtc_agent_tpu.media import gop as JG
from ai_rtc_agent_tpu.media import native as JN
from ai_rtc_agent_tpu.media import plane as JP
from ai_rtc_agent_tpu.media import ring as JRING
from ai_rtc_agent_tpu.media import rtcp as JRTCP
from ai_rtc_agent_tpu.media import rtp as JRTP
from ai_rtc_agent_tpu.media import sockio as JSOCK
from ai_rtc_agent_tpu.media.frames import VideoFrame as JFrame
from ai_rtc_agent_tpu.resilience import netadapt as JNA
from ai_rtc_agent_tpu.resilience import overload as JOV
from ai_rtc_agent_tpu_torch.media import codec as PC
from ai_rtc_agent_tpu_torch.media import gop as PG
from ai_rtc_agent_tpu_torch.media import native as PN
from ai_rtc_agent_tpu_torch.media import plane as PP
from ai_rtc_agent_tpu_torch.media import ring as PRING
from ai_rtc_agent_tpu_torch.media import rtcp as PRTCP
from ai_rtc_agent_tpu_torch.media import rtp as PRTP
from ai_rtc_agent_tpu_torch.media import sockio as PSOCK
from ai_rtc_agent_tpu_torch.media.frames import VideoFrame as PFrame
from ai_rtc_agent_tpu_torch.ops.kernels.build import BUILD_DIR
from ai_rtc_agent_tpu_torch.resilience import netadapt as PNA
from ai_rtc_agent_tpu_torch.resilience import overload as POV

MAX_PAYLOAD = 1200 - 12


def _au(rng, sizes, sc=4) -> bytes:
    """An annex-B access unit of NALs of ``sizes`` bytes (3- or 4-byte start codes)."""
    out = b""
    for i, s in enumerate(sizes):
        code = b"\x00\x00\x00\x01" if (i % 2 == 0 or sc == 4) else b"\x00\x00\x01"
        out += code + bytes([0x65 if s > 200 else 0x67])
        out += rng.integers(0, 256, s - 1, dtype=np.uint8).tobytes()
    return out


AU_SIZES = [([31], 4), ([31, 5001], 4), ([MAX_PAYLOAD], 4), ([MAX_PAYLOAD + 1], 4),
            ([1, 2, 3], 4), ([1190, 1188, 40], 4), ([20000], 4), ([12, 13, 1200, 9], 3)]


def _aus(seed=7):
    rng = np.random.default_rng(seed)
    return [_au(rng, sizes, sc) for sizes, sc in AU_SIZES]


@pytest.fixture(scope="module")
def runtimes():
    """Both C++ runtimes: the port's own build and the JAX package's library."""
    lib = PN.load()
    assert lib is not None, PN.load_error()
    assert JN.load() is not None
    return lib


def test_the_runtime_builds_into_build_and_writes_nothing_under_native(runtimes):
    path = PN.library_path()
    assert path.parent == BUILD_DIR and path.exists()
    assert runtimes._name == str(path)
    native_dir = PN.NATIVE_DIR
    assert sorted(p.name for p in native_dir.iterdir() if p.suffix in (".cpp", ".so")) == [
        "frame_ring.cpp", "h264.cpp", "libtpurtc.so", "rtp.cpp"]
    assert PN.SOURCES == ("frame_ring.cpp", "rtp.cpp", "h264.cpp")


def test_the_library_name_follows_the_sources(monkeypatch, tmp_path):
    for name in PN.SOURCES:
        (tmp_path / name).write_bytes((PN.NATIVE_DIR / name).read_bytes())
    monkeypatch.setattr(PN, "NATIVE_DIR", tmp_path)
    same = PN.library_path()
    (tmp_path / "rtp.cpp").write_bytes((tmp_path / "rtp.cpp").read_bytes() + b"\n")
    assert PN.library_path() != same and PN.library_path().parent == BUILD_DIR


def test_h264_availability_matches_jax(runtimes):
    assert PN.h264_available() == JN.h264_available()


# -- packetizers -------------------------------------------------------------------

PACKETIZERS = ["native", "python", "batched"]


@pytest.mark.parametrize("kind", PACKETIZERS)
@pytest.mark.parametrize("mtu", [1200, 600])
def test_packetizers_match_jax_byte_for_byte(runtimes, kind, mtu):
    def make(mod):
        if kind == "native":
            return mod.RtpPacketizer(ssrc=0xAB, payload_type=102, mtu=mtu)
        if kind == "python":
            return mod.PyRtpPacketizer(ssrc=0xAB, payload_type=102, mtu=mtu)
        return mod.BatchedRtpPacketizer(ssrc=0xAB, payload_type=102, mtu=mtu)

    port, jax_ = make(PRTP), make(JRTP)
    for i, au in enumerate(_aus()):
        got = [bytes(p) for p in port.packetize(au, 9000 + 3000 * i)]
        want = [bytes(p) for p in jax_.packetize(au, 9000 + 3000 * i)]
        assert got == want and got, i


@pytest.mark.parametrize("kind", ["python", "batched"])
def test_stap_a_matches_jax_and_roundtrips(runtimes, kind):
    cls = "PyRtpPacketizer" if kind == "python" else "BatchedRtpPacketizer"
    au = _au(np.random.default_rng(3), [9, 12, 3000, 7, 8])
    got = [bytes(p) for p in getattr(PRTP, cls)(stap_a=True).packetize(au, 111)]
    want = [bytes(p) for p in getattr(JRTP, cls)(stap_a=True).packetize(au, 111)]
    assert got == want and any(p[12] & 0x1F == PRTP.STAP_A for p in got)
    d = PRTP.RtpDepacketizer()
    out = [r for r in (d.push(p) for p in got) if r]
    d.close()
    assert out == [(b"".join(b"\x00\x00\x00\x01" + au[s:e] for s, e in PRTP.split_nals(au)), 111)]


def test_split_nals_and_pli_match_jax():
    for au in _aus():
        assert PRTP.split_nals(au) == JRTP.split_nals(au)
    assert PRTP.make_pli(5, 9) == JRTP.make_pli(5, 9)
    compound = PRTCP.make_rr(1, 2) + PRTP.make_pli(1, 2)
    assert PRTP.is_pli(compound) == JRTP.is_pli(compound) is True


def _orders(n, seed):
    """In order, shuffled within a window, and lossy (every 7th dropped)."""
    rng = np.random.default_rng(seed)
    shuffled = list(range(n))
    for i in range(0, n, 6):
        block = shuffled[i:i + 6]
        rng.shuffle(block)
        shuffled[i:i + 6] = block
    return {"in order": list(range(n)), "shuffled": shuffled,
            "lossy": [i for i in shuffled if i % 7 != 3]}


@pytest.mark.parametrize("order", ["in order", "shuffled", "lossy"])
def test_depacketizer_and_reorder_buffer_match_jax(runtimes, order):
    pk = PRTP.BatchedRtpPacketizer(mtu=600)
    pkts = [bytes(p) for i, au in enumerate(_aus(11)) for p in pk.packetize(au, 1000 + i)]
    seq = _orders(len(pkts), seed=5)[order]

    def run(mod):
        reorder, depkt, aus = mod.RtpReorderBuffer(), mod.RtpDepacketizer(), []
        for i in seq:
            for p in reorder.push(pkts[i]):
                got = depkt.push(p)
                if got is not None:
                    aus.append(got)
        depkt.close()
        return aus, reorder._next

    got, want = run(PRTP), run(JRTP)
    assert got == want and got[0][0]
    if order == "in order":  # the marker bit completes each AU
        assert [ts for _, ts in got[0]] == [1000 + i for i in range(len(AU_SIZES))]
    elif order == "shuffled":  # packets older than the first one seen are late: dropped
        assert len(got[0]) >= len(AU_SIZES) - 1


@pytest.mark.parametrize("shape", [(64, 64, 3), (48, 80, 3)])
def test_null_codec_roundtrips_as_jax(shape):
    arr = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    arr.reshape(-1)[:8] = [0, 0, 1, 0, 0, 0, 3, 1]  # start-code emulation the escaping must carry
    au = PC.NullCodec.encode(arr, pts=4242)
    assert au == JC.NullCodec.encode(arr, pts=4242)
    back, pts = PC.NullCodec.decode(au)
    assert pts == 4242 and np.array_equal(back, arr)


# -- the plane: sink and source ------------------------------------------------------

def _vframes(mod_frame, n, seed, shape=(64, 64, 3)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = mod_frame.from_ndarray(rng.integers(0, 256, shape, dtype=np.uint8))
        f.pts = 3000 * i
        out.append(f)
    return out


@pytest.mark.parametrize("use_h264", [False, True], ids=["nullcodec", "h264"])
def test_sink_packets_and_source_frames_match_jax(runtimes, use_h264):
    """Each sink encodes and packetizes the same frames; the packets, fed
    through each source, come back as the same frames.  x264 is
    deterministic here for one thread and one build: packets equal byte for
    byte; NullCodec is lossless, so its frames are the inputs."""
    if use_h264 and not PN.h264_available():
        pytest.skip("libavcodec not available")
    n = 6

    def run(plane, frame_mod):
        sink = plane.H264Sink(64, 64, use_h264=use_h264)
        src = plane.H264RingSource(64, 64, use_h264=use_h264)
        pkts, frames = [], []
        for f in _vframes(frame_mod, n, seed=9):
            batch = [bytes(p) for p in sink.consume(f)]
            pkts.append(batch)
            for p in batch:
                src.feed_packet(p)
                while (got := src.poll()) is not None:
                    frames.append((got[1], got[0].copy()))
        sink.close()
        src.close()
        return pkts, frames

    (p_pkts, p_frames), (j_pkts, j_frames) = run(PP, PFrame), run(JP, JFrame)
    assert p_pkts == j_pkts
    assert [p for p, _ in p_frames] == [p for p, _ in j_frames]
    for (_, a), (_, b) in zip(p_frames, j_frames):
        assert np.array_equal(a, b)
    if not use_h264:
        want = _vframes(PFrame, n, seed=9)
        assert [p for p, _ in p_frames][:n - 1] == [f.pts for f in want][:n - 1]
        for (pts, a), f in zip(p_frames, want):
            assert np.array_equal(a, f.to_ndarray())


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_sink_reconfigure_records_the_profile(runtimes, mod):
    plane = PP if mod == "port" else JP
    sink = plane.H264Sink(64, 64, use_h264=False)
    sink.reconfigure(bitrate=500_000, gop=30, fps=15, scale=2)
    assert sink.profile == {"bitrate": 500_000, "gop": 30, "fps": 15, "scale": 2}
    assert len(sink.consume(np.zeros((64, 64, 3), np.uint8))) >= 1
    sink.close()


# -- RTCP --------------------------------------------------------------------------------

NOW = 1_760_000_000.25
BLOCK = {"ssrc": 0x5EED, "fraction_lost": 25, "cumulative_lost": 7, "highest_seq": 1234,
         "jitter": 99, "lsr": 0, "dlsr": 0}

RTCP_CASES = {
    "sr": lambda m: m.make_sr(0x5EED, 90000, 42, 4242, now=NOW),
    "sr with a block": lambda m: m.make_sr(0xA, 1, 2, 3, now=NOW, report_blocks=[BLOCK]),
    "sr without sdes": lambda m: m.make_sr(1, 0, 0, 0, now=NOW, compound_sdes=False),
    "rr": lambda m: m.make_rr(0xABC, 0x5EED, fraction_lost=25, cumulative_lost=7,
                              highest_seq=1234, jitter=99),
    "nack": lambda m: m.make_nack(1, 2, [3, 5, 9, 100, 65535, 0]),
    "rr + pli": lambda m: m.make_rr(1, 2) + (PRTP if m is PRTCP else JRTP).make_pli(1, 2),
}


@pytest.mark.parametrize("case", list(RTCP_CASES))
def test_rtcp_bytes_and_parse_match_jax(case):
    got, want = RTCP_CASES[case](PRTCP), RTCP_CASES[case](JRTCP)
    assert got == want
    assert PRTCP.parse_compound(got) == JRTCP.parse_compound(want)
    assert PRTCP.is_rtcp(got) and JRTCP.is_rtcp(want)


def test_reception_stats_match_jax():
    """Seq gaps, duplicates, a wrap and a foreign SSRC: the same report blocks."""
    rng = np.random.default_rng(4)
    seqs = [s % 65536 for s in range(65500, 65700) if s % 9 != 4]
    seqs += seqs[10:14]  # duplicates
    stats = [PRTCP.ReceiverStats(), JRTCP.ReceiverStats()]
    blocks = [[], []]
    for i, seq in enumerate(seqs):
        ssrc = 0x1234 if i % 50 != 17 else 0x9999
        pkt = (bytes([0x80, 96]) + seq.to_bytes(2, "big") + (3000 * i).to_bytes(4, "big")
               + ssrc.to_bytes(4, "big") + rng.integers(0, 256, 20, dtype=np.uint8).tobytes())
        for s, out in zip(stats, blocks):
            s.received(pkt, arrival=100.0 + i / 30)
            if i % 40 == 39:
                out.append(s.report_block())
    assert blocks[0] == blocks[1] and blocks[0][-1]["cumulative_lost"] > 0


def test_retransmission_cache_matches_jax():
    caches = [PRTCP.RetransmissionCache(size=8), JRTCP.RetransmissionCache(size=8)]
    for seq in range(20):
        pkt = bytes([0x80, 96]) + seq.to_bytes(2, "big") + bytes(8) + bytes([seq])
        for c in caches:
            c.add(pkt, pkt[::-1])
    assert [caches[0].get(s) for s in range(20)] == [caches[1].get(s) for s in range(20)]
    assert len(caches[0]) == len(caches[1])


# -- sockets -----------------------------------------------------------------------------

def _udp_pair():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.setblocking(False)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.setblocking(False)
    return tx, rx, rx.getsockname()


def _recv_all(rx, n, timeout_s=2.0):
    got, t = [], time.monotonic()
    while len(got) < n and time.monotonic() - t < timeout_s:
        try:
            got.append(rx.recv(4096))
        except BlockingIOError:
            time.sleep(0.002)
    return got


@pytest.mark.parametrize("use_mmsg", [True, False], ids=["sendmmsg", "sendto"])
@pytest.mark.parametrize("connected", [False, True], ids=["addressed", "connected"])
def test_batch_sender_delivers_the_jax_datagrams(use_mmsg, connected):
    rng = np.random.default_rng(6)
    pkts = [rng.integers(0, 256, 40 + 37 * i, dtype=np.uint8).tobytes() for i in range(17)]
    pkts.append(memoryview(bytearray(b"\x99" * 70)))  # a pooled view
    pkts.append(b"\x01" * 3000)  # past the copy pool's slot: the pinned path
    received = []
    for mod in (PSOCK, JSOCK):
        tx, rx, addr = _udp_pair()
        try:
            if connected:
                tx.connect(addr)
            sent = mod.BatchSender(use_sendmmsg=use_mmsg).send(tx, pkts, None if connected else addr)
            assert sent == len(pkts)
            received.append(_recv_all(rx, len(pkts)))
        finally:
            tx.close()
            rx.close()
    assert received[0] == received[1] == [bytes(p) for p in pkts]


@pytest.mark.parametrize("slots,max_per_drain", [(8, 64), (4, 5)])
def test_datagram_drain_matches_jax(slots, max_per_drain):
    pkts = [bytes([i]) * (100 + 13 * i) for i in range(24)]
    received = []
    for mod in (PSOCK, JSOCK):
        tx, rx, addr = _udp_pair()
        try:
            for p in pkts:
                tx.sendto(p, addr)
            time.sleep(0.05)
            drain, got = mod.DatagramDrain(slots=slots, max_per_drain=max_per_drain), []
            while drain.drain(rx, lambda view, a: got.append(bytes(view))):
                pass
            received.append(got)
        finally:
            tx.close()
            rx.close()
    assert received[0] == received[1] == pkts


# -- ring, GOP cache, frame stats --------------------------------------------------------

@pytest.mark.parametrize("native_ring", [True, False], ids=["native", "python"])
def test_latest_wins_ring_matches_jax(runtimes, monkeypatch, native_ring):
    if not native_ring:
        monkeypatch.setattr(PN, "load", lambda: None)
        monkeypatch.setattr(JN, "load", lambda: None)
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (6, 5, 3), dtype=np.uint8) for _ in range(9)]
    outs = []
    for mod in (PRING, JRING):
        ring, got = mod.FrameRing((6, 5, 3), n_slots=4), []
        for i, f in enumerate(frames):
            ring.push_latest(f, meta=i)
            if i % 4 == 3:
                got.append(ring.pop())
        while (item := ring.pop()) is not None:
            got.append(item)
        outs.append(([m for _, m in got], [a.copy() for a, _ in got], ring.dropped, ring.size))
        ring.close()
        assert ring.pop() is None
    assert outs[0][0] == outs[1][0] and outs[0][2:] == outs[1][2:]
    assert all(np.array_equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_gop_cache_policy_matches_jax():
    rng = np.random.default_rng(12)
    idr = b"\x00\x00\x00\x01\x67" + bytes(8) + b"\x00\x00\x00\x01\x65" + rng.bytes(300)
    delta = [b"\x00\x00\x00\x01\x41" + rng.bytes(200 + 50 * i) for i in range(12)]
    null_au = PC.NullCodec.encode(np.zeros((4, 4, 3), np.uint8), pts=1)
    stream = [delta[0], idr] + delta[1:6] + [null_au, idr] + delta[6:]
    caches = [PG.GopCache(max_aus=6, max_bytes=4000), JG.GopCache(max_aus=6, max_bytes=4000)]
    trace = [[], []]
    for ts, au in enumerate(stream):
        for c, t in zip(caches, trace):
            t.append((c.add(au, ts), c.aus, c.bytes, c.idrs, c.overflows,
                      [bytes(a) for a, _ in c.snapshot()]))
    assert trace[0] == trace[1]
    assert [PG.au_is_idr(a) for a in stream] == [JG.au_is_idr(a) for a in stream]


def test_stage_snapshot_us_and_gauges_match_jax():
    from ai_rtc_agent_tpu.utils.profiling import FrameStats as JStats
    from ai_rtc_agent_tpu_torch.utils.profiling import FrameStats as PStats

    stats = [PStats(window=16), JStats(window=16)]
    for s in stats:
        for i in range(20):
            s.record_stage("packetize", 1e-6 * (i % 7 + 1))
            s.record_stage("send", 2e-6 * i)
        s.count("tx_packets", 40)
        s.gauge("rr_jitter", 12)
    assert stats[0].stage_snapshot_us(("packetize", "send")) == stats[1].stage_snapshot_us(
        ("packetize", "send"))
    assert stats[0].snapshot()["rr_jitter"] == stats[1].snapshot()["rr_jitter"] == 12


# -- the network ladder ---------------------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _rr_sequence(seed):
    """Receiver reports of a link that goes lossy, recovers and flaps."""
    rng = np.random.default_rng(seed)
    loss = [0] * 4 + [int(x) for x in rng.integers(40, 160, 14)] + [0] * 30
    loss += [int(x) for x in rng.integers(0, 60, 20)] + [0] * 40
    return [{"ssrc": 1, "fraction_lost": f, "jitter": int(rng.integers(5, 400))} for f in loss]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("joined", [True, False], ids=["joined", "alone"])
def test_netadapt_walks_the_jax_rungs(seed, joined):
    """One RR sequence (and NACK/PLI feedback) through each ladder, joined
    to a compute ladder or alone: the same rung, effective rung, profile
    and snapshot after every tick."""
    traces = []
    for na_mod, ov_mod in ((PNA, POV), (JNA, JOV)):
        clock = Clock()
        compute = None
        if joined:
            adm = ov_mod.AdmissionController(step_budget_s=1.0, lag_budget_s=0.2, clock=clock)
            compute = ov_mod.OverloadLadder("s", adm, None, clock=clock)
        na = na_mod.NetworkAdaptLadder("s", up_after=2, down_after=4, base_bitrate=3_000_000,
                                       min_bitrate=250_000, rr_timeout_s=1e9,
                                       compute_ladder=compute, clock=clock)
        applied = []
        na.apply = applied.append
        trace = []
        for i, rr in enumerate(_rr_sequence(seed)):
            na.on_receiver_report(rr)
            if i % 5 == 2:
                na.on_tx_feedback(nacks=3, plis=1)
            clock.t += 0.25
            na.tick()
            trace.append((na.rung, compute.effective_rung if compute else None, na.profile(),
                          na.snapshot()))
        traces.append((trace, applied))
    assert traces[0] == traces[1]
    assert max(t[0] for t in traces[0][0]) > 0


def test_keyframe_governor_matches_jax():
    outs = []
    for mod in (PNA, JNA):
        clock = Clock()
        gov = mod.KeyframeGovernor(coalesce_s=0.7, clock=clock)
        out = []
        for i in range(40):
            clock.t += 0.1
            if i == 20:
                gov.interval_s = 0.5
            out.append((gov.request(), gov.periodic_due()))
        outs.append(out)
    assert outs[0] == outs[1]


def test_overload_plane_registers_the_network_ladder_as_jax(monkeypatch):
    """register_netadapt joins the session's compute ladder, ticks with the
    plane, shows in the snapshot under the JAX keys and goes with the
    session; NETADAPT=0 registers none."""
    outs = []
    for mod in (POV, JOV):
        plane = mod.OverloadControlPlane(clock=Clock())
        plane.register_session("a")
        na = plane.register_netadapt("a")
        for _ in range(6):
            na.on_receiver_report({"ssrc": 1, "fraction_lost": 200, "jitter": 9})
            plane.tick()
        snap = plane.snapshot()
        keys = sorted(k for k in snap if k.startswith("netadapt"))
        outs.append((na.rung, plane.ladders["a"].effective_rung, keys,
                     snap["netadapt_rung_max"], snap["netadapt_loss_ewma_max"]))
        plane.unregister_session("a")
        assert plane.netadapt == {}
    assert outs[0] == outs[1] and outs[0][0] > 0
    monkeypatch.setenv("NETADAPT", "0")
    assert POV.OverloadControlPlane().register_netadapt("b") is None
