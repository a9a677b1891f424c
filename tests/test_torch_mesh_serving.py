"""Port parity: the serving mesh (MESH_SHAPE, BATCHSCHED_DP, --tp/--sp,
ATTN_IMPL=ring|ulysses) against the JAX package on the CPU.

* The knobs: ``utils/env.py``'s parsing against the JAX functions on the
  same strings, error texts included.
* The dp session axis in one process: a port ``BatchScheduler(dp=2)`` whose
  two shards both sit on the CPU (``devices=["cpu", "cpu"]``, the stand-in
  for the JAX suite's 8 virtual devices) against the JAX ``BatchScheduler
  (dp=2)`` through a shard-crossing churn, and ``MultiPeerEngine`` on a dp=2
  mesh against the JAX one; the JAX states are carried across by
  ``bridge`` (noise never matches across frameworks).
* tp and sp serving: the tiny-test pipeline in gloo worlds of 2 ranks, each
  rank a ``tests/_torch_mesh_worker.py`` process on a free port (rank 0
  drives a ``LockstepEngine``, rank 1 ``follow``s), against the JAX engine
  on ``make_mesh(tp=2)`` / ``make_mesh(sp=2)`` (ring and Ulysses) and
  against the port's single-rank engine, with a prompt swap mid-stream.
* Refusals and composition: w8 on a tp mesh, DeepCache on dp and tp
  meshes, a dead follower, the carried-or-refused walk, the sp route's
  local case, and the agent's refusals, warnings and /health ``shard``.

Tolerances: the dp planes within 1 uint8 level of JAX (the rounding-tie
class of tests/test_torch_stream.py); the tp/sp worlds within 2 levels of
the JAX sharded engines and of the port's single-rank one, the JAX tests'
own bound for a sharded stream against a single one
(tests/test_stream.py: "same math modulo reduction order").
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import os
import subprocess
import sys
import time
from fractions import Fraction
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.aot.cache import mesh_key_extra as j_mesh_key_extra
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.parallel import mesh as JM
from ai_rtc_agent_tpu.parallel import sharding as JSH
from ai_rtc_agent_tpu.parallel.multipeer import MultiPeerEngine as JMultiPeerEngine
from ai_rtc_agent_tpu.server import agent as JA
from ai_rtc_agent_tpu.server import signaling as JS
from ai_rtc_agent_tpu.stream.engine import StreamEngine as JStreamEngine
from ai_rtc_agent_tpu.stream.scheduler import BatchScheduler as JBatchScheduler
from ai_rtc_agent_tpu.utils import env as JENV
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.aot.cache import mesh_key_extra
from ai_rtc_agent_tpu_torch.media import frames as PF
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.models import unet as PU
from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
from ai_rtc_agent_tpu_torch.parallel import mesh as PM
from ai_rtc_agent_tpu_torch.parallel import serving
from ai_rtc_agent_tpu_torch.parallel import sharding as PSH
from ai_rtc_agent_tpu_torch.parallel.multipeer import MultiPeerEngine
from ai_rtc_agent_tpu_torch.server import agent as PA
from ai_rtc_agent_tpu_torch.server import sessions as PSESS
from ai_rtc_agent_tpu_torch.server import signaling as PS
from ai_rtc_agent_tpu_torch.stream import engine as PENG
from ai_rtc_agent_tpu_torch.stream.engine import install_row
from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
from ai_rtc_agent_tpu_torch.utils import env as PENV

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_mesh_worker.py"
WORLD_LIMIT_S = 120  # wall limit of one spawned world (~10 s alone)
CPU2 = ["cpu", "cpu"]
N_FRAMES = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(n)]


def _levels(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _raised(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the text is what is compared
        return str(e)
    return "<nothing raised>"


# -- the knobs ------------------------------------------------------------------------------

MESH_SHAPES = ["8x1x1", "2,1", "", "1,2,2", "4", " 2 , 1 ", "1x2", "1,2,3,4", "a,b", "0,1",
               "2x-1"]


@pytest.mark.parametrize("value", MESH_SHAPES)
def test_mesh_shape_parses_as_jax(monkeypatch, value):
    monkeypatch.setenv("MESH_SHAPE", value)
    try:
        want = JENV.mesh_shape()
    except ValueError as e:
        assert _raised(PENV.mesh_shape) == str(e)
        return
    assert PENV.mesh_shape() == want


@pytest.mark.parametrize("dp,shape", [(None, None), (None, "4,1,1"), ("1", "2,1,1"),
                                      ("0", "2,1,1"), ("2", None), ("", "2x1x1"),
                                      ("3", "2,1,1"), ("x", None)])
def test_batchsched_dp_parses_as_jax(monkeypatch, dp, shape):
    """BATCHSCHED_DP wins when set (an explicit 0/1 is the per-box kill
    switch under a fleet-wide MESH_SHAPE), MESH_SHAPE's dp otherwise."""
    for name, value in (("BATCHSCHED_DP", dp), ("MESH_SHAPE", shape)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    try:
        want = JENV.batchsched_dp()
    except ValueError as e:
        assert _raised(PENV.batchsched_dp) == str(e)
        return
    assert PENV.batchsched_dp() == want


def test_attn_impl_knob(monkeypatch):
    """ATTN_IMPL: unset and pallas are the kernel route, ring and ulysses
    the sp routes (the config and its keys carry them), xla is refused at
    boot naming the kernel, an unknown value with the JAX registry's text."""
    monkeypatch.delenv("ATTN_IMPL", raising=False)
    assert PENV.attn_impl() == "kernel"
    assert PREG.default_stream_config("tiny-test", device="cpu").attn_impl == "kernel"
    for value, route in (("pallas", "kernel"), ("ring", "ring"), ("ulysses", "ulysses")):
        monkeypatch.setenv("ATTN_IMPL", value)
        assert PENV.attn_impl() == route
        assert PREG.default_stream_config("tiny-test", device="cpu").attn_impl == route
    monkeypatch.setenv("ATTN_IMPL", "xla")
    with pytest.raises(ValueError, match="flash-attention kernel"):
        PREG.default_stream_config("tiny-test", device="cpu")
    monkeypatch.setenv("ATTN_IMPL", "bogus")
    with pytest.raises(ValueError) as e:
        PREG.default_stream_config("tiny-test", device="cpu")
    assert str(e.value) == "ATTN_IMPL='bogus' unknown (xla | pallas | ring | ulysses)"


# -- the dp session axis --------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_bundle():
    return JREG.load_model_bundle("tiny-test")


@pytest.fixture(scope="module")
def port_params(jax_bundle):
    return bridge.params_from_jax(_np(jax_bundle.params))


@pytest.fixture(scope="module")
def port_bundle(port_params):
    return PREG.load_model_bundle("tiny-test", device="cpu", params=port_params)


def _port_sched(pb, cfg=None, **kw):
    kw.setdefault("max_sessions", 4)
    kw.setdefault("window_ms", 10_000.0)  # a step waits for every live session's frame
    return BatchScheduler(pb.stream_models, pb.params,
                          cfg or PREG.default_stream_config("tiny-test", device="cpu"),
                          pb.encode_prompt, device="cpu", **kw)


def _carry_row(js, ps, slot):
    """The JAX scheduler's state row of ``slot`` into the port's, in place."""
    row = bridge.state_from_jax(jax.tree.map(lambda a: np.asarray(a)[slot], js.states))
    sh, i = ps._row(slot)
    install_row(sh.states, i, row)


def test_dp2_scheduler_matches_the_jax_scheduler_through_a_churn():
    """Two sessions through a shard-crossing churn (the JAX suite's dp
    churn): claim, release, a rejoin that lands on shard 1, a prompt swap,
    a guidance update, restart and a release; every frame within 1 level
    of the JAX dp=2 scheduler's, the claims on the same slots and shards,
    and no build after prewarm (a devtel plane in its serving phase)."""
    from ai_rtc_agent_tpu_torch.obs import devtel
    from ai_rtc_agent_tpu_torch.obs.devtel import DevTelPlane

    jb = JREG.load_model_bundle("tiny-test")
    jcfg = JREG.default_stream_config("tiny-test")
    js = JBatchScheduler(jb.stream_models, jb.params, jcfg, jb.encode_prompt, max_sessions=4,
                         window_ms=10_000.0, prewarm=False, dp=2)
    pb = PREG.load_model_bundle("tiny-test", device="cpu",
                                params=bridge.params_from_jax(_np(jb.params)))
    plane = devtel.activate(DevTelPlane())
    ps = _port_sched(pb, dp=2, devices=CPU2)
    rng = np.random.default_rng(5)
    try:
        # prewarm built every (k, variant) on both shards, each under its dp-2 key
        builds = [c["context"] for c in plane.compiles]
        assert sorted(builds) == sorted(list(ps.bucket_keys().values()) * 2), builds
        plane.serving()

        def claim(key, prompt, seed):
            j, p = js.claim(key, prompt=prompt, seed=seed), ps.claim(key, prompt=prompt, seed=seed)
            assert p.slot == j.slot
            _carry_row(js, ps, p.slot)
            return j, p

        def tick(pairs):
            fs = [rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in pairs]
            outs = {}
            for side in (0, 1):
                hs = [pair[side].submit(f) for pair, f in zip(pairs, fs)]
                outs[side] = [pair[side].fetch(h) for pair, h in zip(pairs, hs)]
            for a, b in zip(outs[1], outs[0]):
                assert _levels(a, b) <= 1

        a = claim("a", "pa", 1)
        b = claim("b", "pb", 2)
        assert [a[1].slot, b[1].slot] == [0, 2]
        assert [x.snapshot()["shard"] for x in (a[1], b[1])] == [0, 1]
        tick([a, b])
        for x in b:
            x.release()
        tick([a])
        tick([a])
        b2 = claim("b2", "pb2", 9)  # rejoin -> shard 1
        assert ps._slot_shard(b2[1].slot) == 1
        tick([a, b2])
        for x in a:
            x.update_prompt("new prompt")
        for x in b2:
            x.update_guidance(guidance_scale=1.5)
        for x in a:
            x.restart()
        _carry_row(js, ps, a[1].slot)  # the restart's fresh noise is each framework's own
        tick([a, b2])
        for x in a:
            x.release()
        tick([b2])
        assert plane.retrace_breaches == 0
        assert ps.snapshot()["batchsched_shard_sessions"] == js.snapshot()[
            "batchsched_shard_sessions"] == {"0": 0, "1": 1}
    finally:
        devtel.deactivate(plane)
        js.close()
        ps.close()


def test_dp2_scheduler_plane_matches_jax(jax_bundle, port_bundle):
    """Bucket sizes [2, 4] at S=4 (dp multiples, never k=1), every key with
    ``dp-2`` and the same (k, variant) set as JAX's, the ``:dp2`` devtel
    labels, slot-major residence, the gauges, the health entry's ``shard``,
    least-loaded claims, and the ``multiple of the dp axis`` refusal."""
    jb, jcfg = jax_bundle, JREG.default_stream_config("tiny-test")
    js = JBatchScheduler(jb.stream_models, jb.params, jcfg, jb.encode_prompt, max_sessions=4,
                         window_ms=10_000.0, prewarm=False, dp=2)
    ps = _port_sched(port_bundle, dp=2, devices=CPU2, prewarm=False)
    try:
        assert ps.dp == js.dp == 2
        assert ps._bucket_sizes == js._bucket_sizes == [2, 4]
        jkeys, pkeys = js.bucket_keys("tiny-test"), ps.bucket_keys("tiny-test")
        assert set(pkeys) == set(jkeys) == {(2, "full"), (4, "full")}
        assert all("dp-2" in k for k in list(pkeys.values()) + list(jkeys.values()))
        assert mesh_key_extra(ps.mesh) == j_mesh_key_extra(js.mesh) == {"dp": 2}
        assert mesh_key_extra(None) == j_mesh_key_extra(None) == {}
        for k, v in jkeys:
            assert ps._bucket_label(k, v) == js._bucket_label(k, v)
        assert PSH.session_axis_spec(ps.mesh) == tuple(JSH.session_axis_spec(js.mesh)) == ("dp",)
        assert PSH.session_axis_spec(None) == tuple(JSH.session_axis_spec(JM.make_mesh())) == ()
        assert PSH.dp_devices(ps.mesh) == [torch.device("cpu")] * 2
        assert len(JSH.dp_devices(js.mesh)) == 2
        assert [ps._slot_shard(i) for i in range(4)] == [js._slot_shard(i) for i in range(4)]
        assert [list(r) for r in map(lambda d: PSH.shard_slots(d, 2, 4), range(2))] == [[0, 1],
                                                                                         [2, 3]]
        assert [ps._slot_device(i) for i in range(4)] == [torch.device("cpu")] * 4
        assert [tuple(s["noise"].shape[:1]) for s in ps.shard_states()] == [(2,), (2,)]
        jsess = [js.claim(f"s{i}", seed=i) for i in range(3)]
        psess = [ps.claim(f"s{i}", seed=i) for i in range(3)]
        assert [s.slot for s in psess] == [s.slot for s in jsess] == [0, 2, 1]
        assert ([s.snapshot() for s in psess] == [s.snapshot() for s in jsess])
        pm, jm = ps.snapshot(), js.snapshot()
        for key in ("batchsched_dp", "batchsched_shard_sessions", "batchsched_sessions"):
            assert pm[key] == jm[key], key
    finally:
        js.close()
        ps.close()
    want = _raised(lambda: JBatchScheduler(jb.stream_models, jb.params, jcfg, jb.encode_prompt,
                                           max_sessions=3, prewarm=False, dp=2))
    assert "multiple of the dp axis" in want
    assert _raised(lambda: _port_sched(port_bundle, dp=2, devices=CPU2, max_sessions=3)) == want
    # an engine on a tp/sp mesh keeps the shared pipeline: the scheduler refuses it
    from types import SimpleNamespace

    fake = SimpleNamespace(engine=SimpleNamespace(mesh=SimpleNamespace(
        shape={"dp": 1, "tp": 2, "sp": 1})))
    want = _raised(lambda: JBatchScheduler.from_pipeline(fake))
    assert "owns its own session-axis (dp) mesh" in want
    assert _raised(lambda: BatchScheduler.from_pipeline(fake)) == want
    # a dp=1 scheduler keeps its keys, labels and gauges exactly
    ps1 = _port_sched(port_bundle, prewarm=False, dp=1)
    try:
        assert ps1._bucket_sizes == [1, 2, 4] and ps1.mesh is None
        assert not any("dp-" in k for k in ps1.bucket_keys().values())
        assert ps1._bucket_label(2, "full") == "sbucket-2:full"
        assert "batchsched_shard_sessions" not in ps1.snapshot()
        assert "shard" not in ps1.claim("x").snapshot()
    finally:
        ps1.close()


def test_dp2_multipeer_matches_jax(jax_bundle, port_bundle):
    """MultiPeerEngine over a dp=2 mesh, peers slot-major per shard, each
    shard's rows staged onto its own device: every peer's frames within 1
    level of the JAX engine's on ``make_mesh(dp=2)``, a per-peer prompt on
    one of them."""
    jb, jcfg = jax_bundle, JREG.default_stream_config("tiny-test")
    je = JMultiPeerEngine(jb.stream_models, jb.params, jcfg, jb.encode_prompt, max_peers=2,
                          mesh=JM.make_mesh(dp=2)).start("a cat")
    pe = MultiPeerEngine(port_bundle.stream_models, port_bundle.params,
                         PREG.default_stream_config("tiny-test", device="cpu"),
                         port_bundle.encode_prompt, max_peers=2, device="cpu",
                         mesh=PM.device_mesh(2, CPU2)).start("a cat")
    assert pe.dp == 2 and pe._use_buckets is False and pe.states is None
    assert set(pe.bucket_keys()) == {(2, "full")}
    for p in range(2):
        assert je.connect(f"peer {p}", seed=p) == pe.connect(f"peer {p}", seed=p) == p
    jstates = _np(je.states)
    for sh in pe._shards:
        bridge.states_from_jax(jax.tree.map(lambda a, sh=sh: a[sh.slots.start:sh.slots.stop],
                                            jstates), sh.states)
    streams = [_frames(N_FRAMES, seed=40 + p) for p in range(2)]
    for j in range(N_FRAMES):
        if j == 1:
            je.update_prompt(1, "a watercolor fox")
            pe.update_prompt(1, "a watercolor fox")
        frames = np.stack([s[j] for s in streams])
        want, got = np.asarray(je.step_all(frames)), pe.step_all(frames)
        for p in range(2):
            assert _levels(got[p], want[p]) <= 1, (j, p)


def test_deepcache_composes_with_the_dp_axis(port_bundle):
    """UNET_CACHE through a dp=2 scheduler: its sessions' frames equal a
    dp=1 scheduler's bit for bit over a capture and cached steps (each row
    computes alone, whatever shard it sits on)."""
    cfg = PREG.default_stream_config("tiny-test", device="cpu", unet_cache_interval=3)
    s1 = _port_sched(port_bundle, cfg, dp=1)
    s2 = _port_sched(port_bundle, cfg, dp=2, devices=CPU2)
    try:
        assert set(s2.bucket_keys()) == {(k, v) for k in (2, 4) for v in ("capture", "cached")}
        pairs = [(s1.claim(f"s{i}", seed=i), s2.claim(f"s{i}", seed=i)) for i in range(2)]
        assert [p[1].slot for p in pairs] == [0, 2]
        streams = [_frames(4, seed=50 + i) for i in range(2)]
        for j in range(4):
            outs = []
            for side in (0, 1):
                hs = [p[side].submit(s[j]) for p, s in zip(pairs, streams)]
                outs.append([p[side].fetch(h) for p, h in zip(pairs, hs)])
            for a, b in zip(*outs):
                assert np.array_equal(a, b), j
        assert s2._tick == s1._tick == 4
    finally:
        s1.close()
        s2.close()


def test_warmth_is_per_shard_with_prewarm_off(port_bundle):
    """With prewarm off, bucket k stepped on shard 0 leaves it cold on shard
    1: shard 1's first step there is a cold one, kept out of the admission
    feed (``on_step``), and its second is fed."""
    sc = _port_sched(port_bundle, dp=2, devices=CPU2, max_sessions=2, prewarm=False,
                     window_ms=1.0)
    fed = []
    sc.on_step = lambda dt, n: fed.append(n)
    try:
        a, b = sc.claim("a", seed=1), sc.claim("b", seed=2)
        assert [sc._slot_shard(s.slot) for s in (a, b)] == [0, 1]
        f = _frames(2, seed=9)
        for sess, want in ((a, 0), (a, 1), (b, 1), (b, 2)):
            sess.fetch(sess.submit(f[0]))
            assert len(fed) == want
    finally:
        sc.close()


ADAPTER_MODULES = ("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
                   "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_v")


def _style_registry(pb):
    """Two styles (one and two attention linears, rank 2) over the port's tiny UNet."""
    from ai_rtc_agent_tpu_torch.adapters import AdapterRegistry
    from ai_rtc_agent_tpu_torch.models import loader as PLD

    rng = np.random.default_rng(7)
    reg = AdapterRegistry(pb.params["unet"], PLD.unet_key_map(pb.unet_cfg))
    for name, mods in (("styleA", ADAPTER_MODULES[:1]), ("styleB", ADAPTER_MODULES)):
        reg.add(name, {m: {"down": (rng.normal(size=(2, 8)) * 0.4).astype(np.float32),
                           "up": (rng.normal(size=(8, 2)) * 0.4).astype(np.float32),
                           "alpha": 2.0} for m in mods})
    return reg


@pytest.mark.parametrize("plane", ["styles", "fbs2"])
def test_the_style_bank_and_fbs_ride_the_dp_axis(port_bundle, plane):
    """A bound factor bank (a style per session, a swap mid-stream) and
    ``--fbs 2`` (two consecutive frames a row) through a dp=2 scheduler:
    each session's frames equal a dp=1 scheduler's bit for bit; the keys
    carry both ``lrank`` and ``dp``, the labels ``:r<R>:dp2``."""
    fbs = 2 if plane == "fbs2" else 1
    cfg = PREG.default_stream_config("tiny-test", device="cpu", frame_buffer_size=fbs)
    kw = {"adapters": _style_registry(port_bundle)} if plane == "styles" else {}
    s1 = _port_sched(port_bundle, cfg, dp=1, **kw)
    s2 = _port_sched(port_bundle, cfg, dp=2, devices=CPU2, **kw)
    try:
        styles = ("styleA", "styleB") if plane == "styles" else (None, None)
        pairs = [tuple(sc.claim(f"s{i}", seed=i, adapter=st) for sc in (s1, s2))
                 for i, st in enumerate(styles)]
        assert [p[1].slot for p in pairs] == [0, 2]
        if plane == "styles":
            assert all("lrank-4" in k and "dp-2" in k for k in s2.bucket_keys().values())
            assert s2._bucket_label(2, "full") == "sbucket-2:full:r4:dp2"
            assert [p[1].snapshot()["adapter"] for p in pairs] == ["styleA", "styleB"]
        streams = [_frames(4 * fbs, seed=60 + i) for i in range(2)]
        for j in range(4):
            if j == 2 and plane == "styles":
                for sess in pairs[0]:
                    sess.update_adapter("styleB")
            outs = []
            for side in (0, 1):
                batch = [st[j * fbs:(j + 1) * fbs] for st in streams]
                if fbs == 1:
                    hs = [p[side].submit(b[0]) for p, b in zip(pairs, batch)]
                    outs.append([p[side].fetch(h) for p, h in zip(pairs, hs)])
                else:
                    hs = [p[side].submit_batch(b) for p, b in zip(pairs, batch)]
                    outs.append([np.stack(p[side].fetch_batch(h)) for p, h in zip(pairs, hs)])
            for a, b in zip(*outs):
                assert np.array_equal(a, b), j
    finally:
        s1.close()
        s2.close()


def test_dp2_bank_rebuild_and_snapshots(port_bundle):
    """The engine guard's plane on a dp=2 scheduler: the snapshot bank gathers
    each shard's rows on its device, the quarantine snapshots come from it,
    and the rebuild builds new shards with every bucket prewarmed on each and
    every banked row restored bit for bit, so the frames that follow equal a
    twin scheduler's that was never rebuilt.  A session's snapshot moves from
    a dp=2 scheduler to a dp=1 one and back, its frames unchanged (the
    fingerprint names no mesh, as the JAX one)."""
    from types import SimpleNamespace

    from ai_rtc_agent_tpu_torch.obs import devtel
    from ai_rtc_agent_tpu_torch.obs.devtel import DevTelPlane

    # each session on its own shard steps one row whoever else rides: no window needed
    s2 = _port_sched(port_bundle, dp=2, devices=CPU2, window_ms=0.0)
    twin = _port_sched(port_bundle, dp=2, devices=CPU2, window_ms=0.0)
    s1 = _port_sched(port_bundle, dp=1)
    plane = devtel.activate(DevTelPlane())
    try:
        plane.serving()
        pairs = [(s2.claim(f"s{i}", seed=i), twin.claim(f"s{i}", seed=i)) for i in range(2)]
        streams = [_frames(6, seed=70 + i) for i in range(2)]

        def tick(j, sessions_by_side):
            outs = []
            for sessions in sessions_by_side:
                hs = [s.submit(st[j]) for s, st in zip(sessions, streams)]
                outs.append([s.fetch(h) for s, h in zip(sessions, hs)])
            return outs

        tick(0, list(zip(*pairs)))
        s2._guard, s2._snap_every_s, s2._last_snap_t = SimpleNamespace(quarantined=False), 1e-9, 0.0
        with s2._step_lock:
            s2._maybe_bank_rows_locked()
        assert sorted(s2._snap_rows) == [0, 2] and s2._snap_ready == {}
        snaps = s2.capture_quarantine_snapshots()
        assert sorted(snaps) == ["s0", "s1"]
        old = list(s2._shards)
        s2._guard = None
        assert s2.rebuild_engine(snaps) == 2
        assert all(a is not b for a, b in zip(old, s2._shards))
        assert [len(sh.bucket.graph_cache.steps()) for sh in s2._shards] == [2, 2]
        for j in (1, 2):
            got, want = tick(j, list(zip(*pairs)))
            assert all(np.array_equal(a, b) for a, b in zip(got, want)), j
        # the second session moves dp=2 -> dp=1 -> dp=2, its frames as the twin's
        snap = s2.snapshot_session("s1")
        moved = s1.restore_session(snap, "m1")
        pairs[1][0].release()
        got, want = [moved.fetch(moved.submit(streams[1][3]))], [
            pairs[1][1].fetch(pairs[1][1].submit(streams[1][3]))]
        assert np.array_equal(got[0], want[0])
        back = s2.restore_session(s1.snapshot_session("m1"), "s1")
        assert s2._slot_shard(back.slot) == 1
        got = back.fetch(back.submit(streams[1][4]))
        assert np.array_equal(got, pairs[1][1].fetch(pairs[1][1].submit(streams[1][4])))
        assert plane.retrace_breaches == 0
    finally:
        devtel.deactivate(plane)
        for sc in (s2, twin, s1):
            sc.close()


# -- tp and sp serving in lockstep worlds ---------------------------------------------------

SWAP_AT, SWAP_PROMPT = 2, "a watercolor fox"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(task: str, d: Path, n: int = 2) -> list:
    """Spawn ``n`` ranks of ``task`` on a free port; -> each rank's results.
    A rank that exits non-zero, or a world past WORLD_LIMIT_S, kills the
    others and fails the test with the rank's log."""
    port = _free_port()
    procs, logs = [], []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        log = open(d / f"{task}_r{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), task, str(d), f"tcp://127.0.0.1:{port}", str(r), str(n)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + WORLD_LIMIT_S
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad or time.monotonic() > deadline:
                why = f"rank {bad[0]} exited {codes[bad[0]]}" if bad else "past the wall limit"
                text = (d / f"{task}_r{bad[0] if bad else 0}.log").read_text()[-3000:]
                pytest.fail(f"{task} world of {n}: {why}\n{text}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    paths = [d / f"{task}_r{r}.pt" for r in range(n)]  # a rank that died wrote none
    return [torch.load(p, weights_only=False) if p.exists() else None for p in paths]


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory, jax_bundle, port_params):
    """The worlds' inputs: the bridged params, the JAX engine's prepared
    state, the frames; and the JAX sharded engines' outputs."""
    d = tmp_path_factory.mktemp("mesh_worlds")
    jcfg = JREG.default_stream_config("tiny-test")
    frames = _frames(N_FRAMES, seed=9)
    np.savez(d / "inputs.npz", frames=np.stack(frames), fused=jcfg.use_fused_epilogue)
    torch.save(port_params, d / "params.pt")
    refs = {}
    for name, mesh_kw, impl in (("tp2", {"tp": 2}, None), ("sp2_ring", {"sp": 2}, "ring"),
                                ("sp2_ulysses", {"sp": 2}, "ulysses")):
        bundle = jax_bundle if impl is None else JREG.load_model_bundle("tiny-test",
                                                                       attn_impl=impl)
        eng = JStreamEngine(bundle.stream_models, bundle.params, jcfg, bundle.encode_prompt,
                            mesh=JM.make_mesh(**mesh_kw)).prepare("mesh parity", seed=5)
        if name == "tp2":
            torch.save(bridge.state_from_jax(_np(eng.state)), d / "state0.pt")
        outs = []
        for i, f in enumerate(frames):
            if i == SWAP_AT:
                eng.update_prompt(SWAP_PROMPT)
            outs.append(np.asarray(eng(f)))
        refs[name] = outs
    return d, refs


@pytest.fixture(scope="module")
def single_rank(world_dir, port_bundle):
    """The port's engine on no mesh over the same state, frames and swap."""
    d, _ = world_dir
    cfg = PREG.default_stream_config("tiny-test", device="cpu", use_fused_epilogue=bool(
        np.load(d / "inputs.npz")["fused"]))
    eng = PENG.StreamEngine(port_bundle.stream_models, port_bundle.params, cfg,
                            port_bundle.encode_prompt, device="cpu").prepare("x")
    eng.install(torch.load(d / "state0.pt"))
    outs = []
    for i, f in enumerate(np.load(d / "inputs.npz")["frames"]):
        if i == SWAP_AT:
            eng.update_prompt(SWAP_PROMPT)
        outs.append(eng(f))
    return outs


@pytest.mark.parametrize("task", ["tp2", "sp2_ring", "sp2_ulysses"])
def test_lockstep_world_matches_the_jax_sharded_engine(world_dir, single_rank, task):
    """Two gloo ranks behind LockstepEngine/follow: rank 0's frames within 2
    levels of the JAX engine on the same mesh and of the port's single-rank
    engine; rank 1 stepped every frame and was closed."""
    d, refs = world_dir
    r0, r1 = run_world(task, d)
    assert r0["wrapped"] == "LockstepEngine" and r1["steps"] == N_FRAMES
    for i, (got, want, one) in enumerate(zip(r0["outs"], refs[task], single_rank)):
        assert _levels(got, want) <= 2, (task, i)
        assert _levels(got, one) <= 2, (task, i)


def test_deepcache_composes_with_the_tp_axis(world_dir, port_bundle):
    """UNET_CACHE=3 on a tp=2 world: a capture and cached steps, within 2
    levels of the port's single-rank DeepCache engine."""
    d, _ = world_dir
    r0, r1 = run_world("tp2_deepcache", d)
    cfg = PREG.default_stream_config("tiny-test", device="cpu", unet_cache_interval=3,
                                     use_fused_epilogue=bool(np.load(d / "inputs.npz")["fused"]))
    eng = PENG.StreamEngine(port_bundle.stream_models, port_bundle.params, cfg,
                            port_bundle.encode_prompt, device="cpu").prepare("x")
    state = torch.load(d / "state0.pt")
    state["unet_cache"] = torch.zeros_like(eng.state["unet_cache"])
    eng.install(state)
    for i, (got, f) in enumerate(zip(r0["outs"], np.load(d / "inputs.npz")["frames"])):
        if i == SWAP_AT:
            eng.update_prompt(SWAP_PROMPT)
        assert _levels(got, eng(f)) <= 2, i
    assert r1["steps"] == N_FRAMES and eng._tick == 1  # the swap reset the cadence


def test_a_dead_follower_makes_rank_0_raise_within_the_timeout(world_dir):
    d, _ = world_dir
    r0, r1 = run_world("dead", d)
    assert r1 is None  # it died after its first step, without a close
    assert r0["raised"] is not None, "rank 0 stepped on with its follower gone"
    assert r0["seconds"] < 20.0 + 10.0, r0


def test_lockstep_carries_or_refuses_every_engine_call(port_bundle):
    """Every public StreamEngine call is carried to the followers, a local
    read of rank 0's own step, or refused on the wrapper, naming the call."""
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    eng = PENG.StreamEngine(port_bundle.stream_models, port_bundle.params, cfg,
                            port_bundle.encode_prompt, device="cpu").prepare("x")
    wrapped = serving.LockstepEngine(eng)
    assert eng.on_step is not None
    names = [n for n, _ in inspect.getmembers(PENG.StreamEngine) if not n.startswith("_")]
    assert {"prepare", "submit", "fetch", "restart", "install", "follow_step"} <= set(names)
    refused = []
    for name in names:
        if name in serving.CARRIED:
            assert callable(getattr(wrapped, name)), name
        elif name in serving.LOCAL:
            getattr(wrapped, name)
        else:
            with pytest.raises(RuntimeError, match=f"StreamEngine.{name} is not carried"):
                getattr(wrapped, name)
            refused.append(name)
    assert sorted(refused) == ["build_state", "capture", "follow_step"]
    assert wrapped.cfg is eng.cfg and wrapped.state is eng.state  # plain attributes read through


def test_lockstep_sends_the_calls_in_the_order_rank_0_runs_them(monkeypatch):
    """Threads stepping and swapping prompts at once on rank 0: the order of
    the calls sent to the followers is the order the engine ran them (a
    send and its call under one lock), under a short switch interval."""
    import threading
    from types import SimpleNamespace

    sent, ran = [], []

    class Engine:  # the lock discipline of StreamEngine: submit calls on_step under it
        device = torch.device("cpu")

        def __init__(self):
            self.lock, self.on_step = threading.Lock(), None

        def submit(self, frame):
            with self.lock:
                self.on_step(frame)
                ran.append(("step", int(frame[0, 0, 0])))

        def update_prompt(self, prompt):
            with self.lock:
                ran.append(("update_prompt", prompt))

    fake_dist = SimpleNamespace(
        broadcast_object_list=lambda objs, src: sent.append(objs[0]),
        broadcast=lambda t, src: sent.append(("frame", int(t.reshape(-1)[0]))))
    monkeypatch.setattr(serving, "dist", fake_dist)
    monkeypatch.setattr(serving, "world_rank", lambda: 0)
    monkeypatch.setattr(serving, "host_count", lambda: 2)
    monkeypatch.setattr(serving, "_comm_device", lambda engine: torch.device("cpu"))
    wrapped = serving.LockstepEngine(Engine())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def stepper(base):
            for i in range(50):
                wrapped.submit(np.full((2, 2, 3), base + i, np.uint8))

        def prompter():
            for i in range(50):
                wrapped.update_prompt(f"p{i}")

        threads = [threading.Thread(target=stepper, args=(b,)) for b in (0, 100)]
        threads.append(threading.Thread(target=prompter))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    order = []
    for item in sent:
        if item[0] == "step":
            continue  # its frame follows
        order.append(("step", item[1]) if item[0] == "frame" else (item[0], item[1][0]))
    assert len(ran) == 150 and order == ran


# -- refusals, the sp route's local case ----------------------------------------------------


def test_w8_is_refused_on_a_tp_mesh_with_the_jax_text(monkeypatch):
    monkeypatch.setenv("QUANT_WEIGHTS", "w8")
    monkeypatch.setenv("QUANT_MIN_SIZE", "16")
    jb = JREG.load_model_bundle("tiny-test")
    jcfg = JREG.default_stream_config("tiny-test")
    want = _raised(lambda: JStreamEngine(jb.stream_models, JREG.cast_params(jb.params, jcfg.dtype),
                                         jcfg, jb.encode_prompt, mesh=JM.make_mesh(tp=2)))
    assert "tensor-parallel" in want
    pb = PREG.load_model_bundle("tiny-test", device="cpu")
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    params = PREG.cast_params(pb.params, cfg.dtype)
    # a tp=2 layout of this one process: the refusal comes before any group is read
    mesh = PM.Mesh({"dp": 1, "tp": 2, "sp": 1}, np.arange(2).reshape(1, 2, 1), 0,
                   {"dp": 0, "tp": 0, "sp": 0})
    got = _raised(lambda: PENG.StreamEngine(pb.stream_models, params, cfg, pb.encode_prompt,
                                            device="cpu", mesh=mesh))
    assert got == want


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_the_sp_local_case_serves_through_the_kernel_route(monkeypatch, impl):
    """No sp group active: under inference mode the ring/Ulysses routes call
    the flash-attention wrapper (its plain version on a CPU tensor), as
    the default route does; under a gradient the plain route, as before."""
    calls = []
    real = KA.flash_attention

    def counted(q, k, v, mask=None):
        calls.append(q.shape)
        return real(q, k, v, mask)

    monkeypatch.setattr(KA, "flash_attention", counted)
    cfg = PU.UNetConfig.tiny()
    params = PU.init_unet(torch.Generator().manual_seed(0), cfg)
    x, t = torch.randn(2, 8, 8, 4), torch.tensor([5, 9])
    ctx = torch.randn(2, 7, cfg.cross_attention_dim)
    with torch.inference_mode():
        got = PU.apply_unet(params, x, t, ctx, cfg, attn_impl=impl)
        want = PU.apply_unet(params, x, t, ctx, cfg, attn_impl="kernel")
    n = len(calls)
    assert n > 0 and n % 2 == 0 and torch.equal(got, want)
    xg = x.clone().requires_grad_(True)
    PU.apply_unet(params, xg, t, ctx, cfg, attn_impl=impl).sum().backward()
    assert len(calls) == n and xg.grad is not None


# -- the agent ------------------------------------------------------------------------------


def test_a_mesh_larger_than_the_world_is_refused_with_the_jax_text(monkeypatch):
    """``--tp 2`` in a world of one rank, and BATCHSCHED_DP=2 with one card,
    raise the JAX ``make_mesh`` text; nothing falls back to a smaller mesh."""
    for name in ("MESH_SHAPE", "BATCHSCHED_DP"):
        monkeypatch.delenv(name, raising=False)
    one = jax.devices()[:1]
    want_tp = _raised(lambda: JM.make_mesh(tp=2, devices=one))
    assert want_tp == "mesh dp*tp*sp=2 exceeds 1 available devices"
    assert _raised(lambda: PSESS.serving_mesh({"tp": 2, "sp": 0})) == want_tp
    monkeypatch.setenv("MESH_SHAPE", "1,1,2")
    assert _raised(lambda: PSESS.serving_mesh({"tp": 0, "sp": 0})) == want_tp
    monkeypatch.setenv("MESH_SHAPE", "1,1,1")
    assert PSESS.serving_mesh({"tp": 1, "sp": 1}) is None
    want_dp = _raised(lambda: JM.make_mesh(dp=2, devices=one))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert _raised(lambda: PM.device_mesh(2)) == want_dp


def test_the_agent_warns_as_jax_of_the_ignored_dp_and_the_ring_default(monkeypatch, caplog):
    """``--sp 2`` under BATCHSCHED_DP=2: the JAX agent's two warnings, word
    for word (the JAX agent on its 8 virtual devices; the port's in a world
    of 2 ranks, stood in for by the mesh it would build)."""
    monkeypatch.setenv("BATCHSCHED_DP", "2")
    monkeypatch.setenv("BATCHSCHED_MAX_SESSIONS", "2")
    monkeypatch.delenv("ATTN_IMPL", raising=False)
    monkeypatch.delenv("MESH_SHAPE", raising=False)

    async def jax_startup():
        app = JA.build_app(model_id="tiny-test", provider=JS.LoopbackProvider(), sp=2)
        client = TestClient(TestServer(app))
        await client.start_server()
        await client.close()

    with caplog.at_level(logging.WARNING):
        asyncio.run(jax_startup())
    want = sorted(r.getMessage() for r in caplog.records
                  if "IGNORED" in r.getMessage() or "defaulted to 'ring'" in r.getMessage())
    assert len(want) == 2, want
    caplog.clear()
    fake = PM.Mesh({"dp": 1, "tp": 1, "sp": 2}, np.arange(2).reshape(1, 1, 2), 0,
                   {"dp": 0, "tp": 0, "sp": 0})
    monkeypatch.setattr(PM, "make_mesh", lambda **kw: fake)
    monkeypatch.setattr(PM, "host_count", lambda: 2)
    app = {"model_id": "tiny-test", "sp": 2, "tp": 0}
    with caplog.at_level(logging.WARNING):
        assert PSESS.serving_mesh(app) is fake
        assert PSESS.stream_config(app, torch.device("cpu")).attn_impl == "ring"
    got = sorted(r.getMessage() for r in caplog.records)
    assert got == want
    monkeypatch.setattr(PM, "host_count", lambda: 4)
    assert "a world of 4 ranks serves a tp*sp=2 mesh" in _raised(lambda: PSESS.serving_mesh(app))


def test_health_names_each_sessions_shard_as_the_jax_agent(monkeypatch, port_bundle):
    """Two /offer sessions under BATCHSCHED_DP=2: /health lists each
    session's scheduler view with its slot and ``shard`` as the JAX agent
    does (the port's scheduler on the CPU seam, injected)."""
    monkeypatch.setenv("BATCHSCHED_DP", "2")
    monkeypatch.setenv("BATCHSCHED_MAX_SESSIONS", "2")
    monkeypatch.setenv("BATCHSCHED_PREWARM", "0")
    monkeypatch.setenv("SUPERVISOR", "1")
    monkeypatch.setenv("WARMUP_FRAMES", "0")
    monkeypatch.setenv("OVERLOAD_LOOP_LAG_BUDGET_MS", "100000")

    async def drive(m, sched):
        app = m["agent"].build_app(model_id="tiny-test", provider=m["sig"].LoopbackProvider(),
                                   batch_scheduler=sched, **m["kw"])
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            for room in ("r1", "r2"):
                body = {"room_id": room, "offer": {"sdp": m["sig"].make_loopback_offer(),
                                                   "type": "offer"}}
                r = await client.post("/offer", json=body)
                assert r.status == 200, await r.text()
            health = await (await client.get("/health")).json()
            metrics = await (await client.get("/metrics")).json()
            views = sorted((s["batchsched"]["slot"], s["batchsched"]["shard"])
                           for s in health["sessions"].values())
            return views, metrics["batchsched_dp"], metrics["batchsched_shard_sessions"]
        finally:
            await client.close()

    jax_side = asyncio.run(drive({"agent": JA, "sig": JS, "kw": {}}, None))
    sched = _port_sched(port_bundle, max_sessions=2, dp=2, devices=CPU2, prewarm=False)
    port_side = asyncio.run(drive({"agent": PA, "sig": PS, "kw": {"device": "cpu"}}, sched))
    assert port_side == jax_side == ([(0, 0), (1, 1)], 2, {"0": 1, "1": 1})


def test_a_frame_through_a_dp2_agent_session(monkeypatch, port_bundle):
    """A loopback /offer session of the port's agent on a dp=2 scheduler
    carries frames with their pts (its rows on its own shard)."""
    monkeypatch.setenv("SUPERVISOR", "0")
    monkeypatch.setenv("WARMUP_FRAMES", "0")
    sched = _port_sched(port_bundle, max_sessions=2, dp=2, devices=CPU2)

    async def drive():
        app = PA.build_app(model_id="tiny-test", provider=PS.LoopbackProvider(),
                           batch_scheduler=sched, device="cpu")
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            body = {"room_id": "r", "offer": {"sdp": PS.make_loopback_offer(), "type": "offer"}}
            assert (await client.post("/offer", json=body)).status == 200
            pc = next(iter(app["pcs"]))
            for i, f in enumerate(_frames(4, seed=3)):  # the track keeps 2 frames in flight
                vf = PF.VideoFrame.from_ndarray(f)
                vf.pts, vf.time_base = i, Fraction(1, 30)
                await pc.in_track.push(vf)
            return [(await asyncio.wait_for(pc.out_tracks[0].recv(), 60)).pts for _ in range(2)]
        finally:
            await client.close()

    assert asyncio.run(drive()) == [0, 1]
    assert sched.snapshot()["batchsched_steps_total"] >= 2


def test_a_torchrun_world_of_two_agents_serves_from_rank_0(tmp_path):
    """``--tp 2`` under torchrun's variables: rank 0 answers HTTP (a /config
    prompt is carried to rank 1), rank 1 follows, and rank 0's shutdown
    closes the follower; both exit 0."""
    import signal
    import urllib.request

    master, http = _free_port(), _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", RANK=str(r),
                   WORLD_SIZE="2", LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(master), WEBRTC_PROVIDER="loopback")
        log = open(tmp_path / f"agent_r{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "ai_rtc_agent_tpu_torch.server.agent", "--model-id",
             "tiny-test", "--device", "cpu", "--tp", "2", "--port", str(http)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))

    def get(path, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{http}{path}", data=body)
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode()

    try:
        deadline = time.monotonic() + WORLD_LIMIT_S
        while True:
            assert all(p.poll() is None for p, _ in procs), (tmp_path / "agent_r0.log").read_text()
            try:
                assert get("/") == (200, "OK")
                break
            except OSError:
                assert time.monotonic() < deadline, "rank 0 never served"
                time.sleep(0.2)
        assert get("/config", b'{"prompt": "a fox"}') == (200, "OK")
        procs[0][0].send_signal(signal.SIGINT)
        codes = [p.wait(timeout=60) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    assert codes == [0, 0], (tmp_path / "agent_r1.log").read_text()[-2000:]
    assert "lockstep follower: closed after 0 steps" in (tmp_path / "agent_r1.log").read_text()
