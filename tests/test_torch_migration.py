"""Session snapshot and restore in the port against the JAX package, on the CPU.

* The wire codec (parallel/checkpoint.py): for every leaf kind the session
  state carries (bf16, f32, int32, uint8, bool, 0-size, 0-d, nested dicts,
  lists, tuples and python scalars) the port writes the JAX encoder's
  bytes, and each side decodes the other's bit for bit; corrupt and
  truncated blobs are refused (tests/test_migration.py's cases).
* Across frameworks at tiny-test (a 2-stage turbo ring at 32x32, the JAX
  weights carried by ``bridge``): a JAX ``BatchScheduler`` snapshot
  restores into the port's scheduler and the next 4 frames stay within 1
  uint8 level of the JAX scheduler's own continuation; a port snapshot
  restores into JAX the same way; the fingerprints are equal dicts; a
  mismatch (schema, fbs, height, a row leaf's shape, a corrupt or cut blob,
  a t_index_list of the wrong length, a full pool) is refused on both sides
  and leaves both schedulers untouched.  Within the port a migrated session
  continues bit for bit.
* The engine guard's bank: the port's quarantine snapshot dict equals the
  JAX one for the same state row, field for field (there are no clock
  readings in it); a quarantined scheduler serves it and its rebuild
  restores the row bit for bit.
* The speed variants (w8 weights, DeepCache at N = 3; the JAX w8 tree
  carried by ``bridge``): the fingerprints are equal dicts with ``unet_cache``
  3 and ``quant`` "w8"; a JAX snapshot (its row carries the deep-feature
  cache, bit for bit) restores into the port and rides a capture first,
  and the next frames stay within 1 uint8 level of a JAX reference
  restored from the same snapshot, on the same cadence; a snapshot of
  another variant (``unet_cache`` or ``quant`` differs) is refused on both
  sides as the JAX scheduler refuses it.
* ControlNet: a session's row carries its conditioning ring and scale;
  its snapshot crosses between the packages both ways (the JAX schema and
  codec bytes, the continuation within 1 level), and a ControlNet row is
  refused by a plain scheduler (and a plain row by a ControlNet one) on
  both packages, by the row's structure.
* Style adapters: a styled session's row carries its factor bank and its
  snapshot the adapter's name; it crosses between the packages both ways
  with the same blob and fingerprint, and a bank and no bank refuse each
  other's snapshots on both packages, naming the same keys.
* The import rules: the AST walk of tests/test_torch_stream.py covers the
  new modules, and the router's core and the session layer import no
  aiohttp at all.
"""

import ast
import base64
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.parallel import checkpoint as JC
from ai_rtc_agent_tpu.stream import scheduler as JS
from ai_rtc_agent_tpu.stream.engine import SimilarityFilter as JSimilarityFilter
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.parallel import checkpoint as PC
from ai_rtc_agent_tpu_torch.stream import scheduler as PS
from ai_rtc_agent_tpu_torch.stream.engine import SimilarityFilter as PSimilarityFilter

REPO = Path(__file__).resolve().parents[1]
RING = dict(t_index_list=(0, 1), num_inference_steps=2, timestep_spacing="trailing",
            scheduler="turbo", cfg_type="none", height=32, width=32)


# -- the wire codec ------------------------------------------------------------------

def _leaf(kind: str, seed: int = 0):
    """(numpy/JAX tree, the same tree in torch) of one leaf kind."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    if kind == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    if kind == "float32":
        return x, torch.from_numpy(x.copy())
    if kind == "int32":
        a = rng.integers(-1000, 1000, (5,)).astype(np.int32)
        return a, torch.from_numpy(a.copy())
    if kind == "uint8":
        a = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
        return a, torch.from_numpy(a.copy())
    if kind == "bool":
        a = rng.integers(0, 2, (7,)).astype(bool)
        return a, torch.from_numpy(a.copy())
    if kind == "empty":
        return np.zeros((0, 64, 64, 4), np.float32), torch.zeros((0, 64, 64, 4))
    if kind == "scalar0d":
        return np.float32(0.125), torch.tensor(0.125)
    if kind == "nested":
        j = {"coeffs": {"alpha": x[0], "steps": np.asarray([999], np.int32)},
             "meta": ["prompt", 1.5, None, True, (7,)], "cond": jnp.asarray(x, jnp.bfloat16)}
        t = {"coeffs": {"alpha": torch.from_numpy(x[0].copy()),
                        "steps": torch.tensor([999], dtype=torch.int32)},
             "meta": ["prompt", 1.5, None, True, (7,)],
             "cond": torch.from_numpy(x).to(torch.bfloat16)}
        return j, t
    raise ValueError(kind)


KINDS = ["bfloat16", "float32", "int32", "uint8", "bool", "empty", "scalar0d", "nested"]


def _flat(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _flat(v)
    else:
        yield tree


def _raw(leaf) -> tuple:
    """(dtype name, shape, bytes) of a numpy, JAX or torch leaf."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).rsplit(".", 1)[-1]
        t = leaf.contiguous().reshape(-1)
        return name, tuple(leaf.shape), t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
    a = np.asarray(leaf)
    return a.dtype.name, a.shape, a.tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_codec_writes_the_jax_bytes(kind):
    jtree, ttree = _leaf(kind)
    assert PC.serialize_pytree(ttree) == JC.serialize_pytree(jtree)
    # numpy leaves go through the port's encoder as they go through JAX's
    if kind not in ("bfloat16", "nested"):
        assert PC.serialize_pytree(jtree) == JC.serialize_pytree(jtree)


@pytest.mark.parametrize("kind", KINDS)
def test_each_codec_decodes_the_others(kind):
    jtree, ttree = _leaf(kind, seed=3)
    from_jax = PC.deserialize_pytree(JC.serialize_pytree(jtree))
    from_port = JC.deserialize_pytree(PC.serialize_pytree(ttree))
    for a, b in zip(_flat(jtree), _flat(from_jax)):
        if isinstance(b, torch.Tensor):
            assert _raw(a) == _raw(b)
        else:
            assert a == b  # python scalars ride the spec
    for a, b in zip(_flat(ttree), _flat(from_port)):
        if isinstance(a, torch.Tensor):
            assert _raw(a) == _raw(b)
        else:
            assert a == b


def test_codec_refuses_corrupt_and_truncated():
    import struct

    blob = PC.serialize_pytree({"a": torch.arange(16, dtype=torch.float32)})
    with pytest.raises(ValueError, match="magic|version"):
        PC.deserialize_pytree(b"NOTMAGIC" + blob[8:])
    with pytest.raises(ValueError, match="truncated"):
        PC.deserialize_pytree(blob[:6])
    with pytest.raises(ValueError, match="truncated"):
        PC.deserialize_pytree(blob[:-4])
    flipped = bytearray(blob)
    flipped[-1] ^= 0x01
    with pytest.raises(ValueError, match="checksum"):
        PC.deserialize_pytree(bytes(flipped))
    with pytest.raises(ValueError, match="truncated"):
        PC.deserialize_pytree(blob[:8] + struct.pack("<I", 10_000_000) + blob[12:])
    with pytest.raises(ValueError, match="unknown dtype"):
        PC.deserialize_pytree(JC.serialize_pytree({"c": np.zeros(2, np.complex64)}))


def test_similarity_filter_state_matches_the_jax_filter():
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (32, 32, 3), np.uint8) for _ in range(4)] + [
        np.full((32, 32, 3), 7, np.uint8)] * 6
    j, p = JSimilarityFilter(0.5, 3, seed=9), PSimilarityFilter(0.5, 3, seed=9)
    for f in frames[:5]:
        assert j.should_skip(f, have_output=True) == p.should_skip(f, have_output=True)
    assert p.export_state() == j.export_state()
    back = PSimilarityFilter(0.5, 3, seed=0)
    back.restore_state(j.export_state())
    for f in frames[5:]:
        assert back.should_skip(f, have_output=True) == j.should_skip(f, have_output=True)
    with pytest.raises(ValueError):
        back.restore_state({"skip_count": "x"})


# -- across frameworks -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tiny():
    return JREG.load_model_bundle("tiny-test")


@pytest.fixture(scope="module")
def pair(jax_tiny):
    """A JAX and a port scheduler (2 slots, 2-stage ring at 32x32) over the
    same weights."""
    jb = jax_tiny
    js = JS.BatchScheduler(jb.stream_models, jb.params, JREG.default_stream_config(
        "tiny-test", **RING), jb.encode_prompt, max_sessions=2, window_ms=10_000.0,
        prewarm=False, dp=1, model_id="tiny-test")
    pb = PREG.load_model_bundle("tiny-test", device="cpu",
                                params=bridge.params_from_jax(jax.tree.map(np.asarray, jb.params)))
    ps = PS.BatchScheduler(pb.stream_models, pb.params, PREG.default_stream_config(
        "tiny-test", device="cpu", **RING), pb.encode_prompt, max_sessions=2, window_ms=10_000.0,
        device="cpu", model_id="tiny-test")
    try:
        yield SimpleNamespace(js=js, ps=ps, pb=pb)
    finally:
        js.close()
        ps.close()


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (32, 32, 3), np.uint8) for _ in range(n)]


def _tick(sess, frame):
    return np.asarray(sess.fetch(sess.submit(frame)))


def _levels(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


def _released(*sessions):
    for s in sessions:
        s.release()


def test_fingerprints_are_equal_dicts(pair):
    assert pair.ps.snapshot_fingerprint() == pair.js.snapshot_fingerprint()


def test_a_jax_snapshot_restores_into_the_port(pair):
    frames = _frames(7, 11)
    src = pair.js.claim("src", prompt="migration prompt", seed=5)
    src.update_guidance(guidance_scale=1.4, delta=0.8)
    dst = None
    try:
        for f in frames[:3]:
            _tick(src, f)
        snap = pair.js.snapshot_session("src")
        dst = pair.ps.restore_session(snap, "dst")
        assert (dst.prompt, dst.guidance_scale, dst.delta, dst.t_index_list) == (
            "migration prompt", pytest.approx(1.4), pytest.approx(0.8), [0, 1])
        assert dst.frames_submitted == 3 and dst._had_output
        levels = [_levels(_tick(dst, f), _tick(src, f)) for f in frames[3:]]
        assert max(levels) <= 1, levels
    finally:
        _released(*(s for s in (src, dst) if s is not None))


def test_a_port_snapshot_restores_into_jax(pair):
    frames = _frames(7, 12)
    src = pair.ps.claim("src", prompt="a port session", seed=6)
    dst = None
    try:
        for f in frames[:3]:
            _tick(src, f)
        snap = pair.ps.snapshot_session("src")
        assert snap["fingerprint"] == pair.js.snapshot_fingerprint()
        dst = pair.js.restore_session(snap, "dst")
        levels = [_levels(_tick(dst, f), _tick(src, f)) for f in frames[3:]]
        assert max(levels) <= 1, levels
    finally:
        _released(*(s for s in (src, dst) if s is not None))


def _reblob(snap: dict, edit) -> dict:
    """``snap`` with its row decoded (JAX codec), edited and encoded again."""
    row = JC.deserialize_pytree(base64.b64decode(snap["state_b64"]))
    edit(row)
    return dict(snap, state_b64=base64.b64encode(JC.serialize_pytree(row)).decode())


def _mutate(case: str, snap: dict) -> dict:
    if case == "schema":
        return dict(snap, schema=snap["schema"] + 1)
    if case in ("fbs", "height"):
        return dict(snap, fingerprint=dict(snap["fingerprint"], **{case: 64}))
    if case == "row_shape":
        return _reblob(snap, lambda row: row.update(noise=np.zeros((3, 8, 8, 4), np.float32)))
    if case == "row_structure":
        return _reblob(snap, lambda row: row.pop("stock"))
    if case == "corrupt":
        blob = bytearray(base64.b64decode(snap["state_b64"]))
        blob[len(blob) // 2] ^= 0xFF
        return dict(snap, state_b64=base64.b64encode(bytes(blob)).decode())
    if case == "truncated":
        return dict(snap, state_b64=snap["state_b64"][: len(snap["state_b64"]) // 2])
    if case == "t_index":
        return dict(snap, t_index_list=[0])
    raise ValueError(case)


def _state_bytes(sched, slot) -> bytes:
    if isinstance(sched, PS.BatchScheduler):
        return b"".join(_raw(a[slot])[2] for a in _flat(sched.states))
    return b"".join(np.asarray(a[slot]).tobytes() for a in jax.tree.leaves(sched.states))


@pytest.mark.parametrize("case", ["schema", "fbs", "height", "row_shape", "row_structure",
                                  "corrupt", "truncated", "t_index", "full_pool"])
def test_mismatches_are_refused_on_both_sides(pair, case):
    """Each refusal leaves both schedulers untouched: no slot taken, the live
    session's row unchanged."""
    js_live = pair.js.claim("live-j", prompt="live", seed=1)
    ps_live = pair.ps.claim("live-p", prompt="live", seed=1)
    extra = []
    try:
        snaps = {"jax": pair.js.snapshot_session("live-j"), "port": pair.ps.snapshot_session(
            "live-p")}
        if case == "full_pool":
            extra = [pair.js.claim("fill-j"), pair.ps.claim("fill-p")]
        for target, refusal in ((pair.js, (JS.SnapshotMismatch, JS.CapacityError)),
                                (pair.ps, (PS.SnapshotMismatch, PS.CapacityError))):
            live = js_live if target is pair.js else ps_live
            free, row = target.free_slots, _state_bytes(target, live.slot)
            for origin, snap in snaps.items():
                bad = snap if case == "full_pool" else _mutate(case, snap)
                want = refusal[1] if case == "full_pool" else refusal[0]
                with pytest.raises(want):
                    target.restore_session(bad, f"x-{origin}")
            assert target.free_slots == free
            assert _state_bytes(target, live.slot) == row
    finally:
        _released(js_live, ps_live, *extra)


def _port_scheduler(pb, **kw):
    kw.setdefault("max_sessions", 2)
    return PS.BatchScheduler(pb.stream_models, pb.params, PREG.default_stream_config(
        "tiny-test", device="cpu", **RING), pb.encode_prompt, window_ms=10_000.0, device="cpu",
        **kw)


def test_a_migrated_port_session_continues_bit_for_bit(pair):
    """A -> B mid-stream on the port: every frame after the move equals an
    unmigrated control's; the export left the source untouched; a fresh
    session does not reproduce it (the ring carried real state)."""
    A, B, C = (_port_scheduler(pair.pb) for _ in range(3))
    frames = _frames(10, 21)
    try:
        sa = A.claim("sa", prompt="moving", seed=5)
        sc = C.claim("sc", prompt="moving", seed=5)
        for f in frames[:5]:
            assert np.array_equal(_tick(sa, f), _tick(sc, f))
        snap = A.snapshot_session("sa")
        sb = B.restore_session(snap, "sb")
        first = _tick(sc, frames[5])
        assert np.array_equal(_tick(sb, frames[5]), first)
        for f in frames[6:]:
            assert np.array_equal(_tick(sb, f), _tick(sc, f))
        assert np.array_equal(_tick(sa, frames[5]), first)  # the source never moved
        fresh = B.claim("fresh", prompt="moving", seed=5)
        assert not np.array_equal(_tick(fresh, frames[5]), first)
    finally:
        for s in (A, B, C):
            s.close()


def test_snapshot_of_an_unknown_session_raises(pair):
    with pytest.raises(KeyError):
        pair.ps.snapshot_session("nobody")
    assert pair.ps.session("nobody") is None


# -- the engine guard's bank -----------------------------------------------------------

def _bank(sched):
    """Attach a stand-in guard, refresh the bank now, freeze it."""
    sched.attach_guard(SimpleNamespace(quarantined=False))
    sched._snap_every_s, sched._last_snap_t = 1e-9, 0.0
    sched._maybe_bank_rows_locked()
    return sched.capture_quarantine_snapshots()


def test_quarantine_bank_matches_the_jax_bank(pair):
    """The same state row in both banks (carried by ``states_from_jax``):
    the port's snapshot dict equals the JAX one field for field, its blob
    byte for byte."""
    js_s = pair.js.claim("banked", prompt="a banked session", seed=4)
    ps_s = pair.ps.claim("banked", prompt="a banked session", seed=4)
    try:
        bridge.states_from_jax(jax.tree.map(np.asarray, pair.js.states), pair.ps.states)
        jbank, pbank = _bank(pair.js), _bank(pair.ps)
        assert set(pbank) == set(jbank) == {"banked"}
        got, want = pbank["banked"], jbank["banked"]
        assert isinstance(got, dict)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key] == want[key], key
    finally:
        for s in (pair.js, pair.ps):
            s.attach_guard(None)
            s._quarantine_snaps = {}
        _released(js_s, ps_s)


def test_a_quarantined_scheduler_serves_the_bank_and_rebuilds_from_it(pair):
    guard = SimpleNamespace(quarantined=False, cold_deadline_s=60.0,
                            dispatch=lambda fn, cold=False: fn(),
                            run_bounded=lambda fn, deadline, what: fn())
    sched = _port_scheduler(pair.pb)
    try:
        sched.attach_guard(guard)
        sched._snap_every_s = 1e-9
        sess = sched.claim("q", prompt="quarantined", seed=8)
        for f in _frames(3, 31):
            _tick(sess, f)  # the bank refreshes after every step
        rows = {k: v.clone() for k, v in _flat_items(sched.states, sess.slot)}
        guard.quarantined = True
        bank = sched.capture_quarantine_snapshots()
        assert sched.snapshot_session("q") == bank["q"]
        with pytest.raises(PS.CapacityError):
            sched.restore_session(bank["q"], "other")
        guard.quarantined = False
        assert sched.rebuild_engine() == 1
        assert all(torch.equal(v, dict(_flat_items(sched.states, sess.slot))[k])
                   for k, v in rows.items())
        assert sched._quarantine_snaps == {}
    finally:
        sched.close()


# -- the speed variants: w8 weights and DeepCache ----------------------------------------

@pytest.fixture(scope="module")
def variant_pair(jax_tiny):
    """The pair's schedulers serving w8 weights (QUANT_MIN_SIZE 256) under
    DeepCache at N = 3."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("QUANT_WEIGHTS", "w8")
        mp.setenv("QUANT_MIN_SIZE", "256")
        jq = JREG.cast_params(jax_tiny.params, "float32")
    cfg = dict(RING, unet_cache_interval=3)
    js = JS.BatchScheduler(jax_tiny.stream_models, jq, JREG.default_stream_config(
        "tiny-test", **cfg), jax_tiny.encode_prompt, max_sessions=2, window_ms=10_000.0,
        prewarm=False, dp=1, model_id="tiny-test")
    pb = PREG.load_model_bundle("tiny-test", device="cpu",
                                params=bridge.params_from_jax(jax.tree.map(np.asarray, jq)))
    ps = PS.BatchScheduler(pb.stream_models, pb.params, PREG.default_stream_config(
        "tiny-test", device="cpu", **cfg), pb.encode_prompt, max_sessions=2, window_ms=10_000.0,
        device="cpu", model_id="tiny-test")
    try:
        yield SimpleNamespace(js=js, ps=ps, pb=pb)
    finally:
        js.close()
        ps.close()


def test_variant_fingerprints_are_equal_dicts(variant_pair):
    fp = variant_pair.ps.snapshot_fingerprint()
    assert fp == variant_pair.js.snapshot_fingerprint()
    assert (fp["unet_cache"], fp["quant"]) == (3, "w8")


def test_a_jax_variant_snapshot_restores_into_the_port(variant_pair):
    """The source steps 4 frames (capture, cached, cached, capture) and
    leaves; its snapshot restores into the port and, as the reference, into
    the JAX scheduler again: both ride a capture first and then the same
    cadence, every frame within 1 level."""
    js, ps = variant_pair.js, variant_pair.ps
    frames = _frames(9, 13)
    src = js.claim("src", prompt="a w8 session", seed=5)
    dst = ref = None
    try:
        for f in frames[:4]:
            _tick(src, f)
        snap = js.snapshot_session("src")
        src.release()
        src = None
        assert (snap["cache_tick"], snap["cache_uncaptured"]) == (4, False)
        row = JC.deserialize_pytree(base64.b64decode(snap["state_b64"]))
        assert row["unet_cache"].shape == (2, 8, 8, 16) and np.abs(
            np.asarray(row["unet_cache"], np.float32)).max() > 0
        dst = ps.restore_session(snap, "dst")
        ref = js.restore_session(snap, "ref")
        assert dst.slot in ps._uncaptured and ref.slot in js._uncaptured
        got = ps.states["unet_cache"][dst.slot]
        assert _raw(got)[2] == np.ascontiguousarray(row["unet_cache"]).tobytes()
        levels = []
        for f in frames[4:]:
            levels.append(_levels(_tick(dst, f), _tick(ref, f)))
            assert ps._tick == js._tick
        assert max(levels) <= 1, levels
        back = ps.snapshot_session("dst")
        assert back["fingerprint"] == snap["fingerprint"]
        assert (back["cache_tick"], back["cache_uncaptured"]) == (js._tick, False)
    finally:
        _released(*(s for s in (src, dst, ref) if s is not None))


@pytest.mark.parametrize("case", ["dense_into_variant", "variant_into_dense", "unet_cache",
                                  "quant"])
def test_another_variant_is_refused_on_both_sides(pair, variant_pair, case):
    """A snapshot of another params variant or DeepCache interval is refused
    by both packages' schedulers (SnapshotMismatch naming the key), which
    stay untouched."""
    origin, targets = (pair, variant_pair) if case == "dense_into_variant" else (
        variant_pair, pair if case == "variant_into_dense" else variant_pair)
    live = origin.js.claim("live-j", prompt="live", seed=1)
    try:
        snap = origin.js.snapshot_session("live-j")
    finally:
        live.release()
    if case in ("unet_cache", "quant"):
        snap = dict(snap, fingerprint=dict(snap["fingerprint"], **{
            case: 2 if case == "unet_cache" else ""}))
        keys = [case]
    else:
        keys = ["quant", "unet_cache"]
    for target, mismatch in ((targets.js, JS.SnapshotMismatch), (targets.ps, PS.SnapshotMismatch)):
        free = target.free_slots
        with pytest.raises(mismatch, match=r"fingerprint mismatch on \[" + ", ".join(
                f"'{k}'" for k in keys) + r"\]"):
            target.restore_session(snap, "x")
        assert target.free_slots == free


def _flat_items(tree, slot, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat_items(tree[k], slot, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k][slot]


# -- ControlNet: the conditioning ring rides the row ----------------------------------------

@pytest.fixture(scope="module")
def cnet_pair():
    """The pair's ring at 32x32 with a ControlNet (canny; its zero convs
    non-zero from a seed, the JAX weights carried by ``bridge``)."""
    jb = JREG.load_model_bundle("tiny-test", controlnet="tiny-cnet")
    rng = np.random.default_rng(0)
    cnet = jb.params["controlnet"]
    for zc in cnet["zero_convs"] + [cnet["mid_zero_conv"], cnet["cond_embedding"]["conv_out"]]:
        zc["kernel"] = jnp.asarray(0.3 * rng.standard_normal(zc["kernel"].shape), jnp.float32)
    cfg = dict(RING, use_controlnet=True)
    js = JS.BatchScheduler(jb.stream_models, jb.params, JREG.default_stream_config(
        "tiny-test", **cfg), jb.encode_prompt, max_sessions=2, window_ms=10_000.0,
        prewarm=False, dp=1, model_id="tiny-test")
    pb = PREG.load_model_bundle("tiny-test", device="cpu", controlnet="tiny-cnet",
                                params=bridge.params_from_jax(jax.tree.map(np.asarray, jb.params)))
    ps = PS.BatchScheduler(pb.stream_models, pb.params, PREG.default_stream_config(
        "tiny-test", device="cpu", **cfg), pb.encode_prompt, max_sessions=2, window_ms=10_000.0,
        device="cpu", model_id="tiny-test")
    try:
        yield SimpleNamespace(js=js, ps=ps, pb=pb)
    finally:
        js.close()
        ps.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_controlnet_snapshot_crosses_between_the_packages(cnet_pair, direction):
    """A ControlNet session steps 3 frames and is exported: its row carries
    ``cnet_cond`` (the ring of the last frames' edge maps) and ``cnet_scale``
    under the JAX fingerprint (no ControlNet key); restored on the other
    package, the next 4 frames stay within 1 level of the source's own
    continuation, and the restored row's bytes are the snapshot's."""
    src_s, dst_s = (cnet_pair.js, cnet_pair.ps) if direction == "jax_to_port" else (
        cnet_pair.ps, cnet_pair.js)
    frames = _frames(7, 14)
    src = src_s.claim("src", prompt="a conditioned session", seed=5)
    dst = None
    try:
        for f in frames[:3]:
            _tick(src, f)
        snap = src_s.snapshot_session("src")
        assert snap["fingerprint"] == cnet_pair.js.snapshot_fingerprint() == \
            cnet_pair.ps.snapshot_fingerprint()
        row = JC.deserialize_pytree(base64.b64decode(snap["state_b64"]))
        assert row["cnet_cond"].shape == (1, 32, 32, 3) and float(row["cnet_scale"]) == 1.0
        assert np.asarray(row["cnet_cond"], np.float32).max() > 0
        assert PC.serialize_pytree(PC.deserialize_pytree(base64.b64decode(
            snap["state_b64"]))) == base64.b64decode(snap["state_b64"])
        dst = dst_s.restore_session(snap, "dst")
        restored = dict(_flat_items(dst_s.states, dst.slot))
        assert _raw(restored["cnet_cond"])[2] == np.ascontiguousarray(row["cnet_cond"]).tobytes()
        levels = [_levels(_tick(dst, f), _tick(src, f)) for f in frames[3:]]
        assert max(levels) <= 1, levels
    finally:
        _released(*(s for s in (src, dst) if s is not None))


def test_a_controlnet_row_into_a_plain_scheduler_is_refused_on_both_sides(pair, cnet_pair):
    """The fingerprints agree (they have no ControlNet key), so the row's
    structure refuses it: SnapshotMismatch on both packages, both ways,
    no slot taken."""
    assert cnet_pair.js.snapshot_fingerprint() == pair.js.snapshot_fingerprint()
    for origin, target in ((cnet_pair, pair), (pair, cnet_pair)):
        live = origin.js.claim("live-j", prompt="live", seed=1)
        try:
            snap = origin.js.snapshot_session("live-j")
        finally:
            live.release()
        for sched, mismatch in ((target.js, JS.SnapshotMismatch), (target.ps, PS.SnapshotMismatch)):
            free = sched.free_slots
            with pytest.raises(mismatch, match="structure differs"):
                sched.restore_session(snap, "x")
            assert sched.free_slots == free


# -- style adapters: the factor bank rides the row --------------------------------------------

ADAPTER_MODULES = ("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
                   "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_v")


def _adapter_groups(mods, seed):
    rng = np.random.default_rng(seed)
    return {m: {"down": (rng.normal(size=(2, 8)) * 0.4).astype(np.float32),
                "up": (rng.normal(size=(8, 2)) * 0.4).astype(np.float32), "alpha": 2.0}
            for m in mods}


@pytest.fixture(scope="module")
def adapter_pair(jax_tiny, pair):
    """The pair's ring with a rank-4 bank on both packages: styleA on one
    attention linear, styleB on two (the JAX test_migration registry's
    shape), the same groups on both sides."""
    from ai_rtc_agent_tpu.adapters import AdapterRegistry as JAdapterRegistry
    from ai_rtc_agent_tpu.models import loader as JLD
    from ai_rtc_agent_tpu_torch.adapters import AdapterRegistry
    from ai_rtc_agent_tpu_torch.models import loader as PLD

    jb, pb = jax_tiny, pair.pb
    jreg = JAdapterRegistry(jb.params["unet"], JLD.unet_key_map(jb.unet_cfg))
    preg = AdapterRegistry(pb.params["unet"], PLD.unet_key_map(pb.unet_cfg))
    for name, mods, seed in (("styleA", ADAPTER_MODULES[:1], 7), ("styleB", ADAPTER_MODULES, 8)):
        g = _adapter_groups(mods, seed)
        jreg.add(name, g)
        preg.add(name, g)
    js = JS.BatchScheduler(jb.stream_models, jb.params, JREG.default_stream_config(
        "tiny-test", **RING), jb.encode_prompt, max_sessions=2, window_ms=10_000.0,
        prewarm=False, dp=1, model_id="tiny-test", adapters=jreg)
    ps = PS.BatchScheduler(pb.stream_models, pb.params, PREG.default_stream_config(
        "tiny-test", device="cpu", **RING), pb.encode_prompt, max_sessions=2, window_ms=10_000.0,
        device="cpu", model_id="tiny-test", adapters=preg)
    try:
        yield SimpleNamespace(js=js, ps=ps, preg=preg)
    finally:
        js.close()
        ps.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_styled_snapshot_crosses_between_the_packages(adapter_pair, direction):
    """The JAX test_migrate_adapter_style_rides_snapshot across packages: the
    snapshot names the adapter and carries the factor bank in its row under
    equal fingerprints (adapter_rank 4 and the same targets digest);
    restored on the other package, the row's bytes are the snapshot's (a
    snapshot taken there at once has the same blob), the style is kept, and
    the next 4 frames stay within 1 level of the source's continuation."""
    src_s, dst_s = (adapter_pair.js, adapter_pair.ps) if direction == "jax_to_port" else (
        adapter_pair.ps, adapter_pair.js)
    frames = _frames(7, 15)
    src = src_s.claim("src", prompt="a styled session", seed=5, adapter="styleB")
    dst = None
    try:
        for f in frames[:3]:
            _tick(src, f)
        snap = src_s.snapshot_session("src")
        fp = adapter_pair.ps.snapshot_fingerprint()
        assert snap["fingerprint"] == fp == adapter_pair.js.snapshot_fingerprint()
        assert snap["adapter"] == "styleB" and fp["adapter_rank"] == 4
        row = JC.deserialize_pytree(base64.b64decode(snap["state_b64"]))
        tree_path = "down_blocks.0.attentions.0.blocks.0.attn1.to_v"
        assert row["adapters"][tree_path]["down"].shape == (4, 8)
        assert np.abs(np.asarray(row["adapters"][tree_path]["up"])).max() > 0
        dst = dst_s.restore_session(snap, "dst")
        assert dst.adapter == "styleB"
        again = dst_s.snapshot_session("dst")
        assert again["state_b64"] == snap["state_b64"]
        assert again["adapter"] == "styleB" and again["fingerprint"] == snap["fingerprint"]
        levels = [_levels(_tick(dst, f), _tick(src, f)) for f in frames[3:]]
        assert max(levels) <= 1, levels
    finally:
        _released(*(s for s in (src, dst) if s is not None))


def test_the_guard_bank_and_rebuild_carry_the_factor_bank(pair, adapter_pair):
    """The engine guard's paths with a bank bound: the quarantine snapshot of
    a styled session equals the JAX bank's field for field (the adapter's
    name, the blob with its factors byte for byte); a quarantined scheduler
    serves it and its rebuild restores the row, the factors too, bit for bit;
    a session claimed after the last bank refresh is rebuilt from its control
    plane with its own style's rows."""
    js_s = adapter_pair.js.claim("banked", prompt="a banked session", seed=4, adapter="styleB")
    ps_s = adapter_pair.ps.claim("banked", prompt="a banked session", seed=4, adapter="styleB")
    try:
        bridge.states_from_jax(jax.tree.map(np.asarray, adapter_pair.js.states),
                               adapter_pair.ps.states)
        jbank, pbank = _bank(adapter_pair.js), _bank(adapter_pair.ps)
        assert pbank["banked"]["adapter"] == "styleB"
        for key in jbank["banked"]:
            assert pbank["banked"][key] == jbank["banked"][key], key
    finally:
        for s in (adapter_pair.js, adapter_pair.ps):
            s.attach_guard(None)
            s._quarantine_snaps = {}
        _released(js_s, ps_s)
    guard = SimpleNamespace(quarantined=False, cold_deadline_s=60.0,
                            dispatch=lambda fn, cold=False: fn(),
                            run_bounded=lambda fn, deadline, what: fn())
    sched = _port_scheduler(pair.pb, adapters=adapter_pair.preg)
    try:
        sched.attach_guard(guard)
        sched._snap_every_s = 1e-9
        sess = sched.claim("q", prompt="quarantined", seed=8, adapter="styleB")
        for f in _frames(3, 32):
            _tick(sess, f)  # the bank refreshes after every step
        sched._snap_every_s = 1e9
        late = sched.claim("late", prompt="unbanked", seed=9, adapter="styleA")
        rows = {k: v.clone() for k, v in _flat_items(sched.states, sess.slot)}
        assert any(k.startswith("adapters/") for k in rows)
        guard.quarantined = True
        bank = sched.capture_quarantine_snapshots()
        assert set(bank) == {"q"} and bank["q"]["adapter"] == "styleB"
        assert sched.snapshot_session("q") == bank["q"]
        guard.quarantined = False
        assert sched.rebuild_engine() == 1
        after = dict(_flat_items(sched.states, sess.slot))
        assert all(torch.equal(v, after[k]) for k, v in rows.items())
        want = adapter_pair.preg.factor_rows("styleA")
        for path, f in sched.states["adapters"].items():
            for part in ("down", "up"):
                assert torch.equal(f[part][late.slot], want[path][part])
        assert (sess.adapter, late.adapter) == ("styleB", "styleA")
    finally:
        sched.close()


def test_a_bank_and_no_bank_refuse_each_others_snapshots_on_both_packages(pair, adapter_pair):
    """A styled row into an adapterless scheduler, and a plain row into one
    with a bank: refused by the fingerprint on both packages, naming the same
    keys, no slot taken."""
    msgs = {}
    for origin, target, label in ((adapter_pair, pair, "bank -> none"),
                                  (pair, adapter_pair, "none -> bank")):
        live = origin.ps.claim("live", prompt="live", seed=1)
        try:
            snap = origin.ps.snapshot_session("live")
        finally:
            live.release()
        for sched, mismatch in ((target.js, JS.SnapshotMismatch), (target.ps, PS.SnapshotMismatch)):
            free = sched.free_slots
            with pytest.raises(mismatch, match="fingerprint mismatch") as e:
                sched.restore_session(snap, "x")
            assert sched.free_slots == free
            msgs.setdefault(label, []).append(str(e.value).split(" (")[0])
    for label, (jmsg, pmsg) in msgs.items():
        assert jmsg == pmsg == "snapshot fingerprint mismatch on ['adapter_rank', " \
            "'adapter_targets']", label


# -- the import rules --------------------------------------------------------------------

def _all_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add((node.module or "").split(".")[0])
    return names


def test_the_import_walk_covers_the_new_modules():
    walked = set(sorted((REPO / "ai_rtc_agent_tpu_torch").rglob("*.py")))
    pkg = REPO / "ai_rtc_agent_tpu_torch"
    analysis = ("__init__", "__main__", "core", "paths", "regressions", "async_blocking",
                "bounded_queues", "pooled_views", "span_pairing", "lock_discipline",
                "loop_affinity", "task_lifecycle", "reservation_pairing", "metric_cardinality",
                "metrics_registry", "env_registry", "http_contract", "encoder_reconfig",
                "refusal_discipline")
    for rel in ("fleet/__init__.py", "fleet/journey.py", "fleet/registry.py", "fleet/routing.py",
                "fleet/router.py", "fleet/transport.py", "parallel/checkpoint.py",
                "parallel/mesh.py", "parallel/sharding.py", "parallel/collectives.py",
                "parallel/ring_attention.py", "parallel/trainer.py",
                "server/lifecycle.py", "server/worker.py",
                *(f"analysis/{name}.py" for name in analysis)):
        path = pkg / rel
        assert path in walked, rel
        assert not _all_imports(path) & {"jax", "jaxlib", "ai_rtc_agent_tpu", "ml_dtypes",
                                         "optax", "orbax"}, rel


@pytest.mark.parametrize("rel", ["fleet/routing.py", "fleet/transport.py", "fleet/registry.py",
                                 "fleet/journey.py", "server/sessions.py",
                                 "server/broadcast.py"])
def test_the_cores_import_no_aiohttp_at_module_level(rel):
    """The router's core and the session layer run on the card, which has no
    aiohttp: routing.py and sessions.py import none at all; the transport
    and the poller only inside the aiohttp transport."""
    path = REPO / "ai_rtc_agent_tpu_torch" / rel
    tree = ast.parse(path.read_text())
    top = {n.names[0].name.split(".")[0] for n in tree.body if isinstance(n, ast.Import)} | {
        (n.module or "").split(".")[0] for n in tree.body if isinstance(n, ast.ImportFrom)}
    assert "aiohttp" not in top
    if rel in ("fleet/routing.py", "server/sessions.py", "server/broadcast.py"):
        assert "aiohttp" not in _all_imports(path)
