"""Port parity: the training path (parallel/mesh, sharding, collectives,
ring_attention, trainer, the train-state checkpoints) against the JAX
package on the CPU.

The JAX side runs on the 8 virtual devices of tests/conftest.py.  The
port runs one process per rank: gloo worlds of 2 and 8 ranks, each rank a
``tests/_torch_dist_worker.py`` process (no JAX) on a free loopback port,
with a timeout on every collective and a wall limit on the world, so a
dead rank fails its test and never hangs the suite.  The inputs go to the
workers in ``tmp_path``; the JAX references are computed here.

Tolerances (f32 on both sides): attention rtol/atol 2e-4 as the JAX tests;
the tp UNet rtol 5e-4 / atol 5e-5 as the JAX test; the sp UNet atol 2e-4;
trainer losses rtol 1e-5 and every parameter after each step atol 2e-5
at learning rate 1e-3 (Adam moves a parameter by up to lr a step, so this
holds each step's update to 2% of its largest size; measured ~5e-6).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import unet as JU
from ai_rtc_agent_tpu.ops import schedule as JS
from ai_rtc_agent_tpu.parallel import mesh as JM
from ai_rtc_agent_tpu.parallel import ring_attention as JRA
from ai_rtc_agent_tpu.parallel import sharding as JSH
from ai_rtc_agent_tpu.parallel.trainer import TrainerConfig as JTrainerConfig
from ai_rtc_agent_tpu.parallel.trainer import make_train_step as j_make_train_step
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.models import unet as PU
from ai_rtc_agent_tpu_torch.ops import schedule as PS
from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF
from ai_rtc_agent_tpu_torch.parallel import checkpoint as CK
from ai_rtc_agent_tpu_torch.parallel import mesh as PM
from ai_rtc_agent_tpu_torch.parallel import ring_attention as PRA
from ai_rtc_agent_tpu_torch.parallel import sharding as PSH
from ai_rtc_agent_tpu_torch.parallel.trainer import ShardedTrainer, TrainerConfig

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_dist_worker.py"
WORLD_LIMIT_S = 240  # wall limit of one spawned world (~15-25 s alone)
LR = 1e-3
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
KEYS = (0, 5, 9)  # the JAX keys of steps 1-3


# -- the worlds -------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(task: str, n: int, d: Path, torchrun_env: bool = False) -> list:
    """Spawn ``n`` worker ranks of ``task`` on a free port; -> each rank's
    results.  A rank that exits non-zero, or a world past WORLD_LIMIT_S,
    kills the others and fails the test with the logs."""
    port = _free_port()
    procs, logs = [], []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        args = [task, str(d)]
        if torchrun_env:
            env.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        else:
            args += [f"tcp://127.0.0.1:{port}", str(r), str(n)]
        log = open(d / f"{task}_r{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, str(WORKER), *args], cwd=REPO, env=env,
                                      stdout=log, stderr=subprocess.STDOUT))
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
    return [torch.load(d / f"{task}_r{r}.pt", weights_only=False) for r in range(n)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    cfg = JU.UNetConfig.tiny()
    params = JU.init_unet(jax.random.PRNGKey(1), cfg)
    return cfg, params, bridge.params_from_jax(_np(params))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "q": f(2, 32, 4, 8), "k": f(2, 32, 4, 8), "v": f(2, 32, 4, 8), "cot": f(2, 32, 4, 8),
        "qh": f(2, 32, 8, 8), "kh": f(2, 32, 8, 8), "vh": f(2, 32, 8, 8), "coth": f(2, 32, 8, 8),
        "lq": f(1, 8192, 1, 64), "lk": f(1, 8192, 1, 64), "lv": f(1, 8192, 1, 64),
        "x": f(2, 8, 8, 4), "t": np.array([5, 9], np.int32), "ctx": f(2, 7, 32),
        "latents": f(4, 8, 8, 4), "context": f(4, 7, 32),
    }


def _draws(key, shape):
    """The t and noise the JAX ``loss_fn`` draws from ``key``."""
    kt, kn = jax.random.split(jax.random.PRNGKey(key))
    t = jax.random.randint(kt, (shape[0],), 0, JS.make_schedule().num_train_steps)
    return np.asarray(t), np.asarray(jax.random.normal(kn, shape, jnp.float32))


@pytest.fixture(scope="module")
def jax_train(tiny, inputs):
    """Three steps of the JAX ``make_train_step`` on one device: the loss and
    the state after each."""
    cfg, params, _ = tiny
    init_fn, step_fn = j_make_train_step(
        lambda p, x, t, c, a: JU.apply_unet(p, x, t, c, cfg, added_cond=a), JS.make_schedule(),
        JTrainerConfig(learning_rate=LR))
    step = jax.jit(step_fn)
    state = init_fn(params)
    batch = {"latents": inputs["latents"], "context": inputs["context"]}
    losses, states = [], []
    for key in KEYS:
        state, loss = step(state, batch, jax.random.PRNGKey(key))
        losses.append(float(loss))
        states.append(_np(state))
    return losses, states


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory, tiny, inputs):
    d = tmp_path_factory.mktemp("worlds")
    feeds = dict(inputs)
    for i, key in enumerate(KEYS[:2]):
        feeds[f"t{i}"], feeds[f"noise{i}"] = _draws(key, inputs["latents"].shape)
    np.savez(d / "inputs.npz", **feeds)
    torch.save(tiny[2], d / "params.pt")
    return d


@pytest.fixture(scope="module")
def attention_world(world_dir):
    return run_world("attention", 8, world_dir)


@pytest.fixture(scope="module")
def train_world(world_dir):
    return run_world("train", 8, world_dir)


def _cat(results, key, ranks):
    """The token shards of ``key`` from ``ranks``, in order along L."""
    return torch.cat([results[r][key] for r in ranks], dim=1).numpy()


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _unet_cfg_apply(cfg, impl):
    return lambda p, x, t, c, a: PU.apply_unet(p, x, t, c, cfg, attn_impl=impl, added_cond=a)


def _port_trainer(params, lr=LR, mesh=None):
    cfg = PU.UNetConfig.tiny()
    return ShardedTrainer(_unet_cfg_apply(cfg, "plain"), PS.make_schedule(),
                          mesh or PM.make_mesh(), params, TrainerConfig(learning_rate=lr),
                          device="cpu")


def _assert_params(state_params, jax_params, label):
    want = bridge.params_from_jax(jax_params)
    for path, a in PSH.leaves_with_paths(state_params):
        np.testing.assert_allclose(a.detach().numpy(), PSH.at(want, path).numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"{label} {path}")


# -- the mesh -----------------------------------------------------------------------------


def test_mesh_layout_matches_jax(attention_world):
    """Rank r sits where the JAX mesh puts device r, and each axis group
    holds the ranks along that axis of the JAX device array."""
    jm = JM.make_mesh(dp=2, tp=2, sp=2)
    ids = np.vectorize(lambda dev: dev.id)(jm.devices)
    for r, res in enumerate(attention_world):
        np.testing.assert_array_equal(res["devices"], ids)
        d, t, s = res["coords"]
        assert ids[d, t, s] == r
        assert res["group_ranks"]["dp"] == list(ids[:, t, s])
        assert res["group_ranks"]["tp"] == list(ids[d, :, s])
        assert res["group_ranks"]["sp"] == list(ids[d, t, :])
    with pytest.raises(ValueError) as jerr:
        JM.make_mesh(dp=16)
    assert {res["oversubscribed"] for res in attention_world} == {str(jerr.value)}


def test_mesh_in_one_process():
    """No process group: a world of one, whose mesh is (1,1,1) with no group."""
    m = PM.make_mesh()
    assert m.shape == {"dp": 1, "tp": 1, "sp": 1} and m.coords == {"dp": 0, "tp": 0, "sp": 0}
    assert [m.group(a) for a in PM.AXES] == [None, None, None]
    assert PM.host_count() == 1 and PM.auto_mesh(prefer="sp").shape["sp"] == 1
    with pytest.raises(ValueError, match=r"^mesh dp\*tp\*sp=16 exceeds 1 available devices$"):
        PM.make_mesh(dp=16)
    with PM.use_mesh(m) as active:
        assert PM.current_mesh() is active is m
    assert PM.current_mesh() is None


def test_init_distributed_refuses_what_it_cannot_run():
    """cuda without a card raises; a CPU world needs gloo; NCCL on the CPU
    raises; a world of two needs a rendezvous port."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PM.init_distributed()
    with pytest.raises(ValueError, match="'gloo'"):
        PM.init_distributed(backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="MASTER_PORT"):
        PM.init_distributed(rank=0, world_size=2, backend="gloo", device="cpu")


# -- the tp rules -------------------------------------------------------------------------


def _layout_mesh(tp):
    """A port mesh layout of tp ranks (the rules read only its sizes)."""
    return PM.Mesh({"dp": 1, "tp": tp, "sp": 1}, np.arange(tp).reshape(1, tp, 1), 0,
                   {"dp": 0, "tp": 0, "sp": 0})


def _port_layout(spec, ndim):
    s = list(spec) + [None] * (ndim - len(spec))
    return tuple(s[j] for j in (3, 2, 0, 1)) if ndim == 4 else tuple(s)


@pytest.mark.parametrize("family,tp", [("tiny", 2), ("tiny", 8), ("sd21", 2), ("sd21", 8)])
def test_tp_rules_match_jax_leaf_by_leaf(family, tp):
    """Every leaf's sharded axis (or none) is the JAX answer, after the
    divisibility drop; the SD2.1 (sd-turbo) tree by shapes only."""
    jcfg = JU.UNetConfig.tiny() if family == "tiny" else JU.UNetConfig.sd21()
    pcfg = PU.UNetConfig.tiny() if family == "tiny" else PU.UNetConfig.sd21()
    jtree = jax.eval_shape(lambda: JU.init_unet(jax.random.PRNGKey(0), jcfg))
    jspecs = JSH.param_shardings(JM.make_mesh(tp=tp), jtree)
    ptree = PU.init_unet(None, pcfg, device="meta")
    pspecs = PSH.param_shardings(_layout_mesh(tp), ptree)
    jflat = {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path): sh.spec
             for path, sh in jax.tree_util.tree_flatten_with_path(jspecs)[0]}
    pflat = pspecs
    assert set(jflat) == set(pflat)
    sharded = 0
    for path, spec in pflat.items():
        assert spec == _port_layout(tuple(jflat[path]), len(spec)), path
        sharded += "tp" in spec
    assert sharded > 0


def test_tp_rules_odd_leaf_falls_back_to_replicated():
    """The JAX test's tree: column, row, replicated, and the indivisible leaf."""
    tree = {"attn1": {"to_q": {"kernel": torch.zeros(64, 64)}},
            "ff": {"out": {"kernel": torch.zeros(64, 64), "bias": torch.zeros(64)}},
            "norm1": {"scale": torch.zeros(64), "bias": torch.zeros(64)},
            "odd": {"to_q": {"kernel": torch.zeros(3, 5)}}}
    sh = PSH.param_shardings(_layout_mesh(8), tree)
    assert sh[("attn1", "to_q", "kernel")] == (None, "tp")  # column
    assert sh[("ff", "out", "kernel")] == ("tp", None)  # row
    assert sh[("ff", "out", "bias")] == (None,)
    assert sh[("norm1", "scale")] == (None,)  # replicated
    assert sh[("odd", "to_q", "kernel")] == (None, None)  # fallback


# -- ring and Ulysses attention -------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_attention_matches_jax(attention_world, inputs, n):
    q, k, v = (inputs[x] for x in "qkv")
    got = _cat(attention_world, f"ring{n}", range(n))
    _close(got, JRA.dense_reference(q, k, v), 2e-4, 2e-4)
    _close(got, JRA.ring_attention(q, k, v, JM.make_mesh(sp=n)), 2e-4, 2e-4)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ulysses_attention_matches_jax(attention_world, inputs, n):
    q, k, v = (inputs[x] for x in ("qh", "kh", "vh"))
    got = _cat(attention_world, f"ulysses{n}", range(n))
    _close(got, JRA.dense_reference(q, k, v), 2e-4, 2e-4)
    _close(got, JRA.ulysses_attention(q, k, v, JM.make_mesh(sp=n)), 2e-4, 2e-4)
    assert f"needs heads % sp == 0 (H=1, sp={n})" in attention_world[0][f"ulysses{n}_refused"]


def test_ring_attention_long_context(attention_world, inputs):
    """[1, 8192, 1, 64] at sp = 8 (the JAX long-context case)."""
    q, k, v = (inputs[x] for x in ("lq", "lk", "lv"))
    got = _cat(attention_world, "long8", range(8))
    _close(got, JRA.dense_reference(q, k, v), 2e-4, 2e-4)
    _close(got, JRA.ring_attention(q, k, v, JM.make_mesh(sp=8)), 2e-4, 2e-4)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sp_attention_gradients_match_dense(attention_world, inputs, kind):
    """d/d(q, k, v) of sum(out * cot) through shard -> ring / Ulysses ->
    gather at sp = 2 against the port's dense reference under autograd
    (f32; rtol/atol 1e-5), identical on both ranks."""
    names = ("q", "k", "v", "cot") if kind == "ring" else ("qh", "kh", "vh", "coth")
    q, k, v, cot = (torch.from_numpy(inputs[x]).requires_grad_(x[0] != "c") for x in names)
    (PRA.dense_reference(q, k, v) * cot).sum().backward()
    for r in range(2):
        for got, want in zip(attention_world[r][f"grad_{kind}"], (q.grad, k.grad, v.grad)):
            _close(got, want, 1e-5, 1e-5)


# -- the UNet over a mesh ---------------------------------------------------------------------


def test_unet_tp2_matches_jax(train_world, tiny, inputs):
    """The tiny UNet with tp = 2 Megatron shards = the JAX UNet unsharded."""
    cfg, params, _ = tiny
    want = JU.apply_unet(params, inputs["x"], inputs["t"], inputs["ctx"], cfg)
    for r in range(2):
        _close(train_world[r]["unet_tp2"], want, 5e-4, 5e-5)


@pytest.mark.parametrize("impl,n", [("ring", 8), ("ulysses", 2)])
def test_unet_sp_matches_jax(attention_world, tiny, inputs, impl, n):
    cfg, params, _ = tiny
    want = JU.apply_unet(params, inputs["x"], inputs["t"], inputs["ctx"], cfg, attn_impl="xla")
    for r in range(n):
        _close(attention_world[r][f"unet_{impl}{n}"], want, 0, 2e-4)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_unet_sp_route_without_a_group_is_plain(tiny, inputs, impl):
    """No active group: the sp routes are the plain route, bit for bit, and
    match the JAX xla route (the JAX test's 1e-6)."""
    cfg, params, port = tiny
    x, t, c = (torch.from_numpy(inputs[n]) for n in ("x", "t", "ctx"))
    pcfg = PU.UNetConfig.tiny()
    got = PU.apply_unet(port, x, t, c, pcfg, attn_impl=impl)
    assert torch.equal(got, PU.apply_unet(port, x, t, c, pcfg, attn_impl="plain"))
    want = JU.apply_unet(params, inputs["x"], inputs["t"], inputs["ctx"], cfg, attn_impl="xla")
    _close(got, want, 0, 1e-6)


def test_registry_takes_the_sp_routes_with_a_warning(caplog):
    import logging

    with caplog.at_level(logging.WARNING):
        b = PREG.load_model_bundle("tiny-test", device="cpu", attn_impl="ring")
    assert "takes effect only under an active sp_attention_group" in caplog.text
    assert b.unet_cfg is not None
    with pytest.raises(ValueError, match=r"attn_impl='xla' unknown \(plain \| kernel \| ring "
                                         r"\| ulysses\)"):
        PREG.load_model_bundle("tiny-test", device="cpu", attn_impl="xla")


# -- the trainer ----------------------------------------------------------------------------


def test_trainer_matches_jax_in_one_process(tiny, inputs, jax_train):
    """Mesh (1,1,1), two steps with the JAX draws: each loss and every
    parameter after each step."""
    jl, js = jax_train
    tr = _port_trainer(tiny[2])
    batch = {"latents": inputs["latents"], "context": inputs["context"]}
    for i, key in enumerate(KEYS[:2]):
        t, noise = _draws(key, inputs["latents"].shape)
        loss = tr.step(batch, t=t, noise=noise)
        assert loss == pytest.approx(jl[i], rel=LOSS_RTOL)
        _assert_params(tr.state["params"], js[i]["params"], f"step {i + 1}")
        assert int(tr.state["step"]) == i + 1 == int(tr.state["opt"]["count"])


def test_trainer_matches_jax_on_the_2x2x2_mesh(train_world, jax_train):
    """dp=2 * tp=2 * sp=2 over 8 ranks (ring attention over sp, as the JAX
    dryrun runs it) against the JAX step on one device."""
    jl, js = jax_train
    for r, res in enumerate(train_world):
        for i in range(2):
            assert res[f"loss{i}"] == pytest.approx(jl[i], rel=LOSS_RTOL), (r, i)
            _assert_params(res[f"state{i}"]["params"], js[i]["params"], f"rank {r} step {i + 1}")


def test_trainer_continues_a_jax_state(tiny, inputs, jax_train):
    """The JAX state after two steps, carried over by the bridge, then one
    more port step = the JAX third step."""
    jl, js = jax_train
    tr = _port_trainer(tiny[2])
    tr.load_state(bridge.train_state_from_jax(js[1]))
    assert int(tr.state["step"]) == 2 == int(tr.state["opt"]["count"])
    t, noise = _draws(KEYS[2], inputs["latents"].shape)
    loss = tr.step({"latents": inputs["latents"], "context": inputs["context"]}, t=t,
                   noise=noise)
    assert loss == pytest.approx(jl[2], rel=LOSS_RTOL)
    _assert_params(tr.state["params"], js[2]["params"], "step 3")
    mu = bridge.params_from_jax(js[2]["opt"][1][0].mu)
    for path, a in PSH.leaves_with_paths(tr.state["opt"]["mu"]):
        np.testing.assert_allclose(a.numpy(), PSH.at(mu, path).numpy(), rtol=1e-4, atol=1e-7)


def test_trainer_refuses_an_indivisible_batch_and_a_missing_draw(tiny, inputs):
    tr = _port_trainer(tiny[2])
    with pytest.raises(ValueError, match="needs a generator, or both t and noise"):
        tr.step({"latents": inputs["latents"], "context": inputs["context"]})
    mesh = PM.Mesh({"dp": 3, "tp": 1, "sp": 1}, np.arange(3).reshape(3, 1, 1), 0,
                   {"dp": 0, "tp": 0, "sp": 0})
    from ai_rtc_agent_tpu_torch.parallel.trainer import _place

    with pytest.raises(ValueError, match="a global batch of 4 does not split over dp=3"):
        _place(inputs["latents"], mesh, "cpu", "latents")


def test_checkpoint_round_trip(tiny, inputs, tmp_path):
    """Save mid-run: a fresh trainer restores bit for bit and continues
    within atol 5e-6 (the JAX test's contract); an empty directory -> False."""
    batch = {"latents": inputs["latents"], "context": inputs["context"]}
    tr = _port_trainer(tiny[2])
    tr.step(batch, torch.Generator().manual_seed(0))
    ckpt = tmp_path / "ckpts"
    path = tr.save(str(ckpt))
    assert Path(path).name == "step_00000001" and CK.latest_checkpoint(str(ckpt)) == path
    tr2 = _port_trainer(tiny[2])
    assert tr2.restore(str(ckpt))
    assert int(tr2.state["step"]) == 1
    a, b = tr.full_state(), tr2.full_state()
    for (pa, x), (pb, y) in zip(PSH.leaves_with_paths(a), PSH.leaves_with_paths(b)):
        assert pa == pb and torch.equal(x.detach(), y.detach()), pa
    l_continue = tr.step(batch, torch.Generator().manual_seed(7))
    l_resumed = tr2.step(batch, torch.Generator().manual_seed(7))
    assert abs(l_resumed - l_continue) <= 5e-6
    assert not tr2.restore(str(tmp_path / "nope"))
    tr.save(str(ckpt))
    assert CK.latest_checkpoint(str(ckpt)).endswith("step_00000002")


def test_checkpoint_crosses_mesh_shapes(train_world, tiny):
    """Written by the 8-rank (2,2,2) world (rank 0, tp shards gathered),
    restored at (1,1,1) to the same values bit for bit."""
    res = train_world[0]
    assert all(r["ckpt"] == res["ckpt"] for r in train_world)
    tr = _port_trainer(tiny[2])
    assert tr.restore(str(Path(res["ckpt"]).parent))
    got = tr.full_state()
    want = res["state1"]
    for (pa, x), (pb, y) in zip(PSH.leaves_with_paths(got), PSH.leaves_with_paths(want)):
        assert pa == pb and torch.equal(x.detach(), y.detach()), pa


def test_multihost_world_from_torchrun_env(world_dir):
    """Two ranks brought up by init_distributed from torchrun's variables,
    dp = 2: the losses are finite and fall (tests/multihost_worker.py's
    contract), the same on both ranks."""
    res = run_world("multihost", 2, world_dir, torchrun_env=True)
    assert [r["world"] for r in res] == [2, 2] and [r["rank"] for r in res] == [0, 1]
    l0, l1 = res[0]["losses"]
    assert np.isfinite([l0, l1]).all() and l1 < l0
    assert res[1]["losses"] == res[0]["losses"]


# -- the kernels refuse autograd ------------------------------------------------------------


def test_kernel_wrappers_refuse_grad():
    """A call that needs a gradient raises on the CPU as on the card, naming
    the plain route; without grad (inference) the plain version runs."""
    q = torch.randn(1, 8, 2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match='attn_impl="plain"'):
        KA.flash_attention(q, q, q)
    with torch.no_grad():
        assert KA.flash_attention(q, q, q).shape == q.shape
    x = torch.randn(1, 4, 4, 4, requires_grad=True)
    coeffs = type("C", (), {n: torch.ones(1) for n in ("alpha", "sigma", "c_skip", "c_out",
                                                     "next_alpha", "next_sigma")})()
    args = (x, x.detach(), x.detach(), x.detach(), coeffs, torch.ones(1), torch.ones(1), "none")
    with pytest.raises(RuntimeError, match='attn_impl="plain"'):
        KF.fused_stream_epilogue(*args)
    with torch.inference_mode():
        assert KF.fused_stream_epilogue(*args)[0].shape == x.shape


def test_plain_backward_reaches_every_attention_projection(tiny, inputs):
    """One trainer step: every to_q/to_k/to_v kernel has a finite non-zero
    gradient; the same step through the kernel route raises."""
    tr = _port_trainer(tiny[2])
    batch = {"latents": inputs["latents"], "context": inputs["context"]}
    tr.step(batch, torch.Generator().manual_seed(0))
    proj = [(p, a) for p, a in PSH.leaves_with_paths(tr.state["params"])
            if p[-2] in ("to_q", "to_k", "to_v")]
    transformers = sum(1 for p, _a in PSH.leaves_with_paths(tr.state["params"])
                       if p[-2:] == ("proj_in", "kernel"))
    assert len(proj) == 3 * 2 * transformers > 0  # q, k, v of self- and cross-attention
    for path, a in proj:
        assert torch.isfinite(a.grad).all() and a.grad.abs().max() > 0, path
    kernel = ShardedTrainer(_unet_cfg_apply(PU.UNetConfig.tiny(), "kernel"), PS.make_schedule(),
                            PM.make_mesh(), tiny[2], TrainerConfig(learning_rate=LR),
                            device="cpu")
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        kernel.step(batch, torch.Generator().manual_seed(0))
