"""The port's deploy CLIs (ai_rtc_agent_tpu_torch/assets/) against the JAX
package's, on the CPU.  Nothing here touches the network.

* download: fake ``requests`` and ``huggingface_hub`` modules stand in
  ``sys.modules`` for the network layer both packages import inside their
  functions.  Given the same fakes, the JAX ``download()`` and the port's
  make the same snapshot calls (repo, ``allow_patterns``) for every model
  set, and behave the same on Civitai: a cache hit, a 200 with and without
  Content-Disposition, a 5xx retried to exhaustion, a 503 then a 200, a 429,
  a 404 not retried (the same GETs, results, files and log lines), with
  the retry delays zeroed.
* build_engines at tiny-test on the CPU (nothing built or captured: each
  step runs eagerly once): the keys of ``build``, ``build_multipeer`` and
  ``build_scheduler_buckets`` are the keys the JAX key functions spell for
  the same config (``stream_engine_key``, ``params_variant_extra`` and the
  JAX scheduler's ``bucket_keys``; the JAX ``build`` is not run: it
  AOT-compiles), up to the version part: plain, a LoRA, ``--controlnet``,
  the UNET_CACHE pair, w8 params, ``--peers 2`` and ``--sched-buckets 2``.
* The CLI parses ``--lora`` as the JAX ``main`` does and refuses
  ``--cache-dir`` at parse time with its reason.
* The tiny families attend through the kernel on a CUDA device, unless
  ATTN_IMPL names another route, as every family does.
"""

import dataclasses
import logging
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.assets import build_engines as JBE
from ai_rtc_agent_tpu.assets import download as JDL
from ai_rtc_agent_tpu.resilience import retry as JRETRY
from ai_rtc_agent_tpu.stream import engine as JENG
from ai_rtc_agent_tpu.stream.scheduler import BatchScheduler as JBatchScheduler
from ai_rtc_agent_tpu_torch.assets import build_engines as PBE
from ai_rtc_agent_tpu_torch.assets import download as PDL
from ai_rtc_agent_tpu_torch.models import loader as PLD
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.resilience import retry as PRETRY

PACKAGES = {"jax": JDL, "port": PDL}


# -- download -------------------------------------------------------------------------


class FakeResponse:
    def __init__(self, status: int, content: bytes = b"", disposition: str | None = None):
        self.status_code = status
        self.content = content
        self.headers = {} if disposition is None else {"Content-Disposition": disposition}


def _fake_network(script: list):
    """(requests, huggingface_hub, calls): fake modules; ``requests.get``
    answers from ``script`` in order (the last answer repeats)."""
    calls = []
    requests = types.ModuleType("requests")

    class RequestException(Exception):
        pass

    def get(url, allow_redirects=False, timeout=None):
        calls.append(("get", url, allow_redirects, timeout))
        return script[min(len(calls) - 1, len(script) - 1)]

    requests.RequestException = RequestException
    requests.get = get
    hub = types.ModuleType("huggingface_hub")

    def snapshot_download(repo, allow_patterns=None):
        calls.append(("snapshot", repo, allow_patterns))
        return f"/snapshots/{repo}"

    hub.snapshot_download = snapshot_download
    return requests, hub, calls


@pytest.fixture
def no_retry_delay(monkeypatch):
    for mod in (JRETRY, PRETRY):
        policy = mod.transient_policy
        monkeypatch.setattr(mod, "transient_policy",
                            lambda attempts=3, base_delay_s=0.5, policy=policy:
                            policy(attempts=attempts, base_delay_s=0.0))


def _run(pkg: str, fn, script, monkeypatch, tmp_path, caplog):
    """Run ``fn(module)`` for one package over fresh fakes and its own
    CIVITAI_CACHE -> (result, network calls, files written, log lines)."""
    requests, hub, calls = _fake_network(script)
    monkeypatch.setitem(sys.modules, "requests", requests)
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    cache = tmp_path / pkg
    monkeypatch.setenv("CIVITAI_CACHE", str(cache))
    caplog.clear()
    with caplog.at_level(logging.INFO):
        result = fn(PACKAGES[pkg])
    files = {str(p.relative_to(cache)): p.read_bytes() for p in sorted(cache.rglob("*"))
             if p.is_file()}
    lines = [r.getMessage() for r in caplog.records if r.name.endswith("assets.download")]
    if isinstance(result, str):
        result = str(Path(result).relative_to(cache))
    return result, calls, files, lines


def _both(fn, script, monkeypatch, tmp_path, caplog, seed_cache=None):
    out = {}
    for pkg in PACKAGES:
        if seed_cache:
            (tmp_path / pkg).mkdir(parents=True, exist_ok=True)
            (tmp_path / pkg / seed_cache).write_bytes(b"cached")
        out[pkg] = _run(pkg, fn, script, monkeypatch, tmp_path, caplog)
    assert out["port"] == out["jax"]
    return out["port"]


def test_model_tables_are_the_jax_tables():
    assert PDL.HF_MODEL_SETS == JDL.HF_MODEL_SETS
    assert PDL.CIVITAI_MODELS == JDL.CIVITAI_MODELS
    assert PDL.HF_ALLOW_PATTERNS == JDL.HF_ALLOW_PATTERNS


def test_civitai_model_path_is_the_jax_path(monkeypatch):
    monkeypatch.delenv("CIVITAI_CACHE", raising=False)
    assert PDL.civitai_model_path("x") == JDL.civitai_model_path("x")
    monkeypatch.setenv("CIVITAI_CACHE", "/somewhere/else")
    assert PDL.civitai_model_path("x") == JDL.civitai_model_path("x") == "/somewhere/else/x.safetensors"


@pytest.mark.parametrize("model_set", sorted(JDL.HF_MODEL_SETS))
def test_download_makes_the_jax_snapshot_calls(model_set, monkeypatch, tmp_path, caplog,
                                               no_retry_delay):
    ok = FakeResponse(200, b"weights", 'attachment; filename="ghibli.safetensors"')
    result, calls, files, lines = _both(lambda m: m.download(model_set), [ok], monkeypatch,
                                        tmp_path, caplog)
    snaps = [c[1:] for c in calls if c[0] == "snapshot"]
    assert snaps == [(r, JDL.HF_ALLOW_PATTERNS.get(r)) for r in JDL.HF_MODEL_SETS[model_set]]
    assert files == {"studio-ghibli-style-lora.safetensors": b"weights"}


CIVITAI = {
    "disposition": ([FakeResponse(200, b"abc", 'attachment; filename="style v2.safetensors"')],
                    1, True),
    "no_disposition": ([FakeResponse(200, b"abc")], 1, True),
    "bare_filename": ([FakeResponse(200, b"abc", "attachment; filename=plain.bin; x=1")], 1, True),
    "5xx_exhausted": ([FakeResponse(502)], 4, False),
    "503_then_200": ([FakeResponse(503), FakeResponse(200, b"late")], 2, True),
    "429_then_200": ([FakeResponse(429), FakeResponse(200, b"late")], 2, True),
    "404_not_retried": ([FakeResponse(404)], 1, False),
}


@pytest.mark.parametrize("case", sorted(CIVITAI))
def test_civitai_download_behaves_as_the_jax_one(case, monkeypatch, tmp_path, caplog,
                                                 no_retry_delay):
    script, gets, stored = CIVITAI[case]
    result, calls, files, lines = _both(
        lambda m: m.download_civitai_model("style", "123"), script, monkeypatch, tmp_path,
        caplog)
    assert calls == [("get", "https://civitai.com/api/download/models/123", True, 120)] * gets
    assert (result == "style.safetensors") == stored and (result is None) == (not stored)
    assert bool(files) == stored
    if case == "disposition":
        assert "downloaded style (style v2.safetensors)" in lines
    if case == "no_disposition":
        assert "downloaded style (unnamed)" in lines


def test_civitai_cache_hit_fetches_nothing(monkeypatch, tmp_path, caplog, no_retry_delay):
    result, calls, files, lines = _both(
        lambda m: m.download_civitai_model("style", "123"), [FakeResponse(500)], monkeypatch,
        tmp_path, caplog, seed_cache="style.safetensors")
    assert result == "style.safetensors" and calls == [] and lines == ["civitai style cached"]
    assert files == {"style.safetensors": b"cached"}


# -- build_engines ------------------------------------------------------------------------


def _unversioned(key: str) -> str:
    head, _, version = key.rpartition("--v-")
    assert head and version, key
    return head


def _lora_file(tmp_path) -> str:
    """A kohya LoRA on two attention linears of the tiny UNet."""
    rng = np.random.default_rng(4)
    sd = {}
    block = "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1"
    for target in ("to_q", "to_v"):
        sd[f"{block}_{target}.lora_down.weight"] = rng.standard_normal((4, 8)).astype(np.float32)
        sd[f"{block}_{target}.lora_up.weight"] = rng.standard_normal((8, 4)).astype(np.float32)
        sd[f"{block}_{target}.alpha"] = np.array(2.0, np.float32)
    path = str(tmp_path / "style.safetensors")
    PLD.write_safetensors(path, sd)
    return path


def _jax_keys(model_id: str, cfg, params, peers: int, sessions: int) -> list:
    """The keys the JAX key functions spell for ``cfg`` (the port's serving
    config, field for field): the engine's, every --multipeer bucket (the
    JAX ``peers`` key, ``sbucket`` below capacity) and every scheduler
    bucket (the JAX ``BatchScheduler.bucket_keys`` on a stand-in)."""
    jcfg = JENG.StreamConfig(**dataclasses.asdict(cfg))
    qextra = JENG.params_variant_extra(params)
    variants = ["capture", "cached"] if cfg.unet_cache_interval >= 2 else ["full"]

    def vx(v):
        return {"variant": v} if v != "full" else {}

    keys = [JENG.stream_engine_key(model_id, jcfg, **vx(v), **qextra) for v in variants]
    if peers:
        below = [1 << i for i in range(peers.bit_length()) if 1 << i < peers]
        keys += [JENG.stream_engine_key(model_id, jcfg, peers=peers,
                                        **({"sbucket": k} if k < peers else {}), **vx(v), **qextra)
                 for k in below + [peers] for v in variants]
    if sessions:
        sizes = [1 << i for i in range(sessions.bit_length()) if 1 << i < sessions] + [sessions]
        owner = SimpleNamespace(model_id=model_id, params=params, mesh=None, _adapter_rank=0,
                                cfg=jcfg, max_sessions=sessions, _bucket_sizes=sizes,
                                _variants=variants)
        keys += list(JBatchScheduler.bucket_keys(owner, model_id).values())
    return keys


BUILDS = {
    "plain": ([], {}),
    "lora": (["--lora", "{lora}:0.7"], {}),
    "controlnet": (["--controlnet", "tiny-cnet"], {}),
    "deepcache": (["--peers", "2", "--sched-buckets", "2"], {"UNET_CACHE": "3"}),
    "w8": ([], {"QUANT_WEIGHTS": "w8", "QUANT_MIN_SIZE": "64"}),
    "peers": (["--peers", "2"], {}),
    "sched_buckets": (["--sched-buckets", "2"], {}),
    "all": (["--peers", "3", "--sched-buckets", "4", "--lora", "{lora}"], {}),
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_preflight_keys_are_the_jax_keys(name, tmp_path, monkeypatch):
    argv, env = BUILDS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BATCHSCHED_DP", "2")  # the preflight pins dp=1, as the JAX CLI
    lora = _lora_file(tmp_path)
    argv = ["--model-id", "tiny-test", "--device", "cpu"] + [a.format(lora=lora) for a in argv]
    args, lora_dict = PBE.parse_args(argv)
    bundle, cfg = PBE.load_bundle("tiny-test", lora_dict or None, args.controlnet,
                                  torch.device("cpu"))
    got = PBE.main(argv)
    assert all(s is None for s in got.values())  # the CPU captures nothing
    want = _jax_keys("tiny-test", cfg, bundle.params, args.peers, args.sched_buckets)
    assert [_unversioned(k) for k in got] == [_unversioned(k) for k in want]
    assert all(k.endswith("--v-0.1.0+torch") for k in got)
    assert ("quant-w8" in next(iter(got))) == (name == "w8")
    assert ("cnet-1canny" in next(iter(got))) == (name == "controlnet")


def test_build_fuses_the_lora_and_returns_its_bundle(tmp_path):
    lora = _lora_file(tmp_path)
    keys, plain = PBE.build("tiny-test", device="cpu")
    fused_keys, fused = PBE.build("tiny-test", {lora: 0.7}, device="cpu")
    assert list(keys) == list(fused_keys)
    attn = fused.params["unet"]["down_blocks"][0]["attentions"][0]
    base = plain.params["unet"]["down_blocks"][0]["attentions"][0]
    blk, blk0 = attn["blocks"][0]["attn1"], base["blocks"][0]["attn1"]
    assert not torch.equal(blk["to_q"]["kernel"], blk0["to_q"]["kernel"])
    assert torch.equal(blk["to_k"]["kernel"], blk0["to_k"]["kernel"])


@pytest.mark.parametrize("specs", [
    ["a.safetensors:0.5"], ["b.safetensors"], ["c:d.safetensors:2"],
    ["a.safetensors:0.5", "b.safetensors", "a.safetensors:1.5"], [],
])
def test_cli_parses_loras_as_the_jax_main(specs, monkeypatch):
    seen = {}

    def fake_build(model_id, lora_dict=None, cache_dir=None, controlnet=None):
        seen["lora_dict"] = lora_dict
        return [], None

    monkeypatch.setattr(JBE, "build", fake_build)
    argv = sum((["--lora", s] for s in specs), ["--model-id", "tiny-test"])
    JBE.main(argv)
    _, lora_dict = PBE.parse_args(argv)
    assert (lora_dict or None) == seen["lora_dict"]


def test_cli_refuses_cache_dir_with_its_reason(capsys):
    with pytest.raises(SystemExit) as e:
        PBE.parse_args(["--model-id", "tiny-test", "--cache-dir", "/tmp/engines"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--cache-dir /tmp/engines" in err and "no engine store" in err


@pytest.mark.parametrize("attn", [None, "pallas"])
@pytest.mark.parametrize("model_id", ["tiny-test", "tiny-xl-test"])
def test_tiny_families_attend_through_the_kernel_on_the_card(model_id, attn, monkeypatch):
    """ATTN_IMPL unset or pallas: the tiny families take the attention
    kernel on the card as every family does (the wrapper pads tiny-test's
    head dim 4 to the kernel's 8); the CPU keys spell the same route."""
    if attn is None:
        monkeypatch.delenv("ATTN_IMPL", raising=False)
    else:
        monkeypatch.setenv("ATTN_IMPL", attn)
    for device in ("cuda", "cpu"):
        assert PREG.default_stream_config(model_id, device=device).attn_impl == "kernel"
    monkeypatch.setenv("ATTN_IMPL", "ring")
    assert PREG.default_stream_config(model_id, device="cuda").attn_impl == "ring"
