"""The family seam (families.py): a configuration's model comes from the
family module that its file names.  A new family is taken with new files
alone; a configuration whose family has no module is refused; the
``sd_unet`` family is the code the harness ran before the seam; the
program gets every stream setting that the configuration states, and a
setting it does not take is refused."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from benchmark import compare, families, harness
from benchmark import roofline as RF
from benchmark import run as R
from benchmark.tests import _tiny

SEED = 2**32 + 29
ARGS = ["--workload", _tiny.WORKLOAD, "--seed", str(SEED), "--seconds", "1.5"]
STUB_SHAPE = (64, 77, 2, 8)  # (Lq, Lk, H, D) of the stub's one attention launch
STUB = f'''

import dataclasses


@dataclasses.dataclass(frozen=True)
class Launch:  # a family module may hold its geometry in dataclasses
    shape: tuple = {STUB_SHAPE!r}


def attention_shapes(cfg, rows):
    return [(rows, *Launch().shape)]


def stateless(s):
    return True
'''
# the stream settings the harness handed StreamConfig before the seam
OLD_STREAM_KEYS = ("mode", "height", "width", "latent_scale", "t_index_list",
                   "num_inference_steps", "timestep_spacing", "scheduler", "cfg_type", "dtype",
                   "attn_impl", "use_fused_epilogue")
CONFIGS = sorted((_tiny.BENCH / "configs").glob("*.json")) + [_tiny.HERE / "tiny-ring.json"]


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_family_needs_only_new_files(monkeypatch, tmp_path):
    """A checkout of the whole benchmark gains a family module, a
    configuration that names it and their BENCHMARK.json entries; every
    model-specific step then resolves to the new module, and no file the
    benchmark had changes but BENCHMARK.json."""
    root = _tiny.checkout(tmp_path)
    shutil.copytree(_tiny.BENCH, root / "benchmark", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _files(root)

    ref = root / "benchmark" / "reference"
    (ref / "stub_family.py").write_text((ref / "sd_unet.py").read_text() + STUB)
    cfg = dict(_tiny.config(), name="stub-ring", family="stub_family")
    (root / "benchmark" / "configs" / "stub-ring.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stub-ring", "source": "stub",
                             "file": "benchmark/configs/stub-ring.json", "reduced": [],
                             "why": "stub"})
    bench["workloads"].append({"name": "stub-ring.tiny2", "config": "stub-ring",
                               "traffic": "tiny2", "chips": 1, "why": "stub"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    monkeypatch.setattr(families, "ROOT", root)
    _, got, traffic, _ = R.load_cell(root, "stub-ring.tiny2")
    assert got == cfg
    assert Path(families.of(got).__file__).resolve() == (ref / "stub_family.py").resolve()
    assert RF.attention_shapes(got, 3) == [(3, *STUB_SHAPE)]
    assert RF.attention_bound_s(got, 3) == RF.bound_s(*RF.attention_work((3, *STUB_SHAPE)))
    assert compare.plan_checks(got, traffic, SEED)["mode"] == "sample"
    # the configuration it was copied from keeps its own family there
    _, tiny, _, _ = R.load_cell(root, _tiny.WORKLOAD)
    assert Path(families.of(tiny).__file__).resolve() == (ref / "sd_unet.py").resolve()
    assert len(RF.attention_shapes(tiny, 3)) == 8  # tiny-test: 4 transformer blocks a pass
    assert compare.plan_checks(tiny, traffic, SEED)["mode"] == "replay"

    after = _files(root)
    assert set(after) - set(before) == {"benchmark/reference/stub_family.py",
                                        "benchmark/configs/stub-ring.json"}
    assert {k for k in before if after[k] != before[k]} == {"BENCHMARK.json"}


@pytest.mark.parametrize("family", ["no_such_family", None], ids=["unknown", "missing"])
def test_a_config_without_a_family_module_is_refused(monkeypatch, tmp_path, capsys, family):
    cfg = _tiny.config()
    if family is None:
        del cfg["family"]
    else:
        cfg["family"] = family
    monkeypatch.setattr(R, "ROOT", _tiny.checkout(tmp_path, cfg))
    assert R.main(ARGS) == 2
    cap = capsys.readouterr()
    assert cap.out == ""
    want = (str(tmp_path / "benchmark" / "reference" / f"{family}.py") if family
            else "names no family")
    assert want in cap.err


def _leaves(tree, at=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{at}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{at}/{i}")
    else:
        yield at, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sd_unet_family_is_the_old_code(dtype):
    import torch

    from benchmark.reference import params as P
    from benchmark.reference import stream as S

    cfg = _tiny.config()
    fam = families.of(cfg)
    assert Path(fam.__file__).name == "sd_unet.py"
    assert (fam.Reference, fam.stateless) == (S.Reference, S.stateless)
    dt = getattr(torch, dtype)
    new = list(_leaves(fam.make_tree(cfg, SEED, "cpu", dt)))
    old = list(_leaves(P.make_tree(cfg, SEED, "cpu", dt)))
    assert [k for k, _ in new] == [k for k, _ in old]
    for (k, a), (_, b) in zip(new, old):
        assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b)), k


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_shipped_configs_build_the_old_stream_config(path):
    from ai_rtc_agent_tpu_torch.stream.engine import StreamConfig

    s = json.loads(path.read_text())["stream"]
    assert set(s) == set(OLD_STREAM_KEYS) | set(harness.SCHEDULER_KEYS)
    old = StreamConfig(
        mode=s["mode"], height=s["height"], width=s["width"], latent_scale=s["latent_scale"],
        t_index_list=tuple(s["t_index_list"]), num_inference_steps=s["num_inference_steps"],
        timestep_spacing=s["timestep_spacing"], scheduler=s["scheduler"], cfg_type=s["cfg_type"],
        dtype=s["dtype"], attn_impl=s["attn_impl"], use_fused_epilogue=s["use_fused_epilogue"])
    assert harness.stream_config(s) == old


def test_a_stream_field_reaches_the_program():
    cfg = _tiny.config()
    cfg["stream"].update(unet_cache_interval=2, latent_channels=4)
    scfg = harness.stream_config(cfg["stream"])
    assert (scfg.unet_cache_interval, scfg.latent_channels) == (2, 4)
    assert scfg.t_index_list == tuple(cfg["stream"]["t_index_list"])


def test_an_unknown_stream_setting_is_refused_at_build():
    cfg = _tiny.config()
    cfg["stream"]["guidance_scal"] = 1.2  # a misspelt key is not dropped
    with pytest.raises(ValueError, match="guidance_scal"):
        harness.build(cfg, None, 1, "cpu")
