"""The port's invariant analyzer (ai_rtc_agent_tpu_torch/analysis/) against
the JAX package's (ai_rtc_agent_tpu/analysis/), on the CPU.

* Parity: the port's checkers, given the JAX tree's profile (built here from
  the JAX modules' own path constants, and literals where a JAX rule inlines
  them), give exactly the JAX checkers' findings, rule for rule, on every JAX
  fixture, on the port tree and on the JAX tree.  Suppressions read the same
  in both trees, so both apply them alike.
* The gate: ``python -m ai_rtc_agent_tpu_torch.analysis`` over the port exits
  0 against its empty baseline.
* The mechanics on sources written inline: suppressions, the shrink-only
  baseline, parse errors, the literal ``ROUTES`` tables and both knob tables.
* A regression test for each real fault the first triage found.
"""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

from ai_rtc_agent_tpu.analysis import bounded_queues as J_BQ
from ai_rtc_agent_tpu.analysis import core as J_CORE
from ai_rtc_agent_tpu.analysis import encoder_reconfig as J_ENC
from ai_rtc_agent_tpu.analysis import env_registry as J_ENV
from ai_rtc_agent_tpu.analysis import http_contract as J_HTTP
from ai_rtc_agent_tpu.analysis import refusal_discipline as J_REF
from ai_rtc_agent_tpu_torch.analysis import __main__ as P_MAIN
from ai_rtc_agent_tpu_torch.analysis import core as P_CORE
from ai_rtc_agent_tpu_torch.server import lifecycle
from ai_rtc_agent_tpu_torch.server import agent as PA
from ai_rtc_agent_tpu_torch.server import signaling as PS

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "static_analysis"
PORT_ROOTS = ("ai_rtc_agent_tpu_torch",)

JAX = P_CORE.Profile(
    roots=J_CORE.DEFAULT_ROOTS,
    package="ai_rtc_agent_tpu/",  # env_registry.py inlines both
    env_tier="ai_rtc_agent_tpu/utils/env.py",
    env_docs=(J_ENV.DOC_PATH,),
    env_unread_heading=None,
    http_doc=J_HTTP.DOC_PATH,
    wire=J_HTTP.WIRE_PATH,
    events=J_REF.EVENTS_PATH,
    codec=tuple(f for f in J_ENC._EXEMPT_FILES if f not in J_BQ._EXEMPT_FILES),
    vocab_exempt=J_REF._VOCAB_EXEMPT_PREFIXES,
    route_table=None,
    analysis=next(p for p in J_HTTP._EXEMPT_PREFIXES if p not in J_BQ._EXEMPT_PREFIXES),
    tooling_prefixes=J_BQ._EXEMPT_PREFIXES,
    tooling_files=J_BQ._EXEMPT_FILES,
)


def _rows(findings) -> list:
    return sorted((f.checker, f.path, f.line, f.name, f.scope, f.message) for f in findings)


def _jax_run(rules, **load):
    project, errs = J_CORE.load_project(REPO, **load)
    return errs, J_CORE.run_checkers(project, rules)


def _port_run(rules, profile=JAX, **load):
    project, errs = P_CORE.load_project(REPO, **load)
    return errs, P_CORE.run_checkers(project, rules, profile)


# the port's own device rules, rewritten for torch: device-transfer shares
# only its id with the JAX rule, capture-purity stands for trace-purity
DEVICE_RULES = ("device-transfer", "capture-purity")
# the rules the port copied from the JAX package, held to them rule for rule
SHARED_RULES = tuple(r for r in P_CORE.ALL_CHECKERS if r not in DEVICE_RULES)


def test_the_port_catalog_is_the_jax_one_less_the_device_rules():
    assert set(SHARED_RULES) == set(J_CORE.ALL_CHECKERS) - {"device-transfer", "trace-purity"}
    assert len(SHARED_RULES) == 16
    assert P_CORE.ALL_CHECKERS == SHARED_RULES + DEVICE_RULES
    assert P_CORE.PORT.roots == P_CORE.DEFAULT_ROOTS == PORT_ROOTS
    assert J_CORE.SUPPRESSION_RE.pattern == P_CORE.SUPPRESSION_RE.pattern
    assert not any("ai_rtc_agent_tpu/" in str(v) for v in vars(P_CORE.PORT).values())


# -- parity -----------------------------------------------------------------------------

@pytest.mark.parametrize("rule", SHARED_RULES)
def test_fixture_parity_with_the_jax_checker(rule):
    """Every JAX fixture, one at a time, through one rule: the same findings
    (suppression findings included)."""
    fixtures = sorted(FIXTURES.glob("*.py"))
    assert len(fixtures) >= 18
    fired = 0
    for path in fixtures:
        jerrs, want = _jax_run((rule,), files=[str(path)])
        perrs, got = _port_run((rule,), files=[str(path)])
        assert _rows(perrs) == _rows(jerrs) and _rows(got) == _rows(want), (rule, path.name)
        fired += sum(f.checker == rule and "fixtures" in f.path for f in want)
    assert fired, f"no fixture exercises {rule}"


@pytest.fixture(scope="module")
def port_tree_runs():
    return _jax_run(SHARED_RULES, roots=PORT_ROOTS), _port_run(SHARED_RULES, roots=PORT_ROOTS)


def test_port_tree_parity_with_the_jax_checkers(port_tree_runs):
    """The port tree under the JAX profile: exactly the JAX checkers'
    findings, and only findings a profile parameter closes (JAX paths for the
    env tier, the registries, the codec tier and the route tables)."""
    (jerrs, want), (perrs, got) = port_tree_runs
    assert not jerrs and not perrs
    assert _rows(got) == _rows(want)
    assert want and {f.checker for f in want} <= {"env-registry", "http-contract",
                                                  "encoder-reconfig"}


def test_jax_tree_parity_with_the_jax_checkers():
    jerrs, want = _jax_run(SHARED_RULES)
    perrs, got = _port_run(SHARED_RULES, roots=JAX.roots)
    assert _rows(perrs) == _rows(jerrs) and _rows(got) == _rows(want)


# -- the gate ---------------------------------------------------------------------------

def test_port_runs_clean_with_an_empty_baseline():
    assert json.loads(P_MAIN.BASELINE_PATH.read_text()) == {"findings": []}
    r = subprocess.run([sys.executable, "-m", "ai_rtc_agent_tpu_torch.analysis",
                        "--format", "json"], capture_output=True, text=True, cwd=str(REPO),
                       timeout=300)
    out = json.loads(r.stdout)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    assert out["findings"] == [] and out["new"] == [] and out["stale_baseline"] == []
    assert out["scanned_files"] > 100


# -- mechanics on inline sources --------------------------------------------------------

def _tree(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return root


def _scan(root: Path, rules=None, profile=P_CORE.PORT, files=None):
    project, errs = P_CORE.load_project(root, roots=profile.roots, files=files)
    return errs + P_CORE.run_checkers(project, rules, profile)


PKG = "ai_rtc_agent_tpu_torch/"
SUPPRESSIONS = '''\
"""A docstring quoting the syntax is no suppression:
    time.sleep(1)  # tpurtc: allow[async-blocking] -- quoted
"""
import time


async def reasoned():
    # tpurtc: allow[async-blocking] -- a reasoned allow
    time.sleep(0.001)


async def reasonless():
    time.sleep(0.002)  # tpurtc: allow[async-blocking]


def unused():
    # tpurtc: allow[bounded-queue] -- nothing here is flagged
    return 1
'''


def test_suppression_mechanics(tmp_path):
    root = _tree(tmp_path, {PKG + "mod.py": SUPPRESSIONS})
    fs = _scan(root, ("async-blocking", "bounded-queue"))
    got = sorted((f.checker, f.line, f.scope) for f in fs)
    # the reasoned allow suppressed its finding; the reasonless one does not
    # suppress and is a finding itself; the unused allow is a finding; the
    # docstring's quoted allow is neither
    assert got == [("async-blocking", 13, "reasonless"), ("suppression", 13, "<module>"),
                   ("suppression", 17, "<module>")]
    assert "without a reason" in fs[1].message and "unused" in fs[2].message
    # an allow for a rule this run skipped cannot be proven unused
    skipped = _scan(root, ("async-blocking",))
    assert [(f.checker, f.line) for f in skipped] == [("async-blocking", 13),
                                                      ("suppression", 13)]
    # a project checked twice reports the same (suppression use is per run)
    project, _ = P_CORE.load_project(root)
    first = _rows(P_CORE.run_checkers(project, ("async-blocking", "bounded-queue")))
    assert _rows(P_CORE.run_checkers(project, ("async-blocking", "bounded-queue"))) == first


def test_an_unparseable_file_is_a_finding(tmp_path):
    root = _tree(tmp_path, {PKG + "ok.py": "X = 1\n", PKG + "broken.py": "def f(:\n"})
    fs = _scan(root)
    assert [(f.checker, f.path, f.name) for f in fs] == [
        ("parse-error", PKG + "broken.py", "broken.py")]
    assert P_MAIN.main(["--root", str(root), "--baseline", str(tmp_path / "b.json")]) == 1


QUEUE = "import collections\n\n\ndef make():\n    return collections.deque()\n"


def test_the_baseline_only_shrinks(tmp_path, capsys):
    root = _tree(tmp_path / "repo", {PKG + "q.py": QUEUE})
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"findings": []}))
    (finding,) = _scan(root)
    key = finding.key()
    argv = ["--root", str(root), "--baseline", str(baseline)]
    assert P_MAIN.main(argv) == 1  # a finding the baseline does not list
    # growth is refused, and the file stays as it was
    assert P_MAIN.main(argv + ["--update-baseline"]) == 1
    assert json.loads(baseline.read_text()) == {"findings": []}
    # a partial scan refuses to rewrite it
    assert P_MAIN.main(argv + ["--update-baseline", str(root / PKG / "q.py")]) == 2
    # a listed finding passes; once it is fixed the entry is stale until removed
    baseline.write_text(json.dumps({"findings": [key]}))
    assert P_MAIN.main(argv) == 0
    (root / PKG / "q.py").write_text(QUEUE.replace("deque()", "deque(maxlen=4)"))
    assert P_MAIN.main(argv) == 1
    assert P_MAIN.main(argv + ["--update-baseline"]) == 0
    assert json.loads(baseline.read_text()) == {"findings": []}
    assert P_MAIN.main(argv) == 0
    capsys.readouterr()


ROUTES_DOC = """# HTTP API

| Method | Path | Purpose |
|---|---|---|
| `GET` | `/` | health |
| `POST` | `/config` | runtime config |
"""

ROUTES_AGENT = '''\
ROUTES = (
    ("GET", "/"),
    ("POST", "/config"),
)


def build(app, serve):
    for method, path in ROUTES:
        app.router.add_route(method, path, serve)
'''


def _routes(tmp_path, agent: str, extra=None):
    files = {"docs/http-api.md": ROUTES_DOC, PKG + "server/agent.py": agent}
    files.update(extra or {})
    return [(f.path, f.name) for f in _scan(_tree(tmp_path, files), ("http-contract",))]


def test_a_literal_routes_table_registers_its_rows(tmp_path):
    assert _routes(tmp_path / "a", ROUTES_AGENT) == []
    # a table served by another module's loop (``routing.ROUTES``) registers too
    table = ROUTES_AGENT.split("\n\n\n")[0] + "\n"
    router = "from . import agent\n\n\ndef build(app, h):\n" \
             "    for m, p in agent.ROUTES:\n        app.router.add_get(p, h)\n"
    assert _routes(tmp_path / "b", table, {PKG + "server/router.py": router}) == []
    # without a registering loop the table is only a tuple: the rows are stale
    assert _routes(tmp_path / "c", table) == [("docs/http-api.md", "GET /"),
                                              ("docs/http-api.md", "POST /config")]
    # an undocumented row is a finding at its line
    grown = ROUTES_AGENT.replace('("POST", "/config"),', '("POST", "/config"),\n'
                                 '    ("DELETE", "/nowhere"),')
    assert _routes(tmp_path / "d", grown) == [(PKG + "server/agent.py", "DELETE /nowhere")]


def test_a_non_literal_routes_row_is_a_finding(tmp_path):
    agent = "PATH = '/config'\n" + ROUTES_AGENT.replace('("POST", "/config")',
                                                         '("POST", PATH)')
    fs = _scan(_tree(tmp_path, {"docs/http-api.md": ROUTES_DOC,
                                PKG + "server/agent.py": agent}), ("http-contract",))
    assert sorted((f.path, f.line, f.name) for f in fs) == [
        (PKG + "server/agent.py", 4, "<dynamic-route>"),
        ("docs/http-api.md", 6, "POST /config")]


ENV_DOC = """# Environment

| Variable | Default | Purpose |
|---|---|---|
| `SHARED_KNOB` | 1 | read by both agents |
| `JAX_ONLY_KNOB` | 1 | left unread by the port |
"""

PORT_ENV = """# Port

## Knobs only the port reads

| Variable | Default | Purpose |
|---|---|---|
| `PORT_KNOB` | 1 | the port's own |

## Knobs the port does not read

| Variable | Why |
|---|---|
| `JAX_ONLY_KNOB` | a reason |
"""

READS = "from .utils import env\n\nA = env.get_int('SHARED_KNOB', 1)\n" \
        "B = env.get_int('PORT_KNOB', 1)\n"


def _knobs(tmp_path, reads=READS, port_env=PORT_ENV):
    root = _tree(tmp_path, {"docs/environment.md": ENV_DOC, PKG + "environment.md": port_env,
                            PKG + "utils/env.py": "import os\n", PKG + "mod.py": reads})
    return sorted((f.path, f.name, f.message.split(" — ")[0])
                  for f in _scan(root, ("env-registry",)))


def test_the_knob_tables(tmp_path):
    assert _knobs(tmp_path / "clean") == []
    # a knob the port reads that no table documents
    assert _knobs(tmp_path / "new", READS + "C = env.get_str('NEW_KNOB')\n") == [
        (PKG + "mod.py", "NEW_KNOB", "env knob NEW_KNOB is read here but not documented "
         f"in docs/environment.md or {PKG}environment.md")]
    # a port-only row with no read site is an unread knob
    assert _knobs(tmp_path / "dead", READS.replace("PORT_KNOB", "SHARED_KNOB")) == [
        (PKG + "environment.md", "PORT_KNOB",
         "documented env knob PORT_KNOB has no read site in the scan set")]
    # an exemption whose knob gains a read site is stale
    assert _knobs(tmp_path / "read", READS + "D = env.get_int('JAX_ONLY_KNOB', 1)\n") == [
        (PKG + "environment.md", "JAX_ONLY_KNOB", "stale exemption: env knob JAX_ONLY_KNOB "
         "is listed as unread but now has a read site")]
    # so is one that no other table documents
    assert _knobs(tmp_path / "gone", port_env=PORT_ENV + "| `NOWHERE_KNOB` | a reason |\n") == [
        (PKG + "environment.md", "NOWHERE_KNOB", "stale exemption: env knob NOWHERE_KNOB "
         "is listed as unread but is documented in no other table")]
    # without the exemption the unread JAX knob is a finding
    assert _knobs(tmp_path / "bare", port_env=PORT_ENV.split("## Knobs the port")[0]) == [
        ("docs/environment.md", "JAX_ONLY_KNOB",
         "documented env knob JAX_ONLY_KNOB has no read site in the scan set")]
    # a raw read in the package is a finding; the env tier itself may read raw
    assert _knobs(tmp_path / "raw", READS + "import os\nE = os.environ.get('SHARED_KNOB')\n") == [
        (PKG + "mod.py", "SHARED_KNOB", "raw env read of SHARED_KNOB")]


# -- regressions of the faults the triage found -----------------------------------------

class _ChokingScheduler:
    """A batch scheduler whose restore raises what no refusal names."""

    on_step = None

    def restore_session(self, snapshot, session_key=None):
        raise RuntimeError("restore blew up")

    def snapshot(self):
        return {}

    def close(self):
        pass


def test_a_handoff_restore_that_raises_frees_its_admission_and_boots(monkeypatch, tmp_path):
    """A recycled replacement whose restore of one handoff session raises
    something other than SnapshotMismatch/CapacityError: that session's
    admission token goes back, the agent still starts, and the other sessions
    of the handoff are parked."""
    handoff = str(tmp_path / "handoff.json")
    lifecycle.write_handoff(handoff, [
        {"session": "bad", "room_id": "r", "snapshot": {"kind": "scheduler", "schema": 1}},
        {"session": "good", "room_id": "r", "snapshot": {"kind": "control-plane"}},
    ], {"worker_id": "a", "webhook": {"url": None, "token": None}})
    for name, value in (("RECYCLE_HANDOFF", handoff), ("SUPERVISOR", "0"),
                        ("OVERLOAD_CONTROL", "1"), ("ENGINE_GUARD", "0")):
        monkeypatch.setenv(name, value)

    async def go():
        app = PA.build_app(pipeline=object(), provider=PS.LoopbackProvider(),
                           batch_scheduler=_ChokingScheduler(), device="cpu")
        client = TestClient(TestServer(app))
        await client.start_server()  # on_startup runs the import
        try:
            return sorted(app["imported_sessions"]), sorted(app["overload"]._pending)
        finally:
            await client.close()

    assert asyncio.run(go()) == (["rcy-good"], ["rcy-good"])
