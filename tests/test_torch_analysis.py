"""mlt-lint for the port (``mlrun_tpu_torch/analysis/``) against the
reference's (``mlrun_tpu/analysis/``).

Every case of tests/test_analysis.py runs on both packages: each package's
fixture repo holds that package's own ``chaos/registry.py`` and
``config.py`` plus the repo's two ``docs/`` tables, the same seeded
sources go under each package's directory, and each lint must give the
same codes, lines and suppressed counts (only the package prefix
differs). MLT006's cases use each package's own idiom: ``mlconf`` chains
in the reference, ``run_config`` / ``service_config`` keys and the
``*_DEFAULTS`` dicts' subscripts in the port.

Then the port's own cases: every torch device sync under a checked lock
(MLT004), directly and one ``self.`` call deep; misspelt config keys in
each of the port's spellings (MLT006); ``python -m
mlrun_tpu_torch.analysis mlrun_tpu_torch`` clean; and seeded regressions
copied into real port modules caught.
"""

import importlib
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _package(name: str) -> SimpleNamespace:
    analysis = importlib.import_module(f"{name}.analysis")
    return SimpleNamespace(
        name=name, analysis=analysis,
        engine=importlib.import_module(f"{name}.analysis.engine"),
        cli=importlib.import_module(f"{name}.analysis.__main__"))


PACKAGES = {"jax": "mlrun_tpu", "port": "mlrun_tpu_torch"}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request) -> SimpleNamespace:
    return _package(PACKAGES[request.param])


@pytest.fixture()
def port() -> SimpleNamespace:
    return _package("mlrun_tpu_torch")


def _codes(result):
    return sorted({f.code for f in result.findings})


def _lines(result, code=None):
    return [(f.code, f.line) for f in result.findings
            if code is None or f.code == code]


def _skeleton(root, name: str, dirs=("chaos", "serving", "service", "obs"),
              docs=True):
    """A minimal repo skeleton under ``root``: package ``name`` with its
    REAL chaos registry and config defaults, and the docs tables."""
    pkg_dir = root / name
    for sub in dirs:
        (pkg_dir / sub).mkdir(parents=True, exist_ok=True)
    (pkg_dir / "__init__.py").write_text("")
    shutil.copy(os.path.join(REPO, name, "chaos", "registry.py"),
                pkg_dir / "chaos" / "registry.py")
    shutil.copy(os.path.join(REPO, name, "config.py"), pkg_dir / "config.py")
    if docs:
        (root / "docs").mkdir()
        for doc in ("fault_tolerance.md", "observability.md"):
            shutil.copy(os.path.join(REPO, "docs", doc), root / "docs" / doc)
    return root


@pytest.fixture()
def fixture_repo(tmp_path, pkg):
    return _skeleton(tmp_path, pkg.name)


def _write(fixture_repo, pkg, rel, source):
    path = fixture_repo / rel.format(pkg=pkg.name)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return str(path)


def _run(fixture_repo, pkg, *rels):
    paths = [str(fixture_repo / rel.format(pkg=pkg.name)) for rel in rels] \
        or [str(fixture_repo / pkg.name)]
    return pkg.analysis.run_analysis(paths, root=str(fixture_repo))


# -- MLT001 chaos coherence --------------------------------------------------

def test_mlt001_undeclared_literal_fire(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           "from ..chaos import fire\n"
           "def f():\n"
           "    fire('llm.sumbit')\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/x.py")
    assert _lines(result) == [("MLT001", 3)]
    assert "llm.sumbit" in result.findings[0].message


def test_mlt001_unknown_faultpoints_attribute(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           "from ..chaos import FaultPoints, fire\n"
           "def f():\n"
           "    fire(FaultPoints.llm_sumbit)\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/x.py")
    assert _lines(result) == [("MLT001", 3)]
    assert "llm_sumbit" in result.findings[0].message


def test_mlt001_tests_fire_synthetic_points_freely(fixture_repo, pkg):
    _write(fixture_repo, pkg, "tests/test_x.py",
           "def f(registry):\n"
           "    registry.fire('p')\n")
    result = _run(fixture_repo, pkg, "tests/test_x.py")
    assert not [f for f in result.findings if f.code == "MLT001"]


def test_mlt001_suppressed_with_reason(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           "from ..chaos import fire\n"
           "def f():\n"
           "    fire('x.y')  "
           "# mlt: ignore[MLT001]: staged point, lands next PR\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/x.py")
    assert result.findings == []
    assert [(s["code"], s["line"]) for s in result.suppressed] == [
        ("MLT001", 3)]
    assert result.suppressed[0]["reason"] == "staged point, lands next PR"


# -- MLT002 metrics discipline -----------------------------------------------

def test_mlt002_duplicate_constructor_site(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/obs/fams.py",
           "A = REGISTRY.counter('mlt_x_total', 'x', labels=('k',))\n")
    _write(fixture_repo, pkg, "{pkg}/serving/y.py",
           "B = REGISTRY.counter('mlt_x_total', 'x', labels=('k',))\n")
    result = _run(fixture_repo, pkg)
    hits = [f for f in result.findings
            if f.code == "MLT002" and "declared again" in f.message]
    assert [(f.path, f.line) for f in hits] == [
        (f"{pkg.name}/serving/y.py", 1)]


def test_mlt002_label_key_disagreement(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/obs/fams.py",
           "A = REGISTRY.counter('mlt_x_total', 'x',\n"
           "                     labels=('engine', 'event'))\n"
           "def f():\n"
           "    A.inc(engine='e', event='ok')\n"
           "    A.inc(engine='e', evnt='typo')\n")
    result = _run(fixture_repo, pkg)
    hits = [f for f in result.findings
            if f.code == "MLT002" and "disagree" in f.message]
    assert [f.line for f in hits] == [5]
    assert "evnt" in hits[0].message


def test_mlt002_engine_module_must_retire_replica_series(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/obs/fams.py",
           "G = REGISTRY.gauge('mlt_q_depth', 'q',\n"
           "                   labels=('replica',))\n")
    _write(fixture_repo, pkg, "{pkg}/serving/llm_batch.py",
           "from ..obs.fams import G\n"
           "class Engine:\n"
           "    def observe(self):\n"
           "        G.set(1.0, replica='r0')\n")
    result = _run(fixture_repo, pkg)
    assert [(f.path, f.line) for f in result.findings
            if f.code == "MLT002" and "stop/retire" in f.message] == [
        (f"{pkg.name}/serving/llm_batch.py", 1)]
    # referencing the family from a stop path satisfies the contract
    _write(fixture_repo, pkg, "{pkg}/serving/llm_batch.py",
           "from ..obs.fams import G\n"
           "class Engine:\n"
           "    def observe(self):\n"
           "        G.set(1.0, replica='r0')\n"
           "    def stop(self):\n"
           "        G.remove(replica='r0')\n")
    result = _run(fixture_repo, pkg)
    assert not [f for f in result.findings
                if f.code == "MLT002" and "stop/retire" in f.message]


def test_mlt002_docs_coverage(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/obs/fams.py",
           "A = REGISTRY.counter('mlt_totally_new_total', 'x')\n")
    result = _run(fixture_repo, pkg)
    assert [(f.path, f.line) for f in result.findings
            if f.code == "MLT002" and "observability.md" in f.message] == [
        (f"{pkg.name}/obs/fams.py", 1)]


# -- MLT003 explicit-now -----------------------------------------------------

def test_mlt003_wall_clock_in_autoscaler_tick(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/service/autoscaler.py",
           "import time\n"
           "class FleetAutoscaler:\n"
           "    def tick(self):\n"
           "        return time.time()\n")
    result = _run(fixture_repo, pkg, "{pkg}/service/autoscaler.py")
    assert _lines(result) == [("MLT003", 4)]
    assert "FleetAutoscaler.tick" in result.findings[0].message


def test_mlt003_bare_import_and_non_control_module(fixture_repo, pkg):
    # `from time import monotonic` is still a wall-clock read
    _write(fixture_repo, pkg, "{pkg}/serving/canary.py",
           "from time import monotonic\n"
           "def split():\n"
           "    return monotonic()\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/canary.py")
    assert _lines(result) == [("MLT003", 3)]
    # the same code in a non-control-loop module is fine
    _write(fixture_repo, pkg, "{pkg}/serving/other.py",
           "from time import monotonic\n"
           "def split():\n"
           "    return monotonic()\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/other.py")
    assert result.findings == []


# -- MLT004 blocking under lock ----------------------------------------------

def test_mlt004_direct_block_under_scheduler_lock(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/llm_batch.py",
           "import time\n"
           "class Engine:\n"
           "    def _loop(self):\n"
           "        with self._lock:\n"
           "            time.sleep(0.1)\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/llm_batch.py")
    assert _lines(result) == [("MLT004", 5)]


def test_mlt004_transitive_block_via_intra_module_summary(fixture_repo,
                                                           pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/adapters.py",
           "class Registry:\n"
           "    def _fetch(self):\n"
           "        return self._artifact.result()\n"
           "    def load(self):\n"
           "        with self._bank_lock:\n"
           "            self._fetch()\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/adapters.py")
    assert _lines(result) == [("MLT004", 6)]
    assert "_fetch" in result.findings[0].message


def test_mlt004_bounded_and_outside_lock_ok(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/fleet.py",
           "import time\n"
           "class Fleet:\n"
           "    def dispatch(self):\n"
           "        with self._lock:\n"
           "            node = self._ring.lookup()\n"
           "            fut = self._pool.submit(node)\n"
           "            fut.result(timeout=5.0)\n"
           "        time.sleep(0.1)\n"
           "        return node\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/fleet.py")
    assert result.findings == []


def test_mlt004_nested_def_under_lock_not_charged(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/fleet.py",
           "import time\n"
           "class Fleet:\n"
           "    def arm(self):\n"
           "        with self._lock:\n"
           "            def later():\n"
           "                time.sleep(1.0)\n"
           "            self._cb = later\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/fleet.py")
    assert result.findings == []


def test_mlt004_positional_none_and_acquire_blocking(fixture_repo, pkg):
    # .result(None)/.wait(None) are the UNBOUNDED spelling;
    # .acquire(True)'s first positional is `blocking`, not a timeout
    _write(fixture_repo, pkg, "{pkg}/serving/llm_batch.py",
           "class Engine:\n"
           "    def a(self):\n"
           "        with self._lock:\n"
           "            self._fut.result(None)\n"
           "    def b(self):\n"
           "        with self._lock:\n"
           "            self._done.wait(None)\n"
           "    def c(self):\n"
           "        with self._lock:\n"
           "            self._other.acquire(True)\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/llm_batch.py")
    assert _lines(result) == [("MLT004", 4), ("MLT004", 7), ("MLT004", 10)]
    # and the bounded spellings stay clean
    _write(fixture_repo, pkg, "{pkg}/serving/llm_batch.py",
           "class Engine:\n"
           "    def a(self):\n"
           "        with self._lock:\n"
           "            self._fut.result(2.0)\n"
           "            self._done.wait(timeout=1.0)\n"
           "            self._other.acquire(False)\n"
           "            self._other.acquire(True, 5.0)\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/llm_batch.py")
    assert result.findings == []


def test_mlt002_same_var_name_two_modules_no_crosstalk(fixture_repo, pkg):
    # two modules reusing one binding name for different families must
    # not be checked against each other's label sets
    _write(fixture_repo, pkg, "{pkg}/obs/a.py",
           "EVENTS = REGISTRY.counter('mlt_aa_total', 'a',\n"
           "                          labels=('x',))\n"
           "def f():\n"
           "    EVENTS.inc(x='1')\n")
    _write(fixture_repo, pkg, "{pkg}/obs/b.py",
           "EVENTS = REGISTRY.counter('mlt_bb_total', 'b',\n"
           "                          labels=('y',))\n"
           "def f():\n"
           "    EVENTS.inc(y='1')\n")
    result = _run(fixture_repo, pkg)
    assert not [f for f in result.findings
                if f.code == "MLT002" and "disagree" in f.message]


def test_mlt003_class_body_clock_read(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/canary.py",
           "import time\n"
           "class CanaryRouter:\n"
           "    _epoch = time.time()\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/canary.py")
    assert _lines(result) == [("MLT003", 3)]
    assert "import-time" in result.findings[0].message


def test_mlt000_stale_suppression_matched_nothing(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           "def ok():  # mlt: ignore[MLT005]: raise removed long ago\n"
           "    return 1\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/x.py")
    assert _lines(result) == [("MLT000", 1)]
    assert "matched no finding" in result.findings[0].message


# -- MLT005 typed errors -----------------------------------------------------

def test_mlt005_bare_runtimeerror_on_serving_path(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           "def handle(event):\n"
           "    raise RuntimeError('boom')\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/x.py")
    assert _lines(result) == [("MLT005", 2)]


def test_mlt005_typed_and_nonserving_ok(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           "from .resilience import EngineStoppedError\n"
           "def handle(event):\n"
           "    raise EngineStoppedError('stopped')\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/x.py")
    assert result.findings == []
    _write(fixture_repo, pkg, "{pkg}/service/y.py",
           "def boot():\n"
           "    raise RuntimeError('config broken')\n")
    result = _run(fixture_repo, pkg, "{pkg}/service/y.py")
    assert result.findings == []


# -- MLT006 config keys: each package's own idiom ----------------------------

#: (imports, expression) per package; the typo is "prefil_chunk" both ways
TYPOED_CHAIN = {
    "mlrun_tpu": ("from ..config import mlconf\n",
                  "mlconf.serving.llm.prefil_chunk",
                  "serving.llm.prefil_chunk"),
    "mlrun_tpu_torch": ("from ..config import SERVING_LLM_DEFAULTS\n",
                        "SERVING_LLM_DEFAULTS['prefil_chunk']",
                        "SERVING_LLM_DEFAULTS['prefil_chunk']"),
}
TYPOED_GET = {
    "mlrun_tpu": ("from ..config import mlconf\n",
                  "mlconf.serving.llm.get('prefil_chunk', 64)"),
    "mlrun_tpu_torch": ("from ..config import SERVING_LLM_DEFAULTS\n",
                        "SERVING_LLM_DEFAULTS.get('prefil_chunk', 64)"),
}
VALID = {
    "mlrun_tpu": ("from ..config import mlconf\n",
                  ("mlconf.serving.llm.prefill_chunk",
                   "mlconf.api_base_path.rstrip('/')",
                   "mlconf.resolve_artifact_path('p')",
                   "mlconf.observability.get('metrics_enabled', True)")),
    "mlrun_tpu_torch": ("from ..config import (OBSERVABILITY_DEFAULTS,\n"
                        "    SERVING_LLM_DEFAULTS, run_config,\n"
                        "    service_config)\n",
                        ("SERVING_LLM_DEFAULTS['prefill_chunk']",
                         "run_config('default_project').rstrip('/')",
                         "service_config('httpdb.port')",
                         "OBSERVABILITY_DEFAULTS.get('metrics_enabled',"
                         " True)")),
}
STORE = {
    "mlrun_tpu": ("from ..config import mlconf\n",
                  "mlconf.serving.brand_new_knob = 1"),
    "mlrun_tpu_torch": ("from ..config import SERVING_LLM_DEFAULTS\n",
                        "SERVING_LLM_DEFAULTS['brand_new_knob'] = 1"),
}


def test_mlt006_typoed_chain(fixture_repo, pkg):
    imports, expr, named = TYPOED_CHAIN[pkg.name]
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           f"{imports}def f():\n    return {expr}\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/x.py")
    assert _lines(result) == [("MLT006", 3)]
    assert named in result.findings[0].message


def test_mlt006_get_with_typoed_key(fixture_repo, pkg):
    imports, expr = TYPOED_GET[pkg.name]
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           f"{imports}def f():\n    return {expr}\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/x.py")
    assert _lines(result) == [("MLT006", 3)]


def test_mlt006_valid_chains_methods_and_leaf_attrs(fixture_repo, pkg):
    imports, exprs = VALID[pkg.name]
    body = "".join(f"    v{i} = {e}\n" for i, e in enumerate(exprs))
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           f"{imports}def f():\n{body}    return v0\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/x.py")
    assert result.findings == []


def test_mlt006_store_context_not_validated(fixture_repo, pkg):
    # tests and callers create keys legitimately — only reads are
    # validated
    imports, stmt = STORE[pkg.name]
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           f"{imports}def f():\n    {stmt}\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/x.py")
    assert result.findings == []


# -- MLT000 suppression hygiene ----------------------------------------------

def test_mlt000_suppression_without_reason(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           "def handle(event):\n"
           "    raise RuntimeError('boom')  # mlt: ignore[MLT005]\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/x.py")
    # the unreasoned suppression is itself a finding AND does not
    # suppress
    assert _lines(result) == [("MLT000", 2), ("MLT005", 2)]


def test_parse_suppressions_syntax(pkg):
    sups, findings = pkg.analysis.parse_suppressions(
        "x = 1  # mlt: ignore[MLT001,MLT004]: two codes, one reason\n"
        "y = 2  # mlt: ignore[bogus]: bad code\n", "f.py")
    assert len(sups) == 1 and sups[0].codes == ("MLT001", "MLT004")
    assert [(f.code, f.line) for f in findings] == [("MLT000", 2)]


# -- determinism -------------------------------------------------------------

def test_determinism_same_tree_same_findings(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           "from ..chaos import fire\n"
           "def f():\n"
           "    fire('nope.a')\n"
           "    fire('nope.b')\n"
           "    raise RuntimeError('x')\n")
    first = _run(fixture_repo, pkg)
    second = _run(fixture_repo, pkg)
    assert [f.to_dict() for f in first.findings] \
        == [f.to_dict() for f in second.findings]
    assert pkg.engine.render_json(first) == pkg.engine.render_json(second)
    # stable ordering: sorted on (path, line, code, message)
    keys = [f.sort_key() for f in first.findings]
    assert keys == sorted(keys)
    assert [(f.code, f.line) for f in first.findings
            if f.path == f"{pkg.name}/serving/x.py"] == [
        ("MLT001", 3), ("MLT001", 4), ("MLT005", 5)]


def test_renderers_round_trip(fixture_repo, pkg):
    _write(fixture_repo, pkg, "{pkg}/serving/x.py",
           "def handle(event):\n"
           "    raise RuntimeError('boom')\n")
    result = _run(fixture_repo, pkg, "{pkg}/serving/x.py")
    payload = json.loads(pkg.engine.render_json(result))
    assert payload["ok"] is False
    assert [(f["code"], f["path"], f["line"])
            for f in payload["findings"]] == [
        ("MLT005", f"{pkg.name}/serving/x.py", 2)]
    human = pkg.engine.render_human(result)
    assert "MLT005" in human and "mlt-lint:" in human
    assert all(code in pkg.analysis.CODES for code in _codes(result))


# -- the binding pass over the real package ----------------------------------

def test_real_package_zero_unsuppressed_findings(pkg):
    """The machine-checked baseline: the analyzer over each package must
    be clean — every violation fixed, allowlisted with a rationale, or
    suppressed with a reason."""
    result = pkg.analysis.run_analysis([os.path.join(REPO, pkg.name)],
                                       root=REPO)
    assert result.parse_errors == []
    rendered = "\n".join(f.render() for f in result.findings)
    assert result.findings == [], f"unsuppressed findings:\n{rendered}"
    assert result.suppressed == []


def test_seeded_regressions_caught_in_real_modules(tmp_path, pkg):
    """Copy the real contracts, seed the three regression shapes, assert
    each is caught with its expected code, at the same line in both
    packages."""
    root = _skeleton(tmp_path, pkg.name, dirs=("chaos", "service",
                                               "serving"), docs=False)
    pkg_dir = root / pkg.name
    (pkg_dir / "service" / "autoscaler.py").write_text(
        "import time\n"
        "from ..chaos import fire\n"
        "class FleetAutoscaler:\n"
        "    def tick(self):\n"
        "        now = time.time()\n"
        "        fire('obs.autoscale_typo')\n"
        "        return now\n")
    (pkg_dir / "serving" / "llm_batch.py").write_text(
        "import time\n"
        "class ContinuousBatchingEngine:\n"
        "    def _loop(self):\n"
        "        with self._lock:\n"
        "            time.sleep(0.01)\n")
    result = pkg.analysis.run_analysis([str(pkg_dir)], root=str(root))
    by_code = {f.code: f for f in result.findings
               if f.code in ("MLT001", "MLT003", "MLT004")
               and f.path.endswith(("autoscaler.py", "llm_batch.py"))}
    assert sorted((c, f.line) for c, f in by_code.items()) == [
        ("MLT001", 6), ("MLT003", 5), ("MLT004", 5)]
    assert "obs.autoscale_typo" in by_code["MLT001"].message
    assert "FleetAutoscaler.tick" in by_code["MLT003"].message
    assert "_loop" in by_code["MLT004"].message


def test_cli_main_exit_codes(tmp_path, capsys, pkg):
    main = pkg.cli.main
    assert main(["--list-codes"]) == 0
    out = capsys.readouterr().out
    assert "MLT001" in out and "MLT006" in out
    # clean tree -> 0 with a JSON artifact
    pkg_dir = tmp_path / pkg.name
    pkg_dir.mkdir()
    (pkg_dir / "__init__.py").write_text("")
    (pkg_dir / "ok.py").write_text("x = 1\n")
    artifact = tmp_path / "lint.json"
    assert main([str(pkg_dir), "--json", str(artifact)]) == 0
    assert json.loads(artifact.read_text())["files_checked"] == 2
    # findings -> 1
    (pkg_dir / "serving").mkdir()
    (pkg_dir / "serving" / "bad.py").write_text(
        "def handle(event):\n"
        "    raise RuntimeError('boom')\n")
    assert main([str(pkg_dir)]) == 1


# -- the port's own cases ----------------------------------------------------

#: every torch call that waits for the device, as MLT004 names it
TORCH_SYNCS = [
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("self._stream.synchronize()", ".synchronize()"),
    ("self._done_event.synchronize()", ".synchronize()"),
    ("tokens.item()", ".item()"),
    ("tokens.tolist()", ".tolist()"),
    ("tokens.cpu()", ".cpu()"),
    ("tokens.numpy()", ".numpy()"),
    ("tokens.to('cpu')", ".to('cpu')"),
    ("tokens.to(device='cpu')", ".to('cpu')"),
]


@pytest.mark.parametrize("module", ["llm_batch", "paged", "adapters",
                                    "fleet", "prefix"])
@pytest.mark.parametrize("call,named", TORCH_SYNCS)
def test_mlt004_torch_sync_under_a_checked_lock(tmp_path, port, module,
                                                call, named):
    root = _skeleton(tmp_path, port.name)
    _write(root, port, f"{{pkg}}/serving/{module}.py",
           "import torch\n"
           "class Engine:\n"
           "    def tick(self, tokens):\n"
           "        with self._lock:\n"
           f"            out = {call}\n"
           "        return out\n")
    result = _run(root, port, f"{{pkg}}/serving/{module}.py")
    assert _lines(result) == [("MLT004", 5)]
    assert f"device sync {named}" in result.findings[0].message


def test_mlt004_torch_sync_one_self_call_deep(tmp_path, port):
    root = _skeleton(tmp_path, port.name)
    _write(root, port, "{pkg}/serving/llm_batch.py",
           "import torch\n"
           "class Engine:\n"
           "    def _drain(self):\n"
           "        torch.cuda.synchronize()\n"
           "    def stop(self):\n"
           "        with self._lock:\n"
           "            self._drain()\n")
    result = _run(root, port, "{pkg}/serving/llm_batch.py")
    assert _lines(result) == [("MLT004", 7)]
    message = result.findings[0].message
    assert "Engine._drain" in message
    assert "torch.cuda.synchronize() at line 4" in message


def test_mlt004_host_copies_outside_or_to_the_device_are_clean(tmp_path,
                                                               port):
    root = _skeleton(tmp_path, port.name)
    _write(root, port, "{pkg}/serving/paged.py",
           "import torch\n"
           "class Engine:\n"
           "    def tick(self, tokens, device):\n"
           "        with self._lock:\n"
           "            a = tokens.to('cuda')\n"
           "            b = tokens.to(device)\n"
           "            c = dict(self._stats).items()\n"
           "        torch.cuda.synchronize()\n"
           "        return a, b, c, tokens.tolist()\n")
    _write(root, port, "{pkg}/serving/speculative.py",
           "class Engine:\n"
           "    def tick(self, tokens):\n"
           "        with self._lock:\n"
           "            return tokens.item()\n")
    result = _run(root, port, "{pkg}/serving")
    assert [f for f in result.findings if f.code == "MLT004"] == []


#: (source, what the message names) for each spelling of a misspelt key
TYPOED_KEYS = [
    ("from ..config import run_config\n"
     "def f():\n    return run_config('artifact_pth')\n",
     "RUN_DEFAULTS['artifact_pth']"),
    ("from ..config import service_config\n"
     "def f():\n    return service_config('httpdb.prot')\n",
     "SERVICE_DEFAULTS['httpdb'] has no key 'prot'"),
    ("from ..config import service_config\n"
     "def f():\n    return service_config('httdb.port')\n",
     "SERVICE_DEFAULTS has no key 'httdb'"),
    ("from ..config import service_config\n"
     "def f():\n    return service_config('httpdb')['prot']\n",
     "SERVICE_DEFAULTS['httpdb'] has no key 'prot'"),
    ("from ..config import SERVING_LLM_DEFAULTS\n"
     "def f():\n    return SERVING_LLM_DEFAULTS['prefil_chunk']\n",
     "SERVING_LLM_DEFAULTS has no key 'prefil_chunk'"),
    ("from ..config import OBSERVABILITY_DEFAULTS as conf\n"
     "def f():\n    return conf['flight'].get('rign', 1)\n",
     "OBSERVABILITY_DEFAULTS['flight'] has no key 'rign'"),
    ("from .. import config\n"
     "def f():\n    return config.SERVING_FLEET_DEFAULTS['jounral_dir']\n",
     "SERVING_FLEET_DEFAULTS has no key 'jounral_dir'"),
    ("from .. import config as c\n"
     "def f():\n    return c.run_config('artifact_pth')\n",
     "RUN_DEFAULTS has no key 'artifact_pth'"),
]


@pytest.mark.parametrize("source,named", TYPOED_KEYS)
def test_mlt006_flags_a_misspelt_port_config_key(tmp_path, port, source,
                                                 named):
    root = _skeleton(tmp_path, port.name)
    _write(root, port, "{pkg}/serving/x.py", source)
    result = _run(root, port, "{pkg}/serving/x.py")
    assert _lines(result) == [("MLT006", 3)]
    assert named in result.findings[0].message
    assert "config.py" in result.findings[0].remedy


def test_mlt006_leaves_dynamic_open_and_test_keys_alone(tmp_path, port):
    root = _skeleton(tmp_path, port.name)
    _write(root, port, "{pkg}/serving/x.py",
           "from ..config import SERVING_LLM_DEFAULTS, run_config\n"
           "def f(key):\n"
           "    a = SERVING_LLM_DEFAULTS[key]['whatever']\n"
           "    b = run_config(key)\n"
           "    c = SERVING_LLM_DEFAULTS['kv_tier'].get('host_bytes', 0)\n"
           "    d = SERVING_LLM_DEFAULTS['prefill_chunk'].bit_length()\n"
           "    SERVING_LLM_DEFAULTS['new_knob'] = 1\n"
           "    return a, b, c, d\n")
    _write(root, port, "tests/test_x.py",
           f"from {port.name}.config import run_config\n"
           "def test_f():\n"
           "    run_config('not_a_key')\n")
    result = _run(root, port, "{pkg}/serving/x.py", "tests/test_x.py")
    assert result.findings == []


def test_mlt006_resolves_every_config_key_of_the_port(port):
    """On today's tree every literal key resolves, and the checker does
    see the port's reads: more than a hundred of them."""
    from mlrun_tpu_torch.analysis import confkeys

    checker = confkeys.ConfigKeyChecker()
    seen = []
    check = checker._check

    def counting(root, base, keys, *args, **kw):
        seen.append((root, tuple(base + keys)))
        return check(root, base, keys, *args, **kw)

    checker._check = counting
    result = port.analysis.run_analysis(
        [os.path.join(REPO, port.name)], checkers=[checker], root=REPO)
    assert result.findings == []
    assert len(seen) > 100
    assert {root for root, _ in seen} >= {
        "RUN_DEFAULTS", "SERVICE_DEFAULTS", "SERVING_LLM_DEFAULTS",
        "OBSERVABILITY_DEFAULTS", "K8S_DEFAULTS"}


def test_python_m_lints_the_port_clean():
    out = subprocess.run(
        [sys.executable, "-m", "mlrun_tpu_torch.analysis",
         "mlrun_tpu_torch", "--format", "json"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    report = json.loads(out.stdout)
    assert report["ok"] is True and report["findings"] == []
    assert report["parse_errors"] == [] and report["suppressed"] == []
    assert report["files_checked"] > 200


#: (real port module, seeded source appended, code, what the message names)
SEEDED = [
    ("serving/llm_batch.py",
     "\n\nclass _Seeded:\n"
     "    def tick(self, tokens):\n"
     "        with self._lock:\n"
     "            return tokens.item()\n",
     "MLT004", ".item()"),
    ("serving/paged.py",
     "\n\nclass _Seeded:\n"
     "    def _seeded_sync(self):\n"
     "        torch.cuda.synchronize()\n"
     "    def tick(self):\n"
     "        with self._lock:\n"
     "            self._seeded_sync()\n",
     "MLT004", "_Seeded._seeded_sync"),
    ("service/autoscaler.py",
     "\n\nclass _Seeded:\n"
     "    def tick(self):\n"
     "        return time.time()\n",
     "MLT003", "_Seeded.tick"),
    ("serving/server.py",
     "\n\ndef _seeded(event):\n"
     "    fire('serving.stpe')\n",
     "MLT001", "serving.stpe"),
    ("serving/server.py",
     "\n\ndef _seeded(event):\n"
     "    raise RuntimeError('boom')\n",
     "MLT005", "_seeded"),
    ("db/httpdb.py",
     "\n\ndef _seeded():\n"
     "    return service_config('httpdb.prot')\n",
     "MLT006", "prot"),
    ("serving/llm.py",
     "\n\ndef _seeded():\n"
     "    return SERVING_LLM_DEFAULTS['prefil_chunk']\n",
     "MLT006", "prefil_chunk"),
]


@pytest.mark.parametrize("module,seed,code,named", SEEDED)
def test_seeded_regression_in_a_real_port_module(tmp_path, port, module,
                                                 seed, code, named):
    """A real port module, copied with one regression appended, gives
    exactly one finding: the seeded one, on its line."""
    root = _skeleton(tmp_path, port.name, docs=True)
    source = open(os.path.join(REPO, port.name, module)).read()
    if code == "MLT001":
        source += "\nfrom ..chaos import fire\n"
    target = root / port.name / module
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(source + seed)
    clean = source.count("\n")
    result = port.analysis.run_analysis([str(target)], root=str(root))
    assert [f.code for f in result.findings] == [code]
    finding = result.findings[0]
    assert finding.line > clean and named in finding.message
