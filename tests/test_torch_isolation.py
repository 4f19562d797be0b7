"""The port package stands alone: nothing under mlrun_tpu_torch/ (its obs/,
chaos/ and common/ copies, the engine fleet, the canary router, the
health scorer, the model families, the structured callbacks, the
HuggingFace loader, the datastore, the meshes and sharding, ring and
Ulysses attention, the goodput ledger, tensor parallelism, the pipeline
stages, the elastic guard, the profiler, the sample tap, the kernel
build cache, the packagers, the artifact plans, the GPU JobSet builder,
the serving graph (states, server, routers, remote steps, streams, the
v1 server), the HTTP gateway (asgi), obs/debug and obs/traceview,
ModelObj and the secrets store, the intent journal (common/), the JobSet
provider and the fleet autoscaler (service/), the serving pod fleet and
the fleet telemetry (obs/federation, obs/timeseries, obs/slo), the run
stack (the run objects, the run db, artifacts, notifications,
service/alerts, MLClientCtx, the runtimes and the launchers), model
monitoring with its continuous-tuning loop, the feature store with
its datastore sources and targets, the CLI with the projects and
their workflow engines, the framework adapters (sklearn, xgboost,
lightgbm, tf_keras, onnx, the user-code torch adapter, auto_mlrun and
the boosters' shared logging), the small host surfaces (errors, the
logger and helpers, platforms, render, track, the hub and its
functions) and the service with its clients (the API schemas, the
aiohttp API server and its routes, the run monitor and its providers,
the server-side launcher, project secrets, cron, the chief/worker roles,
projects sync, the HTTP and server-SQL run dbs, the remote launcher, the
log collector client and the requirements bootstrap), the image builder,
the deployments, the serving / remote / api-gateway / dask / spark /
databricks runtimes and the object stores included, and the static
lint (analysis/), nor the chip smoke script and the port's profile scripts) imports JAX or the
reference package, and importing the serving, fleet, telemetry, model,
training, datastore, parallel and run-stack paths pulls neither into the
process.

``aiohttp`` and ``requests`` are imported only by the service's HTTP
layer and its clients: ``service/app.py``, ``service/api/*``,
``service/http_utils.py``, ``service/clusterization.py``,
``service/projects_sync.py``, ``db/httpdb.py``, ``launcher/remote.py``,
``runtimes/remote.py`` (a deployed function's ``invoke``) and the
datastore's http store and http source (``datastore/stores.py``,
``datastore/sources.py``; inside the calls that read a url) — the card's
machine has both, and setup.py requires them. Every other
file imports neither, and importing the serving graph and its gateway,
the training, serving and run-stack paths, or ``get_run_db()`` of a
local path pulls neither in: the gateway and the remote steps stand on
the standard library's ``http.server`` and ``urllib``, which the port's
tests drive. ``click`` is imported by the CLI alone
(``mlrun_tpu_torch/__main__.py``, a click group as the reference's is), and
``import mlrun_tpu_torch`` loads none of it. The multi-rank test
helper (tests/torch_ranks.py), whose ranks run the port alone, is held to
the same rule. No port source names a path under ``native/`` or the
reference package: the token-shard loader builds the port's own copy of
its C++ source."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mlrun_tpu")
# the reference's HTTP packages: the service's HTTP layer and its clients
# use them (HTTP_FILES); the port's gateway and remote steps are written
# on the standard library instead, so they must not creep in elsewhere
HTTP_LIBRARIES = ("aiohttp", "requests")
HTTP_FILES = ("mlrun_tpu_torch/service/app.py",
              "mlrun_tpu_torch/service/http_utils.py",
              "mlrun_tpu_torch/service/clusterization.py",
              "mlrun_tpu_torch/service/projects_sync.py",
              "mlrun_tpu_torch/db/httpdb.py",
              "mlrun_tpu_torch/launcher/remote.py",
              "mlrun_tpu_torch/runtimes/remote.py",
              "mlrun_tpu_torch/datastore/stores.py",
              "mlrun_tpu_torch/datastore/sources.py")
HTTP_DIRS = ("mlrun_tpu_torch/service/api/",)
# the CLI's framework: only the CLI module imports it
CLI_LIBRARIES = ("click",)
CLI_FILES = ("mlrun_tpu_torch/__main__.py",)
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "mlrun_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py", "tests/torch_ranks.py",
       "scripts/profile_torch_serving.py",
       "scripts/profile_torch_training.py", "scripts/time_paged_kernels.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", FILES)
def test_port_file_imports_no_jax_or_reference(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    http_ok = path in HTTP_FILES or path.startswith(HTTP_DIRS)
    forbidden = FORBIDDEN + (() if http_ok else HTTP_LIBRARIES) \
        + (() if path in CLI_FILES else CLI_LIBRARIES)
    bad = sorted({m for m in _imported_roots(tree) if m in forbidden})
    assert not bad, f"{path} imports {bad}"


def test_the_http_files_are_the_services_layer_and_its_clients():
    """Every file the HTTP rule names exists (the list names no stale
    path), and the service's server and its client do use the reference's
    libraries."""
    assert set(HTTP_FILES) <= set(FILES)
    assert any(f.startswith(HTTP_DIRS) for f in FILES)
    for path, library in (("mlrun_tpu_torch/service/app.py", "aiohttp"),
                          ("mlrun_tpu_torch/db/httpdb.py", "requests")):
        roots = set(_imported_roots(ast.parse((ROOT / path).read_text())))
        assert library in roots, path


PORT_FILES = [f for f in FILES if f.startswith("mlrun_tpu_torch/")]
OTHER_PACKAGES = ("native", "mlrun_tpu")


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                yield first.value


def _paths_into_other_packages(tree):
    """String constants (docstrings aside) that name a path under
    ``native/`` or ``mlrun_tpu/``, and path joins (``os.path.join``,
    ``Path(...)``, ``/``) with such a component."""
    skip = {id(node) for node in _docstrings(tree)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in skip:
            parts = node.value.replace("\\", "/").split("/")
            if len(parts) > 1 and any(p in OTHER_PACKAGES
                                      for p in parts[:-1]):
                yield node.lineno, node.value
        args = []
        if isinstance(node, ast.Call):
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            if name in ("join", "Path", "PurePath", "joinpath"):
                args = node.args
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            args = [node.left, node.right]
        for arg in args:
            if isinstance(arg, ast.Constant) and arg.value in OTHER_PACKAGES:
                yield arg.lineno, arg.value


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_opens_nothing_under_native_or_the_reference(path):
    """The port keeps its own copies (the token-shard loader's C++ source
    included): no port source names a file of ``native/`` or of the
    reference package."""
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = list(_paths_into_other_packages(tree))
    assert not bad, f"{path} names paths of another package: {bad}"


def test_the_path_scan_catches_the_references_loader_lookup():
    """The scan rejects the reference's own library lookup
    (``os.path.join(here, "native", "libmlt_data.so")``) and a literal
    path into the reference package; it passes a kv dtype named
    "native"."""
    bad = ast.parse('import os\nos.path.join(here, "native", "lib.so")\n'
                    'open("mlrun_tpu/ops/x.py")\nP / "native"\n')
    assert len(list(_paths_into_other_packages(bad))) == 3
    good = ast.parse('kv_dtype = "native"\nif kv in ("native", "int8"): '
                     'pass\n')
    assert not list(_paths_into_other_packages(good))


def test_serving_import_pulls_in_no_jax_or_reference():
    code = (
        "import sys\n"
        "import mlrun_tpu_torch.serving.paged, mlrun_tpu_torch.serving.llm\n"
        "import mlrun_tpu_torch.serving.speculative\n"
        "import mlrun_tpu_torch.serving.kv_tier\n"
        "import mlrun_tpu_torch.serving.fleet, mlrun_tpu_torch.serving.canary\n"
        "import mlrun_tpu_torch.serving.v2_serving\n"
        "import mlrun_tpu_torch.obs.health, mlrun_tpu_torch.common.retry\n"
        "import mlrun_tpu_torch.obs, mlrun_tpu_torch.chaos\n"
        "import mlrun_tpu_torch.models.convert\n"
        "import mlrun_tpu_torch.training.train\n"
        "import mlrun_tpu_torch.models.moe, mlrun_tpu_torch.models.bert\n"
        "import mlrun_tpu_torch.models.vit, mlrun_tpu_torch.models.t5\n"
        "import mlrun_tpu_torch.frameworks.torch.auto_trainer\n"
        "import mlrun_tpu_torch.frameworks._common.callbacks\n"
        "import mlrun_tpu_torch.frameworks.huggingface\n"
        "import mlrun_tpu_torch.training.data\n"
        "import mlrun_tpu_torch.datastore, mlrun_tpu_torch.artifacts.model\n"
        "import mlrun_tpu_torch.parallel.mesh\n"
        "import mlrun_tpu_torch.parallel.sharding\n"
        "import mlrun_tpu_torch.ops.ring_attention\n"
        "import mlrun_tpu_torch.ops.ulysses, mlrun_tpu_torch.models.llama_cp\n"
        "import mlrun_tpu_torch.obs.goodput\n"
        "import mlrun_tpu_torch.training.checkpoint\n"
        "import mlrun_tpu_torch.parallel.tensor\n"
        "import mlrun_tpu_torch.parallel.pipeline\n"
        "import mlrun_tpu_torch.training.elastic\n"
        "import mlrun_tpu_torch.utils.profiler\n"
        "import mlrun_tpu_torch.utils.compile_cache\n"
        "import mlrun_tpu_torch.serving.samples, mlrun_tpu_torch.execution\n"
        "import mlrun_tpu_torch.package, mlrun_tpu_torch.k8s.jobset\n"
        "import mlrun_tpu_torch.frameworks._common.plans\n"
        "import mlrun_tpu_torch.serving, mlrun_tpu_torch.serving.asgi\n"
        "import mlrun_tpu_torch.serving.streams\n"
        "import mlrun_tpu_torch.obs.debug, mlrun_tpu_torch.obs.traceview\n"
        "import mlrun_tpu_torch.model, mlrun_tpu_torch.secrets\n"
        "import mlrun_tpu_torch.common.journal\n"
        "import mlrun_tpu_torch.service.providers\n"
        "import mlrun_tpu_torch.service.autoscaler\n"
        "import mlrun_tpu_torch.serving.podfleet\n"
        "import mlrun_tpu_torch.obs.federation\n"
        "import mlrun_tpu_torch.obs.timeseries, mlrun_tpu_torch.obs.slo\n"
        "import mlrun_tpu_torch.runtimes, mlrun_tpu_torch.runtimes.tpujob\n"
        "import mlrun_tpu_torch.db, mlrun_tpu_torch.launcher\n"
        "import mlrun_tpu_torch.service.alerts, mlrun_tpu_torch.run\n"
        "import mlrun_tpu_torch.artifacts, mlrun_tpu_torch.datastore.profiles\n"
        "import mlrun_tpu_torch.utils.notifications\n"
        "import mlrun_tpu_torch.model_monitoring\n"
        "import mlrun_tpu_torch.model_monitoring.metrics\n"
        "import mlrun_tpu_torch.model_monitoring.tsdb\n"
        "import mlrun_tpu_torch.model_monitoring.stream_processing\n"
        "import mlrun_tpu_torch.model_monitoring.applications\n"
        "import mlrun_tpu_torch.model_monitoring.controller\n"
        "import mlrun_tpu_torch.feature_store\n"
        "import mlrun_tpu_torch.feature_store.api\n"
        "import mlrun_tpu_torch.feature_store.feature_set\n"
        "import mlrun_tpu_torch.feature_store.retrieval\n"
        "import mlrun_tpu_torch.feature_store.steps\n"
        "import mlrun_tpu_torch.feature_store.ingestion_service\n"
        "import mlrun_tpu_torch.datastore.sources\n"
        "import mlrun_tpu_torch.datastore.targets\n"
        "import mlrun_tpu_torch.projects\n"
        "import mlrun_tpu_torch.projects.pipelines\n"
        "import mlrun_tpu_torch.frameworks, mlrun_tpu_torch.hub\n"
        "import mlrun_tpu_torch.frameworks.sklearn\n"
        "import mlrun_tpu_torch.frameworks.xgboost\n"
        "import mlrun_tpu_torch.frameworks.lightgbm\n"
        "import mlrun_tpu_torch.frameworks.tf_keras\n"
        "import mlrun_tpu_torch.frameworks.onnx\n"
        "import mlrun_tpu_torch.frameworks.torch\n"
        "import mlrun_tpu_torch.errors, mlrun_tpu_torch.platforms\n"
        "import mlrun_tpu_torch.render, mlrun_tpu_torch.track\n"
        "import mlrun_tpu_torch.utils.version\n"
        "import mlrun_tpu_torch.analysis\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in %r)\n"
        "import mlrun_tpu_torch.__main__\n"
        "bad += sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] in %r)\n"
        "print(','.join(bad))\n" % (FORBIDDEN + HTTP_LIBRARIES
                                     + CLI_LIBRARIES,
                                     FORBIDDEN + HTTP_LIBRARIES))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported: {out.stdout.strip()}"


def test_the_run_stack_and_a_local_run_db_pull_in_no_http_library(
        tmp_path):
    """Importing the training, serving and run-stack paths (the launchers,
    the runtimes, the run context) and opening ``get_run_db()`` of a local
    path load neither ``aiohttp`` nor ``requests``: only a client of the
    service (an ``http(s)://`` run db) does."""
    code = (
        "import sys\n"
        "import mlrun_tpu_torch, mlrun_tpu_torch.run\n"
        "import mlrun_tpu_torch.training.train\n"
        "import mlrun_tpu_torch.serving.llm, mlrun_tpu_torch.serving.asgi\n"
        "import mlrun_tpu_torch.launcher, mlrun_tpu_torch.runtimes.tpujob\n"
        "import mlrun_tpu_torch.execution, mlrun_tpu_torch.db\n"
        "import mlrun_tpu_torch.service.providers\n"
        "import mlrun_tpu_torch.service.runtime_handlers\n"
        "import mlrun_tpu_torch.utils.log_collector\n"
        "import mlrun_tpu_torch.utils.bootstrap\n"
        "db = mlrun_tpu_torch.db.get_run_db(%r)\n"
        "assert type(db).__name__ == 'SQLiteRunDB', db\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in %r))\n"
        % (str(tmp_path / "runs.sqlite"), HTTP_LIBRARIES))
    env = dict(os.environ, PYTHONPATH=str(ROOT), MLT_HOME=str(tmp_path))
    env.pop("MLT_DBPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_tuning_loop_needs_no_pandas():
    """With pandas and pyarrow not importable (the card's machine may
    lack them), model monitoring imports, the traffic monitor gives its
    verdicts and the continuous-tuning loop ticks; only the endpoint
    pipeline's frame-building steps need pandas."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['pyarrow'] = None\n"
        "from mlrun_tpu_torch.model_monitoring import (\n"
        "    AdapterTrafficMonitor, ContinuousTuningController)\n"
        "m = AdapterTrafficMonitor(vocab_size=64, reference_min=2,\n"
        "                          window_min=2)\n"
        "for tokens in ([1, 2], [1, 2], [1, 2], [1, 2], [60, 61, 62],\n"
        "               [60, 61, 62]):\n"
        "    m.observe({'adapter': 't1', 'tokens': tokens})\n"
        "stats, drifted = m.evaluate('t1', 0.0)\n"
        "assert drifted is True, stats\n"
        "c = ContinuousTuningController(object(), project='p',\n"
        "    reference_min=2, window_min=2, vocab_size=64).start()\n"
        "c.ring.append({'adapter': 't1', 'tokens': [1], 'generated': 1})\n"
        "out = c.tick(1.0)\n"
        "c.stop()\n"
        "assert out['actions'] == [] and 't1' in out['evaluated']\n"
        "print(sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('pandas', 'pyarrow')\n"
        "             and sys.modules[k] is not None))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_cli_and_projects_need_no_click_or_kfp(tmp_path):
    """With kfp not importable, ``import mlrun_tpu_torch`` leaves click,
    the projects and torch unloaded, the projects and run.py import, a
    project saves and loads and the CLI (a click group: the one module
    that imports click) answers; the kfp engine alone needs kfp."""
    code = (
        "import sys, tempfile\n"
        "sys.modules['kfp'] = None\n"
        "import mlrun_tpu_torch\n"
        "light = [m for m in ('mlrun_tpu_torch.projects', 'torch',\n"
        "                     'click') if m in sys.modules]\n"
        "import mlrun_tpu_torch.run, mlrun_tpu_torch.projects\n"
        "no_click = 'click' not in sys.modules\n"
        "import mlrun_tpu_torch.__main__ as cli\n"
        "from click.testing import CliRunner\n"
        "d = tempfile.mkdtemp()\n"
        "p = mlrun_tpu_torch.new_project('p', context=d, save=False)\n"
        "p.set_workflow('main', 'wf.py')\n"
        "p.save(store=False)\n"
        "q = mlrun_tpu_torch.load_project(d, save=False)\n"
        "assert q.spec.get_workflow('main')['path'] == 'wf.py'\n"
        "answer = CliRunner().invoke(cli.main, ['version'])\n"
        "assert answer.exit_code == 0, answer.output\n"
        "assert answer.output.startswith('mlrun-tpu version '), answer\n"
        "try:\n"
        "    mlrun_tpu_torch.projects.pipelines.get_workflow_engine(\n"
        "        'kfp').run(q, {}, workflow_handler=lambda: None)\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('the kfp engine ran without kfp')\n"
        "print(light, no_click, sorted(m for m in ('click', 'kfp')\n"
        "                              if sys.modules.get(m) is not None))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), MLT_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] True ['click']"
