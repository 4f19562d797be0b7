"""mlrun_tpu_torch's CLI (``python3 -m mlrun_tpu_torch``) against
mlrun_tpu's, both click groups: the contracts of tests/test_cli.py, each
command driven in this process with the same arguments in both packages
through click's ``CliRunner`` (stdout, stderr and exit codes compared
letter for letter, uids masked), plus ``get_or_create_ctx`` under
``MLT_EXEC_CONFIG`` and the pod's program: the ``tpujob`` JobSet's own
container command, run under torchrun on the CPU.

Every package writes under its own ``MLT_HOME`` with a fresh run db.
Three tests start a process: ``python -m mlrun_tpu_torch``, the in-pod
``run --from-env``, and the JobSet's command.
"""

import base64
import json
import os
import re
import socket
import stat
import subprocess
import sys

import pytest
from click.testing import CliRunner

import mlrun_tpu
import mlrun_tpu.__main__ as jcli
import mlrun_tpu.db as jdb
import mlrun_tpu_torch
import mlrun_tpu_torch.__main__ as tcli
from mlrun_tpu.config import mlconf
from mlrun_tpu.datastore import store_manager as jstore
from mlrun_tpu_torch import db as tdb
from mlrun_tpu_torch.datastore import store_manager as tstore
from mlrun_tpu_torch.model import RunObject, new_task

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UID = re.compile(r"\b[0-9a-f]{12,32}\b")
HANDLER = ("def handler(context, x: int = 1):\n"
           "    context.log_result('double', x * 2)\n")


def _reset_dbs():
    jdb.set_run_db(None)
    jdb._run_db = None
    jstore._db = None
    tdb.set_run_db(None)
    tstore._db = None


@pytest.fixture(autouse=True)
def _fresh_port_db():
    _reset_dbs()
    yield
    _reset_dbs()


@pytest.fixture()
def homes(tmp_path, monkeypatch):
    """Each package's MLT_HOME; ``use(name)`` switches to it."""
    paths = {name: str(tmp_path / f"home-{name}") for name in ("jax", "port")}

    def use(name):
        monkeypatch.setenv("MLT_HOME", paths[name])
        mlconf.reload()
        _reset_dbs()
        return paths[name]

    return use


def _invoke(name, args, env=None, monkeypatch=None):
    """(exit code, stdout, stderr) of one command in this process."""
    for key, value in (env or {}).items():
        monkeypatch.setenv(key, value)
    cli = jcli if name == "jax" else tcli
    result = CliRunner().invoke(cli.main, args, catch_exceptions=False)
    for key in env or {}:
        monkeypatch.delenv(key)
    return result.exit_code, result.stdout, result.stderr


def _both(args, homes, monkeypatch, env=None, before=None):
    got = {}
    for name in ("jax", "port"):
        home = homes(name)
        if before is not None:
            before(name, home)
        got[name] = _invoke(name, args(home) if callable(args) else args,
                            env, monkeypatch)
    return got


def _masked(text: str) -> str:
    return UID.sub("<uid>", text)


# -- tests/test_cli.py --------------------------------------------------------

def test_version_like_reference(homes, monkeypatch):
    got = _both(["version"], homes, monkeypatch)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0 and "mlrun-tpu version" in got["port"][1]


def test_run_script_and_get_like_reference(tmp_path, homes,
                                           monkeypatch):
    script = tmp_path / "job.py"
    script.write_text(HANDLER)
    runs = _both(["run", str(script), "--handler", "handler", "--param",
                  "x=21", "--name", "cli-job"], homes, monkeypatch)
    listed = {}
    for name in ("jax", "port"):
        homes(name)
        listed[name] = _invoke(name, ["get", "runs"], None,
                               monkeypatch)
    for name in ("jax", "port"):
        assert runs[name][0] == 0, runs[name][2]
        assert "completed" in runs[name][1]
        assert "cli-job" in listed[name][1]
        assert "'double': 42" in listed[name][1]
    assert _masked(runs["port"][1]) == _masked(runs["jax"][1])
    assert _masked(listed["port"][1]) == _masked(listed["jax"][1])


def test_run_from_env_contract_like_reference(tmp_path, homes,
                                              monkeypatch):
    code = ("def handler(context):\n"
            "    context.log_result('ok', context.get_param('p'))\n")
    config = {"metadata": {"name": "inpod", "project": "default",
                           "uid": "0123456789abcdef"},
              "spec": {"parameters": {"p": 5}, "handler": "handler"}}
    monkeypatch.chdir(tmp_path)
    env = {"MLT_EXEC_CONFIG": json.dumps(config),
           "MLT_EXEC_CODE": base64.b64encode(code.encode()).decode()}
    got = _both(["run", "--from-env"], homes, monkeypatch, env=env)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0
    assert got["port"][1] == "run 0123456789abcdef finished: completed\n"
    # the code went to a private temp dir, not the working directory
    assert not (tmp_path / "main.py").exists()
    run = tdb.get_run_db().read_run("0123456789abcdef", "default")
    assert run["status"]["results"] == {"ok": 5}


def test_run_failure_exit_code_like_reference(tmp_path, homes,
                                              monkeypatch):
    script = tmp_path / "bad.py"
    script.write_text("def handler(context):\n    raise ValueError('no')\n")
    got = _both(["run", str(script), "--handler", "handler"], homes,
                monkeypatch)
    for name in ("jax", "port"):
        code, out, err = got[name]
        assert code == 1 and "error" in out and err == "no\n"
        assert "ValueError: no" in out     # the handler's traceback
    # the traceback's frames name each package's files; the verdict line
    # is the same
    assert _masked(got["port"][1].splitlines()[-1]) == \
        _masked(got["jax"][1].splitlines()[-1]) == "run <uid> finished: error"


def test_from_env_missing_config_errors_like_reference(homes,
                                                       monkeypatch):
    monkeypatch.delenv("MLT_EXEC_CONFIG", raising=False)
    got = _both(["run", "--from-env"], homes, monkeypatch)
    assert got["port"] == got["jax"]
    assert got["port"] == (
        1, "", "Error: --from-env set but MLT_EXEC_CONFIG is empty\n")


def test_from_env_writes_kfp_output_parameters_like_reference(
        tmp_path, homes, monkeypatch):
    code = ("def handler(context):\n"
            "    context.log_result('r', 7)\n"
            "    context.log_result('s', 'text')\n")
    config = {"metadata": {"name": "kfpout", "project": "default"},
              "spec": {"handler": "handler"}}
    monkeypatch.chdir(tmp_path)

    def outs(name):
        return tmp_path / name / "outs"

    env_base = {"MLT_EXEC_CONFIG": json.dumps(config),
                "MLT_EXEC_CODE": base64.b64encode(code.encode()).decode()}
    got, missing = {}, {}
    for name in ("jax", "port"):
        homes(name)
        env = dict(env_base, MLT_KFP_OUTPUTS=json.dumps(
            {"s": str(outs(name) / "s")}))
        got[name] = _invoke(name, ["run", "--from-env", "--kfp-output",
                                   f"r={outs(name) / 'r'}"], env, monkeypatch)
        missing[name] = _invoke(
            name, ["run", "--from-env", "--kfp-output",
                   f"r={outs(name) / 'r'}", "--kfp-output",
                   f"missing={tmp_path / name / 'm'}"], env, monkeypatch)
    for name in ("jax", "port"):
        assert got[name][0] == 0, got[name][2]
        assert (outs(name) / "r").read_text() == "7"
        assert (outs(name) / "s").read_text() == "text"
        assert missing[name][0] == 1
        assert "missing" in missing[name][2]
        assert not (tmp_path / name / "m").exists()
    assert missing["port"][2] == missing["jax"][2]
    assert _masked(got["port"][1]) == _masked(got["jax"][1])


def test_run_str_param_stays_string_like_reference(tmp_path, homes,
                                                   monkeypatch):
    script = tmp_path / "job.py"
    script.write_text(
        "def handler(context, a=None, b=None):\n"
        "    context.log_result('types', f'{type(a).__name__},"
        "{type(b).__name__}')\n")
    got = _both(["run", str(script), "--handler", "handler", "--param",
                 "a=7", "--str-param", "b=7", "--name", "cli-types"],
                homes, monkeypatch)
    listed = {}
    for name in ("jax", "port"):
        homes(name)
        assert got[name][0] == 0
        listed[name] = _invoke(name, ["get", "runs"], None,
                               monkeypatch)[1]
        assert "'types': 'int,str'" in listed[name]
    assert _masked(listed["port"]) == _masked(listed["jax"])


# -- the other commands -------------------------------------------------------

WORKFLOW = '''from {pkg}.projects import get_current_project


def pipeline(v="2"):
    proj = get_current_project()
    first = proj.run_function("step1", params={{"v": int(v)}}, local=True)
    proj.run_function("step2", params={{"v": first.output("a")}},
                      local=True).after(first)
'''

STEPS = '''def step1(context, v: int = 0):
    print("step1 ran")
    context.log_result("a", v + 10)


def step2(context, v: int = 0):
    context.log_result("b", v * 2)
'''


def test_project_run_get_and_logs_like_reference(tmp_path, homes,
                                                 monkeypatch):
    """``project <dir> --run main -x v=3`` runs a project's workflow on the
    local engine; ``get`` lists its runs, functions and project; ``logs``
    prints a run's log and its final state."""
    outs = {}
    for name, pkg in (("jax", mlrun_tpu), ("port", mlrun_tpu_torch)):
        homes(name)
        directory = tmp_path / name
        directory.mkdir()
        (directory / "steps.py").write_text(STEPS)
        (directory / "workflow.py").write_text(WORKFLOW.format(
            pkg=pkg.__name__))
        proj = pkg.new_project("proj-cli", context=str(directory))
        for step in ("step1", "step2"):
            fn = pkg.code_to_function(step, project="proj-cli",
                                      filename=str(directory / "steps.py"),
                                      kind="job", handler=step)
            proj.set_function(fn, name=step)
            fn.save()
        proj.set_workflow("main", "workflow.py")
        proj.save()
        out = [_invoke(name, ["project", str(directory), "--run", "main",
                              "-x", "v=3"], None, monkeypatch)]
        for kind in ("runs", "functions", "projects", "schedules"):
            out.append(_invoke(name, ["get", kind, "-p", "proj-cli"],
                               None, monkeypatch))
        runs = pkg.get_run_db().list_runs(project="proj-cli")
        first = [r for r in runs if r["metadata"]["name"] == "step1"][0]
        assert [r["status"]["results"] for r in sorted(
            runs, key=lambda r: r["metadata"]["name"])] == [
                {"a": 13}, {"b": 26}]
        out.append(_invoke(name, ["logs", first["metadata"]["uid"], "-p",
                                  "proj-cli"], None, monkeypatch))
        outs[name] = [(code, _masked(o), e) for code, o, e in out]
    assert outs["port"] == outs["jax"]
    assert outs["port"][0][1] == ("project loaded: proj-cli\n"
                                  "step1 ran\n"
                                  "workflow main: completed\n")
    assert outs["port"][-1][1] == "step1 ran\n\nfinal state: completed\n"


def test_config_writes_the_same_env_file(tmp_path, homes,
                                         monkeypatch):
    got = _both(lambda home: ["config", "--api", "http://svc:8080",
                              "--artifact-path", "/data/{project}",
                              "--env-file", os.path.join(home, "c.env")],
                homes, monkeypatch,
                before=lambda name, home: os.makedirs(home))
    texts = [open(os.path.join(str(tmp_path / f"home-{n}"), "c.env")).read()
             for n in ("jax", "port")]
    assert texts[0] == texts[1] == ("MLT_DBPATH=http://svc:8080\n"
                                    "MLT_ARTIFACT_PATH=/data/{project}\n")
    assert [c for c, _, _ in got.values()] == [0, 0]


@pytest.mark.parametrize("args", [
    ["build", "db://p/f"], ["db"], ["bootstrap", "-r", "numpy", "python3"],
    ["bootstrap", "-r", "--no-index", "-r", "numpy", "--overlay-root",
     "/o", "--", "python3", "-m", "job", "--flag"]])
def test_build_db_and_bootstrap_reach_the_service_like_reference(
        args, monkeypatch, homes):
    """``build`` deploys the stored function through the service's
    builder (``fn.deploy``): over a local run db, which has no builder,
    both packages raise the db's NotImplementedError. ``db`` starts the
    service (``service.app.run_app``) and ``bootstrap`` execs its command
    under the requirements overlay (``utils.bootstrap.
    exec_with_requirements``) — a requirement that is itself a pip flag
    is the option's value, and ``--`` ends the options — as the
    reference's commands do; both are recorded here instead of run."""
    import mlrun_tpu.service.app
    import mlrun_tpu.utils.bootstrap
    from mlrun_tpu_torch.service import app
    from mlrun_tpu_torch.utils import bootstrap

    calls = {"jax": [], "port": []}
    for name, app_mod, boot_mod in (
            ("jax", mlrun_tpu.service.app, mlrun_tpu.utils.bootstrap),
            ("port", app, bootstrap)):
        def run_app(_calls=calls[name], **kw):
            _calls.append(("run_app", kw))

        def exec_with_requirements(reqs, cmd, overlay_root=None,
                                   _calls=calls[name]):
            _calls.append(("exec", reqs, cmd, overlay_root))

        monkeypatch.setattr(app_mod, "run_app", run_app)
        monkeypatch.setattr(boot_mod, "exec_with_requirements",
                            exec_with_requirements)
    if args[0] == "build":
        for name, pkg, flag in (("jax", mlrun_tpu, "--with-tpu"),
                                ("port", mlrun_tpu_torch, "--with-tpu"),
                                ("port", mlrun_tpu_torch, "--with-gpu")):
            homes(name)
            fn = pkg.new_function("f", project="p", kind="job", image="img")
            fn.save()
            with pytest.raises(NotImplementedError):
                _invoke(name, args + [flag])
        assert calls == {"jax": [], "port": []}
        return
    got = _both(args, homes, monkeypatch)
    assert got["port"] == got["jax"] == (0, "", "")
    assert calls["port"] == calls["jax"]
    if args[0] == "db":
        assert calls["port"] == [("run_app", {"host": "", "port": 0})]
    elif args[2] == "numpy":
        assert calls["port"] == [("exec", ["numpy"], ["python3"], None)]
    else:
        assert calls["port"] == [("exec", ["--no-index", "numpy"],
                                  ["python3", "-m", "job", "--flag"],
                                  "/o")]


def test_usage_errors_exit_2_as_click_does(homes, monkeypatch):
    got = _both(["get", "nothing"], homes, monkeypatch)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 2
    assert "Error: Invalid value" in got["port"][2]
    assert "'nothing' is not one of" in got["port"][2]


def test_serve_starts_the_env_gateway_and_sigint_returns(monkeypatch):
    """``serve`` hands host and port to ``serving.asgi.serve`` (the
    SERVING_SPEC_ENV graph); SIGINT (KeyboardInterrupt in the HTTP loop)
    ends the gateway and the command returns 0, as the reference's
    run_app does."""
    from mlrun_tpu_torch.serving import asgi

    seen = {}

    class _Httpd:
        def serve_forever(self):
            seen["served"] = True
            raise KeyboardInterrupt

        def server_close(self):
            seen["closed"] = True

    def bind(app, host, port):
        seen["bind"] = (host, port)
        return _Httpd()

    monkeypatch.setattr(asgi.ServingApp, "bind", bind)
    monkeypatch.setattr(asgi.ServingApp, "close",
                        lambda app: seen.setdefault("app_closed", True))
    monkeypatch.setattr(asgi.GraphServer, "warmup", lambda server: None)
    spec = {"graph": {"kind": "flow", "steps": {}}, "parameters": {}}
    monkeypatch.setenv("SERVING_SPEC_ENV", json.dumps(spec))
    monkeypatch.setattr("mlrun_tpu_torch.training.preemption."
                        "PreemptionGuard.install", lambda guard: guard)
    assert _invoke("port", ["serve", "--port", "18123", "--host",
                            "127.0.0.1"]) == (0, "", "")
    assert seen == {"bind": ("127.0.0.1", 18123), "served": True,
                    "closed": True, "app_closed": True}


def test_get_or_create_ctx_reads_the_exec_config_like_reference(
        monkeypatch, homes):
    config = {"metadata": {"name": "inpod", "project": "p1",
                           "uid": "feedface"},
              "spec": {"parameters": {"lr": 0.1, "epochs": 3},
                       "output_path": "/tmp/out"}}
    monkeypatch.setenv("MLT_EXEC_CONFIG", json.dumps(config))
    got = {}
    for name, pkg in (("jax", mlrun_tpu), ("port", mlrun_tpu_torch)):
        homes(name)
        ctx = pkg.get_or_create_ctx("ignored")
        got[name] = (ctx.name, ctx.uid, ctx.project, ctx.parameters,
                     ctx.artifact_path, ctx._autocommit)
    assert got["port"] == got["jax"] == (
        "inpod", "feedface", "p1", {"lr": 0.1, "epochs": 3}, "/tmp/out",
        True)
    monkeypatch.delenv("MLT_EXEC_CONFIG")
    for name, pkg in (("jax", mlrun_tpu), ("port", mlrun_tpu_torch)):
        home = homes(name)
        ctx = pkg.get_or_create_ctx("fresh", project="p2")
        got[name] = (ctx.name, ctx.project, ctx._autocommit,
                     ctx.artifact_path == os.path.join(home, "artifacts",
                                                       "p2"))
    assert got["port"] == got["jax"] == ("fresh", "p2", False, True)


# -- processes: python -m, the in-pod run, the JobSet's command ---------------

def _env(home, **extra) -> dict:
    env = dict(os.environ)
    for name in ("MLT_EXEC_CONFIG", "MLT_EXEC_CODE", "MLT_DBPATH", "RANK",
                 "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    env.update(PYTHONPATH=REPO, MLT_HOME=home, **extra)
    return env


def test_python_m_runs_the_ports_cli(tmp_path):
    out = subprocess.run([sys.executable, "-m", "mlrun_tpu_torch",
                          "version"], capture_output=True, text=True,
                         env=_env(str(tmp_path)), cwd=str(tmp_path),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == f"mlrun-tpu version {mlrun_tpu_torch.__version__}\n"


def test_run_from_env_in_a_process_imports_no_torch(tmp_path):
    """The pod's entry point as its own process: the run completes into
    the run db, and the CLI itself never imports torch or the
    reference; click, the CLI's own framework, is the one module of the
    four it loads."""
    code = ("import sys\n"
            "def handler(context, p: int = 0):\n"
            "    context.log_result('ok', p)\n"
            "    context.log_result('loaded', sorted(\n"
            "        m for m in ('torch', 'jax', 'mlrun_tpu', 'click')\n"
            "        if m in sys.modules))\n")
    config = {"metadata": {"name": "inpod", "project": "default",
                           "uid": "00112233445566778899aabbccddeeff"},
              "spec": {"parameters": {"p": 5}, "handler": "handler"}}
    db_path = str(tmp_path / "runs.sqlite")
    out = subprocess.run(
        [sys.executable, "-m", "mlrun_tpu_torch", "run", "--from-env"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=120,
        env=_env(str(tmp_path), MLT_DBPATH=db_path,
                 MLT_EXEC_CONFIG=json.dumps(config),
                 MLT_EXEC_CODE=base64.b64encode(code.encode()).decode()))
    assert out.returncode == 0, out.stderr
    assert out.stdout.endswith(
        "run 00112233445566778899aabbccddeeff finished: completed\n")
    run = tdb.SQLiteRunDB(db_path).read_run(
        "00112233445566778899aabbccddeeff", "default")
    assert run["status"]["results"] == {"ok": 5, "loaded": ["click"]}


def _shims(directory) -> str:
    """``python3`` and ``torchrun`` as this interpreter's, first on PATH."""
    directory.mkdir()
    for name, body in (("python3", f'exec {sys.executable} "$@"'),
                       ("torchrun", f"exec {sys.executable} -m "
                                    'torch.distributed.run "$@"')):
        path = directory / name
        path.write_text(f"#!/bin/sh\n{body}\n")
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(directory)


def test_tpujob_jobset_command_runs_the_ports_cli(tmp_path, monkeypatch):
    """Fault 3.7: the tpujob JobSet's program is the port's CLI, never the
    reference's ``mlrun-tpu`` console script; its own command, run under
    /bin/sh with the JobSet's env resolved as pod 0 of slice 0 (one
    node, one process, MASTER_ADDR 127.0.0.1), completes the run into
    the SQLite db the JobSet names."""
    db_path = str(tmp_path / "runs.sqlite")
    monkeypatch.setenv("MLT_DBPATH", db_path)
    code = ("import os\n"
            "def handler(context, x: int = 1):\n"
            "    print('in the pod')\n"
            "    context.log_result('double', x * 2)\n"
            "    context.log_result('rank', os.environ.get('RANK'))\n")
    fn = mlrun_tpu_torch.new_function("train", kind="tpujob", project="p")
    fn.with_gpus(nodes=1, gpus_per_node=1)
    run = RunObject.from_template(new_task(
        name="train", project="p", params={"x": 21}, handler="handler",
        artifact_path=str(tmp_path / "artifacts")))
    run.metadata.uid = "0123456789abcdef0123456789abcdef"
    jobset = fn.generate_jobset(run, extra_env={
        "MLT_EXEC_CODE": base64.b64encode(code.encode()).decode()})
    main = (jobset["spec"]["replicatedJobs"][0]["template"]["spec"]
            ["template"]["spec"]["containers"][0])
    assert main["args"] == ["python3", "-m", "mlrun_tpu_torch", "run",
                            "--from-env"]
    named = json.dumps(main["command"] + main["args"])
    assert "mlrun-tpu" not in named and '"mlrun_tpu"' not in named
    env = {e["name"]: e.get("value", "0") for e in main["env"]}
    assert env["MLT_DBPATH"] == db_path
    assert (env["NNODES"], env["NPROC_PER_NODE"]) == ("1", "1")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    shims = _shims(tmp_path / "bin")
    full = _env(str(tmp_path), **env)
    full["PATH"] = f"{shims}:{full['PATH']}"
    out = subprocess.run(main["command"] + main["args"], env=full,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    db = tdb.SQLiteRunDB(db_path, logs_dir=str(tmp_path / "logs"))
    stored = db.read_run(run.metadata.uid, "p")
    assert stored["status"]["state"] == "completed"
    assert stored["status"]["results"] == {"double": 42, "rank": "0"}
    assert db.get_log(run.metadata.uid, "p") == ("completed",
                                                  b"in the pod\n")
