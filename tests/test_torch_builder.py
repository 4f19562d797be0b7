"""mlrun_tpu_torch's image builder (``service/builder.py``, the service's
``build/function`` and ``build/status`` routes, ``KubejobRuntime.deploy``)
against mlrun_tpu's.

The cases of ``tests/test_build.py`` run on both packages with the same
inputs: the Dockerfile and Kaniko pod, a build through each package's
service that installs a local package offline into the requirements
overlay and a run that imports it, a failing build's log, the bootstrap
wrap of a pod command, the image-tag strip, and a local build with
commands failing loudly (the overlay and lock cases run in
``tests/test_torch_service_backends.py``). The Kaniko cases of
``tests/test_k8s_provider.py`` run over ``tests/fake_k8s.py``.
"""

import base64
import textwrap
import time
import types

import pytest

import mlrun_tpu
import mlrun_tpu_torch
from . import fake_k8s
from tests.torch_service import PKGS, Service

OFFLINE_FLAGS = ["--no-index", "--no-build-isolation"]

BUILD = {"jax": types.SimpleNamespace(top=mlrun_tpu, cli=["mlrun-tpu"],
                                      **vars(PKGS["jax"])),
         "port": types.SimpleNamespace(top=mlrun_tpu_torch,
                                       cli=["python3", "-m",
                                            "mlrun_tpu_torch"],
                                       **vars(PKGS["port"]))}


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    running = {}
    patch = pytest.MonkeyPatch()
    try:
        for name, pkg in PKGS.items():
            running[name] = Service(pkg, tmp_path_factory.mktemp(name),
                                    patch)
        yield running
    finally:
        for svc in running.values():
            svc.stop()
        patch.undo()


@pytest.fixture(autouse=True)
def _advertised(services):
    """The reference's ``mlconf`` is reloaded before every test: point
    its advertised port at its service again."""
    from mlrun_tpu.config import mlconf

    mlconf.httpdb.port = services["jax"].port


def _make_local_pkg(tmp_path, name="mltdemo", value=3):
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "setup.py").write_text(
        "from setuptools import setup\n"
        f"setup(name='{name}', version='0.1', py_modules=['{name}'])\n")
    (pkg / f"{name}.py").write_text(
        f"def triple(x):\n    return x * {value}\n")
    return pkg


def _both(services, scenario):
    return {name: scenario(svc, BUILD[name])
            for name, svc in services.items()}


def _job(svc, build, name, project="bld"):
    fn = build.top.new_function(name, project=project, kind="job",
                                image="x")
    fn._db = svc.db
    return fn


# -- tests/test_build.py ------------------------------------------------------

def test_make_dockerfile_and_kaniko_pod(monkeypatch):
    out = []
    for name, build in BUILD.items():
        dockerfile = build.builder.make_dockerfile(
            "mlrun-tpu/gpu:latest", requirements=["scipy", "fastparquet"],
            commands=["apt-get update"])
        monkeypatch.setattr(build.builder.time, "time", lambda: 1700000000)
        pod = build.builder.make_kaniko_pod(
            "p1", "fn1", dockerfile, "registry/repo/img:tag",
            registry_secret="regcreds")
        out.append((dockerfile, pod))
    assert out[1] == out[0]
    dockerfile, pod = out[1]
    assert dockerfile.startswith("FROM mlrun-tpu/gpu:latest")
    assert "RUN apt-get update" in dockerfile
    assert "pip install" in dockerfile and "requirements.txt" in dockerfile
    assert pod["kind"] == "Pod"
    assert pod["spec"]["containers"][0]["image"].startswith(
        "gcr.io/kaniko-project/executor")
    assert "--destination=registry/repo/img:tag" in \
        pod["spec"]["containers"][0]["args"]
    init = pod["spec"]["initContainers"][0]
    assert init["env"][0]["value"] == dockerfile
    assert any(v["name"] == "registry-creds" for v in pod["spec"]["volumes"])


def test_build_deploy_then_run_imports_package(services, tmp_path):
    """fn.with_requirements -> fn.deploy() builds the overlay in the
    service -> a submitted run imports the package inside it (each
    package's from its own source directory, so neither build is a cache
    hit of the other's overlay)."""
    code = textwrap.dedent("""
        def handler(context, x: int = 2):
            import mltdemo
            context.log_result("tripled", mltdemo.triple(x))
    """)

    def scenario(svc, build):
        (tmp_path / svc.pkg.name).mkdir()
        pkg = _make_local_pkg(tmp_path / svc.pkg.name, value=7)
        fn = _job(svc, build, "bldfn")
        fn.spec.build.functionSourceCode = base64.b64encode(
            code.encode()).decode()
        fn.spec.default_handler = "handler"
        fn.with_requirements(OFFLINE_FLAGS + [str(pkg)])
        deployed = fn.deploy(watch=True)
        stored = svc.db.get_function("bldfn", "bld", tag="latest")
        status = svc.db.get_builder_status(fn)
        data = status.get("data", status)
        task = {"metadata": {"name": "bldrun", "project": "bld"},
                "spec": {"handler": "handler", "parameters": {"x": 5},
                         "function": "bld/bldfn:latest"}}
        resp = svc.db.submit_job({"function": fn.to_dict(), "task": task})
        uid = resp["data"]["metadata"]["uid"]
        deadline = time.time() + 90
        while time.time() < deadline:
            run = svc.db.read_run(uid, "bld")
            if run["status"].get("state") in ("completed", "error"):
                break
            svc.state.launcher.monitor_all()
            time.sleep(0.3)
        return (deployed, stored["status"]["state"],
                "pip install" in data["log"], data["state"],
                run["status"]["state"], run["status"].get("results"),
                svc.db.get_log(uid, "bld")[1][-2000:])

    got = _both(services, scenario)
    assert got["port"][:-1] == got["jax"][:-1] == (
        True, "ready", True, "ready", "completed", {"tripled": 35}), \
        got["port"][-1]


def test_build_failure_has_retrievable_log(services):
    def scenario(svc, build):
        fn = _job(svc, build, "badbld")
        fn.with_requirements(["--no-index", "definitely-not-a-package-xyz"])
        deployed = fn.deploy(watch=True)
        stored = svc.db.get_function("badbld", "bld", tag="latest")
        status = svc.db.get_builder_status(fn)
        data = status.get("data", status)
        return (deployed, stored["status"]["state"],
                "failed" in data["log"] or "ERROR" in data["log"],
                "definitely-not-a-package-xyz" in data["log"])

    got = _both(services, scenario)
    assert got["port"] == got["jax"] == (False, "error", True, True)


def test_bootstrap_command_wrap():
    """A function with requirements gets its pod command wrapped in the
    package's bootstrap."""
    class _Build:
        requirements = ["scipy", "einx"]

    class _Spec:
        build = _Build()

    class _Runtime:
        spec = _Spec()

    for name, build in BUILD.items():
        _Build.requirements = ["scipy", "einx"]
        wrapped = build.handlers._wrap_with_bootstrap(
            _Runtime(), build.cli + ["run", "--from-env"])
        assert wrapped == build.cli + ["bootstrap", "-r", "scipy", "-r",
                                       "einx", "--"] + build.cli + [
            "run", "--from-env"], name
        _Build.requirements = []
        assert build.handlers._wrap_with_bootstrap(_Runtime(), ["x"]) == \
            ["x"]


@pytest.mark.parametrize("image,want", [
    ("repo:tag", "repo"),
    ("registry:5000/repo", "registry:5000/repo"),
    ("registry:5000/repo:tag", "registry:5000/repo"),
    ("repo@sha256:abc123", "repo"),
    ("repo:tag@sha256:abc123", "repo"),
    ("registry:5000/ns/repo:tag@sha256:abc", "registry:5000/ns/repo"),
])
def test_strip_image_tag_digest_and_port(image, want):
    assert BUILD["port"].builder._strip_image_tag(image) == \
        BUILD["jax"].builder._strip_image_tag(image) == want


def test_local_build_with_commands_fails_loudly(services):
    """The local overlay path cannot run docker RUN commands: the build
    fails with the commands named in its log."""
    def scenario(svc, build):
        fn = _job(svc, build, "cmdbld")
        fn.spec.build.commands = ["apt-get install -y libfoo"]
        deployed = fn.deploy(watch=True)
        stored = svc.db.get_function("cmdbld", "bld", tag="latest")
        status = svc.db.get_builder_status(fn)
        data = status.get("data", status)
        return (deployed, stored["status"]["state"],
                stored["status"].get("error", ""), "libfoo" in data["log"])

    got = _both(services, scenario)
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (False, "error")
    assert "commands" in got["port"][2] and got["port"][3]


def test_prebuilt_image_and_skip_deployed(services):
    """A function with a prebuilt image and nothing to bake is ready at
    once; ``skip_deployed`` returns without a build."""
    def scenario(svc, build):
        fn = _job(svc, build, "readyfn")
        deployed = fn.deploy()
        stored = svc.db.get_function("readyfn", "bld", tag="latest")
        return (deployed, stored["status"]["state"], stored["spec"]["image"],
                fn.deploy(skip_deployed=True))

    got = _both(services, scenario)
    assert got["port"] == got["jax"] == (True, "ready", "x", True)


# -- the Kaniko cases of tests/test_k8s_provider.py ---------------------------

@pytest.fixture(params=list(PKGS))
def k8s(request, monkeypatch, tmp_path):
    """A fake cluster, the package's KubernetesProvider and run db."""
    pkg = PKGS[request.param]
    monkeypatch.setattr(fake_k8s, "chaos_fire", pkg.chaos.fire)
    cluster = fake_k8s.install(monkeypatch)
    provider = pkg.handlers.KubernetesProvider(namespace="testns")
    db = pkg.sqlitedb.SQLiteRunDB(dsn=str(tmp_path / "svc.db"),
                                  logs_dir=str(tmp_path / "logs"))
    return types.SimpleNamespace(pkg=pkg, build=BUILD[pkg.name],
                                 cluster=cluster, provider=provider, db=db)


def _build_fn(name="bfn", requirements=None, commands=None):
    return {
        "kind": "job",
        "metadata": {"name": name, "project": "kp", "tag": "latest"},
        "spec": {"image": "registry/base:v1",
                 "build": {"requirements": requirements or [],
                           "commands": commands or []}},
    }


def _wait(predicate, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return False


def test_kaniko_build_success(k8s):
    """A requirements+commands build on the kubernetes provider runs a
    Kaniko pod; Succeeded -> the function is ready with the derived
    destination image, the pod is deleted, the background task
    succeeds."""
    builder = k8s.build.builder.FunctionBuilder(k8s.db, k8s.provider)
    out = builder.build(_build_fn(requirements=["scipy"],
                                  commands=["apt-get update"]))
    assert out["state"] == "deploying"
    assert out["image"] == "registry/base-bfn:latest"
    assert _wait(lambda: k8s.cluster.pods), "kaniko pod never created"
    pod_name = next(iter(k8s.cluster.pods))
    assert pod_name.startswith("mlt-build-kp-bfn")
    pod = k8s.cluster.pods[pod_name]
    init_env = pod["spec"]["initContainers"][0]["env"]
    assert init_env[1] == {"name": "REQUIREMENTS", "value": "scipy"}
    assert init_env[0]["value"].startswith("FROM mlrun-tpu/base:latest")
    k8s.cluster.set_pod_phase(pod_name, "Succeeded")
    assert _wait(lambda: k8s.db.get_background_task(
        out["background_task"], "kp")["state"] == "succeeded")
    stored = k8s.db.get_function("bfn", "kp", tag="latest")
    assert stored["status"]["state"] == "ready"
    assert stored["spec"]["image"] == "registry/base-bfn:latest"
    assert k8s.cluster.pods == {}


def test_kaniko_build_failure_records_error(k8s):
    builder = k8s.build.builder.FunctionBuilder(k8s.db, k8s.provider)
    out = builder.build(_build_fn(name="badbfn", requirements=["x"]))
    assert _wait(lambda: k8s.cluster.pods), "kaniko pod never created"
    k8s.cluster.set_pod_phase(next(iter(k8s.cluster.pods)), "Failed")
    assert _wait(lambda: k8s.db.get_background_task(
        out["background_task"], "kp")["state"] == "failed")
    stored = k8s.db.get_function("badbfn", "kp", tag="latest")
    assert stored["status"]["state"] == "error"
    assert "kaniko" in stored["status"]["error"]
