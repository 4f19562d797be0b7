"""The port's CLI — the counterpart of ``mlrun_tpu/__main__.py``, on
``argparse``.

    python3 -m mlrun_tpu_torch run job.py --handler h --param x=1
    python3 -m mlrun_tpu_torch run --from-env       # the pod's program
    python3 -m mlrun_tpu_torch get runs
    python3 -m mlrun_tpu_torch logs <uid>
    python3 -m mlrun_tpu_torch project <dir> --run main
    python3 -m mlrun_tpu_torch serve --port 8080    # SERVING_SPEC_ENV
    python3 -m mlrun_tpu_torch db --port 8787       # the service
    python3 -m mlrun_tpu_torch bootstrap -r pkg -- python3 job.py

The commands, options, printed lines and exit codes are the reference's.
An error the reference raises as a ``click.ClickException`` prints
``Error: <message>`` to stderr and exits 1. ``build`` needs the image
builder (part 14c of ROADMAP.md item 14, not ported): it prints the
reason and exits 1.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import pathlib
import sys
import tempfile

from .config import EXEC_CODE_ENV, run_config


class CLIError(Exception):
    """An error reported as ``Error: <message>`` with exit code 1."""


def _pairs(items) -> list[tuple[str, str]]:
    return [item.partition("=")[::2] for item in items or []]


# -- run ---------------------------------------------------------------------
def _run(args) -> int:
    from .model import RunObject
    from .run import new_function

    url = args.url
    struct = {}
    if args.from_env:
        config_env = run_config("exec_config_env")
        config = os.environ.get(config_env)
        if not config:
            raise CLIError(f"--from-env set but {config_env} is empty")
        struct = json.loads(config)
        code = os.environ.get(EXEC_CODE_ENV)
        if code and not url:
            # a private temp dir, not the cwd: a bare "main.py" there would
            # clobber whatever file the working directory holds
            code_dir = tempfile.mkdtemp(prefix="mlt-exec-")
            url = os.path.join(code_dir, "main.py")
            pathlib.Path(url).write_text(base64.b64decode(code).decode())

    # a RunObject, not a RunTemplate: the exec config of a resubmitted
    # resource carries status (retry_count, checkpoint) that the in-run
    # context must round-trip instead of erasing on its first store_run
    template = RunObject.from_dict(struct) if struct else RunObject()
    if args.name:
        template.metadata.name = args.name
    if args.project:
        template.metadata.project = args.project
    for key, value in _pairs(args.param):
        try:
            value = json.loads(value)
        except (ValueError, TypeError):
            pass
        template.spec.parameters[key] = value
    for key, value in _pairs(args.str_param):
        template.spec.parameters[key] = value
    for key, value in _pairs(args.inputs):
        template.spec.inputs[key] = value
    if args.artifact_path:
        template.spec.output_path = args.artifact_path

    # the reference runs "job" only against a remote service; the port's
    # run db is never remote (an http(s):// dbpath is not ported), so a
    # run without --kind is a local one
    fn = new_function(
        name=args.name or template.metadata.name or "run",
        project=args.project or template.metadata.project,
        kind=args.kind or "local", command=url or "", image=args.image)
    run_result = fn.run(
        template, handler=args.handler or template.spec.handler_name or None,
        local=args.from_env or args.local, watch=args.watch)
    state = run_result.state()
    # KFP v2 output parameters: the pipeline compiler passes each produced
    # key as `--kfp-output key={{$.outputs.parameters[...].output_file}}`
    # (args, because the KFP launcher substitutes runtime placeholders in
    # command/args only); MLT_KFP_OUTPUTS is the JSON-env form for other
    # callers
    output_map = {}
    env_outputs = os.environ.get("MLT_KFP_OUTPUTS")
    if env_outputs:
        output_map.update(json.loads(env_outputs))
    for key, path in _pairs(args.kfp_output):
        if path:
            output_map[key] = path
    if output_map and state != "error":
        results = run_result.status.results or {}
        missing = []
        for key, path in output_map.items():
            if key not in results:
                missing.append(key)
                continue
            value = results[key]
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            pathlib.Path(path).write_text(
                value if isinstance(value, str) else json.dumps(value))
        if missing:
            # fail here with the unproduced keys named, not later in the
            # KFP launcher with an opaque "missing output file"
            raise CLIError(
                "run finished but did not produce declared output "
                f"parameter(s) {sorted(missing)}; available results: "
                f"{sorted(results)}")
    print(f"run {run_result.metadata.uid} finished: {state}")
    if state == "error":
        print(run_result.status.error or "", file=sys.stderr)
        return 1
    return 0


# -- get / logs --------------------------------------------------------------
def _get(args) -> int:
    from .db import get_run_db

    db = get_run_db()
    if args.kind == "runs":
        for r in db.list_runs(name=args.name, project=args.project,
                              state=args.state):
            meta, status = r.get("metadata", {}), r.get("status", {})
            print(f"{meta.get('uid', '')[:12]}  "
                  f"{meta.get('name', ''):24} {status.get('state', '')}"
                  f"  {status.get('results', {})}")
    elif args.kind == "functions":
        for f in db.list_functions(name=args.name, project=args.project):
            meta = f.get("metadata", {})
            print(f"{meta.get('name', ''):24} {f.get('kind', '')}")
    elif args.kind == "artifacts":
        for a in db.list_artifacts(name=args.name, project=args.project):
            meta = a.get("metadata", {})
            print(f"{meta.get('key', ''):24} {a.get('kind', '')}  "
                  f"{a.get('spec', {}).get('target_path', '')}")
    elif args.kind == "projects":
        for p in db.list_projects():
            print(p.get("metadata", {}).get("name", ""))
    elif args.kind == "schedules":
        for s in db.list_schedules(args.project or "*"):
            print(f"{s.get('name', ''):24} {s.get('cron_trigger', '')}")
    return 0


def _logs(args) -> int:
    from .db import get_run_db

    state, _ = get_run_db().watch_log(args.uid, args.project,
                                      watch=args.watch)
    print(f"\nfinal state: {state}")
    return 0


# -- project / serve ---------------------------------------------------------
def _project(args) -> int:
    from .projects import load_project

    proj = load_project(context=args.context, url=args.url or None,
                        name=args.name or None)
    print(f"project loaded: {proj.name}")
    if args.workflow:
        arguments = dict(_pairs(args.arguments))
        status = proj.run(args.workflow, arguments=arguments,
                          engine="local")
        print(f"workflow {args.workflow}: {status.state}")
    return 0


def _serve(args) -> int:
    from .serving.asgi import serve as serve_graph

    function = None
    if args.func_url:
        from .run import import_function

        function = import_function(args.func_url)
    serve_graph(function=function, host=args.host, port=args.port)
    return 0


# -- the service's commands -----------------------------------------------
def _build(args) -> int:
    """Build a function's image: ``fn.deploy`` through the service's image
    builder (part 14c of ROADMAP.md item 14, not ported)."""
    from .serving.resilience import not_ported

    raise CLIError(str(not_ported("the build command (the image builder, "
                                  "part 14c)", 14)))


def _db(args) -> int:
    """Start the metadata/orchestration service (aiohttp)."""
    from .service.app import run_app

    run_app(host=args.host, port=args.port)
    return 0


def _bootstrap(args) -> int:
    """Ensure a cached requirements overlay, then exec CMD with it on
    PYTHONPATH — the in-pod half of the build path (runtime handlers wrap
    run commands with this when the function declares
    build.requirements)."""
    from .utils.bootstrap import exec_with_requirements

    cmd = list(args.cmd)
    if cmd[:1] == ["--"]:
        cmd = cmd[1:]
    exec_with_requirements(list(args.requirement), cmd,
                           overlay_root=args.overlay_root or None)
    return 0


def _version(args) -> int:
    from . import __version__

    print(f"mlrun-tpu version {__version__}")
    return 0


def _config(args) -> int:
    """Write a client env file."""
    path = os.path.expanduser(args.env_file)
    lines = []
    if args.api:
        lines.append(f"MLT_DBPATH={args.api}")
    if args.artifact_path:
        lines.append(f"MLT_ARTIFACT_PATH={args.artifact_path}")
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")
    print(f"wrote {path}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="mlrun-tpu-torch",
        description="mlrun-tpu on PyTorch/CUDA — the MLOps framework CLI.")
    commands = parser.add_subparsers(dest="command", required=True)

    run = commands.add_parser(
        "run", help="execute a function/task (the in-pod contract: "
                    "run --from-env)")
    run.add_argument("url", nargs="?", default=None)
    run.add_argument("--name", default="", help="run name")
    run.add_argument("--project", "-p", default="", help="project name")
    run.add_argument("--handler", default="", help="handler function name")
    run.add_argument("--param", action="append", default=[],
                     help="key=value parameter")
    run.add_argument("--str-param", action="append", default=[],
                     help="key=value parameter taken verbatim as a string")
    run.add_argument("--inputs", "-i", action="append", default=[],
                     help="key=url input")
    run.add_argument("--artifact-path", default="",
                     help="artifact output path")
    run.add_argument("--kind", default="", help="runtime kind")
    run.add_argument("--image", default="", help="container image")
    run.add_argument("--from-env", action="store_true",
                     help="read the run spec from MLT_EXEC_CONFIG (the "
                          "in-pod entrypoint)")
    run.add_argument("--kfp-output", action="append", default=[],
                     help="key=path: write run result <key> to <path>")
    run.add_argument("--local", action="store_true",
                     help="force a local in-process run")
    run.add_argument("--watch", "-w", action="store_true")
    run.set_defaults(func=_run)

    get = commands.add_parser("get", help="list objects from the run DB")
    get.add_argument("kind", choices=["runs", "functions", "artifacts",
                                      "projects", "schedules"])
    get.add_argument("--project", "-p", default="")
    get.add_argument("--name", default="")
    get.add_argument("--state", default="")
    get.set_defaults(func=_get)

    logs = commands.add_parser("logs", help="fetch (or tail) run logs")
    logs.add_argument("uid")
    logs.add_argument("--project", "-p", default="")
    logs.add_argument("--watch", "-w", action="store_true")
    logs.set_defaults(func=_logs)

    project = commands.add_parser(
        "project", help="load (and optionally run a workflow of) a project")
    project.add_argument("context", nargs="?", default="./")
    project.add_argument("--name", "-n", default="")
    project.add_argument("--url", "-u", default="")
    project.add_argument("--run", "-r", dest="workflow", default="",
                         help="run this workflow after load")
    project.add_argument("--arguments", "-x", action="append", default=[],
                         help="workflow key=value")
    project.set_defaults(func=_project)

    build = commands.add_parser(
        "build", help="build/deploy a function image via the service")
    build.add_argument("func_url")
    build.add_argument("--tag", default="latest")
    build.add_argument("--with-tpu", action="store_true")
    build.set_defaults(func=_build)

    db = commands.add_parser("db", help="start the metadata service")
    db.add_argument("--port", default=0, type=int)
    db.add_argument("--host", default="")
    db.set_defaults(func=_db)

    serve = commands.add_parser(
        "serve", help="start a serving-graph gateway (SERVING_SPEC_ENV or "
                      "--function)")
    serve.add_argument("--port", default=8080, type=int)
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--function", dest="func_url", default="",
                       help="db:// or yaml url of a serving function")
    serve.set_defaults(func=_serve)

    bootstrap = commands.add_parser(
        "bootstrap", help="ensure a requirements overlay, then exec CMD")
    bootstrap.add_argument("--requirement", "-r", action="append",
                           default=[], help="pip requirement (repeatable)")
    bootstrap.add_argument("--overlay-root", default="",
                           help="overlay cache directory")
    bootstrap.add_argument("cmd", nargs=argparse.REMAINDER)
    bootstrap.set_defaults(func=_bootstrap)

    version = commands.add_parser("version")
    version.set_defaults(func=_version)

    config = commands.add_parser("config", help="write a client env file")
    config.add_argument("--api", default="", help="service url")
    config.add_argument("--artifact-path", default="")
    config.add_argument("--env-file", default="~/.mlrun-tpu.env")
    config.set_defaults(func=_config)
    return parser


def main(argv: list[str] | None = None) -> int:
    """Run one command; returns its exit code."""
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if extra and args.command != "run":
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    try:
        return args.func(args)
    except CLIError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
