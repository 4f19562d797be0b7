"""The port's CLI — the counterpart of ``mlrun_tpu/__main__.py``, the same
``click`` group.

    python3 -m mlrun_tpu_torch run job.py --handler h --param x=1
    python3 -m mlrun_tpu_torch run --from-env       # the pod's program
    python3 -m mlrun_tpu_torch get runs
    python3 -m mlrun_tpu_torch logs <uid>
    python3 -m mlrun_tpu_torch project <dir> --run main
    python3 -m mlrun_tpu_torch serve --port 8080    # SERVING_SPEC_ENV
    python3 -m mlrun_tpu_torch db --port 8787       # the service
    python3 -m mlrun_tpu_torch bootstrap -r pkg -- python3 job.py

The commands, options, printed lines and exit codes are the reference's.
Two departures: ``run`` without ``--kind`` is a local run, and ``build``
names its flag ``--with-gpu`` (``--with-tpu`` is kept as an alias).
Only this module imports click: ``import mlrun_tpu_torch`` loads none of
it.
"""

from __future__ import annotations

import base64
import json
import os
import pathlib
import sys
import tempfile

import click

from .config import EXEC_CODE_ENV, run_config


@click.group()
def main():
    """mlrun-tpu on PyTorch/CUDA — the MLOps framework CLI."""


@main.command(context_settings={"ignore_unknown_options": True})
@click.argument("url", required=False)
@click.option("--name", default="", help="run name")
@click.option("--project", "-p", default="", help="project name")
@click.option("--handler", default="", help="handler function name")
@click.option("--param", multiple=True, help="key=value parameter")
@click.option("--str-param", multiple=True,
              help="key=value parameter taken verbatim as a string (no "
                   "JSON coercion; the KFP compiler routes STRING-typed "
                   "step outputs here so '7' stays '7')")
@click.option("--inputs", "-i", multiple=True, help="key=url input")
@click.option("--artifact-path", default="", help="artifact output path")
@click.option("--kind", default="", help="runtime kind")
@click.option("--image", default="", help="container image")
@click.option("--from-env", is_flag=True,
              help="read run spec from MLT_EXEC_CONFIG (in-pod entrypoint)")
@click.option("--kfp-output", multiple=True,
              help="key=path: write run result <key> to <path> after the "
                   "run (KFP v2 output-parameter contract; paths come "
                   "from placeholder-substituted args)")
@click.option("--local", is_flag=True, help="force local in-process run")
@click.option("--watch", "-w", is_flag=True, default=False)
@click.argument("run_args", nargs=-1, type=click.UNPROCESSED)
def run(url, name, project, handler, param, str_param, inputs,
        artifact_path, kind, image, from_env, kfp_output, local, watch,
        run_args):
    """Execute a function/task (the in-pod contract: `run --from-env`)."""
    from .model import RunObject
    from .run import new_function

    struct = {}
    if from_env:
        config_env = run_config("exec_config_env")
        config = os.environ.get(config_env)
        if not config:
            raise click.ClickException(
                f"--from-env set but {config_env} is empty")
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
    if name:
        template.metadata.name = name
    if project:
        template.metadata.project = project
    for pair in param:
        key, _, value = pair.partition("=")
        try:
            value = json.loads(value)
        except (ValueError, TypeError):
            pass
        template.spec.parameters[key] = value
    for pair in str_param:
        key, _, value = pair.partition("=")
        template.spec.parameters[key] = value
    for pair in inputs:
        key, _, value = pair.partition("=")
        template.spec.inputs[key] = value
    if artifact_path:
        template.spec.output_path = artifact_path

    # a run without --kind is a local one (the reference submits a "job"
    # to the service when its run db is remote)
    fn = new_function(
        name=name or template.metadata.name or "run",
        project=project or template.metadata.project,
        kind=kind or "local", command=url or "", image=image)
    run_result = fn.run(
        template, handler=handler or template.spec.handler_name or None,
        local=from_env or local, watch=watch)
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
    for item in kfp_output:
        key, _, path = item.partition("=")
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
            raise click.ClickException(
                "run finished but did not produce declared output "
                f"parameter(s) {sorted(missing)}; available results: "
                f"{sorted(results)}")
    click.echo(f"run {run_result.metadata.uid} finished: {state}")
    if state == "error":
        click.echo(run_result.status.error or "", err=True)
        sys.exit(1)


@main.command()
@click.argument("kind", type=click.Choice(
    ["runs", "functions", "artifacts", "projects", "schedules"]))
@click.option("--project", "-p", default="")
@click.option("--name", default="")
@click.option("--state", default="")
def get(kind, project, name, state):
    """List objects from the run DB."""
    from .db import get_run_db

    db = get_run_db()
    if kind == "runs":
        for r in db.list_runs(name=name, project=project, state=state):
            meta, status = r.get("metadata", {}), r.get("status", {})
            click.echo(f"{meta.get('uid', '')[:12]}  "
                       f"{meta.get('name', ''):24} {status.get('state', '')}"
                       f"  {status.get('results', {})}")
    elif kind == "functions":
        for f in db.list_functions(name=name, project=project):
            meta = f.get("metadata", {})
            click.echo(f"{meta.get('name', ''):24} {f.get('kind', '')}")
    elif kind == "artifacts":
        for a in db.list_artifacts(name=name, project=project):
            meta = a.get("metadata", {})
            click.echo(f"{meta.get('key', ''):24} {a.get('kind', '')}  "
                       f"{a.get('spec', {}).get('target_path', '')}")
    elif kind == "projects":
        for p in db.list_projects():
            click.echo(p.get("metadata", {}).get("name", ""))
    elif kind == "schedules":
        for s in db.list_schedules(project or "*"):
            click.echo(f"{s.get('name', ''):24} {s.get('cron_trigger', '')}")


@main.command()
@click.argument("uid")
@click.option("--project", "-p", default="")
@click.option("--watch", "-w", is_flag=True)
def logs(uid, project, watch):
    """Fetch (or tail) run logs."""
    from .db import get_run_db

    state, _ = get_run_db().watch_log(uid, project, watch=watch)
    click.echo(f"\nfinal state: {state}")


@main.command()
@click.argument("context", default="./")
@click.option("--name", "-n", default="")
@click.option("--url", "-u", default="")
@click.option("--run", "-r", "workflow", default="",
              help="run this workflow after load")
@click.option("--arguments", "-x", multiple=True, help="workflow key=value")
def project(context, name, url, workflow, arguments):
    """Load (and optionally run a workflow of) a project."""
    from .projects import load_project

    proj = load_project(context=context, url=url or None, name=name or None)
    click.echo(f"project loaded: {proj.name}")
    if workflow:
        args = {}
        for pair in arguments:
            key, _, value = pair.partition("=")
            args[key] = value
        status = proj.run(workflow, arguments=args, engine="local")
        click.echo(f"workflow {workflow}: {status.state}")


@main.command()
@click.argument("func_url")
@click.option("--tag", default="latest")
@click.option("--with-gpu", "--with-tpu", "with_gpu", is_flag=True)
def build(func_url, tag, with_gpu):
    """Build/deploy a function image via the service."""
    import inspect

    from .run import import_function

    fn = import_function(func_url)
    deploy_kwargs = {}
    if "with_gpu" in inspect.signature(fn.deploy).parameters:
        deploy_kwargs["with_gpu"] = with_gpu
    ok = fn.deploy(**deploy_kwargs)
    click.echo(f"build {'succeeded' if ok else 'failed'}: {fn.spec.image}")
    if not ok:
        sys.exit(1)


@main.command()
@click.option("--port", default=0, type=int)
@click.option("--host", default="")
def db(port, host):
    """Start the metadata/orchestration service (aiohttp)."""
    from .service.app import run_app

    run_app(host=host, port=port)


@main.command()
@click.option("--port", default=8080, type=int)
@click.option("--host", default="0.0.0.0")
@click.option("--function", "func_url", default="",
              help="db:// or yaml url of a serving function")
def serve(port, host, func_url):
    """Start a serving-graph gateway (SERVING_SPEC_ENV or --function)."""
    from .serving.asgi import serve as serve_graph

    function = None
    if func_url:
        from .run import import_function

        function = import_function(func_url)
    serve_graph(function=function, host=host, port=port)


@main.command(context_settings={"ignore_unknown_options": True})
@click.option("--requirement", "-r", multiple=True,
              help="pip requirement (repeatable)")
@click.option("--overlay-root", default="", help="overlay cache directory")
@click.argument("cmd", nargs=-1, type=click.UNPROCESSED)
def bootstrap(requirement, overlay_root, cmd):
    """Ensure a cached requirements overlay, then exec CMD with it on
    PYTHONPATH — the in-pod half of the build path (runtime handlers wrap
    run commands with this when the function declares
    build.requirements)."""
    from .utils.bootstrap import exec_with_requirements

    exec_with_requirements(list(requirement), list(cmd),
                           overlay_root=overlay_root or None)


@main.command()
def version():
    from . import __version__

    click.echo(f"mlrun-tpu version {__version__}")


@main.command()
@click.option("--api", default="", help="service url")
@click.option("--artifact-path", default="")
@click.option("--env-file", default="~/.mlrun-tpu.env")
def config_cmd(api, artifact_path, env_file):
    """Write a client env file."""
    path = os.path.expanduser(env_file)
    lines = []
    if api:
        lines.append(f"MLT_DBPATH={api}")
    if artifact_path:
        lines.append(f"MLT_ARTIFACT_PATH={artifact_path}")
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")
    click.echo(f"wrote {path}")


main.add_command(config_cmd, name="config")


if __name__ == "__main__":
    main()
