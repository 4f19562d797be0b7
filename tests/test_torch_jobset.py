"""The port's GPU JobSet builder (mlrun_tpu_torch.k8s.jobset) against the
reference's TPU builder (mlrun_tpu.k8s.jobset): both manifests agree on
every field that carries over (the JobSet envelope, the one replicated
Indexed Job, ``backoffLimit`` 0, the headless ``subdomain``,
``failurePolicy.maxRestarts`` with the elastic restart floor, the serving
annotation, the ``/readyz`` probe, the ``/__drain__`` preStop and
``COMPILE_CACHE_ENV``); the GPU fields (``nvidia.com/gpu`` limits, the GPU
product node selector) and torchrun's rendezvous env replace the TPU
ones; and the container command, run by ``sh`` with the pod's env and a
stand-in ``torchrun``, hands torchrun the node's global rank.

Bounds: every compared field equal.
"""

import copy
import os
import stat
import subprocess

import pytest

from mlrun_tpu.k8s import jobset as jjobset
from mlrun_tpu_torch.config import COMPILE_CACHE_ENV
from mlrun_tpu_torch.k8s import jobset as tjobset

POD = {"containers": [{"name": "main", "image": "trainer:1",
                       "args": ["train.py", "--steps", "10"]}]}


def _pair(builder, **kw):
    # the reference's builder appends to the caller's container (its
    # shallow copy): each builder gets a fresh pod spec
    ref = getattr(jjobset, builder)("run", "ns", copy.deepcopy(POD),
                                    accelerator="tpu-v5p-slice",
                                    topology="2x2x1", chips_per_host=4, **kw)
    port = getattr(tjobset, builder)("run", "ns", copy.deepcopy(POD),
                                     gpu_product="NVIDIA-H100-80GB-HBM3",
                                     nodes=1, gpus_per_node=8, **kw)
    return ref, port


def _job(spec):
    return spec["spec"]["replicatedJobs"][0]


def _pod(spec):
    return _job(spec)["template"]["spec"]["template"]["spec"]


def _main(spec):
    return _pod(spec)["containers"][0]


def _env(spec) -> dict:
    return {e["name"]: e.get("value", e.get("valueFrom"))
            for e in _main(spec).get("env", [])}


def _shared(spec) -> dict:
    job = _job(spec)
    template = job["template"]["spec"]
    return {
        "envelope": (spec["apiVersion"], spec["kind"], spec["metadata"]),
        "suspend": spec["spec"]["suspend"],
        "failure": spec["spec"]["failurePolicy"],
        "job": (job["name"], job["replicas"]),
        "indexed": {k: template[k] for k in (
            "parallelism", "completions", "backoffLimit", "completionMode")},
        "pod_labels": template["template"]["metadata"],
        "subdomain": _pod(spec)["subdomain"],
        "port_names": [p["name"] for p in _main(spec)["ports"]],
        "probe": _main(spec).get("readinessProbe"),
        "lifecycle": _main(spec).get("lifecycle"),
        "cache": _env(spec).get(COMPILE_CACHE_ENV),
    }


@pytest.mark.parametrize("kw", [
    {}, {"num_slices": 2, "elastic": True}, {"num_slices": 3,
                                             "max_restarts": 5,
                                             "suspend": True,
                                             "labels": {"team": "a"}}])
def test_training_jobset_agrees_on_shared_fields(kw):
    ref, port = _pair("build_jobset", **kw)
    assert _shared(port) == _shared(ref)


def test_serving_jobset_agrees_on_shared_fields():
    ref, port = _pair("build_serving_jobset", compile_cache_dir="/cache",
                      serve_port=9000)
    assert _shared(port) == _shared(ref)
    assert port["metadata"]["annotations"][tjobset.SERVING_ANNOTATION] == \
        "true"
    assert _env(port)[COMPILE_CACHE_ENV] == "/cache"


def test_serving_pod_without_a_program_runs_the_ports_gateway():
    """A serving container that names no program (the pod fleet's default
    pod spec) runs the port's ``serve`` as one process, on the probes'
    port; a given program keeps its torchrun launch."""
    from mlrun_tpu_torch.__main__ import main as cli

    spec = tjobset.build_serving_jobset(
        "serve-a", "ns", {"containers": [{"name": "engine",
                                          "image": "img"}]},
        gpu_product="H100", gpus_per_node=2, serve_port=9000)
    main = _main(spec)
    assert main["command"] == ["python3", "-m", "mlrun_tpu_torch", "serve",
                               "--port", "9000"]
    assert "args" not in main
    ctx = cli.make_context("mlrun-tpu-torch", main["command"][3:])
    serve = cli.get_command(ctx, main["command"][3])
    args = serve.make_context("serve", main["command"][4:], parent=ctx)
    assert (serve.name, args.params["port"]) == ("serve", 9000)
    assert main["readinessProbe"]["httpGet"]["port"] == 9000
    given = tjobset.build_serving_jobset(
        "serve-b", "ns", {"containers": [{"name": "engine", "image": "img",
                                          "args": ["serve.py"]}]},
        gpu_product="H100", gpus_per_node=1)
    assert "torchrun" in _main(given)["command"][2]
    assert _main(given)["args"] == ["serve.py"]


def test_gpu_fields_and_torchrun_env():
    spec = tjobset.build_jobset("run", "ns", POD, gpu_product="H100",
                                nodes=2, gpus_per_node=4, num_slices=2)
    main = _main(spec)
    assert main["resources"]["limits"] == {"nvidia.com/gpu": 4}
    assert _pod(spec)["nodeSelector"] == {"nvidia.com/gpu.product": "H100"}
    env = _env(spec)
    assert env["MASTER_ADDR"] == "run-slice-0-0.run"
    assert env["MASTER_PORT"] == str(tjobset.MASTER_PORT)
    assert env["NNODES"] == "4" and env["NPROC_PER_NODE"] == "4"
    assert env["NODE_RANK"]["fieldRef"]["fieldPath"].endswith(
        "['batch.kubernetes.io/job-completion-index']")
    assert env["MLT_SLICE_ID"]["fieldRef"]["fieldPath"].endswith(
        "['jobset.sigs.k8s.io/job-index']")
    assert not {"TPU_WORKER_ID", "MEGASCALE_NUM_SLICES"} & set(env)
    assert main["args"] == ["train.py", "--steps", "10"]
    assert POD["containers"][0] == {"name": "main", "image": "trainer:1",
                                    "args": ["train.py", "--steps", "10"]}
    for bad in ({"nodes": 0}, {"gpus_per_node": -1}, {"nodes": 1.5}):
        with pytest.raises(tjobset.TopologyError):
            tjobset.build_jobset("run", "ns", POD, gpu_product="H100", **bad)


def test_command_hands_torchrun_the_global_node_rank(tmp_path):
    """The pod's command under sh with its env resolved (slice 1, pod 1 of
    2): a stand-in torchrun records what it was given."""
    fake = tmp_path / "torchrun"
    fake.write_text('#!/bin/sh\nprintf "%s\\n" "$@"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    for pod, no_python in ((POD, False), (
            {"containers": [{"name": "m", "command": ["python3", "-m", "x"],
                             "args": ["--a"]}]}, True)):
        spec = tjobset.build_jobset("run", "ns", pod, gpu_product="H100",
                                    nodes=2, gpus_per_node=8, num_slices=2)
        env = dict(os.environ, PATH=f"{tmp_path}:{os.environ['PATH']}")
        for name, value in _env(spec).items():
            env[name] = value if isinstance(value, str) else "1"
        main = _main(spec)
        out = subprocess.run(main["command"] + main["args"], env=env,
                             capture_output=True, text=True, timeout=30)
        assert out.returncode == 0, out.stderr
        got = out.stdout.splitlines()
        assert got[:5] == ["--nnodes=4", "--nproc_per_node=8",
                           "--node_rank=3", "--master_addr=run-slice-0-0.run",
                           f"--master_port={tjobset.MASTER_PORT}"]
        if no_python:
            assert got[5:] == ["--no-python", "python3", "-m", "x", "--a"]
        else:
            assert got[5:] == ["train.py", "--steps", "10"]
