"""Spark runtime — the port's copy of ``mlrun_tpu/runtimes/sparkjob.py``
(the spark-operator's SparkApplication with driver/executor resources).

Spark is a CPU dataframe engine beside the GPU pods. Client-side the
runtime builds the SparkApplication CRD; ``run(..., local=True)`` executes
the handler with a local SparkSession when pyspark is importable.
"""

from __future__ import annotations

from ..config import K8S_DEFAULTS, run_config
from ..model import RunObject
from .pod import KubeResource, KubeResourceSpec


class SparkJobSpec(KubeResourceSpec):
    _dict_fields = KubeResourceSpec._dict_fields + [
        "driver_resources", "executor_resources", "executor_replicas",
        "spark_version", "main_class", "spark_conf", "deps",
    ]

    def __init__(self, driver_resources=None, executor_resources=None,
                 executor_replicas=None, spark_version=None, main_class=None,
                 spark_conf=None, deps=None, **kwargs):
        super().__init__(**kwargs)
        self.driver_resources = driver_resources or {
            "requests": {"cpu": "1", "memory": "2g"}}
        self.executor_resources = executor_resources or {
            "requests": {"cpu": "1", "memory": "4g"}}
        self.executor_replicas = executor_replicas or 2
        self.spark_version = spark_version or "3.5.0"
        self.main_class = main_class
        self.spark_conf = spark_conf or {}
        self.deps = deps or {}


class SparkRuntime(KubeResource):
    kind = "spark"
    _is_remote = True
    _nested_fields = {**KubeResource._nested_fields, "spec": SparkJobSpec}

    def __init__(self, metadata=None, spec=None, status=None):
        super().__init__(metadata, spec, status)
        if not isinstance(self.spec, SparkJobSpec):
            self.spec = SparkJobSpec.from_dict(self.spec.to_dict())

    def with_driver_resources(self, mem: str = "", cpu: str = ""):
        requests = self.spec.driver_resources.setdefault("requests", {})
        if mem:
            requests["memory"] = mem
        if cpu:
            requests["cpu"] = cpu
        return self

    def with_executor_resources(self, mem: str = "", cpu: str = "",
                                replicas: int | None = None):
        requests = self.spec.executor_resources.setdefault("requests", {})
        if mem:
            requests["memory"] = mem
        if cpu:
            requests["cpu"] = cpu
        if replicas:
            self.spec.executor_replicas = replicas
        return self

    def generate_spark_application(self, runobj: RunObject) -> dict:
        """The sparkoperator.k8s.io SparkApplication of a run."""
        import json

        name = f"{runobj.metadata.name}-{runobj.metadata.uid[:8]}"
        return {
            "apiVersion": "sparkoperator.k8s.io/v1beta2",
            "kind": "SparkApplication",
            "metadata": {
                "name": name,
                "namespace": K8S_DEFAULTS["namespace"],
                "labels": {
                    "mlrun-tpu/project": runobj.metadata.project,
                    "mlrun-tpu/uid": runobj.metadata.uid,
                    "mlrun-tpu/class": self.kind,
                },
            },
            "spec": {
                "type": "Python",
                "sparkVersion": self.spec.spark_version,
                "mode": "cluster",
                "image": self.full_image_path(),
                "mainApplicationFile": self.spec.command or "local:///main.py",
                "sparkConf": self.spec.spark_conf,
                "driver": {
                    "cores": int(float(self.spec.driver_resources
                                       .get("requests", {})
                                       .get("cpu", "1"))),
                    "memory": self.spec.driver_resources
                    .get("requests", {}).get("memory", "2g"),
                    "env": self._container_env({
                        run_config("exec_config_env"): json.dumps(
                            runobj.to_dict(), default=str)}),
                },
                "executor": {
                    "instances": self.spec.executor_replicas,
                    "cores": int(float(self.spec.executor_resources
                                       .get("requests", {})
                                       .get("cpu", "1"))),
                    "memory": self.spec.executor_resources
                    .get("requests", {}).get("memory", "4g"),
                },
            },
        }

    def _run(self, runobj: RunObject, execution) -> dict:
        # local mode: execute with a local SparkSession (gated on pyspark)
        try:
            from pyspark.sql import SparkSession
        except ImportError as exc:
            raise RuntimeError(
                "the spark runtime needs the service + spark-operator, or "
                "pyspark installed for local execution") from exc
        from .local import exec_from_params, load_module

        spark = SparkSession.builder.master("local[*]").appName(
            runobj.metadata.name).getOrCreate()
        try:
            handler = runobj.spec.handler
            if not callable(handler):
                handler = load_module(self.spec.command,
                                      runobj.spec.handler_name or "handler")
            execution.spark = spark
            return exec_from_params(handler, runobj, execution)
        finally:
            spark.stop()
