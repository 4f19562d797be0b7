"""Databricks runtime — the port's copy of
``mlrun_tpu/runtimes/databricks.py``: runs a wrapped script on a
Databricks cluster.

The databricks-sdk is imported inside ``_run``; the run-submit payload is
built client-side, so its shape is testable without the SDK.
"""

from __future__ import annotations

from ..model import RunObject
from .pod import KubeResource, KubeResourceSpec


class DatabricksSpec(KubeResourceSpec):
    _dict_fields = KubeResourceSpec._dict_fields + [
        "cluster_id", "new_cluster_spec", "timeout_minutes",
    ]

    def __init__(self, cluster_id=None, new_cluster_spec=None,
                 timeout_minutes=None, **kwargs):
        super().__init__(**kwargs)
        self.cluster_id = cluster_id
        self.new_cluster_spec = new_cluster_spec or {}
        self.timeout_minutes = timeout_minutes or 60


class DatabricksRuntime(KubeResource):
    kind = "databricks"
    # client-side driven like DaskRuntime: _run submits to the Databricks
    # workspace directly (no service-side resource handler involved)
    _is_remote = False
    _nested_fields = {**KubeResource._nested_fields, "spec": DatabricksSpec}

    def __init__(self, metadata=None, spec=None, status=None):
        super().__init__(metadata, spec, status)
        if not isinstance(self.spec, DatabricksSpec):
            self.spec = DatabricksSpec.from_dict(self.spec.to_dict())

    def generate_submit_payload(self, runobj: RunObject) -> dict:
        """The jobs/runs/submit payload: the embedded code ships base64
        inside the task parameters."""
        import json

        build = self.spec.build
        code = build.functionSourceCode if build else None
        task = {
            "task_key": f"{runobj.metadata.name}-{runobj.metadata.uid[:8]}",
            "spark_python_task": {
                "python_file": self.spec.command or "dbfs:/mlrun-tpu/run.py",
                "parameters": [
                    json.dumps({
                        "run_spec": runobj.to_dict(),
                        "handler": runobj.spec.handler_name,
                        "code_b64": code,
                    }, default=str)
                ],
            },
            "timeout_seconds": self.spec.timeout_minutes * 60,
        }
        if self.spec.cluster_id:
            task["existing_cluster_id"] = self.spec.cluster_id
        else:
            task["new_cluster"] = self.spec.new_cluster_spec or {
                "num_workers": 1, "spark_version": "14.3.x-scala2.12",
                "node_type_id": "i3.xlarge"}
        return {"run_name": runobj.metadata.name, "tasks": [task]}

    def _run(self, runobj: RunObject, execution) -> dict:
        try:
            from databricks.sdk import WorkspaceClient  # gated
            from databricks.sdk.service import jobs as dbx_jobs
        except ImportError as exc:
            raise ImportError(
                "the databricks runtime requires the databricks-sdk "
                "package") from exc
        client = WorkspaceClient()
        payload = self.generate_submit_payload(runobj)
        tasks = []
        for task in payload["tasks"]:
            spark_task = dbx_jobs.SparkPythonTask(
                python_file=task["spark_python_task"]["python_file"],
                parameters=task["spark_python_task"]["parameters"])
            tasks.append(dbx_jobs.SubmitTask(
                task_key=task["task_key"],
                spark_python_task=spark_task,
                existing_cluster_id=task.get("existing_cluster_id"),
                new_cluster=dbx_jobs.ClusterSpec.from_dict(
                    task["new_cluster"]) if "new_cluster" in task else None,
                timeout_seconds=task.get("timeout_seconds")))
        run = client.jobs.submit(run_name=payload["run_name"],
                                 tasks=tasks).result()
        execution.log_result("databricks_run_id", run.run_id)
        if run.run_page_url:
            execution.log_result("databricks_run_url", run.run_page_url)
        state = run.state
        result_state = getattr(state, "result_state", None)
        if result_state is not None and str(result_state) not in (
                "RunResultState.SUCCESS", "SUCCESS"):
            execution.set_state(
                error=f"databricks run ended with {result_state}: "
                      f"{getattr(state, 'state_message', '')}")
        else:
            execution.commit(completed=True)
        return execution.to_dict()
