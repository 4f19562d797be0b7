"""The control-plane services the port stands on (copies of the parts of
``mlrun_tpu/service`` it needs): the JobSet surface of the Kubernetes
provider (``providers``), the fleet autoscaler (``autoscaler``) and alert
processing over the run db (``alerts``). The API server and the rest of
the service are ROADMAP.md item 14."""
