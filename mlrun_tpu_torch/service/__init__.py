"""The control-plane services the port's serving fleet stands on (copies
of the parts of ``mlrun_tpu/service`` it needs): the JobSet surface of the
Kubernetes provider (``providers``) and the fleet autoscaler
(``autoscaler``). The API server, the run db and the rest of the service
wait for their port queue items (ROADMAP.md)."""
