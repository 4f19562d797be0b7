"""The orchestration service — the port's copy of ``mlrun_tpu/service``:
the aiohttp API server (``app``, ``api/``), the server-side launcher and
the run monitor with its retries (``launcher``, ``runtime_handlers``),
the execution providers (``providers``), project secrets, cron schedules,
the chief/worker roles and projects sync, the fleet autoscaler
(``autoscaler``) and alert processing over the run db (``alerts``). The
image builder and the deployments are ROADMAP.md item 14, part 14c."""
