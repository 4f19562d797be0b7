"""Server-side runtime handlers — the execution backend; the port's copy of
``mlrun_tpu/service/runtime_handlers.py``.

Reference analog: server/api/runtime_handlers/base.py:50 BaseRuntimeHandler
(run :57, monitor_runs :189, delete_resources :115, stuck-state thresholds
:518,:1368) and kubejob.py:45 / mpijob/v1.py:49. The MPIJob CRD path is
replaced by the GPU JobSet builder (``k8s/jobset.py``, torchrun in every
pod).

Providers decouple "what resource to create" from "where": the
``KubernetesProvider`` creates pods/JobSets via the k8s API (gated on the
kubernetes package); the ``LocalProcessProvider`` runs the resource's own
container command (``python3 -m mlrun_tpu_torch run --from-env``, under
torchrun for a ``tpujob``) as child processes, so the full
submit→pod→run→logs path works on a single machine.

The run monitor classifies each failed resource (``common/retry.py``) and
resubmits the retryable ones within the run's policy; a resubmitted
``tpujob`` JobSet carries the resume env from ``status.checkpoint``
(``TpuJobHandler._customize_retry_manifest``). A dask run's pod is a job
pod; a spark run's SparkApplication needs the kubernetes provider.
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
from datetime import datetime

from ..common.retry import (
    FailureClass,
    classify_failure,
    compute_backoff,
    resolve_retry_policy,
)
from ..common.runtimes_constants import (
    COMPILE_CACHE_ENV,
    RESUME_CHECKPOINT_ENV,
    RESUME_STEP_ENV,
    JobSetConditions,
    PodPhases,
    RunStates,
    RuntimeKinds,
)
from ..config import (
    CLI_COMMAND,
    EXEC_CODE_ENV,
    K8S_DEFAULTS,
    RUN_FROM_ENV_COMMAND,
    TRAINING_DEFAULTS,
    run_config,
    service_config,
)
from ..model import RunObject
from ..obs import (
    RUN_RETRIES,
    RUN_STALL_ABORTS,
    flight_record,
    get_flight_recorder,
    get_tracer,
    record_badput,
    trace_id_for,
)
from ..utils import get_in, logger, now_iso


from ..k8s.jobset import JOB_NAME
from .providers import (  # noqa: F401 - canonical home is
    # service/providers.py; re-exported for existing importers
    KubernetesProvider,
    LocalProcessProvider,
    Provider,
    _extract_pod_spec,
)


def _service_dbpath() -> str:
    """The run db a resource reports to: the configured ``dbpath``, else
    this service on its advertised port."""
    return (run_config("dbpath") or
            f"http://127.0.0.1:{service_config('httpdb.port')}")


def _epoch(iso: str | None) -> float | None:
    """ISO timestamp (utils.now_iso) → epoch seconds; None when absent or
    unparseable."""
    if not iso:
        return None
    try:
        return datetime.fromisoformat(str(iso)).timestamp()
    except ValueError:
        return None


def _rewrite_exec_config(node, value: str):
    """Replace every baked exec-config env value (any container, any
    manifest shape — Pod, JobSet, Deployment) with ``value``."""
    if isinstance(node, dict):
        for key, child in node.items():
            if key == "containers" and isinstance(child, list):
                for container in child:
                    for env in container.get("env", []) or []:
                        if env.get("name") == run_config(
                                "exec_config_env"):
                            env["value"] = value
            else:
                _rewrite_exec_config(child, value)
    elif isinstance(node, list):
        for item in node:
            _rewrite_exec_config(item, value)


def _wrap_with_bootstrap(runtime, command: list[str]) -> list[str]:
    """Functions that declare build.requirements run under the cached
    requirements venv: the pod command becomes `python3 -m mlrun_tpu_torch
    bootstrap -r ... -- <command>` (the zero-registry half of the
    reference's Kaniko image build, utils/bootstrap.py)."""
    build = getattr(runtime.spec, "build", None)
    requirements = list(getattr(build, "requirements", []) or [])
    if not requirements:
        return command
    wrapped = list(CLI_COMMAND) + ["bootstrap"]
    for req in requirements:
        wrapped += ["-r", req]
    return wrapped + ["--"] + command


class BaseRuntimeHandler:
    kind = "base"

    def __init__(self, db, provider: Provider):
        self.db = db
        self.provider = provider
        # run key -> (resource_id, project, started_walltime); mirrored in
        # the DB's runtime_resources table so a service restart can rebuild
        # it (reference recovers via cluster label listing, base.py:65).
        # The key is the run uid for iteration 0 and "uid#iter" for hyper
        # children — they share the parent's uid, and keying by bare uid
        # would make child resources overwrite each other AND make the
        # monitor write child terminal states onto the PARENT run doc
        self._resources: dict[str, tuple[str, str, float]] = {}
        # run uid -> pristine resource manifest as built by build_resource,
        # kept so a retryable failure can be resubmitted without the
        # runtime object; a restarted service falls back to rebuilding the
        # runtime from the stored function (``_build_retry_manifest``)
        self._manifests: dict[str, dict] = {}
        # run uid -> wall-clock before which a scheduled retry must wait
        self._retry_at: dict[str, float] = {}
        # run uid -> consecutive state-probe failures; a single apiserver
        # blip must not be mistaken for a dead resource
        self._probe_failures: dict[str, int] = {}
        self._lock = threading.RLock()

    @staticmethod
    def _run_key(uid: str, iteration: int) -> str:
        return f"{uid}#{iteration}" if iteration else uid

    @staticmethod
    def _split_key(key: str) -> tuple[str, int]:
        uid, _, iteration = key.partition("#")
        return uid, int(iteration or 0)

    # -- resource building --------------------------------------------------
    def build_resource(self, runtime, run: RunObject) -> dict:
        raise NotImplementedError

    def run(self, runtime, run: RunObject, execution=None) -> dict:
        resource = self.build_resource(runtime, run)
        self._apply_secret_projection(resource, run.metadata.project)
        iteration = run.metadata.iteration or 0
        key = self._run_key(run.metadata.uid, iteration)
        with self._lock:
            self._manifests[key] = copy.deepcopy(resource)
        try:
            resource_id = self.provider.create(resource, run.metadata.uid)
        except Exception:
            # a failed create never registers the key in _resources, so
            # _forget would never fire for it — drop the cached manifest
            # here or repeatedly failing submissions accumulate deep
            # copies forever (ROADMAP open item)
            with self._lock:
                self._manifests.pop(key, None)
            raise
        started = time.time()
        with self._lock:
            self._resources[key] = (
                resource_id, run.metadata.project, started)
        self._persist(key, run.metadata.project, resource_id, started)
        self.db.update_run(
            {"status.state": RunStates.running,
             "status.start_time": now_iso()},
            run.metadata.uid, run.metadata.project, iter=iteration)
        logger.info("runtime resource created", kind=self.kind,
                    resource=resource_id, uid=run.metadata.uid,
                    iteration=iteration)
        return {"resource_id": resource_id}

    # -- durable state ------------------------------------------------------
    def _persist(self, uid: str, project: str, resource_id: str,
                 started: float):
        store = getattr(self.db, "store_runtime_resource", None)
        if store:
            try:
                store(uid, project, self.kind, resource_id, started)
            except Exception as exc:  # noqa: BLE001 - tracking best-effort
                logger.warning("runtime resource persist failed",
                               error=str(exc))

    def _forget(self, uid: str, project: str):
        with self._lock:
            self._resources.pop(uid, None)
            self._manifests.pop(uid, None)
            self._retry_at.pop(uid, None)
            self._probe_failures.pop(uid, None)
        # series lifecycle: a finished run's per-run goodput label sets
        # are queued for retirement (kept scrapeable for the most recent
        # N finished runs so the terminal attribution survives until the
        # federation loop reads it) — only once no sibling iteration is
        # still tracked, since hyper children share the parent uid
        bare_uid = self._split_key(uid)[0]
        with self._lock:
            siblings = any(self._split_key(key)[0] == bare_uid
                           for key in self._resources)
        if not siblings:
            from ..obs.goodput import release_run

            release_run(bare_uid)
        drop = getattr(self.db, "del_runtime_resource", None)
        if drop:
            try:
                drop(uid, project)
            except Exception as exc:  # noqa: BLE001
                logger.warning("runtime resource forget failed",
                               error=str(exc))

    def recover_resources(self):
        """Rebuild the resource map after a service restart: DB rows first,
        then provider label discovery for resources the DB missed."""
        lister = getattr(self.db, "list_runtime_resources", None)
        recovered = 0
        if lister:
            for row in lister(kind=self.kind):
                with self._lock:
                    if row["uid"] not in self._resources:
                        self._resources[row["uid"]] = (
                            row["resource_id"], row["project"],
                            float(row["started"] or time.time()))
                        recovered += 1
        discover = getattr(self.provider, "list_resources", None)
        if discover:
            try:
                for resource_id, uid, project in discover(self.kind):
                    with self._lock:
                        if uid not in self._resources:
                            self._resources[uid] = (
                                resource_id, project, time.time())
                            recovered += 1
                            self._persist(uid, project, resource_id,
                                          time.time())
            except Exception as exc:  # noqa: BLE001 - discovery best-effort
                logger.warning("provider resource discovery failed",
                               kind=self.kind, error=str(exc))
        if recovered:
            logger.info("recovered runtime resources", kind=self.kind,
                        count=recovered)

    # -- monitoring (reference base.py:189 monitor_runs) ---------------------
    def monitor_runs(self):
        with self._lock:
            snapshot = list(self._resources.items())
        for key, (resource_id, project, started) in snapshot:
            try:
                self._monitor_one(key, resource_id, project, started)
            except Exception as exc:  # noqa: BLE001 - one bad resource must
                # not wedge monitoring for every other run of this kind
                logger.warning("monitoring resource failed", uid=key,
                               resource=resource_id, error=str(exc))

    def _monitor_one(self, key: str, resource_id: str, project: str,
                     started: float):
        uid, iteration = self._split_key(key)
        probe_error = None
        try:
            phase = self.provider.state(resource_id)
            with self._lock:
                self._probe_failures.pop(key, None)
        except Exception as exc:  # noqa: BLE001 - e.g. k8s 404 after the
            # resource was GC'd while the service was down
            # 404 is definitive (the resource is gone); anything else may
            # be an apiserver blip — require consecutive failures before
            # declaring the resource dead, or a transient 5xx would
            # trigger a resubmission against a still-running resource
            definitive = getattr(exc, "status", None) == 404 \
                or "404" in str(exc)
            if not definitive:
                with self._lock:
                    failures = self._probe_failures.get(key, 0) + 1
                    self._probe_failures[key] = failures
                if failures < 2:
                    logger.warning("resource state probe failed — "
                                   "waiting for the next tick",
                                   uid=uid, resource=resource_id,
                                   error=str(exc))
                    return
            logger.warning("resource state probe failed — treating as gone",
                           uid=uid, resource=resource_id, error=str(exc))
            probe_error = str(exc)
            phase = PodPhases.failed
        run_state = PodPhases.to_run_state(phase)
        run = self.db.read_run(uid, project, iter=iteration)
        if run is None:
            self._delete_quietly(resource_id)
            self._forget(key, project)
            return
        current = get_in(run, "status.state")
        if current in (RunStates.aborting,):
            self._delete_quietly(resource_id)
            self.db.update_run({"status.state": RunStates.aborted},
                               uid, project, iter=iteration)
            self._forget(key, project)
            return
        failure_class = None
        if run_state == RunStates.error:
            # the fault-tolerance core (reference base.py has no retry at
            # all — SURVEY §5.3): classify, then resubmit retryable infra
            # failures within policy instead of failing the run
            failure_class = classify_failure(
                probe_error=probe_error,
                run_error=get_in(run, "status.error"),
                run_reported_terminal=current in RunStates.terminal_states())
            if self._maybe_retry(key, resource_id, project, run,
                                 failure_class):
                return
        if run_state in RunStates.terminal_states():
            updates = {"status.last_update": now_iso()}
            # the in-run process writes richer state; only force error
            # when the resource failed but the run never reported it
            if run_state == RunStates.error and current not in \
                    RunStates.terminal_states():
                updates["status.state"] = RunStates.error
                updates["status.error"] = (
                    get_in(run, "status.error")
                    or "execution resource failed")
            elif current not in RunStates.terminal_states():
                updates["status.state"] = run_state
            # record the class only on runs that actually FAILED — a
            # completed run whose finished resource was GC'd before this
            # tick must not be labeled a user-code failure
            final_state = updates.get("status.state", current)
            if failure_class and final_state in RunStates.error_states() \
                    and not get_in(run, "status.failure_class"):
                updates["status.failure_class"] = failure_class
            self.db.update_run(updates, uid, project, iter=iteration)
            self._forget(key, project)
            self._push_notifications(uid, project, run)
            return
        if run_state == RunStates.running:
            # the resource is healthy again: a retry scheduled off a
            # transient blip must not linger and fire with zero backoff
            # at the NEXT genuine failure
            with self._lock:
                self._retry_at.pop(key, None)
            if current == RunStates.pending and get_in(
                    run, "status.failure_class"):
                # undo the blip's pending-for-retry parking
                self.db.update_run({"status.state": RunStates.running},
                                   uid, project, iter=iteration)
            # elastic multi-slice path: ONE slice gone while the job
            # stays alive is not a failure — submit only a replacement
            # slice; the in-run trainer reshards onto the survivors
            if self._check_slices(key, resource_id, project, run):
                return
            # heartbeat watchdog: a resource that still reports running
            # but whose run went silent is stalled (hung collective,
            # wedged host)
            if self._check_stalled(key, resource_id, project, run, started):
                return
        # stuck-state thresholds (reference base.py:518)
        threshold = self._state_threshold(run, run_state)
        if threshold > 0 and time.time() - started > threshold:
            logger.warning("aborting stuck run", uid=uid,
                           state=run_state, threshold=threshold)
            flight_record("run.stuck_abort", uid=uid, state=run_state,
                          threshold_s=threshold)
            self._delete_quietly(resource_id)
            self.db.update_run(
                {"status.state": RunStates.aborted,
                 "status.status_text":
                 f"stuck in state {run_state} over {threshold}s"},
                uid, project, iter=iteration)
            self._forget(key, project)

    # -- retry / resubmission (the fault-tolerance subsystem) ----------------
    def _maybe_retry(self, key: str, resource_id: str, project: str,
                     run: dict, failure_class: str) -> bool:
        """Decide whether a failed resource is resubmitted. True → the
        failure was fully handled here (scheduled or resubmitted); False →
        fall through to the terminal-state path."""
        uid, iteration = self._split_key(key)
        policy = resolve_retry_policy(get_in(run, "spec.retry_policy"))
        retry_count = int(get_in(run, "status.retry_count", 0) or 0)
        if failure_class not in policy.retry_on or \
                not policy.retries_left(retry_count):
            return False
        with self._lock:
            retry_at = self._retry_at.get(key)
        if retry_at is None:
            delay = compute_backoff(retry_count, policy, seed=key)
            if delay > 0:
                with self._lock:
                    self._retry_at[key] = time.time() + delay
                self.db.update_run(
                    {"status.state": RunStates.pending,
                     "status.failure_class": failure_class,
                     "status.status_text":
                     f"{failure_class}: retry "
                     f"{retry_count + 1}/{policy.max_retries} "
                     f"in {delay:.1f}s"},
                    uid, project, iter=iteration)
                # goodput accounting: the scheduled backoff is wall time
                # this run spends NOT training — preemption downtime or a
                # generic resubmit gap, attributed out-of-band because
                # the run process is dead for its duration
                record_badput(
                    "preemption_downtime"
                    if failure_class == FailureClass.preemption
                    else "resubmit_gap", delay, run=uid)
                flight_record("run.retry_scheduled", uid=uid,
                              failure_class=failure_class,
                              delay_s=round(delay, 3),
                              attempt=retry_count + 1)
                logger.info("scheduled run retry", uid=uid,
                            failure_class=failure_class, delay=delay,
                            attempt=retry_count + 1)
                return True
        elif time.time() < retry_at:
            return True
        with self._lock:
            self._retry_at.pop(key, None)
        return self._resubmit(key, resource_id, project, run,
                              retry_count + 1, failure_class)

    def _resubmit(self, key: str, old_resource_id: str, project: str,
                  run: dict, attempt: int, failure_class: str) -> bool:
        uid, iteration = self._split_key(key)
        self._delete_quietly(old_resource_id)
        try:
            manifest = self._build_retry_manifest(key, project, run, attempt,
                                                  failure_class)
        except Exception as exc:  # noqa: BLE001 - unresolvable function etc.
            logger.warning("cannot rebuild resource for retry", uid=uid,
                           error=str(exc))
            manifest = None
        if manifest is None:
            self.db.update_run(
                {"status.state": RunStates.error,
                 "status.failure_class": failure_class,
                 "status.error": get_in(run, "status.error")
                 or f"execution resource failed ({failure_class}); "
                 "resource could not be rebuilt for retry"},
                uid, project, iter=iteration)
            self._forget(key, project)
            self._push_notifications(uid, project, run)
            return True
        try:
            new_id = self.provider.create(manifest, uid)
        except Exception as exc:  # noqa: BLE001 - cluster rejected the retry
            logger.warning("resubmission failed", uid=uid, error=str(exc))
            self.db.update_run(
                {"status.state": RunStates.error,
                 "status.failure_class": failure_class,
                 "status.error": f"resubmission failed: {exc}"},
                uid, project, iter=iteration)
            self._forget(key, project)
            self._push_notifications(uid, project, run)
            return True
        started = time.time()
        with self._lock:
            self._resources[key] = (new_id, project, started)
        self._persist(key, project, new_id, started)
        self.db.update_run(
            {"status.state": RunStates.running,
             "status.retry_count": attempt,
             "status.failure_class": failure_class,
             "status.status_text":
             f"resubmitted after {failure_class} (attempt {attempt})"},
            uid, project, iter=iteration)
        RUN_RETRIES.inc(failure_class=failure_class)
        # joins the run.submit span on the uid-derived lifecycle trace
        get_tracer().emit(
            "run.retry", trace_id_for(uid),
            attrs={"uid": uid, "failure_class": failure_class,
                   "attempt": attempt, "resource": new_id})
        flight_record("run.resubmit", uid=uid,
                      failure_class=failure_class, attempt=attempt,
                      resource=new_id)
        logger.info("resubmitted run", uid=uid, resource=new_id,
                    failure_class=failure_class, attempt=attempt,
                    trace_id=trace_id_for(uid))
        return True

    def _build_retry_manifest(self, key: str, project: str, run: dict,
                              attempt: int,
                              failure_class: str = "") -> dict | None:
        """Fresh manifest for a retry: the pristine manifest cached at
        submission (or rebuilt from the stored function after a service
        restart), renamed per attempt so an async-deleting cluster can't
        409 the replacement, then handler-customized (resume env)."""
        with self._lock:
            manifest = self._manifests.get(key)
        if manifest is None:
            manifest = self._rebuild_from_function(
                self._split_key(key)[0], project, run)
            if manifest is None:
                return None
            with self._lock:
                self._manifests[key] = copy.deepcopy(manifest)
        manifest = copy.deepcopy(manifest)
        name = manifest.get("metadata", {}).get("name")
        if name:
            manifest["metadata"]["name"] = f"{name}-r{attempt}"
        # the baked exec config predates the failure — refresh it so the
        # retried process knows its retry status (and latest checkpoint)
        # and its full-doc store_run doesn't erase them
        run_doc = copy.deepcopy(run)
        run_doc.setdefault("status", {})["retry_count"] = attempt
        if failure_class:
            run_doc["status"]["failure_class"] = failure_class
        _rewrite_exec_config(manifest, json.dumps(run_doc, default=str))
        self._customize_retry_manifest(manifest, run, attempt)
        return manifest

    def _rebuild_from_function(self, uid: str, project: str,
                               run: dict) -> dict | None:
        """Post-restart fallback: rebuild the runtime from the function
        stored in the DB (spec.function 'project/name:tag') and run
        build_resource again."""
        getter = getattr(self.db, "get_function", None)
        uri = get_in(run, "spec.function", "") or ""
        if not getter or "/" not in uri:
            return None
        func_project, _, rest = uri.partition("/")
        name, _, tag = rest.partition(":")
        tag, _, _hash = tag.partition("@")
        struct = getter(name, func_project or project, tag=tag or "latest")
        if not struct:
            return None
        from .launcher import rebuild_function

        runtime = rebuild_function(struct)
        resource = self.build_resource(runtime, RunObject.from_dict(run))
        self._apply_secret_projection(resource, project)
        return resource

    def _customize_retry_manifest(self, manifest: dict, run: dict,
                                  attempt: int):
        """Handler hook: adjust the renamed manifest before resubmission
        (TpuJobHandler wires checkpoint-resume env here)."""

    def _check_slices(self, key: str, resource_id: str, project: str,
                      run: dict) -> bool:
        """Handler hook: per-slice health of a still-running resource.
        True → a slice-level event was handled this tick (the monitor
        skips the stall check — a just-degraded run is mid-reshard, not
        stalled). Base handlers have no slice structure."""
        return False

    # -- stall watchdog ------------------------------------------------------
    def _check_stalled(self, key: str, resource_id: str, project: str,
                       run: dict, started: float) -> bool:
        """Escalate runs whose heartbeat went silent past the policy
        threshold: abort, or resubmit within the retry budget."""
        uid, iteration = self._split_key(key)
        policy = resolve_retry_policy(get_in(run, "spec.retry_policy"))
        if policy.stall_timeout is None or policy.stall_timeout <= 0:
            return False
        # floor at the CURRENT resource's start: a just-resubmitted
        # replacement hasn't heartbeat yet, and judging it by the previous
        # attempt's stale heartbeat would burn the retry budget one
        # monitor tick at a time
        heartbeat = max(_epoch(get_in(run, "status.last_heartbeat")) or 0.0,
                        started)
        silent = time.time() - heartbeat
        if silent <= policy.stall_timeout:
            return False
        retry_count = int(get_in(run, "status.retry_count", 0) or 0)
        logger.warning("run stalled — no heartbeat", uid=uid,
                       silent_seconds=round(silent, 1),
                       threshold=policy.stall_timeout,
                       escalation=policy.on_stall)
        # flight + goodput: the silent window is badput, and the
        # detection event opens the post-mortem sequence the artifact
        # below must carry (stall detection -> retry decision)
        flight_record("run.stall_detected", uid=uid,
                      silent_s=round(silent, 1),
                      threshold_s=policy.stall_timeout,
                      escalation=policy.on_stall)
        record_badput("stall", silent, run=uid)
        # on_stall is the explicit directive — it is NOT gated on
        # retry_on (a run retrying only preemptions but asking for stall
        # resubmission means exactly that); only the budget limits it
        if policy.on_stall == "resubmit" and \
                policy.retries_left(retry_count):
            handled = self._resubmit(key, resource_id, project, run,
                                     retry_count + 1, FailureClass.stalled)
            get_flight_recorder().dump("stall-resubmit",
                                       extra={"run": uid})
            return handled
        self._delete_quietly(resource_id)
        self.db.update_run(
            {"status.state": RunStates.aborted,
             "status.failure_class": FailureClass.stalled,
             "status.status_text":
             f"stalled: no heartbeat for {silent:.0f}s "
             f"(threshold {policy.stall_timeout:.0f}s)"},
            uid, project, iter=iteration)
        RUN_STALL_ABORTS.inc()
        get_tracer().emit(
            "run.stall_abort", trace_id_for(uid),
            attrs={"uid": uid, "silent_s": round(silent, 1),
                   "threshold_s": policy.stall_timeout})
        flight_record("run.stall_abort", uid=uid,
                      silent_s=round(silent, 1))
        # the black-box artifact a stall-aborted run leaves behind: the
        # event sequence into the abort (detection, prior retries, chaos
        # fires) — ISSUE 10 acceptance
        get_flight_recorder().dump("stall-abort", extra={"run": uid})
        self._forget(key, project)
        self._push_notifications(uid, project, run)
        return True

    def _push_notifications(self, uid: str, project: str, run: dict):
        """Server-side push when the monitor retires a terminal resource —
        the only place masked (secret-backed) notification params can be
        resolved (reference RunNotificationPusher). ``run`` is the dict the
        monitor already read; statuses are re-read so an in-run push that
        landed after the monitor's read is not repeated."""
        if not get_in(run, "spec.notifications"):
            return
        run = self.db.read_run(uid, project) or run
        specs = run.get("spec", {}).get("notifications") or []
        # the in-run process already pushed what it could (unmasked specs);
        # the server covers masked ones and anything not yet sent
        pending = [s for s in specs if isinstance(s, dict)
                   and s.get("status") != "sent"]
        if not pending:
            return
        from ..utils.notifications import NotificationPusher
        from .secrets import NOTIFICATION_SECRET_PREFIX, \
            resolve_notification_params

        run = dict(run)
        run["spec"] = dict(run["spec"])
        run["spec"]["notifications"] = pending
        try:
            NotificationPusher(
                [run],
                secret_resolver=lambda proj, params:
                resolve_notification_params(self.db, proj, params)).push()
            # pending entries are the same dict objects as in specs, so
            # their pushed statuses are visible in the full list
            self.db.update_run({"spec.notifications": specs}, uid, project)
        except Exception as exc:  # noqa: BLE001 - notification is best-effort
            logger.warning("server-side notification push failed", uid=uid,
                           error=str(exc))
        # per-run notification secrets are single-use — drop them so the
        # store (and any projected k8s Secret) does not grow unboundedly
        drop = getattr(self.db, "delete_project_secrets", None)
        if drop:
            used = [s.get("params", {}).get("secret") for s in specs
                    if isinstance(s, dict)
                    and (s.get("params") or {}).get("secret", "").startswith(
                        NOTIFICATION_SECRET_PREFIX)]
            if used:
                try:
                    drop(project, keys=[k for k in used if k])
                except Exception as exc:  # noqa: BLE001
                    logger.warning("notification secret cleanup failed",
                                   error=str(exc))

    def _delete_quietly(self, resource_id: str):
        try:
            self.provider.delete(resource_id)
        except Exception as exc:  # noqa: BLE001 - already-gone is fine
            logger.warning("resource delete failed", resource=resource_id,
                           error=str(exc))

    @staticmethod
    def _state_threshold(run: dict, state: str) -> float:
        thresholds = dict(service_config("runs.state_thresholds"))
        thresholds.update(get_in(run, "spec.state_thresholds", {}) or {})
        if state == RunStates.pending:
            return float(thresholds.get("pending_scheduled", 3600))
        if state == RunStates.running:
            return float(thresholds.get("executing", -1))
        return -1

    def _secret_env(self, project: str) -> dict:
        """Project secrets as MLT_SECRET_* env for the resource. With a
        kubernetes provider the values ride a k8s Secret + envFrom instead
        (``_apply_secret_projection``) so they never appear in the pod
        manifest; the local provider carries them as plain subprocess env."""
        if hasattr(self.provider, "ensure_project_secret"):
            return {}
        from .secrets import project_secret_env

        return project_secret_env(self.db, project)

    def _apply_secret_projection(self, resource: dict, project: str):
        """Project the project-secret store into the pod spec via a k8s
        Secret object + envFrom secretRef (reference pod.py secret mounts)."""
        ensure = getattr(self.provider, "ensure_project_secret", None)
        if ensure is None:
            return
        from .secrets import project_secret_env

        secrets = project_secret_env(self.db, project)
        if not secrets:
            return
        secret_name = ensure(project, secrets)
        ref = {"secretRef": {"name": secret_name}}
        if resource.get("kind") == "SparkApplication":
            # spark-operator takes envFrom on the driver/executor specs,
            # not a containers list — without this branch spark runs got
            # NO project secrets at all
            for role in ("driver", "executor"):
                section = resource["spec"].setdefault(role, {})
                section.setdefault("envFrom", []).append(dict(ref))
            return
        pod_spec = _extract_pod_spec(resource)
        for container in pod_spec.get("containers", []):
            container.setdefault("envFrom", []).append(dict(ref))

    def delete_resources(self, uid: str, project: str = "",
                         resource_id: str = ""):
        """Delete a run's cluster resource + both tracking layers (the
        in-memory map and the DB row). ``project``/``resource_id`` serve as
        a fallback for rows that were never adopted in-memory (e.g. listed
        straight from the DB after a restart)."""
        with self._lock:
            entry = self._resources.get(uid)
        if entry:
            self.provider.delete(entry[0])
            self._forget(uid, entry[1])
        elif resource_id:
            self.provider.delete(resource_id)
            self._forget(uid, project)

    def abort_run(self, uid: str, project: str):
        self.db.update_run({"status.state": RunStates.aborting}, uid, project)
        with self._lock:
            entry = self._resources.get(uid)
        if entry:
            self.provider.delete(entry[0])
            self._forget(uid, project)
        self.db.update_run({"status.state": RunStates.aborted}, uid, project)


class KubeJobHandler(BaseRuntimeHandler):
    """Single-pod batch job (reference kubejob.py:45)."""

    kind = RuntimeKinds.job

    def build_resource(self, runtime, run: RunObject) -> dict:
        env = {
            run_config("exec_config_env"): json.dumps(run.to_dict(),
                                                      default=str),
            "MLT_DBPATH": _service_dbpath(),
        }
        env.update(self._secret_env(run.metadata.project))
        build = runtime.spec.build
        if build and build.functionSourceCode:
            env[EXEC_CODE_ENV] = build.functionSourceCode
        command = list(RUN_FROM_ENV_COMMAND)
        handler = run.spec.handler_name
        if handler:
            command += ["--handler", handler]
        command = _wrap_with_bootstrap(runtime, command)
        pod_spec = runtime.to_pod_spec(command=command, extra_env=env)
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": f"{run.metadata.name}-{run.metadata.uid[:8]}",
                "namespace": K8S_DEFAULTS["namespace"],
                "labels": {
                    "mlrun-tpu/project": run.metadata.project,
                    "mlrun-tpu/uid": run.metadata.uid,
                    "mlrun-tpu/class": self.kind,
                },
            },
            "spec": pod_spec,
        }


class TpuJobHandler(BaseRuntimeHandler):
    """GPU JobSet of torchrun pods (replaces MpiV1RuntimeHandler,
    mpijob/v1.py:49)."""

    kind = RuntimeKinds.tpujob

    def build_resource(self, runtime, run: RunObject) -> dict:
        env = {"MLT_DBPATH": _service_dbpath()}
        cache_dir = self._compile_cache_dir()
        if cache_dir:
            # persistent kernel-build cache (utils/compile_cache.py): the
            # first attempt populates it, a preemption-resume restarts warm
            env[COMPILE_CACHE_ENV] = cache_dir
        env.update(self._secret_env(run.metadata.project))
        build = runtime.spec.build
        if build and build.functionSourceCode:
            env[EXEC_CODE_ENV] = build.functionSourceCode
        command = list(RUN_FROM_ENV_COMMAND)
        handler = run.spec.handler_name
        if handler:
            command += ["--handler", handler]
        command = _wrap_with_bootstrap(runtime, command)
        return runtime.generate_jobset(run, extra_env=env, command=command)

    @staticmethod
    def _compile_cache_dir() -> str:
        return str(os.environ.get(COMPILE_CACHE_ENV)
                   or TRAINING_DEFAULTS.get("compile_cache_dir", "") or "")

    def _check_slices(self, key: str, resource_id: str, project: str,
                      run: dict) -> bool:
        """Elastic multi-slice handling (docs/fault_tolerance.md
        "Elastic training"): a failed slice of a LIVE JobSet gets only a
        replacement slice Job — the survivors keep training at reduced
        world size (the in-run trainer reshards; ``ElasticGuard``) —
        instead of the whole run being resubmitted. Re-entry is warm:
        the replacement's template is refreshed with the latest
        ``status.checkpoint`` resume env and the persistent compile
        cache before the child Job is recreated. Budgeted like retries
        (``status.slice_replacements`` against ``max_retries``), gated
        on ``slice_preempted`` being a retried class."""
        slice_status = getattr(self.provider, "slice_status", None)
        if slice_status is None:
            return False
        try:
            status = slice_status(resource_id) or {}
        except Exception:  # noqa: BLE001 - a probe blip never escalates
            return False   # here; the state probe owns liveness
        if not status.get("elastic"):
            # elasticity is an OPT-IN (with_elastic(), the
            # mlrun-tpu/elastic annotation): a non-elastic run's failed
            # slice means its survivors are wedged in dead DCN
            # collectives with no reshard machinery — the job-level
            # failure/full-resubmit path is the right medicine there
            return False
        failed = sorted(int(s) for s in status.get("failed_slices") or [])
        uid, iteration = self._split_key(key)
        degraded = [int(s) for s in
                    get_in(run, "status.degraded_slices", []) or []]
        if not failed:
            if degraded:
                # the replacement came up: the run is whole again —
                # grow-back is the trainer's job, this is bookkeeping
                self.db.update_run(
                    {"status.degraded_slices": [],
                     "status.status_text":
                     "replacement slice joined — full world size "
                     "restored"},
                    uid, project, iter=iteration)
                flight_record("run.slice_rejoined", uid=uid,
                              slices=degraded)
                logger.info("slice replacement joined", uid=uid,
                            slices=degraded)
            return False
        replicas = int(status.get("replicas") or 0)
        if replicas and len(failed) >= replicas:
            # EVERY slice is gone: that is a dead job, not a degraded
            # one — fall through to the state probe / full-resubmit path
            return False
        policy = resolve_retry_policy(get_in(run, "spec.retry_policy"))
        replaced = int(get_in(run, "status.slice_replacements", 0) or 0)
        fresh = [s for s in failed if s not in degraded]
        if FailureClass.slice_preempted not in policy.retry_on:
            return False
        if not fresh:
            # replacements pending — survivors keep running, and the
            # stall watchdog must KEEP watching them (a wedged survivor
            # set during a capacity shortage still needs the escalation
            # path), so this is deliberately not "handled"
            return False
        if not policy.retries_left(replaced):
            logger.warning("slice replacement budget exhausted", uid=uid,
                           slices=fresh, budget=policy.max_retries)
            return False
        checkpoint = get_in(run, "status.checkpoint", {}) or {}
        resume_env = {}
        if checkpoint.get("path"):
            resume_env[RESUME_CHECKPOINT_ENV] = str(checkpoint["path"])
            if checkpoint.get("step") is not None:
                resume_env[RESUME_STEP_ENV] = str(checkpoint["step"])
        cache_dir = self._compile_cache_dir()
        if cache_dir:
            resume_env[COMPILE_CACHE_ENV] = cache_dir
        flight_record("run.slice_preempted", uid=uid, slices=fresh,
                      survivors=(replicas - len(failed)) if replicas
                      else None)
        submitted = []
        for slice_index in fresh:
            if not policy.retries_left(replaced):
                # re-checked per slice: several slices failing in one
                # tick must not overrun the budget together
                logger.warning("slice replacement budget exhausted",
                               uid=uid, slice=slice_index,
                               budget=policy.max_retries)
                break
            try:
                child = self.provider.replace_slice(
                    resource_id, slice_index, extra_env=resume_env)
            except Exception as exc:  # noqa: BLE001 - a failed slice
                # replacement degrades to the full-resubmit safety net
                # on a later tick (the slice stays listed as failed)
                logger.warning("slice replacement failed", uid=uid,
                               slice=slice_index, error=str(exc))
                continue
            submitted.append(slice_index)
            replaced += 1
            RUN_RETRIES.inc(failure_class=FailureClass.slice_preempted)
            flight_record("run.slice_replacement", uid=uid,
                          slice=slice_index, resource=child,
                          attempt=replaced)
        if not submitted:
            return False
        self.db.update_run(
            {"status.degraded_slices": sorted(set(degraded)
                                              | set(submitted)),
             "status.slice_replacements": replaced,
             "status.status_text":
             f"slice(s) {submitted} preempted — replacement submitted, "
             "survivors continue resharded"},
            uid, project, iter=iteration)
        get_tracer().emit(
            "run.slice_replacement", trace_id_for(uid),
            attrs={"uid": uid, "slices": submitted,
                   "resource": resource_id})
        logger.info("submitted slice replacement", uid=uid,
                    slices=submitted, resource=resource_id)
        return True

    def _customize_retry_manifest(self, manifest: dict, run: dict,
                                  attempt: int):
        """Rescheduled JobSets resume instead of restarting: fix the
        JobSet's name-derived wiring (headless-service subdomain,
        torchrun's rendezvous at pod 0 of the first Job) for the renamed
        manifest, inject the latest checkpoint path + step recorded on
        ``status.checkpoint`` so training/train.py restores before the
        first step, and thread the persistent compile-cache dir so the
        replacement skips the kernel build (warm restart)."""
        new_name = manifest.get("metadata", {}).get("name", "")
        checkpoint = get_in(run, "status.checkpoint", {}) or {}
        resume_env = []
        if checkpoint.get("path"):
            resume_env.append({"name": RESUME_CHECKPOINT_ENV,
                               "value": str(checkpoint["path"])})
            if checkpoint.get("step") is not None:
                resume_env.append({"name": RESUME_STEP_ENV,
                                   "value": str(checkpoint["step"])})
        cache_dir = self._compile_cache_dir()
        if cache_dir:
            resume_env.append({"name": COMPILE_CACHE_ENV,
                               "value": cache_dir})
        for job in get_in(manifest, "spec.replicatedJobs", []) or []:
            pod_spec = get_in(job, "template.spec.template.spec", {}) or {}
            if pod_spec.get("subdomain") and new_name:
                pod_spec["subdomain"] = new_name
            for container in pod_spec.get("containers", []):
                env = container.setdefault("env", [])
                for item in env:
                    if item.get("name") == "MASTER_ADDR" and new_name:
                        item["value"] = f"{new_name}-{JOB_NAME}-0-0.{new_name}"
                # upsert: the pristine manifest may already carry the
                # cache env (build_resource) — overwrite in place rather
                # than appending a duplicate name
                for item in resume_env:
                    for existing in env:
                        if existing.get("name") == item["name"]:
                            existing["value"] = item["value"]
                            break
                    else:
                        env.append(copy.deepcopy(item))


class DaskHandler(KubeJobHandler):
    kind = RuntimeKinds.dask


class SparkHandler(BaseRuntimeHandler):
    """SparkApplication CRD. Requires the kubernetes provider — a local
    process cannot materialize a spark cluster."""

    kind = RuntimeKinds.spark

    def build_resource(self, runtime, run: RunObject) -> dict:
        if isinstance(self.provider, LocalProcessProvider):
            raise ValueError(
                "the spark runtime needs a kubernetes provider with the "
                "spark-operator installed; run with local=True for a local "
                "SparkSession instead")
        return runtime.generate_spark_application(run)


def get_runtime_handler(kind: str, db, provider: Provider
                        ) -> BaseRuntimeHandler:
    cls = {
        RuntimeKinds.job: KubeJobHandler,
        RuntimeKinds.tpujob: TpuJobHandler,
        RuntimeKinds.dask: DaskHandler,
        RuntimeKinds.spark: SparkHandler,
    }.get(kind)
    if cls is None:
        raise ValueError(f"no runtime handler for kind '{kind}'")
    return cls(db, provider)
