"""Serving pod fleet: autoscaler-driven JobSet elasticity with a live
ring join, graceful drain and pre-warmed replica bring-up — the port's own
copy of ``mlrun_tpu/serving/podfleet.py`` (same state machine, events,
flight records, journal records and reconcile actions).

The :class:`~.fleet.EngineFleet` scales in-process replicas. This module
is the cross-process layer above it: one serving replica is one
single-slice JobSet (``k8s/jobset.build_serving_jobset``: ``nodes`` pods
of ``gpus_per_node`` GPUs on a ``gpu_product`` node) whose pod hosts one
engine behind a :class:`PodReplicaClient` — the duck-typed ``submit`` /
``submit_prefill`` / ``submit_prefilled`` surface the fleet already routes
over, so the ring, the 503-class re-dispatch and the KV-handoff wire
format all apply unchanged across the process boundary.

The pod lifecycle is a deterministic state machine advanced one
transition per :meth:`ServingPodFleet.tick` (the autoscaler's clock — no
background threads, so chaos drills replay exactly):

    pending --(pod Running)--> warming --(pre-warm pass)--> ready
      ready --(/readyz probe + ring join)--> joined
     joined --(scale-down drain)--> draining --(drained)--> deleted
     joined --(pod 404: preemption)--> deleted (in-flight re-dispatched)

Pre-warm runs BEFORE the ring join, so the replica's first routed request
is already warm: the adapter working set replays from the fleet's
registered sources, the kernel build cache arrives through
``COMPILE_CACHE_ENV`` in the JobSet spec, and the hot prefix KV of the
ring's REASSIGNED keys (``EngineFleet.reassigned_hot_keys``) is fetched
from the current owner's pool (``fetch_prefix`` -> ``import_prefix``: a
page gather, no prefill) or, where the owner no longer holds the pages,
replayed as a prefill there and imported with ``register_prefix=True``.
Either way the first real request on a moved key is a prefix-cache hit,
served by paged prefill over the imported pages.

Preemption is a steady-state input, not an exception: a joined pod whose
liveness read 404s has its in-flight requests failed with
:class:`~.resilience.ReplicaPreemptedError` carrying the decode state as a
:class:`~.llm_batch.KVHandoff` (exported while the engine still answers;
bf16 K/V travel as uint16 bit patterns), so the fleet resumes them on a
survivor through ``submit_prefilled`` and paged decode — no admitted
request is dropped.

Everything here is host-side Python (the engines behind the factory own
the device); the k8s surface is the provider seam, so the whole
lifecycle runs against an in-memory cluster.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

from ..chaos import FaultPoints, fire
from ..common.journal import open_journal
from ..config import K8S_DEFAULTS
from ..k8s.jobset import build_serving_jobset
from ..obs import (
    FLEET_DISPATCHES,
    FLEET_POD_EVENTS,
    FLEET_POD_PHASE,
    FLEET_POD_PREWARM_SECONDS,
    JOURNAL_WRITES,
    RECONCILE_ACTIONS,
    RECONCILE_SECONDS,
)
from ..obs.flight import record as flight_record
from ..utils import logger
from .resilience import ReplicaPreemptedError, retry_after_hint

# state-machine phases, in lifecycle order (the gauge value)
_PHASES = {"pending": 0, "warming": 1, "ready": 2, "joined": 3,
           "draining": 4}

# bound on the per-request export/replay waits inside a tick — the
# lifecycle must never hang the autoscaler loop on one stuck future
_TICK_WAIT_S = 30.0

# journal snapshot op per live phase (the compacted record a restarted
# controller replays; phases left of "joined" re-enter conservatively)
_PHASE_OP = {"pending": "scale_up", "warming": "prewarm",
             "ready": "prewarm", "joined": "joined", "draining": "drain"}


def controller_crash(**context):
    """Entry point of the control-plane restart drill. Fires the
    declared ``fleet.controller_crash`` chaos point and stamps the
    flight recorder; the caller (a test or drill harness) then drops the
    fleet/autoscaler/tuning-controller objects WITHOUT graceful shutdown
    and constructs fresh ones over the same cluster + journal — recovery
    is asserted on the causal chain that follows
    (``fleet.crash → reconcile.adopt/orphan/resume → reconcile.converged``,
    docs/fault_tolerance.md "Control-plane crash recovery")."""
    flight_record("fleet.crash", **context)
    fire(FaultPoints.fleet_controller_crash, **context)


class PodReplicaClient:
    """The fleet-facing client for one pod-hosted engine.

    In production this is a ``RemoteStep``-backed HTTP client; here it
    wraps the in-pod engine directly behind the SAME duck-typed surface
    (``submit*`` returning Futures), which is exactly why the fleet
    cannot tell the difference. What it adds over the bare engine:

    - **liveness**: once :meth:`preempt` runs (pod gone), every new
      submit raises ``RemoteCallError(503)`` — the redispatchable class
      a dead pod's connection error maps to.
    - **in-flight tracking**: requests route through OUTER futures the
      client owns, so a preemption can fail them all promptly with
      :class:`ReplicaPreemptedError` — each carrying the decode state
      exported as a :class:`KVHandoff` during the grace window — instead
      of letting them hang to their timeouts.
    """

    def __init__(self, pod_name: str, engine):
        self.pod = pod_name
        self.replica = ""  # stamped by EngineReplica
        self._engine = engine
        self._dead = False
        self._lock = threading.Lock()
        self._inflight: dict[Future, dict] = {}

    # -- engine surface passthrough ------------------------------------------
    @property
    def page_size(self):
        return getattr(self._engine, "page_size", 64)

    @property
    def kv_dtype(self):
        return getattr(self._engine, "kv_dtype", "native")

    @property
    def stats(self):
        return self._engine.stats

    @property
    def _stopped(self) -> bool:
        # EngineReplica.healthy reads this duck attribute
        return self._dead or getattr(self._engine, "_stopped", False)

    @property
    def _slot_state(self):
        return getattr(self._engine, "_slot_state", ())

    def _queue_depth(self) -> int:
        return self._engine._queue_depth()

    def _free_page_frac(self):
        frac_fn = getattr(self._engine, "_free_page_frac", None)
        return frac_fn() if frac_fn else None

    def start(self):
        self._engine.start()

    def warmup(self):
        self._engine.warmup()

    def stop(self, timeout: float = 10.0):
        with self._lock:
            self._dead = True
        self._engine.stop()

    def add_adapter_source(self, name: str, source):
        self._engine.add_adapter_source(name, source)

    def retire_adapter(self, name: str, keep_source: bool = False):
        self._engine.retire_adapter(name, keep_source=keep_source)

    # -- dispatch ------------------------------------------------------------
    def _check_alive(self):
        if self._dead:
            from .remote import RemoteCallError

            raise RemoteCallError(
                f"pod {self.pod} is gone", status_code=503)

    def _track(self, req: dict, inner: Future) -> Future:
        outer: Future = Future()
        with self._lock:
            self._inflight[outer] = req
        inner.add_done_callback(lambda fut: self._relay(outer, fut))
        return outer

    def _relay(self, outer: Future, inner: Future):
        with self._lock:
            self._inflight.pop(outer, None)
        if outer.done():  # already failed by preempt()
            return
        exc = inner.exception()
        if exc is not None:
            outer.set_exception(exc)
        else:
            outer.set_result(inner.result())

    def submit(self, prompt_tokens, max_new_tokens: int = 64,
               eos_id=None, temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, max_wait=None, adapter: str = "",
               request_key=None, _trace=None) -> Future:
        self._check_alive()
        req = {"kind": "decode", "prompt": list(prompt_tokens),
               "adapter": adapter,
               "sampling": (temperature, top_k, top_p)}
        inner = self._engine.submit(
            prompt_tokens, max_new_tokens=max_new_tokens, eos_id=eos_id,
            temperature=temperature, top_k=top_k, top_p=top_p,
            max_wait=max_wait, adapter=adapter, request_key=request_key,
            _trace=_trace)
        return self._track(req, inner)

    def submit_prefill(self, prompt_tokens, eos_id=None,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0, max_wait=None,
                       adapter: str = "", request_key=None,
                       _trace=None) -> Future:
        self._check_alive()
        req = {"kind": "prefill", "prompt": list(prompt_tokens),
               "adapter": adapter,
               "sampling": (temperature, top_k, top_p)}
        inner = self._engine.submit_prefill(
            prompt_tokens, eos_id=eos_id, temperature=temperature,
            top_k=top_k, top_p=top_p, max_wait=max_wait, adapter=adapter,
            request_key=request_key, _trace=_trace)
        return self._track(req, inner)

    def submit_prefilled(self, handoff, max_new_tokens: int = 64,
                         eos_id=None, max_wait=None,
                         register_prefix: bool = False,
                         _trace=None) -> Future:
        self._check_alive()
        req = {"kind": "decode", "prompt": list(handoff.prompt),
               "adapter": handoff.adapter, "sampling": handoff.sampling}
        inner = self._engine.submit_prefilled(
            handoff, max_new_tokens=max_new_tokens, eos_id=eos_id,
            max_wait=max_wait, register_prefix=register_prefix,
            _trace=_trace)
        return self._track(req, inner)

    # -- cross-replica prefix fetch (docs/serving.md "Hierarchical KV") ------
    def fetch_prefix(self, prompt_tokens, adapter: str = "") -> Future:
        """Serve this pod's cached pages for a prompt as a page-payload
        handoff — the fetch SOURCE side. A control op, not a tracked
        request: the engine fails its own control futures on stop, so a
        preempted pod cannot strand the caller."""
        self._check_alive()
        return self._engine.fetch_prefix(prompt_tokens, adapter=adapter)

    def import_prefix(self, handoff) -> Future:
        """Index a fetched page payload into this pod's pool — the
        fetch TARGET side (pre-warm and the fleet's dispatch-time hop)."""
        self._check_alive()
        return self._engine.import_prefix(handoff)

    # -- preemption ----------------------------------------------------------
    def preempt(self, grace: bool = True) -> list[dict]:
        """The pod is going away NOW. Fail every in-flight outer future
        with :class:`ReplicaPreemptedError`; while the grace window
        lasts (``grace=True`` — the engine still answers locally), each
        decode's state is first re-exported as a KV handoff (a prefix
        HIT on this engine's own cache, so the export runs paged prefill
        over cached pages, not a cold prefill) and rides the error — the
        fleet resumes it on a survivor via ``submit_prefilled``. Returns
        the re-dispatched request records for flight/metric accounting."""
        with self._lock:
            self._dead = True
            inflight = list(self._inflight.items())
            self._inflight.clear()
        redispatched = []
        for outer, req in inflight:
            if outer.done():
                continue
            handoff = None
            if grace and req["kind"] == "decode":
                try:
                    temperature, top_k, top_p = req["sampling"]
                    handoff = self._engine.submit_prefill(
                        req["prompt"], temperature=temperature,
                        top_k=top_k, top_p=top_p,
                        adapter=req["adapter"]).result(
                        timeout=_TICK_WAIT_S)
                except Exception as exc:  # noqa: BLE001 - degrade to
                    # a handoff-less preemption (full re-dispatch)
                    logger.warning("preemption KV export failed",
                                   pod=self.pod, error=str(exc))
            outer.set_exception(ReplicaPreemptedError(
                f"pod {self.pod} preempted", handoff=handoff,
                retry_after_s=retry_after_hint()))
            redispatched.append(dict(req, handoff=handoff is not None))
        self._engine.stop()
        return redispatched


class ServingPodFleet:
    """Pod-level elasticity for an :class:`~.fleet.EngineFleet`.

    Owns the JobSet-per-replica lifecycle behind the provider seam
    (``KubernetesProvider`` — or the fake cluster in tests) and keeps
    the fleet's ring membership consistent with pod reality. The
    autoscaler drives it: ``scale_up``/``drain`` replace its direct
    ``fleet.add_replica``/``drain_replica`` calls, and ``tick`` advances
    every pod one lifecycle transition per autoscaler tick.

    ``engine_factory(role)`` builds the in-pod engine (in production
    the pod process builds it and the factory returns a RemoteStep
    client; the seam is identical either way). A pod is sized by
    ``gpu_product`` / ``nodes`` / ``gpus_per_node`` (the port's
    ``build_serving_jobset``), where the reference takes an
    ``accelerator`` and a ``topology``.
    """

    def __init__(self, fleet, provider, engine_factory, *,
                 namespace: str | None = None,
                 gpu_product: str | None = None,
                 nodes: int = 1,
                 gpus_per_node: int = 1,
                 pod_spec: dict | None = None,
                 compile_cache_dir: str | None = None,
                 prewarm_max_keys: int = 32,
                 journal=None, reconcile_now: float = 0.0):
        self.fleet = fleet
        self.provider = provider
        self._factory = engine_factory
        self.namespace = namespace or getattr(
            provider, "namespace", None) or K8S_DEFAULTS["namespace"]
        self.gpu_product = gpu_product or str(K8S_DEFAULTS["gpu_product"])
        self.nodes = int(nodes)
        self.gpus_per_node = int(gpus_per_node)
        self._pod_spec = pod_spec or {
            "containers": [{"name": "engine",
                            "image": str(K8S_DEFAULTS["image"])}]}
        self.compile_cache_dir = compile_cache_dir
        self.prewarm_max_keys = int(prewarm_max_keys)
        self._lock = threading.RLock()
        self._pods: dict[str, dict] = {}  # pod name -> record
        self._seq = 0
        # adapter working set replayed into every joining pod (the
        # registry host cache makes the N-th replay a local copy)
        self._adapter_sources: dict[str, object] = {}
        # durable intent journal + restart reconciliation (docs/
        # fault_tolerance.md "Control-plane crash recovery"); None =
        # journaling off (the default — zero behavior change)
        self._journal = journal if journal is not None else open_journal(
            "podfleet", snapshot=self._journal_snapshot)
        if self._journal is not None:
            self.reconcile(reconcile_now)

    # -- introspection -------------------------------------------------------
    def pods(self) -> dict[str, str]:
        with self._lock:
            return {name: rec["phase"]
                    for name, rec in self._pods.items()}

    def pending_count(self) -> int:
        """Pods on their way INTO the ring (pending/warming/ready) —
        capacity the autoscaler must count before scaling up again."""
        with self._lock:
            return sum(1 for rec in self._pods.values()
                       if rec["phase"] in ("pending", "warming", "ready"))

    def owns(self, replica_id: str) -> bool:
        with self._lock:
            return any(rec.get("rid") == replica_id
                       for rec in self._pods.values())

    def _by_rid(self, replica_id: str) -> dict | None:
        with self._lock:
            for rec in self._pods.values():
                if rec.get("rid") == replica_id:
                    return rec
        return None

    def _set_phase(self, rec: dict, phase: str):
        rec["phase"] = phase
        FLEET_POD_PHASE.set(_PHASES[phase], pod=rec["name"])

    def _event(self, rec: dict, event: str):
        FLEET_POD_EVENTS.inc(pod=rec["name"], event=event)

    # -- adapter working set -------------------------------------------------
    def add_adapter_source(self, name: str, source):
        """Register a tenant adapter fleet-wide AND remember it as part
        of the working set every joining pod pre-warms with."""
        with self._lock:
            self._adapter_sources[name] = source
        self.fleet.add_adapter_source(name, source)

    def retire_adapter(self, name: str, keep_source: bool = False):
        with self._lock:
            self._adapter_sources.pop(name, None)
        self.fleet.retire_adapter(name, keep_source=keep_source)

    # -- scale up ------------------------------------------------------------
    def scale_up(self, role: str = "unified", now: float = 0.0) -> str:
        """Submit one serving JobSet; the pod enters the lifecycle at
        ``pending`` and joins the ring only after pre-warm + readiness
        (ticks later). Returns the pod name."""
        with self._lock:
            self._seq += 1
            name = f"serve-{self.fleet._fleet_id}-{self._seq}"
        spec = build_serving_jobset(
            name, self.namespace, dict(self._pod_spec),
            gpu_product=self.gpu_product, nodes=self.nodes,
            gpus_per_node=self.gpus_per_node,
            compile_cache_dir=self.compile_cache_dir)
        pod_name = f"{name}-slice-0-0"
        rec = {"name": pod_name, "jobset": name,
               "resource_id": f"jobset/{name}", "role": role,
               "rid": None, "client": None, "prewarmed": False}
        # write-ahead: the intent lands in the journal BEFORE the
        # cluster call, so a crash in between still leaves a record
        # reconcile() can match against the (possibly created) JobSet
        self._journal_pod(rec, "scale_up")
        resource_id = self.provider.create(spec, run_uid=name)
        if resource_id != rec["resource_id"]:
            rec["resource_id"] = resource_id
            self._journal_pod(rec, "scale_up")
        with self._lock:
            self._pods[pod_name] = rec
        self._set_phase(rec, "pending")
        self._event(rec, "scale_up")
        flight_record("pod.scale_up", pod=pod_name, jobset=name,
                      role=role)
        logger.info("serving pod scale-up submitted", pod=pod_name,
                    jobset=name, role=role)
        return pod_name

    # -- scale down / drain --------------------------------------------------
    def drain(self, replica_id: str, now: float = 0.0):
        """Graceful scale-down entry: fire ``fleet.drain`` (production:
        POST ``/__drain__`` on the pod), pull the replica's ring points
        so NEW work routes elsewhere, and let in-flight work finish —
        the autoscaler's drain sweep calls :meth:`on_replica_removed`
        once load hits zero (or grace expires). If the drain endpoint is
        unreachable (injected ``fleet.drain`` error), escalate to the
        preemption path: the pod is deleted anyway, so in-flight work
        re-dispatches as handoffs instead of being stranded."""
        rec = self._by_rid(replica_id)
        if rec is None:
            raise KeyError(f"no pod backs replica '{replica_id}'")
        self._journal_pod(rec, "drain")
        try:
            fire(FaultPoints.fleet_drain, pod=rec["name"],
                 replica=replica_id)
        except Exception as exc:  # noqa: BLE001 - injected fault
            logger.warning("pod drain endpoint unreachable; escalating "
                           "to preemption re-dispatch", pod=rec["name"],
                           error=str(exc))
            self._preempt(rec)
            return
        self._set_phase(rec, "draining")
        self._event(rec, "drain")
        flight_record("pod.drain", pod=rec["name"], replica=replica_id)
        self.fleet.drain_replica(replica_id)

    def on_replica_removed(self, replica_id: str):
        """Autoscaler callback after ``fleet.remove_replica`` (drain
        complete): delete the pod's JobSet and retire its series."""
        rec = self._by_rid(replica_id)
        if rec is None:
            return
        self._journal_pod(rec, "delete")
        try:
            self.provider.delete(rec["resource_id"])
        except Exception as exc:  # noqa: BLE001 - already-gone is fine
            logger.warning("serving jobset delete failed",
                           jobset=rec["jobset"], error=str(exc))
        self._event(rec, "delete")
        flight_record("pod.delete", pod=rec["name"],
                      jobset=rec["jobset"])
        self._retire(rec)

    # -- lifecycle tick ------------------------------------------------------
    def tick(self, now: float = 0.0):
        """Advance every pod ONE lifecycle transition (deterministic —
        a chaos drill steps the exact same sequence every run), then
        probe joined pods for out-of-band preemption."""
        with self._lock:
            records = list(self._pods.values())
        for rec in records:
            phase = rec["phase"]
            try:
                if phase == "pending":
                    self._advance_pending(rec)
                elif phase == "warming":
                    self._advance_warming(rec)
                elif phase == "ready":
                    self._advance_ready(rec)
                elif phase in ("joined", "draining"):
                    self._check_liveness(rec)
            except Exception as exc:  # noqa: BLE001 - one pod's fault
                # must not stall the whole fleet's lifecycle
                logger.warning("pod lifecycle tick failed",
                               pod=rec["name"], phase=phase,
                               error=str(exc))

    def _advance_pending(self, rec: dict):
        phase = self._read_pod_phase(rec["name"])
        if phase is None:
            # the pod vanished before it ever ran (scheduler rejection,
            # early preemption) — nothing joined the ring yet, so just
            # clean up; the autoscaler's below-min repair resubmits
            logger.warning("pending serving pod vanished",
                           pod=rec["name"])
            self._event(rec, "kill")
            flight_record("pod.kill", pod=rec["name"], joined=False)
            self._journal_pod(rec, "delete")
            try:
                self.provider.delete(rec["resource_id"])
            except Exception:  # noqa: BLE001 - already gone
                pass
            self._retire(rec)
            return
        if phase != "Running":
            return  # still scheduling — try again next tick
        client = PodReplicaClient(rec["name"],
                                  self._factory(rec["role"]))
        rec["client"] = client
        # registered but OUT of the ring: visible to stats/prewarm,
        # taking no traffic until join_replica
        rec["rid"] = self.fleet.add_replica(
            rec["role"], engine=client, joined=False)
        self._set_phase(rec, "warming")
        self._journal_pod(rec, "prewarm")

    def _advance_warming(self, rec: dict):
        t0 = time.perf_counter()
        client = rec["client"]
        replayed = 0
        fetched = 0
        try:
            fire(FaultPoints.fleet_prewarm, pod=rec["name"],
                 replica=rec["rid"])
            with self._lock:
                sources = dict(self._adapter_sources)
            for name, source in sources.items():
                client.add_adapter_source(name, source)
            client.warmup()
            # seed the ring slice this replica will own, FETCH-first:
            # each reassigned hot key's pages are pulled straight out of
            # the CURRENT owner's pool (a page gather, no prefill
            # compute — docs/serving.md "Hierarchical KV") and imported
            # here; keys the owner no longer holds fall back to the
            # replay path (prefill on the owner, a prefix hit there,
            # imported via submit_prefilled with register_prefix=True).
            # [-0:] would be the WHOLE list — 0 must mean "replay none"
            keys = (self.fleet.reassigned_hot_keys(rec["rid"])
                    [-self.prewarm_max_keys:]
                    if self.prewarm_max_keys > 0 else [])
            for key, prompt, adapter in keys:
                payload = self._owner_fetch(key, prompt, adapter)
                if payload is not None:
                    try:
                        client.import_prefix(payload).result(
                            timeout=_TICK_WAIT_S)
                        fetched += 1
                        continue
                    except Exception as exc:  # noqa: BLE001 - replay
                        logger.warning("prewarm page import failed; "
                                       "replaying", pod=rec["name"],
                                       error=str(exc))
                handoff = self._owner_prefill(key, prompt, adapter)
                if handoff is None:
                    continue
                client.submit_prefilled(
                    handoff, max_new_tokens=1,
                    register_prefix=True).result(timeout=_TICK_WAIT_S)
                replayed += 1
            rec["prewarmed"] = True
        except Exception as exc:  # noqa: BLE001 - a failed pre-warm
            # joins COLD rather than stranding paid-for capacity
            logger.warning("pod pre-warm failed; will join cold",
                           pod=rec["name"], error=str(exc))
        wall = time.perf_counter() - t0
        FLEET_POD_PREWARM_SECONDS.observe(wall)
        self._event(rec, "prewarm")
        flight_record("pod.prewarm", pod=rec["name"],
                      replica=rec["rid"], replayed_keys=replayed,
                      fetched_keys=fetched,
                      warm=rec["prewarmed"], wall_s=wall)
        self._set_phase(rec, "ready")

    def _advance_ready(self, rec: dict):
        # production: GET /readyz — which gates on warmth
        # (serving/server.py), so "probe ok" == "engine warm". An
        # injected fleet.pod_ready error is a readiness flap: the pod
        # stays OUT of the ring and is re-probed next tick.
        try:
            fire(FaultPoints.fleet_pod_ready, pod=rec["name"],
                 replica=rec["rid"])
        except Exception as exc:  # noqa: BLE001 - injected flap
            self._event(rec, "ready_flap")
            logger.warning("pod readiness probe failed; staying out "
                           "of the ring", pod=rec["name"],
                           error=str(exc))
            return
        self._event(rec, "ready")
        # join: ~1/N of the keyspace moves to this (pre-warmed) replica
        self.fleet.join_replica(rec["rid"])
        self._set_phase(rec, "joined")
        self._event(rec, "join")
        self._journal_pod(rec, "joined")
        flight_record("pod.join", pod=rec["name"], replica=rec["rid"],
                      prewarmed=rec["prewarmed"])

    def _check_liveness(self, rec: dict):
        if self._read_pod_phase(rec["name"]) is not None:
            return
        self._preempt(rec)

    def _preempt(self, rec: dict):
        """The pod is gone (liveness 404) or its drain endpoint is
        unreachable: fail its in-flight work with handoff-carrying
        preemption errors (the fleet re-dispatches them), drop the
        replica from the ring, and clean up the JobSet."""
        self._event(rec, "kill")
        flight_record("pod.kill", pod=rec["name"], replica=rec["rid"],
                      joined=rec["phase"] in ("joined", "draining"))
        redispatched = rec["client"].preempt() if rec["client"] else []
        for req in redispatched:
            self._event(rec, "redispatch")
            flight_record("pod.redispatch", pod=rec["name"],
                          prompt_len=len(req["prompt"]),
                          handoff=req["handoff"])
        if rec["rid"] is not None:
            try:
                self.fleet.remove_replica(rec["rid"])
            except KeyError:
                pass  # the drain sweep already removed it
        self._journal_pod(rec, "delete")
        try:
            self.provider.delete(rec["resource_id"])
        except Exception:  # noqa: BLE001 - the JobSet record may have
            pass           # vanished with the pod
        self._event(rec, "delete")
        flight_record("pod.delete", pod=rec["name"],
                      jobset=rec["jobset"])
        self._retire(rec)

    # -- helpers -------------------------------------------------------------
    def _read_pod_phase(self, name: str) -> str | None:
        """One liveness/phase read through the provider's core API;
        None means the pod record is gone (404 — preempted)."""
        core = getattr(self.provider, "_core", None)
        if core is None:
            raise ValueError(
                "provider exposes no CoreV1 client for pod reads")
        try:
            pod = core.read_namespaced_pod(name, self.namespace)
        except Exception as exc:  # noqa: BLE001 - only 404 is "gone"
            if getattr(exc, "status", None) == 404:
                return None
            raise
        return pod.status.phase

    def _owner_fetch(self, key: int, prompt: list, adapter: str):
        """Pull one hot prompt's cached pages from its CURRENT ring
        owner as a page-payload handoff (docs/serving.md "Hierarchical
        KV") — the cheap pre-warm seed: a pool gather on the owner, no
        prefill compute. None when fetch is disabled, no owner speaks
        the protocol, or nobody holds the pages (the caller replays via
        :meth:`_owner_prefill` instead)."""
        fleet = self.fleet
        if not getattr(fleet, "_prefix_fetch", False):
            return None
        try:
            # an armed error models a dead fetch path (degrade to the
            # replay prefill); an armed delay models a slow pull
            fire(FaultPoints.llm_kv_fetch, key=key, target="prewarm")
        except Exception as exc:  # noqa: BLE001 - injected fault
            logger.warning("prewarm prefix fetch faulted; replaying",
                           key=key, error=str(exc))
            return None
        with fleet._lock:
            pool = dict(fleet._route_pool())
            order = fleet._ring.preference(key)
        for rid in order:
            replica = pool.get(rid)
            if replica is None or not replica.healthy:
                continue
            fetcher = getattr(replica.engine, "fetch_prefix", None)
            if fetcher is None:
                continue
            try:
                payload = fetcher(prompt, adapter=adapter).result(
                    timeout=_TICK_WAIT_S)
            except Exception as exc:  # noqa: BLE001 - next owner
                logger.warning("prewarm prefix fetch failed",
                               replica=rid, error=str(exc))
                continue
            if payload is not None:
                return payload
        return None

    def _owner_prefill(self, key: int, prompt: list, adapter: str):
        """Prefill one hot prompt on its CURRENT ring owner (a prefix
        hit there — the pages are already cached) and return the
        handoff; None when no owner could serve it."""
        fleet = self.fleet
        with fleet._lock:
            pool = dict(fleet._route_pool())
            order = fleet._ring.preference(key)
        for rid in order:
            replica = pool.get(rid)
            if replica is None or not replica.healthy:
                continue
            try:
                return replica.engine.submit_prefill(
                    prompt, adapter=adapter).result(timeout=_TICK_WAIT_S)
            except Exception as exc:  # noqa: BLE001 - next owner
                logger.warning("prewarm owner prefill failed",
                               replica=rid, error=str(exc))
        return None

    def _retire(self, rec: dict):
        """Zero leaked per-pod series: drop every label set this pod's
        lifecycle may have created (remove() is a no-op for label sets
        that never materialized)."""
        for event in ("scale_up", "prewarm", "ready", "ready_flap",
                      "join", "kill", "redispatch", "drain", "delete"):
            FLEET_POD_EVENTS.remove(pod=rec["name"], event=event)
        FLEET_POD_PHASE.remove(pod=rec["name"])
        with self._lock:
            self._pods.pop(rec["name"], None)

    # -- durable intent + crash recovery -------------------------------------
    def draining_rids(self) -> list[str]:
        """Replica ids currently mid-drain — the autoscaler re-derives
        its drain sweep from this, level-triggered, instead of trusting
        its own (possibly restarted-away) ``_draining`` dict."""
        with self._lock:
            return [rec["rid"] for rec in self._pods.values()
                    if rec["phase"] == "draining" and rec.get("rid")]

    def _journal_pod(self, rec: dict, op: str):
        if self._journal is None:
            return
        ok = self._journal.append(
            "pod", op=op, pod=rec["name"], jobset=rec["jobset"],
            resource_id=rec["resource_id"], role=rec["role"],
            rid=rec.get("rid"), prewarmed=bool(rec.get("prewarmed")))
        JOURNAL_WRITES.inc(journal="podfleet",
                           outcome="ok" if ok else "failed")

    def _journal_snapshot(self) -> list[dict]:
        """Compaction view: one full-state record per live pod (each
        append carries full state, so the latest record per pod IS the
        intent — deleted pods simply drop out)."""
        with self._lock:
            records = list(self._pods.values())
        return [{"kind": "pod", "op": _PHASE_OP[rec["phase"]],
                 "pod": rec["name"], "jobset": rec["jobset"],
                 "resource_id": rec["resource_id"], "role": rec["role"],
                 "rid": rec.get("rid"),
                 "prewarmed": bool(rec.get("prewarmed"))}
                for rec in records]

    def reconcile(self, now: float = 0.0) -> dict:
        """Converge journaled intent vs. the observed world, LEVEL-
        triggered (docs/fault_tolerance.md "Control-plane crash
        recovery"). Runs on construction whenever a journal is
        configured; idempotent afterwards.

        - **adopt**: a Running pod whose last intent was scale_up /
          prewarm / joined re-enters the state machine at the ``ready``
          probe phase (a still-scheduling pod re-enters at ``pending``);
          the normal tick re-probes and rejoins the ring via
          ``join_replica``.
        - **resume**: a pod mid-drain re-enters at ``draining`` with its
          ring points pulled again; the autoscaler's normal drain/delete
          sweep finishes the removal.
        - **orphan**: a JobSet whose intent already said ``delete`` is
          deleted now; a journaled pod with no world presence only has
          its stale series retired. Desired capacity is NEVER replayed
          from stale scale-ups — the autoscaler re-derives it from live
          signals and its below-min repair resubmits what is actually
          missing.
        """
        empty = {"adopted": [], "resumed": [], "orphaned": [],
                 "unknown": []}
        if self._journal is None:
            return empty
        lister = getattr(self.provider, "list_serving_jobsets", None)
        if lister is None:
            logger.warning("provider cannot list serving jobsets — "
                           "journal replayed but world not reconciled",
                           provider=type(self.provider).__name__)
            return empty
        t0 = time.perf_counter()
        intent: dict[str, dict] = {}
        for record in self._journal.replay():
            if record.get("kind") == "pod" and record.get("pod"):
                intent[record["pod"]] = record
        world = lister()
        adopted: list = []
        resumed: list = []
        orphaned: list = []
        unknown: list = []
        handled = set()
        with self._lock:
            known = set(self._pods)
        for pod, record in intent.items():
            handled.add(record.get("jobset"))
            if pod in known:
                continue  # already tracked — nothing crashed in between
            self._reconcile_pod(pod, record, world,
                                adopted, resumed, orphaned)
        for name in world:
            if name not in handled:
                # not ours (another fleet sharing the namespace) — a
                # level-triggered pass only acts on intent it owns
                unknown.append(name)
                RECONCILE_ACTIONS.inc(controller="podfleet",
                                      action="skip_unknown")
                logger.warning("serving jobset unknown to the intent "
                               "journal — left alone", jobset=name)
        wall = time.perf_counter() - t0
        RECONCILE_SECONDS.observe(wall)
        flight_record("reconcile.converged", controller="podfleet",
                      adopted=len(adopted), resumed=len(resumed),
                      orphaned=len(orphaned), unknown=len(unknown),
                      wall_s=wall)
        if intent:
            logger.info("pod fleet reconciled", adopted=len(adopted),
                        resumed=len(resumed), orphaned=len(orphaned),
                        unknown=len(unknown))
        self._journal.compact(self._journal_snapshot())
        return {"adopted": adopted, "resumed": resumed,
                "orphaned": orphaned, "unknown": unknown}

    def _reconcile_pod(self, pod: str, record: dict, world: dict,
                       adopted: list, resumed: list, orphaned: list):
        op = record.get("op", "scale_up")
        jobset = record.get("jobset", "")
        resource_id = record.get("resource_id", f"jobset/{jobset}")
        alive = jobset in world
        phase = self._read_pod_phase(pod) if alive else None
        if op == "delete" or phase is None \
                or (op == "drain" and phase != "Running"):
            # removal intent already decided, or the world moved on
            # (pod/JobSet gone) — finish the delete; capacity is NOT
            # resubmitted here, the autoscaler re-derives desired count
            if alive:
                try:
                    self.provider.delete(resource_id)
                except Exception:  # noqa: BLE001 - going away anyway
                    pass
            orphaned.append(pod)
            reason = "intent_deleted" if op == "delete" else "vanished"
            RECONCILE_ACTIONS.inc(
                controller="podfleet",
                action="orphan_deleted" if op == "delete"
                else "orphan_vanished")
            flight_record("reconcile.orphan", pod=pod, jobset=jobset,
                          reason=reason)
            self._retire_journaled(record)
            return
        rec = {"name": pod, "jobset": jobset,
               "resource_id": resource_id,
               "role": record.get("role") or "unified", "rid": None,
               "client": None,
               "prewarmed": bool(record.get("prewarmed"))}
        if phase != "Running":
            # still scheduling — re-enter at pending, the normal tick
            # advances it exactly like a fresh scale-up
            with self._lock:
                self._pods[pod] = rec
            self._set_phase(rec, "pending")
            adopted.append(pod)
            RECONCILE_ACTIONS.inc(controller="podfleet", action="adopt")
            flight_record("reconcile.adopt", pod=pod, phase="pending")
            self._retire_old_rid(record)
            self._journal_pod(rec, "scale_up")
            return
        client = PodReplicaClient(pod, self._factory(rec["role"]))
        rec["client"] = client
        # registered OUT of the ring, same as a fresh bring-up — the
        # re-probe (ready) or drain sweep decides what happens next
        rec["rid"] = self.fleet.add_replica(
            rec["role"], engine=client, joined=False)
        with self._lock:
            self._pods[pod] = rec
        if op == "drain":
            self.fleet.drain_replica(rec["rid"])
            self._set_phase(rec, "draining")
            resumed.append(pod)
            RECONCILE_ACTIONS.inc(controller="podfleet",
                                  action="resume_drain")
            flight_record("reconcile.resume", pod=pod,
                          replica=rec["rid"])
            self._journal_pod(rec, "drain")
        else:
            self._set_phase(rec, "ready")
            adopted.append(pod)
            RECONCILE_ACTIONS.inc(controller="podfleet", action="adopt")
            flight_record("reconcile.adopt", pod=pod,
                          replica=rec["rid"],
                          prewarmed=rec["prewarmed"])
            self._journal_pod(rec, "prewarm")
        self._retire_old_rid(record)

    def _retire_journaled(self, record: dict):
        """Series cleanup for a journaled pod that did not survive into
        this incarnation — the crash skipped the normal ``_retire``
        path, so its label sets would otherwise leak forever."""
        self._retire({"name": record.get("pod", "")})
        self._retire_old_rid(record)

    @staticmethod
    def _retire_old_rid(record: dict):
        """The previous incarnation's replica id is gone for good (ids
        are process-unique): drop its dispatch series."""
        rid = record.get("rid")
        if not rid:
            return
        for outcome in ("ok", "redispatch", "failed"):
            FLEET_DISPATCHES.remove(replica=rid, outcome=outcome)
