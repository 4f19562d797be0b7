"""Engine replica fleet: prefix-affinity routing and prefill/decode
disaggregation — the port's copy of ``mlrun_tpu/serving/fleet.py`` (same
names, defaults and behaviour) over the port's engines.

One continuous-batching engine caps throughput, and naive random routing
across replicas destroys the prefix-cache locality the paged engine pays
for: every replica re-prefills the hot prefixes its siblings already
cached. This module is the fleet layer above the engines:

- :class:`ConsistentHashRing` — bounded ring with (weighted) virtual
  nodes; keys are the prompt's leading full-page block chains
  (``prefix.block_chain_key``, the radix index's block identity), so
  requests sharing a hot prefix land on the SAME replica where the KV
  pages already live, and a replica join/leave moves only ~1/N of the
  keyspace.
- :class:`EngineFleet` — owns N engine replicas (in-process; the dispatch
  seam is a Future-returning ``submit``). Dispatch re-routes 503-class
  failures (``EngineStoppedError``, draining, shed) to the next ring node
  with bounded deterministic backoff (``common/retry.compute_backoff``)
  instead of surfacing them to the client.
- Prefill/decode disaggregation: with ``prefill_replicas`` > 0 the fleet
  splits into a prefill pool (affinity-routed: the prefix caches live
  there) and a decode pool (least-loaded). A prefill replica runs the
  prefill and exports the slot's KV as a ``KVHandoff``; a decode replica
  imports it and ticks, so a long prompt never appears between two decode
  ticks.
- Cross-replica prefix fetch: when the ring moves a hot key to another
  replica, the new owner pulls the cached pages from the previous owner
  (``fetch_prefix`` -> ``import_prefix``) before the request's prefill,
  which then runs as a prefix-cache hit.

The fleet itself is host Python; its replicas are the port's engines on
the device their factory gives them (one process, one card: every
replica's scheduler thread launches on the device's current stream).
A KV handoff crosses host memory even between replicas on one card: that
is the ``KVHandoff`` wire format.
"""

from __future__ import annotations

import bisect
import hashlib
import random
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Callable, Optional

from ..chaos import FaultPoints, fire
from ..common.retry import RetryPolicy, compute_backoff
from ..config import SERVING_FLEET_DEFAULTS
from ..obs import (
    FLEET_DISPATCHES,
    FLEET_HANDOFF_BYTES,
    FLEET_HANDOFF_LATENCY,
    FLEET_REPLICAS,
    HEALTH_TRANSITIONS,
    REPLICA_HEALTH_SCORE,
    REPLICA_HEALTH_STATE,
    get_tracer,
    merge_timing,
)
from ..utils import logger
from .prefix import block_chain_key
from .resilience import (
    CircuitOpenError,
    EngineStoppedError,
    QueueFullError,
    ReplicaUnavailableError,
    ServerDrainingError,
)

# process-unique fleet ids so two fleets' replica labels never collide
_FLEET_SEQUENCE = iter(range(1, 1 << 30))


def redispatchable(exc: Exception) -> bool:
    """Failures worth re-routing to another replica: the REPLICA is
    unavailable (stopped, draining, breaker-open, shedding, adapter
    working-set full) — not the request (400-class, unknown tenant, and
    per-tenant rate-limit sheds stay fatal: those follow the request
    wherever it routes). Remote process replicas surface the same
    classes as ``RemoteCallError`` with a 429/502/503 status."""
    if isinstance(exc, (EngineStoppedError, ServerDrainingError,
                        QueueFullError, CircuitOpenError)):
        return True
    from .adapters import AdapterCapacityError
    from .remote import RemoteCallError

    if isinstance(exc, AdapterCapacityError):
        # THIS replica's bank slots are all pinned — another replica
        # (its own registry, its own slots) may well have room
        return True
    if isinstance(exc, RemoteCallError):
        return getattr(exc, "status_code", None) in (429, 502, 503)
    return False


class ConsistentHashRing:
    """Bounded consistent-hash ring with virtual nodes.

    Each node owns ``vnodes`` deterministic points on a 64-bit ring
    (sha256 of ``"node#i"`` — stable across processes); a key maps to
    the first point clockwise from it. Adding/removing a node moves only
    the keys whose nearest point belonged to it (~1/N of the keyspace),
    so a replica join/leave relocates a bounded slice of prefix
    residency instead of reshuffling every hot prefix."""

    def __init__(self, vnodes: int = 64):
        if vnodes <= 0:
            raise ValueError(f"vnodes must be > 0, got {vnodes}")
        self.vnodes = int(vnodes)
        self._points: list[int] = []      # sorted ring positions
        self._owners: list[str] = []      # owner node per position
        self._nodes: set[str] = set()
        self._weights: dict[str, float] = {}

    @staticmethod
    def _point(data: str) -> int:
        return int.from_bytes(
            hashlib.sha256(data.encode()).digest()[:8], "big")

    def __len__(self) -> int:
        return len(self._nodes)

    def nodes(self) -> list[str]:
        return sorted(self._nodes)

    def add(self, node: str, weight: float = 1.0):
        """Add (or re-weight) a node. ``weight`` in (0, 1] scales the
        node's vnode count: a de-weighted node keeps the FIRST
        ``round(vnodes * weight)`` of its deterministic points, so
        probation sheds only the keys owned by the dropped points —
        restoring weight 1.0 restores the identical ownership map, and
        keys on the kept points never move at all."""
        weight = min(1.0, max(0.0, float(weight)))
        if node in self._nodes:
            if self._weights.get(node, 1.0) == weight:
                return
            self.remove(node)
        self._nodes.add(node)
        self._weights[node] = weight
        count = max(1, round(self.vnodes * weight))
        for i in range(count):
            point = self._point(f"{node}#{i}")
            idx = bisect.bisect(self._points, point)
            self._points.insert(idx, point)
            self._owners.insert(idx, node)

    def weight(self, node: str) -> float:
        return self._weights.get(node, 1.0) if node in self._nodes else 0.0

    def remove(self, node: str):
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._weights.pop(node, None)
        keep = [(p, o) for p, o in zip(self._points, self._owners)
                if o != node]
        self._points = [p for p, _ in keep]
        self._owners = [o for _, o in keep]

    def lookup(self, key: int) -> str:
        """The node owning ``key``; raises when the ring is empty."""
        if not self._points:
            raise ReplicaUnavailableError("hash ring has no nodes")
        idx = bisect.bisect(self._points, key) % len(self._points)
        return self._owners[idx]

    def preference(self, key: int, exclude=()) -> list[str]:
        """Distinct nodes in ring order starting at ``key``'s owner —
        the re-dispatch order (primary first, then each next ring
        node)."""
        if not self._points:
            return []
        exclude = set(exclude)
        start = bisect.bisect(self._points, key) % len(self._points)
        seen: set[str] = set()
        order: list[str] = []
        for offset in range(len(self._points)):
            owner = self._owners[(start + offset) % len(self._points)]
            if owner in seen or owner in exclude:
                continue
            seen.add(owner)
            order.append(owner)
        return order


class EngineReplica:
    """One engine behind a fleet id + role (unified | prefill | decode).

    The dispatch contract is duck-typed on ``submit``/``submit_prefill``/
    ``submit_prefilled`` returning Futures, so a remote process replica
    can satisfy it without the fleet changing."""

    def __init__(self, replica_id: str, engine, role: str = "unified"):
        self.id = replica_id
        self.engine = engine
        self.role = role
        self.draining = False
        # deferred ring join (the pod fleet's pre-warm): a joining replica is
        # registered (visible in stats, warm-able) but takes NO ring
        # traffic until join_replica() flips this — ready means warm
        self.joining = False
        # fail-slow probation (obs/health.py ReplicaHealthScorer): the
        # scorer de-weights a probated replica's ring vnodes instead of
        # draining it — correct-but-slow deserves less traffic, not death
        self.weight = 1.0
        self.health_state = "healthy"
        # stamp the replica label BEFORE the engine registers metrics
        engine.replica = replica_id

    @property
    def healthy(self) -> bool:
        return not self.draining and not self.joining and not getattr(
            self.engine, "_stopped", False)

    def load(self) -> int:
        """Cheap congestion signal for decode-pool placement: active
        slots + queued admissions (host-side ints, no stats() walk)."""
        engine = self.engine
        active = sum(1 for s in getattr(engine, "_slot_state", ())
                     if s.active)
        return active + engine._queue_depth()


class EngineFleet:
    """N engine replicas behind one ``submit()``.

    ``engine_factory(role)`` builds one engine per replica ("unified",
    or "prefill"/"decode" when ``prefill_replicas`` > 0). Routing:

    - ``"affinity"`` (default): consistent-hash on the prompt's leading
      prefix blocks — hot prefixes stay cache-resident on one replica.
    - ``"random"``: uniform choice (the bench baseline affinity is
      measured against).

    The fleet duck-types the engine surface ``LLMModelServer.predict``
    uses (``submit``/``generate``/``warmup``/``start``/``stop``/
    ``stats``), so it drops in wherever a single engine did.
    """

    ROUTING = ("affinity", "random")

    def __init__(self, engine_factory: Callable[[str], object],
                 replicas: int = 2, prefill_replicas: int = 0,
                 routing: str | None = None,
                 route_blocks: int | None = None,
                 route_block_tokens: int | None = None,
                 vnodes: int | None = None,
                 max_dispatch_attempts: int | None = None,
                 backoff: float | None = None, seed: int = 0):
        fleet_conf = SERVING_FLEET_DEFAULTS
        if routing is None:
            routing = str(fleet_conf["routing"])
        if routing not in self.ROUTING:
            raise ValueError(
                f"unknown routing '{routing}' (one of {self.ROUTING})")
        # replicas=0 is valid for pod-backed fleets: a (re)started
        # control plane whose membership is owned entirely by
        # ServingPodFleet (scale-up / crash-recovery adoption) must not
        # fabricate an in-process seed replica the cluster never had
        if replicas < 0:
            raise ValueError(f"replicas must be >= 0, got {replicas}")
        if prefill_replicas < 0:
            raise ValueError(
                f"prefill_replicas must be >= 0, got {prefill_replicas}")
        self.routing = routing
        self.route_blocks = int(route_blocks
                                if route_blocks is not None
                                else fleet_conf["route_blocks"])
        self._factory = engine_factory
        self._fleet_id = f"f{next(_FLEET_SEQUENCE)}"
        self._lock = threading.RLock()
        self._rng = random.Random(seed)
        attempts = (max_dispatch_attempts
                    if max_dispatch_attempts is not None
                    else int(fleet_conf["max_dispatch_attempts"]))
        if attempts < 1:
            raise ValueError("max_dispatch_attempts must be >= 1")
        self.max_dispatch_attempts = attempts
        # cross-replica prefix fetch:
        # when a hot key's ring owner changes, pull the cached pages from
        # the previous owner instead of re-prefilling on the new one
        self._prefix_fetch = bool(fleet_conf.get("prefix_fetch", True))
        self._retry_policy = RetryPolicy(
            max_retries=attempts,
            backoff=(float(backoff) if backoff is not None
                     else float(fleet_conf["backoff"])),
            backoff_factor=2.0, backoff_max=1.0, jitter=0.1)
        self._started = False
        self._stopped = False
        self._replica_seq = 0
        self._stats = {"dispatches": 0, "redispatches": 0, "failed": 0,
                       "no_replica": 0, "handoffs": 0, "handoff_bytes": 0,
                       "prefix_fetches": 0, "prefix_fetch_fallbacks": 0}
        # per-replica sliding outcome windows (rid -> deque of 0/1):
        # rates, not lifetime counters — a replica that failed an hour
        # ago and recovered reads 0.0, which is what the health scorer
        # (obs/health.py) and operators actually want to see
        self._dispatch_outcomes: dict[str, deque] = {}
        self._fetch_outcomes: dict[str, deque] = {}
        self._ttft_ring: list = []            # end-to-end, bounded below
        self._ttft_ring_max = 512
        # hot routing keys (bounded LRU):
        # key -> (prompt, route_adapter, last_owner_rid).  A joining pod
        # replays/fetches its REASSIGNED slice of these as pre-warm
        # (the pod fleet) so its first real request on a moved key
        # is a prefix-cache hit; the last owner is where a ring-moved
        # key's pages still live — the cross-replica fetch source
        self._hot_keys: OrderedDict = OrderedDict()
        self._hot_keys_max = 256
        # pools: unified fleets route over _workers; disaggregated fleets
        # affinity-route prefills over _prefill and place decodes
        # least-loaded over _workers
        self._workers: dict[str, EngineReplica] = {}
        self._prefill: dict[str, EngineReplica] = {}
        vnode_count = int(vnodes if vnodes is not None
                          else fleet_conf["vnodes"])
        self._ring = ConsistentHashRing(vnodes=vnode_count)
        worker_role = "decode" if prefill_replicas else "unified"
        for _ in range(replicas):
            self.add_replica(worker_role)
        for _ in range(prefill_replicas):
            self.add_replica("prefill")
        # routing-key block size: align with the engines' page size so
        # the routing identity IS the radix index's block identity
        if route_block_tokens is None:
            pool = self._route_pool()
            if pool:
                first = next(iter(pool.values()))
                route_block_tokens = getattr(first.engine, "page_size",
                                             64)
            else:
                route_block_tokens = 64  # empty fleet: engines arrive
                # later via add_replica; the page-size alignment is the
                # caller's job then (pass route_block_tokens explicitly)
        self.route_block_tokens = int(route_block_tokens)

    # -- topology ------------------------------------------------------------
    def _route_pool(self) -> dict[str, EngineReplica]:
        """The pool affinity routing runs over: prefill replicas when
        disaggregated (their prefix caches are the locality that
        matters), the whole fleet otherwise."""
        return self._prefill if self._prefill else self._workers

    def _sync_ring(self):
        """Ring membership == non-draining, non-joining routing-pool
        membership. Caller holds the lock. Adding the first prefill
        replica flips the routing pool from workers to prefill; the sweep
        keeps the ring consistent through that flip, through drains, and
        through deferred pod joins."""
        route = self._route_pool()
        for node in list(self._ring.nodes()):
            if node not in route or route[node].draining \
                    or route[node].joining:
                self._ring.remove(node)
        for rid, replica in route.items():
            if not replica.draining and not replica.joining:
                self._ring.add(rid, weight=replica.weight)

    @property
    def replicas(self) -> list[EngineReplica]:
        with self._lock:
            return list(self._workers.values()) + list(
                self._prefill.values())

    def add_replica(self, role: str = "unified", engine=None,
                    joined: bool = True) -> str:
        """Scale up: build + ring-join one replica (keys move ~1/N).
        ``engine`` adopts an externally built engine (a pod-backed
        client of a pod fleet) instead of calling the factory;
        ``joined=False`` registers the replica WITHOUT ring membership —
        it takes no traffic until :meth:`join_replica`, so a pod can
        pre-warm behind the ring."""
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"unknown replica role '{role}'")
        with self._lock:
            rid = f"{self._fleet_id}-{role[0]}{self._replica_seq}"
            self._replica_seq += 1
            if engine is None:
                engine = self._factory(role)
            replica = EngineReplica(rid, engine, role)
            replica.joining = not joined
            pool = self._prefill if role == "prefill" else self._workers
            pool[rid] = replica
            self._sync_ring()
            FLEET_REPLICAS.set(
                sum(1 for r in self.replicas if r.role == role), role=role)
            if self._started:
                engine.start()
        logger.info("fleet replica added", replica=rid, role=role,
                    fleet=self._fleet_id, joined=joined)
        return rid

    def join_replica(self, replica_id: str):
        """Flip a deferred-join replica into the ring (its ~1/N keyspace
        slice moves here). Fires ``fleet.join`` first: an injected delay
        models a slow join (keys keep routing to survivors meanwhile),
        an injected error keeps the replica out of the ring."""
        fire(FaultPoints.fleet_join, replica=replica_id,
             fleet=self._fleet_id)
        with self._lock:
            for pool in (self._workers, self._prefill):
                if replica_id in pool:
                    pool[replica_id].joining = False
                    self._sync_ring()
                    logger.info("fleet replica joined ring",
                                replica=replica_id, fleet=self._fleet_id)
                    return
        raise KeyError(f"unknown replica '{replica_id}'")

    def remove_replica(self, replica_id: str):
        """Scale down: ring-leave (only this replica's keys move), stop
        the engine (queued work fails with EngineStoppedError and the
        dispatch layer re-routes it), and let the engine retire its own
        metric series."""
        with self._lock:
            replica = self._workers.pop(replica_id, None) or \
                self._prefill.pop(replica_id, None)
            if replica is None:
                raise KeyError(f"unknown replica '{replica_id}'")
            replica.draining = True
            self._sync_ring()
            FLEET_REPLICAS.set(
                sum(1 for r in self.replicas if r.role == replica.role),
                role=replica.role)
        replica.engine.stop()
        # the engine retired its mlt_llm_* series in stop(); retire the
        # fleet's per-replica dispatch series too, or a churning fleet
        # pins dead replicas until the family's cardinality bound bites
        for outcome in ("ok", "redispatch", "failed"):
            FLEET_DISPATCHES.remove(replica=replica_id, outcome=outcome)
        # health telemetry rides the same lifecycle: scorer series and
        # outcome windows die with the replica (remove() is a no-op for
        # series the scorer never wrote)
        REPLICA_HEALTH_SCORE.remove(replica=replica_id)
        REPLICA_HEALTH_STATE.remove(replica=replica_id)
        for to in ("healthy", "suspect", "probation"):
            HEALTH_TRANSITIONS.remove(replica=replica_id, to=to)
        with self._lock:
            self._dispatch_outcomes.pop(replica_id, None)
            self._fetch_outcomes.pop(replica_id, None)
        logger.info("fleet replica removed", replica=replica_id,
                    fleet=self._fleet_id)

    def set_replica_weight(self, replica_id: str, weight: float):
        """Scale a replica's share of the ring keyspace (probation
        actuation, obs/health.py). Weight in (0, 1] keeps a deterministic
        prefix of its vnode points, so only the shed slice of keys moves
        to neighbors and restoring 1.0 restores identical ownership.
        Drain/joining state is untouched — a de-weighted replica still
        serves the keys it keeps and all in-flight work."""
        with self._lock:
            for pool in (self._workers, self._prefill):
                if replica_id in pool:
                    pool[replica_id].weight = min(
                        1.0, max(0.0, float(weight)))
                    self._sync_ring()
                    return
        raise KeyError(f"unknown replica '{replica_id}'")

    def drain_replica(self, replica_id: str):
        """Stop routing NEW work to a replica (in-flight work finishes);
        the ring drops its points so its keyspace moves to neighbors."""
        with self._lock:
            for pool in (self._workers, self._prefill):
                if replica_id in pool:
                    pool[replica_id].draining = True
                    self._sync_ring()
                    return
        raise KeyError(f"unknown replica '{replica_id}'")

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        with self._lock:
            self._started = True
            replicas = self.replicas
        for replica in replicas:
            replica.engine.start()

    def warmup(self):
        for replica in self.replicas:
            replica.engine.warmup()

    def stop(self, timeout: float = 10.0):
        with self._lock:
            self._stopped = True
            replicas = self.replicas
        for replica in replicas:
            replica.engine.stop(timeout=timeout)

    def close(self):
        self.stop()

    # -- routing -------------------------------------------------------------
    def routing_key(self, prompt_tokens, adapter: str = "") -> int:
        """Prefix-block routing key, namespaced per tenant: the SAME
        prompt under two adapters is two identities (its KV is not
        shareable across them), while same-tenant shared prefixes still
        land on one replica."""
        return block_chain_key(prompt_tokens, self.route_block_tokens,
                               max_blocks=self.route_blocks,
                               adapter=adapter)

    def reassigned_hot_keys(self, candidate: str) -> list:
        """The hot keys whose ring owner WOULD become ``candidate`` if it
        joined now — exactly the prefix working set a joining pod takes
        over, so a pod fleet's pre-warm replays these and nothing
        else. Returns ``[(key, prompt, adapter), ...]`` hottest-last
        (LRU order)."""
        with self._lock:
            probe = ConsistentHashRing(vnodes=self._ring.vnodes)
            for node in self._ring.nodes():
                probe.add(node)
            probe.add(candidate)
            items = list(self._hot_keys.items())
        out = []
        for key, (prompt, adapter, _owner) in items:
            if probe.lookup(key) == candidate:
                out.append((key, prompt, adapter))
        return out

    def hot_key_owner(self, key: int) -> Optional[str]:
        """The replica that last SERVED a hot key — where its prefix
        pages still live after a ring reassignment moves the key (the
        cross-replica fetch source)."""
        with self._lock:
            entry = self._hot_keys.get(key)
            return entry[2] if entry is not None else None

    def _pick(self, pool: dict, key: int, tried: list,
              affinity: bool) -> Optional[EngineReplica]:
        """Next replica for a key: ring preference order under affinity,
        uniform under random; draining/stopped/already-tried replicas are
        skipped, with a healthy fallback off-ring so a request never
        fails while ANY replica could serve it."""
        with self._lock:
            candidates = [r for r in pool.values()
                          if r.healthy and r.id not in tried]
            if not candidates:
                return None
            if not affinity or self.routing == "random":
                return self._rng.choice(candidates)
            by_id = {r.id: r for r in candidates}
            for rid in self._ring.preference(key, exclude=tried):
                if rid in by_id:
                    return by_id[rid]
            # ring points may lag a drain — any healthy replica beats a
            # client-visible failure
            return candidates[0]

    def _pick_decode(self, tried: list) -> Optional[EngineReplica]:
        """Decode placement is load-, not locality-driven: the KV arrives
        with the handoff, so the least-loaded healthy replica wins."""
        with self._lock:
            candidates = [r for r in self._workers.values()
                          if r.healthy and r.id not in tried]
        if not candidates:
            return None
        return min(candidates, key=lambda r: (r.load(), r.id))

    # -- dispatch ------------------------------------------------------------
    def submit(self, prompt_tokens, max_new_tokens: int = 64,
               eos_id: int | None = None, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               max_wait: float | None = None,
               adapter: str = "", request_key=None) -> Future:
        """Route one request into the fleet; resolves to (tokens, stats)
        exactly like an engine future, with ``stats`` gaining ``replica``
        (and ``prefill_replica``/``prefill_s``/``handoff_bytes`` when
        disaggregated). 503-class replica failures re-dispatch to the
        next ring node up to ``max_dispatch_attempts`` times.
        ``adapter`` is the tenant id: it namespaces the routing key and
        rides the dispatch (and any KV handoff) into the engines. A
        tenant with canary-loop state resolves to its effective
        versioned id BEFORE the routing key is computed
        (serving/canary.py), so canary traffic routes — and caches — as
        its own identity; ``request_key`` pins the split side."""
        out: Future = Future()
        if self._stopped:
            out.set_exception(EngineStoppedError(
                "fleet is stopped, not accepting requests"))
            return out
        route_adapter = adapter or ""
        if adapter:
            from .canary import resolve_adapter

            # key computation only (count=False): the ENGINE is the
            # single resolution/metering authority — it re-resolves with
            # the SAME request key threaded below, so the routing key
            # here and the identity there always agree
            route_adapter = resolve_adapter(adapter, prompt_tokens,
                                            request_key, count=False)
        span = get_tracer().current()
        state = {
            "prompt": list(prompt_tokens),
            "max_new": max_new_tokens, "eos_id": eos_id,
            "sampling": (float(temperature), int(top_k), float(top_p)),
            "max_wait": max_wait,
            "adapter": adapter or "",
            "request_key": request_key,
            "key": self.routing_key(prompt_tokens, adapter=route_adapter),
            "t0": time.perf_counter(),
            "attempts": 0, "tried": [], "tried_decode": [],
            "trace": ((span.trace_id, span.span_id)
                      if span is not None else None),
        }
        with self._lock:
            prev = self._hot_keys.get(state["key"])
            self._hot_keys[state["key"]] = (
                state["prompt"], state["adapter"],
                prev[2] if prev is not None else None)
            self._hot_keys.move_to_end(state["key"])
            while len(self._hot_keys) > self._hot_keys_max:
                self._hot_keys.popitem(last=False)
        if self._prefill:
            self._dispatch_prefill(out, state)
        else:
            self._dispatch_unified(out, state)
        return out

    def generate(self, prompt_tokens, max_new_tokens: int = 64,
                 eos_id: int | None = None, timeout: float = 300.0,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, adapter: str = "",
                 request_key=None):
        return self.submit(prompt_tokens, max_new_tokens, eos_id,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, adapter=adapter,
                           request_key=request_key).result(timeout=timeout)

    # -- adapter source lifecycle ---------------------------------------------
    def add_adapter_source(self, name: str, source):
        """Publish a named adapter on every replica's registry (the
        canary hot-load path) — idempotent for replicas sharing one
        registry."""
        for replica in self.replicas:
            replica.engine.add_adapter_source(name, source)

    def retire_adapter(self, name: str, keep_source: bool = False):
        """Drop an adapter fleet-wide (promotion's old-stable evict / a
        rollback's canary teardown); per-replica in-flight pins finish
        first."""
        for replica in self.replicas:
            replica.engine.retire_adapter(name, keep_source=keep_source)

    def _fail(self, out: Future, state: dict, exc: Exception):
        with self._lock:
            self._stats["failed"] += 1
        if not out.done():
            out.set_exception(exc)

    @staticmethod
    def _merge_timing(state: dict, stats: dict):
        """Fold the fleet's own time attribution into the engine-side
        phase ledger so the end-to-end timing still sums to the
        CLIENT-OBSERVED wall by construction: the prefill replica's ledger
        (riding the KV handoff) and the decode replica's ledger add
        phase-wise,
        the re-dispatch backoff timers land on ``redispatch_backoff``,
        and whatever the engines could not see — dispatch callbacks,
        handoff transfer, a failed attempt's discarded work — is the
        ``network`` remainder (the hop wall minus the server-side
        attributed time)."""
        timing = stats.get("timing")
        if not isinstance(timing, dict):
            return
        timing = dict(timing)
        timing["phases"] = dict(timing.get("phases") or {})
        handoff = state.get("handoff")
        if handoff is not None and getattr(handoff, "timing", None):
            merge_timing(timing, handoff.timing)
        phases = timing["phases"]
        backoff = state.get("backoff_s", 0.0)
        if backoff > 0:
            phases["redispatch_backoff"] = \
                phases.get("redispatch_backoff", 0.0) + backoff
        fetch = state.get("fetch_s", 0.0)
        if fetch > 0:
            phases["fetch"] = phases.get("fetch", 0.0) + fetch
        wall = time.perf_counter() - state["t0"]
        attributed = sum(phases.values())
        gap = wall - attributed
        if gap > 0:
            phases["network"] = phases.get("network", 0.0) + gap
        timing["wall_s"] = max(wall, attributed)
        timing["attribution_closed"] = True
        stats["timing"] = timing

    def _retry_later(self, out: Future, state: dict, redo: Callable,
                     exc: Exception | None = None):
        """Deterministic-jitter backoff off-thread: the done-callback
        runs on a replica's scheduler thread, which must never sleep.
        A server-supplied ``Retry-After`` hint riding the failure
        (``exc.retry_after_s``) wins over the local schedule — the
        replica knows its own drain/recovery timeline better than the
        client's blind exponential. The delay is remembered so the final
        timing attributes it to the ``redispatch_backoff`` phase
        (obs/reqledger.py)."""
        with self._lock:
            self._stats["redispatches"] += 1
        hint = getattr(exc, "retry_after_s", None)
        delay = float(hint) if hint is not None else compute_backoff(
            state["attempts"] - 1, self._retry_policy,
            seed=f"fleet:{state['key']}")
        state["backoff_s"] = state.get("backoff_s", 0.0) + delay
        timer = threading.Timer(delay, redo)
        timer.daemon = True
        timer.start()

    def _no_replica(self, out: Future, state: dict, pool: str):
        with self._lock:
            self._stats["no_replica"] += 1
        FLEET_DISPATCHES.inc(replica="", outcome="no_replica")
        # a jitter-free Retry-After derived from the same schedule the
        # fleet retries on: an upstream honoring it lands just after
        # capacity could have returned, instead of hammering blind
        hint = compute_backoff(
            min(state["attempts"], self.max_dispatch_attempts - 1),
            self._retry_policy, seed="retry-after")
        self._fail(out, state, ReplicaUnavailableError(
            f"no healthy {pool} replica left after "
            f"{state['attempts']} attempt(s) "
            f"(tried {state['tried'] or state['tried_decode']})",
            retry_after_s=hint))

    def _budget_left(self, out: Future, state: dict,
                     exc: Exception) -> bool:
        state["attempts"] += 1
        if state["attempts"] < self.max_dispatch_attempts:
            return True
        self._fail(out, state, exc)
        return False

    # -- cross-replica prefix fetch -------------------------------------------
    def _fetch_source(self, state: dict,
                      target: EngineReplica) -> Optional[EngineReplica]:
        """The replica worth pulling this key's cached pages from before
        dispatching to ``target``: the key's LAST owner, when it is a
        different, healthy replica and both ends speak the fetch
        protocol. One attempt per request — fetch is a warm-up, not a
        retry loop — and only on the first dispatch (a re-dispatch means
        replicas are failing; don't add hops). Affinity routing only: a
        moved key there means the RING moved (scale event), a one-time
        migration worth a hop; under random routing every request lands
        off-owner and the hop would re-ship pages per request."""
        if not self._prefix_fetch or self.routing != "affinity" \
                or state.get("fetch_tried") or state["attempts"]:
            return None
        with self._lock:
            entry = self._hot_keys.get(state["key"])
            owner_id = entry[2] if entry is not None else None
            if owner_id is None or owner_id == target.id:
                return None
            owner = self._workers.get(owner_id) \
                or self._prefill.get(owner_id)
        if owner is None or not owner.healthy:
            return None
        if not hasattr(owner.engine, "fetch_prefix") \
                or not hasattr(target.engine, "import_prefix"):
            return None
        return owner

    def _fetch_then(self, state: dict, owner: EngineReplica,
                    target: EngineReplica, resume: Callable):
        """Pull the request's cached prefix pages out of ``owner`` and
        import them into ``target``, then ``resume()`` the dispatch —
        the request's prefill on the new owner becomes a prefix-cache
        hit instead of a cold re-prefill. ANY failure (chaos-armed
        ``llm.kv_fetch``, a miss on the owner, a stopped engine, an
        import error) falls through to the plain dispatch: fetch is an
        optimization, never a gate on the hot path. The elapsed seconds
        land on the ``fetch`` ledger phase via :meth:`_merge_timing`."""
        state["fetch_tried"] = True
        t0 = time.perf_counter()

        def finish(fetched: bool):
            state["fetch_s"] = state.get("fetch_s", 0.0) \
                + (time.perf_counter() - t0)
            with self._lock:
                self._stats["prefix_fetches" if fetched
                            else "prefix_fetch_fallbacks"] += 1
            self._note_fetch(target.id, fetched)
            if fetched:
                logger.info("fleet prefix fetch", key=state["key"],
                            owner=owner.id, target=target.id)
            resume()

        def on_import(fut: Future):
            try:
                fut.result()
            except Exception:  # noqa: BLE001 - fall back to plain dispatch
                finish(False)
                return
            finish(True)

        def on_fetch(fut: Future):
            try:
                payload = fut.result()
            except Exception:  # noqa: BLE001 - miss/stopped owner
                payload = None
            if payload is None:
                finish(False)
                return
            try:
                with self._lock:
                    self._stats["handoff_bytes"] += payload.nbytes()
                FLEET_HANDOFF_BYTES.inc(payload.nbytes())
                target.engine.import_prefix(payload) \
                    .add_done_callback(on_import)
            except Exception:  # noqa: BLE001 - fall back
                finish(False)

        try:
            # an armed error here models a dead fetch path; an armed
            # delay models a slow pull — both degrade to re-prefill
            fire(FaultPoints.llm_kv_fetch, key=state["key"],
                 owner=owner.id, target=target.id)
            owner.engine.fetch_prefix(
                state["prompt"], adapter=state["adapter"]) \
                .add_done_callback(on_fetch)
        except Exception:  # noqa: BLE001 - fall back to plain dispatch
            finish(False)

    def _note_dispatch(self, replica_id: str, ok: bool):
        """Append one outcome to the replica's sliding window (ok=False
        covers both redispatch and terminal failure — either way the
        replica didn't complete work it was handed)."""
        with self._lock:
            self._dispatch_outcomes.setdefault(
                replica_id, deque(maxlen=64)).append(0 if ok else 1)

    def _note_fetch(self, replica_id: str, fetched: bool):
        with self._lock:
            self._fetch_outcomes.setdefault(
                replica_id, deque(maxlen=64)).append(0 if fetched else 1)

    # unified fleet: one replica runs prefill AND decode
    def _dispatch_unified(self, out: Future, state: dict):
        # dispatch runs on done-callback / Timer threads, where an
        # uncaught raise is swallowed by the Future machinery and the
        # client future hangs to its timeout — a synchronous submit()
        # failure (duck-typed remote replica, bad handoff) must fail the
        # request loudly instead
        try:
            replica = self._pick(self._workers, state["key"],
                                 state["tried"], affinity=True)
            if replica is None:
                self._no_replica(out, state, "fleet")
                return
            owner = self._fetch_source(state, replica)
        except Exception as exc:  # noqa: BLE001 - routed to the client
            self._fail(out, state, exc)
            return
        if owner is not None:
            self._fetch_then(state, owner, replica,
                             lambda: self._submit_unified(
                                 out, state, replica))
            return
        self._submit_unified(out, state, replica)

    def _submit_unified(self, out: Future, state: dict,
                        replica: EngineReplica):
        try:
            state["tried"].append(replica.id)
            inner = replica.engine.submit(
                state["prompt"], max_new_tokens=state["max_new"],
                eos_id=state["eos_id"], temperature=state["sampling"][0],
                top_k=state["sampling"][1], top_p=state["sampling"][2],
                max_wait=state["max_wait"], adapter=state["adapter"],
                request_key=state["request_key"], _trace=state["trace"])
        except Exception as exc:  # noqa: BLE001 - routed to the client
            self._fail(out, state, exc)
            return
        inner.add_done_callback(
            lambda fut: self._unified_done(out, state, replica, fut))

    def _unified_done(self, out: Future, state: dict,
                      replica: EngineReplica, fut: Future):
        exc = fut.exception()
        if exc is None:
            tokens, stats = fut.result()
            self._finalize(out, state, replica, tokens, dict(stats))
            return
        if redispatchable(exc):
            FLEET_DISPATCHES.inc(replica=replica.id, outcome="redispatch")
            self._note_dispatch(replica.id, ok=False)
            logger.warning("fleet re-dispatching request",
                           replica=replica.id, error=str(exc),
                           attempt=state["attempts"] + 1)
            if self._budget_left(out, state, exc):
                # a preempted replica may have exported the decode state
                # (ReplicaPreemptedError.handoff): resume it on a
                # survivor via submit_prefilled instead of re-prefilling
                handoff = getattr(exc, "handoff", None)
                if handoff is not None:
                    state["handoff"] = handoff
                    redo = lambda: self._dispatch_handoff(out, state)  # noqa: E731
                else:
                    redo = lambda: self._dispatch_unified(out, state)  # noqa: E731
                self._retry_later(out, state, redo, exc=exc)
            return
        FLEET_DISPATCHES.inc(replica=replica.id, outcome="failed")
        self._note_dispatch(replica.id, ok=False)
        self._fail(out, state, exc)

    def _dispatch_handoff(self, out: Future, state: dict):
        """Resume a preempted request on a survivor: the dying replica
        exported the decode state as a :class:`KVHandoff` (riding the
        :class:`ReplicaPreemptedError`), so the survivor imports it and
        decodes — no re-prefill, no dropped admitted request."""
        try:
            replica = self._pick(self._workers, state["key"],
                                 state["tried"], affinity=True)
            if replica is None:
                self._no_replica(out, state, "fleet")
                return
            state["tried"].append(replica.id)
            handoff = state["handoff"]
            with self._lock:
                self._stats["handoffs"] += 1
                self._stats["handoff_bytes"] += handoff.nbytes()
            FLEET_HANDOFF_BYTES.inc(handoff.nbytes())
            inner = replica.engine.submit_prefilled(
                handoff, max_new_tokens=state["max_new"],
                eos_id=state["eos_id"], max_wait=state["max_wait"],
                _trace=state["trace"])
        except Exception as exc:  # noqa: BLE001 - routed to the client
            self._fail(out, state, exc)
            return
        inner.add_done_callback(
            lambda fut: self._handoff_done(out, state, replica, fut))

    def _handoff_done(self, out: Future, state: dict,
                      replica: EngineReplica, fut: Future):
        exc = fut.exception()
        if exc is None:
            tokens, stats = fut.result()
            stats = dict(stats)
            handoff = state["handoff"]
            FLEET_HANDOFF_LATENCY.observe(stats.get("ttft_s", 0.0))
            stats["handoff_bytes"] = handoff.nbytes()
            stats["cached_prefix"] = handoff.cached_prefix
            stats["resumed_via_handoff"] = True
            self._finalize(out, state, replica, tokens, stats)
            return
        if redispatchable(exc):
            FLEET_DISPATCHES.inc(replica=replica.id, outcome="redispatch")
            self._note_dispatch(replica.id, ok=False)
            newer = getattr(exc, "handoff", None)
            if newer is not None:
                state["handoff"] = newer
            if self._budget_left(out, state, exc):
                self._retry_later(
                    out, state,
                    lambda: self._dispatch_handoff(out, state), exc=exc)
            return
        FLEET_DISPATCHES.inc(replica=replica.id, outcome="failed")
        self._note_dispatch(replica.id, ok=False)
        self._fail(out, state, exc)

    # disaggregated fleet: prefill pool → KV handoff → decode pool
    def _dispatch_prefill(self, out: Future, state: dict):
        try:
            replica = self._pick(self._prefill, state["key"],
                                 state["tried"], affinity=True)
            if replica is None:
                self._no_replica(out, state, "prefill")
                return
            owner = self._fetch_source(state, replica)
        except Exception as exc:  # noqa: BLE001 - routed to the client
            self._fail(out, state, exc)
            return
        if owner is not None:
            self._fetch_then(state, owner, replica,
                             lambda: self._submit_prefill(
                                 out, state, replica))
            return
        self._submit_prefill(out, state, replica)

    def _submit_prefill(self, out: Future, state: dict,
                        replica: EngineReplica):
        try:
            state["tried"].append(replica.id)
            inner = replica.engine.submit_prefill(
                state["prompt"], eos_id=state["eos_id"],
                temperature=state["sampling"][0],
                top_k=state["sampling"][1], top_p=state["sampling"][2],
                max_wait=state["max_wait"], adapter=state["adapter"],
                request_key=state["request_key"], _trace=state["trace"])
        except Exception as exc:  # noqa: BLE001 - routed to the client
            self._fail(out, state, exc)
            return
        inner.add_done_callback(
            lambda fut: self._prefill_done(out, state, replica, fut))

    def _prefill_done(self, out: Future, state: dict,
                      replica: EngineReplica, fut: Future):
        exc = fut.exception()
        if exc is None:
            handoff = fut.result()
            with self._lock:
                self._stats["handoffs"] += 1
                self._stats["handoff_bytes"] += handoff.nbytes()
            FLEET_HANDOFF_BYTES.inc(handoff.nbytes())
            state["handoff"] = handoff
            self._dispatch_decode(out, state)
            return
        if redispatchable(exc):
            FLEET_DISPATCHES.inc(replica=replica.id, outcome="redispatch")
            self._note_dispatch(replica.id, ok=False)
            if self._budget_left(out, state, exc):
                self._retry_later(
                    out, state,
                    lambda: self._dispatch_prefill(out, state), exc=exc)
            return
        FLEET_DISPATCHES.inc(replica=replica.id, outcome="failed")
        self._note_dispatch(replica.id, ok=False)
        self._fail(out, state, exc)

    def _dispatch_decode(self, out: Future, state: dict):
        try:
            replica = self._pick_decode(state["tried_decode"])
            if replica is None:
                self._no_replica(out, state, "decode")
                return
            state["tried_decode"].append(replica.id)
            inner = replica.engine.submit_prefilled(
                state["handoff"], max_new_tokens=state["max_new"],
                eos_id=state["eos_id"], max_wait=state["max_wait"],
                _trace=state["trace"])
        except Exception as exc:  # noqa: BLE001 - routed to the client
            # e.g. submit_prefilled's synchronous KV-dtype mismatch — this
            # runs inside the prefill future's done-callback, which eats
            # uncaught raises
            self._fail(out, state, exc)
            return
        inner.add_done_callback(
            lambda fut: self._decode_done(out, state, replica, fut))

    def _decode_done(self, out: Future, state: dict,
                     replica: EngineReplica, fut: Future):
        exc = fut.exception()
        if exc is None:
            tokens, stats = fut.result()
            stats = dict(stats)
            handoff = state["handoff"]
            # decode-side ttft is the import+queue cost — the handoff
            # latency; end-to-end TTFT = prefill + handoff
            FLEET_HANDOFF_LATENCY.observe(stats.get("ttft_s", 0.0))
            stats["handoff_s"] = stats.get("ttft_s", 0.0)
            stats["handoff_bytes"] = handoff.nbytes()
            stats["prefill_replica"] = handoff.replica
            stats["prefill_s"] = handoff.prefill_s
            stats["cached_prefix"] = handoff.cached_prefix
            stats["ttft_s"] = handoff.prefill_s + stats["handoff_s"]
            self._finalize(out, state, replica, tokens, stats)
            return
        if redispatchable(exc):
            # the handoff is plain host data — replayable on the next
            # decode replica without touching the prefill pool again; a
            # preempted decode replica may ship back a FRESHER handoff
            FLEET_DISPATCHES.inc(replica=replica.id, outcome="redispatch")
            self._note_dispatch(replica.id, ok=False)
            newer = getattr(exc, "handoff", None)
            if newer is not None:
                state["handoff"] = newer
            if self._budget_left(out, state, exc):
                self._retry_later(
                    out, state,
                    lambda: self._dispatch_decode(out, state), exc=exc)
            return
        FLEET_DISPATCHES.inc(replica=replica.id, outcome="failed")
        self._note_dispatch(replica.id, ok=False)
        self._fail(out, state, exc)

    def _finalize(self, out: Future, state: dict,
                  replica: EngineReplica, tokens, stats: dict):
        stats["replica"] = replica.id
        stats["dispatch_attempts"] = state["attempts"] + 1
        if state.get("adapter"):
            stats["adapter"] = state["adapter"]
        self._merge_timing(state, stats)
        FLEET_DISPATCHES.inc(replica=replica.id, outcome="ok")
        self._note_dispatch(replica.id, ok=True)
        with self._lock:
            # remember WHERE this key's pages now live: the fetch source
            # after the ring moves the key to a different replica.
            # Disaggregated fleets cache on the PREFILL replica, not the
            # decode replica finalizing here
            entry = self._hot_keys.get(state["key"])
            if entry is not None:
                owner_rid = stats.get("prefill_replica") or replica.id
                self._hot_keys[state["key"]] = (entry[0], entry[1],
                                                owner_rid)
            self._stats["dispatches"] += 1
            self._ttft_ring.append(stats.get("ttft_s", 0.0))
            if len(self._ttft_ring) > self._ttft_ring_max:
                del self._ttft_ring[:len(self._ttft_ring)
                                    - self._ttft_ring_max]
        if not out.done():
            out.set_result((tokens, stats))

    # -- observability -------------------------------------------------------
    @property
    def stats(self) -> dict:
        """Fleet-level view: routing counters, aggregate prefix hit rate
        (total hits over total queries — the bench/acceptance number),
        end-to-end TTFT percentiles from the fleet's own ring, and a
        ``per_replica`` breakdown feeding the future autoscaler."""
        from .llm_batch import _percentile

        with self._lock:
            out = dict(self._stats)
            ttfts = sorted(self._ttft_ring)
            replicas = self.replicas
            dispatch_windows = {rid: list(win) for rid, win
                                in self._dispatch_outcomes.items()}
            fetch_windows = {rid: list(win) for rid, win
                             in self._fetch_outcomes.items()}
        out["routing"] = self.routing
        out["replicas"] = len(replicas)
        out["prefill_replicas"] = sum(
            1 for r in replicas if r.role == "prefill")
        hits = queries = completed = depth = 0
        per: dict[str, dict] = {}
        for replica in replicas:
            stats = replica.engine.stats
            hits += stats.get("prefix_hits", 0)
            queries += stats.get("prefix_queries", 0)
            completed += stats.get("completed", 0)
            depth += stats.get("queue_depth", 0)
            # page headroom + live load: the autoscaler's signals
            frac_fn = getattr(replica.engine, "_free_page_frac", None)
            try:
                load = replica.load()
            except Exception:  # noqa: BLE001 - a stopping replica's
                load = 0       # queue may already be torn down
            d_win = dispatch_windows.get(replica.id, ())
            f_win = fetch_windows.get(replica.id, ())
            per[replica.id] = {
                "role": replica.role,
                "draining": replica.draining,
                "joining": replica.joining,
                "weight": replica.weight,
                "health_state": replica.health_state,
                # windowed rates (last 64 outcomes), not lifetime
                # counters — what the health scorer and operators read
                "dispatch_failure_rate": (
                    sum(d_win) / len(d_win) if d_win else 0.0),
                "fetch_fallback_rate": (
                    sum(f_win) / len(f_win) if f_win else 0.0),
                "requests": stats.get("requests", 0),
                "completed": stats.get("completed", 0),
                "queue_depth": stats.get("queue_depth", 0),
                "free_page_frac": frac_fn() if frac_fn else None,
                "load": load,
                "prefix_hit_rate": stats.get("prefix_hit_rate", 0.0),
                "handoffs_out": stats.get("handoffs_out", 0),
                "handoffs_in": stats.get("handoffs_in", 0),
            }
            for key in ("ttft_p50_s", "ttft_p95_s", "decode_tick_p50_s",
                        "decode_tick_p95_s", "prefill_chunks",
                        "prefill_kernel_chunks",
                        "prefill_gather_admissions",
                        "spec_rounds", "spec_proposed", "spec_accepted",
                        "acceptance_rate", "spec_tokens_per_round"):
                if key in stats:
                    per[replica.id][key] = stats[key]
        out["completed"] = completed
        out["queue_depth"] = depth
        out["prefix_hits"] = hits
        out["prefix_queries"] = queries
        out["prefix_hit_rate"] = hits / queries if queries else 0.0
        if ttfts:
            out["ttft_p50_s"] = _percentile(ttfts, 0.50)
            out["ttft_p95_s"] = _percentile(ttfts, 0.95)
        out["per_replica"] = per
        return out
