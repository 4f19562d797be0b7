"""Metrics-driven fleet autoscaler — the port's own copy of
``mlrun_tpu/service/autoscaler.py`` (same signals, thresholds, hysteresis,
cooldowns, bounds, victim choice and journal, so the same signal sequence
gives the same actions in both packages).

A recommendation loop over the federated signals — per-replica load
(queued + active work), KV-page headroom, fleet p95 TTFT, dispatch
failures — drives ``EngineFleet.add_replica`` / drain-and-remove, or,
with ``pods=``, the serving pod fleet's JobSets. GPU serving economics
hinge on keeping the fleet sized to traffic (idle replicas burn
card-hours; an undersized fleet burns the latency SLO), so the loop is
deliberately conservative:

- **hysteresis** — a condition must hold for ``hysteresis_ticks``
  consecutive ticks before it becomes a recommendation;
- **cooldowns** — per-direction minimum spacing between applied actions
  (scale-down cools longer than scale-up);
- **bounds** — ``min_replicas`` / ``max_replicas`` clamp the worker pool;
- **drain-first scale-down** — the victim is drained (no new routing,
  ring keys move to neighbors) and only removed once its in-flight work
  hits zero or ``drain_grace_s`` expires; its ``replica``-labelled series
  go with it;
- **dry-run** — the default mode evaluates everything and records only
  ``mlt_autoscaler_recommendations_total{action,reason}``; flip
  ``dry_run=False`` to act.

Every tick fires the ``obs.autoscale`` chaos point with a mutable
``box``: an ``action()`` can overwrite ``box["action"]`` /
``box["reason"]`` and set ``box["force"]=True`` to bypass hysteresis and
cooldown. Time is an explicit ``now`` argument to :meth:`tick`. The knobs
default to ``config.SERVING_AUTOSCALE_DEFAULTS``.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..chaos import FaultPoints, fire
from ..common.journal import open_journal
from ..config import SERVING_AUTOSCALE_DEFAULTS
from ..obs import (
    AUTOSCALER_ACTIONS,
    AUTOSCALER_DESIRED,
    AUTOSCALER_RECOMMENDATIONS,
    JOURNAL_WRITES,
    RECONCILE_ACTIONS,
)
from ..obs.flight import record as flight_record
from ..utils import logger

_WORKER_ROLES = ("unified", "decode")


class FleetAutoscaler:
    """One autoscaler per :class:`~mlrun_tpu_torch.serving.fleet.EngineFleet`.

    ``store`` (an ``obs.TimeSeriesStore``) upgrades the p95-TTFT signal
    from the fleet's in-process sample ring to the federated windowed
    quantile; ``aggregator`` (an ``obs.MetricsAggregator``) upgrades
    queue depth / page headroom to the merged multi-source view. Both
    are optional — without them the loop runs off ``fleet.stats`` alone,
    so a single-process fleet needs no federation plumbing.
    """

    def __init__(self, fleet, store=None, aggregator=None,
                 slo=None, ttft_window: float = 60.0, pods=None,
                 journal=None, scorer=None, **overrides):
        def knob(name, cast=float):
            if name in overrides:
                return cast(overrides.pop(name))
            return cast(SERVING_AUTOSCALE_DEFAULTS[name])

        self.fleet = fleet
        self.store = store
        self.aggregator = aggregator
        # fail-slow detection (obs/health.py ReplicaHealthScorer): when
        # set, the scorer ticks on this loop's clock, probated replicas
        # are preferred scale-down victims, and persistent probation
        # triggers a drain-and-replace through the normal lifecycle
        self.scorer = scorer
        # cross-process elasticity (serving/podfleet.ServingPodFleet):
        # when set, scale actions submit/drain serving JobSets instead
        # of building in-process replicas, and every tick advances the
        # pod lifecycle state machine
        self.pods = pods
        self.dry_run = knob("dry_run", bool)
        self.min_replicas = knob("min_replicas", int)
        self.max_replicas = knob("max_replicas", int)
        self.hysteresis_ticks = knob("hysteresis_ticks", int)
        self.cooldown_up_s = knob("cooldown_up_s")
        self.cooldown_down_s = knob("cooldown_down_s")
        self.drain_grace_s = knob("drain_grace_s")
        self.queue_high = knob("queue_high")
        self.queue_low = knob("queue_low")
        self.free_page_frac_low = knob("free_page_frac_low")
        self.failure_rate_high = knob("failure_rate_high")
        ttft_high = knob("ttft_p95_high_s")
        if ttft_high <= 0 and slo is not None:
            ttft_high = float(slo.target)
        self.ttft_p95_high_s = ttft_high  # <= 0 disables the signal
        self.ttft_window = float(ttft_window)
        if overrides:
            raise ValueError(
                f"unknown autoscaler knobs: {sorted(overrides)}")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")
        self._lock = threading.Lock()
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_at: Optional[float] = None
        self._draining: dict[str, float] = {}   # replica id -> drain t0
        self._last_dispatch_counts: Optional[dict] = None
        # durable journal + conservative restart (docs/fault_tolerance.md
        # "Control-plane crash recovery"): a prior incarnation's journal
        # arms BOTH cooldowns on the first tick, so a reboot can never
        # cause a scale flap. Streaks restart at zero above; the
        # below_min floor repair stays forced, so it is never delayed.
        self._journal = journal if journal is not None \
            else open_journal("autoscaler")
        self._boot_cooldown_pending = False
        if self._journal is not None:
            prior = [r for r in self._journal.replay()
                     if r.get("kind") == "autoscaler"]
            if prior:
                self._boot_cooldown_pending = True
                last_mode = next(
                    (bool(r["dry_run"]) for r in reversed(prior)
                     if "dry_run" in r), None)
                if last_mode is not None and last_mode != self.dry_run:
                    logger.warning(
                        "autoscaler dry-run mode changed across restart",
                        was_dry_run=last_mode, now_dry_run=self.dry_run)
            # one boot record per incarnation is all recovery needs —
            # compact the applied-action history away at boot
            self._journal.compact([{"kind": "autoscaler", "op": "boot",
                                    "dry_run": self.dry_run}])

    # -- signal plane --------------------------------------------------------
    def _workers(self):
        return [r for r in self.fleet.replicas
                if r.role in _WORKER_ROLES and not r.draining]

    def _worker_role(self) -> str:
        return "decode" if any(r.role == "prefill"
                               for r in self.fleet.replicas) else "unified"

    def signals(self, now: float, advance: bool = False) -> dict:
        """The aggregated decision inputs at ``now`` (also the chaos
        context, so an injected action can assert what the loop saw).
        The dispatch-failure rate is a delta since the last baseline;
        only :meth:`tick` passes ``advance=True`` to move it — an
        out-of-band status read must not zero the next tick's window."""
        stats = self.fleet.stats
        # fleet.stats already walked every replica's load() (and eats a
        # dying replica's errors) — read it, don't walk the engines a
        # second time per tick
        worker_stats = [per for per in
                        (stats.get("per_replica") or {}).values()
                        if per.get("role") in _WORKER_ROLES
                        and not per.get("draining")]
        count = len(worker_stats)
        loads = [per.get("load") or 0 for per in worker_stats]
        if self.aggregator is not None:
            # merged multi-source view, minus the local replicas that
            # are NOT scale targets (prefill pool, draining victims) —
            # their gauges must not inflate the per-worker load or pin
            # an exhausted page pool into the min (the fallback branch
            # below filters by role/draining the same way; remote
            # replicas' series pass through untouched)
            excluded = {r.id for r in self.fleet.replicas
                        if r.draining or r.role not in _WORKER_ROLES}
            queue_total = 0.0
            contributing = set()
            for labels, value in self.aggregator.family(
                    "mlt_llm_queue_depth", now).items():
                rid = dict(labels).get("replica")
                if rid in excluded:
                    continue
                queue_total += value
                contributing.add(rid)
            fracs = [value for labels, value in self.aggregator.family(
                "mlt_llm_free_page_frac", now).items()
                if dict(labels).get("replica") not in excluded]
            free_frac = min(fracs) if fracs else None
            load_total = max(float(sum(loads)), queue_total)
            # the federated queue total may include REMOTE replicas'
            # series — per-replica load divides by every replica that
            # contributed, not just the local workers, or remote load
            # reads as local overload
            serving = max(count, len(contributing))
        else:
            load_total = float(sum(loads))
            serving = count
            fracs = [per["free_page_frac"]
                     for per in stats.get("per_replica", {}).values()
                     if per.get("free_page_frac") is not None
                     and per.get("role") in _WORKER_ROLES
                     and not per.get("draining")]
            free_frac = min(fracs) if fracs else None
        ttft_p95 = None
        if self.store is not None:
            ttft_p95 = self.store.quantile(
                "mlt_llm_ttft_seconds", 0.95, self.ttft_window, now)
        if ttft_p95 is None:
            ttft_p95 = stats.get("ttft_p95_s")
        counts = {key: stats.get(key, 0)
                  for key in ("dispatches", "redispatches", "failed",
                              "no_replica")}
        last = self._last_dispatch_counts or counts
        if advance:
            self._last_dispatch_counts = counts
        bad = max(0, (counts["failed"] - last["failed"])
                  + (counts["no_replica"] - last["no_replica"]))
        total = max(0, sum(counts.values()) - sum(last.values()))
        out = {
            "replicas": count,
            "draining": len(self._draining),
            "load_total": load_total,
            "load_per_replica": load_total / serving if serving else 0.0,
            "free_page_frac_min": free_frac,
            "ttft_p95_s": ttft_p95,
            "dispatch_failure_rate": bad / total if total else 0.0,
        }
        if self.pods is not None:
            # capacity already on its way into the ring — a pod takes
            # ticks to warm and join, and the loop must not stack
            # scale-ups while one is in flight
            out["pods_pending"] = self.pods.pending_count()
        return out

    # -- decision loop -------------------------------------------------------
    def _evaluate(self, sig: dict) -> tuple[str, str]:
        """Raw (action, reason) from thresholds — before hysteresis,
        cooldown, and bounds."""
        # capacity repair: a preempted pod dropped the fleet below its
        # floor — replace it regardless of load (tick() treats this as
        # forced: hysteresis and cooldown are for demand decisions, not
        # for repairing paid-for minimum capacity)
        if sig["replicas"] + sig.get("pods_pending", 0) \
                < self.min_replicas:
            return "up", "below_min"
        reasons = []
        if sig["load_per_replica"] > self.queue_high:
            reasons.append("queue_depth")
        frac = sig["free_page_frac_min"]
        if frac is not None and frac < self.free_page_frac_low:
            reasons.append("kv_pressure")
        ttft = sig["ttft_p95_s"]
        if self.ttft_p95_high_s > 0 and ttft is not None \
                and ttft > self.ttft_p95_high_s:
            reasons.append("ttft_slo")
        if sig["dispatch_failure_rate"] > self.failure_rate_high:
            reasons.append("dispatch_failures")
        if reasons:
            return "up", "+".join(reasons)
        # scale-down keys on live load only: the p95 signal is
        # backward-looking (windowed or ring history), and an empty
        # queue means nothing is currently suffering — hysteresis plus
        # the down-cooldown damp any flap
        if sig["load_per_replica"] < self.queue_low \
                and not sig["draining"]:
            return "down", "idle"
        return "hold", ""

    def _cooled(self, action: str, now: float) -> bool:
        if self._last_action_at is None:
            return True
        cooldown = (self.cooldown_up_s if action == "up"
                    else self.cooldown_down_s)
        return now - self._last_action_at >= cooldown

    def tick(self, now: float) -> dict:
        """One evaluation: gather signals, decide, (maybe) act, and
        advance draining replicas toward removal. Deterministic — no
        internal clock reads, no sleeps."""
        with self._lock:
            if self._boot_cooldown_pending:
                # conservative-restart contract: cooldowns are assumed
                # ACTIVE at boot and anchor to the first post-restart
                # tick (the clock arrives here, not in __init__)
                self._boot_cooldown_pending = False
                self._last_action_at = now
                RECONCILE_ACTIONS.inc(controller="autoscaler",
                                      action="cooldown_armed")
                flight_record("reconcile.autoscaler",
                              action="cooldown_armed", at=now)
            if self.pods is not None:
                # advance the pod lifecycle FIRST so the signals below
                # see fresh ring membership (a preempted pod is already
                # out, a warmed pod already joined)
                self.pods.tick(now)
                # level-triggered drain adoption: the draining set is
                # re-derived from the pod fleet every tick, so a
                # restarted autoscaler resumes interrupted drains
                # through its normal sweep instead of replaying them
                for rid in self.pods.draining_rids():
                    if rid not in self._draining:
                        self._draining[rid] = now
                        RECONCILE_ACTIONS.inc(controller="autoscaler",
                                              action="adopt_drain")
            if self.scorer is not None:
                # score BEFORE signals: a probated replica's ring weight
                # drops here, so this tick's routing already shifts
                self.scorer.tick(now)
            sig = self.signals(now, advance=True)
            action, reason = self._evaluate(sig)
            box = {"action": action, "reason": reason, "force": False}
            fire(FaultPoints.obs_autoscale, box=box, signals=sig, now=now)
            action, reason = box["action"], box["reason"]
            forced = bool(box["force"]) or reason == "below_min"

            if action == "up":
                self._up_streak += 1
                self._down_streak = 0
            elif action == "down":
                self._down_streak += 1
                self._up_streak = 0
            else:
                self._up_streak = self._down_streak = 0

            current = sig["replicas"]
            pending = sig.get("pods_pending", 0)
            streak = (self._up_streak if action == "up"
                      else self._down_streak)
            recommended = action != "hold" and (
                forced or streak >= self.hysteresis_ticks)
            bounded = recommended and (
                (action == "up"
                 and current + pending < self.max_replicas)
                or (action == "down" and current > self.min_replicas))
            desired = current
            if bounded:
                desired = current + (1 if action == "up" else -1)
            if recommended:
                AUTOSCALER_RECOMMENDATIONS.inc(
                    action=action if bounded
                    else f"{action}_at_bound", reason=reason)
            AUTOSCALER_DESIRED.set(desired)

            acted = None
            if bounded and not self.dry_run and (
                    forced or self._cooled(action, now)):
                acted = self._act(action, now)
            removed = self._sweep_draining(now)
            if acted is None:
                replaced = self._replace_degraded(now)
                if replaced is not None:
                    acted = replaced
        return {"action": action, "reason": reason, "recommended":
                recommended, "desired": desired, "current": current,
                "acted": acted, "removed": removed, "forced": forced,
                "signals": sig, "dry_run": self.dry_run}

    def _replace_degraded(self, now: float) -> Optional[dict]:
        """Drain one persistently-probated replica (fail-slow
        replacement, obs/health.py). Deliberately a *repair*, not a
        demand decision: it runs regardless of cooldown, one replica at
        a time, and never while another drain is in flight. Removal
        drops the fleet to (or below) its floor momentarily — the
        forced ``below_min`` path resubmits the replacement capacity on
        the next tick, which pre-warm makes cheap."""
        if self.scorer is None or self.dry_run or self._draining:
            return None
        rid = self.scorer.pop_replace_due()
        if rid is None:
            return None
        if not any(r.id == rid for r in self.fleet.replicas):
            return None  # probated replica already left the fleet
        # the decision is recorded BEFORE the drain so the flight chain
        # reads causally: health.probation -> health.replace -> pod.drain
        flight_record("health.replace", replica=rid, at=now)
        if self.pods is not None and self.pods.owns(rid):
            self.pods.drain(rid, now)
        else:
            self.fleet.drain_replica(rid)
        self._draining[rid] = now
        AUTOSCALER_ACTIONS.inc(action="drain")
        self._journal_append(op="act", action="replace_degraded",
                             replica=rid, at=now)
        logger.warning("autoscaler replacing degraded replica",
                       replica=rid)
        return {"action": "replace_degraded", "replica": rid}

    def _act(self, action: str, now: float) -> Optional[dict]:
        if action == "up":
            if self.pods is not None:
                # cross-process: submit a serving JobSet; the pod joins
                # the ring ticks later, after pre-warm + readiness
                pod = self.pods.scale_up(self._worker_role(), now)
                AUTOSCALER_ACTIONS.inc(action="add")
                self._last_action_at = now
                self._up_streak = 0
                self._journal_append(op="act", action="add", pod=pod,
                                     at=now)
                logger.info("autoscaler submitted serving pod", pod=pod)
                return {"action": "add", "pod": pod}
            rid = self.fleet.add_replica(self._worker_role())
            AUTOSCALER_ACTIONS.inc(action="add")
            self._last_action_at = now
            self._up_streak = 0
            self._journal_append(op="act", action="add", replica=rid,
                                 at=now)
            logger.info("autoscaler added replica", replica=rid)
            return {"action": "add", "replica": rid}
        victim = self._scale_down_victim()
        if victim is None:
            return None
        if self.pods is not None and self.pods.owns(victim.id):
            # drain-before-delete through the pod's /__drain__ path;
            # the sweep deletes the JobSet once in-flight work drains
            self.pods.drain(victim.id, now)
        else:
            self.fleet.drain_replica(victim.id)
        self._draining[victim.id] = now
        AUTOSCALER_ACTIONS.inc(action="drain")
        self._last_action_at = now
        self._down_streak = 0
        self._journal_append(op="act", action="drain",
                             replica=victim.id, at=now)
        logger.info("autoscaler draining replica", replica=victim.id)
        return {"action": "drain", "replica": victim.id}

    def _journal_append(self, **fields):
        if self._journal is None:
            return
        ok = self._journal.append("autoscaler", **fields)
        JOURNAL_WRITES.inc(journal="autoscaler",
                           outcome="ok" if ok else "failed")

    def _scale_down_victim(self):
        """Least-loaded non-draining worker — the cheapest replica to
        take out of rotation (its keyspace moves to ring neighbors; its
        few in-flight requests finish during the drain). A probated
        (fail-slow) replica is preferred over ANY load ordering: if the
        fleet is shedding capacity anyway, shed the sick capacity."""
        workers = self._workers()
        if len(workers) <= self.min_replicas:
            return None

        def load_of(replica):
            try:
                return replica.load()
            except Exception:  # noqa: BLE001
                return 0

        def probated(replica):
            return getattr(replica, "health_state",
                           "healthy") == "probation"

        return min(workers, key=lambda r: (0 if probated(r) else 1,
                                           load_of(r), r.id))

    def _sweep_draining(self, now: float) -> list[str]:
        """Remove drained replicas whose in-flight work hit zero (or
        whose grace expired). The engine stop retires its own
        ``replica``-labeled series — asserted in tests; see
        serving/fleet.py remove_replica."""
        removed = []
        for rid, since in list(self._draining.items()):
            replica = next((r for r in self.fleet.replicas
                            if r.id == rid), None)
            if replica is None:
                self._draining.pop(rid)
                continue
            try:
                busy = replica.load() > 0
            except Exception:  # noqa: BLE001
                busy = False
            if busy and now - since < self.drain_grace_s:
                continue
            self.fleet.remove_replica(rid)
            if self.pods is not None:
                # delete the drained pod's JobSet + retire its series
                self.pods.on_replica_removed(rid)
            if self.store is not None:
                # the engine retires its registry series on stop; the
                # windowed store keeps its own rings, so retire the
                # removed replica's series here too — a churning fleet
                # must not fill the store's series budget with dead ids
                self.store.drop_series(labels={"replica": rid})
            AUTOSCALER_ACTIONS.inc(action="remove")
            self._draining.pop(rid)
            removed.append(rid)
            logger.info("autoscaler removed drained replica", replica=rid)
        return removed
