"""Peer-relative replica health scoring: fail-slow detection — the port's
copy of ``mlrun_tpu/obs/health.py`` (same signals, floors, thresholds and
state machine; ``serving.health`` defaults from the port's config).

At fleet scale the failures that hurt p95 are not crashes but fail-slow
replicas: a throttled or contended replica answers every request
correctly, just 3-10x slower, and the error-path machinery (circuit
breaker, ``redispatchable()`` re-routing) never sees it. This module is a
control loop over signals the fleet already produces:

- **peer-relative, not absolute.** Each signal is scored as a robust z
  against the fleet median, with the MAD (median absolute deviation) as
  the scale, both immune to the outlier dragging the baseline.
- **EWMA + hysteresis.** The per-replica badness is EWMA-smoothed and
  state transitions need consecutive-tick streaks, so one slow tick never
  probates a healthy replica.
- **graduated actuation.** healthy -> suspect (observe only) ->
  probation: the fleet de-weights the replica's ring vnodes
  (``EngineFleet.set_replica_weight``), so traffic shifts gradually with
  minimal key movement. Persistent probation makes it a replacement
  candidate (``pop_replace_due``).

Time is an explicit ``now`` argument to :meth:`ReplicaHealthScorer.tick`:
every drill runs on a fake clock with zero sleeps. The module never reads
a wall clock.
"""

from __future__ import annotations

from ..config import SERVING_HEALTH_DEFAULTS
from ..utils import logger
from . import HEALTH_TRANSITIONS, REPLICA_HEALTH_SCORE, REPLICA_HEALTH_STATE
from .flight import record as flight_record

# (signal key in EngineFleet.stats per_replica, MAD floor). The floor
# bounds the z denominator from below so a near-uniform fleet (MAD ~ 0)
# cannot turn measurement noise into huge z-scores: a replica must
# exceed the median by a *materially meaningful* margin, not a
# statistically tiny one. Floors are in the signal's own units.
SIGNALS = (
    ("ttft_p95_s", 0.005),
    ("decode_tick_p95_s", 0.002),
    ("queue_depth", 2.0),
    ("dispatch_failure_rate", 0.05),
    ("fetch_fallback_rate", 0.10),
)

# robust z-scores are capped so a single grotesque outlier saturates
# instead of poisoning the EWMA for many recovery ticks
_Z_CAP = 16.0

_STATE_VALUES = {"healthy": 0, "suspect": 1, "probation": 2}


def _median(values: list[float]) -> float:
    ordered = sorted(values)
    mid = len(ordered) // 2
    if len(ordered) % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


class _ReplicaState:
    """Per-replica scorer memory across ticks."""

    __slots__ = ("score", "state", "bad", "good", "probation_age",
                 "replace_flagged")

    def __init__(self):
        self.score = None        # EWMA-smoothed badness (None = no tick)
        self.state = "healthy"
        self.bad = 0             # consecutive ticks at/above suspect_z
        self.good = 0            # consecutive ticks below recover_z
        self.probation_age = 0   # ticks spent in probation (cumulative)
        self.replace_flagged = False


class ReplicaHealthScorer:
    """One scorer per :class:`~mlrun_tpu_torch.serving.fleet.EngineFleet`.

    Knobs read the config's ``SERVING_HEALTH_DEFAULTS`` and accept keyword
    overrides; unknown overrides raise.
    """

    def __init__(self, fleet, **overrides):
        def knob(name, cast=float):
            if name in overrides:
                return cast(overrides.pop(name))
            return cast(SERVING_HEALTH_DEFAULTS[name])

        self.fleet = fleet
        self.enabled = knob("enabled", bool)
        self.ewma_alpha = knob("ewma_alpha")
        self.suspect_z = knob("suspect_z")
        self.recover_z = knob("recover_z")
        self.suspect_ticks = knob("suspect_ticks", int)
        self.probation_ticks = knob("probation_ticks", int)
        self.recover_ticks = knob("recover_ticks", int)
        self.probation_weight = knob("probation_weight")
        self.replace_after_ticks = knob("replace_after_ticks", int)
        self.min_peers = knob("min_peers", int)
        if overrides:
            raise ValueError(
                f"unknown health scorer knobs: {sorted(overrides)}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"need 0 < ewma_alpha <= 1, got {self.ewma_alpha}")
        if not 0.0 <= self.recover_z <= self.suspect_z:
            raise ValueError(
                f"need 0 <= recover_z <= suspect_z, got "
                f"{self.recover_z}..{self.suspect_z}")
        if not 0.0 < self.probation_weight <= 1.0:
            raise ValueError(
                f"need 0 < probation_weight <= 1, got "
                f"{self.probation_weight}")
        self._states: dict[str, _ReplicaState] = {}
        self._replace_due: list[str] = []

    # -- introspection -------------------------------------------------------
    def state(self, replica_id: str) -> str:
        entry = self._states.get(replica_id)
        return entry.state if entry is not None else "healthy"

    def score(self, replica_id: str) -> float:
        entry = self._states.get(replica_id)
        return entry.score if entry is not None and \
            entry.score is not None else 0.0

    def pop_replace_due(self):
        """One persistently-probated replica id, or None. The consumer
        (autoscaler) executes the replacement; popping is destructive so
        a replica is handed out exactly once."""
        return self._replace_due.pop(0) if self._replace_due else None

    # -- signal plane --------------------------------------------------------
    def _candidate_rows(self) -> dict[str, dict]:
        """Scoring population: non-draining, non-joining replicas from
        ``fleet.stats`` ``per_replica``. A draining victim or a warming
        joiner is *expected* to look unlike its peers — scoring it would
        both smear the baseline and flag lifecycle as sickness. (The
        reference also fills a process replica's TTFT from its federated
        time-series store; the port has no process replicas yet.)"""
        per = (self.fleet.stats.get("per_replica") or {})
        return {rid: dict(stats) for rid, stats in per.items()
                if not stats.get("draining") and not stats.get("joining")}

    def _raw_scores(self, rows: dict[str, dict]) -> dict[str, float]:
        """Max-over-signals robust z per replica. A signal participates
        only when >= min_peers replicas report it — a 2-replica fleet
        has no meaningful median, and a signal only one engine exports
        must not condemn that engine for being observable."""
        raw = {rid: 0.0 for rid in rows}
        for key, floor in SIGNALS:
            values = {rid: float(row[key]) for rid, row in rows.items()
                      if row.get(key) is not None}
            if len(values) < self.min_peers:
                continue
            med = _median(list(values.values()))
            mad = _median([abs(v - med) for v in values.values()])
            scale = max(1.4826 * mad, floor)
            for rid, value in values.items():
                z = min(max((value - med) / scale, 0.0), _Z_CAP)
                if z > raw[rid]:
                    raw[rid] = z
        return raw

    # -- state machine -------------------------------------------------------
    def _transition(self, rid: str, entry: _ReplicaState, to: str,
                    now: float):
        entry.state = to
        HEALTH_TRANSITIONS.inc(replica=rid, to=to)
        for replica in self.fleet.replicas:
            if replica.id == rid:
                replica.health_state = to
                break

    def _actuate_weight(self, rid: str, weight: float):
        setter = getattr(self.fleet, "set_replica_weight", None)
        if setter is None:
            return
        try:
            setter(rid, weight)
        except KeyError:
            pass  # removed between stats snapshot and actuation

    def tick(self, now: float) -> dict:
        """One scoring pass at ``now``: window the signals, score each
        replica peer-relative, advance the state machines, actuate ring
        weights, and publish gauges. Deterministic — no internal clock
        reads, no sleeps."""
        if not self.enabled:
            return {}
        rows = self._candidate_rows()
        raw = self._raw_scores(rows)
        snapshot: dict[str, dict] = {}
        for rid, raw_score in raw.items():
            entry = self._states.setdefault(rid, _ReplicaState())
            if entry.score is None:
                entry.score = raw_score
            else:
                entry.score = (self.ewma_alpha * raw_score
                               + (1.0 - self.ewma_alpha) * entry.score)
            if entry.score >= self.suspect_z:
                entry.bad += 1
                entry.good = 0
            elif entry.score < self.recover_z:
                entry.good += 1
                entry.bad = 0
            else:
                # hysteresis band: not sick enough to advance, not well
                # enough to recover — freeze the bad streak, reset good
                entry.good = 0
            if entry.state == "healthy" \
                    and entry.bad >= self.suspect_ticks:
                self._transition(rid, entry, "suspect", now)
                flight_record("health.suspect", replica=rid,
                              score=round(entry.score, 3), at=now)
                logger.warning("replica health: suspect", replica=rid,
                               score=entry.score)
            if entry.state == "suspect" and entry.bad >= \
                    self.suspect_ticks + self.probation_ticks:
                self._transition(rid, entry, "probation", now)
                self._actuate_weight(rid, self.probation_weight)
                flight_record("health.probation", replica=rid,
                              score=round(entry.score, 3),
                              weight=self.probation_weight, at=now)
                logger.warning("replica health: probation", replica=rid,
                               score=entry.score,
                               weight=self.probation_weight)
            if entry.state == "probation":
                entry.probation_age += 1
                if entry.probation_age >= self.replace_after_ticks \
                        and not entry.replace_flagged:
                    # persistently sick: hand it to the autoscaler as a
                    # replacement candidate exactly once
                    entry.replace_flagged = True
                    self._replace_due.append(rid)
            if entry.state in ("suspect", "probation") \
                    and entry.good >= self.recover_ticks:
                was_probation = entry.state == "probation"
                self._transition(rid, entry, "healthy", now)
                if was_probation:
                    self._actuate_weight(rid, 1.0)
                entry.bad = 0
                entry.probation_age = 0
                entry.replace_flagged = False
                if rid in self._replace_due:
                    self._replace_due.remove(rid)
                flight_record("health.recovered", replica=rid,
                              score=round(entry.score, 3), at=now)
                logger.info("replica health: recovered", replica=rid,
                            score=entry.score)
            REPLICA_HEALTH_SCORE.set(entry.score, replica=rid)
            REPLICA_HEALTH_STATE.set(_STATE_VALUES[entry.state],
                                     replica=rid)
            snapshot[rid] = {"score": entry.score, "state": entry.state}
        # forget replicas that left the population (drained, removed):
        # their registry series are retired by remove_replica; dropping
        # scorer memory here keeps a churning fleet's state bounded and
        # re-admits a rejoining id with a clean slate
        for rid in [r for r in self._states if r not in raw]:
            self._states.pop(rid)
            if rid in self._replace_due:
                self._replace_due.remove(rid)
            REPLICA_HEALTH_SCORE.remove(replica=rid)
            REPLICA_HEALTH_STATE.remove(replica=rid)
        return snapshot
