"""mlrun_tpu_torch's fail-slow replica scorer (obs/health.py) against
mlrun_tpu's on the CPU, on fake clocks: both scorers are fed the same
per-replica stats on every tick and must agree on every score (within
1e-12), state, ring weight, transition count, flight event and
``pop_replace_due``. The drills are the reference's
(tests/test_replica_health.py): the MAD outlier walking to probation, a
one-tick blip, recovery, replacement exactly once, the min-peers gate,
draining and joining replicas, series retirement, knob validation; then
seeded random stats sequences over six replicas and five signals, the
weighted ring's minimal movement and exact restoration, and the fleet's
windowed failure rates.
"""

import numpy as np
import pytest
from concurrent.futures import Future

from mlrun_tpu import obs as jobs
from mlrun_tpu.obs.flight import get_flight_recorder as jflight
from mlrun_tpu.obs.health import ReplicaHealthScorer as JScorer
from mlrun_tpu.serving import fleet as jfleet
from mlrun_tpu_torch import obs as tobs
from mlrun_tpu_torch.obs.flight import get_flight_recorder as tflight
from mlrun_tpu_torch.obs.health import ReplicaHealthScorer as TScorer
from mlrun_tpu_torch.serving import fleet as tfleet
from tests.torch_registries import registries_left_as_found  # noqa: F401

# (scorer class, obs package, flight recorder getter) per package
PACKAGES = {"jax": (JScorer, jobs, jflight),
            "port": (TScorer, tobs, tflight)}
SCORE_TOL = 1e-12


@pytest.fixture(autouse=True)
def _fresh_state():
    def reset():
        tobs.REGISTRY.reset()
        for getter in (jflight, tflight):
            getter().clear()

    reset()
    yield
    reset()


class _Replica:
    def __init__(self, rid):
        self.id = rid
        self.weight = 1.0
        self.health_state = "healthy"


class _StatsFleet:
    """The fleet surface the scorer reads: ``stats`` with a per_replica
    breakdown, ``replicas``, and the weight setter (a log of weights)."""

    def __init__(self, rids):
        self.replicas = [_Replica(rid) for rid in rids]
        self.rows = {rid: {"draining": False, "joining": False,
                           "ttft_p95_s": 0.010} for rid in rids}
        self.weights = {}

    @property
    def stats(self):
        return {"per_replica": {rid: dict(row)
                                for rid, row in self.rows.items()}}

    def set_replica_weight(self, rid, weight):
        if not any(r.id == rid for r in self.replicas):
            raise KeyError(rid)
        self.weights.setdefault(rid, []).append(weight)
        for replica in self.replicas:
            if replica.id == rid:
                replica.weight = weight


KNOBS = dict(ewma_alpha=1.0, suspect_z=3.0, recover_z=1.5, suspect_ticks=2,
             probation_ticks=1, recover_ticks=2, probation_weight=0.25,
             replace_after_ticks=4, min_peers=3)


class _Pair:
    """One fake fleet and one scorer per package, stepped in lockstep:
    every mutation applies to both fleets, every tick runs both scorers
    and compares everything they expose."""

    def __init__(self, rids, **overrides):
        knobs = {**KNOBS, **overrides}
        self.rids = list(rids)
        self.fleets = {name: _StatsFleet(rids) for name in PACKAGES}
        self.scorers = {name: PACKAGES[name][0](self.fleets[name], **knobs)
                        for name in PACKAGES}
        # transition counts relative to construction: the reference's
        # registry is process-wide and never reset here
        self.base = {name: self._transitions(name) for name in PACKAGES}

    def set(self, rid, key, value):
        for fleet in self.fleets.values():
            fleet.rows[rid][key] = value

    def drop(self, rid):
        for fleet in self.fleets.values():
            del fleet.rows[rid]
            fleet.replicas = [r for r in fleet.replicas if r.id != rid]

    def _transitions(self, name) -> dict:
        family = PACKAGES[name][1].HEALTH_TRANSITIONS
        return {(rid, to): family.value(replica=rid, to=to)
                for rid in self.rids
                for to in ("suspect", "probation", "healthy")}

    def view(self, name, snap) -> dict:
        fleet, scorer = self.fleets[name], self.scorers[name]
        now = self._transitions(name)
        return {
            "states": {rid: scorer.state(rid) for rid in self.rids},
            "snap_states": {rid: v["state"] for rid, v in snap.items()},
            "weights": {rid: list(w) for rid, w in fleet.weights.items()},
            "replica_states": {r.id: r.health_state for r in fleet.replicas},
            "transitions": {key: now[key] - self.base[name][key]
                            for key in now},
        }

    def tick(self, now: float) -> dict:
        snaps = {name: self.scorers[name].tick(now=now) for name in PACKAGES}
        views = {name: self.view(name, snaps[name]) for name in PACKAGES}
        assert views["port"] == views["jax"]
        assert set(snaps["port"]) == set(snaps["jax"])
        for rid in snaps["port"]:
            assert abs(snaps["port"][rid]["score"]
                       - snaps["jax"][rid]["score"]) <= SCORE_TOL
            assert abs(self.scorers["port"].score(rid)
                       - self.scorers["jax"].score(rid)) <= SCORE_TOL
        return snaps["port"]

    def pop_replace_due(self):
        got = {name: self.scorers[name].pop_replace_due()
               for name in PACKAGES}
        assert got["port"] == got["jax"]
        return got["port"]

    def flight(self, rid) -> list:
        kinds = {name: [e["kind"] for e in PACKAGES[name][2]().events(
            kind="health.*") if e.get("replica") == rid]
            for name in PACKAGES}
        assert kinds["port"] == kinds["jax"]
        return kinds["port"]


def test_mad_outlier_walks_to_probation_and_deweights_like_reference():
    pair = _Pair(["hr0", "hr1", "hr2", "hr3"])
    pair.set("hr3", "ttft_p95_s", 0.200)
    snap = pair.tick(1.0)
    assert snap["hr3"]["score"] >= 3.0 and snap["hr0"]["score"] == 0.0
    assert pair.scorers["port"].state("hr3") == "healthy"
    pair.tick(2.0)
    assert pair.scorers["port"].state("hr3") == "suspect"
    assert pair.fleets["port"].weights == {}
    pair.tick(3.0)
    assert pair.scorers["port"].state("hr3") == "probation"
    assert pair.fleets["port"].weights == {"hr3": [0.25]}
    assert tobs.REPLICA_HEALTH_STATE.value(replica="hr3") == 2
    assert tobs.HEALTH_TRANSITIONS.value(replica="hr3", to="probation") == 1
    assert pair.flight("hr3") == ["health.suspect", "health.probation"]


def test_one_tick_blip_never_leaves_healthy_like_reference():
    pair = _Pair(["hb0", "hb1", "hb2", "hb3"])
    pair.set("hb3", "ttft_p95_s", 0.200)
    pair.tick(1.0)
    pair.set("hb3", "ttft_p95_s", 0.010)
    pair.tick(2.0)
    pair.tick(3.0)
    assert pair.scorers["port"].state("hb3") == "healthy"
    assert pair.fleets["port"].weights == {}
    assert tobs.HEALTH_TRANSITIONS.value(replica="hb3", to="suspect") == 0


def test_recovery_restores_weight_and_clears_replace_flag_like_reference():
    pair = _Pair(["hc0", "hc1", "hc2", "hc3"], replace_after_ticks=1)
    pair.set("hc3", "ttft_p95_s", 0.200)
    for now in (1.0, 2.0, 3.0):
        pair.tick(now)
    assert pair.scorers["port"].state("hc3") == "probation"
    pair.set("hc3", "ttft_p95_s", 0.010)
    pair.tick(4.0)
    pair.tick(5.0)
    assert pair.scorers["port"].state("hc3") == "healthy"
    assert pair.fleets["port"].weights["hc3"] == [0.25, 1.0]
    assert pair.pop_replace_due() is None
    assert pair.flight("hc3") == ["health.suspect", "health.probation",
                                  "health.recovered"]


def test_persistent_probation_flags_replacement_once_like_reference():
    pair = _Pair(["hd0", "hd1", "hd2", "hd3"], replace_after_ticks=2)
    pair.set("hd3", "ttft_p95_s", 0.200)
    for now in range(1, 7):
        pair.tick(float(now))
    assert pair.scorers["port"].state("hd3") == "probation"
    assert pair.pop_replace_due() == "hd3"
    assert pair.pop_replace_due() is None
    pair.tick(7.0)
    assert pair.pop_replace_due() is None


def test_min_peers_gates_every_signal_like_reference():
    pair = _Pair(["he0", "he1"])
    pair.set("he1", "ttft_p95_s", 5.0)
    snap = pair.tick(1.0)
    assert snap["he1"]["score"] == 0.0
    assert pair.scorers["port"].state("he1") == "healthy"


@pytest.mark.parametrize("flag", ["draining", "joining"])
def test_lifecycle_replicas_are_not_scored_like_reference(flag):
    pair = _Pair(["hf0", "hf1", "hf2", "hf3"])
    pair.set("hf3", "ttft_p95_s", 0.200)
    pair.set("hf3", flag, True)
    snap = pair.tick(1.0)
    assert "hf3" not in snap
    assert pair.scorers["port"].state("hf3") == "healthy"


def test_vanished_replica_retires_health_series_like_reference():
    pair = _Pair(["hg0", "hg1", "hg2", "hg3"])
    pair.tick(1.0)
    assert tobs.REPLICA_HEALTH_STATE.value(replica="hg3") == 0
    pair.drop("hg3")
    pair.rids.remove("hg3")
    pair.tick(2.0)
    rendered = tobs.REGISTRY.render()
    assert 'mlt_replica_health_state{replica="hg3"}' not in rendered
    assert 'mlt_replica_health_score{replica="hg3"}' not in rendered
    assert 'mlt_replica_health_state{replica="hg0"}' in rendered


@pytest.mark.parametrize("kwargs,match", [
    ({"not_a_knob": 1}, "unknown health scorer knobs"),
    ({"ewma_alpha": 0.0}, "ewma_alpha"),
    ({"suspect_z": 2.0, "recover_z": 3.0}, "recover_z"),
    ({"probation_weight": 0.0}, "probation_weight"),
])
def test_knob_validation_like_reference(kwargs, match):
    for scorer, _, _ in PACKAGES.values():
        with pytest.raises(ValueError, match=match):
            scorer(_StatsFleet(["hv0", "hv1", "hv2"]), **kwargs)


def test_config_defaults_match_reference():
    from mlrun_tpu.config import mlconf
    from mlrun_tpu_torch.config import (
        SERVING_FLEET_DEFAULTS,
        SERVING_HEALTH_DEFAULTS,
    )

    assert SERVING_HEALTH_DEFAULTS == mlconf.serving.health.to_dict()
    fleet = mlconf.serving.fleet.to_dict()
    assert SERVING_FLEET_DEFAULTS == {key: fleet[key]
                                      for key in SERVING_FLEET_DEFAULTS}
    scorers = [scorer(_StatsFleet(["a", "b", "c"]))
               for scorer, _, _ in PACKAGES.values()]
    for knob in SERVING_HEALTH_DEFAULTS:
        assert getattr(scorers[1], knob) == getattr(scorers[0], knob)


SIGNALS = ("ttft_p95_s", "decode_tick_p95_s", "queue_depth",
           "dispatch_failure_rate", "fetch_fallback_rate")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_stats_sequences_score_like_reference(seed):
    """Seeded stats over 40 ticks, six replicas and all five signals (a
    slow replica, noise, missing signals, a draining spell, a replica
    leaving and rejoining), with the default EWMA and streaks: every tick
    agrees, scores within 1e-12."""
    rng = np.random.default_rng(seed)
    rids = [f"rs{i}" for i in range(6)]
    pair = _Pair(rids, ewma_alpha=0.5, probation_ticks=2,
                 replace_after_ticks=6)
    slow = rids[int(rng.integers(6))]
    base = {"ttft_p95_s": 0.02, "decode_tick_p95_s": 0.03,
            "queue_depth": 1.0, "dispatch_failure_rate": 0.0,
            "fetch_fallback_rate": 0.0}
    gone = None
    states = set()
    for tick in range(40):
        for rid in pair.fleets["port"].rows:
            for key in SIGNALS:
                if rng.random() < 0.1:
                    pair.set(rid, key, None)
                    continue
                value = base[key] * (1.0 + 0.3 * rng.random()) \
                    + (0.05 * rng.random() if "rate" in key else 0.0)
                if rid == slow and 8 <= tick < 28:
                    value *= 8.0 if "rate" not in key else 1.0
                    if "rate" in key:
                        value += 0.5
                pair.set(rid, key, float(value))
            pair.set(rid, "draining", bool(rid == rids[1]
                                           and 12 <= tick < 15))
        if tick == 20:
            gone = rids[2]
            pair.drop(gone)
        snap = pair.tick(float(tick))
        states |= {v["state"] for v in snap.values()}
        pair.pop_replace_due()
        pair.flight(slow)
    assert "suspect" in states or "probation" in states


# -- the weighted ring ---------------------------------------------------------

def _ownership(ring, keys):
    return {key: ring.lookup(key) for key in keys}


@pytest.mark.parametrize("weight", [0.25, 0.5])
def test_ring_deweight_moves_only_victim_keys_like_reference(weight):
    keys = list(range(0, 2 ** 63, 2 ** 63 // 512))
    seen = []
    for module in (jfleet, tfleet):
        ring = module.ConsistentHashRing(vnodes=64)
        for node in ("w0", "w1", "w2", "w3"):
            ring.add(node)
        before = _ownership(ring, keys)
        ring.add("w2", weight=weight)
        during = _ownership(ring, keys)
        ring.add("w2", weight=1.0)
        seen.append((before, during, _ownership(ring, keys),
                     ring.weight("w2")))
    assert seen[1] == seen[0]
    before, during, restored, _ = seen[1]
    moved = [k for k in keys if during[k] != before[k]]
    assert moved and all(before[k] == "w2" and during[k] != "w2"
                         for k in moved)
    assert restored == before


# -- the fleet's windowed rates --------------------------------------------------

class _InstantEngine:
    page_size = 8

    def __init__(self):
        self.replica = ""
        self._slot_state = ()

    def _queue_depth(self):
        return 0

    def start(self):
        pass

    def stop(self, timeout=10.0):
        pass

    def submit(self, prompt, adapter="", **kwargs):
        future = Future()
        future.set_result((list(prompt)[:1], {"ttft_s": 0.001}))
        return future

    @property
    def stats(self):
        return {"requests": 0, "completed": 0, "queue_depth": 0}


def test_per_replica_rates_are_windowed_like_reference():
    rows = []
    for module in (jfleet, tfleet):
        fleet = module.EngineFleet(lambda role: _InstantEngine(), replicas=1,
                                   route_block_tokens=8)
        try:
            rid = fleet.replicas[0].id
            fleet._note_dispatch(rid, ok=False)
            fleet._note_dispatch(rid, ok=True)
            fleet._note_fetch(rid, fetched=True)
            fleet._note_fetch(rid, fetched=False)
            first = fleet.stats["per_replica"][rid]
            for _ in range(64):
                fleet._note_dispatch(rid, ok=True)
            later = fleet.stats["per_replica"][rid]
        finally:
            fleet.stop()
        rows.append([(row["dispatch_failure_rate"],
                      row["fetch_fallback_rate"], row["health_state"],
                      row["weight"]) for row in (first, later)])
    assert rows[1] == rows[0]
    assert rows[1][0][:2] == (0.5, 0.5) and rows[1][1][0] == 0.0
