"""mlrun_tpu_torch's serving pod fleet (serving/podfleet.py), its JobSet
provider (service/providers.py) and the autoscaler's pod hooks
(service/autoscaler.py) against mlrun_tpu's, over the in-memory cluster
of ``tests/fake_k8s.py``.

First the reference's drills on the reference's fake engines
(``tests/test_fleet_elastic._FakeEngine``: instant futures, a prefix index
fed by ``register_prefix`` imports, parked decodes): the full lifecycle
(scale-up, pre-warm, join, preemption mid-decode with a handoff
re-dispatch, the replacement's pre-warmed first hit, a forced scale-up
and a drained scale-down), a readiness flap, a failed pre-warm, an
unreachable drain endpoint, the three restart drills (mid scale-up, mid
drain, an interrupted delete), unknown JobSets, and a probated pod
replaced through drain, delete and below-min repair. Each package runs
the same script on its own cluster; the per-tick phases and decisions,
the flight recorder's pod / reconcile / health chain, the cluster's
verbs, the journal's records, the served tokens and the control-plane
families of the registry must be equal.

Then real paged engines at ``tiny_llama`` size in float32 (TF32 off,
max_len 64, 2 slots, page 8), fed the same converted weights: a pod joins
a one-replica fleet, its pre-warm fetches the moved hot key's pages from
the owner (a prefix hit on the new pod), a preempted pod's in-flight
decodes resume on the survivor from their KV handoffs, and the scale-down
retires every series of the removed replica. Token streams are equal
token for token between the packages and equal to a lone engine's, after
a top-2 margin above 1e-3 is asserted.

Time: every transition takes an explicit ``now``; nothing sleeps. Both
packages' fleet-id sequences restart per test, so pod names and replica
ids agree.
"""

import itertools
import json
import types
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu import chaos as jchaos
from mlrun_tpu import obs as jobs
from mlrun_tpu.common import journal as jjournal
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.obs import health as jhealth
from mlrun_tpu.serving import fleet as jfleet
from mlrun_tpu.serving import paged as jpaged
from mlrun_tpu.serving import podfleet as jpodfleet
from mlrun_tpu.service import autoscaler as jautoscaler
from mlrun_tpu.service import runtime_handlers as jhandlers
from mlrun_tpu_torch import chaos as tchaos
from mlrun_tpu_torch import obs as tobs
from mlrun_tpu_torch.common import journal as tjournal
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.obs import health as thealth
from mlrun_tpu_torch.serving import fleet as tfleet
from mlrun_tpu_torch.serving import paged as tpaged
from mlrun_tpu_torch.serving import podfleet as tpodfleet
from mlrun_tpu_torch.service import autoscaler as tautoscaler
from mlrun_tpu_torch.service import providers as tproviders

from . import fake_k8s
from .test_fleet_elastic import _FakeEngine
from tests.torch_registries import registries_left_as_found  # noqa: F401

PKGS = {
    "jax": types.SimpleNamespace(
        fleet=jfleet, podfleet=jpodfleet, autoscaler=jautoscaler,
        chaos=jchaos, obs=jobs, journal=jjournal, health=jhealth,
        provider=jhandlers.KubernetesProvider),
    "port": types.SimpleNamespace(
        fleet=tfleet, podfleet=tpodfleet, autoscaler=tautoscaler,
        chaos=tchaos, obs=tobs, journal=tjournal, health=thealth,
        provider=tproviders.KubernetesProvider),
}
# the control plane's families, compared line for line across registries
FAMILIES = ("mlt_fleet_pod_", "mlt_autoscaler_", "mlt_reconcile_actions",
            "mlt_journal_writes", "mlt_replica_health_state")
# flight-record fields that are facts, not wall clocks
FIELDS = ("pod", "replica", "jobset", "role", "joined", "prewarmed", "warm",
          "replayed_keys", "fetched_keys", "handoff", "prompt_len",
          "reason", "phase", "controller", "adopted", "resumed",
          "orphaned", "unknown", "action", "drill", "to")


def _reset():
    for pkg in PKGS.values():
        pkg.chaos.chaos.clear()
        pkg.obs.REGISTRY.reset()
        pkg.obs.get_flight_recorder().clear()


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = False
    _reset()
    yield
    _reset()


def _restart_ids(monkeypatch):
    for module in (jfleet, tfleet):
        monkeypatch.setattr(module, "_FLEET_SEQUENCE", itertools.count(1))


def _cluster(pkg, monkeypatch):
    """A fresh fake cluster and this package's provider over it."""
    cluster = fake_k8s.install(monkeypatch)
    return cluster, pkg.provider(namespace="testns")


def _fleet(pkg, replicas=1, engine=_FakeEngine, **kwargs):
    created = []

    def factory(role):
        made = engine()
        created.append(made)
        return made

    fleet = pkg.fleet.EngineFleet(factory, replicas=replicas,
                                  route_block_tokens=8, backoff=0.001,
                                  **kwargs)
    return fleet, factory, created


def _pods(pkg, fleet, provider, factory, **kwargs):
    """A pod fleet of one-GPU pods (the reference sizes a pod by TPU
    topology, the port by GPUs)."""
    size = {"gpus_per_node": 1} if pkg is PKGS["port"] \
        else {"topology": "1x1"}
    return pkg.podfleet.ServingPodFleet(fleet, provider, factory, **size,
                                        **kwargs)


def _scaler(pkg, fleet, pods, **overrides):
    knobs = dict(dry_run=False, min_replicas=2, max_replicas=4,
                 hysteresis_ticks=1, cooldown_up_s=0.0, cooldown_down_s=0.0,
                 drain_grace_s=5.0, queue_low=0.0, queue_high=1e9)
    knobs.update(overrides)
    return pkg.autoscaler.FleetAutoscaler(fleet, pods=pods, **knobs)


def _flight(pkg, prefixes=("pod.", "reconcile.", "fleet.crash", "health.")):
    return [{k: e[k] for k in ("kind",) + FIELDS if k in e}
            for e in pkg.obs.get_flight_recorder().events()
            if e["kind"].startswith(prefixes)]


def _families(pkg) -> list:
    """The control plane's samples; of the pre-warm wall histogram only
    its count (its buckets and sum are wall clocks)."""
    return sorted(line for line in pkg.obs.REGISTRY.render().splitlines()
                  if line.startswith(FAMILIES) and not line.startswith(
                      ("mlt_fleet_pod_prewarm_seconds_bucket",
                       "mlt_fleet_pod_prewarm_seconds_sum")))


def _decision(d: dict) -> tuple:
    return (d["action"], d["reason"], d["recommended"], d["desired"],
            d["current"], d["acted"], d["removed"], d["forced"],
            d["signals"])


def _force(box_action):
    def action(point, context):
        context["box"].update(action=box_action, reason="injected",
                              force=True)
    return action


def _chain_ordered(kinds, chain):
    cursor = 0
    for kind in chain:
        cursor = kinds.index(kind, cursor) + 1


def _both(drill, monkeypatch, *args):
    """Run ``drill`` on each package (fresh ids, fresh cluster) and return
    {name: trace}; the traces must be equal."""
    got = {}
    for name, pkg in PKGS.items():
        _restart_ids(monkeypatch)
        got[name] = drill(pkg, monkeypatch, *args)
    assert got["port"] == got["jax"]
    return got["port"]


# -- the fleet hooks a pod stands on (test_fleet_elastic.py:173-284) ---------

def _fleet_hooks(pkg, monkeypatch):
    from .test_fleet_elastic import _FakeHandoff

    fleet, _, created = _fleet(pkg, replicas=2)
    rid = fleet.add_replica("unified", joined=False)
    out = [sorted(fleet._ring.nodes()),
           fleet.stats["per_replica"][rid]["joining"],
           [fleet.submit([i] * 16).result(timeout=10)[1]["replica"]
            for i in range(8)]]
    with pkg.chaos.chaos.inject("fleet.join", pkg.chaos.fail_first(1),
                                error=RuntimeError("join torn")):
        with pytest.raises(RuntimeError, match="join torn"):
            fleet.join_replica(rid)
        out.append(rid in fleet._ring.nodes())
        fleet.join_replica(rid)
    out.append(sorted(fleet._ring.nodes()))
    with pytest.raises(KeyError):
        fleet.join_replica("nope")
    prompts = [list(range(i, i + 24)) for i in range(0, 320, 10)]
    for prompt in prompts:
        fleet.submit(prompt).result(timeout=10)
    out.append(fleet.reassigned_hot_keys("candidate-x"))
    # a preempted decode resumes on a survivor from its handoff
    prompt = list(range(32))
    primary_id = fleet._ring.lookup(fleet.routing_key(prompt))
    primary = next(r.engine for r in fleet.replicas if r.id == primary_id)
    handoff = _FakeHandoff(prompt, cached_prefix=24, replica=primary_id)

    def preempted_submit(p, **kwargs):
        future = Future()
        future.set_exception(pkg.podfleet.ReplicaPreemptedError(
            "pod preempted", handoff=handoff,
            retry_after_s=pkg.podfleet.retry_after_hint()))
        return future

    primary.submit = preempted_submit
    tokens, stats = fleet.submit(prompt).result(timeout=10)
    survivor = next(r.engine for r in fleet.replicas
                    if r.id == stats["replica"])
    out.append((tokens, primary_id, stats["replica"],
                stats["resumed_via_handoff"], stats["cached_prefix"],
                stats["handoff_bytes"], survivor.imported,
                fleet.stats["handoffs"]))
    fleet.stop()
    return out


@pytest.mark.chaos
def test_deferred_join_reassigned_keys_and_handoff_resume_like_reference(
        monkeypatch):
    """A deferred-join replica takes no traffic until ``join_replica``
    (an armed ``fleet.join`` keeps it out once), the reassigned hot keys
    are the reference's, and a preempted decode resumes on a survivor
    from its handoff."""
    (ring, joining, served, out_after_fault, joined, moved,
     resumed) = _both(_fleet_hooks, monkeypatch)
    rid = "f1-u2"
    assert rid not in ring and joining is True and rid not in served
    assert out_after_fault is False and rid in joined
    assert 0 < len(moved) < 32
    tokens, primary, survivor, via, cached, nbytes, imported, handoffs = \
        resumed
    assert tokens == [0] and survivor != primary and via is True
    assert (cached, nbytes, imported, handoffs) == (24, 256, 1, 1)


# -- the lifecycle drill (test_fleet_elastic.py:286-465) ----------------------

def _lifecycle(pkg, monkeypatch):
    cluster, provider = _cluster(pkg, monkeypatch)
    fleet, factory, created = _fleet(pkg, replicas=1)
    pods = _pods(pkg, fleet, provider, factory)
    scaler = _scaler(pkg, fleet, pods, min_replicas=2)
    seed_rid = fleet.replicas[0].id
    ticks = []

    def tick(now):
        decision = scaler.tick(now=now)
        ticks.append((now, pods.pods(), _decision(decision)))
        return decision

    decision = tick(0.0)
    assert decision["reason"] == "below_min" and decision["forced"]
    pod1 = decision["acted"]["pod"]
    assert cluster.pod_phases[pod1] == "Running"
    assert pods.pods()[pod1] == "pending"
    tick(1.0)
    rid1 = next(rec["rid"] for rec in pods._pods.values())
    assert pods.pods()[pod1] == "warming" and rid1 not in fleet._ring.nodes()
    tick(2.0)
    tick(3.0)
    assert pods.pods()[pod1] == "joined" and rid1 in fleet._ring.nodes()

    prompts = [list(range(i, i + 24)) for i in range(0, 400, 10)]
    served = [fleet.submit(p).result(timeout=10) for p in prompts]
    assert all(tokens == p[:1] for p, (tokens, _) in zip(prompts, served))
    victim = next(p for p in prompts
                  if fleet._ring.lookup(fleet.routing_key(p)) == rid1)
    created[1].hang_decode = True
    inflight = fleet.submit(victim)
    assert not inflight.done()
    created[1].hang_decode = False
    cluster.kill_pod(pod1)
    decision = tick(4.0)
    tokens, stats = inflight.result(timeout=10)
    assert tokens == victim[:1] and stats["replica"] == seed_rid
    assert stats["resumed_via_handoff"] is True
    assert stats["cached_prefix"] == len(victim)
    pod2 = decision["acted"]["pod"]
    for now in (5.0, 6.0, 7.0):
        tick(now)
    assert pods.pods() == {pod2: "joined"}
    rid2 = next(rec["rid"] for rec in pods._pods.values())
    assert created[2].imported > 0
    warmed = next(p for p in prompts
                  if fleet._ring.lookup(fleet.routing_key(p)) == rid2
                  and tuple(p) in created[2].registered)
    _, warm_stats = fleet.submit(warmed).result(timeout=10)
    assert warm_stats["replica"] == rid2
    assert warm_stats["cached_prefix"] == len(warmed)

    with pkg.chaos.chaos.inject("obs.autoscale", pkg.chaos.always(),
                                action=_force("up")):
        decision = tick(8.0)
    pod3 = decision["acted"]["pod"]
    for now in (9.0, 10.0, 11.0):
        tick(now)
    assert pods.pods() == {pod2: "joined", pod3: "joined"}
    sentinel = (Future(), [])
    created[0].hung.extend([sentinel, sentinel])
    created[2].hung.extend([sentinel, sentinel])
    created[3].hung.append(sentinel)
    with pkg.chaos.chaos.inject("obs.autoscale", pkg.chaos.always(),
                                action=_force("down")):
        decision = tick(12.0)
    drained_rid = decision["acted"]["replica"]
    drained_pod = next(rec["name"] for rec in pods._pods.values()
                       if rec["rid"] == drained_rid)
    assert pods.pods()[drained_pod] == "draining"
    assert tick(13.0)["removed"] == []
    for engine in created:
        engine.hung.clear()
    decision = tick(14.0)
    assert decision["removed"] == [drained_rid]
    assert drained_pod not in cluster.pods
    kinds = [e["kind"] for e in _flight(pkg, ("pod.",))]
    _chain_ordered(kinds, ["pod.scale_up", "pod.prewarm", "pod.join",
                           "pod.kill", "pod.redispatch", "pod.delete",
                           "pod.scale_up", "pod.prewarm", "pod.join"])
    rendered = pkg.obs.REGISTRY.render()
    assert pod1 not in rendered and drained_pod not in rendered
    assert rid1 not in rendered
    trace = (ticks, [(s["replica"], s.get("cached_prefix"))
                     for _, s in served], (stats["replica"],
                                           stats["cached_prefix"]),
             warm_stats["cached_prefix"], _flight(pkg), cluster.events,
             _families(pkg), [e.imported for e in created])
    fleet.stop()
    return trace


@pytest.mark.chaos
def test_lifecycle_drill_like_reference(monkeypatch):
    """scale-up -> pre-warm -> join -> preemption mid-decode (handoff
    re-dispatch) -> replacement pre-warmed (first moved request a hit) ->
    forced scale-up -> drained scale-down: the same ticks, decisions,
    flight chain, cluster verbs and families as the reference."""
    ticks = _both(_lifecycle, monkeypatch)[0]
    phases = [p for _, p, _ in ticks]
    assert [sorted(p.values()) for p in phases[:4]] == [
        ["pending"], ["warming"], ["ready"], ["joined"]]


def _flap(pkg, monkeypatch):
    cluster, provider = _cluster(pkg, monkeypatch)
    fleet, factory, created = _fleet(pkg, replicas=1)
    pods = _pods(pkg, fleet, provider, factory)
    pod = pods.scale_up("unified")
    seen = []
    pods.tick()
    pods.tick()
    rid = next(rec["rid"] for rec in pods._pods.values())
    with pkg.chaos.chaos.inject("fleet.pod_ready", pkg.chaos.fail_first(2),
                                error=RuntimeError("probe timeout")):
        for _ in range(3):
            pods.tick()
            seen.append((pods.pods()[pod], rid in fleet._ring.nodes()))
    fleet.stop()
    return seen, _flight(pkg), _families(pkg)


@pytest.mark.chaos
def test_readiness_flap_delays_join_like_reference(monkeypatch):
    seen = _both(_flap, monkeypatch)[0]
    assert seen == [("ready", False), ("ready", False), ("joined", True)]


def _cold_join(pkg, monkeypatch):
    cluster, provider = _cluster(pkg, monkeypatch)
    fleet, factory, created = _fleet(pkg, replicas=1)
    for i in range(0, 200, 10):
        fleet.submit(list(range(i, i + 24))).result(timeout=10)
    pods = _pods(pkg, fleet, provider, factory)
    pods.scale_up("unified")
    pods.tick()
    with pkg.chaos.chaos.inject("fleet.prewarm", pkg.chaos.always(),
                                error=RuntimeError("registry unreachable")):
        pods.tick()
    pods.tick()
    rid = next(rec["rid"] for rec in pods._pods.values())
    joined = rid in fleet._ring.nodes()
    fleet.stop()
    return joined, _flight(pkg), _families(pkg)


@pytest.mark.chaos
def test_prewarm_fault_joins_cold_like_reference(monkeypatch):
    joined, flight, _ = _both(_cold_join, monkeypatch)
    prewarm = next(e for e in flight if e["kind"] == "pod.prewarm")
    assert joined and prewarm["warm"] is False
    assert prewarm["replayed_keys"] == 0
    assert next(e for e in flight if e["kind"] == "pod.join")[
        "prewarmed"] is False


def _drain_escalates(pkg, monkeypatch):
    cluster, provider = _cluster(pkg, monkeypatch)
    fleet, factory, created = _fleet(pkg, replicas=1)
    pods = _pods(pkg, fleet, provider, factory)
    pod = pods.scale_up("unified")
    for _ in range(3):
        pods.tick()
    rid = next(rec["rid"] for rec in pods._pods.values())
    created[1].hang_decode = True
    prompt = next(list(range(i, i + 24)) for i in range(200)
                  if fleet._ring.lookup(
                      fleet.routing_key(list(range(i, i + 24)))) == rid)
    inflight = fleet.submit(prompt)
    created[1].hang_decode = False
    with pkg.chaos.chaos.inject("fleet.drain", pkg.chaos.always(),
                                error=RuntimeError("connection refused")):
        pods.drain(rid)
    tokens, stats = inflight.result(timeout=10)
    out = (tokens == prompt[:1], stats["resumed_via_handoff"], pods.pods(),
           pod in cluster.pods, _flight(pkg), cluster.events, _families(pkg))
    fleet.stop()
    return out


@pytest.mark.chaos
def test_drain_endpoint_unreachable_escalates_like_reference(monkeypatch):
    ok, resumed, left, pod_alive, flight = _both(_drain_escalates,
                                                  monkeypatch)[:5]
    kinds = [e["kind"] for e in flight]
    assert ok and resumed and left == {} and not pod_alive
    assert "pod.redispatch" in kinds and "pod.drain" not in kinds


# -- restart drills (test_control_recovery.py:202-363) ------------------------

def _journal_ops(path) -> list:
    with open(path, encoding="utf-8") as fp:
        return [json.loads(line) for line in fp if line.strip()]


def _restart(pkg, monkeypatch, tmp_path, drill):
    cluster, provider = _cluster(pkg, monkeypatch)
    path = str(tmp_path / f"{pkg.fleet.__name__}-{drill}.jsonl")
    fleet1, factory1, _ = _fleet(pkg, replicas=1)
    pods1 = _pods(pkg, fleet1, provider, factory1,
                  journal=pkg.journal.IntentJournal(path))
    pod = pods1.scale_up("unified")
    jobset = pod.rsplit("-slice", 1)[0]
    if drill != "mid_scale_up":
        for _ in range(3):
            pods1.tick()
        rid = next(rec["rid"] for rec in pods1._pods.values())
        pods1.drain(rid)
    if drill == "mid_delete":
        fleet1.remove_replica(rid)
        with jchaos.chaos.inject("k8s.delete", jchaos.always(),
                                 error=RuntimeError("apiserver down")):
            pods1.on_replica_removed(rid)
    if drill == "mid_scale_up":
        with pkg.chaos.chaos.inject(
                pkg.chaos.FaultPoints.fleet_controller_crash,
                pkg.chaos.always(), error=RuntimeError("controller killed")):
            with pytest.raises(RuntimeError, match="controller killed"):
                pkg.podfleet.controller_crash(drill=drill)
    else:
        pkg.podfleet.controller_crash(drill=drill)
    pods1._journal.close()
    written = _journal_ops(path)
    fleet1.stop()

    fleet2, factory2, _ = _fleet(pkg, replicas=1)
    pods2 = _pods(pkg, fleet2, provider, factory2,
                  journal=pkg.journal.IntentJournal(path))
    after_restart = pods2.pods()
    again = pods2.reconcile()
    seen = [after_restart]
    if drill == "mid_scale_up":
        pods2.tick()
        seen.append(pods2.pods())
        for i in range(0, 200, 10):
            prompt = list(range(i, i + 24))
            assert fleet2.submit(prompt).result(timeout=10)[0] == prompt[:1]
    elif drill == "mid_drain":
        scaler = _scaler(pkg, fleet2, pods2, min_replicas=1)
        seen.append(_decision(scaler.tick(now=100.0)))
        seen.append(pods2.pods())
    out = (written, seen, again, sorted(cluster.jobsets), jobset,
           _journal_ops(path), _flight(pkg), cluster.events, _families(pkg))
    fleet2.stop()
    return out


@pytest.mark.chaos
@pytest.mark.parametrize("drill", ["mid_scale_up", "mid_drain", "mid_delete"])
def test_restart_drills_like_reference(monkeypatch, tmp_path, drill):
    """The controller dies mid scale-up / mid drain / mid delete; the
    restarted plane adopts, resumes or finishes the orphan exactly as the
    reference's does (same journal records before and after, same
    reconcile result, same cluster, same flight chain)."""
    (written, seen, again, jobsets, jobset, _, flight,
     _, families) = _both(_restart, monkeypatch, tmp_path, drill)
    kinds = [e["kind"] for e in flight]
    assert again == {"adopted": [], "resumed": [], "orphaned": [],
                     "unknown": []}
    pod = written[0]["pod"]
    if drill == "mid_scale_up":
        assert [r["op"] for r in written] == ["scale_up"]
        assert seen == [{pod: "ready"}, {pod: "joined"}]
        assert jobsets == [jobset]
        _chain_ordered(kinds, ["fleet.crash", "reconcile.adopt",
                               "reconcile.converged"])
    elif drill == "mid_drain":
        assert seen[0] == {pod: "draining"} and seen[2] == {}
        assert jobsets == []
        _chain_ordered(kinds, ["fleet.crash", "reconcile.resume",
                               "reconcile.converged", "pod.delete"])
    else:
        assert seen == [{}] and jobsets == []
        orphan = next(e for e in flight if e["kind"] == "reconcile.orphan")
        assert orphan["reason"] == "intent_deleted"


def _unknown(pkg, monkeypatch, tmp_path):
    cluster, provider = _cluster(pkg, monkeypatch)
    from mlrun_tpu.k8s.jobset import build_serving_jobset

    foreign = build_serving_jobset(
        "serve-foreign-1", "testns",
        {"containers": [{"name": "engine", "image": "x"}]},
        accelerator="v5litepod-8", topology="1x1")
    provider.create(foreign, run_uid="serve-foreign-1")
    fleet, factory, _ = _fleet(pkg, replicas=1)
    pods = _pods(pkg, fleet, provider, factory,
                 journal=pkg.journal.IntentJournal(
                     str(tmp_path / f"{pkg.fleet.__name__}.jsonl")))
    result = pods.reconcile()
    out = (result, sorted(cluster.jobsets), pods.pods(), _families(pkg))
    fleet.stop()
    return out


def test_unknown_jobsets_left_alone_like_reference(monkeypatch, tmp_path):
    result, jobsets, pods = _both(_unknown, monkeypatch, tmp_path)[:3]
    assert result["unknown"] == ["serve-foreign-1"]
    assert jobsets == ["serve-foreign-1"] and pods == {}


# -- a probated pod replaced (test_replica_health.py:450-548) -----------------

def _degraded(pkg, monkeypatch):
    cluster, provider = _cluster(pkg, monkeypatch)
    fleet, factory, created = _fleet(pkg, replicas=2)
    pods = _pods(pkg, fleet, provider, factory)
    scorer = pkg.health.ReplicaHealthScorer(
        fleet, ewma_alpha=1.0, suspect_ticks=1, probation_ticks=1,
        recover_ticks=100, probation_weight=0.25, replace_after_ticks=1,
        min_peers=3)
    scaler = pkg.autoscaler.FleetAutoscaler(
        fleet, pods=pods, scorer=scorer, dry_run=False, min_replicas=3,
        max_replicas=4, hysteresis_ticks=1, cooldown_up_s=0.0,
        cooldown_down_s=0.0, drain_grace_s=5.0, queue_low=0.0,
        queue_high=1e9)
    ticks = []

    def tick(now):
        decision = scaler.tick(now=now)
        ticks.append((now, pods.pods(), _decision(decision)))
        return decision

    pod1 = tick(0.0)["acted"]["pod"]
    for now in (1.0, 2.0, 3.0):
        tick(now)
    pod_rid = next(rec["rid"] for rec in pods._pods.values())
    created[2].hung.extend([(Future(), [])] * 24)
    tick(4.0)
    assert scorer.state(pod_rid) == "suspect"
    decision = tick(5.0)
    assert decision["acted"] == {"action": "replace_degraded",
                                 "replica": pod_rid}
    decision = tick(6.0)
    assert decision["removed"] == [] and decision["reason"] == "below_min"
    created[2].hung.clear()
    assert tick(7.0)["removed"] == [pod_rid]
    for now in (8.0, 9.0, 10.0):
        tick(now)
    assert len(fleet.replicas) == 3 and pod1 not in cluster.pods
    rendered = pkg.obs.REGISTRY.render()
    assert f'mlt_replica_health_state{{replica="{pod_rid}"}}' not in rendered
    out = (ticks, _flight(pkg), cluster.events, _families(pkg))
    fleet.stop()
    return out


@pytest.mark.chaos
def test_degraded_pod_replaced_via_drain_delete_repair_like_reference(
        monkeypatch):
    flight = _both(_degraded, monkeypatch)[1]
    kinds = [e["kind"] for e in flight]
    _chain_ordered(kinds, ["health.suspect", "health.probation",
                           "health.replace", "pod.drain", "pod.delete"])


def test_port_provider_jobset_surface(monkeypatch):
    """The port's provider speaks the reference's JobSet verbs over the
    same cluster: create / state / delete / list_serving_jobsets, its
    ``provider.*`` chaos points, a plain pod (the run stack's job kind),
    and a serving gateway's Deployment (the deployment manager's)."""
    from mlrun_tpu_torch.k8s.jobset import build_serving_jobset

    cluster, provider = _cluster(PKGS["port"], monkeypatch)
    spec = build_serving_jobset("serve-x-1", "testns", {"containers": [
        {"name": "engine", "image": "x"}]}, gpu_product="H100",
        gpus_per_node=1)
    assert provider.create(spec, run_uid="serve-x-1") == "jobset/serve-x-1"
    assert "serve-x-1-slice-0-0" in cluster.pods
    assert provider.state("jobset/serve-x-1") == "Running"
    cluster.set_jobset_conditions("serve-x-1", [
        {"type": "Completed", "status": "True"}])
    assert provider.state("jobset/serve-x-1") == "Succeeded"
    assert list(provider.list_serving_jobsets()) == ["serve-x-1"]
    with tchaos.chaos.inject("provider.delete", tchaos.always(),
                             error=RuntimeError("refused")):
        with pytest.raises(RuntimeError, match="refused"):
            provider.delete("jobset/serve-x-1")
    provider.delete("jobset/serve-x-1")
    assert cluster.jobsets == {} and cluster.pods == {}
    assert provider.create({"kind": "Pod", "metadata": {"name": "p"}},
                           "p") == "pod/p"
    assert "p" in cluster.pods
    assert provider.create({"kind": "Deployment", "metadata": {"name": "d"},
                            "spec": {}}, "d") == "deployment/d"
    assert "d" in cluster.deployments
    assert provider.state("deployment/d") == "Pending"
    provider.delete("deployment/d")
    assert cluster.deployments == {}


# -- real paged engines -------------------------------------------------------

ENGINE_KW = dict(max_len=64, slots=2, prefill_buckets=(16,), page_size=8)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _factory(name, models):
    jcfg, jparams, tcfg, tparams = models
    if name == "jax":
        return lambda role: jpaged.PagedContinuousBatchingEngine(
            jcfg, jparams, **ENGINE_KW)
    return lambda role: tpaged.PagedContinuousBatchingEngine(
        tcfg, tparams, device="cpu", **ENGINE_KW)


def _margin(models, prompt, generated) -> float:
    _, _, tcfg, tparams = models
    seq = torch.tensor([prompt + generated[:-1]], dtype=torch.long)
    logits = tllama.forward(tcfg, tparams, seq)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def _tokens(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=n).tolist()


class _Parkable:
    """A paged engine whose ``submit`` can be parked: while ``park`` is
    set, a decode request gets a pending future and never reaches the
    engine (the in-flight state a preemption must hand off); everything
    else is the engine's own."""

    def __init__(self, engine):
        object.__setattr__(self, "_inner", engine)
        object.__setattr__(self, "park", False)
        object.__setattr__(self, "parked", [])

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        if name in ("park", "parked"):
            object.__setattr__(self, name, value)
        else:
            setattr(self._inner, name, value)

    def submit(self, prompt_tokens, **kwargs):
        if self.park:
            future = Future()
            self.parked.append(future)
            return future
        return self._inner.submit(prompt_tokens, **kwargs)


def _cached(stats: dict) -> int:
    """A served request's cached prefix (the handoff path states it at the
    top, a paged engine's answer in its timing)."""
    if "cached_prefix" in stats:
        return stats["cached_prefix"]
    return stats.get("timing", {}).get("cached_prefix", 0)


def _real_drill(pkg, monkeypatch, factory):
    cluster, provider = _cluster(pkg, monkeypatch)
    engines = []

    def parkable(role):
        engines.append(_Parkable(factory(role)))
        return engines[-1]

    fleet = pkg.fleet.EngineFleet(parkable, replicas=1, backoff=0.001)
    fleet.start()
    seed_rid = fleet.replicas[0].id
    pods = _pods(pkg, fleet, provider, parkable)
    scaler = _scaler(pkg, fleet, pods, min_replicas=1, max_replicas=2)
    candidate = f"{fleet._fleet_id}-u{fleet._replica_seq}"
    probe = pkg.fleet.ConsistentHashRing(vnodes=fleet._ring.vnodes)
    for node in (seed_rid, candidate):
        probe.add(node)
    prompts = [_tokens(seed, 24) for seed in range(100, 112)]
    moving = [p for p in prompts
              if probe.lookup(fleet.routing_key(p)) == candidate][:2]
    staying = [p for p in prompts
               if probe.lookup(fleet.routing_key(p)) == seed_rid][:1]
    warm = [fleet.generate(p, max_new_tokens=4)[0] for p in moving + staying]
    phases = []
    with pkg.chaos.chaos.inject("obs.autoscale", pkg.chaos.fail_first(1),
                                action=_force("up")):
        for now in range(4):
            scaler.tick(now=float(now))
            phases.append(pods.pods())
    rid = next(rec["rid"] for rec in pods._pods.values())
    pod = next(iter(pods.pods()))
    prewarm = next(e for e in pkg.obs.get_flight_recorder().events()
                   if e["kind"] == "pod.prewarm")
    hit, hit_stats = fleet.generate(moving[0], max_new_tokens=4)
    hit2, hit2_stats = fleet.generate(moving[1], max_new_tokens=4)
    # preemption: both movers' decodes in flight on the pod (their keys'
    # hot owner is the pod now, so they dispatch straight to it), then
    # the pod dies
    engines[-1].park = True
    futures = [fleet.submit(p, max_new_tokens=12) for p in moving]
    parked = len(engines[-1].parked)
    cluster.kill_pod(pod)
    scaler.tick(now=4.0)
    resumed = []
    for future in futures:
        tokens, stats = future.result(timeout=300)
        resumed.append((tokens, stats["resumed_via_handoff"],
                        stats["replica"], _cached(stats)))
    after = scaler.tick(now=5.0)
    survivors = [r.id for r in fleet.replicas]
    rendered = pkg.obs.REGISTRY.render()
    # scale up again, then down: the drain-first victim is swept and
    # removed, its pod's JobSet deleted and its series retired
    with pkg.chaos.chaos.inject("obs.autoscale", pkg.chaos.fail_first(1),
                                action=_force("up")):
        for now in range(6, 10):
            scaler.tick(now=float(now))
    again = pods.pods()
    with pkg.chaos.chaos.inject("obs.autoscale", pkg.chaos.always(),
                                action=_force("down")):
        down = scaler.tick(now=10.0)
    victim = down["acted"]["replica"]
    gone = f'replica="{victim}"' not in pkg.obs.REGISTRY.render()
    scaled = (again, _decision(down)[5:7], pods.pods(), sorted(
        cluster.jobsets), [r.id for r in fleet.replicas], gone)
    out = (phases, moving + staying, warm,
           (prewarm["fetched_keys"], prewarm["replayed_keys"],
            prewarm["warm"]),
           hit, _cached(hit_stats), hit_stats["replica"] == rid,
           (hit2, _cached(hit2_stats), hit2_stats["replica"]),
           parked, resumed, survivors,
           f'replica="{rid}"' in rendered, pod in rendered,
           _decision(after)[:2], scaled, _flight(pkg, ("pod.",)),
           cluster.events)
    fleet.stop()
    return out


def test_real_engine_pod_join_prewarm_and_preemption_like_reference(
        models, monkeypatch):
    """Paged engines in pods: the pre-warm fetches the moved keys' pages
    from the owner, the first request there is a prefix hit with the
    owner's tokens, and a preempted pod's in-flight decodes resume on the
    survivor from their KV handoffs with the lone engine's streams; every
    series of the removed replica is gone."""
    got = {}
    for name, pkg in PKGS.items():
        _restart_ids(monkeypatch)
        got[name] = _real_drill(pkg, monkeypatch, _factory(name, models))
    assert got["port"] == got["jax"]
    (phases, prompts, warm, prewarm, hit, cached, on_pod, hit2, parked,
     resumed, survivors, rid_left, pod_left, after, scaled, _,
     _) = got["port"]
    moving = prompts[:2]
    for prompt, stream in zip(prompts, warm):
        assert _margin(models, prompt, stream) > 1e-3
    assert [sorted(p.values()) for p in phases] == [
        ["pending"], ["warming"], ["ready"], ["joined"]]
    assert len(moving) == 2 and prewarm == (2, 0, True)
    assert on_pod and cached == 16 and hit == warm[0]
    assert hit2[0] == warm[1] and hit2[1] == 16
    lone = tpaged.PagedContinuousBatchingEngine(
        models[2], models[3], device="cpu", **ENGINE_KW)
    lone.start()
    try:
        want = [lone.generate(p, max_new_tokens=12)[0] for p in moving]
    finally:
        lone.stop()
    for prompt, stream in zip(moving, want):
        assert _margin(models, prompt, stream) > 1e-3
    assert parked == 2
    assert [r[:3] for r in resumed] == [(w, True, survivors[0])
                                        for w in want]
    assert all(r[3] == 16 for r in resumed)
    assert len(survivors) == 1 and not rid_left and not pod_left
    assert after == ("hold", "")
    again, (acted, removed), left, jobsets, replicas, gone = scaled
    assert sorted(again.values()) == ["joined"]
    assert acted["action"] == "drain" and removed == [acted["replica"]]
    assert len(left) + len(replicas) == 2 and len(replicas) == 1
    assert len(jobsets) == len(left) and gone
