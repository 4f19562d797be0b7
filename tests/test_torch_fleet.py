"""mlrun_tpu_torch's engine fleet (serving/fleet.py) against mlrun_tpu's on
the CPU: the consistent-hash ring (lookup, preference, weighted vnodes,
movement on join and leave) and the routing key for 1000 keys; the fake
engine drills of the reference's fleet tests (re-dispatch, exhaustion,
fatal errors, drain, no replica, affinity and random routing with one
seed); then real paged engines at ``tiny_llama`` size in float32, TF32
off, max_len 64, 2 slots, page 8, fed the same weights: the disaggregated
handoff cold and warm, the decode pool under a long prompt, affinity
placement, the ring move with its cross-replica prefix fetch and the
``llm.kv_fetch`` fallback, re-dispatch after a replica crash, scale-down
retiring the replica's series, a fleet request's ``timing``, and
``LLMModelServer(replicas=2)`` / ``prefill_replicas=1`` against the JAX
server's v2 responses.

Tolerances: none. Tokens, placements, counts and bytes are compared
exactly; every prompt's greedy stream is first checked to have a top-2
logit margin above 1e-3, so the comparison never rests on a near-tie. No
assertion compares wall clocks. Both packages' fleet-id sequences restart
per test, so replica ids (and with them ring positions) agree.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from concurrent.futures import Future

from mlrun_tpu import chaos as jchaos
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.serving import fleet as jfleet
from mlrun_tpu.serving import paged as jpaged
from mlrun_tpu.serving import resilience as jres
from mlrun_tpu.serving.prefix import block_chain_key
from mlrun_tpu_torch import chaos as tchaos
from mlrun_tpu_torch import obs as tobs
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.serving import fleet as tfleet
from mlrun_tpu_torch.serving import llm as tllm
from mlrun_tpu_torch.serving import paged as tpaged
from mlrun_tpu_torch.serving import resilience as tres
from tests.torch_registries import registries_left_as_found  # noqa: F401

# (fleet module, resilience module, chaos package) per package
PACKAGES = {"jax": (jfleet, jres, jchaos), "port": (tfleet, tres, tchaos)}
ENGINE_KW = dict(max_len=64, slots=2, prefill_buckets=(16,), page_size=8)


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = False
    for module in (jfleet, tfleet):
        monkeypatch.setattr(module, "_FLEET_SEQUENCE", itertools.count(1))

    def reset():
        tchaos.chaos.clear()
        jchaos.chaos.clear()
        tobs.REGISTRY.reset()
        tobs.get_flight_recorder().clear()

    reset()
    yield
    reset()


def _local(rid: str) -> str:
    """A replica id without its fleet part ("f1-u0" -> "u0")."""
    return rid.split("-", 1)[1] if rid else rid


# -- the consistent-hash ring --------------------------------------------------

def _keys(n=1000):
    return [block_chain_key(list(range(i, i + 40)), 8, max_blocks=4)
            for i in range(n)]


def _rings(vnodes, weights=None):
    rings = []
    for module in (jfleet, tfleet):
        ring = module.ConsistentHashRing(vnodes=vnodes)
        for node in ("r0", "r1", "r2", "r3"):
            ring.add(node, weight=(weights or {}).get(node, 1.0))
        rings.append(ring)
    return rings


@pytest.mark.parametrize("vnodes,weights", [
    (32, None), (64, None), (64, {"r2": 0.25, "r3": 0.5}), (8, {"r1": 0.001}),
], ids=["v32", "v64", "v64-weighted", "v8-min-one-point"])
def test_ring_lookup_and_preference_match_reference(vnodes, weights):
    """Lookup, preference order (with and without an exclusion), weights
    and point counts are the reference ring's for 1000 keys."""
    jring, tring = _rings(vnodes, weights)
    keys = _keys()
    owners = {}
    for key in keys:
        owners[key] = tring.lookup(key)
        assert owners[key] == jring.lookup(key)
        assert tring.preference(key) == jring.preference(key)
        assert tring.preference(key, exclude=("r0",)) == \
            jring.preference(key, exclude=("r0",))
    assert tring._points == jring._points and tring._owners == jring._owners
    assert [tring.weight(n) for n in ("r0", "r1", "r2", "r3", "rx")] == \
        [jring.weight(n) for n in ("r0", "r1", "r2", "r3", "rx")]
    for key in keys[:20]:
        assert tring.preference(key)[0] == owners[key]
        assert sorted(tring.preference(key)) == ["r0", "r1", "r2", "r3"]


def test_ring_join_leave_movement_matches_reference():
    """The same minimal movement as the reference ring on a join, the
    exact prior mapping after the leave, and only the removed node's keys
    moving on a second leave."""
    keys = _keys()
    maps = []
    for ring in _rings(64):
        before = {key: ring.lookup(key) for key in keys}
        ring.add("r4")
        joined = {key: ring.lookup(key) for key in keys}
        ring.remove("r4")
        restored = {key: ring.lookup(key) for key in keys}
        ring.remove("r1")
        left = {key: ring.lookup(key) for key in keys}
        maps.append((before, joined, restored, left))
    assert maps[1] == maps[0]
    before, joined, restored, left = maps[1]
    moved = [key for key in keys if joined[key] != before[key]]
    assert 0 < len(moved) / len(keys) <= 0.35
    assert all(joined[key] == "r4" for key in moved)
    assert restored == before
    assert all(left[key] == before[key] for key in keys
               if before[key] != "r1")
    assert not tfleet.ConsistentHashRing().preference(1)
    with pytest.raises(tres.ReplicaUnavailableError):
        tfleet.ConsistentHashRing().lookup(1)
    with pytest.raises(ValueError):
        tfleet.ConsistentHashRing(vnodes=0)


# -- dispatch on fake engines ----------------------------------------------------

class _FakeEngine:
    """Duck-typed engine resolving futures at once, optionally with a
    scripted failure (the reference tests' fake)."""

    page_size = 8

    def __init__(self, fail_with=None):
        self.replica = ""
        self._stopped = False
        self._slot_state = ()
        self.fail_with = fail_with
        self.prompts = []

    def _queue_depth(self):
        return 0

    def start(self):
        pass

    def warmup(self):
        pass

    def stop(self, timeout=10.0):
        self._stopped = True

    def submit(self, prompt, **kwargs):
        future = Future()
        self.prompts.append(list(prompt))
        if self.fail_with is not None:
            future.set_exception(self.fail_with)
        else:
            future.set_result((list(prompt)[:1], {"ttft_s": 0.001}))
        return future

    @property
    def stats(self):
        return {"requests": len(self.prompts), "completed": 0,
                "queue_depth": 0}


def _fake_fleet(module, engines, **kwargs):
    pool = list(engines)
    return module.EngineFleet(lambda role: pool.pop(0), replicas=len(engines),
                              route_block_tokens=8, backoff=0.001, **kwargs)


def _counts(stats: dict) -> dict:
    return {key: stats[key] for key in (
        "dispatches", "redispatches", "failed", "no_replica", "handoffs",
        "handoff_bytes", "prefix_fetches", "prefix_fetch_fallbacks",
        "replicas", "prefill_replicas", "routing")}


@pytest.mark.parametrize("adapter", ["", "t1", "t1@v2"])
def test_routing_key_matches_reference(adapter):
    """The routing key (leading page blocks, namespaced by the route
    adapter) is the reference's for shared, diverging, short and
    sub-block prompts; the block size follows the engines' page size."""
    prompts = [list(range(100)), list(range(64)) + [9] * 40, [1, 2, 3],
               [7] * 8, list(range(33)), [5] * 31]
    keys = []
    for module, _, _ in PACKAGES.values():
        fleet = module.EngineFleet(lambda role: _FakeEngine(), replicas=2)
        keys.append((fleet.route_block_tokens, fleet.route_blocks,
                     [fleet.routing_key(p, adapter=adapter)
                      for p in prompts]))
    assert keys[1] == keys[0]
    assert keys[1][:2] == (8, 4)
    assert keys[1][2][0] == keys[1][2][1]      # a shared prefix groups
    assert len(set(keys[1][2][2:])) == 4


def _redispatch_drill(module, res):
    engines = [_FakeEngine(), _FakeEngine()]
    fleet = _fake_fleet(module, engines)
    prompt = list(range(32))
    primary_id = fleet._ring.lookup(fleet.routing_key(prompt))
    primary = next(r.engine for r in fleet.replicas if r.id == primary_id)
    primary.fail_with = res.EngineStoppedError("replica died")
    tokens, stats = fleet.submit(prompt, max_new_tokens=4).result(timeout=10)
    return (tokens, _local(primary_id), _local(stats["replica"]),
            stats["dispatch_attempts"], primary.prompts, _counts(fleet.stats))


def test_fleet_redispatch_on_failing_future_like_reference():
    got = [_redispatch_drill(*pkg[:2]) for pkg in PACKAGES.values()]
    assert got[1] == got[0]
    tokens, primary, served, attempts, primary_prompts, counts = got[1]
    assert tokens == [0] and served != primary and attempts == 2
    assert primary_prompts == [list(range(32))]
    assert counts["redispatches"] == 1 and counts["dispatches"] == 1


def _exhaustion_drill(module, res):
    out = []
    engines = [_FakeEngine(fail_with=res.EngineStoppedError("down")),
               _FakeEngine(fail_with=res.EngineStoppedError("down"))]
    fleet = _fake_fleet(module, engines, max_dispatch_attempts=2)
    with pytest.raises(res.EngineStoppedError):
        fleet.submit(list(range(16))).result(timeout=10)
    out.append(_counts(fleet.stats))
    # a 400-class error is the request's fault: no re-dispatch
    fleet = _fake_fleet(module, [_FakeEngine(fail_with=ValueError("bad")),
                                 _FakeEngine()])
    outcomes = []
    for i in range(8):
        try:
            _, stats = fleet.submit([i] * 16).result(timeout=10)
            outcomes.append(_local(stats["replica"]))
        except ValueError:
            outcomes.append("ValueError")
    out.append((outcomes, _counts(fleet.stats)))
    return out


def test_fleet_redispatch_exhaustion_and_fatal_errors_like_reference():
    got = [_exhaustion_drill(*pkg[:2]) for pkg in PACKAGES.values()]
    assert got[1] == got[0]
    exhausted, (outcomes, fatal) = got[1]
    assert exhausted["failed"] == 1 and exhausted["redispatches"] == 1
    assert fatal["redispatches"] == 0 and "ValueError" in outcomes
    assert fatal["failed"] == outcomes.count("ValueError")


def _drain_drill(module, res):
    fleet = _fake_fleet(module, [_FakeEngine(), _FakeEngine()])
    replicas = [r.id for r in fleet.replicas]
    fleet.drain_replica(replicas[0])
    served = [_local(fleet.submit([i] * 16).result(timeout=10)[1]["replica"])
              for i in range(6)]
    fleet.drain_replica(replicas[1])
    with pytest.raises(res.ReplicaUnavailableError) as err:
        fleet.submit([1] * 16).result(timeout=10)
    with pytest.raises(KeyError):
        fleet.drain_replica("nope")
    return served, err.value.status_code, err.value.retry_after_s, \
        _counts(fleet.stats), sorted(fleet.stats["per_replica"])


def test_fleet_drain_and_no_replica_like_reference():
    got = [_drain_drill(*pkg[:2]) for pkg in PACKAGES.values()]
    assert got[1][:4] == got[0][:4]
    served, status, hint, counts, _ = got[1]
    assert served == ["u1"] * 6 and status == 503 and hint > 0
    assert counts["no_replica"] == 1


@pytest.mark.parametrize("routing,seed", [("affinity", 0), ("random", 7),
                                          ("random", 11)])
def test_fleet_routing_sequence_like_reference(routing, seed):
    """Affinity puts a shared prefix on one replica; random routing with
    one seed picks the reference's replica sequence."""
    shared = list(range(64))
    sequences = []
    for module, _, _ in PACKAGES.values():
        engines = [_FakeEngine() for _ in range(4)]
        fleet = _fake_fleet(module, engines, routing=routing, seed=seed)
        sequences.append([
            _local(fleet.submit(shared + [i] * 4).result(timeout=10)[1]
                   ["replica"]) for i in range(16)])
    assert sequences[1] == sequences[0]
    if routing == "affinity":
        assert len(set(sequences[1])) == 1
    else:
        assert len(set(sequences[1])) >= 2


def test_fleet_replica_lifecycle_like_reference():
    """add / join / weight / remove on a fleet of fake engines: the same
    ring membership, roles and per-replica rows as the reference fleet,
    and a deferred-join replica takes no traffic until it joins."""
    rows = []
    for module, _, _ in PACKAGES.values():
        fleet = _fake_fleet(module, [_FakeEngine(), _FakeEngine(),
                                     _FakeEngine()])
        extra = fleet.add_replica("unified", engine=_FakeEngine(),
                                  joined=False)
        before = sorted(_local(n) for n in fleet._ring.nodes())
        fleet.join_replica(extra)
        fleet.set_replica_weight(extra, 0.25)
        weighted = fleet._ring.weight(extra)
        victim = fleet.replicas[0].id
        fleet.remove_replica(victim)
        per = fleet.stats["per_replica"]
        rows.append((before, sorted(_local(n) for n in fleet._ring.nodes()),
                     weighted, _local(victim),
                     {_local(r): (v["role"], v["weight"], v["joining"])
                      for r, v in per.items()}))
        with pytest.raises(ValueError):
            fleet.add_replica("oracle")
    assert rows[1] == rows[0]
    assert rows[1][0] == ["u0", "u1", "u2"] and rows[1][2] == 0.25


# -- real engines ------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _factories(models, **kw):
    """One engine factory per package over ONE param tree each (the
    replicas share the weights)."""
    jcfg, jparams, tcfg, tparams = models
    kw = {**ENGINE_KW, **kw}
    return {
        "jax": lambda role: jpaged.PagedContinuousBatchingEngine(
            jcfg, jparams, **kw),
        "port": lambda role: tpaged.PagedContinuousBatchingEngine(
            tcfg, tparams, device="cpu", **kw),
    }


def _margin(models, prompt, generated) -> float:
    _, _, tcfg, tparams = models
    seq = torch.tensor([prompt + generated[:-1]], dtype=torch.long)
    logits = tllama.forward(tcfg, tparams, seq)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def _tokens(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=n).tolist()


PROMPT = [1, 7, 3, 9, 2, 4, 6, 8, 5, 3, 1, 2]


def _disaggregated(module, factory):
    single = factory("unified")
    single.start()
    try:
        ref, _ = single.generate(PROMPT, max_new_tokens=6)
    finally:
        single.stop()
    fleet = module.EngineFleet(factory, replicas=1, prefill_replicas=1)
    try:
        cold, cold_stats = fleet.generate(PROMPT, max_new_tokens=6)
        warm, warm_stats = fleet.generate(PROMPT, max_new_tokens=6)
        stats = fleet.stats
    finally:
        fleet.stop()
    per = stats["per_replica"]
    decode = next(r for r in per.values() if r["role"] == "decode")
    prefill = next(r for r in per.values() if r["role"] == "prefill")
    seen = {key: (cold_stats[key], warm_stats[key]) for key in (
        "cached_prefix", "handoff_bytes", "dispatch_attempts")}
    seen["replica"] = (_local(warm_stats["replica"]),
                       _local(warm_stats["prefill_replica"]))
    return (ref, cold, warm, seen, _counts(stats),
            (decode["handoffs_in"], prefill["handoffs_out"],
             decode["prefill_chunks"], prefill["prefill_chunks"]))


def test_disaggregated_handoff_cold_and_warm_like_reference(models):
    """prefill replica -> KVHandoff -> decode replica gives the single
    engine's greedy tokens cold and through a prefill-side prefix hit,
    with the JAX fleet's cached prefix, float32 handoff bytes and counts;
    the decode replica never runs a prefill."""
    factories = _factories(models)
    got = {name: _disaggregated(PACKAGES[name][0], factories[name])
           for name in PACKAGES}
    assert got["port"] == got["jax"]
    ref, cold, warm, seen, counts, replicas = got["port"]
    assert _margin(models, PROMPT, ref) > 1e-3
    assert cold == warm == ref
    assert seen["cached_prefix"] == (0, 8)
    assert seen["handoff_bytes"][0] == seen["handoff_bytes"][1] > 0
    assert seen["replica"] == ("d0", "p1")
    assert counts["handoffs"] == 2 and counts["handoff_bytes"] == \
        2 * seen["handoff_bytes"][0]
    assert replicas[:3] == (2, 2, 0)


def test_decode_pool_runs_no_prefill_under_a_long_prompt_like_reference(
        models):
    """The structural half of the reference's decode-pool isolation
    test: while the decode replica ticks a long generation, an unchunked
    230-token prefill runs on the prefill replica only."""
    short = [5, 3, 8, 1, 9, 2, 4, 7]
    long_prompt = [(i * 13 + 7) % 512 for i in range(230)]
    factories = _factories(models, max_len=256, page_size=16,
                           prefill_buckets=(16, 256))
    got = []
    for name, (module, _, _) in PACKAGES.items():
        fleet = module.EngineFleet(factories[name], replicas=1,
                                   prefill_replicas=1)
        try:
            running = fleet.submit(short, max_new_tokens=24)
            long_future = fleet.submit(long_prompt, max_new_tokens=4)
            short_tokens, _ = running.result(timeout=300)
            long_tokens, long_stats = long_future.result(timeout=300)
            per = fleet.stats["per_replica"]
        finally:
            fleet.stop()
        decode = next(r for r in per.values() if r["role"] == "decode")
        got.append((short_tokens, long_tokens, decode["prefill_chunks"],
                    decode["handoffs_in"], long_stats["prefill_s"] > 0))
    assert _margin(models, short, got[1][0]) > 1e-3
    assert _margin(models, long_prompt, got[1][1]) > 1e-3
    assert got[1] == got[0]
    assert got[1][2:] == (0, 2, True)


def _affinity(module, factory, prompts):
    fleet = module.EngineFleet(factory, replicas=2)
    try:
        served = [fleet.generate(p, max_new_tokens=4) for p in prompts]
        stats = fleet.stats
    finally:
        fleet.stop()
    return ([tokens for tokens, _ in served],
            [_local(s["replica"]) for _, s in served],
            [s["timing"].get("cached_prefix", 0) for _, s in served],
            stats["prefix_hits"], stats["prefix_queries"])


def test_affinity_placement_like_reference(models):
    """Three prefixes, two suffixes each, on two unified replicas: every
    request lands where the JAX fleet put it, a prefix's requests share a
    replica and the second of each is a prefix hit."""
    prefixes = [_tokens(seed, 24) for seed in (1, 2, 3)]
    prompts = [prefix + _tokens(10 + i, 6) for i in range(2)
               for prefix in prefixes]
    factories = _factories(models)
    got = [_affinity(module, factories[name], prompts)
           for name, (module, _, _) in PACKAGES.items()]
    assert got[1] == got[0]
    tokens, replicas, cached, hits, queries = got[1]
    for prompt, stream in zip(prompts, tokens):
        assert _margin(models, prompt, stream) > 1e-3
    assert replicas[:3] == replicas[3:]
    assert cached == [0, 0, 0, 24, 24, 24] and (hits, queries) == (3, 6)


def _pick_moving(module, fleet):
    """Two prompts whose routing key moves to the replica a join adds and
    one whose key stays, picked from seeded candidates by the ring
    alone."""
    probe = module.ConsistentHashRing(vnodes=fleet._ring.vnodes)
    for node in fleet._ring.nodes():
        probe.add(node)
    candidate = f"{fleet._fleet_id}-u{fleet._replica_seq}"
    probe.add(candidate)
    moving, staying = [], []
    for seed in range(100, 200):
        prompt = _tokens(seed, 24) + _tokens(seed + 1000, 6)
        key = fleet.routing_key(prompt)
        (moving if probe.lookup(key) == candidate else staying).append(prompt)
    return moving[:2], staying[:1]


def _ring_move(module, factory, chaos):
    fleet = module.EngineFleet(factory, replicas=2)
    moving, staying = _pick_moving(module, fleet)
    try:
        warm = [fleet.generate(p, max_new_tokens=4) for p in
                moving + staying]
        candidate = f"{fleet._fleet_id}-u{fleet._replica_seq}"
        reassigned = [prompt for _, prompt, _ in
                      fleet.reassigned_hot_keys(candidate)]
        owners = [_local(fleet.hot_key_owner(fleet.routing_key(p)))
                  for p in moving]
        added = fleet.add_replica("unified")
        fetched, fetched_stats = fleet.generate(moving[0], max_new_tokens=4)
        after_fetch = _counts(fleet.stats)
        with chaos.chaos.inject("llm.kv_fetch", chaos.fail_nth(1),
                                error=RuntimeError("fetch path down")):
            fallback, fallback_stats = fleet.generate(moving[1],
                                                      max_new_tokens=4)
        stayed, stayed_stats = fleet.generate(staying[0], max_new_tokens=4)
        counts = _counts(fleet.stats)
        per = fleet.stats["per_replica"][added]
    finally:
        fleet.stop()
    return (moving + staying, [t for t, _ in warm], reassigned == moving,
            owners,
            _local(added),
            (fetched, _local(fetched_stats["replica"]),
             fetched_stats["timing"].get("cached_prefix", 0),
             "fetch" in fetched_stats["timing"]["phases"]),
            after_fetch,
            (fallback, _local(fallback_stats["replica"]),
             fallback_stats["timing"].get("cached_prefix", 0)),
            (stayed, _local(stayed_stats["replica"])), counts,
            (per["fetch_fallback_rate"], per["prefix_hit_rate"]))


def test_ring_move_prefix_fetch_and_fallback_like_reference(models):
    """A third replica joins; the next request on a moved hot key pulls
    its prefix pages from the old owner (a prefix hit on the new replica,
    the old owner's tokens); with ``llm.kv_fetch`` armed the next moved
    key falls back to a plain prefill (same tokens), as in the JAX
    fleet, with equal counts."""
    factories = _factories(models)
    got = [_ring_move(module, factories[name], chaos)
           for name, (module, _, chaos) in PACKAGES.items()]
    assert got[1] == got[0]
    (prompts, warm, reassigned_ok, owners, added, fetched, after_fetch,
     fallback, stayed, counts, rates) = got[1]
    assert len(prompts) == 3
    for prompt, stream in zip(prompts, warm):
        assert _margin(models, prompt, stream) > 1e-3
    assert reassigned_ok and added == "u2"
    assert fetched == (warm[0], "u2", 24, True)
    assert after_fetch["prefix_fetches"] == 1
    assert after_fetch["prefix_fetch_fallbacks"] == 0
    assert fallback == (warm[1], "u2", 0)
    assert counts["prefix_fetches"] == 1
    assert counts["prefix_fetch_fallbacks"] == 1
    assert stayed[0] == warm[2] and stayed[1] != "u2"
    assert rates[0] == 0.5


def _crash_redispatch(module, res, chaos, factory):
    fleet = module.EngineFleet(factory, replicas=2, backoff=0.001)
    prompt = _tokens(7, 20)
    try:
        # an armed llm.submit raises out of the engine's submit(): the
        # fleet fails the request loudly instead of re-dispatching it
        with chaos.chaos.inject("llm.submit", error=res.EngineStoppedError(
                "submit torn")):
            with pytest.raises(res.EngineStoppedError, match="submit torn"):
                fleet.submit(prompt, max_new_tokens=4).result(timeout=120)
        loud = _counts(fleet.stats)
        owner = fleet._ring.lookup(fleet.routing_key(prompt))
        # an armed llm.prefill crashes the owner's scheduler on this
        # request: its future fails 503-class and the next ring node
        # serves it
        with chaos.chaos.inject("llm.prefill", chaos.fail_nth(1),
                                error=res.EngineStoppedError("crashed")):
            tokens, stats = fleet.generate(prompt, max_new_tokens=4)
        counts = _counts(fleet.stats)
        per = fleet.stats["per_replica"]
    finally:
        fleet.stop()
    return (loud, _local(owner), tokens, _local(stats["replica"]),
            stats["dispatch_attempts"], "redispatch_backoff" in
            stats["timing"]["phases"], counts,
            {_local(r): v["dispatch_failure_rate"] for r, v in per.items()})


def test_redispatch_after_a_replica_crash_like_reference(models):
    factories = _factories(models)
    got = [_crash_redispatch(*pkg, factories[name])
           for name, pkg in PACKAGES.items()]
    assert got[1] == got[0]
    loud, owner, tokens, served, attempts, backoff, counts, rates = got[1]
    assert _margin(models, _tokens(7, 20), tokens) > 1e-3
    assert loud["failed"] == 1 and loud["redispatches"] == 0
    assert served != owner and attempts == 2 and backoff
    assert counts["redispatches"] == 1 and counts["dispatches"] == 1
    assert rates[owner] == 1.0 and rates[served] == 0.0


def test_scale_down_removes_replica_metric_series_like_reference(models):
    """remove_replica retires every series carrying the replica's label
    (the engine's and the fleet's), and the survivor serves its keys."""
    prompt = list(range(1, 13))
    factories = _factories(models)
    got = []
    for name, (module, _, _) in PACKAGES.items():
        fleet = module.EngineFleet(factories[name], replicas=2)
        try:
            first, stats = fleet.generate(prompt, max_new_tokens=4)
            victim = stats["replica"]
            if name == "port":
                tobs.REGISTRY.render()
                assert any(victim in key
                           for key in tobs.LLM_EVENTS._series)
                assert any(victim in key
                           for key in tobs.FLEET_DISPATCHES._series)
            fleet.remove_replica(victim)
            if name == "port":
                rendered = tobs.REGISTRY.render()
                assert victim not in rendered
                for family in (tobs.LLM_EVENTS, tobs.LLM_QUEUE_DEPTH,
                               tobs.FLEET_DISPATCHES, tobs.LLM_TTFT):
                    assert not any(victim in key for key in family._series)
            second, stats2 = fleet.generate(prompt, max_new_tokens=4)
        finally:
            fleet.stop()
        got.append((first, second, _local(victim),
                    _local(stats2["replica"])))
    assert got[1] == got[0]
    assert got[1][0] == got[1][1] and got[1][2] != got[1][3]


def _timing_keys(module, factory, prefill_replicas):
    fleet = module.EngineFleet(factory, replicas=1 if prefill_replicas
                               else 2, prefill_replicas=prefill_replicas)
    try:
        _, stats = fleet.generate(PROMPT, max_new_tokens=4)
    finally:
        fleet.stop()
    timing = stats["timing"]
    assert timing["attribution_closed"]
    assert timing["wall_s"] == pytest.approx(
        sum(timing["phases"].values()), abs=1e-9)
    required = {"admission", "queue_wait", "prefill", "decode_active",
                "network"} | ({"handoff"} if prefill_replicas else set())
    assert required <= set(timing["phases"])
    return sorted(timing), sorted(required)


@pytest.mark.parametrize("prefill_replicas", [0, 1],
                         ids=["unified", "disaggregated"])
def test_fleet_timing_keys_like_reference(models, prefill_replicas):
    """A fleet request's ``timing`` closes on the client-observed wall
    (the fleet's ``network`` remainder included) and carries the JAX
    fleet's keys; a disaggregated one merges the prefill side's
    ``prefill`` and ``handoff`` phases into the decode side's."""
    factories = _factories(models, request_ledger=True)
    got = [_timing_keys(module, factories[name], prefill_replicas)
           for name, (module, _, _) in PACKAGES.items()]
    assert got[1] == got[0]


# -- LLMModelServer ----------------------------------------------------------------

class _Event:
    def __init__(self, body, path="/v2/models/m/infer"):
        self.body = body
        self.path = path


@pytest.mark.parametrize("shape", [{"replicas": 2},
                                   {"replicas": 1, "prefill_replicas": 1}],
                         ids=["replicas2", "prefill1"])
def test_llm_model_server_fleet_like_reference(models, monkeypatch, shape):
    """LLMModelServer(replicas=2) and prefill_replicas=1 build an
    EngineFleet of port engines and answer v2 bodies (``timing``
    included) with the JAX server's outputs."""
    from mlrun_tpu.frameworks.jax import auto_trainer as jauto
    from mlrun_tpu.serving.llm import LLMModelServer as JServer

    jcfg, _, tcfg, tparams = models
    monkeypatch.setitem(jauto.MODEL_PRESETS, "tiny", lambda: jcfg)
    monkeypatch.setitem(tllama.MODEL_PRESETS, "tiny", lambda: tcfg)
    monkeypatch.setattr(tllama, "init_params",
                        lambda config, generator, device: tparams)
    common = dict(name="m", model_preset="tiny", continuous_batching=True,
                  paged=True, page_size=8, slots=2, max_len=64,
                  max_new_tokens=4, warmup=False, **shape)
    servers = [JServer(**common), tllm.LLMModelServer(device="cpu",
                                                      **common)]
    bodies = [{"inputs": [_tokens(3, 18), _tokens(4, 7)], "timing": True},
              {"inputs": [_tokens(3, 18)]}]
    replies = []
    try:
        for server in servers:
            replies.append([server.do_event(_Event(dict(body))).body
                            for body in bodies])
        fleets = [server.engine for server in servers]
        assert isinstance(fleets[1], tfleet.EngineFleet)
        assert all(isinstance(r.engine, tpaged.PagedContinuousBatchingEngine)
                   for r in fleets[1].replicas)
        shapes = [(f.stats["replicas"], f.stats["prefill_replicas"],
                   f.routing) for f in fleets]
    finally:
        for server in servers:
            if server.engine is not None:
                server.engine.stop()
    assert shapes[1] == shapes[0]
    for want, got in zip(*replies):
        assert got["outputs"] == want["outputs"]
        assert ("timing" in got) == ("timing" in want)
    for prompt, stream in zip(bodies[0]["inputs"],
                              replies[1][0]["outputs"]):
        assert _margin(models, prompt, stream) > 1e-3
    for timing in replies[1][0]["timing"]:
        assert timing["attribution_closed"]
        assert "network" in timing["phases"]


def test_fleet_families_share_the_reference_schema():
    """The fleet, health and canary families carry the reference's names,
    types, labels and buckets, so one scrape config reads both packages."""
    from mlrun_tpu import obs as jobs
    from mlrun_tpu_torch.obs import metrics as tmetrics

    for name in ("FLEET_DISPATCHES", "FLEET_HANDOFF_BYTES",
                 "FLEET_HANDOFF_LATENCY", "FLEET_REPLICAS",
                 "REPLICA_HEALTH_SCORE", "REPLICA_HEALTH_STATE",
                 "HEALTH_TRANSITIONS", "CANARY_REQUESTS"):
        jf, tf = getattr(jobs, name), getattr(tobs, name)
        assert (tf.name, tf.type_name, tf.labelnames) == \
            (jf.name, jf.type_name, jf.labelnames), name
        if isinstance(tf, tmetrics.Histogram):
            assert tf.buckets == jf.buckets, name
    assert set(tchaos.FaultPoints.all()) <= set(jchaos.FaultPoints.all())
    assert {"llm.kv_fetch", "fleet.join"} <= set(tchaos.FaultPoints.all())


def test_split_k_counter_cache_never_shrinks_under_threads():
    """A fleet's replicas launch from several scheduler threads onto one
    stream, so the split-K counter cache is grown under a lock: with many
    threads racing to grow it (a 1 us switch interval), every call gets a
    zeroed tensor of its size and the cached tensor never shrinks below a
    size already returned (a lost update leaves a smaller one behind)."""
    import sys
    import threading

    from mlrun_tpu_torch.ops import paged_attention as pa

    key = (torch.device("cpu"), -7)
    pa._merge_counters.pop(key, None)
    sizes = [int(n) for n in np.random.default_rng(0).integers(1, 1 << 16,
                                                                20000)]
    bad = []

    def grow(chunk):
        for n in chunk:
            got = pa._counters(key[0], key[1], n)
            if got.numel() < n or int(got.abs().sum()) != 0:
                bad.append(n)
            # the cache only grows: once a call of size n returned, no
            # racing call may have left a smaller tensor behind it
            if pa._merge_counters[key].numel() < n:
                bad.append(-n)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=grow, args=(sizes[i::16],))
                   for i in range(16)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert not bad
    assert pa._merge_counters.pop(key).numel() >= max(sizes)
