"""mlrun_tpu_torch's host KV tier and KV handoff against mlrun_tpu's on the
CPU, at ``tiny_llama`` size in float32: ``HostKVTier``'s bounded-bytes
LRU, ancestry and pinning (the same event sequence through both tiers);
the paged engine's demote -> promote round trip (pages bit-identical to
the demoted ones, greedy tokens equal to the JAX engine's, the ledger's
``promote`` phase exact under a fake clock), on the gather route and on
the kernel route's plain versions; the chaos fallbacks of a failed
demote and a failed promote; ``fetch_prefix`` -> ``import_prefix``
(greedy parity, idempotence, a miss, the dtype check); and the KV
handoff within the port and across packages in both directions (the JAX
engine's ``submit_prefill`` payload into the port's ``submit_prefilled``
and the reverse), float32 and int8, with identical greedy tokens and the
imported bytes equal to the exported ones. bfloat16 payloads cross as
their raw bits (``KVHandoff``'s docstring).

Tolerances: none. Pages and payloads are compared bit for bit; token
streams exactly, each checked to have a top-2 logit margin above 1e-3
(the int8 engines quantize alike up to rounding ties, so their tokens
are compared only where the margins allow). The port's chaos registry,
metrics and flight recorder are reset around every test.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu import chaos as jchaos
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.serving import llm_batch as jbatch
from mlrun_tpu.serving import paged as jpaged
from mlrun_tpu.serving.kv_tier import HostKVTier as JTier
from mlrun_tpu_torch import chaos as tchaos
from mlrun_tpu_torch import obs as tobs
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.serving import llm_batch as tbatch
from mlrun_tpu_torch.serving import paged as tpaged
from mlrun_tpu_torch.serving.kv_tier import HostKVTier as TTier
from tests.torch_registries import registries_left_as_found  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_state():
    def reset():
        tchaos.chaos.clear()
        jchaos.chaos.clear()
        tobs.REGISTRY.reset()
        tobs.get_flight_recorder().clear()

    reset()
    yield
    reset()


# -- HostKVTier --------------------------------------------------------------

def _payload(nbytes=64):
    return {"k": np.zeros(nbytes, np.int8)}


def _tier_script(cls):
    """The reference tests' LRU, ancestry and pinning sequences on three
    tiers of ``cls``; returns every observable (put results, membership,
    stats)."""
    seen = []
    lru = cls(256)
    seen.append(lru.put(9, None, _payload(512)))       # over the budget
    seen.extend(lru.put(key, None, _payload(64)) for key in (1, 2, 3, 4))
    lru.get(1)                                          # LRU bump
    seen.append(lru.put(5, None, _payload(64)))
    hits = lru.stats()["hits"]
    seen.append((2 in lru, 1 in lru, 5 in lru, lru.peek(1), lru.peek(2),
                 lru.stats()["hits"] == hits, lru.stats()))
    chain = cls(192)
    seen.append(chain.put(10, None, _payload(64)))      # LRU-oldest parent
    seen.append(chain.put(11, 10, _payload(64)))        # its child
    seen.append(chain.put(20, None, _payload(64)))
    seen.append(chain.put(30, None, _payload(64)))      # child goes first
    seen.append((11 in chain, 10 in chain))
    seen.append(chain.put(31, None, _payload(64)))      # then the parent
    seen.append(10 in chain)
    pins = cls(128)
    seen.append(pins.put(1, None, _payload(64)))
    seen.append(pins.pin(1))
    seen.append(pins.put(2, None, _payload(64)))
    seen.append(pins.put(3, None, _payload(64)))        # evicts around 1
    seen.append((1 in pins, 2 in pins))
    seen.append(pins.pin(3))
    seen.append(pins.put(4, None, _payload(64)))        # all pinned
    pins.unpin(1)
    seen.append(pins.put(4, None, _payload(64)))
    seen.append((1 in pins, 3 in pins, pins.pin(99)))
    seen.append(pins.put(3, None, _payload(32)))        # refresh in place
    seen.append((len(pins), pins.bytes_used, pins.stats()))
    return seen


def test_tier_lru_ancestry_and_pinning_match_reference():
    got = _tier_script(TTier)
    assert got == _tier_script(JTier)
    # the reference tests' facts: an over-budget payload is refused; the
    # LRU-bumped entry survives; peek touches no counter; a parent with a
    # resident child outlives it; pins block eviction
    assert got[0] is False and got[6][:6] == (False, True, True, True,
                                              False, True)
    assert got[11] == (False, True) and got[13] is False
    assert got[18] == (True, False) and got[20] is False
    assert got[22] == (False, True, False)
    with pytest.raises(ValueError):
        TTier(0)


def test_tier_holds_torch_pages_by_nbytes():
    tier = TTier(1 << 20)
    page = {"k": torch.zeros((2, 8, 2, 4), dtype=torch.bfloat16),
            "v": torch.zeros((2, 8, 2, 4), dtype=torch.bfloat16)}
    assert tier.put(7, None, page)
    assert tier.bytes_used == 2 * 2 * 8 * 2 * 4 * 2
    assert tier.get(7) is page


# -- engines -----------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


# P1 caches 3 full blocks; P2 needs 7 of the 8 pool pages, so the prefix
# cache evicts (demotes) the tail of P1's chain
P1 = list(range(1, 30))
P2 = list(range(50, 100))
NEW = 4
ENGINE_KW = dict(max_len=64, slots=2, prefill_buckets=(16,), page_size=8,
                 n_pages=8)


def _jengine(models, kv="int8", **kw):
    jcfg, jparams, _, _ = models
    eng = jpaged.PagedContinuousBatchingEngine(
        jcfg, jparams, kv_dtype=kv, **{**ENGINE_KW, **kw})
    eng.start()
    return eng


def _tengine(models, kv="int8", route="gather", **kw):
    """The port's paged engine on the CPU; ``route="kernel"`` runs the
    decode, the prefix-hit prefill and the verify through the kernel
    wrappers' plain versions (set after construction: an explicit kernel
    request is refused on the CPU)."""
    _, _, tcfg, tparams = models
    eng = tpaged.PagedContinuousBatchingEngine(
        tcfg, tparams, kv_dtype=kv, device="cpu", **{**ENGINE_KW, **kw})
    if route == "kernel":
        eng.attn_impl = "kernel"
        eng.prefill_impl = "flash"
        eng.paged_prefill_impl = "kernel"
    eng.start()
    return eng


def _min_margin(models, prompt, generated) -> float:
    _, _, tcfg, tparams = models
    seq = torch.tensor([prompt + generated[:-1]], dtype=torch.long)
    logits = tllama.forward(tcfg, tparams, seq)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def _same_payload(a, b):
    assert set(a.kv) == set(b.kv)
    for name in a.kv:
        x, y = np.asarray(a.kv[name]), np.asarray(b.kv[name])
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def _tier_round_trip(eng):
    """cold P1, P2 (demotes P1's tail), P1 again (promotes it) under a
    fake ledger clock; fetches before, between and after."""
    cold, _ = eng.generate(P1, max_new_tokens=NEW)
    before = eng.fetch_prefix(P1).result(timeout=120)
    eng.generate(P2, max_new_tokens=NEW)
    demoted = eng.stats
    mid = eng.fetch_prefix(P1).result(timeout=120)
    eng._ledger_clock = itertools.count(0).__next__
    again, rstats = eng.generate(P1, max_new_tokens=NEW)
    after = eng.fetch_prefix(P1).result(timeout=120)
    return cold, again, rstats["timing"], demoted, eng.stats, \
        (before, mid, after)


COUNTS = ("kv_demotes", "kv_demoted_pages", "kv_promotes",
          "kv_promoted_pages", "prefix_hits", "kv_fetches")


@pytest.mark.parametrize("kv", ["int8", "native"])
@pytest.mark.parametrize("route", ["gather", "kernel"])
def test_demote_promote_round_trip_like_reference(models, kv, route):
    """The first prompt's evicted pages demote to the host tier and the
    rerun promotes them: pages bit-identical through device -> host ->
    device, tokens equal to the cold run's and to the JAX engine's, the
    same demote/promote counts, and the promote request's phase ledger
    equal to the reference's under the fake clock (exact closure)."""
    runs = []
    for make in (_jengine, _tengine):
        kw = {"route": route} if make is _tengine else {}
        eng = make(models, kv, kv_tier={"host_bytes": 32 << 20},
                   request_ledger=True, **kw)
        try:
            runs.append(_tier_round_trip(eng))
        finally:
            eng.stop()
    (jcold, jagain, jtiming, jdem, jstats, _), \
        (cold, again, timing, dem, stats, (before, mid, after)) = runs
    assert _min_margin(models, P1, cold) > 1e-3
    assert cold == again == jcold == jagain
    assert before.cached_prefix == mid.cached_prefix == 24
    _same_payload(before, mid)        # assembled through the host tier
    _same_payload(before, after)      # promoted back into device pages
    assert {name: a.dtype for name, a in before.kv.items()} == (
        {"k": np.int8, "v": np.int8, "k_scale": np.float32,
         "v_scale": np.float32} if kv == "int8"
        else {"k": np.float32, "v": np.float32})
    assert dem["kv_demoted_pages"] == 2 and dem["kv_tier"]["entries"] == 2
    for key in COUNTS:
        assert stats[key] == jstats[key], key
    assert stats["kv_promoted_pages"] == 2
    assert timing["attribution_closed"] and "promote" in timing["phases"]
    assert timing["wall_s"] == sum(timing["phases"].values())
    assert timing["phases"] == jtiming["phases"]
    assert timing["cached_prefix"] == jtiming["cached_prefix"] == 24
    if route == "kernel":
        # the promoted prefix was attended in place, never gathered
        assert stats["prefill_gather_admissions"] == 0
        assert stats["prefill_kernel_chunks"] >= 1


def test_tier_series_live_while_running_and_retired_on_stop(models):
    eng = _tengine(models, kv_tier={"host_bytes": 32 << 20})
    try:
        _tier_round_trip(eng)

        def samples(family):
            return [line for line in tobs.REGISTRY.render().splitlines()
                    if line.startswith(family + "{")]

        for family in ("mlt_kv_tier_bytes", "mlt_kv_tier_hits_total",
                       "mlt_kv_tier_events_total"):
            assert samples(family), family
        assert tobs.KV_TIER_HITS.value(engine=eng._obs_name, replica="",
                                       tier="host") == 2
    finally:
        eng.stop()
    leaked = [line for line in tobs.REGISTRY.render().splitlines()
              if line.startswith("mlt_kv_tier")]
    assert not leaked, leaked


def test_tier_off_engine_never_demotes(models):
    eng = _tengine(models, kv_tier=False)
    try:
        cold, _ = eng.generate(P1, max_new_tokens=NEW)
        eng.generate(P2, max_new_tokens=NEW)
        again, _ = eng.generate(P1, max_new_tokens=NEW)
        stats = eng.stats
    finally:
        eng.stop()
    assert again == cold
    assert stats["kv_demoted_pages"] == stats["kv_promotes"] == 0
    assert "kv_tier" not in stats


@pytest.mark.parametrize("point", ["llm.kv_demote", "llm.kv_promote"])
def test_tier_chaos_falls_back_to_token_prefill_like_reference(models,
                                                               point):
    """A failed demote loses the chain to the tier (the page is reclaimed
    all the same); a failed promote prefills the suffix from tokens over
    the same fresh pages. Neither is a client error: the tokens equal the
    cold run's, and the counts equal the reference's under the same
    fault."""
    runs = []
    for make, module in ((_jengine, jchaos), (_tengine, tchaos)):
        eng = make(models, kv_tier={"host_bytes": 32 << 20})
        try:
            cold, _ = eng.generate(P1, max_new_tokens=NEW)
            with module.chaos.inject(point, module.always(),
                                     error=RuntimeError("torn")):
                eng.generate(P2, max_new_tokens=NEW)
                again, _ = eng.generate(P1, max_new_tokens=NEW)
            stats = eng.stats
        finally:
            eng.stop()
        runs.append((cold, again, [stats[k] for k in COUNTS],
                     stats["kv_tier"]["entries"]))
    assert runs[1] == runs[0]
    cold, again, counts, entries = runs[1]
    assert again == cold
    assert counts[2] == counts[3] == 0              # nothing promoted
    if point == "llm.kv_demote":
        # every demote errored: counted, nothing stored, and the
        # evictions still freed their pages
        assert counts[0] >= 2 and counts[1] == 0 and entries == 0
    else:
        assert counts[1] >= 2 and entries >= 2


@pytest.mark.parametrize("kv", ["int8", "native"])
def test_fetch_import_parity_and_idempotence(models, kv):
    """fetch_prefix -> import_prefix between two port engines: the next
    request on the importer is a prefix hit with the exporter's cold
    tokens (the JAX engine's too), the ledger closes exactly; a second
    import caches nothing; a miss resolves None; a pool of another dtype
    refuses the payload."""
    jeng = _jengine(models, kv)
    try:
        jcold, _ = jeng.generate(P1, max_new_tokens=NEW)
        jpayload = jeng.fetch_prefix(P1).result(timeout=120)
    finally:
        jeng.stop()
    src = _tengine(models, kv)
    dst = _tengine(models, kv, request_ledger=True)
    other = _tengine(models, "native" if kv == "int8" else "int8")
    try:
        cold, _ = src.generate(P1, max_new_tokens=NEW)
        payload = src.fetch_prefix(P1).result(timeout=120)
        assert payload.prewarm and payload.first_token == -1
        assert payload.cached_prefix == jpayload.cached_prefix == 24
        assert dst.import_prefix(payload).result(timeout=120) == 3
        dst._ledger_clock = itertools.count(0).__next__
        tokens, stats = dst.generate(P1, max_new_tokens=NEW)
        again = src.fetch_prefix(P1).result(timeout=120)
        assert dst.import_prefix(again).result(timeout=120) == 0
        assert src.fetch_prefix(list(range(300, 312))).result(
            timeout=120) is None
        with pytest.raises(ValueError, match="dtype mismatch"):
            other.import_prefix(payload)
        dst_stats = dst.stats
    finally:
        for eng in (src, dst, other):
            eng.stop()
    assert tokens == cold == jcold
    assert stats["timing"]["cached_prefix"] == 24
    assert stats["timing"]["wall_s"] == sum(stats["timing"]["phases"]
                                            .values())
    assert dst_stats["kv_imports"] == 1 and dst_stats["kv_imported_pages"] \
        == 3 and dst_stats["prefix_hits"] == 1


# -- the KV handoff ------------------------------------------------------------

@pytest.mark.parametrize("kv", ["int8", "native"])
def test_handoff_within_the_port(models, kv):
    """submit_prefill -> submit_prefilled between two port engines gives
    the single-engine greedy tokens; an int8 payload arrives as int8 with
    float32 scales; both hops' ledgers close, the decode side's carries
    the import as ``handoff``; the handoff stats count the bytes."""
    single = _tengine(models, kv)
    prefill = _tengine(models, kv, request_ledger=True)
    decode = _tengine(models, kv, request_ledger=True)
    try:
        want, _ = single.generate(P1, max_new_tokens=NEW)
        prefill._ledger_clock = itertools.count(0).__next__
        handoff = prefill.submit_prefill(P1).result(timeout=120)
        decode._ledger_clock = itertools.count(0).__next__
        tokens, stats = decode.submit_prefilled(
            handoff, max_new_tokens=NEW).result(timeout=120)
        out_stats, in_stats = prefill.stats, decode.stats
    finally:
        for eng in (single, prefill, decode):
            eng.stop()
    assert tokens == want
    assert handoff.first_token == want[0] and handoff.prompt_len == len(P1)
    _, _, tcfg, _ = models
    rows = (tcfg.n_layers, len(P1), tcfg.n_kv_heads)
    assert handoff.kv["k"].shape == rows + (tcfg.head_dim,)
    if kv == "int8":
        assert handoff.kv["k"].dtype == np.int8
        assert handoff.kv["k_scale"].dtype == np.float32
        assert handoff.kv["k_scale"].shape == rows
    for timing in (handoff.timing, stats["timing"]):
        assert timing["attribution_closed"]
        assert timing["wall_s"] == sum(timing["phases"].values())
        assert "handoff" in timing["phases"]
    assert "prefill" in handoff.timing["phases"]
    assert "prefill" not in stats["timing"]["phases"]
    assert out_stats["handoffs_out"] == in_stats["handoffs_in"] == 1
    assert out_stats["handoff_bytes_out"] == in_stats["handoff_bytes_in"] \
        == handoff.nbytes()


def _over_the_wire(handoff, cls):
    """The payload as the receiving package rebuilds it after a process
    boundary: the same fields (the wire format), the receiver's class."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: getattr(handoff, f.name)
                  for f in dataclasses.fields(handoff) if f.name in names})


def _prefix_rows(kv: dict, rows: int) -> dict:
    return {name: np.asarray(a)[:, :rows] for name, a in kv.items()}


@pytest.mark.parametrize("kv", ["int8", "native"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_handoff_across_packages(models, kv, direction):
    """One package's submit_prefill payload into the other's
    submit_prefilled (registered as a prewarm, so its pages can be
    fetched back): the decode side gives the single-engine greedy tokens
    of both packages, and the bytes it imported — int8 values and
    float32 scales, or float32 K/V — equal the exported payload's."""
    jsingle = _jengine(models, kv)
    tsingle = _tengine(models, kv)
    try:
        jwant, _ = jsingle.generate(P1, max_new_tokens=NEW)
        twant, _ = tsingle.generate(P1, max_new_tokens=NEW)
    finally:
        jsingle.stop()
        tsingle.stop()
    assert _min_margin(models, P1, twant) > 1e-3
    if direction == "jax_to_port":
        prefill, decode = _jengine(models, kv), _tengine(models, kv)
        receiver = tbatch.KVHandoff
    else:
        prefill, decode = _tengine(models, kv), _jengine(models, kv)
        receiver = jbatch.KVHandoff
    try:
        handoff = prefill.submit_prefill(P1).result(timeout=120)
        tokens, _ = decode.submit_prefilled(
            _over_the_wire(handoff, receiver), max_new_tokens=NEW,
            register_prefix=True).result(timeout=120)
        back = decode.fetch_prefix(P1).result(timeout=120)
    finally:
        prefill.stop()
        decode.stop()
    assert tokens == twant == jwant
    assert decode.stats["handoffs_in"] == 1
    want_dtype = np.int8 if kv == "int8" else np.float32
    assert np.asarray(handoff.kv["k"]).dtype == want_dtype
    assert back.cached_prefix == 24
    sent = _prefix_rows(handoff.kv, back.cached_prefix)
    for name, array in back.kv.items():
        got = np.asarray(array)
        assert got.dtype == sent[name].dtype
        assert np.array_equal(got, sent[name]), name


def test_bf16_payload_crosses_as_raw_bits():
    """A bfloat16 pool's K/V cross as their 16-bit patterns (uint16): the
    port's wire conversion round-trips bit for bit, reads the reference's
    ml_dtypes bfloat16 arrays by their bits, and a bf16 handoff between
    two port engines decodes the single-engine tokens."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 5, 3, 4)).astype(
        np.float32)).to(torch.bfloat16)
    wire = tbatch._to_wire(x)
    assert wire.dtype == np.uint16
    assert torch.equal(tbatch._from_wire(wire), x)
    jbits = np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    assert jbits.dtype.name == "bfloat16"
    assert torch.equal(tbatch._from_wire(jbits), x)
    for a in (np.arange(6, dtype=np.int8), np.ones(3, np.float32)):
        assert np.array_equal(tbatch._from_wire(tbatch._to_wire(
            torch.from_numpy(a))).numpy(), a)
    cfg = tllama.tiny_llama(dtype=torch.bfloat16)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    engines = [tpaged.PagedContinuousBatchingEngine(
        cfg, params, device="cpu", **ENGINE_KW) for _ in range(3)]
    try:
        want, _ = engines[0].generate(P1, max_new_tokens=NEW)
        handoff = engines[1].submit_prefill(P1).result(timeout=120)
        tokens, _ = engines[2].submit_prefilled(
            handoff, max_new_tokens=NEW).result(timeout=120)
    finally:
        for eng in engines:
            eng.stop()
    assert handoff.kv["k"].dtype == np.uint16
    assert tokens == want
