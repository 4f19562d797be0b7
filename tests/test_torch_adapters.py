"""mlrun_tpu_torch's multi-tenant LoRA serving against mlrun_tpu's on the
CPU, at ``tiny_llama`` size in float32: the adapter registry (one event
sequence through both registries, equal stats; eviction never touches a
pinned in-flight adapter; a failing source fails one request), the
per-tenant rate limiter, the ``.npz`` artifact in both directions, and
every engine with adapters — the dense and the paged engine (native and
int8 pools; the paged engine on its gather route and on its kernel
route's plain versions), ``LLMEngine``, ``LLMModelServer`` and speculative
decoding with tenant rows.

Adapters are drawn by the JAX package and converted. Greedy tokens must
be identical to the JAX engine's; every compared stream is checked to
have a top-2 logit margin above 1e-3 under its tenant's merged weights,
so no comparison rides on a float near-tie. Speculation rides the
reference's permutation pair (argmax gaps O(50)) with a tiny adapter, so
streams and spec counts are exact. The JAX engines' outputs are memoized
per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.models import lora as jlora
from mlrun_tpu.serving import adapters as jadapters
from mlrun_tpu.serving import llm as jllm
from mlrun_tpu.serving import llm_batch as jbatch
from mlrun_tpu.serving import paged as jpaged
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models import lora as tlora
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.serving import adapters as tadapters
from mlrun_tpu_torch.serving import llm as tllm
from mlrun_tpu_torch.serving import llm_batch as tbatch
from mlrun_tpu_torch.serving import paged as tpaged
from tests.torch_registries import registries_left_as_found  # noqa: F401

PROMPT = [1, 7, 3, 9, 2, 4, 6, 8, 5, 3, 1, 2]   # one full page at page 8
NEW = 6
KW = dict(max_len=64, prefill_buckets=(16,))
PAGED_KW = dict(page_size=8)
TENANTS = ("t1", "t2", "")
MARGIN = 1e-3


def _convert(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _jadapter(jcfg, seed, **kw):
    kw = {"rank": 4, "alpha": 8.0, **kw}
    return jlora.init_lora_nonzero(jcfg, jax.random.PRNGKey(seed), **kw)


@pytest.fixture(scope="module")
def setup():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    jads = {"t1": _jadapter(jcfg, 1), "t2": _jadapter(jcfg, 2)}
    tads = {name: _convert(tree) for name, tree in jads.items()}
    return jcfg, jparams, tcfg, _convert(jparams), jads, tads


def _min_margin(tcfg, params, prompt, generated) -> float:
    seq = torch.tensor([prompt + generated[:-1]], dtype=torch.long)
    logits = tllama.forward(tcfg, params, seq)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def _assert_margins(setup, outs: dict, prompt=PROMPT):
    """Each tenant's stream is a clear argmax under its merged weights."""
    _, _, tcfg, tparams, _, tads = setup
    for tenant, tokens in outs.items():
        params = tlora.merge_lora(tparams, tads[tenant]) if tenant \
            else tparams
        assert _min_margin(tcfg, params, prompt, tokens) > MARGIN, tenant


# -- the registry ---------------------------------------------------------------

EVENTS = (("pin", "nope"), ("pin", "t1"), ("pin", "t2"),
          ("load", "t1"), ("load", "t2"), ("pin", "t3"), ("unpin", "t1"),
          ("pin", "t3"), ("load", "t3"), ("unpin", "t2"), ("pin", "t1"),
          ("load", "t1"), ("load", "t1"), ("retire", "t3"), ("unpin", "t3"),
          ("retire", "t3"), ("pin", "t3"), ("check", "t2"), ("check", "x"),
          ("unpin", "t1"), ("retire", "t2"))


def _drive_registry(reg, factor_of):
    """One event sequence; each event's outcome (a slot, an error class
    name or None) and, after every load, the slot's bank factors."""
    outcomes, banks = [], []
    for op, name in EVENTS:
        try:
            if op == "pin":
                out = reg.pin(name)
            elif op == "unpin":
                out = reg.unpin(name)
            elif op == "retire":
                out = reg.retire(name)
            elif op == "check":
                out = reg.check_known(name)
            else:
                out = reg.ensure_loaded(name)
                banks.append(factor_of(reg.bank.tensors["wq"]["lora_b"][out]))
        except Exception as exc:  # noqa: BLE001 - the outcome compared
            out = type(exc).__name__
        outcomes.append(out)
    return outcomes, banks, dict(reg.stats), reg.resident_names(), \
        reg.live()


def test_registry_event_sequence_matches_reference(setup):
    """pin / load / evict / capacity / unknown / retire, one sequence
    through both registries: the same outcomes (slots, 404s, 429s), the
    same bank contents per load, equal stats dicts and residents."""
    jcfg, _, tcfg, _, jads, _ = setup
    jsources = dict(jads, t3=_jadapter(jcfg, 3))
    tsources = {name: _convert(tree) for name, tree in jsources.items()}
    jreg = jadapters.AdapterRegistry(jcfg, sources=jsources, max_live=2)
    treg = tadapters.AdapterRegistry(tcfg, sources=tsources, max_live=2)
    want = _drive_registry(jreg, np.asarray)
    got = _drive_registry(treg, lambda t: t.numpy().copy())
    assert got[0] == want[0]
    assert "UnknownAdapterError" in got[0]
    assert "AdapterCapacityError" in got[0]
    for a, b in zip(want[1], got[1]):
        np.testing.assert_array_equal(a, b)
    assert got[2:] == want[2:]
    assert got[2]["adapter_evictions"] >= 2


def test_registry_errors_are_typed_like_reference():
    for name in ("AdapterError", "UnknownAdapterError",
                 "AdapterCapacityError", "AdapterRateLimitError"):
        assert getattr(tadapters, name).status_code == \
            getattr(jadapters, name).status_code
    assert issubclass(tadapters.AdapterCapacityError,
                      tadapters.AdmissionRejected)
    assert issubclass(tadapters.AdapterCapacityError, tadapters.AdapterError)


def test_bank_loads_in_place_and_validates(setup):
    """``load_slot`` writes into the bank's existing storage (a holder of
    the tensors sees the new rows), zeroes targets the adapter does not
    train, and rejects a tree of another rank or config."""
    jcfg, _, tcfg, _, _, tads = setup
    bank = tadapters.AdapterBank(tcfg, 2, 4,
                                 tlora.DEFAULT_TARGETS + ("w_up",))
    held = bank.tensors["wq"]["lora_a"]
    pointer = held.data_ptr()
    bank.load_slot(1, tads["t1"])
    assert bank.tensors["wq"]["lora_a"].data_ptr() == pointer
    assert torch.equal(held[1], tads["t1"]["wq"]["lora_a"])
    assert not bank.tensors["w_up"]["lora_b"][1].any()
    assert not held[0].any() and not held[2].any()
    with pytest.raises(tlora.LoraShapeError):
        bank.load_slot(2, _convert(_jadapter(jcfg, 5, rank=2)))
    with pytest.raises(ValueError, match="out of range"):
        bank.load_slot(0, tads["t1"])


def test_rate_limiter_matches_reference_on_a_fake_clock():
    """The same (tenant, time) sequence through both token buckets gives
    the same accept / deny sequence."""
    clock = {"t": 0.0}
    jlim = jadapters.TenantRateLimiter(2.0, 3, now_fn=lambda: clock["t"])
    tlim = tadapters.TenantRateLimiter(2.0, 3, now_fn=lambda: clock["t"])
    rng = np.random.default_rng(0)
    got, want = [], []
    for _ in range(60):
        clock["t"] += float(rng.exponential(0.2))
        tenant = ("a", "b", "")[int(rng.integers(3))]
        want.append(jlim.try_acquire(tenant))
        got.append(tlim.try_acquire(tenant))
    assert got == want and not all(got) and any(got)
    with pytest.raises(tadapters.AdapterRateLimitError):
        for _ in range(10):
            tlim.check("a")


def test_adapter_artifact_round_trip_both_ways(tmp_path, setup):
    """An adapter the JAX package saved loads in the port bit for bit,
    and the reverse; a path source fills a bank slot; a datastore url is
    not ported (item 10)."""
    _, _, tcfg, _, jads, tads = setup
    jadapters.save_adapter(str(tmp_path / "j.npz"), jads["t1"])
    tadapters.save_adapter(str(tmp_path / "t.npz"), tads["t2"])
    from_jax = tadapters.load_adapter(str(tmp_path / "j.npz"))
    from_port = jadapters.load_adapter(str(tmp_path / "t.npz"))
    for loaded, tree in ((from_jax, jads["t1"]), (from_port, jads["t2"])):
        assert set(loaded) == set(tree)
        for target, parts in tree.items():
            for key in ("lora_a", "lora_b", "scaling"):
                np.testing.assert_array_equal(loaded[target][key],
                                              np.asarray(parts[key]))
    reg = tadapters.AdapterRegistry(tcfg, sources={"t1": str(tmp_path /
                                                             "j.npz")})
    reg.pin("t1")
    slot = reg.ensure_loaded("t1")
    assert slot >= 1
    assert torch.equal(reg.bank.tensors["wq"]["lora_a"][slot],
                       tads["t1"]["wq"]["lora_a"])
    with pytest.raises(NotImplementedError, match="item 10"):
        tadapters.load_adapter("s3://bucket/t1.npz")


# -- the engines ----------------------------------------------------------------

ENGINES = {
    "dense": (jbatch.ContinuousBatchingEngine,
              tbatch.ContinuousBatchingEngine, {}),
    "paged": (jpaged.PagedContinuousBatchingEngine,
              tpaged.PagedContinuousBatchingEngine, PAGED_KW),
    "paged_int8": (jpaged.PagedContinuousBatchingEngine,
                   tpaged.PagedContinuousBatchingEngine,
                   dict(PAGED_KW, kv_dtype="int8")),
}
_JAX_MEMO: dict = {}


def _drive_tenants(engine, paged: bool):
    """t1, t2 and base submitted together (one decode batch), then t1
    again (a same-tenant prefix hit on the paged engines). Returns the
    streams and the stats after each part."""
    futures = {tenant: engine.submit(PROMPT, max_new_tokens=NEW,
                                     adapter=tenant) for tenant in TENANTS}
    outs = {tenant: list(map(int, f.result(timeout=300)[0]))
            for tenant, f in futures.items()}
    first = engine.stats
    again = list(map(int, engine.generate(PROMPT, max_new_tokens=NEW,
                                          adapter="t1")[0]))
    return outs, again, first, engine.stats


def _jax_tenants(setup, kind):
    if kind not in _JAX_MEMO:
        jcfg, jparams, _, _, jads, _ = setup
        jcls, _, extra = ENGINES[kind]
        engine = jcls(jcfg, jparams, slots=3, adapters=jads, **KW, **extra)
        engine.start()
        try:
            _JAX_MEMO[kind] = _drive_tenants(engine, "paged" in kind)
        finally:
            engine.stop()
    return _JAX_MEMO[kind]


@pytest.mark.parametrize("kind,route", [("dense", "dense"),
                                        ("paged", "reference"),
                                        ("paged", "kernel"),
                                        ("paged_int8", "reference"),
                                        ("paged_int8", "kernel")])
def test_engine_tenant_rows_match_reference(setup, kind, route):
    """Three tenants (t1, t2, base) on one decode batch give the JAX
    engine's greedy tokens, and the adapters really diverge. On the paged
    engines the same prompt under two adapters shares no prefix KV, the
    same tenant's rerun hits its own pages with the same tokens, and two
    adapters are live. ``route="kernel"`` drives the kernel route's plain
    versions (decode, and the prefix hit's paged prefill + bounded
    flash): adapter rows take the same attention route as base rows."""
    _, _, tcfg, tparams, _, tads = setup
    _, tcls, extra = ENGINES[kind]
    engine = tcls(tcfg, tparams, slots=3, adapters=tads, device="cpu",
                  **KW, **extra)
    if route == "kernel":
        engine.attn_impl = "kernel"
        engine.prefill_impl = "flash"
        engine.paged_prefill_impl = "kernel"
    engine.start()
    try:
        got = _drive_tenants(engine, "paged" in kind)
    finally:
        engine.stop()
    want = _jax_tenants(setup, kind)
    outs, again, first, last = got
    assert outs == want[0] and again == want[1]
    _assert_margins(setup, outs)
    assert len({tuple(t) for t in outs.values()}) == 3
    assert again == outs["t1"]
    assert last["adapter_live"] == want[3]["adapter_live"] == 2
    assert last["adapter_loads"] == want[3]["adapter_loads"] == 2
    if "paged" in kind:
        assert first["prefix_hits"] == want[2]["prefix_hits"] == 0
        assert last["prefix_hits"] == want[3]["prefix_hits"] == 1
        if route == "kernel":
            assert last["attn_gather_ticks"] == 0
            assert last["attn_kernel_ticks"] > 0
            assert last["prefill_kernel_chunks"] > 0
            assert last["prefill_gather_admissions"] == 0


def test_llm_engine_adapters_match_reference(setup):
    """``LLMEngine.generate(adapter=)`` and ``generate_batch`` with one
    adapter per row (base included) against the JAX engine."""
    jcfg, jparams, tcfg, tparams, jads, tads = setup
    kw = dict(max_len=64, batch=3, prefill_buckets=(16,))
    jeng = jllm.LLMEngine(jcfg, jparams, adapters=jads, **kw)
    teng = tllm.LLMEngine(tcfg, tparams, adapters=tads, device="cpu", **kw)
    outs = {}
    for eng, side in ((jeng, "jax"), (teng, "port")):
        single = [list(map(int, eng.generate(PROMPT, NEW, adapter=a)[0]))
                  for a in TENANTS]
        batch, _ = eng.generate_batch([PROMPT] * 3, NEW,
                                      adapters=list(TENANTS))
        outs[side] = (single, [list(map(int, t)) for t in batch])
    assert outs["port"] == outs["jax"]
    single, batch = outs["port"]
    assert single == batch
    _assert_margins(setup, dict(zip(TENANTS, single)))
    assert teng._adapters.pinned_counts() == {}
    with pytest.raises(tadapters.UnknownAdapterError):
        teng.generate_batch([PROMPT], NEW, adapters=["nope"])


class _Event:
    def __init__(self, body, path="/v2/models/m/infer"):
        self.body = body
        self.path = path


@pytest.mark.parametrize("paged", [False, True])
def test_llm_model_server_serves_adapters_like_reference(setup, monkeypatch,
                                                         paged):
    """``LLMModelServer(adapters=...)`` — its default ``LLMEngine`` and
    the paged engine — answers a v2 body naming ``"adapter": "t1"`` with
    the JAX server's tokens, and an unknown adapter with a 404."""
    from mlrun_tpu.frameworks.jax import auto_trainer as jauto

    jcfg, _, tcfg, tparams, jads, tads = setup
    monkeypatch.setitem(jauto.MODEL_PRESETS, "tiny", lambda: jcfg)
    monkeypatch.setitem(tllama.MODEL_PRESETS, "tiny", lambda: tcfg)
    monkeypatch.setattr(tllama, "init_params",
                        lambda config, generator, device: tparams)
    common = dict(name="m", model_preset="tiny", max_len=64,
                  max_new_tokens=NEW, warmup=False, max_live_adapters=2)
    if paged:
        common.update(continuous_batching=True, paged=True, slots=2,
                      page_size=8)
    servers = (jllm.LLMModelServer(adapters=jads, **common),
               tllm.LLMModelServer(adapters=tads, device="cpu", **common))
    body = {"inputs": [PROMPT], "adapter": "t1"}
    try:
        outs = [server.do_event(_Event(dict(body))).body["outputs"]
                for server in servers]
        with pytest.raises(tadapters.UnknownAdapterError):
            servers[1].do_event(_Event({"inputs": [PROMPT],
                                        "adapter": "nope"}))
    finally:
        for server in servers:
            if server.engine is not None and paged:
                server.engine.stop()
    assert [list(map(int, t)) for t in outs[1]] == \
        [list(map(int, t)) for t in outs[0]]
    assert len(outs[1][0]) == NEW


def test_eviction_never_touches_a_pinned_inflight_adapter(setup):
    """With two bank slots, t1 pinned by a long in-flight generation
    while t2, t3 and t4 churn through the other slot: residency churns,
    t1 is never the victim, and its stream is its merged weights'."""
    jcfg, _, tcfg, tparams, _, tads = setup
    sources = dict(tads, t3=_convert(_jadapter(jcfg, 3)),
                   t4=_convert(_jadapter(jcfg, 4)))
    eng = tpaged.PagedContinuousBatchingEngine(
        tcfg, tparams, slots=2, adapters=sources, max_live_adapters=2,
        device="cpu", **KW, **PAGED_KW)
    registry = eng._adapters
    evicted = []
    pin = registry.pin

    def watching_pin(name):
        before = set(registry.resident_names())
        pin(name)
        evicted.extend(before - set(registry.resident_names()))

    registry.pin = watching_pin
    eng.start()
    try:
        long_future = eng.submit(PROMPT, max_new_tokens=40, adapter="t1")
        for name in ("t2", "t3", "t4"):
            eng.generate(PROMPT[:9], max_new_tokens=2, adapter=name)
        long_tokens, _ = long_future.result(timeout=300)
        stats = eng.stats
    finally:
        eng.stop()
    assert evicted and "t1" not in evicted
    assert stats["adapter_evictions"] == len(evicted) >= 2
    merged = tpaged.PagedContinuousBatchingEngine(
        tcfg, tlora.merge_lora(tparams, tads["t1"]), slots=2, device="cpu",
        **KW, **PAGED_KW)
    try:
        want, _ = merged.generate(PROMPT, max_new_tokens=NEW)
    finally:
        merged.stop()
    assert long_tokens[:NEW] == want


def test_failing_source_fails_one_request_engine_serves_on(setup):
    """A callable source that raises fails that one request with its
    error; the engine goes on serving other tenants and the base."""
    _, _, tcfg, tparams, _, tads = setup

    def broken():
        raise RuntimeError("artifact store down")

    eng = tbatch.ContinuousBatchingEngine(
        tcfg, tparams, slots=2, adapters=dict(tads, bad=broken),
        device="cpu", **KW)
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="store down"):
            eng.submit(PROMPT, NEW, adapter="bad").result(timeout=300)
        ok = eng.submit(PROMPT, NEW, adapter="t1").result(timeout=300)[0]
        base = eng.submit(PROMPT, NEW).result(timeout=300)[0]
        stats = eng.stats
    finally:
        eng.stop()
    assert len(ok) == len(base) == NEW and ok != base
    assert stats["adapter_load_errors"] == 1
    assert stats["completed"] == 2
    assert eng._adapters.pinned_counts() == {}


def test_flooding_tenant_is_rate_limited_others_unaffected(setup):
    """A tenant over its bucket is shed with a typed 429 before the
    queue; the other tenant and the base ride their own buckets; an
    unknown name is a 404, never a 429 (it mints no bucket)."""
    _, _, tcfg, tparams, _, tads = setup
    eng = tbatch.ContinuousBatchingEngine(
        tcfg, tparams, slots=2, adapters=tads, adapter_rate=0.001,
        adapter_burst=3, device="cpu", **KW)
    eng.start()
    try:
        flood = [eng.submit(PROMPT, max_new_tokens=2, adapter="t1")
                 for _ in range(10)]
        shed = [f for f in flood if f.done() and f.exception() is not None]
        assert len(shed) == 7
        for f in shed:
            assert isinstance(f.exception(), tadapters.AdapterRateLimitError)
            assert f.exception().status_code == 429
        unknown = eng.submit(PROMPT, max_new_tokens=2, adapter="nope")
        assert unknown.exception(timeout=5).status_code == 404
        others = [eng.submit(PROMPT, max_new_tokens=2, adapter=a)
                  for a in ("t2", "t2", "t2", "", "", "")]
        for f in others + flood[:3]:
            assert len(f.result(timeout=300)[0]) == 2
        stats = eng.stats
    finally:
        eng.stop()
    assert stats["adapter_rate_limited"] == 7 and stats["shed"] == 0
    assert stats["adapter_rejected_unknown"] == 1
    assert "nope" not in eng._tenant_limiter._buckets


# -- speculative decoding with tenant rows ------------------------------------

SPEC_COUNTS = ("spec_rounds", "spec_proposed", "spec_accepted",
               "spec_tokens")


@pytest.fixture(scope="module")
def perm():
    """The reference's permutation pair (overlap 0.7, vocab 64) with a
    tiny target adapter and a tiny draft adapter (deltas far below the
    O(50) argmax gaps), and their conversions."""
    jcfg = dataclasses.replace(
        jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference"),
        vocab_size=64, tie_embeddings=False)
    tcfg = tllama.tiny_llama(dtype=torch.float32, vocab_size=64,
                             tie_embeddings=False)
    target_perm, draft_perm = jllama.permutation_pair(64, overlap=0.7)
    jtarget = jllama.init_permutation_params(jcfg, target_perm)
    jdraft = jllama.init_permutation_params(jcfg, draft_perm)
    lora = _jadapter(jcfg, 5, rank=2, alpha=0.1, b_scale=0.001)
    draft_lora = _jadapter(jcfg, 7, rank=2, alpha=0.1, b_scale=0.001)
    return (jcfg, tcfg, (jtarget, jdraft, lora, draft_lora),
            tuple(_convert(t) for t in (jtarget, jdraft, lora, draft_lora)))


def _spec_run(cls, cfg, trees, spec: bool, tenant_draft: bool, **kw):
    """A tenant request and a base request on one engine, spec off or on
    (with the base draft, or a per-tenant draft adapter attached)."""
    target, draft, lora, draft_lora = trees
    spec_conf = ({"enabled": True, "k": 4, "draft_config": cfg,
                  "draft_params": draft} if spec else None)
    engine = cls(cfg, target, slots=2, speculative=spec_conf,
                 adapters={"t1": lora}, **KW, **kw)
    if tenant_draft:
        engine._adapters.attach_draft(cfg, sources={"t1": draft_lora})
    engine.start()
    try:
        tenant = engine.submit(PROMPT, max_new_tokens=8,
                               adapter="t1").result(timeout=300)[0]
        base = engine.generate(PROMPT, max_new_tokens=8)[0]
        stats = engine.stats
    finally:
        engine.stop()
    draft_reg = engine._adapters.draft
    draft_loads = draft_reg.stats["adapter_loads"] if draft_reg else None
    return list(map(int, tenant)), list(map(int, base)), \
        {key: stats.get(key) for key in SPEC_COUNTS}, draft_loads


@pytest.mark.parametrize("tenant_draft", [False, True])
@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_spec_adapter_rows_identity_with_tenant_draft(perm, kind,
                                                      tenant_draft):
    """Adapter rows keep exact greedy identity under speculation — the
    verify runs under the tenant's target adapter — with the base draft
    model and with a per-tenant draft adapter (``attach_draft``); the
    spec counts equal the JAX engine's on the same traffic. The port's
    tenant draft adapter really loads; the reference's never does (its
    draft ``ensure_loaded`` runs without a pin, ROADMAP.md queue 3), so
    the adapters are small enough that both drafts propose alike."""
    jcfg, tcfg, jtrees, ttrees = perm
    jcls, tcls, extra = ENGINES[kind]
    off = _spec_run(tcls, tcfg, ttrees, False, False, device="cpu",
                    **extra)
    on = _spec_run(tcls, tcfg, ttrees, True, tenant_draft, device="cpu",
                   **extra)
    jon = _spec_run(jcls, jcfg, jtrees, True, tenant_draft, **extra)
    assert on[:2] == off[:2] == jon[:2]
    assert on[2] == jon[2]
    assert on[2]["spec_rounds"] > 0
    assert (on[3], jon[3]) == ((1, 0) if tenant_draft else (None, None))
