"""mlrun_tpu_torch's canary router (serving/canary.py) against mlrun_tpu's
on the CPU: ``split_key_for``, ``CanaryRouter.bucket`` and ``resolve``
for 1000 (tenant, key) pairs, aliases, promotion, export and restore
across the packages, the process router's one-stop ``resolve_adapter``;
then a paged engine serving tenant ``t1`` with a canary of it
(``t1@v2``) at a 0.5 split, each request resolving to the JAX engine's
identity, with the JAX engine's greedy tokens and split telemetry, and
``LLMEngine`` resolving through the same router. Adapters are drawn by
the JAX package at ``tiny_llama`` size in float32 and converted; every
compared stream is checked to have a top-2 logit margin above 1e-3 under
its identity's merged weights. Tolerances: none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu import obs as jobs
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.models import lora as jlora
from mlrun_tpu.serving import canary as jcanary
from mlrun_tpu.serving import llm as jllm
from mlrun_tpu.serving import paged as jpaged
from mlrun_tpu_torch import obs as tobs
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models import lora as tlora
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.serving import canary as tcanary
from mlrun_tpu_torch.serving import llm as tllm
from mlrun_tpu_torch.serving import paged as tpaged
from tests.torch_registries import registries_left_as_found  # noqa: F401

MODULES = (jcanary, tcanary)
TENANTS = ("t1", "t2", "acme", "x")


@pytest.fixture(autouse=True)
def _fresh_state():
    tobs.REGISTRY.reset()
    yield
    for module in MODULES:
        module.set_canary_router(None)
    tobs.REGISTRY.reset()


def _keys(n=1000):
    rng = np.random.default_rng(0)
    return [(TENANTS[i % len(TENANTS)],
             f"user-{int(rng.integers(1 << 30))}") for i in range(n)]


def _routers(fractions=None):
    routers = []
    for module in MODULES:
        router = module.CanaryRouter()
        router.set_alias("t2", "t2@v3")
        router.set_split("t1", "t1@v2", (fractions or {}).get("t1", 0.5))
        router.set_split("acme", "acme@v7",
                         (fractions or {}).get("acme", 0.1))
        routers.append(router)
    return routers


@pytest.mark.parametrize("fraction", [0.05, 0.5, 0.95])
def test_bucket_and_resolve_match_reference(fraction):
    """The same bucket and the same (effective id, side) for 1000 (tenant,
    key) pairs; the split fraction lands within sampling error."""
    jrouter, trouter = _routers({"t1": fraction})
    canary = 0
    for tenant, key in _keys():
        assert tcanary.CanaryRouter.bucket(tenant, key) == \
            jcanary.CanaryRouter.bucket(tenant, key)
        got = trouter.resolve(tenant, key)
        assert got == jrouter.resolve(tenant, key)
        canary += got[1] == "canary" and tenant == "t1"
    assert abs(canary / 250 - fraction) < 0.1
    assert trouter.resolve("", "k") == ("", "")
    assert trouter.resolve("t1@v2", "k") == ("t1@v2", "")


def test_split_key_and_resolve_adapter_match_reference():
    prompts = [[1, 2, 3], list(range(40)), [7]]
    for prompt in prompts:
        for explicit in (None, "", "session-9", 12):
            assert tcanary.split_key_for(prompt, explicit) == \
                jcanary.split_key_for(prompt, explicit)
    routers = _routers()
    for module, router in zip(MODULES, routers):
        assert module.resolve_adapter("t1", prompts[1]) == "t1"  # dark
        module.set_canary_router(router)
        assert module.get_canary_router() is router
    for prompt in prompts:
        for key in (None, "session-1", "session-2"):
            for tenant in ("t1", "t2", "", "zz"):
                assert tcanary.resolve_adapter(tenant, prompt, key) == \
                    jcanary.resolve_adapter(tenant, prompt, key)


def test_state_ops_export_and_restore_match_reference():
    """Aliases, promotion, clearing and the validation errors behave as
    the reference's; an export of either package restores into the other
    hash-identically."""
    jrouter, trouter = _routers()
    assert trouter.export_state() == jrouter.export_state()
    for router in (jrouter, trouter):
        with pytest.raises(ValueError):
            router.set_split("t1", "t1", 0.5)
        with pytest.raises(ValueError):
            router.set_split("t1", "t1@v9", 1.0)
        with pytest.raises(ValueError):
            router.set_alias("t@1", "x")
        with pytest.raises(ValueError):
            router.promote("nobody")
    assert trouter.promote("t1") == jrouter.promote("t1") == "t1@v2"
    trouter.clear_split("acme")
    jrouter.clear_split("acme")
    assert trouter.export_state() == jrouter.export_state()
    # after promotion t1 resolves to the promoted version, unsplit
    assert trouter.resolve("t1", "any") == jrouter.resolve("t1", "any") \
        == ("t1@v2", "stable")
    fresh = _routers()
    crossed = [tcanary.CanaryRouter(), jcanary.CanaryRouter()]
    crossed[0].restore_state(fresh[0].export_state())
    crossed[1].restore_state(fresh[1].export_state())
    for tenant, key in _keys(200):
        assert crossed[0].resolve(tenant, key) == \
            crossed[1].resolve(tenant, key) == fresh[0].resolve(tenant, key)


def test_split_is_metered_only_when_counted():
    router = _routers()[1]
    router.resolve("t1", "k1")
    assert tobs.CANARY_REQUESTS.value(adapter="t1", side="stable") + \
        tobs.CANARY_REQUESTS.value(adapter="t1", side="canary") == 0
    _, side = router.resolve("t1", "k1", count=True)
    router.resolve("t2", "k1", count=True)     # alias only: unmetered
    assert tobs.CANARY_REQUESTS.value(adapter="t1", side=side) == 1
    assert tobs.CANARY_REQUESTS.value(adapter="t2", side="stable") == 0


# -- engines -------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    jads = {name: jlora.init_lora_nonzero(jcfg, jax.random.PRNGKey(seed),
                                          rank=4, alpha=8.0)
            for name, seed in (("t1", 1), ("t1@v2", 2))}

    def convert(tree):
        return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")

    return (jcfg, jparams, tcfg, convert(jparams), jads,
            {name: convert(tree) for name, tree in jads.items()})


def _margin(tcfg, params, prompt, generated) -> float:
    seq = torch.tensor([prompt + generated[:-1]], dtype=torch.long)
    logits = tllama.forward(tcfg, params, seq)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


PROMPTS = [[1, 7, 3, 9, 2, 4, 6, 8, 5, 3, 1, 2],
           [4, 4, 9, 1, 30, 2, 8, 17, 5]]
REQUEST_KEYS = [None, "alice", "bob", "carol", "dave", "erin"]


def _serve(engine, requests):
    return [engine.generate(prompt, max_new_tokens=5, adapter="t1",
                            request_key=key)[0] for prompt, key in requests]


def test_paged_engine_canary_split_like_reference(setup):
    """t1 with its canary t1@v2 at a 0.5 split: each request resolves to
    the JAX engine's identity (the same side for its request key) and
    gets the JAX engine's tokens, which are the resolved adapter's own;
    the split telemetry counts the same sides."""
    jcfg, jparams, tcfg, tparams, jads, tads = setup
    requests = [(prompt, key) for key in REQUEST_KEYS for prompt in PROMPTS]
    sides = []
    for module in MODULES:
        router = module.CanaryRouter()
        router.set_split("t1", "t1@v2", 0.5)
        module.set_canary_router(router)
        sides.append([router.resolve("t1", module.split_key_for(p, k))
                      for p, k in requests])
    assert sides[1] == sides[0]
    assert {side for _, side in sides[1]} == {"stable", "canary"}
    kw = dict(max_len=64, slots=2, prefill_buckets=(16,), page_size=8)
    jeng = jpaged.PagedContinuousBatchingEngine(jcfg, jparams, adapters=jads,
                                                **kw)
    teng = tpaged.PagedContinuousBatchingEngine(tcfg, tparams, adapters=tads,
                                                device="cpu", **kw)
    for eng in (jeng, teng):
        eng.start()
    metered = []
    try:
        for eng, obs in ((jeng, jobs), (teng, tobs)):
            base = {side: obs.CANARY_REQUESTS.value(adapter="t1", side=side)
                    for side in ("stable", "canary")}
            outs = _serve(eng, requests)
            metered.append({side: obs.CANARY_REQUESTS.value(
                adapter="t1", side=side) - base[side] for side in base})
            if eng is jeng:
                want = outs
            else:
                got = outs
        # with the router dark every identity names itself
        tcanary.set_canary_router(None)
        direct = [teng.generate(prompt, max_new_tokens=5,
                                adapter=identity)[0]
                  for (prompt, _), (identity, _) in zip(requests, sides[1])]
        apart = [teng.generate(prompt, max_new_tokens=5, adapter=identity)[0]
                 for prompt in PROMPTS for identity in ("t1", "t1@v2")]
    finally:
        for eng in (jeng, teng):
            eng.stop()
    assert got == want == direct
    # the two identities serve different streams, so the tokens name the
    # identity each request resolved to
    assert apart[0] != apart[1] and apart[2] != apart[3]
    for (prompt, _), (identity, _), tokens in zip(requests, sides[1], got):
        params = tlora.merge_lora(tparams, tads[identity])
        assert _margin(tcfg, params, prompt, tokens) > 1e-3
    # the reference's counter is process-wide: both are read as deltas
    assert metered[1] == metered[0] == {
        side: sum(s == side for _, s in sides[1])
        for side in ("stable", "canary")}


def test_llm_engine_canary_resolution_like_reference(setup):
    """LLMEngine.generate resolves the tenant through the same router
    (request_key pins the side) and serves the JAX engine's tokens."""
    jcfg, jparams, tcfg, tparams, jads, tads = setup
    for module in MODULES:
        router = module.CanaryRouter()
        router.set_split("t1", "t1@v2", 0.5)
        module.set_canary_router(router)
    jeng = jllm.LLMEngine(jcfg, jparams, max_len=64, adapters=jads)
    teng = tllm.LLMEngine(tcfg, tparams, max_len=64, adapters=tads,
                          device="cpu")
    requests = [(PROMPTS[0], key) for key in REQUEST_KEYS[1:5]]
    want = _serve(jeng, requests)
    got = _serve(teng, requests)
    assert got == want
    counted = sum(tobs.CANARY_REQUESTS.value(adapter="t1", side=side)
                  for side in ("stable", "canary"))
    assert counted == len(requests)
