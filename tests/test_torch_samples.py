"""The engines' sample tap (mlrun_tpu_torch.serving.samples and the
engine sites) against mlrun_tpu's on the CPU, on the same converted tiny
float32 weights: the dense and paged continuous-batching engines and
``LLMEngine`` emit one sample per completion with the reference's keys,
tokens, ``prompt_len`` and ``generated``, and the same first-token
top-1 minus top-2 logit margin (``LLMEngine``: NaN, as the reference).
With no observer nothing is emitted and no margin is taken. The
reference's
``tests/test_continuous_tuning.py::test_fleet_threads_request_key_to_engine``
on the port's fleet.

Bounds: tokens, lengths and keys equal; margins within 1e-4 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.serving import llm as jllm
from mlrun_tpu.serving import llm_batch as jbatch
from mlrun_tpu.serving import paged as jpaged
from mlrun_tpu.serving import samples as jsamples
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.serving import llm as tllm
from mlrun_tpu_torch.serving import llm_batch as tbatch
from mlrun_tpu_torch.serving import paged as tpaged
from mlrun_tpu_torch.serving import samples as tsamples
from tests.torch_registries import registries_left_as_found  # noqa: F401

MARGIN_RTOL = 1e-4
KEYS = {"adapter", "tokens", "prompt_len", "generated", "ttft_s", "total_s",
        "logit_margin", "engine", "replica"}


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(autouse=True)
def _dark():
    for mod in (jsamples, tsamples):
        mod.set_sample_observer(None)
    yield
    for mod in (jsamples, tsamples):
        mod.set_sample_observer(None)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, 512, size=n).tolist() for n in (5, 11, 17)]


def _engines(models, kind):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(max_len=64, slots=2, prefill_buckets=(16, 32))
    if kind == "paged":
        kw["page_size"] = 16
        return (jpaged.PagedContinuousBatchingEngine(jcfg, jparams, **kw),
                tpaged.PagedContinuousBatchingEngine(tcfg, tparams,
                                                     device="cpu", **kw))
    return (jbatch.ContinuousBatchingEngine(jcfg, jparams, **kw),
            tbatch.ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                            **kw))


def _serve(engine, prompts) -> list:
    engine.start()
    try:
        futures = [engine.submit(p, max_new_tokens=6) for p in prompts]
        return [f.result(timeout=120)[0] for f in futures]
    finally:
        engine.stop()


def _by_prompt(samples):
    return sorted(samples, key=lambda s: s["prompt_len"])


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_engine_samples_match_the_reference(models, kind):
    rings = (jsamples.SampleRing(), tsamples.SampleRing())
    for mod, ring in zip((jsamples, tsamples), rings):
        mod.set_sample_observer(ring.append)
    jeng, teng = _engines(models, kind)
    outs = [_serve(eng, _prompts()) for eng in (jeng, teng)]
    assert outs[1] == outs[0]
    jwant, tgot = (_by_prompt(ring.drain()) for ring in rings)
    assert len(tgot) == len(jwant) == 3
    for want, got in zip(jwant, tgot):
        assert set(got) == set(want) == KEYS
        for key in ("tokens", "prompt_len", "generated", "adapter",
                    "replica"):
            assert got[key] == want[key], key
        assert got["engine"].split("-")[0] == want["engine"].split("-")[0]
        assert got["logit_margin"] > 0
        assert math.isclose(got["logit_margin"], want["logit_margin"],
                            rel_tol=MARGIN_RTOL)


def test_llm_engine_emits_a_nan_margin(models):
    jcfg, jparams, tcfg, tparams = models
    rings = (jsamples.SampleRing(), tsamples.SampleRing())
    for mod, ring in zip((jsamples, tsamples), rings):
        mod.set_sample_observer(ring.append)
    prompt = _prompts()[1]
    jllm.LLMEngine(jcfg, jparams, max_len=64, batch=1).generate(
        prompt, max_new_tokens=4)
    tllm.LLMEngine(tcfg, tparams, max_len=64, batch=1,
                   device="cpu").generate(prompt, max_new_tokens=4)
    [want], [got] = (ring.drain() for ring in rings)
    assert set(got) == set(want) == KEYS
    assert got["tokens"] == want["tokens"]
    assert got["engine"] == want["engine"] == "LLMEngine"
    assert math.isnan(got["logit_margin"]) and math.isnan(
        want["logit_margin"])


def test_dark_tap_emits_nothing_and_takes_no_margin(models, monkeypatch):
    _, teng = _engines(models, "paged")
    margins = []
    activate = teng._activate_slot

    def spy(adm):
        margins.append(adm.logit_margin)
        return activate(adm)

    monkeypatch.setattr(teng, "_activate_slot", spy)
    emitted = []
    monkeypatch.setattr(tbatch, "emit_sample",
                        lambda **s: emitted.append(s))
    _serve(teng, _prompts()[:2])
    assert len(margins) == 2 and all(math.isnan(m) for m in margins)
    assert emitted == []


def test_fleet_threads_request_key_to_engine(models):
    """The fleet hands the client's request key to the engine, so a pinned
    session's canary side is kept (the reference's regression test)."""
    from mlrun_tpu_torch.models import lora as tlora
    from mlrun_tpu_torch.serving.canary import (
        CanaryRouter,
        set_canary_router,
        split_key_for,
    )
    from mlrun_tpu_torch.serving.fleet import EngineFleet

    _, _, tcfg, tparams = models
    stable = tlora.init_lora_nonzero(tcfg, torch.Generator().manual_seed(1))
    canary = tlora.init_lora_nonzero(tcfg, torch.Generator().manual_seed(2))
    prompt = [1, 7, 3, 9, 2, 4, 6, 8]

    def factory(role):
        return tbatch.ContinuousBatchingEngine(
            tcfg, tparams, max_len=64, slots=2, prefill_buckets=(16,),
            adapters={"t1": stable, "t1@v1": canary}, device="cpu")

    router = CanaryRouter()
    router.set_split("t1", "t1@v1", 0.5)
    digest_side = router.resolve("t1", split_key_for(prompt))[1]
    key = next(f"pin-{i}" for i in range(1000)
               if router.resolve("t1", f"pin-{i}")[1] != digest_side)
    expected = router.resolve("t1", key)[0]
    ring = tsamples.SampleRing()
    set_canary_router(router)
    tsamples.set_sample_observer(ring.append)
    fleet = EngineFleet(factory, replicas=1)
    fleet.start()
    try:
        fleet.generate(prompt, max_new_tokens=4, adapter="t1",
                       request_key=key)
        samples = ring.drain()
        assert samples and samples[-1]["adapter"] == expected
    finally:
        fleet.stop()
        set_canary_router(None)
