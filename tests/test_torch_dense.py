"""mlrun_tpu_torch's dense serving path against mlrun_tpu's on the CPU, on
the same converted tiny float32 weights: ``LLMEngine`` (greedy chunks,
EOS, the capacity guard, ``generate_batch``, an int8 cache, sampling),
the dense ``ContinuousBatchingEngine`` (whole-prompt and chunked prefill,
an int8 cache, speculative decoding with the permutation pair), the dense
verify step and ``LLMModelServer``'s two non-paged branches.

Greedy tokens must be identical; every compared stream is checked to
have a top-2 logit margin above 1e-3 at each generated position, so no
comparison rides on a float near-tie. Chunked prefill is held against the
JAX engine's own streams on the same inputs (never against a test oracle
of the reference: one of those fails on the reference itself). The port's
chunked resumes also run the cached flash route's plain version
(``prefill_impl = "flash"`` set after construction: an explicit kernel
request is refused on the CPU). int8 caches: values equal but at rounding
ties straddled by the two frameworks' float32 matmuls (off by one, at
most 1 in 1000), scales within 1e-5 relative; every quantization the
port made is the reference's bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.serving import llm as jllm
from mlrun_tpu.serving import llm_batch as jbatch
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.serving import llm as tllm
from mlrun_tpu_torch.serving import llm_batch as tbatch
from mlrun_tpu_torch.serving.adapters import UnknownAdapterError
from mlrun_tpu_torch.serving.resilience import PromptTooLongError
from tests.torch_registries import registries_left_as_found  # noqa: F401

MAX_LEN = 128
BUCKETS = (32, 64)
TIE_SHARE = 1e-3
SCALE_RTOL = 1e-5


def _convert(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    return jcfg, jparams, tcfg, _convert(jparams)


def _tokens(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=n).tolist()


def _min_margin(tcfg, tparams, prompt, generated) -> float:
    seq = torch.tensor([prompt + generated[:-1]], dtype=torch.long)
    logits = tllama.forward(tcfg, tparams, seq)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def _assert_margins(tcfg, tparams, prompts, outs):
    for prompt, tokens in zip(prompts, outs):
        assert _min_margin(tcfg, tparams, prompt, tokens) > 1e-3


def _assert_int8_state(j: dict, t: dict, index=slice(None)):
    for name in ("k", "v"):
        diff = np.abs(np.asarray(j[name])[index].astype(np.int32)
                      - t[name].numpy()[index].astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= TIE_SHARE, \
            (name, int(diff.max()), float((diff > 0).mean()))
        np.testing.assert_allclose(t[f"{name}_scale"].numpy()[index],
                                   np.asarray(j[f"{name}_scale"])[index],
                                   rtol=SCALE_RTOL, atol=0)


@pytest.fixture
def quantize_calls(monkeypatch):
    """Record every (input, int8 values, scales) the port's serving code
    quantizes."""
    calls = []
    quantize = tllm._quantize_kv

    def recording(x):
        q, s = quantize(x)
        calls.append((x.detach().clone(), q.clone(), s.clone()))
        return q, s

    monkeypatch.setattr(tllm, "_quantize_kv", recording)
    return calls


def _assert_reference_bits(calls, least: int):
    assert len(calls) >= least
    for x, q, scale in calls:
        jq, js = jllm._quantize_kv(jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(np.asarray(jq), q.numpy())
        np.testing.assert_array_equal(np.asarray(js), scale.numpy())


# -- LLMEngine ---------------------------------------------------------------

def _jengine(models, **kw):
    jcfg, jparams, _, _ = models
    return jllm.LLMEngine(jcfg, jparams, max_len=MAX_LEN,
                          prefill_buckets=BUCKETS, **kw)


def _tengine(models, **kw):
    _, _, tcfg, tparams = models
    return tllm.LLMEngine(tcfg, tparams, max_len=MAX_LEN,
                          prefill_buckets=BUCKETS, device="cpu", **kw)


# prompt lengths: under a bucket (the 1-token replay), exactly a bucket
# (no replay), past the largest bucket (the max_len bucket)
LENGTHS = (10, 32, 45, 70)
NEW = 40                       # the first token, one chunk of 32, 7 more


@pytest.fixture(scope="module")
def jax_greedy(models):
    eng = _jengine(models)
    prompts = [_tokens(n, n) for n in LENGTHS]
    return prompts, [eng.generate(p, max_new_tokens=NEW)[0]
                     for p in prompts]


def test_llm_engine_greedy_matches_reference(models, jax_greedy):
    _, _, tcfg, tparams = models
    prompts, jout = jax_greedy
    eng = _tengine(models)
    eng.warmup()
    outs = []
    for prompt in prompts:
        tokens, stats = eng.generate(prompt, max_new_tokens=NEW,
                                     request_key="user-1")
        assert stats["prompt_len"] == len(prompt)
        assert stats["generated"] == len(tokens) and stats["ttft_s"] > 0
        outs.append(tokens)
    assert [len(o) for o in jout] == [NEW, NEW, NEW, 33]   # 70: capacity
    _assert_margins(tcfg, tparams, prompts, jout)
    assert outs == jout


def test_llm_engine_decode_chunk_reads_the_host_once(models, monkeypatch):
    """Greedy decode reads the device once per chunk of 32 steps: the
    position never comes back from the cache inside the chunk."""
    eng = _tengine(models)
    reads = []
    forward = tllm._forward_with_cache

    def counting(*args, **kwargs):
        reads.append(kwargs.get("start") is None)
        return forward(*args, **kwargs)

    monkeypatch.setattr(tllm, "_forward_with_cache", counting)
    tokens, _ = eng.generate(_tokens(3, 10), max_new_tokens=NEW)
    assert len(tokens) == NEW
    # the prefill reads its start; the replay and 64 decode steps do not
    assert reads == [True] + [False] * (1 + 2 * eng.decode_chunk)


def test_llm_engine_eos_and_capacity_guard(models, jax_greedy):
    """EOS truncates inside a chunk, as the reference; a prompt that
    leaves room for one chunk only stops after it (prompt 90 + 38: the
    second chunk would run past max_len)."""
    prompts, jout = jax_greedy
    jeng, teng = _jengine(models), _tengine(models)
    eos = jout[0][5]
    stopped = teng.generate(prompts[0], max_new_tokens=NEW, eos_id=eos)[0]
    assert stopped == jeng.generate(prompts[0], max_new_tokens=NEW,
                                    eos_id=eos)[0]
    assert stopped[-1] == eos and len(stopped) <= 6
    long_prompt = _tokens(90, 90)
    capped = teng.generate(long_prompt, max_new_tokens=38)[0]
    assert capped == jeng.generate(long_prompt, max_new_tokens=38)[0]
    assert len(capped) == 33
    with pytest.raises(PromptTooLongError):
        teng.generate(long_prompt, max_new_tokens=39)


def test_llm_engine_generate_batch_matches_single(models):
    """Equal lengths share one batch and give each prompt's single-stream
    tokens (and the reference's batch); mixed lengths fall back to the
    per-prompt loop; an empty batch; more prompts than the engine's
    batch raise."""
    prompts = [_tokens(seed, 20) for seed in (20, 120, 520)]
    jeng = _jengine(models, batch=3)
    teng = _tengine(models, batch=3)
    out, stats = teng.generate_batch(prompts, max_new_tokens=36)
    assert stats["batch"] == 3 and stats["ttft_s"] > 0
    assert out == jeng.generate_batch(prompts, max_new_tokens=36)[0]
    single = _tengine(models)
    assert out == [single.generate(p, max_new_tokens=36)[0]
                   for p in prompts]
    eos = out[1][3]
    assert teng.generate_batch(prompts, max_new_tokens=36, eos_id=eos)[0] \
        == jeng.generate_batch(prompts, max_new_tokens=36, eos_id=eos)[0]
    mixed = [prompts[0], _tokens(77, 13)]
    got, stats = teng.generate_batch(mixed, max_new_tokens=8)
    assert got == [single.generate(p, max_new_tokens=8)[0] for p in mixed]
    assert stats["batch"] == 2
    assert teng.generate_batch([])[0] == []
    with pytest.raises(ValueError, match="batch size"):
        single.generate_batch(prompts)


def test_llm_engine_int8_cache_matches_reference(models, quantize_calls):
    """An int8 cache: the reference's tokens, the prefilled cache's bits
    (as stated above), and every quantization the reference's."""
    _, _, tcfg, tparams = models
    prompt = _tokens(45, 45)
    jeng, teng = _jengine(models, kv_dtype="int8"), \
        _tengine(models, kv_dtype="int8")
    jout = jeng.generate(prompt, max_new_tokens=NEW)[0]
    _assert_margins(tcfg, tparams, [prompt], [jout])
    assert teng.generate(prompt, max_new_tokens=NEW)[0] == jout
    _assert_reference_bits(quantize_calls, 2 * NEW)
    bucket = teng._bucket_for(len(prompt))
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :len(prompt)] = prompt
    _, tcache = teng._prefill_prompt(padded, padded[:, 44:45], 45, bucket)
    jcache = jllm.init_kv_cache(jeng.config, 1, MAX_LEN, kv_dtype="int8")
    _, jcache = jeng._prefill(jeng.params, jnp.asarray(padded), jcache)
    _assert_int8_state(jcache, tcache, (slice(None), slice(None),
                                        slice(0, 44)))
    assert tcache["k"].dtype == torch.int8


def test_llm_engine_sampling_follows_its_settings(models):
    """Sampled decode goes token by token from the engine's seeded
    generator: repeatable per seed, inside top-k, and top-k 1 is the
    greedy stream. (Its random streams differ from jax.random by
    design.)"""
    prompt = _tokens(70, 12)
    greedy = _tengine(models).generate(prompt, max_new_tokens=10)[0]
    runs = [_tengine(models, temperature=0.9, top_k=5, seed=s).generate(
        prompt, max_new_tokens=10)[0] for s in (3, 3, 4)]
    assert runs[0] == runs[1] and len(runs[0]) == 10
    assert all(0 <= t < 512 for t in runs[2])
    assert _tengine(models, temperature=0.9, top_k=1).generate(
        prompt, max_new_tokens=10)[0] == greedy


def test_llm_engine_adapters_are_not_ported(models):
    """The LLMEngine's adapter registry lifecycle (adapters are ported
    now; the name is kept from the slice that refused them). Without a
    registry a named adapter is a typed 404, as on the reference's engine
    without one (never the base model's tokens), publishing a source
    raises and retiring is a no-op. With one, an unknown name is still a
    404; a source published at runtime serves, a name is never
    overwritten, and retiring an idle adapter frees its bank slot."""
    from mlrun_tpu_torch.models.lora import init_lora_nonzero

    eng = _tengine(models)
    with pytest.raises(UnknownAdapterError) as err:
        eng.generate([1, 2, 3], max_new_tokens=2, adapter="t1")
    assert err.value.status_code == 404
    with pytest.raises(ValueError, match="no adapter registry"):
        eng.add_adapter_source("t1", {})
    eng.retire_adapter("t1")

    _, _, tcfg, _ = models
    t1, t2 = (init_lora_nonzero(tcfg, torch.Generator().manual_seed(seed),
                                rank=2) for seed in (1, 2))
    eng = _tengine(models, adapters={"t1": t1}, max_live_adapters=2)
    with pytest.raises(UnknownAdapterError) as err:
        eng.generate([1, 2, 3], max_new_tokens=2, adapter="t2")
    assert err.value.status_code == 404
    eng.add_adapter_source("t2", t2)
    eng.add_adapter_source("t2", t2)            # the same source: kept
    with pytest.raises(ValueError, match="immutable"):
        eng.add_adapter_source("t2", t1)
    tokens, _ = eng.generate([1, 2, 3], max_new_tokens=2, adapter="t2")
    assert len(tokens) == 2
    registry = eng._adapters
    assert registry.resident_names() == ["t2"] and registry.live() == 1
    eng.retire_adapter("t2")
    assert registry.resident_names() == [] and registry.live() == 0
    assert registry.stats["adapter_evictions"] == 1
    with pytest.raises(UnknownAdapterError):
        eng.generate([1, 2, 3], max_new_tokens=2, adapter="t2")


# -- the dense ContinuousBatchingEngine ----------------------------------------

CB_KW = dict(max_len=MAX_LEN, slots=2, prefill_buckets=(16, 32, 64))
CB_NEW = 8


def _cb_requests():
    return [_tokens(112, 40), _tokens(212, 20), _tokens(312, 35),
            _tokens(412, 9)]


def _drive_cb(engine):
    """One request alone, then three together (two slots: the third
    waits for a free slot), then the first again."""
    a, b, c, d = _cb_requests()
    try:
        out = [engine.generate(a, CB_NEW)[0]]
        futures = [engine.submit(p, CB_NEW) for p in (b, c, d)]
        out += [f.result(timeout=300)[0] for f in futures]
        out.append(engine.generate(a, CB_NEW)[0])
        return [list(map(int, t)) for t in out], engine.stats
    finally:
        engine.stop()


def _cb_prompts():
    a, b, c, d = _cb_requests()
    return [a, b, c, d, a]


@pytest.fixture(scope="module")
def jax_cb(models):
    """The reference dense engine's streams: native whole-prompt and
    chunked, and int8."""
    jcfg, jparams, _, _ = models
    return {key: _drive_cb(jbatch.ContinuousBatchingEngine(
        jcfg, jparams, **CB_KW, **kw))[0]
        for key, kw in (("native", {}), ("chunked", {"prefill_chunk": 8}),
                        ("int8", {"kv_dtype": "int8"}))}


def _tcb(models, route="dense", **kw):
    _, _, tcfg, tparams = models
    eng = tbatch.ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                          **CB_KW, **kw)
    eng.prefill_impl = route
    return eng


@pytest.mark.parametrize("chunk", [0, 8])
def test_dense_engine_matches_reference(models, jax_cb, chunk):
    _, _, tcfg, tparams = models
    jout = jax_cb["chunked" if chunk else "native"]
    _assert_margins(tcfg, tparams, _cb_prompts(), jout)
    assert [len(t) for t in jout] == [CB_NEW] * 5
    eng = _tcb(models, prefill_chunk=chunk)
    eng.warmup()
    out, stats = _drive_cb(eng)
    assert out == jout
    assert stats["completed"] == 5 and stats["requests"] == 5
    if chunk:
        # 40 / 20 / 35 / 9 / 40 tokens in chunks of 8
        assert stats["prefill_chunks"] == 5 + 3 + 5 + 2 + 5
        assert stats["prefill_tokens_tick_max"] == 8


def test_dense_engine_chunk_resume_on_the_flash_route(models, jax_cb):
    """Chunks resume at q_offset > 0 through ``flash_fwd_cached`` (its
    plain version here): the reference's chunked streams."""
    out, stats = _drive_cb(_tcb(models, route="flash", prefill_chunk=8))
    assert out == jax_cb["chunked"]
    assert stats["prefill_impl"] == "flash"


def test_dense_engine_int8_matches_reference(models, jax_cb, quantize_calls):
    _, _, tcfg, tparams = models
    jout = jax_cb["int8"]
    _assert_margins(tcfg, tparams, _cb_prompts(), jout)
    eng = _tcb(models, kv_dtype="int8")
    assert eng._cache["k"].dtype == torch.int8
    out, _ = _drive_cb(eng)
    assert out == jout
    _assert_reference_bits(quantize_calls, 5 * CB_NEW)


def test_dense_engine_sampled_rows_and_typed_errors(models):
    from mlrun_tpu_torch.serving.resilience import EngineStoppedError

    eng = _tcb(models)
    try:
        a, _, c, _ = _cb_requests()
        greedy = eng.generate(a, CB_NEW)[0]
        futures = [eng.submit(a, CB_NEW),
                   eng.submit(c, CB_NEW, temperature=0.8, top_k=20)]
        both = [f.result(timeout=120)[0] for f in futures]
        with pytest.raises(PromptTooLongError):
            eng.submit(list(range(1, 120)), 20).result(timeout=5)
    finally:
        eng.stop()
    assert both[0] == greedy
    assert len(both[1]) == CB_NEW and all(0 <= t < 512 for t in both[1])
    with pytest.raises(EngineStoppedError):
        eng.submit([1, 2, 3], 2).result(timeout=5)


# -- the dense verify step and speculative decoding ----------------------------

@pytest.mark.parametrize("kv", ["native", "int8"])
def test_verify_rowwise_matches_reference(models, kv):
    """Three rows: mid-cache, one whose last two lanes run past the end
    (dropped: the real last entry keeps its value), one at position 0;
    the same verified tokens and cache as the reference's."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(5)
    shape = (jcfg.n_layers, 3, 32, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {"k": rng.standard_normal(shape, np.float32) * 0.5,
             "v": rng.standard_normal(shape, np.float32) * 0.5,
             "pos": np.array([7, 29, 0], np.int32)}
    if kv == "int8":
        for name in ("k", "v"):
            q, s = jllm._quantize_kv(jnp.asarray(cache[name]))
            cache[name], cache[f"{name}_scale"] = np.asarray(q), np.asarray(s)
    chunk = rng.integers(1, 512, size=(3, 5)).astype(np.int32)
    jver, jcache = jbatch._verify_rowwise(
        jcfg, jparams, jnp.asarray(chunk),
        {name: jnp.asarray(a) for name, a in cache.items()})
    tcache = {name: torch.from_numpy(a.copy()) for name, a in cache.items()}
    tver, tcache = tbatch._verify_rowwise(
        tcfg, tparams, torch.from_numpy(chunk).long(), tcache)
    np.testing.assert_array_equal(np.asarray(jver), tver.numpy())
    np.testing.assert_array_equal(np.asarray(jcache["pos"]),
                                  tcache["pos"].numpy())
    if kv == "int8":
        _assert_int8_state(jcache, tcache)
    else:
        for name in ("k", "v"):
            diff = np.abs(np.asarray(jcache[name]) - tcache[name].numpy())
            assert diff.max() <= 1e-5
    # row 1's lanes at 32 and 33 dropped: entry 31 holds lane 2's write
    assert not np.array_equal(tcache["k"][:, 1, 31].numpy(),
                              cache["k"][:, 1, 31])


def test_decode_rowwise_int8_matches_reference(models):
    """The int8 leg of the dense decode step, one row past the cache's
    end (its write dropped)."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(6)
    shape = (jcfg.n_layers, 3, 32, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {"pos": np.array([5, 31, 32], np.int32)}
    for name in ("k", "v"):
        q, s = jllm._quantize_kv(jnp.asarray(
            rng.standard_normal(shape, np.float32) * 0.5))
        cache[name], cache[f"{name}_scale"] = np.asarray(q), np.asarray(s)
    tokens = np.array([[7], [300], [11]], np.int32)
    jtok, jcache = jbatch._decode_rowwise(
        jcfg, jparams, jnp.asarray(tokens),
        {name: jnp.asarray(a) for name, a in cache.items()})
    tcache = {name: torch.from_numpy(a.copy()) for name, a in cache.items()}
    ttok, tcache = tbatch._decode_rowwise(
        tcfg, tparams, torch.from_numpy(tokens).long(), tcache)
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
    _assert_int8_state(jcache, tcache)
    assert torch.equal(tcache["k"][:, 2],
                       torch.from_numpy(cache["k"][:, 2].copy()))


@pytest.fixture(scope="module")
def perm():
    """The reference's permutation pair at overlap 0.7 on a vocab-64 tiny
    model (float32), and its conversion."""
    jcfg = dataclasses.replace(
        jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference"),
        vocab_size=64, tie_embeddings=False)
    tcfg = tllama.tiny_llama(dtype=torch.float32, vocab_size=64,
                             tie_embeddings=False)
    target_perm, draft_perm = jllama.permutation_pair(64, overlap=0.7)
    jtarget = jllama.init_permutation_params(jcfg, target_perm)
    jdraft = jllama.init_permutation_params(jcfg, draft_perm)
    return jcfg, tcfg, jtarget, jdraft, _convert(jtarget), _convert(jdraft)


SPEC_KW = dict(max_len=64, slots=2, prefill_buckets=(16,))
COUNTS = ("spec_rounds", "spec_proposed", "spec_accepted", "spec_tokens")
SPEC_PROMPTS = ([1, 7, 3, 9, 2, 4, 6, 8, 5, 3, 1, 2], [5, 9, 11], [2, 30])


def _spec(cfg, draft_params):
    return {"enabled": True, "k": 4, "draft_config": cfg,
            "draft_params": draft_params}


def _spec_run(engine):
    """Two requests together, then one alone (a slot reused)."""
    a, b, c = SPEC_PROMPTS
    try:
        futures = [engine.submit(p, max_new_tokens=12) for p in (a, b)]
        out = [f.result(timeout=300)[0] for f in futures]
        out.append(engine.generate(c, max_new_tokens=12)[0])
        return [list(map(int, t)) for t in out], engine.stats
    finally:
        engine.stop()


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_dense_spec_engine_matches_reference(perm, kv):
    """Spec on == spec off on the dense engine, and the streams and the
    round / acceptance counts equal the reference dense spec engine's
    (a row's lanes reach max_len - 1 on the last prompt's rounds)."""
    jcfg, tcfg, jtarget, jdraft, ttarget, tdraft = perm
    jout, jstats = _spec_run(jbatch.ContinuousBatchingEngine(
        jcfg, jtarget, kv_dtype=kv, speculative=_spec(jcfg, jdraft),
        **SPEC_KW))
    off, off_stats = _spec_run(tbatch.ContinuousBatchingEngine(
        tcfg, ttarget, kv_dtype=kv, device="cpu", **SPEC_KW))
    eng = tbatch.ContinuousBatchingEngine(
        tcfg, ttarget, kv_dtype=kv, speculative=_spec(tcfg, tdraft),
        device="cpu", **SPEC_KW)
    eng.warmup()
    out, stats = _spec_run(eng)
    assert off == jout and "spec_rounds" not in off_stats
    assert out == off
    assert {c: stats[c] for c in COUNTS} == {c: jstats[c] for c in COUNTS}
    assert 0.0 < stats["acceptance_rate"] < 1.0
    assert stats["spec_tokens_per_round"] > 1.0


def test_dense_spec_rows_near_max_len(perm):
    """Rows whose verify lanes run past max_len: a 40-token prompt with 24
    new tokens fills a 64-token cache, so the last rounds' trailing lanes
    drop; the stream is still the spec-off stream."""
    jcfg, tcfg, jtarget, jdraft, ttarget, tdraft = perm
    prompt = [(3 * i) % 63 + 1 for i in range(40)]

    def run(eng):
        try:
            return eng.generate(prompt, max_new_tokens=24)[0], eng.stats
        finally:
            eng.stop()

    jout, jstats = run(jbatch.ContinuousBatchingEngine(
        jcfg, jtarget, speculative=_spec(jcfg, jdraft), **SPEC_KW))
    off, _ = run(tbatch.ContinuousBatchingEngine(tcfg, ttarget,
                                                 device="cpu", **SPEC_KW))
    out, stats = run(tbatch.ContinuousBatchingEngine(
        tcfg, ttarget, speculative=_spec(tcfg, tdraft), device="cpu",
        **SPEC_KW))
    assert out == off == jout and len(out) == 24
    assert {c: stats[c] for c in COUNTS} == {c: jstats[c] for c in COUNTS}


# -- LLMModelServer's non-paged branches ---------------------------------------

class _Event:
    def __init__(self, body, path="/v2/models/m/infer"):
        self.body = body
        self.path = path


def _servers(models, monkeypatch, **kwargs):
    """The reference's server and the port's, both on the tiny preset in
    float32 with the same weights: the port's draws are replaced by the
    converted reference params."""
    from mlrun_tpu.frameworks.jax import auto_trainer as jauto
    from mlrun_tpu.serving.llm import LLMModelServer as JServer

    jcfg, _, tcfg, tparams = models
    monkeypatch.setitem(jauto.MODEL_PRESETS, "tiny", lambda: jcfg)
    monkeypatch.setitem(tllama.MODEL_PRESETS, "tiny", lambda: tcfg)
    monkeypatch.setattr(tllama, "init_params",
                        lambda config, generator, device: tparams)
    common = dict(name="m", model_preset="tiny", max_len=MAX_LEN,
                  max_new_tokens=6, warmup=False, **kwargs)
    return JServer(**common), tllm.LLMModelServer(device="cpu", **common)


@pytest.mark.parametrize("continuous_batching", [False, True])
def test_llm_model_server_non_paged_matches_reference(models, monkeypatch,
                                                      continuous_batching):
    jserver, tserver = _servers(models, monkeypatch,
                                continuous_batching=continuous_batching)
    prompts = [_tokens(7, 12), _tokens(8, 40), _tokens(9, 5)]
    try:
        want = jserver.do_event(_Event({"inputs": prompts})).body["outputs"]
        body = tserver.do_event(_Event({"inputs": prompts})).body
        engine = tserver.engine
    finally:
        for server in (jserver, tserver):
            if server.engine is not None and continuous_batching:
                server.engine.stop()
        tserver.close()
    _, _, tcfg, tparams = models
    _assert_margins(tcfg, tparams, prompts, want)
    assert body["outputs"] == want
    assert [len(o) for o in want] == [6, 6, 6]
    kind = tbatch.ContinuousBatchingEngine if continuous_batching \
        else tllm.LLMEngine
    assert type(engine) is kind
    assert "ttft_s" in tserver.metrics and "decode_tps" in tserver.metrics


def _stop(*servers):
    for server in servers:
        if server.engine is not None and server.continuous_batching:
            server.engine.stop()


@pytest.mark.parametrize("continuous_batching", [False, True])
def test_llm_model_server_unknown_adapter_is_404_like_reference(
        models, monkeypatch, continuous_batching):
    """A v2 body naming an adapter fails with a typed 404 on a server
    without adapters, the reference's and the port's alike, and the port
    serves no token for it."""
    from mlrun_tpu.serving.adapters import \
        UnknownAdapterError as JUnknownAdapterError

    jserver, tserver = _servers(models, monkeypatch,
                                continuous_batching=continuous_batching)
    body = {"inputs": [[1, 2, 3, 4]], "adapter": "t1"}
    try:
        for server in (jserver, tserver):
            server.post_init()
        if not continuous_batching:
            def served(*a, **kw):
                raise AssertionError("a token was served")
            monkeypatch.setattr(tserver.engine, "_generate_inner", served)
        with pytest.raises(JUnknownAdapterError) as jerr:
            jserver.do_event(_Event(dict(body)))
        with pytest.raises(UnknownAdapterError) as terr:
            tserver.do_event(_Event(dict(body, request_key="user-7")))
        assert jerr.value.status_code == terr.value.status_code == 404
        if continuous_batching:
            stats = tserver.engine.stats
            assert stats["requests"] == 0 and stats["tokens_out"] == 0
        assert "requests" not in tserver.metrics
    finally:
        _stop(jserver, tserver)


def test_dense_engine_submit_unknown_adapter_fails_before_queueing(models):
    _, _, tcfg, tparams = models
    eng = tbatch.ContinuousBatchingEngine(tcfg, tparams, max_len=MAX_LEN,
                                          slots=2, max_queue_size=1,
                                          device="cpu")
    try:
        future = eng.submit([1, 2, 3, 4], max_new_tokens=4, adapter="t1",
                            request_key="user-7")
        with pytest.raises(UnknownAdapterError):
            future.result(timeout=5)
        assert eng.stats["requests"] == 0 and eng._queue.qsize() == 0
        with pytest.raises(UnknownAdapterError):
            eng.generate([1, 2, 3, 4], max_new_tokens=4, adapter="t1")
    finally:
        eng.stop()


def test_dense_server_timing_is_not_ported(models, monkeypatch):
    """{"timing": true} on the dense batching server: since the request
    ledger landed (ROADMAP.md item 2) the port answers it as the reference
    does — one closed phase breakdown per input beside the same outputs
    (the name is kept from when the field raised NotImplementedError)."""
    jserver, tserver = _servers(models, monkeypatch,
                                continuous_batching=True)
    body = {"inputs": [_tokens(11, 9), _tokens(12, 5)], "timing": True}
    try:
        want = jserver.do_event(_Event(dict(body))).body
        got = tserver.do_event(_Event(dict(body))).body
    finally:
        _stop(jserver, tserver)
    assert got["outputs"] == want["outputs"]
    assert len(got["timing"]) == len(want["timing"]) == 2
    for jt, tt in zip(want["timing"], got["timing"]):
        assert tt["attribution_closed"] and jt["attribution_closed"]
        assert tt["wall_s"] == pytest.approx(sum(tt["phases"].values()),
                                             abs=1e-9)
        assert {"prefill", "decode_active"} <= set(tt["phases"])
        assert set(tt["phases"]) <= set(jt["phases"]) | {"decode_stall",
                                                          "queue_wait"}
        assert tt["prefill_chunks"] == jt["prefill_chunks"]


def test_llm_engine_server_ignores_timing_like_reference(models,
                                                        monkeypatch):
    """The reference's LLMEngine server reads "timing" only on its
    batching branch: the field changes nothing, and no timing comes
    back."""
    jserver, tserver = _servers(models, monkeypatch)
    body = {"inputs": [_tokens(11, 9)], "timing": True}
    want = jserver.do_event(_Event(dict(body))).body
    got = tserver.do_event(_Event(dict(body))).body
    assert "timing" not in want and "timing" not in got
    assert got["outputs"] == want["outputs"] and len(want["outputs"][0]) == 6


def test_llm_model_server_paged_needs_continuous_batching():
    server = tllm.LLMModelServer(model_preset="tiny", paged=True,
                                 max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="continuous_batching=True"):
        server.load()
    server.post_init()
    assert not server.ready and "ValueError" in server.error
