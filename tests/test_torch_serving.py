"""mlrun_tpu_torch serving against mlrun_tpu's on the CPU, on the same
converted tiny float32 weights: the prefill forward (cold and in the paged
prefix-hit form), the paged decode step (kernel and reference branches),
and the paged continuous-batching engine end to end (greedy tokens cold
and on prefix-cache hits). The JAX side runs its Pallas kernels in
interpret mode, as its own CPU tests do; the port's kernel wrappers, given
CPU tensors, run their plain versions.

Tolerances (float32): logits 1e-4 absolute (two layers, O(1) logits);
KV cache contents 1e-5 absolute. Greedy tokens must be identical; the
prompts are checked to have a top-2 logit margin above 1e-3 at every
generated position, so no comparison rides on a float near-tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.serving import llm as jllm
from mlrun_tpu.serving import paged as jpaged
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.ops.paged_attention import KernelUnavailableError
from mlrun_tpu_torch.serving import llm as tllm
from mlrun_tpu_torch.serving import paged as tpaged
from mlrun_tpu_torch.serving.adapters import UnknownAdapterError
from mlrun_tpu_torch.serving.resilience import PromptTooLongError

LOGIT_TOL = 1e-4
KV_TOL = 1e-5
PAGE, MAX_LEN = 16, 64


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=n).astype(
        np.int32)


def _close(j, t, tol):
    diff = np.abs(np.asarray(j, np.float32) - t.float().numpy()).max()
    assert diff <= tol, f"max abs diff {diff} > {tol}"


# -- prefill forward ----------------------------------------------------------

@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_forward_with_cache_cold_matches_reference(models, impl):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(1, 20)[None]
    jlog, jcache = jllm._forward_with_cache(
        jcfg, jparams, jnp.asarray(toks), jllm.init_kv_cache(jcfg, 1, MAX_LEN),
        attn_impl=impl)
    tcache = tllm.init_kv_cache(tcfg, 1, MAX_LEN, device="cpu")
    tlog, tcache = tllm._forward_with_cache(
        tcfg, tparams, torch.from_numpy(toks).long(), tcache, attn_impl=impl)
    assert tlog.shape == (1, jcfg.vocab_size)
    _close(jlog, tlog, LOGIT_TOL)
    _close(jcache["k"], tcache["k"], KV_TOL)
    _close(jcache["v"], tcache["v"], KV_TOL)
    assert int(tcache["pos"][0]) == int(jcache["pos"][0]) == 20


def _prefix_pool(fwd, init_cache, init_pool, insert, cfg, params, prefix,
                 ids, to_tokens):
    """Prefill ``prefix`` cold and scatter its KV into a fresh pool."""
    _, small = fwd(cfg, params, to_tokens(prefix[None]),
                   init_cache(cfg, 1, MAX_LEN))
    pool = init_pool(cfg, 8 + 1, PAGE)
    return insert(pool, small, ids, PAGE)


@pytest.mark.parametrize("suffix_len", [8, 1])
@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_forward_with_cache_prefix_hit_matches_reference(models, suffix_len,
                                                         impl):
    """The paged prefix-hit form: the 32-token prefix is attended in place
    in pool pages [3, 1] and LSE-merged with the suffix attention. Both
    packages agree with each other and with a cold prefill of the whole
    prompt."""
    jcfg, jparams, tcfg, tparams = models
    prompt = _tokens(2, 32 + suffix_len)
    base = 32
    ids = np.full((MAX_LEN // PAGE,), -1, np.int32)
    ids[:2] = [3, 1]
    jpool = _prefix_pool(jllm._forward_with_cache, jllm.init_kv_cache,
                         jpaged.init_paged_pool, jpaged.insert_prompt_pages,
                         jcfg, jparams, prompt[:base], jnp.asarray(ids),
                         jnp.asarray)
    tpool = _prefix_pool(
        tllm._forward_with_cache,
        lambda c, b, m: tllm.init_kv_cache(c, b, m, device="cpu"),
        lambda c, n, p: tpaged.init_paged_pool(c, n, p, device="cpu"),
        tpaged.insert_prompt_pages, tcfg, tparams, prompt[:base], ids,
        lambda a: torch.from_numpy(a).long())
    _close(jpool["k"], tpool["k"], KV_TOL)

    suffix = prompt[base:][None]
    jsmall = jllm.init_kv_cache(jcfg, 1, MAX_LEN)
    jsmall["pos"] = jnp.full((1,), base, jnp.int32)
    jlog, _ = jllm._forward_with_cache(
        jcfg, jparams, jnp.asarray(suffix), jsmall,
        prefix_kv={"k": jpool["k"], "v": jpool["v"],
                   "page_ids": jnp.asarray(ids), "base": jnp.int32(base)},
        attn_impl=impl, page_size=PAGE)
    tsmall = tllm.init_kv_cache(tcfg, 1, MAX_LEN, device="cpu")
    tsmall["pos"].fill_(base)
    tlog, tsmall = tllm._forward_with_cache(
        tcfg, tparams, torch.from_numpy(suffix).long(), tsmall,
        prefix_kv={"k": tpool["k"], "v": tpool["v"],
                   "page_ids": torch.from_numpy(ids), "base": base},
        attn_impl=impl, page_size=PAGE)
    _close(jlog, tlog, LOGIT_TOL)
    assert int(tsmall["pos"][0]) == base + suffix_len
    cold, _ = tllm._forward_with_cache(
        tcfg, tparams, torch.from_numpy(prompt[None]).long(),
        tllm.init_kv_cache(tcfg, 1, MAX_LEN, device="cpu"))
    assert float((cold - tlog).abs().max()) <= LOGIT_TOL


# -- paged decode step --------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_decode_rowwise_paged_matches_reference(models, impl):
    """Three slots over a random pool (one unmapped, pos 0), -1 entries in
    the table: next tokens identical, the written pool within KV_TOL."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(3)
    shape = (jcfg.n_layers, 9, PAGE, jcfg.n_kv_heads, jcfg.head_dim)
    k_np = rng.standard_normal(shape, np.float32) * 0.5
    v_np = rng.standard_normal(shape, np.float32) * 0.5
    table = np.full((3, MAX_LEN // PAGE), -1, np.int32)
    table[0, :2] = [4, 2]
    table[1, :4] = [0, 1, 5, 7]
    pos = np.array([20, 63, 0], np.int32)
    tokens = np.array([[7], [300], [0]], np.int32)
    jtok, jpool, jpos = jpaged._decode_rowwise_paged(
        jcfg, PAGE, impl, jparams, jnp.asarray(tokens),
        {"k": jnp.asarray(k_np), "v": jnp.asarray(v_np)},
        jnp.asarray(table), jnp.asarray(pos))
    tpool = {"k": torch.from_numpy(k_np.copy()),
             "v": torch.from_numpy(v_np.copy())}
    ttok, tpool, tpos = tpaged._decode_rowwise_paged(
        tcfg, PAGE, impl, tparams, torch.from_numpy(tokens).long(), tpool,
        torch.from_numpy(table), torch.from_numpy(pos))
    np.testing.assert_array_equal(np.asarray(jtok)[:2], ttok.numpy()[:2])
    np.testing.assert_array_equal(np.asarray(jpos), tpos.numpy())
    live = [0, 1, 2, 4, 5, 7]          # the scratch page (8) is never read
    _close(np.asarray(jpool["k"])[:, live], tpool["k"][:, live], KV_TOL)
    _close(np.asarray(jpool["v"])[:, live], tpool["v"][:, live], KV_TOL)


# -- the paged engine end to end ----------------------------------------------

ENGINE_KW = dict(max_len=128, slots=2, page_size=PAGE,
                 prefill_buckets=(16, 32, 64))
NEW = 6


def _requests():
    a = _tokens(12, 40).tolist()
    b = a[:32] + _tokens(112, 10).tolist()     # shares two pages with a
    c = _tokens(212, 20).tolist()
    d = _tokens(312, 35).tolist()
    return a, b, c, d


def _drive(engine):
    """Sequential a, b (prefix hit), then c and d together, then a again
    (hit on its own registered pages)."""
    a, b, c, d = _requests()
    out = [engine.generate(a, NEW)[0], engine.generate(b, NEW)[0]]
    futures = [engine.submit(p, NEW) for p in (c, d)]
    out += [f.result(timeout=120)[0] for f in futures]
    out.append(engine.generate(a, NEW)[0])
    return [list(map(int, t)) for t in out]


def _min_margin(tcfg, tparams, prompt, generated) -> float:
    seq = torch.tensor([prompt + generated[:-1]], dtype=torch.long)
    logits = tllama.forward(tcfg, tparams, seq)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def test_paged_engine_greedy_matches_reference_engine(models):
    jcfg, jparams, tcfg, tparams = models
    jeng = jpaged.PagedContinuousBatchingEngine(jcfg, jparams, **ENGINE_KW)
    try:
        jout = _drive(jeng)
    finally:
        jeng.stop()
    teng = tpaged.PagedContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                                **ENGINE_KW)
    try:
        tout = _drive(teng)
        stats = teng.stats
    finally:
        teng.stop()
    a, b, c, d = _requests()
    for prompt, tokens in zip((a, b, c, d, a), jout):
        assert len(tokens) == NEW
        assert _min_margin(tcfg, tparams, prompt, tokens) > 1e-3
    assert tout == jout
    assert tout[0] == tout[4]           # cold a == a through its own pages
    assert stats["prefix_hit_rate"] > 0 and stats["prefix_hits"] == 2
    assert stats["decode_attn_impl"] == "reference"
    assert stats["prefill_gather_admissions"] == 2
    assert stats["completed"] == 5 and stats["free_pages"] >= 0


def test_chunked_prefill_gives_the_same_tokens(models):
    _, _, tcfg, tparams = models
    prompt = _requests()[3]
    outs = []
    for chunk in (0, 16):
        eng = tpaged.PagedContinuousBatchingEngine(
            tcfg, tparams, device="cpu", prefill_chunk=chunk, **ENGINE_KW)
        try:
            outs.append(eng.generate(prompt, NEW)[0])
            chunks = eng.stats["prefill_chunks"]
        finally:
            eng.stop()
    assert outs[0] == outs[1]
    assert chunks == 3                  # 35 tokens in chunks of 16


def test_sampling_rows_follow_their_settings():
    """Greedy rows (temperature 0) and top-k 1 rows take the argmax;
    sampled rows stay inside their top-k; the generator makes draws
    repeatable. (Random streams differ from jax.random by design, so
    the sampler is checked by its contract, not token for token.)"""
    from mlrun_tpu_torch.serving.sampling import sample_logits

    logits = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4, 512), np.float32) * 3)
    gen = torch.Generator().manual_seed(0)
    temp, top_k, top_p = [0.0, 1.0, 1.5, 0.7], [0, 1, 5, 0], [1.0, 1.0,
                                                              1.0, 0.5]
    draws = [sample_logits(logits, gen, temp, top_k, top_p)
             for _ in range(20)]
    argmax = logits.argmax(dim=-1)
    top5 = torch.topk(logits[2], 5).indices.tolist()
    for tok in draws:
        assert tok.dtype == torch.int32
        assert int(tok[0]) == int(argmax[0]) and int(tok[1]) == int(argmax[1])
        assert int(tok[2]) in top5
    again = torch.Generator().manual_seed(0)
    assert torch.equal(draws[0], sample_logits(logits, again, temp, top_k,
                                               top_p))


def test_engine_serves_sampled_and_greedy_rows_together(models):
    _, _, tcfg, tparams = models
    eng = tpaged.PagedContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                               **ENGINE_KW)
    try:
        a, _, c, _ = _requests()
        greedy = eng.generate(a, NEW)[0]
        futures = [eng.submit(a, NEW), eng.submit(c, NEW, temperature=0.8,
                                                  top_k=20)]
        both = [f.result(timeout=120)[0] for f in futures]
    finally:
        eng.stop()
    assert both[0] == greedy
    assert len(both[1]) == NEW and all(0 <= t < 512 for t in both[1])


def test_engine_rejects_and_stops_typed(models):
    from mlrun_tpu_torch.serving.resilience import EngineStoppedError

    _, _, tcfg, tparams = models
    eng = tpaged.PagedContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                               **ENGINE_KW)
    with pytest.raises(PromptTooLongError):
        eng.submit(list(range(1, 120)), max_new_tokens=20).result(timeout=5)
    eng.stop()
    with pytest.raises(EngineStoppedError):
        eng.submit([1, 2, 3], 2).result(timeout=5)


# -- the serving step ---------------------------------------------------------

class _Event:
    def __init__(self, body, path="/v2/models/m/infer"):
        self.body = body
        self.path = path


def test_llm_model_server_do_event_on_cpu():
    server = tllm.LLMModelServer(
        name="m", model_preset="tiny", continuous_batching=True, paged=True,
        slots=2, max_len=128, page_size=PAGE, max_new_tokens=4,
        device="cpu")
    try:
        shared = _tokens(20, 32).tolist()
        prompts = [shared + [5, 6, 7], shared + [9, 10], [3, 4, 5]]
        body = server.do_event(_Event({"inputs": prompts})).body
        assert body["model_name"] == "m"
        assert [len(o) for o in body["outputs"]] == [4, 4, 4]
        assert all(0 <= t < 512 for o in body["outputs"] for t in o)
        assert server.metrics["requests"] == 1
        assert server.metrics["prefix_hit_rate"] > 0
        assert "ttft_s" in server.metrics and "decode_tps" in server.metrics
        ready = server.do_event(_Event({}, "/v2/models/m/ready")).body
        assert ready == {"name": "m", "ready": True}
    finally:
        server.close()


def _paged_servers(models, monkeypatch):
    """The reference's paged server and the port's on the tiny preset in
    float32 with the same weights (the port's draws are replaced by the
    converted reference params)."""
    from mlrun_tpu.frameworks.jax import auto_trainer as jauto
    from mlrun_tpu.serving.llm import LLMModelServer as JServer

    jcfg, _, tcfg, tparams = models
    monkeypatch.setitem(jauto.MODEL_PRESETS, "tiny", lambda: jcfg)
    monkeypatch.setitem(tllama.MODEL_PRESETS, "tiny", lambda: tcfg)
    monkeypatch.setattr(tllama, "init_params",
                        lambda config, generator, device: tparams)
    common = dict(name="m", model_preset="tiny", continuous_batching=True,
                  paged=True, slots=2, max_len=MAX_LEN, page_size=PAGE,
                  max_new_tokens=4, warmup=False)
    return JServer(**common), tllm.LLMModelServer(device="cpu", **common)


def test_paged_server_unknown_adapter_is_404_like_reference(models,
                                                           monkeypatch):
    """A v2 body naming an adapter fails with a typed 404 on the paged
    servers without adapters, the reference's and the port's alike; the
    port's engine never queues it, so no token is served."""
    from mlrun_tpu.serving.adapters import \
        UnknownAdapterError as JUnknownAdapterError

    jserver, tserver = _paged_servers(models, monkeypatch)
    body = {"inputs": [[1, 2, 3, 4]], "adapter": "t1"}
    try:
        with pytest.raises(JUnknownAdapterError) as jerr:
            jserver.do_event(_Event(dict(body)))
        with pytest.raises(UnknownAdapterError) as terr:
            tserver.do_event(_Event(dict(body)))
        assert jerr.value.status_code == terr.value.status_code == 404
        assert isinstance(tserver.engine, tpaged.PagedContinuousBatchingEngine)
        stats = tserver.engine.stats
        assert stats["requests"] == 0 and stats["tokens_out"] == 0
    finally:
        for server in (jserver, tserver):
            if server.engine is not None:
                server.engine.stop()


def test_paged_engine_submit_unknown_adapter_fails_before_queueing(models):
    _, _, tcfg, tparams = models
    eng = tpaged.PagedContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                               max_queue_size=1, **ENGINE_KW)
    try:
        future = eng.submit(_tokens(30, 8).tolist(), max_new_tokens=4,
                            adapter="t1", request_key="user-7")
        with pytest.raises(UnknownAdapterError) as err:
            future.result(timeout=5)
        assert err.value.status_code == 404
        assert eng.stats["requests"] == 0 and eng._queue.qsize() == 0
    finally:
        eng.stop()


def test_paged_server_timing_is_not_ported(models, monkeypatch):
    """{"timing": true} on the paged server: since the request ledger
    landed (ROADMAP.md item 2) it comes back as on the reference's server —
    a closed phase breakdown per input beside the same outputs, and no
    field without the flag (the name is kept from when it raised)."""
    jserver, tserver = _paged_servers(models, monkeypatch)
    prompt = _tokens(31, 20).tolist()
    try:
        jserver.do_event(_Event({"inputs": [prompt]}))
        plain = tserver.do_event(_Event({"inputs": [prompt]})).body
        want = jserver.do_event(_Event({"inputs": [prompt],
                                        "timing": True})).body
        got = tserver.do_event(_Event({"inputs": [prompt],
                                       "timing": True})).body
    finally:
        for server in (jserver, tserver):
            if server.engine is not None:
                server.engine.stop()
    assert "timing" not in plain
    assert got["outputs"] == want["outputs"] == plain["outputs"]
    (jt,), (tt,) = want["timing"], got["timing"]
    assert jt["attribution_closed"] and tt["attribution_closed"]
    assert tt["wall_s"] == pytest.approx(sum(tt["phases"].values()),
                                         abs=1e-9)
    # the second run of the prompt is a prefix hit on both servers
    assert tt.get("cached_prefix") == jt.get("cached_prefix") == PAGE


def test_default_device_needs_cuda(models, monkeypatch):
    """Entry points run on the GPU unless the caller asks for the CPU;
    without a CUDA device they raise instead of carrying on."""
    _, _, tcfg, tparams = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllm.LLMModelServer(continuous_batching=True, paged=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpaged.PagedContinuousBatchingEngine(tcfg, tparams, **ENGINE_KW)
    with pytest.raises(RuntimeError):
        tpaged.PagedContinuousBatchingEngine(tcfg, tparams, device="cuda",
                                             **ENGINE_KW)


@pytest.mark.parametrize("impl", ["kernel", "flash"])
def test_explicit_kernel_on_cpu_raises(models, impl):
    _, _, tcfg, tparams = models
    with pytest.raises(KernelUnavailableError):
        tpaged.PagedContinuousBatchingEngine(
            tcfg, tparams, device="cpu", attention_impl=impl, **ENGINE_KW)


# what the server builds for the fleet's knobs, as the reference's does
FLEET_KNOB_BUILDS = {"prefill_replicas": "LLMEngine",
                     "routing": "PagedContinuousBatchingEngine",
                     "replicas": "EngineFleet"}


@pytest.mark.parametrize("kwargs", [
    {"paged": False, "hf_model": "meta-llama/Llama-3.2-1B"},
    {"continuous_batching": False, "paged": False, "prefill_replicas": 1},
    {"tokenizer": "gpt2"},
    {"routing": "affinity"},
    {"replicas": 2},
])
def test_unported_server_features_raise(kwargs):
    """Features of the reference's server the port does not have yet raise
    their ROADMAP.md item (max_wait, degradation and request_ledger, once
    cases here, landed with item 2: tests/test_torch_resilience.py). The
    fleet's knobs landed with item 6's engine fleet: the server builds
    what the reference's builds (a fleet only for replicas >= 2 or
    prefill_replicas on a batching server; tests/test_torch_fleet.py holds
    the fleet against the reference's). ``hf_model`` and ``tokenizer``
    landed with item 10: the server keeps them for its load, as the
    reference's does (tests/test_torch_hf.py and
    tests/test_torch_tokenizer.py load local ones; nothing is fetched
    here)."""
    args = dict(continuous_batching=True, paged=True, device="cpu",
                max_len=64, page_size=8, warmup=False)
    args.update(kwargs)
    if "hf_model" in kwargs or "tokenizer" in kwargs:
        server = tllm.LLMModelServer(**args)
        assert server.hf_model == kwargs.get("hf_model")
        assert server.tokenizer_id == kwargs.get("tokenizer")
        assert server.engine is None and not server.ready
        return
    builds = next((FLEET_KNOB_BUILDS[key] for key in kwargs
                   if key in FLEET_KNOB_BUILDS), None)
    if builds is None:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tllm.LLMModelServer(**args)
        return
    server = tllm.LLMModelServer(**args)
    server.post_init()
    try:
        assert server.ready, server.error
        assert type(server.engine).__name__ == builds
    finally:
        server.close()


def test_int8_pool_is_not_ported_yet(models):
    """The int8 pool is ported now (tests/test_torch_int8.py holds it
    against the reference): the engine builds one; an unknown kv_dtype
    still raises, as the reference's does."""
    _, _, tcfg, tparams = models
    eng = tpaged.PagedContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                               kv_dtype="int8", **ENGINE_KW)
    try:
        assert eng._pool["k"].dtype == torch.int8
        assert eng._pool["k_scale"].shape == eng._pool["k"].shape[:-1]
    finally:
        eng.stop()
    with pytest.raises(ValueError, match="kv_dtype"):
        tpaged.PagedContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                             kv_dtype="fp8", **ENGINE_KW)
