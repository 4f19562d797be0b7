"""mlrun_tpu_torch's speculative decoding against mlrun_tpu's on the CPU:
the verify attention ops (the dense-view version and the kernel route's
plain form, native and int8 pools), the paged engine with speculation on
(cold and through a prefix hit, native and int8, on the gather route and
on the kernel route's plain versions), the batch-1
``SpeculativeDecoder``, the permutation models and ``LLMModelServer``.

Exactness rides the reference's permutation models
(``init_permutation_params`` / ``permutation_pair``): every transformer
weight is zero and the argmax gaps are O(50), far above float noise, so
the token streams, the round counts and the acceptance counts must be
identical to the reference's. The pairs are built by the JAX package and
converted (the two packages draw different random embeddings). A second
check uses random tiny weights, where the streams must agree at every
position whose top-2 logit margin is above 1e-3 (all of them, asserted).

Tolerances: the verify ops differ from the reference's only by float32
summation order, 2e-5 absolute.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.models import llama as jllama
from mlrun_tpu.serving import llm as jllm
from mlrun_tpu.serving import paged as jpaged
from mlrun_tpu.serving.speculative import SpeculativeDecoder as JDecoder
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.ops import paged_attention as tpa
from mlrun_tpu_torch.serving import llm as tllm
from mlrun_tpu_torch.serving import paged as tpaged
from mlrun_tpu_torch.serving.speculative import SpeculativeDecoder, accept_tokens

# mlrun_tpu.ops re-exports functions under the submodules' names
jpa = importlib.import_module("mlrun_tpu.ops.paged_attention")

TOL = 2e-5
PROMPT = [1, 7, 3, 9, 2, 4, 6, 8, 5, 3, 1, 2]  # one full page at page 8


def _close(j, t, tol=TOL):
    diff = np.abs(np.asarray(j, np.float32) - t.detach().float().numpy())
    assert diff.max() <= tol, f"max abs diff {diff.max()} > {tol}"


def _convert(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


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


def _spec(cfg, draft_params, **over):
    conf = {"enabled": True, "k": 4, "draft_config": cfg,
            "draft_params": draft_params}
    conf.update(over)
    return conf


ENGINE_KW = dict(max_len=64, slots=2, prefill_buckets=(16,), page_size=8)


def _jengine(cfg, params, spec=None, **kw):
    eng = jpaged.PagedContinuousBatchingEngine(
        cfg, params, speculative=spec, **{**ENGINE_KW, **kw})
    eng.start()
    return eng


def _tengine(cfg, params, spec=None, route="reference", **kw):
    """The port's engine on the CPU. ``route="kernel"`` drives the kernel
    route's plain versions (the paged decode / verify wrappers given CPU
    tensors): an explicit kernel request is refused on the CPU, so the
    resolved route is set after construction."""
    eng = tpaged.PagedContinuousBatchingEngine(
        cfg, params, speculative=spec, device="cpu", **{**ENGINE_KW, **kw})
    eng.attn_impl = route
    eng.start()
    return eng


def _run(eng, prompts, max_new):
    """Sequential requests (deterministic scheduling); returns (streams,
    stats, free pages)."""
    try:
        out = [eng.generate(p, max_new_tokens=max_new)[0] for p in prompts]
        return out, eng.stats, len(eng._free_pages)
    finally:
        eng.stop()


COUNTS = ("spec_rounds", "spec_proposed", "spec_accepted", "spec_tokens")


# -- verify attention ops -----------------------------------------------------

@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("base", [[13, 0, 27], [13, 0, 30]])
def test_verify_ops_match_reference(kv, base):
    """The reference's op-level verify case: a row with two mapped pages,
    an all-(-1) row at base 0, a row deep into its pages; base 30 puts
    three lanes past the 32-position view (dropped, never clamped)."""
    ps, slots, hkv, h, d, s, n_pages = 8, 3, 2, 4, 32, 5, 8
    rng = np.random.default_rng(0)
    k_pages = rng.standard_normal((n_pages + 1, ps, hkv, d), np.float32) * .3
    v_pages = rng.standard_normal((n_pages + 1, ps, hkv, d), np.float32) * .3
    q = rng.standard_normal((slots, s, h, d), np.float32)
    chunk_k = rng.standard_normal((slots, s, hkv, d), np.float32) * .3
    chunk_v = rng.standard_normal((slots, s, hkv, d), np.float32) * .3
    table = np.asarray([[0, 1, -1, -1], [-1, -1, -1, -1], [2, 3, 4, 5]],
                       np.int32)
    jargs = [jnp.asarray(a) for a in (q, chunk_k, chunk_v, k_pages,
                                      v_pages, table)]
    jargs.append(jnp.asarray(base, jnp.int32))
    jscales = {}
    if kv == "int8":
        jargs[3], ks = jllm._quantize_kv(jargs[3])
        jargs[4], vs = jllm._quantize_kv(jargs[4])
        jscales = {"k_scale": ks, "v_scale": vs}
    targs = [torch.from_numpy(np.asarray(a).copy()) for a in jargs]
    tscales = {name: torch.from_numpy(np.asarray(a).copy())
               for name, a in jscales.items()}
    ref_j = jpa.paged_verify_attention(*jargs, page_size=ps,
                                       impl="reference", **jscales)
    ker_j = jpa.paged_verify_attention(*jargs, page_size=ps, impl="kernel",
                                       interpret=True, **jscales)
    ref_t = tpa.paged_verify_attention(*targs, page_size=ps,
                                       impl="reference", **tscales)
    ker_t = tpa.paged_verify_merged(*targs, page_size=ps, **tscales)
    assert ref_t.shape == (slots, s, h, d) and ref_t.dtype == torch.float32
    _close(ref_j, ref_t)
    _close(ker_j, ker_t)
    # the prefix part alone: (o, lse) against the Pallas verify kernel
    o_j, lse_j = jpa._paged_verify_call(jargs[0], jargs[3], jargs[4],
                                        jargs[5], jargs[6], ps,
                                        interpret=True, **jscales)
    o_t, lse_t = tpa._paged_verify_call(targs[0], targs[3], targs[4],
                                        targs[5], targs[6], ps, **tscales)
    assert lse_t.shape == (slots, h, s)
    _close(o_j, o_t)
    _close(lse_j, lse_t)
    o_j, lse_j = jpa.chunk_causal_part(*jargs[:3])
    o_t, lse_t = tpa.chunk_causal_part(*targs[:3])
    _close(o_j, o_t)
    _close(lse_j, lse_t)


def test_paged_prefill_plain_empty_prefix_matches_pallas():
    """A chunk over an empty prefix (base 0, all ids -1): the Pallas kernel
    skips every page, so o = 0 and lse = NEG_INF + log(1e-30). The plain
    version used to weigh the masked keys evenly (o = the mean of the
    scratch-routed view, 0.80 off here); masked keys now weigh exactly 0,
    as in the kernels."""
    rng = np.random.default_rng(2)
    ps, hkv, d, h = 8, 2, 16, 4
    k = rng.standard_normal((5, ps, hkv, d), np.float32)
    v = rng.standard_normal((5, ps, hkv, d), np.float32)
    q = rng.standard_normal((3, h, d), np.float32)
    ids = np.full((4,), -1, np.int32)
    o_j, lse_j = jpa._paged_prefill_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ids), 0,
        ps, interpret=True)
    o_t, lse_t = tpa._paged_prefill_call(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(ids), 0, ps)
    assert not o_t.any()
    _close(o_j, o_t)
    _close(lse_j, lse_t)


def test_single_slot_verify_is_the_prefill():
    """The verify prefix part of one slot is the paged prefill of that
    slot's chunk over its ids and base (one kernel body on the card)."""
    rng = np.random.default_rng(1)
    ps, hkv, d = 8, 2, 16
    k = torch.from_numpy(rng.standard_normal((6, ps, hkv, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((6, ps, hkv, d), np.float32))
    q = torch.from_numpy(rng.standard_normal((1, 5, 4, d), np.float32))
    ids = torch.tensor([[3, 0, 4, -1]], dtype=torch.int32)
    o, lse = tpa._paged_verify_call(q, k, v, ids, torch.tensor(
        [19], dtype=torch.int32), ps)
    o1, lse1 = tpa._paged_prefill_call(q[0], k, v, ids[0], 19, ps)
    assert torch.equal(o[0], o1) and torch.equal(lse[0], lse1.T)


def test_decode_rowwise_dense_matches_reference():
    """The draft's dense decode step: per-row positions, one row past the
    cache's end (its write is dropped, as the reference's scatter drops
    it): the same next tokens, cache contents and positions as the
    reference's ``_decode_rowwise``; greedy rows of the sampled form take
    the same argmax."""
    from mlrun_tpu.serving import llm_batch as jbatch
    from mlrun_tpu_torch.serving import llm_batch as tbatch

    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = _convert(jparams)
    rng = np.random.default_rng(4)
    shape = (jcfg.n_layers, 3, 32, jcfg.n_kv_heads, jcfg.head_dim)
    k = rng.standard_normal(shape, np.float32) * 0.5
    v = rng.standard_normal(shape, np.float32) * 0.5
    pos = np.array([5, 31, 32], np.int32)
    tokens = np.array([[7], [300], [11]], np.int32)
    jtok, jcache = jbatch._decode_rowwise(
        jcfg, jparams, jnp.asarray(tokens),
        {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)})

    def cache():
        return {"k": torch.from_numpy(k.copy()),
                "v": torch.from_numpy(v.copy()),
                "pos": torch.from_numpy(pos.copy())}

    ttok, tcache = tbatch._decode_rowwise(tcfg, tparams,
                                          torch.from_numpy(tokens).long(),
                                          cache())
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
    np.testing.assert_array_equal(np.asarray(jcache["pos"]),
                                  tcache["pos"].numpy())
    for name in ("k", "v"):
        _close(jcache[name], tcache[name], 1e-5)
    assert torch.equal(tcache["k"][:, 2], torch.from_numpy(k[:, 2]))
    sampled, _ = tbatch._decode_rowwise(
        tcfg, tparams, torch.from_numpy(tokens).long(), cache(),
        torch.Generator().manual_seed(0), [0.0] * 3, [0] * 3, [1.0] * 3)
    assert torch.equal(sampled, ttok)


# -- the speculative paged engine ---------------------------------------------

@pytest.mark.parametrize("kv", ["native", "int8"])
def test_spec_engine_matches_reference_cold_and_prefix_hit(perm, kv):
    """Spec on == spec off, cold and through a prefix hit, on both routes;
    the streams and the round / acceptance counts equal the reference's
    spec engine's; mixed accept / reject rounds; no page leaked."""
    jcfg, tcfg, jtarget, jdraft, ttarget, tdraft = perm
    jout, jstats, _ = _run(_jengine(jcfg, jtarget, _spec(jcfg, jdraft),
                                    kv_dtype=kv), [PROMPT, PROMPT], 10)
    off, off_stats, off_free = _run(_tengine(tcfg, ttarget, kv_dtype=kv),
                                    [PROMPT, PROMPT], 10)
    assert off == jout and "spec_rounds" not in off_stats
    assert off_stats["prefix_hits"] >= 1
    for route in ("reference", "kernel"):
        out, stats, free = _run(
            _tengine(tcfg, ttarget, _spec(tcfg, tdraft), route=route,
                     kv_dtype=kv), [PROMPT, PROMPT], 10)
        assert out == off, route
        assert {c: stats[c] for c in COUNTS} == \
            {c: jstats[c] for c in COUNTS}, route
        assert 0.0 < stats["acceptance_rate"] < 1.0
        assert stats["spec_tokens_per_round"] > 1.0
        assert stats["prefix_hits"] >= 1
        assert free == off_free
        ticks = "attn_kernel_ticks" if route == "kernel" \
            else "attn_gather_ticks"
        assert stats[ticks] > 0


def test_page_accounting_after_mid_round_rejection(perm):
    """More requests than slots, a partial-agreement draft: rejections
    happen mid-round, every stream is exact, and afterwards every page is
    back on the free list and every page-table row is cleared."""
    _, tcfg, _, _, ttarget, tdraft = perm
    prompts = [[i + 1, i + 2, i + 3] for i in range(5)]
    budgets = [5, 7, 4, 6, 8]

    def drive(spec):
        eng = _tengine(tcfg, ttarget, spec, max_len=32)
        try:
            futures = [eng.submit(p, max_new_tokens=b)
                       for p, b in zip(prompts, budgets)]
            out = [f.result(timeout=300)[0] for f in futures]
            return out, eng.stats, eng
        finally:
            eng.stop()

    expect, _, _ = drive(None)
    out, stats, eng = drive(_spec(tcfg, tdraft))
    assert out == expect
    assert stats["spec_rejected"] > 0
    assert len(eng._free_pages) == eng.n_pages
    assert (eng._page_table == -1).all()


def test_acceptance_window_adaptation(perm):
    """An adversarial draft drives the row's gate into probation (plain
    ticks with periodic k=1 probes) with the reference's exact round and
    acceptance counts; a perfect draft rides the full k."""
    jcfg, tcfg, jtarget, _, ttarget, _ = perm
    target_perm, _ = jllama.permutation_pair(64, overlap=0.7)
    jadv = jllama.init_permutation_params(
        jcfg, np.roll(np.asarray(target_perm), 7), seed=3)
    tadv = _convert(jadv)
    over = dict(window=8, probe_every=8)
    jout, jstats, _ = _run(_jengine(jcfg, jtarget, _spec(jcfg, jadv, **over)),
                           [PROMPT], 24)
    out, stats, _ = _run(_tengine(tcfg, ttarget, _spec(tcfg, tadv, **over)),
                         [PROMPT], 24)
    expect, _, _ = _run(_tengine(tcfg, ttarget), [PROMPT], 24)
    assert out == jout == expect
    assert {c: stats[c] for c in COUNTS} == {c: jstats[c] for c in COUNTS}
    assert stats["acceptance_rate"] < 0.35
    assert 0 < stats["spec_rounds"] < 24
    assert stats["spec_resyncs"] > 0          # plain ticks staled the draft
    out, stats, _ = _run(_tengine(tcfg, ttarget, _spec(tcfg, ttarget)),
                         [PROMPT], 24)
    assert out == expect
    assert stats["acceptance_rate"] > 0.9
    assert stats["spec_tokens_per_round"] > 2.0


def test_spec_engine_random_weights_match_reference():
    """A random tiny target with a random tiny draft: the spec engine's
    streams equal the reference spec engine's and the port's spec-off
    streams, every position above a 1e-3 top-2 margin."""
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    jtarget = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jdraft = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    ttarget, tdraft = _convert(jtarget), _convert(jdraft)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (12, 21)]
    kw = dict(max_len=64, prefill_buckets=(16, 32))
    jout, _, _ = _run(_jengine(jcfg, jtarget, _spec(jcfg, jdraft), **kw),
                      prompts, 10)
    off, _, _ = _run(_tengine(tcfg, ttarget, **kw), prompts, 10)
    out, stats, _ = _run(_tengine(tcfg, ttarget, _spec(tcfg, tdraft), **kw),
                         prompts, 10)
    for prompt, tokens in zip(prompts, out):
        seq = torch.tensor([prompt + tokens[:-1]], dtype=torch.long)
        logits = tllama.forward(tcfg, ttarget, seq)[0, len(prompt) - 1:]
        top2 = torch.topk(logits, 2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3
    assert out == jout == off
    assert stats["spec_rounds"] > 0


# -- the batch-1 decoder and the permutation models ---------------------------

def _plain_greedy(cfg, params, prompt, max_new, max_len=256):
    cache = tllm.init_kv_cache(cfg, 1, max_len, device="cpu")
    logits, cache = tllm._forward_with_cache(
        cfg, params, torch.tensor([prompt]), cache)
    out = [int(torch.argmax(logits, -1)[0])]
    while len(out) < max_new:
        logits, cache = tllm._forward_with_cache(
            cfg, params, torch.tensor([[out[-1]]]), cache)
        out.append(int(torch.argmax(logits, -1)[0]))
    return out


@pytest.mark.parametrize("case", ["partial", "perfect", "useless"])
def test_speculative_decoder_matches_reference(perm, case):
    """tests/test_speculative.py's three exact-parity cases: the port's
    decoder emits the target's greedy stream with the reference decoder's
    tokens and round / acceptance counts."""
    jcfg, tcfg, jtarget, jdraft, ttarget, tdraft = perm
    prompt, k, n = {"partial": ([3, 11, 25], 4, 30),
                    "perfect": ([7, 2], 4, 20),
                    "useless": ([5, 9], 3, 16)}[case]
    if case != "partial":
        target_perm, _ = jllama.permutation_pair(64, overlap=1.0)
        jtarget = jllama.init_permutation_params(jcfg, target_perm)
        jdraft = jtarget if case == "perfect" else \
            jllama.init_permutation_params(
                jcfg, np.roll(target_perm, 7), seed=3)
        ttarget, tdraft = _convert(jtarget), _convert(jdraft)
    jout, jstats = JDecoder(jcfg, jtarget, jcfg, jdraft, k=k,
                            max_len=256).generate(prompt, max_new_tokens=n)
    out, stats = SpeculativeDecoder(tcfg, ttarget, tcfg, tdraft, k=k,
                                    max_len=256).generate(prompt,
                                                          max_new_tokens=n)
    assert out == jout == _plain_greedy(tcfg, ttarget, prompt, n)
    assert (stats.rounds, stats.proposed, stats.accepted, stats.tokens) == \
        (jstats.rounds, jstats.proposed, jstats.accepted, jstats.tokens)
    if case == "partial":
        assert 0.0 < stats.acceptance_rate < 1.0
    elif case == "perfect":
        assert stats.acceptance_rate == 1.0
    else:
        assert stats.accepted <= stats.rounds


def test_accept_tokens_rule():
    assert accept_tokens([5, 6, 7], [5, 6, 9, 1], 3) == ([5, 6, 9], 2)
    assert accept_tokens([5, 6, 7], [5, 6, 7, 1], 3) == ([5, 6, 7], 3)
    assert accept_tokens([5], [8, 2], 0) == ([8], 0)


def test_permutation_models_follow_their_permutation():
    """The port's own pair: the same permutations as the reference's
    (numpy draws them), and a greedy step after token t gives the v with
    perm[v] == t; the head is untied and converts both ways."""
    from mlrun_tpu_torch.models.convert import params_to_numpy

    target, draft = tllama.permutation_pair(64, overlap=0.7)
    jt, jd = jllama.permutation_pair(64, overlap=0.7)
    np.testing.assert_array_equal(target, jt)
    np.testing.assert_array_equal(draft, jd)
    assert 0.6 < float((target == draft).mean()) < 0.8
    cfg = tllama.tiny_llama(dtype=torch.float32, vocab_size=64,
                            tie_embeddings=False)
    params = tllama.init_permutation_params(cfg, target)
    logits = tllama.forward(cfg, params, torch.arange(64)[None])[0]
    assert (target[logits.argmax(-1).numpy()] == np.arange(64)).all()
    assert set(params_to_numpy(params)) == {"embedding", "layers",
                                            "final_norm_scale", "lm_head"}
    with pytest.raises(ValueError, match="untied"):
        tllama.init_permutation_params(tllama.tiny_llama(), target)


# -- LLMModelServer -----------------------------------------------------------

class _Event:
    def __init__(self, body, path="/v2/models/m/infer"):
        self.body = body
        self.path = path


@pytest.mark.parametrize("kwargs", [
    {"kv_dtype": "int8"},
    {"speculative": {"draft": "tiny", "k": 3}},
    {"kv_dtype": "int8", "speculative": {"draft": "tiny"}},
])
def test_llm_model_server_int8_and_speculative(kwargs):
    server = tllm.LLMModelServer(
        name="m", model_preset="tiny", continuous_batching=True, paged=True,
        slots=2, max_len=128, page_size=16, max_new_tokens=5, device="cpu",
        **kwargs)
    try:
        prompts = [[3, 4, 5, 6], list(range(1, 30))]
        body = server.do_event(_Event({"inputs": prompts})).body
        assert [len(o) for o in body["outputs"]] == [5, 5]
        stats = server.engine.stats
        assert server.engine.spec_enabled == ("speculative" in kwargs)
        if "speculative" in kwargs:
            assert stats["spec_rounds"] > 0
            assert server.engine.spec_k == kwargs["speculative"].get("k", 4)
        if "kv_dtype" in kwargs:
            assert server.engine._pool["k"].dtype == torch.int8
    finally:
        server.close()


def test_llm_model_server_speculative_needs_a_draft():
    """``speculative=True`` no longer raises; without a draft preset it
    leaves speculation off, as the reference does."""
    server = tllm.LLMModelServer(continuous_batching=True, paged=True,
                                 speculative=True, max_len=128,
                                 page_size=16, device="cpu")
    assert server._speculative_conf() is None
