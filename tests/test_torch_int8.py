"""mlrun_tpu_torch's int8 KV path against mlrun_tpu's on the CPU: the
quantizer, the int8 legs of the paged decode and paged prefill ops (plain
versions vs the Pallas kernels in interpret mode), the int8 prefill
forward and paged decode step, and the paged engine with an int8 pool end
to end, cold and through a prefix-cache hit.

Tolerances: the quantizer is held bit for bit on the same inputs (values
built to land on x.5 after the division included), and so is every
quantization the port's int8 engine performs (each one recorded and
re-run through the reference's ``_quantize_kv``). The ops take the same
int8 pages and scales on both sides, so they differ only by float32
summation order: 2e-5 absolute. The engines run the tiny model in float32
from the same converted weights; their greedy tokens must be identical
(every compared position has a top-2 margin above 1e-3). Their pools are
compared at every live position, but not bit for bit: XLA's and
PyTorch's CPU matmuls round the raw float32 K/V differently in the last
bits (up to ~5e-6 absolute on this model), so the scales (``amax / 127``)
are held to 1e-5 relative (1.5e-6 measured), and an int8 value may
differ by one where the two inputs straddle a rounding tie (at most 1e-3
of the values; 1 in 8192 measured).

Logits held after a quantization (the int8 prefill, cold and through a
prefix hit) are compared at LOGIT_TOL only where both sides read the
same int8 state. One straddled tie in layer 1 moves the tiny model's
logits by ~4.5e-4, four times LOGIT_TOL, while a native cache agrees to
~3e-6. So where ``_assert_int8_state`` finds straddled ties, the port's
forward is run again with those values pinned to the reference's
(``_ties_pinned``: every other int8 value and every scale stays the
port's own, and a pinned value must be off by exactly one), its int8
state is then held bit for bit, and its logits at LOGIT_TOL. A wrong
scale still fails SCALE_RTOL, a wrong page or a wrong value still fails
the state or the logits.
"""

import contextlib
import importlib

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
from mlrun_tpu_torch.ops import paged_attention as tpa
from mlrun_tpu_torch.serving import llm as tllm
from mlrun_tpu_torch.serving import paged as tpaged

# mlrun_tpu.ops re-exports functions under the submodules' names
jpa = importlib.import_module("mlrun_tpu.ops.paged_attention")

OP_TOL = 2e-5
LOGIT_TOL = 1e-4
SCALE_RTOL = 1e-5
TIE_SHARE = 1e-3
PAGE, MAX_LEN = 16, 64


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _close(j, t, tol=OP_TOL):
    diff = np.abs(np.asarray(j, np.float32) - t.detach().float().numpy())
    assert diff.max() <= tol, f"max abs diff {diff.max()} > {tol}"


def _tokens(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=n).astype(
        np.int32)


# -- the quantizer ------------------------------------------------------------

def _half_way_vectors() -> np.ndarray:
    """Rows whose elements land exactly on n + 0.5 after the division by
    the row's scale (amax = 127 * 2**-3, so scale = 2**-3 exactly), where
    round-half-to-even decides the int8 value."""
    halves = np.array([0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 100.5, -7.5,
                       126.5, 4.5, 5.5, 6.5, -126.5, 9.5], np.float32)
    row = np.concatenate([[127.0], halves]) * 2.0 ** -3
    return np.stack([row, -row]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bits_match_reference(dtype):
    rng = np.random.default_rng(0)
    random = rng.standard_normal((3, 5, 2, 16), np.float32) * 0.7
    random[0, 0, 0] = 0.0                     # an all-zero vector: scale 0
    for x in (random, _half_way_vectors()):
        jx = jnp.asarray(x).astype(dtype)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        jq, js = jllm._quantize_kv(jx)
        tq, ts = tllm._quantize_kv(tx)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    # round half to even, as jnp.round does
    assert tq[0, 1:6].tolist() == [0, 2, 2, 4, 0]
    np.testing.assert_array_equal(
        np.asarray(jllm._dequantize_kv(jq, js, jnp.float32)),
        tllm._dequantize_kv(tq, ts, torch.float32).numpy())


# -- int8 ops (plain versions) vs the Pallas kernels in interpret mode -------

def _int8_pool(rng, n_pages, page_size, hkv, d):
    """Random float pages quantized by the reference: (jax, torch) pairs
    of int8 pages and float32 scales, the same bits on both sides."""
    out = []
    for _ in ("k", "v"):
        x = rng.standard_normal((n_pages + 1, page_size, hkv, d), np.float32)
        q, s = jllm._quantize_kv(jnp.asarray(x))
        out.append(((q, s), (torch.from_numpy(np.asarray(q).copy()),
                             torch.from_numpy(np.asarray(s).copy()))))
    return out


@pytest.mark.parametrize("n_rep", [1, 2])
def test_paged_decode_int8_plain_matches_pallas(n_rep):
    rng = np.random.default_rng(4)
    slots, pps, ps, hkv, d = 4, 4, 8, 2, 16
    h = hkv * n_rep
    ((kj, ksj), (kt, kst)), ((vj, vsj), (vt, vst)) = _int8_pool(
        rng, 12, ps, hkv, d)
    q = rng.standard_normal((slots, h, d), np.float32)
    table = np.full((slots, pps), -1, np.int32)
    table[0, :2] = [3, 7]
    table[1, :4] = [0, 1, 2, 8]
    table[2, :3] = [9, 10, 11]
    table[3, :1] = [5]
    pos = np.array([11, 31, 16, 7], np.int32)
    out_j = jpa._paged_decode_call(jnp.asarray(q), kj, vj, jnp.asarray(table),
                                   jnp.asarray(pos), ps, k_scale=ksj,
                                   v_scale=vsj, interpret=True)
    args = (torch.from_numpy(q), kt, vt, torch.from_numpy(table),
            torch.from_numpy(pos))
    out_t = tpa._paged_decode_call(*args, ps, k_scale=kst, v_scale=vst)
    assert out_t.shape == (slots, h, d) and out_t.dtype == torch.float32
    _close(out_j, out_t)
    _close(out_j, tpa.paged_attention(*args, page_size=ps, k_scale=kst,
                                      v_scale=vst))


@pytest.mark.parametrize("s,base", [(5, 16), (12, 24), (1, 8)])
def test_paged_prefill_int8_plain_matches_pallas(s, base):
    rng = np.random.default_rng(5)
    pps, ps, hkv, d, h = 4, 8, 2, 16, 4
    ((kj, ksj), (kt, kst)), ((vj, vsj), (vt, vst)) = _int8_pool(
        rng, 10, ps, hkv, d)
    q = rng.standard_normal((s, h, d), np.float32)
    ids = np.full((pps,), -1, np.int32)
    ids[:-(-base // ps)] = [6, 2, 9][:-(-base // ps)]
    o_j, lse_j = jpa._paged_prefill_call(
        jnp.asarray(q), kj, vj, jnp.asarray(ids), base, ps, k_scale=ksj,
        v_scale=vsj, interpret=True)
    o_t, lse_t = tpa._paged_prefill_call(
        torch.from_numpy(q), kt, vt, torch.from_numpy(ids), base, ps,
        k_scale=kst, v_scale=vst)
    _close(o_j, o_t)
    _close(lse_j, lse_t)
    o1_j, lse1_j = jpa.paged_prefix_part(
        jnp.asarray(q)[None], kj, vj, jnp.asarray(ids), base, page_size=ps,
        k_scale=ksj, v_scale=vsj, interpret=True)
    o1_t, lse1_t = tpa.paged_prefix_part(
        torch.from_numpy(q)[None], kt, vt, torch.from_numpy(ids), base,
        page_size=ps, k_scale=kst, v_scale=vst)
    _close(o1_j, o1_t)
    _close(lse1_j, lse1_t)


def test_int8_gather_dequantizes_after_the_gather_in_float32():
    """The plain versions' int8 view is exactly int8 x scale in float32,
    element by element (the kernels' one multiply per element)."""
    rng = np.random.default_rng(6)
    (_, (kt, kst)), _ = _int8_pool(rng, 3, 4, 2, 16)
    ids = torch.tensor([[2, -1, 0]], dtype=torch.int32)
    view = tpa._gather_pages(kt, ids, kst)
    want = kt[[2, 0, 0]].float() * kst[[2, 0, 0]][..., None]
    assert torch.equal(view[0], want.reshape(12, 2, 16))


# -- the int8 prefill forward and decode step ---------------------------------

def _int8_prefix_pools(models, prompt, base, ids):
    jcfg, jparams, tcfg, tparams = models
    _, jsmall = jllm._forward_with_cache(
        jcfg, jparams, jnp.asarray(prompt[:base][None]),
        jllm.init_kv_cache(jcfg, 1, MAX_LEN, kv_dtype="int8"))
    jpool = jpaged.insert_prompt_pages(
        jpaged.init_paged_pool(jcfg, 9, PAGE, kv_dtype="int8"), jsmall,
        jnp.asarray(ids), PAGE)
    tsmall = tllm.init_kv_cache(tcfg, 1, MAX_LEN, kv_dtype="int8",
                                device="cpu")
    tllm._forward_with_cache(tcfg, tparams,
                             torch.from_numpy(prompt[:base][None]).long(),
                             tsmall)
    tpool = tpaged.insert_prompt_pages(
        tpaged.init_paged_pool(tcfg, 9, PAGE, kv_dtype="int8", device="cpu"),
        tsmall, ids, PAGE)
    return jpool, tpool


def _assert_int8_state(j: dict, t: dict, index=slice(None)):
    """int8 values equal but at straddled rounding ties (off by one, at
    most TIE_SHARE of them); scales within SCALE_RTOL."""
    for name in ("k", "v"):
        diff = np.abs(np.asarray(j[name])[index].astype(np.int32)
                      - t[name].numpy()[index].astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= TIE_SHARE, \
            (name, int(diff.max()), float((diff > 0).mean()))
        js = np.asarray(j[f"{name}_scale"])[index]
        ts = t[f"{name}_scale"].numpy()[index]
        np.testing.assert_allclose(ts, js, rtol=SCALE_RTOL, atol=0)


def _int8_equal(j: dict, t: dict) -> bool:
    return all(np.array_equal(np.asarray(j[name]), t[name].numpy())
               for name in ("k", "v"))


@contextlib.contextmanager
def _ties_pinned(jcache: dict, start: int):
    """Within the block, the port's prefill forward takes the reference's
    int8 value wherever its own quantization lands one step away (a
    straddled rounding tie). Its forward quantizes k then v once a layer,
    for the chunk at ``start``, which is how calls map to ``jcache``."""
    quantize = tllm._quantize_kv
    calls = []

    def pinned(x):
        q, scales = quantize(x)
        layer, name = divmod(len(calls), 2)
        want = torch.from_numpy(np.asarray(
            jcache["kv"[name]][layer])[:, start:start + x.shape[1]].copy())
        off = (q.to(torch.int32) - want.to(torch.int32)).abs()
        assert int(off.max()) <= 1 and float((off > 0).double().mean()) \
            <= TIE_SHARE
        calls.append(int((off > 0).sum()))
        return torch.where(off > 0, want, q), scales

    tllm._quantize_kv = pinned
    try:
        yield calls
    finally:
        tllm._quantize_kv = quantize


def _int8_prefill(tcfg, tparams, tokens, cache, jcache, start, **kw):
    """The port's int8 prefill of ``tokens`` into ``cache`` (a fresh copy
    each run), again with straddled ties pinned where its int8 state
    differs from the reference's ``jcache``; the state is then equal."""
    fresh = {name: a.clone() for name, a in cache.items()}
    tlog, tcache = tllm._forward_with_cache(
        tcfg, tparams, torch.from_numpy(tokens[None]).long(), fresh, **kw)
    _assert_int8_state(jcache, tcache)
    if not _int8_equal(jcache, tcache):
        fresh = {name: a.clone() for name, a in cache.items()}
        with _ties_pinned(jcache, start) as pins:
            tlog, tcache = tllm._forward_with_cache(
                tcfg, tparams, torch.from_numpy(tokens[None]).long(),
                fresh, **kw)
        assert sum(pins) > 0
        assert _int8_equal(jcache, tcache)
    return tlog, tcache


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_forward_with_cache_int8_cold_and_hit(models, impl):
    """Cold int8 prefill, then a suffix prefill through a prefix hit on
    an int8 pool (the prefix attended in place with its scales): caches
    and pool bits as stated, and logits within LOGIT_TOL of the
    reference's wherever both sides read the same int8 state (straddled
    ties pinned, module docstring)."""
    jcfg, jparams, tcfg, tparams = models
    prompt = _tokens(2, 40)
    jlog, jcache = jllm._forward_with_cache(
        jcfg, jparams, jnp.asarray(prompt[None]),
        jllm.init_kv_cache(jcfg, 1, MAX_LEN, kv_dtype="int8"), attn_impl=impl)
    tlog, _ = _int8_prefill(
        tcfg, tparams, prompt,
        tllm.init_kv_cache(tcfg, 1, MAX_LEN, kv_dtype="int8", device="cpu"),
        jcache, 0, attn_impl=impl)
    _close(jlog, tlog, LOGIT_TOL)

    base = 32
    ids = np.full((MAX_LEN // PAGE,), -1, np.int32)
    ids[:2] = [3, 1]
    jpool, tpool = _int8_prefix_pools(models, prompt, base, ids)
    _assert_int8_state(jpool, tpool)
    # the hit reads the pool both sides built; held at LOGIT_TOL on the
    # reference's pages (the same state), the port's own pages only where
    # they are bit-equal to it
    pools = [{name: torch.from_numpy(np.asarray(a).copy())
              for name, a in jpool.items()}]
    if _int8_equal(jpool, tpool):
        pools.append(tpool)
    jsmall = jllm.init_kv_cache(jcfg, 1, MAX_LEN, kv_dtype="int8")
    jsmall["pos"] = jnp.full((1,), base, jnp.int32)
    jprefix = {name: jpool[name] for name in jpool}
    jprefix.update(page_ids=jnp.asarray(ids), base=jnp.int32(base))
    jlog, jsmall = jllm._forward_with_cache(
        jcfg, jparams, jnp.asarray(prompt[base:][None]), jsmall,
        prefix_kv=jprefix, attn_impl=impl, page_size=PAGE)
    tsmall = tllm.init_kv_cache(tcfg, 1, MAX_LEN, kv_dtype="int8",
                                device="cpu")
    tsmall["pos"].fill_(base)
    for pool in pools:
        tprefix = dict(pool, page_ids=torch.from_numpy(ids), base=base)
        tlog, _ = _int8_prefill(
            tcfg, tparams, prompt[base:], tsmall, jsmall, base,
            prefix_kv=tprefix, attn_impl=impl, page_size=PAGE)
        _close(jlog, tlog, LOGIT_TOL)


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_decode_rowwise_paged_int8_matches_reference(models, impl):
    """Three slots over a random int8 pool (one unmapped, pos 0): the
    kernel route (plain version on the CPU) and the gather route give the
    reference's tokens and write the reference's bits."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(3)
    shape = (jcfg.n_layers, 9, PAGE, jcfg.n_kv_heads, jcfg.head_dim)
    jpool = {}
    for name in ("k", "v"):
        q, s = jllm._quantize_kv(jnp.asarray(
            rng.standard_normal(shape, np.float32) * 0.5))
        jpool[name], jpool[f"{name}_scale"] = q, s
    tpool = {name: torch.from_numpy(np.asarray(a).copy())
             for name, a in jpool.items()}
    table = np.full((3, MAX_LEN // PAGE), -1, np.int32)
    table[0, :2] = [4, 2]
    table[1, :4] = [0, 1, 5, 7]
    pos = np.array([20, 63, 0], np.int32)
    tokens = np.array([[7], [300], [0]], np.int32)
    jtok, jpool, _ = jpaged._decode_rowwise_paged(
        jcfg, PAGE, impl, jparams, jnp.asarray(tokens), jpool,
        jnp.asarray(table), jnp.asarray(pos))
    ttok, tpool, _ = tpaged._decode_rowwise_paged(
        tcfg, PAGE, impl, tparams, torch.from_numpy(tokens).long(), tpool,
        torch.from_numpy(table), torch.from_numpy(pos))
    np.testing.assert_array_equal(np.asarray(jtok)[:2], ttok.numpy()[:2])
    live = [0, 1, 2, 4, 5, 7]            # the scratch page (8) is never read
    _assert_int8_state(jpool, tpool, (slice(None), live))


# -- the int8 paged engine end to end -----------------------------------------

ENGINE_KW = dict(max_len=128, slots=2, page_size=PAGE,
                 prefill_buckets=(16, 32, 64))
NEW = 6


def _requests():
    a = _tokens(12, 40).tolist()
    b = a[:32] + _tokens(112, 10).tolist()     # shares two pages with a
    c = _tokens(212, 20).tolist()
    return a, b, c


def _drive(engine, pages: list):
    """a cold, b through a prefix hit on a's pages, then c and a together;
    ``pages`` collects each admission's (prompt, page ids)."""
    complete = engine._complete_storage

    def record(adm):
        pages.append((list(adm.prompt), np.asarray(adm.page_ids).copy()))
        return complete(adm)

    engine._complete_storage = record
    a, b, c = _requests()
    out = [engine.generate(a, NEW)[0], engine.generate(b, NEW)[0]]
    futures = [engine.submit(p, NEW) for p in (c, a)]
    out += [f.result(timeout=120)[0] for f in futures]
    return [list(map(int, t)) for t in out]


def _min_margin(tcfg, tparams, prompt, generated) -> float:
    seq = torch.tensor([prompt + generated[:-1]], dtype=torch.long)
    logits = tllama.forward(tcfg, tparams, seq)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def _live_index(pages, outputs):
    """(page, offset) of every position a request wrote KV for: its prompt
    and all generated tokens but the last."""
    page_idx, offsets = [], []
    for (prompt, ids), out in zip(pages, outputs):
        for p in range(len(prompt) + len(out) - 1):
            page_idx.append(ids[p // PAGE])
            offsets.append(p % PAGE)
    return np.asarray(page_idx), np.asarray(offsets)


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

    for module in (tllm, tpaged):
        monkeypatch.setattr(module, "_quantize_kv", recording)
    return calls


def test_int8_paged_engine_tokens_and_pool_bits_match_reference(
        models, quantize_calls):
    jcfg, jparams, tcfg, tparams = models
    jeng = jpaged.PagedContinuousBatchingEngine(jcfg, jparams,
                                                kv_dtype="int8", **ENGINE_KW)
    jpages: list = []
    try:
        jout = _drive(jeng, jpages)
        jpool = {name: np.asarray(a) for name, a in jeng._pool.items()}
    finally:
        jeng.stop()
    teng = tpaged.PagedContinuousBatchingEngine(
        tcfg, tparams, kv_dtype="int8", device="cpu", **ENGINE_KW)
    tpages: list = []
    try:
        tout = _drive(teng, tpages)
        stats = teng.stats
    finally:
        teng.stop()
    a, b, c = _requests()
    for prompt, tokens in zip((a, b, c, a), jout):
        assert _min_margin(tcfg, tparams, prompt, tokens) > 1e-3
    assert tout == jout
    assert stats["prefix_hits"] >= 1 and stats["attn_gather_ticks"] > 0
    for (jp, jids), (tp, tids) in zip(jpages, tpages):
        assert jp == tp
        np.testing.assert_array_equal(jids, tids)
    pidx, off = _live_index(tpages, tout)
    _assert_int8_state(jpool, teng._pool, (slice(None), pidx, off))
    # the int8 bits: every quantization the engine did is the reference's
    assert len(quantize_calls) > 2 * NEW
    for x, q, scale in quantize_calls:
        jq, js = jllm._quantize_kv(jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(np.asarray(jq), q.numpy())
        np.testing.assert_array_equal(np.asarray(js), scale.numpy())
