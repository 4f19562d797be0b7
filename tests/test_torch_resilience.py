"""mlrun_tpu_torch's serving resilience against mlrun_tpu's on the CPU, at
``tiny_llama`` size in float32: the degradation ladder (its clamp of
``max_new_tokens``, its speculation flip, the paged free-page rung), the
``max_wait`` expiry (504) and the queue-full shed (429), the chaos points
the engines fire (``llm.spec_verify`` parks a tick to plain decode,
``llm.submit``, ``llm.prefill``, ``llm.adapter_load``), the request
ledger on the engines and the v2 ``{"timing": true}`` field on the paged
and dense servers, and the engines' metric series.

Expiry runs on a fake ``perf_counter`` (the engines' clock module is
swapped for one the test advances) and the scheduler steps are called
by hand, so no outcome depends on the wall clock; ledger closures run on
integer fake clocks and must be exact. Streams are held token for token
against the JAX engines: speculation rides the reference's permutation
pair (argmax gaps O(50)), the random-weight streams have top-2 margins
above 1e-3 (asserted). The port's chaos registry, metrics, flight
recorder and tracer are reset around every test.
"""

import dataclasses
import itertools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu import chaos as jchaos
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.serving import llm_batch as jbatch
from mlrun_tpu.serving import paged as jpaged
from mlrun_tpu.serving import resilience as jres
from mlrun_tpu_torch import chaos as tchaos
from mlrun_tpu_torch import obs as tobs
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.serving import llm as tllm
from mlrun_tpu_torch.serving import llm_batch as tbatch
from mlrun_tpu_torch.serving import paged as tpaged
from mlrun_tpu_torch.serving import resilience as tres
from tests.torch_registries import registries_left_as_found  # noqa: F401

PAGE, MAX_LEN = 16, 64


@pytest.fixture(autouse=True)
def _fresh_state():
    def reset():
        tchaos.chaos.clear()
        jchaos.chaos.clear()
        tobs.REGISTRY.reset()
        tobs.get_flight_recorder().clear()
        tobs.get_tracer().clear()

    reset()
    yield
    reset()


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=n).tolist()


def _engines(models, paged, **kw):
    """The reference's engine and the port's with the same knobs; neither
    scheduler runs (``start`` is a no-op), so the test drives the steps."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(max_len=MAX_LEN, slots=2, prefill_buckets=(16,), **kw)
    if paged:
        kw["page_size"] = PAGE
        jeng = jpaged.PagedContinuousBatchingEngine(jcfg, jparams, **kw)
        teng = tpaged.PagedContinuousBatchingEngine(tcfg, tparams,
                                                    device="cpu", **kw)
    else:
        jeng = jbatch.ContinuousBatchingEngine(jcfg, jparams, **kw)
        teng = tbatch.ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                               **kw)
    for eng in (jeng, teng):
        eng.start = lambda: None
    return jeng, teng


def _queued(engine) -> list:
    items = []
    while not engine._queue.empty():
        items.append(engine._queue.get_nowait())
    return items


class _FakeClock:
    """A stand-in for an engine module's ``time``: ``perf_counter`` reads
    ``now``, which only the test moves."""

    def __init__(self):
        self.now = 1000.0
        self.time = time.time
        self.sleep = time.sleep

    def perf_counter(self):
        return self.now


# -- the degradation ladder --------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_ladder_clamps_and_flips_speculation_like_reference(models, paged):
    """Queue depth 2 reaches the degraded rung: the third request's
    max_new_tokens is clamped and speculation parks; once the pressure is
    gone it comes back on — the reference's sequence, item for item."""
    runs = []
    for eng in _engines(models, paged, max_queue_size=8,
                        degradation={"queue_depth": 2, "max_new_tokens": 4}):
        flags = [eng.speculative_enabled]
        for prompt in ([1], [2], [3]):
            eng.submit(prompt, max_new_tokens=16)
            flags.append(eng.speculative_enabled)
        level = eng.pressure_level()
        clamps = [item[2] for item in _queued(eng)]
        eng.submit([4], max_new_tokens=16)
        flags.append(eng.speculative_enabled)
        runs.append((flags, level, clamps, eng.stats["degraded"],
                     eng.stats["pressure_level"]))
        eng.stop()
    assert runs[1] == runs[0]
    assert runs[1] == ([True, True, True, False, True], 1, [16, 16, 4], 1, 0)


def test_degradation_spec_validation_matches_reference():
    for spec, match in (({"queue_dpth": 3}, "unknown degradation keys"),
                        ({"min_free_page_frac": 2.0}, "min_free_page_frac"),
                        ({"queue_depth": 0}, "queue_depth"),
                        ({"max_new_tokens": -1}, "max_new_tokens")):
        for ladder in (jres.DegradationLadder, tres.DegradationLadder):
            with pytest.raises(ValueError, match=match):
                ladder.from_spec(spec)
    assert tres.DegradationLadder.from_spec({}) is None
    ladder = tres.DegradationLadder.from_spec({"queue_depth": 3,
                                               "max_new_tokens": 8})
    reference = jres.DegradationLadder.from_spec({"queue_depth": 3,
                                                  "max_new_tokens": 8})
    for depth, cap, frac in itertools.product((0, 2, 3, 5), (0, 5),
                                              (None, 0.1, 0.9)):
        assert ladder.level(depth, cap, frac) == \
            reference.level(depth, cap, frac)
        for level in (0, 1, 2):
            assert ladder.clamp_max_new(64, level) == \
                reference.clamp_max_new(64, level)


def test_paged_page_exhaustion_degrades_like_reference(models):
    """Burning free pages below min_free_page_frac reaches the degraded
    rung before admission would block on the pool."""
    for eng in _engines(models, True,
                        degradation={"min_free_page_frac": 0.5,
                                     "max_new_tokens": 4}):
        assert eng.pressure_level() == 0
        while len(eng._free_pages) / eng.n_pages >= 0.5:
            eng._free_pages.popleft()
        assert eng._free_page_frac() < 0.5
        assert eng.pressure_level() == 1
        eng.stop()


# -- max_wait expiry and the queue-full shed ----------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_max_wait_expiry_and_shed_like_reference(models, monkeypatch, paged):
    """Two queued requests past their 0.05 s budget fail with
    DeadlineExceeded (504) at the next sweep, the third is shed at submit
    with QueueFullError (429, the reference's retry-after hint); a
    request with its own larger budget survives the sweep."""
    outcomes = []
    for module, eng in zip((jbatch, tbatch),
                           _engines(models, paged, max_queue_size=3,
                                    max_wait=0.05)):
        clock = _FakeClock()
        monkeypatch.setattr(module, "time", clock)
        futures = [eng.submit([1, 2], max_new_tokens=4),
                   eng.submit([3, 4], max_new_tokens=4),
                   eng.submit([9], max_new_tokens=4, max_wait=10.0),
                   eng.submit([5, 6], max_new_tokens=4)]
        assert futures[3].done()
        clock.now += 1.0
        eng._expire_queued()
        errors = [type(f.exception(timeout=1)).__name__ if f.done()
                  else None for f in futures]
        codes = [f.exception().status_code for f in futures if f.done()]
        stats = eng.stats
        outcomes.append((errors, codes, stats["shed"], stats["expired"],
                         futures[3].exception().retry_after_s,
                         eng._queue.qsize()))
        eng.stop()
    assert outcomes[1] == outcomes[0]
    assert outcomes[1] == (["DeadlineExceeded", "DeadlineExceeded", None,
                            "QueueFullError"], [504, 504, 429], 1, 2, 0.05,
                           1)


def test_paged_head_of_line_request_expires_like_reference(models,
                                                          monkeypatch):
    """A request parked at the head of the line waiting for pages carries
    its budget: it expires out of the pending deque."""
    outcomes = []
    for module, eng in zip((jbatch, tbatch),
                           _engines(models, True, max_wait=0.1)):
        clock = _FakeClock()
        monkeypatch.setattr(module, "time", clock)
        eng._free_pages.clear()           # every page held elsewhere
        future = eng.submit(_tokens(5, 20), max_new_tokens=4)
        assert eng._prepare_admission() is None
        parked = len(eng._pending)
        clock.now += 0.05
        eng._expire_queued()
        alive = not future.done()
        clock.now += 0.1
        eng._expire_queued()
        outcomes.append((parked, alive, type(future.exception(timeout=1)),
                         len(eng._pending), eng.stats["expired"]))
        eng.stop()
    assert outcomes[0][2] is jres.DeadlineExceeded
    assert outcomes[1][2] is tres.DeadlineExceeded
    assert [o[:2] + o[3:] for o in outcomes] == [(1, True, 0, 1)] * 2


# -- llm.spec_verify: a parked tick is plain decode ----------------------------

@pytest.fixture(scope="module")
def perm():
    """The reference's permutation pair at overlap 0.7 (vocab 64, float32)
    and its conversion."""
    jcfg = dataclasses.replace(
        jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference"),
        vocab_size=64, tie_embeddings=False)
    tcfg = tllama.tiny_llama(dtype=torch.float32, vocab_size=64,
                             tie_embeddings=False)
    target_perm, draft_perm = jllama.permutation_pair(64, overlap=0.7)
    trees = [jllama.init_permutation_params(jcfg, p)
             for p in (target_perm, draft_perm)]
    converted = [params_from_numpy(jax.tree.map(np.asarray, t), "cpu")
                 for t in trees]
    return jcfg, tcfg, trees, converted


SPEC_PROMPT = [1, 7, 3, 9, 2, 4, 6, 8, 5, 3, 1, 2]
SPEC_KW = dict(max_len=64, slots=2, prefill_buckets=(16,), page_size=8)


def _spec_engines(perm, route="reference", **kw):
    jcfg, tcfg, (jt, jd), (tt, td) = perm
    spec = {"enabled": True, "k": 4}
    jeng = jpaged.PagedContinuousBatchingEngine(
        jcfg, jt, speculative=dict(spec, draft_config=jcfg, draft_params=jd),
        **SPEC_KW, **kw)
    teng = tpaged.PagedContinuousBatchingEngine(
        tcfg, tt, speculative=dict(spec, draft_config=tcfg, draft_params=td),
        device="cpu", **SPEC_KW, **kw)
    teng.attn_impl = route
    return jeng, teng


SPEC_COUNTS = ("spec_parked_ticks", "spec_rounds", "spec_proposed",
               "spec_accepted", "spec_resyncs")


@pytest.mark.parametrize("route", ["reference", "kernel"])
def test_chaos_spec_verify_parks_ticks_like_reference(perm, route):
    """An armed llm.spec_verify error parks its ticks to plain decode —
    never a client error — then the rows resync their drafts and
    speculation resumes: the stream, the parked-tick count and every
    speculation count equal the reference engine's under the same
    schedule, and the parks land on the flight ring. ``route="kernel"``
    runs the paged decode and verify wrappers' plain versions."""
    jeng, teng = _spec_engines(perm, route)
    runs = []
    for eng, registry in ((jeng, jchaos.chaos), (teng, tchaos.chaos)):
        try:
            with registry.inject("llm.spec_verify", jchaos.fail_first(3)
                                 if registry is jchaos.chaos
                                 else tchaos.fail_first(3),
                                 error=RuntimeError("injected verify")):
                out, _ = eng.generate(SPEC_PROMPT, max_new_tokens=12)
            stats = eng.stats
        finally:
            eng.stop()
        runs.append((out, [stats[k] for k in SPEC_COUNTS]))
    assert runs[1] == runs[0]
    assert runs[1][1][0] == 3 and runs[1][1][1] > 0
    parks = tobs.get_flight_recorder().events("engine.spec_park")
    assert len(parks) == 3 and parks[0]["error"] == "injected verify"
    assert tobs.CHAOS_FIRED.value(point="llm.spec_verify") == 3


def test_ladder_parks_speculation_and_streams_stay_greedy(perm):
    """A burst past the ladder's queue_depth parks speculation (the
    degraded submits flip it off, the last one back on) and clamps the
    degraded requests; every stream equals the reference engine's under
    the same burst, and the clamp bounds each degraded stream."""
    prompts = [SPEC_PROMPT, SPEC_PROMPT[:9], SPEC_PROMPT[2:], [5, 1, 2, 3]]
    runs = []
    for eng in _spec_engines(perm, degradation={"queue_depth": 2,
                                                "max_new_tokens": 3}):
        start, eng.start = eng.start, lambda: None
        futures, flags = [], []
        for prompt in prompts:
            futures.append(eng.submit(prompt, max_new_tokens=10))
            flags.append(eng.speculative_enabled)
        del eng.start
        start()
        try:
            outs = [f.result(timeout=300)[0] for f in futures]
            stats = eng.stats
        finally:
            eng.stop()
        runs.append((outs, flags, stats["degraded"]))
    assert runs[1] == runs[0]
    outs, flags, degraded = runs[1]
    assert flags == [True, True, False, False] and degraded == 2
    assert [len(o) for o in outs] == [10, 10, 3, 3]


# -- the request ledger and the v2 timing field --------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_ledger_closes_exactly_like_reference(models, paged):
    """Under an integer fake ledger clock on both engines, a cold request
    and a repeat (a prefix hit on the paged engine) walk the same phase
    transitions as the reference's: identical phase seconds, exact
    closure, identical tokens; with the ledger off the tokens stay and
    no timing comes back."""
    prompt = _tokens(21, 40)
    results = []
    for eng in _engines(models, paged, request_ledger=True):
        del eng.start
        eng._ledger_clock = itertools.count(0).__next__
        try:
            runs = [eng.generate(prompt, max_new_tokens=5) for _ in (0, 1)]
        finally:
            eng.stop()
        results.append([(tokens, stats["timing"]) for tokens, stats in runs])
    for (jtok, jt), (ttok, tt) in zip(*results):
        assert ttok == jtok
        assert tt["attribution_closed"]
        assert tt["wall_s"] == sum(tt["phases"].values())
        assert float(tt["wall_s"]).is_integer()
        assert tt["phases"] == jt["phases"]
        assert tt.get("cached_prefix", 0) == jt.get("cached_prefix", 0)
    if paged:
        assert results[1][1][1]["cached_prefix"] == 32
    _, teng = _engines(models, paged, request_ledger=False)
    del teng.start
    try:
        tokens, stats = teng.generate(prompt, max_new_tokens=5)
    finally:
        teng.stop()
    assert "timing" not in stats and tokens == results[1][0][0]


def _server_pair(models, monkeypatch, **kwargs):
    from mlrun_tpu.frameworks.jax import auto_trainer as jauto
    from mlrun_tpu.serving.llm import LLMModelServer as JServer

    jcfg, _, tcfg, tparams = models
    monkeypatch.setitem(jauto.MODEL_PRESETS, "tiny", lambda: jcfg)
    monkeypatch.setitem(tllama.MODEL_PRESETS, "tiny", lambda: tcfg)
    monkeypatch.setattr(tllama, "init_params",
                        lambda config, generator, device: tparams)
    common = dict(name="m", model_preset="tiny", continuous_batching=True,
                  slots=2, max_len=MAX_LEN, max_new_tokens=4, warmup=False,
                  **kwargs)
    return JServer(**common), tllm.LLMModelServer(device="cpu", **common)


class _Event:
    def __init__(self, body, path="/v2/models/m/infer"):
        self.body = body
        self.path = path


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_server_overload_knobs_and_timing_like_reference(models, monkeypatch,
                                                         paged):
    """LLMModelServer takes max_wait, degradation and request_ledger (they
    raised item 2 before it landed), hands them to its engine as the
    reference's does, and answers {"timing": true} with one closed
    breakdown per input beside the same outputs."""
    extra = {"paged": True, "page_size": PAGE} if paged else {}
    jserver, tserver = _server_pair(
        models, monkeypatch, max_queue_size=8, max_wait=30.0,
        degradation={"queue_depth": 6, "max_new_tokens": 2},
        request_ledger=True, **extra)
    body = {"inputs": [_tokens(3, 18), _tokens(4, 7)], "timing": True}
    try:
        want = jserver.do_event(_Event(dict(body))).body
        got = tserver.do_event(_Event(dict(body))).body
        engines = (jserver.engine, tserver.engine)
    finally:
        for server in (jserver, tserver):
            if server.engine is not None:
                server.engine.stop()
    for attr in ("max_queue_size", "max_wait", "request_ledger"):
        assert getattr(engines[1], attr) == getattr(engines[0], attr)
    assert vars(engines[1].degradation) == vars(engines[0].degradation)
    assert got["outputs"] == want["outputs"]
    assert len(got["timing"]) == 2
    for timing in got["timing"]:
        assert timing["attribution_closed"]
        assert timing["wall_s"] == pytest.approx(
            sum(timing["phases"].values()), abs=1e-9)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_default_server_ledger_follows_config_and_off_does_no_work(
        models, monkeypatch, paged):
    """request_ledger=None resolves through the port's config (on, as the
    reference's mlconf), so a default server returns timing when asked;
    request_ledger=False constructs no RequestLedger at all and returns
    none."""
    built = []

    class Counting(tbatch.RequestLedger):
        __slots__ = ()

        def __init__(self, *a, **kw):
            built.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(tbatch, "RequestLedger", Counting)
    extra = {"paged": True, "page_size": PAGE} if paged else {}
    body = {"inputs": [_tokens(6, 9)], "timing": True}
    outputs = []
    for ledger in (None, False):
        _, server = _server_pair(models, monkeypatch, request_ledger=ledger,
                                 **extra)
        built.clear()
        try:
            got = server.do_event(_Event(dict(body))).body
            assert server.engine.request_ledger is (ledger is None)
        finally:
            server.engine.stop()
        outputs.append(got["outputs"])
        if ledger is None:
            assert len(built) == 1 and got["timing"][0]["attribution_closed"]
        else:
            assert built == [] and "timing" not in got
    assert outputs[0] == outputs[1]


def test_timing_does_not_leak_across_requests(models, monkeypatch):
    """The timing hand-over is cleared per request: a request without the
    flag after one with it gets no timing field."""
    _, server = _server_pair(models, monkeypatch, paged=True, page_size=PAGE)
    try:
        timed = server.do_event(_Event({"inputs": [[1, 2, 3]],
                                        "timing": True})).body
        plain = server.do_event(_Event({"inputs": [[1, 2, 3]]})).body
    finally:
        server.engine.stop()
    assert "timing" in timed and "timing" not in plain


# -- the engines' metric series and chaos points --------------------------------

def test_engine_series_count_requests_and_retire_on_stop(models):
    """One TTFT observation a request on the standalone series, the
    engine's event counters mirrored at scrape time, and every series the
    engine owns gone after stop."""
    _, teng = _engines(models, True)
    del teng.start
    name = teng._obs_name
    try:
        for seed in (1, 2, 3):
            teng.generate(_tokens(seed, 12), max_new_tokens=3)
        text = tobs.REGISTRY.render()
    finally:
        teng.stop()
    assert tobs.LLM_TTFT.value(replica="", adapter="")["count"] == 3
    assert tobs.LLM_DECODE_TICK.value(replica="")["count"] >= 2
    assert f'mlt_llm_events_total{{engine="{name}",replica="",' \
           f'event="completed"}} 3' in text
    assert f'mlt_llm_free_page_frac{{engine="{name}",replica=""}}' in text
    text = tobs.REGISTRY.render()
    assert f'engine="{name}"' not in text


def test_submit_and_prefill_chaos_like_reference(models):
    """An armed llm.submit error raises out of submit() before anything is
    queued; an armed llm.prefill error fails the request and stops the
    engine, whose later submits fail fast with the cause — as the
    reference's."""
    outcomes = []
    for eng, module in zip(_engines(models, True), (jchaos, tchaos)):
        del eng.start
        with module.chaos.inject("llm.submit",
                                 error=RuntimeError("submit torn")):
            with pytest.raises(RuntimeError, match="submit torn"):
                eng.submit([1, 2, 3], max_new_tokens=2)
        queued = eng.stats["requests"]
        with module.chaos.inject("llm.prefill",
                                 error=RuntimeError("prefill torn")):
            future = eng.submit([1, 2, 3], max_new_tokens=2)
            with pytest.raises(RuntimeError, match="prefill torn"):
                future.result(timeout=60)
        later = eng.submit([4, 5], max_new_tokens=2)
        with pytest.raises(Exception, match="prefill torn") as err:
            later.result(timeout=5)
        outcomes.append((queued, type(err.value).__name__,
                         err.value.status_code))
        eng.stop()
    assert outcomes[1] == outcomes[0] == (0, "EngineStoppedError", 503)
    assert tobs.get_flight_recorder().events("engine.crash")


def test_adapter_load_chaos_fails_one_request(models):
    """An armed llm.adapter_load error (op "load") fails the one request
    that needed the load, typed as injected; the next request loads and
    is served, and retiring the adapter drops its phase series."""
    from mlrun_tpu.models import lora as jlora

    jcfg, _, _, _ = models
    tree = params_from_numpy(jax.tree.map(
        np.asarray, jlora.init_lora_nonzero(jcfg, jax.random.PRNGKey(3),
                                            rank=4)), "cpu")
    _, teng = _engines(models, True, adapters={"t1": tree})
    del teng.start
    try:
        with tchaos.chaos.inject("llm.adapter_load", tchaos.fail_first(1),
                                 match=lambda ctx: ctx["op"] == "load",
                                 error=RuntimeError("artifact torn")):
            with pytest.raises(RuntimeError, match="artifact torn"):
                teng.generate([1, 2, 3], max_new_tokens=2, adapter="t1")
            tokens, stats = teng.generate([1, 2, 3], max_new_tokens=2,
                                          adapter="t1")
        assert len(tokens) == 2 and stats["timing"]["attribution_closed"]
        assert "adapter_load_wait" in stats["timing"]["phases"]
        family = tobs.REQUEST_PHASE_SECONDS
        assert family.value(phase="prefill", adapter="t1")["count"] == 1
        teng.retire_adapter("t1")
        assert family.value(phase="prefill", adapter="t1")["count"] == 0
        assert teng.stats["adapter_load_errors"] == 1
    finally:
        teng.stop()
