"""mlrun_tpu_torch's continuous-tuning loop (model_monitoring/) against
mlrun_tpu's on the CPU: the drift detectors (PSI, KL, Hellinger, TVD and
the two histogram sketches) on the same numpy arrays, the per-adapter
``AdapterTrafficMonitor`` fed the same samples, the ``monitor.drift``
chaos box, the fake-clock closed loop on both packages' tiny paged engines
with converted weights in both directions (drift → local-launcher LoRA
retrain run → canary hash split → promote, with greedy tokens after
promotion equal to the reference's; a degraded canary → rollback with its
ordered post-mortem), the canary identity and split cases, the restart
cases of tests/test_control_recovery.py with a journal that either
package writes replayed in the other, and an adapter ``.npz`` that either
package's ``save_adapter`` writes loaded in the other.

Contracts: tests/test_continuous_tuning.py and
tests/test_control_recovery.py (the mid-canary and mid-retrain restarts).
Tolerances: the detectors agree to 1e-12 (the same float64 numpy
arithmetic); the monitor's stats exactly; the loop's actions and journal
records exactly once the run uids are masked; tokens exactly (every
compared stream has a top-2 logit margin above 1e-3).
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlrun_tpu
from mlrun_tpu import obs as jobs
from mlrun_tpu.chaos import FaultPoints as JFaultPoints
from mlrun_tpu.chaos import chaos as jchaos
from mlrun_tpu.common.journal import IntentJournal as JJournal
from mlrun_tpu.model_monitoring import controller as jctl
from mlrun_tpu.model_monitoring import metrics as jmetrics
from mlrun_tpu.model_monitoring import stream_processing as jsp
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.models import lora as jlora
from mlrun_tpu.serving import adapters as jadapters
from mlrun_tpu.serving import canary as jcanary
from mlrun_tpu.serving import paged as jpaged
from mlrun_tpu.serving import samples as jsamples
from mlrun_tpu.serving.podfleet import controller_crash as jcrash
from mlrun_tpu_torch import db as tdb
from mlrun_tpu_torch import obs as tobs
from mlrun_tpu_torch.chaos import FaultPoints as TFaultPoints
from mlrun_tpu_torch.chaos import chaos as tchaos
from mlrun_tpu_torch.common.journal import IntentJournal as TJournal
from mlrun_tpu_torch.datastore import store_manager as tstore_manager
from mlrun_tpu_torch.model_monitoring import controller as tctl
from mlrun_tpu_torch.model_monitoring import metrics as tmetrics
from mlrun_tpu_torch.model_monitoring import stream_processing as tsp
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models import lora as tlora
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.serving import adapters as tadapters
from mlrun_tpu_torch.serving import canary as tcanary
from mlrun_tpu_torch.serving import paged as tpaged
from mlrun_tpu_torch.serving import samples as tsamples
from mlrun_tpu_torch.serving.podfleet import controller_crash as tcrash
from tests.torch_registries import registries_left_as_found  # noqa: F401

PROMPT = [1, 7, 3, 9, 2, 4, 6, 8]
CANARY_SEED = 42
UID = re.compile(r"[0-9a-f]{32}")

# one namespace per package: what a scenario reaches of it
JAX = dict(name="jax", ctl=jctl, sp=jsp, metrics=jmetrics, chaos=jchaos,
           points=JFaultPoints, journal=JJournal, canary=jcanary,
           samples=jsamples, adapters=jadapters, obs=jobs, crash=jcrash)
PORT = dict(name="port", ctl=tctl, sp=tsp, metrics=tmetrics, chaos=tchaos,
            points=TFaultPoints, journal=TJournal, canary=tcanary,
            samples=tsamples, adapters=tadapters, obs=tobs, crash=tcrash)
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """The port's db, store manager, chaos, process slots and flight ring
    start empty (the shared conftest resets the reference's db and
    chaos)."""
    tdb.set_run_db(None)
    tstore_manager._db = None
    tchaos.clear()
    tobs.get_flight_recorder().clear()
    jobs.get_flight_recorder().clear()
    yield
    tchaos.clear()
    for pkg in PKGS:
        pkg["canary"].set_canary_router(None)
        pkg["samples"].set_sample_observer(None)
    tdb.set_run_db(None)
    tstore_manager._db = None


# -- drift detectors -----------------------------------------------------------

def _hist_pairs():
    rng = np.random.default_rng(0)
    same = np.array([10, 20, 30, 40])
    return [
        (same, same), (same, same * 3), (np.array([40, 30, 20, 10]), same),
        (np.array([1, 0, 0, 0]), np.array([0, 0, 0, 1])),
        (np.zeros(5), np.arange(5)),
        (rng.integers(0, 50, 32), rng.integers(0, 50, 32)),
    ]


@pytest.mark.parametrize("fn", ["psi", "kl_divergence", "hellinger_distance",
                                "total_variance_distance"])
def test_detectors_match_reference(fn):
    """Each detector gives the reference's value on the same histograms;
    the contract's bands hold (PSI scale-invariant, finite on disjoint
    support, over 0.2 for the reversed histogram)."""
    for p, q in _hist_pairs():
        want = getattr(jmetrics, fn)(p, q)
        got = getattr(tmetrics, fn)(p, q)
        assert np.isfinite(got)
        assert abs(got - want) <= 1e-12, (fn, p, q)
    same = np.array([10, 20, 30, 40])
    assert tmetrics.psi(same, same) < 1e-9
    assert tmetrics.psi(same, same * 3) < 1e-9
    assert tmetrics.psi(np.array([40, 30, 20, 10]), same) > 0.2
    assert tmetrics.kl_divergence(same, same, symmetric=False) == \
        jmetrics.kl_divergence(same, same, symmetric=False)


def test_fixed_histogram_matches_reference():
    """tests/test_continuous_tuning.py's bounds and clipping case, on both
    sketches, with equal counts after every step."""
    hists = [m.FixedHistogram(0.0, 10.0, bins=5) for m in (jmetrics, tmetrics)]
    for h in hists:
        h.update([0, 1.9, 2, 5, 9.9, -3, 42, float("nan")])
    assert hists[1].total == 7 and list(hists[1].counts) == \
        list(hists[0].counts) == [3, 1, 1, 0, 2]
    for h, m in zip(hists, (jmetrics, tmetrics)):
        other = m.FixedHistogram(0.0, 10.0, bins=5)
        other.update([5])
        h.merge(other)
        with pytest.raises(ValueError):
            h.merge(m.FixedHistogram(0.0, 10.0, bins=6))
        with pytest.raises(ValueError):
            m.FixedHistogram(3.0, 3.0)
    assert hists[1].total == 8
    assert list(hists[1].snapshot()) == list(hists[0].snapshot())
    hists[1].reset()
    assert hists[1].total == 0 and hists[1].counts.sum() == 0


def test_streaming_histogram_and_feature_drift_match_reference():
    """The range-locking sketch, its dict round trip, drift against raw
    reference values, and per-feature drift over two frames."""
    import pandas as pd

    rng = np.random.default_rng(1)
    values = rng.normal(0.0, 1.0, 5000)
    ref = rng.normal(0.0, 1.0, 3000)
    shifted = rng.normal(3.0, 1.0, 3000)
    out = []
    for m in (jmetrics, tmetrics):
        hist = m.StreamingHistogram(bins=20, warmup=1000)
        for chunk in np.array_split(values, 13):
            hist.update(chunk)
        partial = m.StreamingHistogram(bins=20, warmup=10_000)
        partial.update(values[:50])
        back = m.StreamingHistogram.from_dict(partial.to_dict())
        assert back.edges is None and back._buffer == partial._buffer
        h_shift = m.StreamingHistogram(bins=20, warmup=500)
        h_shift.update(shifted)
        frame_ref = pd.DataFrame({"f0": ref, "f1": ref * 2, "label": "x"})
        frame_cur = pd.DataFrame({"f0": shifted, "f1": ref * 2})
        out.append((hist.to_dict(), m.drift_between_histograms(h_shift, ref),
                    m.drift_per_feature(frame_cur, frame_ref, bins=20)))
    assert out[1][0] == out[0][0]
    for k in ("tvd", "hellinger", "kld"):
        assert abs(out[1][1][k] - out[0][1][k]) <= 1e-12
    assert out[1][1]["tvd"] > 0.5
    assert set(out[1][2]) == set(out[0][2]) == {"f0", "f1"}
    for col in ("f0", "f1"):
        for k in ("tvd", "hellinger", "kld"):
            assert abs(out[1][2][col][k] - out[0][2][col][k]) <= 1e-12


def _samples():
    """A reference lock, a same-distribution window, a window shifted in
    tokens and lengths, then a window still filling, for two adapters and
    base traffic, with random margins and TTFTs."""
    rng = np.random.default_rng(2)
    out = []
    for phase, tokens in enumerate([[1, 2, 3], [1, 2, 3],
                                    list(range(50, 59)), [1, 2, 3]]):
        for _ in range(4 if phase < 3 else 2):
            for adapter in ("t1", "t2@v1", ""):
                out.append({"adapter": adapter, "tokens": tokens,
                            "generated": len(tokens),
                            "ttft_s": float(rng.uniform(0.01, 0.02)),
                            "logit_margin": float(rng.uniform(0.5, 2.0))})
        out.append(None)   # an evaluation point
    return out


def test_traffic_monitor_stats_and_verdicts_match_reference():
    """The same sample stream into both monitors: the same stats and the
    same verdicts at every evaluation (None while filling, False on a
    same-distribution window, True on the shifted one, None after the
    verdict consumed the window), and the adapter cap drops alike."""
    results = []
    for m in (jsp, tsp):
        monitor = m.AdapterTrafficMonitor(
            vocab_size=64, reference_min=4, window_min=4, psi_threshold=0.2,
            max_adapters=3, max_output_len=16)
        evals = []
        now = 0.0
        for sample in _samples():
            if sample is None:
                now += 1.0
                evals.append({a: monitor.evaluate(a, now)
                              for a in monitor.adapters()})
            else:
                monitor.observe(sample)
        monitor.observe({"adapter": "t9", "tokens": [1]})
        evals.append((monitor.adapters(), monitor.dropped_adapters))
        monitor.rebase("t1")
        evals.append(monitor.evaluate("t1", now + 1))
        results.append(evals)
    assert results[1] == results[0]
    verdicts = [e["t1"][1] for e in results[1][:4]]
    assert verdicts == [None, False, True, None]
    assert results[1][4] == (["", "t1", "t2@v1"], 1)
    assert results[1][5] == ({"sample_count": 0.0}, None)


@pytest.mark.chaos
def test_monitor_drift_chaos_box_like_reference():
    """The ``monitor.drift`` box makes drift injectable in both packages:
    the action sees the same context and its edits come back."""
    seen = []
    for pkg in PKGS:
        monitor = pkg["sp"].AdapterTrafficMonitor(
            vocab_size=64, reference_min=2, window_min=2)

        def action(point, ctx):
            seen.append((point, ctx["adapter"], ctx["now"],
                         dict(ctx["box"]["stats"])))
            ctx["box"]["drifted"] = True
            ctx["box"]["stats"]["quality_mean"] = 0.123

        with pkg["chaos"].inject(pkg["points"].monitor_drift, action=action):
            armed = monitor.evaluate("t9", 0.0)
        assert armed == ({"sample_count": 0.0, "quality_mean": 0.123}, True)
        assert monitor.evaluate("t9", 1.0) == ({"sample_count": 0.0}, None)
    assert seen[1] == seen[0] == ("monitor.drift", "t9", 0.0,
                                  {"sample_count": 0.0})
    assert TFaultPoints.monitor_drift in TFaultPoints.all()


# -- the closed loop -----------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    jads = {name: jlora.init_lora_nonzero(jcfg, jax.random.PRNGKey(seed),
                                          rank=4, alpha=8.0)
            for name, seed in (("stable", 1), ("canary", CANARY_SEED))}
    nads = {name: jax.tree.map(np.asarray, tree)
            for name, tree in jads.items()}
    return (jcfg, jparams, tcfg,
            params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
            nads)


def _engine(pkg, setup, tenant):
    jcfg, jparams, tcfg, tparams, nads = setup
    kw = dict(max_len=64, slots=2, prefill_buckets=(16,), page_size=8)
    if pkg is JAX:
        return jpaged.PagedContinuousBatchingEngine(
            jcfg, jparams, adapters={tenant: nads["stable"]}, **kw)
    return tpaged.PagedContinuousBatchingEngine(
        tcfg, tparams, adapters={tenant: params_from_numpy(nads["stable"],
                                                           "cpu")},
        device="cpu", **kw)


def _tune_handler(pkg, lora):
    """The fine-tune job the loop submits through each package's local
    launcher: writes the 'retrained' adapter (the same numpy factors for
    both packages) with that package's ``save_adapter``."""
    def tune(context, tenant="", output_path="", **kwargs):
        pkg["adapters"].save_adapter(output_path, lora)
        context.log_result("adapter", output_path)
    tune.__name__ = "tune"
    return tune


def _drive(engine, tenant, n=6):
    for i in range(n):
        engine.generate(PROMPT[:4 + (i % 4)] + [i % 5], max_new_tokens=4,
                        adapter=tenant, request_key=f"k{i}")


def _quality_injection(pkg, tenant, stable_q, canary_q):
    def action(point, ctx):
        box = ctx["box"]
        if ctx["adapter"] == tenant:
            box["drifted"] = True
            box["stats"]["quality_mean"] = stable_q
        elif ctx["adapter"].startswith(tenant + "@"):
            box["stats"]["quality_mean"] = canary_q
    return pkg["chaos"].inject(pkg["points"].monitor_drift, action=action)


def _mask(value):
    """Run uids masked (drawn per run); flight-dump paths reduced to their
    folder's presence (each package dumps into its own directory)."""
    if isinstance(value, dict):
        return {k: ("<dump>" if k == "post_mortem" and v else _mask(v))
                for k, v in value.items()}
    if isinstance(value, list):
        return [_mask(v) for v in value]
    if isinstance(value, str):
        return UID.sub("<uid>", value)
    return value


def _run_loop(pkg, setup, tmp_path, tenant, stable_q, canary_q, stop_on):
    """One package's closed loop on a fake clock: its own run db, journal
    and flight dump directory; returns the actions, the journal records,
    the engine's greedy stream for ``tenant`` afterwards and the final
    router state."""
    _, _, _, _, nads = setup
    home = tmp_path / pkg["name"]
    home.mkdir()
    if pkg is PORT:
        tdb.set_run_db(tdb.SQLiteRunDB(str(home / "runs.sqlite")))
    recorder = pkg["obs"].get_flight_recorder()
    recorder.configure(directory=str(home / "flight"))
    journal = pkg["journal"](str(home / "canary.jsonl"))
    engine = _engine(pkg, setup, tenant)
    engine.start()
    controller = pkg["ctl"].ContinuousTuningController(
        engine, project="ct", retrain_kind="local",
        retrain_handler=_tune_handler(pkg, nads["canary"]), confirm_ticks=2,
        cooldown_s=120.0, fraction=0.5, warmup_s=0.0, fast_window_s=30.0,
        slow_window_s=60.0, ttft_target_s=10.0, promote_ticks=2,
        rollback_ticks=2, reference_min=4, window_min=4, vocab_size=256,
        journal=journal).start()
    injection = _quality_injection(pkg, tenant, stable_q, canary_q)
    actions = []
    try:
        now = 0.0
        _drive(engine, tenant, 8)
        for _ in range(12):
            now += 10.0
            _drive(engine, tenant, 6)
            out = controller.tick(now)
            actions += out["actions"]
            if any(a["action"] == stop_on for a in actions):
                break
        injection.remove()
        tokens = engine.generate(PROMPT, max_new_tokens=4, adapter=tenant)[0]
        state = {"stable": controller.router.stable_id(tenant),
                 "split": controller.router.split(tenant),
                 "resident": sorted(engine._adapters.resident_names()),
                 "sources": sorted(engine._adapters.sources),
                 "series": sorted({s["labels"].get("adapter", "")
                                   for s in controller.store.series()}),
                 "runs": [r["status"]["state"] for r in (
                     mlrun_tpu if pkg is JAX else tdb).get_run_db()
                     .list_runs(project="ct")]}
        flight = [e for e in recorder.events() if e.get("adapter") == tenant]
    finally:
        injection.remove()
        controller.stop()
        engine.stop()
        recorder.configure(directory="")
        journal.close()
    records = [json.loads(line) for line in open(home / "canary.jsonl")]
    return (_mask(actions), _mask(records), tokens, state,
            [e["kind"] for e in flight], actions)


@pytest.mark.chaos
def test_closed_loop_promotes_like_reference(setup, tmp_path):
    """Injected drift → ONE local-launcher retrain run → canary hash split →
    sustained-better promotion, in both packages: the same actions and
    journal records; the promoted tenant's greedy tokens equal the
    reference's, which are the merged retrained adapter's."""
    got = [_run_loop(pkg, setup, tmp_path, "tp", 0.5, 0.9, "promote")
           for pkg in PKGS]
    (j_actions, j_records, j_tokens, j_state, j_kinds, _), \
        (t_actions, t_records, t_tokens, t_state, t_kinds, _) = got
    assert [a["action"] for a in t_actions] == \
        ["retrain", "canary_start", "promote"]
    assert t_actions == j_actions
    assert t_records == j_records
    assert [r["op"] for r in t_records] == ["retrain", "canary", "promote"]
    assert t_state == j_state == {
        "stable": "tp@v1", "split": None, "resident": ["tp@v1"],
        "sources": ["tp", "tp@v1"], "series": t_state["series"],
        "runs": ["completed"]}
    assert "tp" not in t_state["series"]
    assert t_kinds == j_kinds
    assert 'mlt_drift_stat{adapter="tp"' not in tobs.REGISTRY.render()
    # greedy tokens after promotion: the reference's, served from the new
    # adapter (an engine on merge_lora of the retrained factors)
    jcfg, jparams, tcfg, tparams, nads = setup
    assert t_tokens == j_tokens
    merged = tlora.merge_lora(tparams, params_from_numpy(nads["canary"],
                                                         "cpu"))
    ref = tpaged.PagedContinuousBatchingEngine(
        tcfg, merged, max_len=64, slots=2, prefill_buckets=(16,),
        page_size=8, device="cpu")
    ref.start()
    try:
        assert ref.generate(PROMPT, max_new_tokens=4)[0] == t_tokens
    finally:
        ref.stop()
    seq = torch.tensor([PROMPT + t_tokens[:-1]])
    logits = tllama.forward(tcfg, merged, seq)[0, len(PROMPT) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3


@pytest.mark.chaos
def test_closed_loop_degraded_canary_rolls_back_like_reference(setup,
                                                                tmp_path):
    """The other direction: the canary's quality degrades past the budget
    in both windows → rollback in both packages with the same actions and
    journal, the split cleared, the canary retired, and a post-mortem
    carrying the causal chain in order."""
    got = [_run_loop(pkg, setup, tmp_path, "tr", 0.9, 0.2, "rollback")
           for pkg in PKGS]
    (j_actions, j_records, j_tokens, j_state, j_kinds, _), \
        (t_actions, t_records, t_tokens, t_state, t_kinds, raw) = got
    assert [a["action"] for a in t_actions] == \
        ["retrain", "canary_start", "rollback"]
    assert t_actions == j_actions
    assert t_records == j_records
    assert t_state == j_state
    assert t_state["stable"] == "tr" and t_state["split"] is None
    assert "tr@v1" not in t_state["sources"]
    assert t_tokens == j_tokens
    path = raw[-1]["post_mortem"]
    assert path.startswith(str(tmp_path / "port" / "flight"))
    lines = [json.loads(line) for line in open(path)]
    header, events = lines[0], lines[1:]
    assert header["flight_dump"] is True and header["canary"] == "tr@v1"
    assert "canary-worse" in header["reason"]
    kinds = [e["kind"] for e in events if e.get("adapter") == "tr"]
    chain = ["monitor.drift_confirmed", "tune.submitted", "tune.completed",
             "canary.start", "canary.decision", "canary.rollback"]
    indices = [kinds.index(k) for k in chain]
    assert indices == sorted(indices), kinds
    decision = next(e for e in events if e.get("kind") == "canary.decision"
                    and e.get("verdict") == "worse")
    assert "canary-quality-tr" in decision["burns"]
    assert t_kinds == j_kinds


# -- canary identity and split -------------------------------------------------

def test_canary_identity_never_shares_prefix_pages(setup):
    """The same prompt under the stable and the canary id builds two radix
    roots with disjoint pages and no prefix hit, in both packages."""
    jcfg, jparams, tcfg, tparams, nads = setup
    prompt = list(range(1, 33))
    kw = dict(max_len=64, slots=2, page_size=8, prefill_buckets=(16,))
    out = []
    for pkg in PKGS:
        if pkg is JAX:
            engine = jpaged.PagedContinuousBatchingEngine(
                jcfg, jparams, adapters={"t1": nads["stable"],
                                         "t1@v1": nads["canary"]}, **kw)
        else:
            engine = tpaged.PagedContinuousBatchingEngine(
                tcfg, tparams, device="cpu", adapters={
                    "t1": params_from_numpy(nads["stable"], "cpu"),
                    "t1@v1": params_from_numpy(nads["canary"], "cpu")}, **kw)
        engine.start()
        try:
            streams = [engine.generate(prompt, max_new_tokens=4,
                                       adapter=a)[0] for a in ("t1", "t1@v1")]
            roots = engine._prefix._roots

            def pages_of(root):
                found, todo = set(), [root]
                while todo:
                    node = todo.pop()
                    for child in node.children.values():
                        found.add(child.page_id)
                        todo.append(child)
                return found

            stable, canary = pages_of(roots["t1"]), pages_of(roots["t1@v1"])
            assert stable and canary and not stable & canary
            out.append((streams, engine.stats["prefix_hits"], len(stable),
                        len(canary)))
        finally:
            engine.stop()
    assert out[1] == out[0]
    assert out[1][1] == 0


def test_split_metering_and_slots_like_reference():
    """Split metering stops after promotion, and an older controller's
    stop() leaves a newer one's sample tap and router installed (both
    packages). The tenant's name is its own: the reference's tests read
    the absolute count of theirs from the shared registry."""
    for pkg in PKGS:
        obs = pkg["obs"]
        base = obs.CANARY_REQUESTS.value(adapter="tmp", side="stable") + \
            obs.CANARY_REQUESTS.value(adapter="tmp", side="canary")
        router = pkg["canary"].CanaryRouter()
        router.set_split("tmp", "tmp@v1", 0.5)
        router.resolve("tmp", "k1", count=True)
        router.promote("tmp")
        router.resolve("tmp", "k1", count=True)
        router.resolve("tmp", "k2", count=True)
        metered = obs.CANARY_REQUESTS.value(adapter="tmp", side="stable") + \
            obs.CANARY_REQUESTS.value(adapter="tmp", side="canary") - base
        assert metered == 1.0
        first = pkg["ctl"].ContinuousTuningController(
            object(), project="ct").start()
        second = pkg["ctl"].ContinuousTuningController(
            object(), project="ct").start()
        first.stop()
        assert pkg["canary"].get_canary_router() is second.router
        assert pkg["samples"].get_sample_observer() is not None
        second.stop()
        assert pkg["canary"].get_canary_router() is None
        assert pkg["samples"].get_sample_observer() is None


@pytest.mark.chaos
def test_adapterless_traffic_never_retrains_like_reference():
    """Base-model traffic (adapter "") is evaluated for telemetry and
    never reaches the drift state machine, in both packages."""
    outs = []
    for pkg in PKGS:
        controller = pkg["ctl"].ContinuousTuningController(
            object(), project="ct", confirm_ticks=1, reference_min=2,
            window_min=2, vocab_size=64).start()
        try:
            for _ in range(8):
                controller.ring.append({"adapter": "", "tokens": [1, 2, 3],
                                        "generated": 3, "ttft_s": 0.01})

            def force(point, ctx):
                ctx["box"]["drifted"] = True

            with pkg["chaos"].inject(pkg["points"].monitor_drift,
                                     action=force):
                ticks = [controller.tick(float(t * 10)) for t in range(3)]
        finally:
            controller.stop()
        assert all(t["actions"] == [] for t in ticks)
        outs.append([t["evaluated"] for t in ticks])
    assert outs[1] == outs[0] and "" in outs[1][-1]


class _FakeServing:
    def __init__(self):
        self.added = []
        self.retired = []

    def add_adapter_source(self, name, source):
        self.added.append(name)

    def retire_adapter(self, name, keep_source=False):
        self.retired.append(name)


def test_canary_ages_out_like_reference(tmp_path):
    """A canary whose windows carry no signal concludes at ``max_age_s``
    with a rollback, in both packages."""
    outs = []
    for pkg in PKGS:
        recorder = pkg["obs"].get_flight_recorder()
        recorder.configure(directory=str(tmp_path / pkg["name"]))
        serving = _FakeServing()
        controller = pkg["ctl"].ContinuousTuningController(
            serving, project="ct", warmup_s=0.0, max_age_s=50.0,
            reference_min=2, window_min=2, vocab_size=64)
        try:
            state = controller._tenants.setdefault(
                "tx", pkg["ctl"]._TenantState())
            state.version = 1
            controller._start_canary(
                "tx", state, {"canary_id": "tx@v1", "output_path": "x"},
                0.0, {"actions": []})
            held = controller.tick(20.0)["actions"]
            aged = controller.tick(60.0)["actions"]
        finally:
            controller.stop()
            recorder.configure(directory="")
        assert held == [] and controller.router.split("tx") is None
        outs.append((_mask(aged), serving.added, serving.retired))
    assert outs[1] == outs[0]
    assert "aged out" in outs[1][0][0]["reason"]


# -- restarts across packages --------------------------------------------------

def _canary_controller(pkg, journal, serving=None, **overrides):
    kwargs = dict(project="ct", warmup_s=0.0, max_age_s=50.0,
                  cooldown_s=120.0, fraction=0.5, reference_min=2,
                  window_min=2, vocab_size=64)
    kwargs.update(overrides)
    return pkg["ctl"].ContinuousTuningController(
        serving or _FakeServing(), journal=journal, **kwargs)


@pytest.mark.chaos
@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_restart_mid_canary_split_hash_identical(writer, reader, tmp_path):
    """A canary split live at a crash, journaled by one package and
    adopted by the other: the same split, the same side for every key,
    the version counter and the START time kept (it still ages out), and
    the adopt chain in the reader's flight ring."""
    path = str(tmp_path / "canary.jsonl")
    c1 = _canary_controller(writer, writer["journal"](path))
    state = c1._tenants.setdefault("tx", writer["ctl"]._TenantState())
    state.version = 3
    c1._start_canary("tx", state,
                     {"canary_id": "tx@v3", "output_path": "path-v3"},
                     10.0, {"actions": []})
    keys = [f"key-{i}" for i in range(64)]
    sides_before = {k: c1.router.resolve("tx", k) for k in keys}
    assert {s for _, s in sides_before.values()} == {"canary", "stable"}
    writer["crash"](drill="mid_canary")
    c1._journal.close()

    serving2 = _FakeServing()
    c2 = _canary_controller(reader, reader["journal"](path),
                            serving=serving2)
    split = c2.router.split("tx")
    assert split.canary == "tx@v3" and split.fraction == 0.5
    assert serving2.added == ["tx@v3"]
    assert c2._tenants["tx"].version == 3
    assert {k: c2.router.resolve("tx", k) for k in keys} == sides_before
    kinds = [e["kind"] for e in reader["obs"].get_flight_recorder().events()]
    chain = ["reconcile.adopt", "reconcile.converged"]
    assert [kinds.index(k) for k in chain] == sorted(
        kinds.index(k) for k in chain)
    out = c2.tick(61.0)
    rollback = [a for a in out["actions"] if a["action"] == "rollback"]
    assert rollback and "aged out" in rollback[0]["reason"]
    assert c2.router.split("tx") is None
    c2._journal.close()


class _RunDB:
    """The run reads an adopted retrain polls (``read_run``)."""

    def __init__(self):
        self.runs = {}

    def read_run(self, uid, project="", iter=0):
        return self.runs.get((uid, project))


@pytest.mark.chaos
@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_restart_mid_retrain_adopts_by_uid_no_double_submit(writer, reader,
                                                            tmp_path):
    """A retrain in flight at a crash, journaled by one package, adopted by
    the other by its uid: polled through the run db, never submitted
    again, and concluded (an unusable artifact) under the cooldown."""
    path = str(tmp_path / "canary.jsonl")
    submits = []

    class _Run:
        class metadata:
            uid = "uid-1"

    def submit_fn(request):
        submits.append(request)
        return _Run()

    db = _RunDB()
    c1 = _canary_controller(writer, writer["journal"](path),
                            submit_fn=submit_fn, db=db)
    state = c1._tenants.setdefault("ty", writer["ctl"]._TenantState())
    c1._submit_retrain("ty", state, {"token_psi": 0.5}, 0.0, {"actions": []})
    assert len(submits) == 1 and state.inflight["uid"] == "uid-1"
    writer["crash"](drill="mid_retrain")
    c1._journal.close()

    db.runs[("uid-1", "ct")] = {"status": {"state": "running"}}
    c2 = _canary_controller(reader, reader["journal"](path),
                            submit_fn=submit_fn, db=db)
    adopted = c2._tenants["ty"].inflight
    assert adopted["uid"] == "uid-1" and adopted["run"] is None
    c2.tick(10.0)
    assert len(submits) == 1 and c2._tenants["ty"].inflight is not None
    db.runs[("uid-1", "ct")] = {"status": {"state": "completed"}}
    c2.tick(20.0)
    assert c2._tenants["ty"].inflight is None
    assert c2._tenants["ty"].last_concluded_at == 20.0
    assert len(submits) == 1
    c2._journal.close()


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_adapter_npz_crosses_packages(writer, reader, setup, tmp_path):
    """An adapter ``.npz`` one package's ``save_adapter`` writes loads in
    the other's ``load_adapter`` with the same factors, bit for bit."""
    _, _, _, _, nads = setup
    lora = nads["canary"]
    if writer is PORT:
        lora = params_from_numpy(lora, "cpu")
    path = str(tmp_path / "a.npz")
    writer["adapters"].save_adapter(path, lora)
    back = reader["adapters"].load_adapter(path)
    assert set(back) == set(nads["canary"])
    for target, factors in nads["canary"].items():
        for key in ("lora_a", "lora_b", "scaling"):
            np.testing.assert_array_equal(
                np.asarray(back[target][key]),
                np.asarray(factors[key], np.float32))


@pytest.mark.parametrize("dbpath", ["", "runs.sqlite"])
def test_cluster_retrain_kind_concludes_failed_like_reference(dbpath,
                                                              tmp_path,
                                                              monkeypatch):
    """A ``tpujob`` retrain submits through the remote launcher: without a
    service url both packages refuse it, and the loop concludes the
    tenant as a failed retrain (cooldown, no in-flight run). With a
    sqlite dbpath both packages' remote launchers reach the sqlite db,
    which refuses ``submit_job`` with the same error."""
    if dbpath:
        from mlrun_tpu.config import mlconf

        monkeypatch.setenv("MLT_DBPATH", str(tmp_path / dbpath))
        mlconf.reload()  # the reference reads its env at load
    errors = []
    for pkg in PKGS:
        controller = pkg["ctl"].ContinuousTuningController(
            object(), project="ct", retrain_kind="tpujob",
            retrain_handler="tune.handler")
        state = controller._tenants.setdefault("tz",
                                               pkg["ctl"]._TenantState())
        out = {"actions": []}
        controller._submit_retrain("tz", state, {"token_psi": 0.5}, 5.0,
                                   out)
        failed = [e for e in pkg["obs"].get_flight_recorder().events()
                  if e["kind"] == "tune.failed" and e["adapter"] == "tz"]
        assert out["actions"] == [] and state.inflight is None
        assert state.last_concluded_at == 5.0 and failed
        errors.append(failed[-1]["error"])
    assert errors[1] == errors[0]
    if dbpath:
        assert "submit_job requires a remote service" in errors[1]
    else:
        assert "remote runtime kinds need the service" in errors[1]
