"""The port's on-demand profiler (mlrun_tpu_torch.utils.profiler) against
mlrun_tpu.utils.profiler on the CPU: the same scripted tick sequences —
two sources, a steps bound, a seconds bound, an orphan rescue and a
disarm of an active capture — give the same outcomes and the same
``profile_status`` shapes, with each package's trace start/stop replaced
by a recorder and a fake clock driving both. Then the real capture: a
session claimed on one thread and stopped from another (a torch.profiler
session crashes when stopped off its own thread; the port runs every
start and stop on one thread of its own) leaves the profiler able to
start again, and a tiny ``Trainer.fit`` and a tiny paged engine, each
armed, leave a trace file and a ``last`` status.

Bounds: outcomes, status keys, sources, reasons and directories equal.
"""

import glob
import json
import os
import threading
import types

import jax
import numpy as np
import pytest
import torch

from mlrun_tpu.utils import profiler as jprof
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.serving import paged as tpaged
from mlrun_tpu_torch.training import data as tdata
from mlrun_tpu_torch.training import train as ttrain
from mlrun_tpu_torch.utils import profiler as tprof

ORPHAN_S = 5.0


def _reset(mod):
    with mod._profile_lock:
        mod._armed = mod._active = mod._last_profile = None


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (jprof, tprof):
        _reset(mod)
    yield
    for mod in (jprof, tprof):
        _reset(mod)


class _Clock:
    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now


def _fake(mod, monkeypatch, calls):
    """Record the package's trace start/stop and drive its clock."""
    clock = _Clock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter))
    monkeypatch.setattr(mod, "ORPHAN_TICK_TIMEOUT_S", ORPHAN_S)
    if mod is jprof:
        monkeypatch.setattr(jax.profiler, "start_trace",
                            lambda d: calls.append(("start", d)))
        monkeypatch.setattr(jax.profiler, "stop_trace",
                            lambda: calls.append(("stop",)))
    else:
        monkeypatch.setattr(mod, "_start_trace",
                            lambda d: calls.append(("start", d)))
        monkeypatch.setattr(mod, "_stop_trace",
                            lambda: calls.append(("stop",)))
    return clock


def _shape(status: dict) -> dict:
    """The status with its timestamps and wall times dropped."""
    out = {}
    for key, value in status.items():
        if value is None:
            out[key] = None
            continue
        out[key] = {k: v for k, v in value.items()
                    if k not in ("armed_at", "started_at", "finished_at",
                                 "wall_s", "at")}
        out[key]["_keys"] = sorted(value)
    return out


def _script(mod, clock, root) -> list:
    trace = []

    def note(*outcomes):
        trace.append((outcomes, _shape(mod.profile_status())))

    with pytest.raises(ValueError):
        mod.arm_profile()
    note(mod.tick("trainer"))                      # dark
    mod.arm_profile(steps=2, output_dir=f"{root}/steps")
    note(mod.tick("trainer"))                      # claims
    note(mod.tick("engine-7"), mod.tick("trainer"))  # other source; count
    refused = mod.arm_profile(seconds=3.0)         # active: refused
    note(refused["armed"], refused["active"])
    note(mod.tick("trainer"))                      # stopped on steps
    mod.arm_profile(seconds=3.0, output_dir=f"{root}/secs")
    note(mod.tick("engine-7"))
    clock.now += 1.0
    note(mod.tick("engine-7"))                     # before the deadline
    clock.now += 2.5
    note(mod.tick("engine-7"))                     # past it: stopped
    mod.arm_profile(steps=100, output_dir=f"{root}/orphan")
    note(mod.disarm_profile(), mod.tick("x"))      # pending dropped
    mod.arm_profile(steps=100, output_dir=f"{root}/orphan")
    note(mod.tick("dead-loop"), mod.tick("live-loop"))
    clock.now += ORPHAN_S + 1
    note(mod.tick("live-loop"))                    # orphan rescued
    mod.arm_profile(steps=100, output_dir=f"{root}/dis")
    note(mod.tick("wedged"))
    note(mod.disarm_profile(stop_active=True), mod.disarm_profile())
    mod.arm_profile(steps=1, seconds=50.0, output_dir=f"{root}/both")
    note(mod.tick("a"), mod.tick("a"))             # steps hit first
    return trace


def test_scripted_ticks_match_the_reference(monkeypatch, tmp_path):
    runs, calls = [], []
    for mod in (jprof, tprof):
        calls.append([])
        clock = _fake(mod, monkeypatch, calls[-1])
        runs.append(_script(mod, clock, str(tmp_path)))
    assert runs[1] == runs[0]
    assert calls[1] == calls[0]
    assert [c[0] for c in calls[1]].count("start") == 5
    last = runs[1][-1][1]["last"]
    assert last["reason"] == "bound" and last["source"] == "a"


def test_profile_run_stop_failure_does_not_mask_block_error(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(tprof, "_start_trace", lambda d: None)

    def broken_stop():
        raise RuntimeError("profiler backend wedged")

    monkeypatch.setattr(tprof, "_stop_trace", broken_stop)
    ctx = _Ctx(tmp_path)
    with pytest.raises(ValueError, match="the real bug"):
        with tprof.profile_run(context=ctx):
            raise ValueError("the real bug")
    assert "xla_trace_wall_s" in ctx.metrics
    assert ctx.artifacts == ["xla-trace"]


class _Ctx:
    def __init__(self, root):
        self.artifact_path = str(root)
        self.metrics, self.artifacts = {}, []

    def log_metrics(self, metrics, step=None):
        self.metrics.update(metrics)

    def log_artifact(self, key, **kwargs):
        self.artifacts.append(key)


def _trace_events(directory) -> list:
    files = glob.glob(os.path.join(directory, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as fp:
        return json.load(fp)["traceEvents"]


def test_cross_thread_stop_leaves_the_profiler_startable(tmp_path):
    """Armed here, claimed on a worker thread, stopped from a third: the
    trace is written, and a second capture starts and stops."""
    tprof.arm_profile(steps=50, output_dir=str(tmp_path / "a"))
    out = {}

    def worker():
        out["claim"] = tprof.tick("loop")
        x = torch.randn(32, 32)
        torch.mm(x, x)

    for target in (worker, lambda: out.setdefault(
            "stop", tprof.disarm_profile(stop_active=True))):
        thread = threading.Thread(target=target)
        thread.start()
        thread.join()
    assert out == {"claim": "started", "stop": True}
    assert tprof.profile_status()["last"]["reason"] == "disarmed"
    names = {e.get("name") for e in _trace_events(tmp_path / "a")}
    assert "aten::mm" in names
    with tprof.profile_run(output_dir=str(tmp_path / "b")):
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
    assert _trace_events(tmp_path / "b")


def test_armed_trainer_fit_leaves_a_trace(tmp_path):
    trainer = ttrain.Trainer(tllama.tiny_llama(dtype=torch.float32),
                             ttrain.TrainConfig(), device="cpu")
    trainer.init(0)
    ctx = _Ctx(tmp_path)
    tprof.arm_profile(steps=2)
    trainer.fit(tdata.synthetic_token_stream(2, 16, 512, seed=1), steps=4,
                context=ctx, log_every=4)
    last = tprof.profile_status()["last"]
    assert last["source"] == trainer._profiler_source
    assert last["reason"] == "bound"
    assert last["dir"] == str(tmp_path / "traces" / "xla-trace")
    assert _trace_events(last["dir"])
    assert "xla_trace_wall_s" in ctx.metrics
    assert "xla-trace" in ctx.artifacts


def test_armed_paged_engine_leaves_a_trace(tmp_path):
    cfg = tllama.tiny_llama(dtype=torch.float32)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    engine = tpaged.PagedContinuousBatchingEngine(
        cfg, params, max_len=64, slots=2, page_size=16,
        prefill_buckets=(16,), device="cpu")
    engine.start()
    try:
        tprof.arm_profile(steps=3, output_dir=str(tmp_path / "eng"))
        tokens, _ = engine.generate(
            np.arange(1, 9).tolist(), max_new_tokens=4)
        for _ in range(500):
            if tprof.profile_status()["last"] is not None:
                break
            threading.Event().wait(0.01)
    finally:
        engine.stop()
    assert len(tokens) == 4
    last = tprof.profile_status()["last"]
    assert last["source"] == engine._obs_name and last["reason"] == "bound"
    assert _trace_events(tmp_path / "eng")


def test_annotate_step_timer_and_memory_report(tmp_path):
    """A region under an active request span carries its trace id."""
    from mlrun_tpu_torch.obs import get_tracer

    tracer = get_tracer()
    span = tracer.start_span("req", activate=True)
    try:
        with tprof.profile_run(output_dir=str(tmp_path)):
            with tprof.annotate("region"):
                torch.ones(2).sum()
    finally:
        tracer.end_span(span)
    names = {e.get("name") for e in _trace_events(tmp_path)}
    assert f"region|trace={span.trace_id[:16]}" in names
    timer = tprof.StepTimer(window=200, name="t-port")
    timer._times = [float(v) for v in range(1, 101)]
    summary = timer.summary()
    assert summary["step_time_p95_s"] == 95.0
    assert summary["step_time_p50_s"] == 50.0
    assert "host_vmrss" in tprof.memory_report()
    assert tprof.memory_sample()["host_rss_bytes"] > 0
