"""The training step's phases (mlrun_tpu_torch.utils.profiler.phase) and
the trainer's flight-recorder events, on the CPU.

A tiny MoE model (with checkpointed layers) trained through
``Trainer.fit`` under a CPU ``torch.profiler`` shows ``mlt.train.step``
over ``mlt.train.forward`` / ``backward`` / ``optimizer``, the
``mlt.moe.*`` ranges inside the forward and again (the recompute) inside
the backward; the process tracer's ring holds the matching spans with
their parents and ``step``. With no profiler and the tracer's switch off,
``phase()`` makes no range, no CUDA event and no span. The benchmark's
five phase readers (``perfbench/metrics``) are held to a synthetic run
and ring. ``train.step``, ``train.preempt`` and ``train.exception`` land
in the flight recorder as the reference records them.

The one test marked ``cuda`` checks, on a card, that device times
resolve positive and that each span's ``host_ns`` start sits on the
profiler's clock within 1 ms of its ``mlt.*`` range.
"""

import importlib.util
import json
import sys
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mlrun_tpu_torch.models import moe as tmoe
from mlrun_tpu_torch.obs import get_flight_recorder, tracing
from mlrun_tpu_torch.training import data as tdata
from mlrun_tpu_torch.training import train as ttrain
from mlrun_tpu_torch.utils import profiler as tprof

METRICS = Path(__file__).resolve().parents[1] / "perfbench" / "metrics"
STEP_CHILDREN = {"train.forward", "train.backward", "train.optimizer"}
MOE = ("moe.attention", "moe.route", "moe.dispatch", "moe.experts",
       "moe.combine")


@pytest.fixture
def ring():
    """The process tracer, emptied, its switch off before and after."""
    tracer = tracing.get_tracer()
    tracer.configure(phases=False)
    tracer.clear()
    yield tracer
    tracer.configure(phases=False)
    tracer.clear()


def _trainer(device="cpu", **overrides):
    cfg = tmoe.tiny_moe(remat=True, dtype=torch.float32, **overrides)
    trainer = ttrain.Trainer(cfg, ttrain.TrainConfig(
        loss_chunk=16, warmup_steps=1, total_steps=10), device=device)
    trainer.init(seed=0)
    return trainer


def _stream(seed=1):
    return tdata.synthetic_token_stream(2, 32, 512, seed=seed)


def _phase_spans(tracer):
    return [s for s in tracer.spans() if "host_ns" in s.attrs]


def _host_ranges(prof) -> list:
    """The ``mlt.*`` ranges on the host's timeline (on a card each is
    mirrored on the device's as an annotation)."""
    return [event for event in prof.events()
            if event.name.startswith(tprof.PHASE_PREFIX)
            and event.device_type != torch.autograd.DeviceType.CUDA]


def _ranges(prof) -> dict:
    out: dict = {}
    for event in _host_ranges(prof):
        out.setdefault(event.name[len(tprof.PHASE_PREFIX):], []).append(
            (event.time_range.start, event.time_range.end))
    return out


def _inside(inner, outers) -> bool:
    return any(start <= inner[0] and inner[1] <= end
               for start, end in outers)


def test_fit_under_a_profiler_nests_the_phase_ranges(ring):
    trainer = _trainer()
    stream = _stream()
    trainer.fit(stream, 1, prefetch=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.fit(stream, 2, prefetch=0, log_every=1)
    ranges = _ranges(prof)
    assert len(ranges["train.step"]) == 2
    for name in STEP_CHILDREN:
        assert len(ranges[name]) == 2
        assert all(_inside(r, ranges["train.step"]) for r in ranges[name])
    layers = trainer.model_config.n_layers
    for name in MOE:
        found = ranges[name]
        in_forward = [r for r in found if _inside(r, ranges["train.forward"])]
        in_backward = [r for r in found
                       if _inside(r, ranges["train.backward"])]
        # once in the forward, once more in the checkpoint's recompute
        assert len(in_forward) == len(in_backward) == 2 * layers
        assert len(found) == 4 * layers
    assert all(_inside(r, ranges["train.forward"])
               for r in ranges["moe.head"])
    for name in ("train.data_wait", "train.h2d", "train.metric_flush"):
        assert ranges[name]


def test_the_ring_holds_the_phases_with_parents_and_steps(ring):
    trainer = _trainer()
    stream = _stream()
    trainer.fit(stream, 1, prefetch=0)
    first = trainer.state.step
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.fit(stream, 2, prefetch=0)
    spans = _phase_spans(ring)
    by_id = {s.span_id: s for s in spans}
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.attrs["step"] for s in steps] == [first, first + 1]
    assert len({s.trace_id for s in spans}) == 1
    layers = trainer.model_config.n_layers
    for step in steps:
        children = [s for s in spans if s.parent_id == step.span_id]
        assert {s.name for s in children} == STEP_CHILDREN
        assert step.parent_id is None
        for child in children:
            assert child.attrs["step"] == step.attrs["step"]
            assert step.attrs["host_ns"][0] <= child.attrs["host_ns"][0] \
                <= child.attrs["host_ns"][1] <= step.attrs["host_ns"][1]
            assert "recompute" not in child.attrs
            inner = [s for s in spans if s.parent_id == child.span_id]
            if child.name == "train.optimizer":
                assert inner == []
                continue
            moe = [s for s in inner if s.name in MOE]
            assert sorted(s.name for s in moe) == sorted(MOE * layers)
            assert all(s.attrs["step"] == step.attrs["step"] for s in inner)
            recompute = child.name == "train.backward"
            assert all(s.attrs.get("recompute", False) is recompute
                       for s in inner)
            # the recompute stops once it has rebuilt every tensor the
            # backward saved: inside each layer's combine
            assert sorted(s.name for s in inner if s.status != "ok") == (
                ["moe.combine"] * layers if recompute else [])
            assert all(s.status == "stopped" for s in inner
                       if s.status != "ok")
            assert ("moe.head" in {s.name for s in inner}) is not recompute
    for name in ("train.data_wait", "train.h2d"):
        assert [s.attrs["step"] for s in spans if s.name == name] == \
            [first, first + 1]
    assert all(by_id.get(s.parent_id, s) is not None for s in spans)
    # no CUDA here: no device time is claimed
    assert not any("device_ms" in s.attrs for s in spans)


def test_no_profiler_and_the_switch_off_record_nothing(ring, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("phase capture while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert tprof.phase("train.step", step=1) is tprof.phase("moe.route")
    with tprof.phase("train.step", step=1) as handle:
        assert handle is None
    trainer = _trainer()
    trainer.fit(_stream(), 2, prefetch=0, log_every=1)
    assert ring.spans() == []


def test_the_tracer_switch_captures_without_a_profiler(ring, tmp_path):
    path = tmp_path / "spans.jsonl"
    ring.configure(phases=True, path=str(path))
    try:
        trainer = _trainer()
        trainer.fit(_stream(), 2, prefetch=0, log_every=1)
    finally:
        ring.configure(path="")
    names = [s.name for s in _phase_spans(ring)]
    assert names.count("train.step") == 2
    assert names.count("train.forward") == names.count("train.backward") \
        == names.count("train.optimizer") == 2
    written = [json.loads(line)["name"] for line in path.read_text().split(
        "\n") if line]
    assert sorted(written) == sorted(names)


def test_phases_on_many_threads_keep_their_own_parents(ring):
    """Threads opening nested phases at once under a short switch
    interval: each inner span's parent is its own thread's outer one, and
    no phase stays open."""
    ring.configure(phases=True)

    def work():
        for step in range(50):
            with tprof.phase("train.step", step=step):
                with tprof.phase("train.forward"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        assert not any(thread.is_alive() for thread in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = _phase_spans(ring)
    assert len(spans) == 16 * 50 * 2 and tprof._OPEN == []
    by_id = {s.span_id: s for s in spans}
    for span in spans:
        if span.name == "train.forward":
            parent = by_id[span.parent_id]
            assert parent.name == "train.step"
            assert parent.attrs["thread"] == span.attrs["thread"]
            assert parent.attrs["step"] == span.attrs["step"]


def test_a_pending_span_is_written_once_resolved(tmp_path):
    path = tmp_path / "spans.jsonl"
    tracer = tracing.Tracer(path=str(path))
    ready = {"done": False}

    def resolve(span):
        if ready["done"]:
            span.attrs["device_ms"] = 2.5
        return ready["done"]

    tracer.emit("train.step", "t" * 32, attrs={"step": 1}, resolve=resolve)
    tracer.emit("llm.decode", "t" * 32)
    assert [s.name for s in tracer.spans()] == ["train.step", "llm.decode"]
    assert [json.loads(x)["name"] for x in path.read_text().splitlines()] \
        == ["llm.decode"]
    assert tracer.settle() == 1
    ready["done"] = True
    assert tracer.spans()[0].attrs["device_ms"] == 2.5
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["name"] for x in lines] == ["llm.decode", "train.step"]
    assert lines[1]["attrs"]["device_ms"] == 2.5
    assert tracer.settle() == 0


# -- the benchmark's readers ---------------------------------------------------

def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"phase_reader_{name.replace('.', '_')}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _emit(tracer, name, step, at_s, ms, trace="a" * 32, **attrs):
    start = int(at_s * 1e9)
    attrs.update(step=step, host_ns=[start, start + int(ms * 1e6)],
                 device_ms=ms)
    tracer.emit(name, trace, attrs=attrs)


def _synthetic_ring(tracer):
    """Steps 1-6 of one fit, a second apart, in a window [100, 200]:
    step 1 before the window, step 6 ending past it, step 5 without its
    optimizer; steps 2-4 complete, step 2 without a gap."""
    for step in range(1, 7):
        at = 97.0 + step * 20.0 if step < 6 else 199.9
        if step == 1:
            at = 50.0
        gap = {} if step == 2 else {"gap_ms": 1.0 * step}
        _emit(tracer, "train.step", step, at, 500.0, **gap)
        _emit(tracer, "train.forward", step, at + 0.001, 10.0 * step)
        _emit(tracer, "train.backward", step, at + 0.05, 100.0 + step)
        if step != 5:
            _emit(tracer, "train.optimizer", step, at + 0.3, 50.0 + step)
        for layer in range(2):
            for name in ("moe.route", "moe.dispatch", "moe.combine",
                         "moe.experts"):
                _emit(tracer, name, step, at + 0.002 + layer * 0.001,
                      float(step))
                _emit(tracer, name, step, at + 0.06 + layer * 0.001,
                      1000.0, recompute=True)
        _emit(tracer, "train.data_wait", step, at - 0.01, 0.5)


@pytest.mark.parametrize("name,want", [
    ("forward_ms.train", 30.0),      # steps 2, 3, 4: 20, 30, 40
    ("backward_ms.train", 103.0),
    ("optimizer_ms.train", 53.0),
    # 2 layers x 3 spans x the step's ms; the experts and the recompute
    # spans left out
    ("moe_dispatch_ms.train", 18.0),
    ("step_gap_ms.train", 3.5),      # steps 3, 4 (step 2 has none)
])
def test_phase_readers_keep_the_complete_steps_in_the_window(ring, name,
                                                             want):
    run = {"kind": "train", "t0": 100.0, "t1": 200.0}
    read = _reader(name)
    assert read(run) is None
    _synthetic_ring(ring)
    assert read(run) == pytest.approx(want)
    assert read({**run, "t0": 300.0, "t1": 400.0}) is None
    assert read({**run, "kind": "serve"}) is None


def test_step_phases_groups_by_trace_and_step(ring):
    _synthetic_ring(ring)
    _emit(ring, "train.step", 3, 150.0, 1.0, trace="b" * 32)
    steps = tprof.step_phases(ring.spans(), 100.0, 200.0)
    assert [s["step"] for s in steps] == [2, 3, 4]
    assert steps[1]["ms"]["moe.route"] == 6.0
    assert steps[1]["recompute_ms"]["moe.route"] == 2000.0
    assert steps[0]["gap_ms"] is None and steps[1]["gap_ms"] == 3.0
    assert steps[2]["step_ms"] == 500.0


# -- the flight recorder ---------------------------------------------------------

@pytest.fixture
def flight():
    recorder = get_flight_recorder()
    recorder.clear()
    yield recorder
    recorder.clear()


def test_fit_records_train_step_at_log_points(flight):
    trainer = _trainer()
    trainer.fit(_stream(), 5, prefetch=0, log_every=2)
    events = flight.events("train.step")
    assert [e["step"] for e in events] == [2, 4, 5]
    assert all(0.0 <= e["goodput_fraction"] <= 1.0 for e in events)


def test_fit_records_train_preempt_before_its_checkpoint(flight):
    class Guard:
        def agreed(self, device):
            return True

    class Manager:
        directory = "unused"

        def save(self, step, state, force=False):
            self.seen = [e["kind"] for e in flight.events("train.*")]

        def wait(self):
            pass

    trainer = _trainer()
    trainer.fit(_stream(), 1, prefetch=0)
    manager = Manager()
    out = trainer.fit(_stream(), 3, prefetch=0, preemption_guard=Guard(),
                      checkpoint_manager=manager)
    assert out["preempted"] is True
    assert manager.seen[-1] == "train.preempt"
    assert flight.events("train.preempt")[-1]["step"] == 1


def test_fit_records_train_exception_and_dumps(flight, tmp_path):
    def failing():
        yield next(_stream(seed=2))
        raise ValueError("the feed broke")

    flight.configure(directory=str(tmp_path))
    try:
        trainer = _trainer()
        with pytest.raises(ValueError, match="the feed broke"):
            trainer.fit(failing(), 3, prefetch=0)
    finally:
        flight.configure(directory="")
    event = flight.events("train.exception")[-1]
    assert event["error"] == "the feed broke"
    assert event["error_type"] == "ValueError"
    dumps = list(tmp_path.glob("flight-train-crash-*.jsonl"))
    assert len(dumps) == 1
    header = json.loads(dumps[0].read_text().splitlines()[0])
    assert header["reason"] == "train-crash"
    assert header["error"] == "the feed broke"


# -- on the card -------------------------------------------------------------------

@pytest.mark.cuda
def test_device_times_resolve_on_the_profilers_clock(ring):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device times come from CUDA "
                    "events")
    trainer = _trainer(device="cuda", attention_impl="reference")
    stream = _stream()
    trainer.fit(stream, 1, prefetch=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.fit(stream, 3, prefetch=0)
        torch.cuda.synchronize()
    offset_ns = time.time_ns() - time.perf_counter_ns()
    spans = _phase_spans(ring)
    steps = [s for s in spans if s.name == "train.step"]
    assert len(steps) == 3
    assert all(s.attrs["device_ms"] >= 0 for s in spans)
    # the phases that launch kernels take device time
    assert all(s.attrs["device_ms"] > 0 for s in spans
               if s.name in STEP_CHILDREN | {"train.step", *MOE})
    assert all(s.attrs["gap_ms"] >= 0 for s in steps[1:])
    assert tprof.step_phases(spans, 0.0, time.perf_counter())
    results = prof.profiler.kineto_results
    trace_start_ns = (results.trace_start_ns()
                      if hasattr(results, "trace_start_ns")
                      else results.trace_start_us() * 1000)
    starts: dict = {}
    for event in _host_ranges(prof):
        starts.setdefault(event.name[len(tprof.PHASE_PREFIX):], []).append(
            trace_start_ns + event.time_range.start * 1e3)
    for span in spans:
        host = span.attrs["host_ns"][0] + offset_ns
        nearest = min(abs(at - host) for at in starts[span.name])
        assert nearest < 1e6, (span.name, nearest)
    # the checkpoints' recompute runs on autograd's worker thread, inside
    # the backward
    backward = [s.attrs["host_ns"] for s in spans
                if s.name == "train.backward"]
    recompute = [s for s in spans if s.attrs.get("recompute")]
    assert recompute
    assert all(s.attrs["thread"] != "MainThread" for s in recompute)
    assert all(any(b[0] <= s.attrs["host_ns"][0] <= s.attrs["host_ns"][1]
                   <= b[1] for b in backward) for s in recompute)
    for name in ("train.forward", "moe.route"):
        assert len(starts[name]) == len([s for s in spans
                                         if s.name == name])
