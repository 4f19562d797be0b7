"""A serving cell: the port's paged continuous-batching engine at the
configuration's widths, fed by the traffic plan, timed over the window,
its served tokens judged against the plain reference afterwards.

The window drives ``PagedContinuousBatchingEngine.submit``. The engine is
the port's class with harness-side records around two of its hooks (the
decode tick: host start and end, rows, live positions; the first token of
each request: host time): counters taken from the harness's own file
around the calls into the layer, with nothing changed in what it does.
"""

from __future__ import annotations

import gc
import heapq
import itertools
import threading
import time

import checks
import models
import traffic as traffic_mod


def engine_class():
    from mlrun_tpu_torch.serving.paged import PagedContinuousBatchingEngine

    class BenchEngine(PagedContinuousBatchingEngine):
        """The port's paged engine, with harness records around the decode
        tick and the first token; with ``spans`` the two scheduler steps
        also carry ``perfbench.*`` profiler labels."""

        def bench_init(self, spans: bool):
            self.bench_ticks: list = []      # (start, end, rows, live)
            self.bench_firsts: list = []     # host time of a first token
            self.bench_spans = spans
            # the traced run's profiler and the host times it runs between;
            # started and stopped on this engine's thread, whose ops it
            # then records
            self.bench_profiler = None
            self.bench_profile_at = (0.0, 0.0)

        def _plain_decode_tick(self, active) -> int:
            live = sum(int(self._pos[i]) + 1 for i in active)
            started = time.perf_counter()
            if self.bench_spans:
                from torch.profiler import record_function

                with record_function("perfbench.decode_tick"):
                    done = super()._plain_decode_tick(active)
            else:
                done = super()._plain_decode_tick(active)
            self.bench_ticks.append((started, time.perf_counter(),
                                     len(active), live))
            return done

        def _activate_slot(self, adm):
            self.bench_firsts.append(time.perf_counter())
            super()._activate_slot(adm)

        def _admission_tick(self):
            if not self.bench_spans:
                return super()._admission_tick()
            self._bench_profile()
            from torch.profiler import record_function

            with record_function("perfbench.admission"):
                return super()._admission_tick()

        def _bench_profile(self):
            profiler = self.bench_profiler
            if profiler is None:
                return
            now = time.perf_counter()
            on, off = self.bench_profile_at
            if profiler.t_start is None and on <= now < off:
                profiler.start()
            elif profiler.active and now >= off:
                profiler.stop()

    return BenchEngine


class Window:
    """Sends the plan's requests at their due times from one thread and
    records each one's due, send and completion times and its result."""

    def __init__(self, engine, plan):
        self.engine = engine
        self.plan = plan
        self.records: list = []
        self._heap: list = []
        self._order = itertools.count()
        self._cond = threading.Condition()
        self._finished: list = []
        self.closed_at = None

    def _push(self, due: float, req):
        with self._cond:
            heapq.heappush(self._heap, (due, next(self._order), req))
            self._cond.notify()

    def _done(self, future, rec: dict):
        """On the engine's thread: the completion time and a hand-off,
        nothing more; ``collect`` does the rest on the window's thread."""
        rec["done"] = time.perf_counter()
        with self._cond:
            self._finished.append((future, rec))
            self._cond.notify()

    def collect(self):
        """Fill in the records of the requests completed since the last
        call and, while the window is open, send each session's next
        turn (or each client's next request) a think time after it."""
        with self._cond:
            finished, self._finished = self._finished, []
        for future, rec in finished:
            exc = future.exception()
            if exc is not None:
                rec["ok"] = False
                rec["error"] = f"{type(exc).__name__}: {exc}"
                continue
            tokens, stats = future.result()
            rec.update(ok=True, tokens=list(tokens),
                       generated=int(stats["generated"]),
                       ttft_s=float(stats["ttft_s"]),
                       total_s=float(stats["total_s"]))
            phases = (stats.get("timing") or {}).get("phases") or {}
            rec["queue_wait_s"] = float(phases.get("queue_wait", 0.0))
            nxt = self.plan.next_after(rec["req"])
            if nxt is not None and self.closed_at is None:
                self._push(rec["done"] + rec["req"].then_after_s, nxt)

    def _send(self, due: float, req):
        rec = {"due": due, "req": req, "prompt_len": len(req.prompt),
               "max_new": req.max_new, "ok": None}
        rec["sent"] = time.perf_counter()
        self.records.append(rec)
        future = self.engine.submit(req.prompt, max_new_tokens=req.max_new)
        future.add_done_callback(lambda f, r=rec: self._done(f, r))

    def run(self, t0: float, seconds: float):
        """Send every request due before ``t0 + seconds``."""
        for offset, req in self.plan.first():
            self._push(t0 + offset, req)
        end = t0 + seconds
        while True:
            self.collect()
            now = time.perf_counter()
            if now >= end:
                break
            with self._cond:
                if self._finished:
                    continue
                if self._heap and self._heap[0][0] <= now:
                    due, _, req = heapq.heappop(self._heap)
                else:
                    due = None
                    wake = min(end, self._heap[0][0] if self._heap else end)
                    self._cond.wait(timeout=min(max(0.0, wake - now), 0.05))
            if due is not None:
                self._send(due, req)
        self.closed_at = end

    def drain(self, until: float):
        """Wait until every request sent has completed, or ``until``."""
        while time.perf_counter() < until:
            self.collect()
            if all(r["ok"] is not None for r in self.records):
                return True
            with self._cond:
                if not self._finished:
                    self._cond.wait(timeout=0.05)
        self.collect()
        return all(r["ok"] is not None for r in self.records)


def _engine_snapshot(engine) -> dict:
    stats = engine.stats
    return {key: stats.get(key, 0) for key in
            ("prefix_queries", "prefix_hits")}


def run(cell, seed: int, seconds: float, trace: bool, device,
        started: float, config_overrides=None, check_limit=True,
        fault=None, control=None) -> dict:
    """One run of a serving cell. Returns the run's record: the
    per-request records, the engine's counters at the window's open and
    close, the tick records, the trace summary, the correctness reading
    and the device's memory peak."""
    from devtrace import DeviceTrace

    mix, conf = cell.traffic, cell.config
    marks = [("start", started), ("imported", time.perf_counter())]
    sizes = models.sizes(conf)
    if config_overrides:
        sizes.update(config_overrides)
    model = models.port_config(conf, **(config_overrides or {}))
    params = models.make_params(sizes, seed, device)
    _sync(device)
    marks.append(("weights", time.perf_counter()))
    eng_conf = dict(mix["engine"])
    plan = traffic_mod.plan(mix, seed, sizes["vocab_size"], seconds)
    BenchEngine = engine_class()
    engine = BenchEngine(
        model, params, max_len=eng_conf["max_len"], slots=eng_conf["slots"],
        page_size=eng_conf["page_size"],
        prefix_cache=eng_conf["prefix_cache"], seed=seed,
        latency_window=1 << 20, device=device)
    engine.bench_init(spans=trace)
    if fault is not None:
        fault(engine)
    marks.append(("engine", time.perf_counter()))
    engine.warmup()
    marks.append(("engine_warmup", time.perf_counter()))
    engine.start()
    warm = [engine.submit(r.prompt, max_new_tokens=r.max_new)
            for r in plan.warmup()]
    for future in warm:
        future.result(timeout=600)
    _sync(device)
    marks.append(("warmup_requests", time.perf_counter()))
    window = Window(engine, plan)
    stats0 = _engine_snapshot(engine)
    ring0 = len(engine._tick_ring)
    ticks0 = len(engine.bench_ticks)
    profiler = DeviceTrace() if trace else None
    if profiler is not None:
        profiler.prime()
    t0 = time.perf_counter()
    setup_s = t0 - started
    marks.append(("window", t0))

    if profiler is not None:
        # the traced part: a steady stretch in the window's middle
        on = t0 + 0.4 * seconds
        engine.bench_profile_at = (on, min(on + cell.trace_seconds,
                                           t0 + 0.9 * seconds))
        engine.bench_profiler = profiler
    window.run(t0, seconds)
    t1 = window.closed_at
    stats1 = _engine_snapshot(engine)
    ring = list(engine._tick_ring)[ring0:]
    ticks = list(engine.bench_ticks)[ticks0:]
    firsts = [t for t in engine.bench_firsts if t0 <= t < t1]
    drain_s = float(mix.get("drain_s", 0))
    drained = window.drain(t1 + drain_s) if drain_s else False
    engine.stop()
    window.collect()
    window.engine = None
    peak = _memory_peak(device)
    summary = (profiler.summary() if profiler is not None
               and profiler.t_stop is not None else None)
    records = window.records
    for rec in records:
        rec["in_window"] = t0 <= rec["due"] < t1
        if rec["ok"] and rec["generated"] >= 1:
            rec["first"] = rec["done"] - rec["total_s"] + rec["ttft_s"]
        rec["stopped"] = (not rec["ok"]) and rec.get("error", "").startswith(
            "EngineStoppedError") and not drain_s
    del engine
    gc.collect()
    _empty_cache(device)
    _note_memory(device, "after the window")
    check = checks.serve_check(cell, sizes, params, records, seed,
                               check_limit, control)
    return {
        "kind": "serve", "seed": seed, "setup_s": setup_s,
        "t0": t0, "t1": t1, "window_s": t1 - t0, "drained": drained,
        "requests": records, "stats0": stats0, "stats1": stats1,
        "tick_ring": ring, "ticks": ticks, "firsts": firsts,
        "trace": summary,
        # the traced stretch, and the stretch its start and stop cost
        "trace_span": ((profiler.t_start, profiler.t_stop)
                       if summary else None),
        "trace_cost_span": ((profiler.t_begin, profiler.t_done)
                            if summary else None),
        "sizes": sizes, "engine": eng_conf, "memory_peak_bytes": peak,
        "setup_marks": marks,
        "check": check,
    }


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _memory_peak(device) -> int:
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def _note_memory(device, when: str):
    """What stays allocated once the program's state is gone (a serving
    cell keeps the weights, which the reference reads)."""
    import sys

    import torch

    if torch.device(device).type == "cuda":
        print(f"perfbench: {torch.cuda.memory_allocated()} bytes allocated "
              f"{when}", file=sys.stderr)


def _empty_cache(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
