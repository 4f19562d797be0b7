"""Device-trace capture and step timing — the port's copy of
``mlrun_tpu/utils/profiler.py`` on ``torch.profiler``.

``profile_run`` captures a trace (CPU ops and, on a card, CUPTI's
device-kernel events) around a block into the run's artifact path;
``arm_profile`` / ``tick`` let a live trainer or engine be captured for
the next N steps or seconds WITHOUT a restart: the hot loops (the
engines' scheduler loop, ``Trainer.fit``) tick, and the first one to tick
claims the armed capture. ``StepTimer`` feeds per-step wall time into the
``mlt_train_step_seconds`` gauge.

Traces are written by ``torch.profiler.tensorboard_trace_handler``: one
``<worker>.<ts>.pt.trace.json`` per capture under
``<artifact_path>/traces/<key>``, readable by TensorBoard's profiler
plugin, Perfetto or ``chrome://tracing``. The port's CUDA kernels are
launched through ctypes, not the torch dispatcher: they appear as device
kernel events under their ``__global__`` names, not as ``aten::`` ops.

Thread rule: a torch.profiler session must be stopped on the thread that
started it (a stop from another thread crashes the process), yet the
on-demand capture is stopped from other threads (a disarm, an orphan
rescue). So every start and stop runs on one daemon thread of this module
(``_TRACE_THREAD``), and the session records the CPU ops of every thread
(``profile_all_threads``, where the installed torch has it; without it
the device events are still process-wide, and only the CPU ops of the
hot loop's thread are missing).
"""

from __future__ import annotations

import contextlib
import os
import queue
import tempfile
import threading
import time
from typing import Optional

from ..obs import memory_sample  # noqa: F401  (re-exported)
from ..obs.tracing import new_span_id, new_trace_id
from ..obs.tracing import tracer as _TRACER
from .helpers import now_iso
from .logger import logger


class _TraceThread:
    """One daemon thread that runs every torch.profiler start and stop, so
    a session is always stopped on the thread that started it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._jobs: Optional[queue.SimpleQueue] = None

    def _serve(self):
        while True:
            self._jobs.get()()

    def run(self, fn):
        with self._lock:
            if self._jobs is None:
                self._jobs = queue.SimpleQueue()
                threading.Thread(target=self._serve, name="mlt-profiler",
                                 daemon=True).start()
        done = threading.Event()
        box: dict = {}

        def job():
            try:
                box["value"] = fn()
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                box["error"] = exc
            finally:
                done.set()

        self._jobs.put(job)
        done.wait()
        if "error" in box:
            raise box["error"]
        return box.get("value")


_TRACE_THREAD = _TraceThread()
# the open torch.profiler session: {"prof": profile, "device": int|None}
_session: dict = {}


def _profile_kwargs() -> dict:
    """``experimental_config`` recording every thread's CPU ops, where the
    installed torch knows ``profile_all_threads``."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def _start_trace(output_dir: str):
    """Start a torch.profiler session writing into ``output_dir`` (CPU and,
    with a card, CUDA activities). Raises when a session is already open."""
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    # the caller's card (the current device is per thread): synchronized
    # before the stop so the trace holds every kernel launched inside it
    device = (torch.cuda.current_device()
              if torch.cuda.is_available() and torch.cuda.is_initialized()
              else None)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    def start():
        if _session:
            raise RuntimeError("a trace capture is already running")
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(output_dir),
                       **_profile_kwargs())
        prof.start()
        _session.update(prof=prof, device=device)

    _TRACE_THREAD.run(start)


def _stop_trace():
    """Stop the open session (after draining the caller's card) and write
    its trace file."""
    def stop():
        if not _session:
            raise RuntimeError("no trace capture is running")
        prof, device = _session.pop("prof"), _session.pop("device")
        if device is not None:
            import torch

            torch.cuda.synchronize(device)
        prof.stop()

    _TRACE_THREAD.run(stop)


def _resolve_trace_dir(context, key: str, output_dir: str = "") -> str:
    return output_dir or os.path.join(
        (context.artifact_path if context is not None
         else tempfile.gettempdir()), "traces", key)


def _register_trace(context, key: str, output_dir: str, elapsed: float):
    """Best-effort trace finalization: log line, capture wall time on the
    run's metrics, artifact registration. Never raises — this runs on
    unwind paths where the block's own exception must win."""
    logger.info("device trace captured", dir=output_dir,
                wall_s=round(elapsed, 3))
    if context is None:
        return
    try:
        if hasattr(context, "log_metrics"):
            context.log_metrics({"xla_trace_wall_s": round(elapsed, 6)})
        elif hasattr(context, "log_result"):
            context.log_result("xla_trace_wall_s", round(elapsed, 6))
    except Exception as exc:  # noqa: BLE001
        logger.warning("failed to record trace wall time", error=str(exc))
    try:
        context.log_artifact(
            key, target_path=output_dir, upload=False,
            labels={"viewer": "tensorboard"})
    except Exception as exc:  # noqa: BLE001
        logger.warning("failed to register trace artifact", error=str(exc))


@contextlib.contextmanager
def profile_run(context=None, key: str = "xla-trace", output_dir: str = ""):
    """Capture a trace around a code block and register it as a run
    artifact (TensorBoard-readable). A stop failure on the way out never
    masks an exception raised by the profiled block; the capture wall time
    lands on the run's metrics (``xla_trace_wall_s``, the reference's
    name)."""
    output_dir = _resolve_trace_dir(context, key, output_dir)
    os.makedirs(output_dir, exist_ok=True)
    _start_trace(output_dir)
    started = time.perf_counter()
    try:
        yield output_dir
    finally:
        elapsed = time.perf_counter() - started
        try:
            _stop_trace()
        except Exception as exc:  # noqa: BLE001 - a failing stop must not
            # mask the profiled block's own exception
            logger.warning("profiler stop failed", error=str(exc))
        _register_trace(context, key, output_dir, elapsed)


# -- on-demand profiling ------------------------------------------------------
# One capture at a time, process-wide: arm_profile() stages a request; the
# FIRST instrumented hot loop (Trainer.fit step, engine scheduler tick) to
# call tick() claims it, starts the trace, and stops it after the requested
# step count or wall seconds. The dark-path cost in the hot loops is one
# module-global None check.
_profile_lock = threading.Lock()
_armed: Optional[dict] = None
_active: Optional[dict] = None
_last_profile: Optional[dict] = None

# a capture whose claiming loop stopped ticking (fit returned, engine
# stopped) would otherwise hold the profiler open forever — ANY other
# source's tick past this silence rescues it by forcing the stop
ORPHAN_TICK_TIMEOUT_S = 60.0


def arm_profile(steps: int = 0, seconds: float = 0.0,
                output_dir: str = "", key: str = "xla-trace") -> dict:
    """Arm a device-trace capture for the next ticking hot loop. At least
    one bound is required (``steps`` of the claiming loop, or wall
    ``seconds``); with both, whichever hits first stops the trace.
    Re-arming replaces a pending (unclaimed) request; an ACTIVE capture is
    never interrupted — callers get its status instead."""
    global _armed

    steps = int(steps)
    seconds = float(seconds)
    if steps <= 0 and seconds <= 0:
        raise ValueError("arm_profile needs steps > 0 and/or seconds > 0")
    spec = {"steps": steps, "seconds": seconds,
            "output_dir": str(output_dir or ""), "key": str(key),
            "armed_at": now_iso()}
    with _profile_lock:
        if _active is not None:
            return {"armed": False, "active": True,
                    "capture": dict(_active["public"])}
        _armed = spec
    _flight("profile.armed", steps=steps, seconds=seconds, key=key)
    return {"armed": True, **spec}


def disarm_profile(stop_active: bool = False) -> bool:
    """Drop a pending (unclaimed) arm request; with ``stop_active`` also
    stop a running capture (the operator remedy for a capture whose
    claiming loop went away). Returns whether anything was pending or
    stopped."""
    global _armed
    finished = None
    with _profile_lock:
        pending = _armed is not None
        _armed = None
        if stop_active and _active is not None \
                and not _active.get("stopping"):
            _active["stopping"] = True
            finished = _active
    if finished is not None:
        _finalize_capture(finished, None, reason="disarmed")
        return True
    return pending


def profile_status() -> dict:
    """Armed / active / last-capture view."""
    with _profile_lock:
        return {
            "armed": dict(_armed) if _armed is not None else None,
            "active": dict(_active["public"]) if _active is not None
            else None,
            "last": dict(_last_profile) if _last_profile is not None
            else None,
        }


def tick(source: str = "", context=None) -> Optional[str]:
    """Hot-loop hook: claim a pending arm request (starting the trace) or
    count down the active capture this ``source`` owns. Returns
    ``"started"`` / ``"active"`` / ``"stopped"`` for the owning loop,
    ``None`` otherwise. Dark-path cost: one global check."""
    if _armed is None and _active is None:
        return None
    return _tick_slow(source, context)


def _tick_slow(source: str, context) -> Optional[str]:
    global _armed, _active, _last_profile

    finished = None
    outcome = None
    with _profile_lock:
        if _active is None:
            spec = _armed
            if spec is None:
                return None
            _armed = None
            try:
                # dir resolution INSIDE the guard: a duck-typed context
                # without artifact_path must not break the hot loop
                output_dir = _resolve_trace_dir(context, spec["key"],
                                                spec["output_dir"])
                os.makedirs(output_dir, exist_ok=True)
                _start_trace(output_dir)
            except Exception as exc:  # noqa: BLE001 - a failed start must
                # not break the hot loop that happened to tick first
                logger.warning("on-demand profile start failed",
                               error=str(exc))
                _last_profile = {"error": str(exc), "at": now_iso()}
                return None
            now = time.perf_counter()
            _active = {
                "spec": spec,
                "source": source,
                "dir": output_dir,
                "started": now,
                "last_tick": now,
                "steps_left": spec["steps"],
                "deadline": (now + spec["seconds"])
                if spec["seconds"] > 0 else None,
                "public": {"source": source, "dir": output_dir,
                           "steps": spec["steps"],
                           "seconds": spec["seconds"],
                           "started_at": now_iso()},
            }
            outcome = "started"
        else:
            active = _active
            if active.get("stopping"):
                # mid-stop the capture stays claimed so a racing arm+claim
                # cannot start a trace over the closing one
                return None
            now = time.perf_counter()
            if source != active["source"]:
                # another loop's ticks must not count down this capture —
                # UNLESS the claiming loop stopped ticking entirely: then
                # any live loop rescues the orphan
                if now - active["last_tick"] <= ORPHAN_TICK_TIMEOUT_S:
                    return None
                active["stopping"] = True
                finished = active
                outcome = "stopped"
            else:
                active["last_tick"] = now
                if active["steps_left"] > 0:
                    active["steps_left"] -= 1
                done = (active["spec"]["steps"] > 0
                        and active["steps_left"] <= 0) or (
                    active["deadline"] is not None
                    and now >= active["deadline"])
                if not done:
                    return "active"
                active["stopping"] = True
                finished = active
                outcome = "stopped"
    if outcome == "started":
        _flight("profile.start", source=source,
                dir=_active["dir"] if _active else "")
        return outcome
    _finalize_capture(finished, context,
                      reason="bound" if source == finished["source"]
                      else "orphaned")
    return outcome


def _finalize_capture(finished: dict, context, reason: str):
    """Stop the trace and publish the result — OUTSIDE the profile lock
    (the stop writes the trace file); the claim is released only after
    the stop completes so a racing arm+claim can never double-start."""
    global _active, _last_profile

    elapsed = time.perf_counter() - finished["started"]
    try:
        _stop_trace()
    except Exception as exc:  # noqa: BLE001
        logger.warning("on-demand profile stop failed", error=str(exc))
    _register_trace(context, finished["spec"]["key"], finished["dir"],
                    elapsed)
    result = {"dir": finished["dir"], "wall_s": round(elapsed, 6),
              "source": finished["source"], "reason": reason,
              "finished_at": now_iso()}
    with _profile_lock:
        _last_profile = result
        if _active is finished:  # release the claim only now
            _active = None
    _flight("profile.stop", source=finished["source"], dir=finished["dir"],
            wall_s=round(elapsed, 6), reason=reason)


def _flight(kind: str, **data):
    try:
        from ..obs import flight_record

        flight_record(kind, **data)
    except Exception:  # noqa: BLE001 - telemetry only
        pass


@contextlib.contextmanager
def _named_range(name: str):
    """A ``torch.profiler.record_function`` range, plus an NVTX range once
    CUDA is up: the body ``annotate`` and ``phase`` share."""
    import torch

    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            try:
                torch.cuda.nvtx.range_push(name)
            except Exception:  # noqa: BLE001 - a torch without NVTX
                nvtx = False
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the trace (``torch.profiler.record_function``, plus
    an NVTX range once CUDA is up). When a request span is active on this
    thread the trace id is stamped into the region name
    (``<name>|trace=<id16>``), so a device trace joins the span timeline
    of the request that dispatched the compute."""
    try:
        from ..obs import get_tracer

        current = get_tracer().current()
        if current is not None:
            name = f"{name}|trace={current.trace_id[:16]}"
    except Exception:  # noqa: BLE001 - annotation is best-effort telemetry
        pass
    with _named_range(name):
        yield


# -- step phases ----------------------------------------------------------------
# ``phase(name)`` marks one phase of the training step. Off (no
# torch.profiler session records and the process tracer's ``phases`` switch
# is off) it costs one check and yields None. On, it opens a
# ``mlt.<name>`` range on the profiler's clock, records a CUDA event pair
# on the current stream (once CUDA is up) with perf_counter_ns stamps, and
# at exit emits a finished span into the process tracer whose
# ``device_ms`` (and ``gap_ms``) are read from the events later, when the
# events have completed: never a synchronise.
PHASE_PREFIX = "mlt."
# the step's own phases; a step with each of them is complete
STEP_PHASES = ("train.forward", "train.backward", "train.optimizer")
# torch.cuda.memory_stats counters whose change over a step train.step
# carries
ALLOCATOR_COUNTERS = ("num_alloc_retries", "num_device_alloc",
                      "num_device_free", "num_sync_all_streams")
_OFF = contextlib.nullcontext()
# the open phases of every thread, innermost last: a phase opened on a
# thread with none open (autograd's worker running a checkpoint's
# recompute) takes the innermost of any thread as its parent
_OPEN: list = []
_WALL_OFFSET_S = time.time() - time.perf_counter()
_autograd_profiler = None


def _import_autograd_profiler():
    """``torch.autograd.profiler``, imported at the first phase: its
    ``_is_profiler_enabled`` is torch's process-wide flag that a profiler
    session records, set on whatever thread started it."""
    global _autograd_profiler
    import torch.autograd.profiler as autograd_profiler

    _autograd_profiler = autograd_profiler
    return autograd_profiler


class _Phase:
    """An open phase: the handle ``phase`` yields. ``attrs`` may gain
    entries before the block ends; ``end_event`` is what a later phase's
    ``follows`` measures its gap from."""

    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "thread", "in_backward", "start_event", "end_event",
                 "prev_end")

    def __init__(self, name: str, trace_id, follows, attrs: dict):
        self.name, self.attrs = name, attrs
        self.thread = threading.get_ident()
        opened = list(_OPEN)
        parent = next((p for p in reversed(opened)
                       if p.thread == self.thread),
                      opened[-1] if opened else None)
        self.in_backward = parent is not None and (
            parent.in_backward or parent.name == "train.backward")
        if self.in_backward:
            attrs["recompute"] = True
        if parent is not None and "step" not in attrs \
                and "step" in parent.attrs:
            attrs["step"] = parent.attrs["step"]
        attrs["thread"] = threading.current_thread().name
        self.parent_id = parent.span_id if parent is not None else None
        self.trace_id = trace_id or (parent.trace_id if parent is not None
                                     else new_trace_id())
        self.span_id = new_span_id()
        self.prev_end = follows.end_event if follows is not None else None
        self.start_event = self.end_event = None

    def resolver(self):
        """``resolve(span)`` for the tracer: fills ``device_ms`` (and
        ``gap_ms``: the device's time from the followed phase's end to
        this one's start) once the end event has completed."""
        start, end, prev = self.start_event, self.end_event, self.prev_end
        if end is None:
            return None

        def resolve(span) -> bool:
            if not end.query():
                return False
            span.attrs["device_ms"] = start.elapsed_time(end)
            if prev is not None:
                span.attrs["gap_ms"] = prev.elapsed_time(start)
            return True

        return resolve


def phase(name: str, trace_id: str | None = None, follows=None, **attrs):
    """A phase of the training step, as a context manager.

    Capture is on while a torch.profiler session records (the
    benchmark's traced run, an ``arm_profile`` capture, ``profile_run``)
    or while the process tracer's switch is on
    (``obs.get_tracer().configure(phases=True)``); otherwise this is one
    check and the block gets None. On, the block gets the open phase
    (``attrs`` may gain entries before it ends) and the phase shows as:

    - a ``mlt.<name>`` range in the profile (Perfetto / TensorBoard's
      trace viewer: beside the kernels it launched, on the same clock;
      autograd's worker thread shows its own ranges, inside
      ``mlt.train.backward``'s time) and an NVTX range;
    - a span ``<name>`` in the process tracer's ring (and JSONL file)
      with the fit's trace id, the enclosing phase as ``parent_id``
      (on a thread with none open, the innermost open phase of any
      thread), and attrs ``step`` (inherited from the parent unless
      given), ``thread``, ``host_ns`` [start, end] (perf_counter_ns),
      ``recompute`` True inside ``train.backward`` (a checkpoint's
      recompute), and on a card ``device_ms`` between a CUDA event pair
      on the current stream, plus ``gap_ms`` from ``follows`` (an earlier
      phase's handle) to this one. Its status is ``error`` where the
      block raised, ``stopped`` where a recompute ended early inside it.
      Device times are read when the events have completed (at a later
      emit, or ``Tracer.spans()`` / ``settle()``); the JSONL line waits
      for them.

    The spans ``Trainer.fit`` and the models emit: ``train.step`` (attrs
    ``gap_ms`` and the allocator counters' change, ``ALLOCATOR_COUNTERS``)
    over ``train.forward``, ``train.backward`` and ``train.optimizer``;
    ``train.data_wait``, ``train.h2d``, ``train.callbacks`` and
    ``train.metric_flush`` between steps; in an MoE layer
    ``moe.attention``, ``moe.route``, ``moe.dispatch``, ``moe.experts``,
    ``moe.combine``, and the loss head ``moe.head``."""
    if not (_TRACER.phases or (_autograd_profiler
                               or _import_autograd_profiler()
                               )._is_profiler_enabled):
        return _OFF
    return _phase(name, trace_id, follows, attrs)


@contextlib.contextmanager
def _phase(name: str, trace_id, follows, attrs: dict):
    import torch

    handle = _Phase(name, trace_id, follows, attrs)
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    status = "ok"
    _OPEN.append(handle)
    # the host stamps bracket the range (a session's first range takes a
    # millisecond or more to open, after its own start stamp)
    t0 = time.perf_counter_ns()
    try:
        with _named_range(PHASE_PREFIX + name):
            if cuda:
                handle.start_event = torch.cuda.Event(enable_timing=True)
                handle.start_event.record()
            try:
                yield handle
            finally:
                if cuda:
                    handle.end_event = torch.cuda.Event(enable_timing=True)
                    handle.end_event.record()
    except BaseException as exc:
        # a checkpoint's recompute ends early by raising through the
        # phases still open: no failure, but the phase was cut short
        status = ("stopped" if type(exc).__name__ == "_StopRecomputationError"
                  else "error")
        raise
    finally:
        t1 = time.perf_counter_ns()
        _OPEN.remove(handle)
        attrs["host_ns"] = [t0, t1]
        _TRACER.emit(name, handle.trace_id, handle.parent_id,
                     start=t0 / 1e9 + _WALL_OFFSET_S,
                     end=t1 / 1e9 + _WALL_OFFSET_S, status=status,
                     attrs=attrs, span_id=handle.span_id,
                     resolve=handle.resolver())


def allocator_counts(device=None) -> dict:
    """The ``ALLOCATOR_COUNTERS`` the installed torch's
    ``torch.cuda.memory_stats`` has (a host read of the allocator's
    counters; no synchronise)."""
    import torch

    stats = torch.cuda.memory_stats(device)
    return {key: stats[key] for key in ALLOCATOR_COUNTERS if key in stats}


def step_phases(spans, since: float, until: float) -> list[dict]:
    """The complete steps among ``spans`` (a tracer's) whose phases lie
    in [since, until] (perf_counter seconds): one dict a step, in step
    order, with ``step``, ``trace_id``, ``host_ns`` (its ``train.step``
    span's), ``step_ms`` (that span's device ms), ``gap_ms`` (None when
    not measured), ``ms`` {span name: summed device ms of its spans
    outside a recompute} and ``recompute_ms`` (the same inside one). A
    step is complete when its ``train.step`` span and each of
    ``STEP_PHASES`` lie in the window with device times read."""
    lo, hi = since * 1e9, until * 1e9
    groups: dict = {}
    for span in spans:
        host = span.attrs.get("host_ns")
        if host is None or "step" not in span.attrs \
                or not lo <= host[0] <= host[1] <= hi:
            continue
        groups.setdefault((span.trace_id, span.attrs["step"]),
                          []).append(span)
    out = []
    for (trace_id, step), members in groups.items():
        steps = [s for s in members if s.name == "train.step"]
        ms: dict = {}
        recompute: dict = {}
        for span in members:
            if span.attrs.get("device_ms") is None:
                continue
            into = recompute if span.attrs.get("recompute") else ms
            into[span.name] = into.get(span.name, 0.0) \
                + span.attrs["device_ms"]
        if len(steps) != 1 or "train.step" not in ms \
                or any(name not in ms for name in STEP_PHASES):
            continue
        out.append({"step": step, "trace_id": trace_id,
                    "host_ns": steps[0].attrs["host_ns"],
                    "step_ms": ms["train.step"],
                    "gap_ms": steps[0].attrs.get("gap_ms"),
                    "ms": ms, "recompute_ms": recompute})
    return sorted(out, key=lambda s: s["host_ns"][0])


class StepTimer:
    """Rolling per-step wall-time stats for trainer/serving loops.
    ``name`` keys the ``mlt_train_step_seconds`` gauge."""

    def __init__(self, window: int = 100, name: str = "step"):
        self.window = window
        self.name = name
        self._times: list[float] = []
        self._last: Optional[float] = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self) -> float:
        if self._last is None:
            return 0.0
        elapsed = time.perf_counter() - self._last
        self._times.append(elapsed)
        if len(self._times) > self.window:
            del self._times[: len(self._times) - self.window]
        self._last = None
        try:
            from ..obs import TRAIN_STEP_TIME

            TRAIN_STEP_TIME.set(elapsed, timer=self.name)
        except Exception:  # noqa: BLE001 - telemetry must not break a step
            pass
        return elapsed

    @contextlib.contextmanager
    def measure(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> dict:
        if not self._times:
            return {}
        from ..obs.stats import nearest_rank

        ordered = sorted(self._times)
        n = len(ordered)
        return {
            "step_time_mean_s": sum(ordered) / n,
            "step_time_p50_s": nearest_rank(ordered, 0.50),
            "step_time_p95_s": nearest_rank(ordered, 0.95),
            "steps_measured": n,
        }


def memory_report() -> dict:
    """Device + host memory snapshot: per initialised CUDA device the
    caching allocator's in-use, peak, reserved and peak-reserved bytes
    (``torch.cuda.memory_stats``) and the card's total as the limit; the
    host's VmRSS / VmHWM."""
    out: dict = {}
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for index in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(index)
                _, total = torch.cuda.mem_get_info(index)
                out[f"cuda:{index}"] = {
                    "bytes_in_use": stats.get("allocated_bytes.all.current"),
                    "peak_bytes_in_use": stats.get(
                        "allocated_bytes.all.peak"),
                    "bytes_limit": total,
                    "bytes_reserved": stats.get("reserved_bytes.all.current"),
                    "peak_bytes_reserved": stats.get(
                        "reserved_bytes.all.peak"),
                }
    except Exception as exc:  # noqa: BLE001
        out["error"] = str(exc)
    try:
        with open("/proc/self/status") as fp:
            for line in fp:
                if line.startswith(("VmRSS", "VmHWM")):
                    key, _, value = line.partition(":")
                    out[f"host_{key.lower()}"] = value.strip()
    except OSError:
        pass
    return out
