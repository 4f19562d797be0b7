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
from datetime import datetime, timezone
from typing import Optional

from ..obs import memory_sample  # noqa: F401  (re-exported)
from .logger import logger


def now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


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
def annotate(name: str):
    """Named region in the trace (``torch.profiler.record_function``, plus
    an NVTX range once CUDA is up). When a request span is active on this
    thread the trace id is stamped into the region name
    (``<name>|trace=<id16>``), so a device trace joins the span timeline
    of the request that dispatched the compute."""
    import torch

    try:
        from ..obs import get_tracer

        current = get_tracer().current()
        if current is not None:
            name = f"{name}|trace={current.trace_id[:16]}"
    except Exception:  # noqa: BLE001 - annotation is best-effort telemetry
        pass
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
