"""Per-request phase ledger for the serving path — the port's own copy of
``mlrun_tpu/obs/reqledger.py``.

Every engine request carries a phase-transition ledger: entering a phase
closes the previous one at the SAME clock read, so the per-phase seconds
sum to the request wall by construction (the zero-tolerance closure the
reference's tests assert under a fake clock). Phases: ``admission``,
``rate_limit_wait``, ``queue_wait``, ``adapter_load_wait``, ``promote``
(host-KV-tier pages imported at admission), ``prefill`` (first dispatch
to first token; chunked prefill spans every chunk tick), ``handoff``
(prefill-side serialize, decode-side import), ``decode_active`` (a
decode dispatch that advanced the row was running), ``decode_stall``
(the slot held a row while the scheduler did other work), and the fleet's
``redispatch_backoff`` (re-dispatch backoff timers), ``fetch`` (pulling a
moved hot prefix's pages from its previous owner) and ``network`` (the
dispatch/transfer remainder at the fleet boundary), which
``EngineFleet`` attributes out of band (:meth:`RequestLedger.attribute`,
:func:`merge_timing`).

Stdlib only at module level; the one metric family lives here.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from .metrics import REGISTRY

# canonical phase names (anything else folds into "other" at export)
PHASES = ("admission", "rate_limit_wait", "queue_wait",
          "adapter_load_wait", "promote", "prefill", "handoff",
          "decode_active", "decode_stall", "redispatch_backoff",
          "fetch", "network", "other")

REQUEST_PHASE_SECONDS = REGISTRY.histogram(
    "mlt_request_phase_seconds",
    "Per-request wall seconds by ledger phase (admission, "
    "rate_limit_wait, queue_wait, adapter_load_wait, promote, prefill, "
    "handoff, decode_active, decode_stall, redispatch_backoff, fetch, "
    "network, other); "
    "phases sum to the request wall by construction. Bounded adapter "
    "label like the TTFT family (docs/serving.md \"Multi-tenant LoRA\")",
    labels=("phase", "adapter"), max_label_sets=1024, overflow="drop",
    buckets=(0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
             0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0))


def ledger_enabled() -> bool:
    """``SERVING_LLM_DEFAULTS["request_ledger"]`` of the port's config
    (imported lazily: this module stays bottom-layer); True when the
    config is unreadable, so the default path is the instrumented one."""
    try:
        from ..config import SERVING_LLM_DEFAULTS

        return bool(SERVING_LLM_DEFAULTS.get("request_ledger", True))
    except Exception:  # noqa: BLE001 - config must not gate telemetry
        return True


class RequestLedger:
    """One request's phase-transition ledger.

    The owner calls :meth:`enter` at every phase boundary; the elapsed
    clock time since the previous boundary is attributed to the phase
    being LEFT. Because the close of one phase and the open of the next
    share a single clock read, no instant is ever double-counted or
    dropped: ``Σ phase seconds == wall`` exactly (the acceptance
    invariant, fake-clock asserted).

    Ownership moves submit-thread → scheduler-thread → (fleet callback
    threads for :meth:`attribute`); a lock keeps each transition atomic.
    ``clock`` is injectable for deterministic tests.
    """

    __slots__ = ("trace_id", "notes", "_clock", "_t0", "_t_last",
                 "_phase", "_seconds", "_out_of_band", "_closed", "_lock")

    def __init__(self, trace_id: str = "",
                 clock: Callable[[], float] = time.perf_counter,
                 phase: str = "admission"):
        self.trace_id = trace_id
        self.notes: dict = {}      # free-form context (chunks, cached_prefix)
        self._clock = clock
        now = clock()
        self._t0 = now
        self._t_last = now
        self._phase = phase
        self._seconds: dict[str, float] = {}
        self._out_of_band = 0.0    # attribute() seconds (outside the span)
        self._closed = False
        self._lock = threading.Lock()

    # -- phase transitions ---------------------------------------------------
    @property
    def current_phase(self) -> str:
        return self._phase

    def enter(self, phase: str) -> float:
        """Close the current phase at this instant and start ``phase``.
        Returns the seconds attributed to the phase being left."""
        now = self._clock()
        with self._lock:
            if self._closed:
                return 0.0
            elapsed = max(0.0, now - self._t_last)
            if elapsed:
                self._seconds[self._phase] = \
                    self._seconds.get(self._phase, 0.0) + elapsed
            self._t_last = now
            self._phase = phase
        return elapsed

    def attribute(self, phase: str, seconds: float):
        """Add out-of-band seconds to ``phase`` (fleet backoff timers,
        network remainders measured by a caller that owns the outer wall).
        Advances the wall total with them, so attribution still sums to
        wall."""
        seconds = float(seconds)
        if seconds <= 0:
            return
        with self._lock:
            self._seconds[phase] = self._seconds.get(phase, 0.0) + seconds
            self._out_of_band += seconds

    def note(self, key: str, value):
        self.notes[key] = value

    def close(self, final_phase: str | None = None) -> dict:
        """Attribute the trailing open interval (renamed to
        ``final_phase`` when given) and return the timing summary.
        Idempotent — a second close returns the same summary."""
        if not self._closed:
            if final_phase is not None:
                with self._lock:
                    self._phase = final_phase
            self.enter(self._phase)
            with self._lock:
                self._closed = True
        return self.summary()

    # -- views ---------------------------------------------------------------
    def wall_seconds(self) -> float:
        with self._lock:
            span = (self._t_last if self._closed else self._clock()) \
                - self._t0
            return max(0.0, span) + self._out_of_band

    def phases(self) -> dict[str, float]:
        with self._lock:
            return {phase: seconds
                    for phase, seconds in sorted(self._seconds.items())
                    if seconds > 0}

    def summary(self) -> dict:
        """JSON-friendly timing payload (the v2 ``"timing"`` debug field
        and the bench/test view). ``attribution_closed`` is the closure
        invariant check: phases must sum to wall exactly (modulo float
        addition noise)."""
        phases = self.phases()
        wall = self.wall_seconds()
        attributed = sum(phases.values())
        out = {
            "wall_s": wall,
            "phases": phases,
            "attribution_closed": abs(wall - attributed) < 1e-6,
        }
        if self.trace_id:
            out["trace_id"] = self.trace_id
        if self.notes:
            out.update(self.notes)
        return out


def retire_adapter_phases(adapter: str):
    """Drop a retired adapter's per-phase series — the series-lifecycle
    contract the TTFT/ITL families follow: the continuous-tuning loop
    mints new versioned adapter ids over time, and without pruning the
    churn would exhaust the family's label-set cap (past it,
    ``overflow="drop"`` silently stops attributing NEW tenants).
    Idempotent; the ``""`` base series is never retired. Called from
    ``AdapterRegistry.retire`` (the canary promote/rollback path —
    exactly where version churn happens); ``max_label_sets`` + drop
    stays the backstop for adapters never formally retired."""
    if not adapter:
        return
    for phase in PHASES:
        REQUEST_PHASE_SECONDS.remove(phase=phase, adapter=adapter)


def export_phases(timing: dict, adapter: str = ""):
    """Flush one finished request's phase breakdown onto
    ``mlt_request_phase_seconds{phase,adapter}``; the request's trace id
    rides each observation as the histogram exemplar so a latency alert
    can name the culprit trace (docs/observability.md)."""
    trace_id = timing.get("trace_id") or None
    for phase, seconds in (timing.get("phases") or {}).items():
        if phase not in PHASES:
            phase = "other"
        REQUEST_PHASE_SECONDS.observe(seconds, exemplar=trace_id,
                                      phase=phase, adapter=adapter)


def merge_timing(into: dict, other: dict | None) -> dict:
    """Sum another hop's timing phases into ``into`` (the fleet's
    prefill-side + decode-side merge): same-named phases add, notes of the
    later hop win, walls add. Closure is preserved — both inputs sum to
    their walls, so the merge sums to the summed wall."""
    if not other:
        return into
    phases = into.setdefault("phases", {})
    for phase, seconds in (other.get("phases") or {}).items():
        phases[phase] = phases.get(phase, 0.0) + seconds
    into["wall_s"] = into.get("wall_s", 0.0) + other.get("wall_s", 0.0)
    for key, value in other.items():
        if key not in ("phases", "wall_s", "attribution_closed"):
            into.setdefault(key, value)
    return into
