"""Deterministic, seedable fault-injection registry — the port's own copy
of ``mlrun_tpu/chaos/registry.py`` (same names, schedules and semantics).

Production code calls ``fire(point, **context)`` at named fault points;
tests arm those points with schedules (``fail_nth``/``fail_with_prob``/...)
and effects (raise, delay, callback) scoped by context managers.

- **Zero cost when dark.** ``fire`` is a single attribute check when no
  injection is armed.
- **Deterministic.** ``fail_with_prob`` draws from its own seeded RNG.
- **A registry of its own.** The port's process-wide ``chaos`` is a
  separate object from the reference package's: arming one never arms
  the other.
- **No package imports.** The registry sits below every other layer of
  the port, so it imports none of them (the fire observer is pushed in
  from ``obs``).
"""

from __future__ import annotations

import threading
import time

# observer(point) called whenever an armed injection's effect actually
# fires — pushed in from above (obs wires it to a counter and the flight
# recorder). Kept off the dark path.
_fire_observer = None


def set_fire_observer(observer):
    global _fire_observer
    _fire_observer = observer


class FaultPoints:
    """The named fault points the port's serving graph, engines and engine
    fleet fire (the reference's names). A point is matched exactly or by a
    ``prefix.*`` wildcard at injection time."""

    # serving-graph step execution (states.py TaskStep/RouterStep.run);
    # a delay() here models a slow model step, an error a failing one
    serving_step = "serving.step"
    # remote-step HTTP attempts (serving/remote.py) — an injected
    # connection error / HTTPError exercises the retry classifier and
    # circuit breaker without a live endpoint
    serving_remote = "serving.remote"
    # async queue admission (states.py QueueStep.run)
    serving_queue = "serving.queue"

    # one ring join of a deferred-join fleet replica (serving/fleet.py
    # join_replica) — a delay() models a slow join (keys keep routing to
    # the survivors meanwhile), an error keeps the replica out of the ring
    fleet_join = "fleet.join"
    # one engine scheduler iteration (serving/llm_batch.py _loop) — a
    # delay() makes the engine fail-SLOW: every request still succeeds,
    # just late
    fleet_degrade = "fleet.degrade"
    # LLM engine request submission (serving/llm_batch.py submit); an armed
    # error raises out of submit() itself. Its context (and llm.prefill's)
    # carries the engine's ``replica`` label beside the reference's keys,
    # so ``match=`` can narrow a fault to one fleet replica
    llm_submit = "llm.submit"
    # one prefill dispatch on the scheduler thread (llm_batch._run_prefill)
    llm_prefill = "llm.prefill"
    # one speculative verify round (llm_batch._spec_decode_tick): fires
    # BEFORE the draft steps and the verify dispatch — an armed error
    # parks that tick to plain decode (never a client error; the stream
    # stays exact-greedy), a delay() models a slow verify
    llm_spec_verify = "llm.spec_verify"
    # prefix-cache page eviction (serving/paged.py _reclaim_pages) — per
    # evicted page with page_id/refcount context
    llm_prefix_evict = "llm.prefix_evict"
    # adapter registry load/evict (serving/adapters.py AdapterRegistry):
    # op="load" before an adapter's weights land in the device bank,
    # op="evict" when a refcount-0 resident is displaced or retired — an
    # error fails ONE request, never the engine
    llm_adapter_load = "llm.adapter_load"
    # one prefix-chain demotion into the host KV tier (serving/paged.py
    # _reclaim_pages), BEFORE the host copy — an error loses the chain to
    # the tier; the page is reclaimed either way
    llm_kv_demote = "llm.kv_demote"
    # one host-tier promote at admission (serving/paged.py
    # _prepare_admission), before the pages re-enter the device pool —
    # an error falls the request back to token prefill, never a client
    # error
    llm_kv_promote = "llm.kv_promote"
    # one cross-replica prefix-page fetch (serving/fleet.py dispatch):
    # fires before the previous ring owner's pages are pulled over the
    # KVHandoff wire — a delay() models a slow fetch, an error falls back
    # to re-prefill from tokens
    llm_kv_fetch = "llm.kv_fetch"
    # datastore reads and writes (datastore/base.py DataItem / DataStore)
    datastore_read = "datastore.read"
    datastore_write = "datastore.write"
    # one elastic health poll of the training loop (training/elastic.py
    # ElasticGuard.poll), with a mutable ``box``: an action setting
    # box["fail"] / box["join"] to a slice index fails / revives that
    # slice in this step
    train_slice_fail = "train.slice_fail"

    @staticmethod
    def all() -> list[str]:
        return [
            FaultPoints.serving_step, FaultPoints.serving_remote,
            FaultPoints.serving_queue,
            FaultPoints.fleet_join, FaultPoints.fleet_degrade,
            FaultPoints.llm_submit,
            FaultPoints.llm_prefill, FaultPoints.llm_spec_verify,
            FaultPoints.llm_prefix_evict, FaultPoints.llm_adapter_load,
            FaultPoints.llm_kv_demote, FaultPoints.llm_kv_promote,
            FaultPoints.llm_kv_fetch,
            FaultPoints.datastore_read, FaultPoints.datastore_write,
            FaultPoints.train_slice_fail,
        ]


# -- schedules ---------------------------------------------------------------
class Schedule:
    """Decides, per matching call, whether the effect fires. ``count`` is
    the 1-based number of calls that reached this injection."""

    def should_fire(self, count: int) -> bool:
        raise NotImplementedError


class _Always(Schedule):
    def should_fire(self, count: int) -> bool:
        return True


class _Nth(Schedule):
    def __init__(self, n: int):
        self.n = int(n)

    def should_fire(self, count: int) -> bool:
        return count == self.n


class _First(Schedule):
    def __init__(self, n: int):
        self.n = int(n)

    def should_fire(self, count: int) -> bool:
        return count <= self.n


class _After(Schedule):
    def __init__(self, n: int):
        self.n = int(n)

    def should_fire(self, count: int) -> bool:
        return count > self.n


class _Prob(Schedule):
    """Deterministic Bernoulli: the k-th call fires iff the k-th draw of
    ``Random(seed)`` is below p — independent of wall clock, process, or
    interleaving with other injections."""

    def __init__(self, p: float, seed: int = 0):
        import random

        self.p = float(p)
        self._rng = random.Random(seed)
        self._draws: list[float] = []

    def should_fire(self, count: int) -> bool:
        while len(self._draws) < count:
            self._draws.append(self._rng.random())
        return self._draws[count - 1] < self.p


def always() -> Schedule:
    return _Always()


def fail_nth(n: int) -> Schedule:
    """Fire only on the n-th call (1-based)."""
    return _Nth(n)


def fail_first(n: int = 1) -> Schedule:
    """Fire on the first n calls, then go quiet (transient fault)."""
    return _First(n)


def fail_after(n: int) -> Schedule:
    """Quiet for the first n calls, then fire on every one."""
    return _After(n)


def fail_with_prob(p: float, seed: int = 0) -> Schedule:
    """Fire with probability p per call, from a seeded deterministic RNG."""
    return _Prob(p, seed)


# -- injections --------------------------------------------------------------
class Injection:
    """One armed fault: point (+ optional wildcard), schedule, effect.
    Usable as a context manager for scoping, or left armed until
    ``remove()`` / ``ChaosRegistry.clear()``."""

    def __init__(self, registry: "ChaosRegistry", point: str,
                 schedule: Schedule, *, error=None, delay: float = 0.0,
                 action=None, match=None):
        self._registry = registry
        self.point = point
        self.schedule = schedule
        self.error = error
        self.delay = float(delay or 0.0)
        self.action = action
        self.match = match
        self.calls = 0   # calls that reached this injection
        self.fired = 0   # calls where the effect actually fired

    def matches(self, point: str, context: dict) -> bool:
        if self.point.endswith(".*"):
            if not point.startswith(self.point[:-1]):
                return False
        elif point != self.point:
            return False
        if self.match is not None and not self.match(context):
            return False
        return True

    def apply(self, point: str, context: dict):
        self.calls += 1
        if not self.schedule.should_fire(self.calls):
            return
        self.fired += 1
        if _fire_observer is not None:
            try:
                _fire_observer(point)
            except Exception:  # noqa: BLE001 - telemetry must not alter
                pass           # the injected failure semantics
        if self.delay > 0:
            time.sleep(self.delay)
        if self.action is not None:
            self.action(point, context)
        if self.error is not None:
            raise self.error() if isinstance(self.error, type) \
                else self.error

    def remove(self):
        self._registry._remove(self)

    def __enter__(self) -> "Injection":
        return self

    def __exit__(self, *exc_info):
        self.remove()
        return False


class ChaosRegistry:
    """Process-wide fault switchboard. ``enabled`` is the fast-path gate:
    the production hooks pay one attribute read when no fault is armed."""

    def __init__(self):
        self._lock = threading.RLock()
        self._injections: list[Injection] = []
        self.enabled = False

    def inject(self, point: str, schedule: Schedule | None = None, *,
               error=None, delay: float = 0.0, action=None,
               match=None) -> Injection:
        """Arm a fault at ``point``. Returns the Injection — use it as a
        context manager to scope the fault to a block:

            with chaos.inject("k8s.delete", fail_nth(1),
                              error=ApiException(500)):
                ...

        ``error`` is an exception instance or class raised when the
        schedule fires; ``delay`` sleeps first (stall simulation);
        ``action(point, context)`` runs arbitrary test code (e.g. kill a
        pod out from under the service); ``match(context) -> bool``
        narrows the fault to specific calls (one pod name, one url).
        """
        injection = Injection(self, point, schedule or always(),
                              error=error, delay=delay, action=action,
                              match=match)
        with self._lock:
            self._injections.append(injection)
            self.enabled = True
        return injection

    def _remove(self, injection: Injection):
        with self._lock:
            if injection in self._injections:
                self._injections.remove(injection)
            self.enabled = bool(self._injections)

    def clear(self):
        with self._lock:
            self._injections.clear()
            self.enabled = False

    def fire(self, point: str, **context):
        """Hook call from production code. No-op unless a matching armed
        injection's schedule fires — then its effect applies (raise/
        delay/action). Injections are applied in arming order."""
        if not self.enabled:
            return
        with self._lock:
            matching = [i for i in self._injections
                        if i.matches(point, context)]
        for injection in matching:
            injection.apply(point, context)

    def injections(self) -> list[Injection]:
        with self._lock:
            return list(self._injections)


# the process-wide registry production hooks fire into
chaos = ChaosRegistry()


def fire(point: str, **context):
    chaos.fire(point, **context)
