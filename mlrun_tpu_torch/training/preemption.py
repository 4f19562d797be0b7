"""Graceful preemption handling — a copy of
``mlrun_tpu/training/preemption.py``.

Preemptible/spot machines get SIGTERM with a grace period before
eviction. ``PreemptionGuard`` latches the signal into a flag that
``Trainer.fit`` polls each step; it then writes one final synchronous
checkpoint and returns a resumable state instead of being killed.
"""

from __future__ import annotations

import os
import signal
import threading

import torch
import torch.distributed as dist

from ..utils import logger


def all_ranks_agree(flag: bool, device=None, group=None) -> bool:
    """Max-reduce a local boolean across the process group's ranks (or
    ``group``'s): every rank must take a stop decision in the same step,
    or the ranks still stepping wait forever in the step's collectives.
    One process: the flag itself. ``device`` holds the vote (NCCL's
    default: the current CUDA device; gloo's: the CPU)."""
    if not dist.is_initialized() or dist.get_world_size(group) <= 1:
        return flag
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    vote = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(vote, op=dist.ReduceOp.MAX, group=group)
    return bool(vote.item())


class PreemptionGuard:
    """Latches SIGTERM (and optionally extra signals) into a flag the
    training loop can poll. A second signal escalates to the previous
    handler, so process managers above us still see hard kills."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict = {}
        self._installed = False

    # -- lifecycle ---------------------------------------------------------
    def install(self) -> "PreemptionGuard":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            # signal handlers can only be set from the main thread; fall
            # back to manual request()
            logger.warning("preemption guard not installed "
                           "(not on main thread)")
            return self
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        self._installed = True
        return self

    def restore(self):
        if not self._installed:
            return
        for sig, previous in self._previous.items():
            signal.signal(sig, previous)
        self._previous.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc_info):
        self.restore()

    # -- signal path -------------------------------------------------------
    def _handle(self, signum, frame):
        # nothing but the event set may happen here: the FIRST signal only
        # latches; a SECOND signal escalates to the previous handler
        if self._event.is_set():
            previous = self._previous.get(signum)
            if callable(previous):
                previous(signum, frame)
            elif previous == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            return
        self._event.set()

    def request(self):
        """Programmatic preemption (tests / external watchers)."""
        self._event.set()

    def on_preempted(self, callback, name: str = "preemption-watcher",
                     timeout: float | None = None) -> threading.Thread:
        """Run ``callback`` once when the preemption latch sets.

        The watcher thread blocks on the latch event (no polling), so the
        callback fires on the FIRST signal — before the second-signal
        escalation in ``_handle`` can ever run. Serving replicas use this
        to drain in-flight requests inside the eviction grace period
        (``GraphServer.drain_on_preemption``). Returns the (daemon)
        watcher thread."""

        def _wait():
            if not self._event.wait(timeout):
                return
            # the latch set is the black-box event of record for an
            # eviction; the dump AFTER the callback captures the drain
            # decisions too (guarded: the grace-period drain must never be
            # blocked by telemetry)
            try:
                from ..obs import flight_record

                flight_record("preempt.signal", watcher=name)
            except Exception:  # noqa: BLE001
                pass
            try:
                callback()
            except Exception as exc:  # noqa: BLE001 - a crashing handler
                # must not take the watcher (and the process teardown) down
                logger.error("preemption callback failed", error=str(exc))
            try:
                from ..obs import get_flight_recorder

                get_flight_recorder().dump("preemption",
                                           extra={"watcher": name})
            except Exception:  # noqa: BLE001
                pass

        thread = threading.Thread(target=_wait, daemon=True, name=name)
        thread.start()
        return thread

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def agreed(self, device=None) -> bool:
        """Agreement of every rank on the preemption latch.

        SIGTERM lands on the ranks at slightly different steps; if one
        rank stops stepping (into the collective checkpoint save) while
        another still runs the train step's collectives, the group
        deadlocks until SIGKILL. Over more than one rank the local flag is
        max-reduced, so every rank flips in the same step (the reference
        all-gathers it across hosts). One process: the local flag."""
        return all_ranks_agree(self._event.is_set(), device)
