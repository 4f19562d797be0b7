"""Graceful preemption handling — a copy of
``mlrun_tpu/training/preemption.py`` for one process (without
``on_preempted``, whose caller, the serving graph's drain, is not ported).

Preemptible/spot machines get SIGTERM with a grace period before
eviction. ``PreemptionGuard`` latches the signal into a flag that
``Trainer.fit`` polls each step; it then writes one final synchronous
checkpoint and returns a resumable state instead of being killed.
"""

from __future__ import annotations

import os
import signal
import threading

from ..utils import logger


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

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def agreed(self) -> bool:
        """The latch as every process agrees on it: one process here, so
        the local flag (the reference all-gathers it across hosts)."""
        return self._event.is_set()
