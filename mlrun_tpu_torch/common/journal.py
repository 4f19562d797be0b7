"""Durable intent journal of the serving control plane — the port's own
copy of ``mlrun_tpu/common/journal.py``, with the same on-disk format
(one ``json.dumps(record, sort_keys=True, separators=(",", ":"))`` line a
record), so a journal either package writes, the other replays.

The pod fleet and the autoscaler keep their orchestration state
(submitted JobSets, drain progress, applied actions) in process memory. A
restart would orphan all of it. The :class:`IntentJournal` is the
write-ahead record that makes a restart a non-event: every intent
transition is appended as one JSONL line *before* the side effect it
describes, and a restarted controller replays the journal, lists the
observed world, and converges the two level-triggered.

Design constraints, in order:

1. **Never poison the control loop.** A journal write failure degrades
   (logged, counted in ``stats``) — it never raises into ``tick()``.
2. **Torn tails are expected.** ``replay()`` drops an unparseable final
   line silently (counted) and skips and logs corrupt lines mid-file.
3. **Bounded size.** ``compact()`` rewrites the file atomically (tmp +
   rename) from a snapshot of live records, and auto-compaction triggers
   through the ``snapshot`` callback once the appends since the last
   compaction cross ``compact_threshold``.
4. **Deterministic fault injection.** Chaos point ``journal.write`` fires
   per append with a mutable box: an action may truncate the serialized
   line (a torn write on demand), an error models a failed write.

Off by default: ``open_journal()`` returns ``None`` unless
``config.SERVING_FLEET_DEFAULTS["journal_dir"]`` is set, and every caller
treats a ``None`` journal as "journaling disabled".
"""

from __future__ import annotations

import io
import json
import os
import threading
from typing import Callable, Iterator, Optional

from ..chaos import FaultPoints, fire
from ..utils import logger


class IntentJournal:
    """Append-only JSONL intent journal with fsync batching, atomic
    compaction, and torn-tail-tolerant replay."""

    def __init__(self, path: str, *, fsync_every: int = 8,
                 compact_threshold: int = 256,
                 snapshot: Optional[Callable[[], list[dict]]] = None):
        self.path = path
        self.fsync_every = max(1, int(fsync_every))
        self.compact_threshold = max(1, int(compact_threshold))
        self._snapshot = snapshot
        self._lock = threading.Lock()
        self._fp: Optional[io.TextIOWrapper] = None
        self._since_fsync = 0
        self._since_compact = 0
        self.stats = {
            "appends": 0,
            "write_failures": 0,
            "torn_tail_dropped": 0,
            "corrupt_skipped": 0,
            "compactions": 0,
        }
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    # -- write path ----------------------------------------------------------
    def append(self, kind: str, **fields) -> bool:
        """Append one intent record. Returns False (and degrades) on any
        failure — callers in control loops must not need a try/except."""
        record = {"kind": kind}
        record.update(fields)
        try:
            line = json.dumps(record, sort_keys=True,
                              separators=(",", ":")) + "\n"
        except (TypeError, ValueError) as exc:
            logger.warning("journal record not serializable",
                           path=self.path, kind=kind, error=str(exc))
            self.stats["write_failures"] += 1
            return False
        box = {"line": line, "kind": kind}
        with self._lock:
            try:
                # an action() may truncate box["line"] (torn write), an
                # error models the write itself failing
                fire(FaultPoints.journal_write, box=box, path=self.path)
                fp = self._open_locked()
                fp.write(box["line"])
                fp.flush()
                self._since_fsync += 1
                if self._since_fsync >= self.fsync_every:
                    os.fsync(fp.fileno())
                    self._since_fsync = 0
            except Exception as exc:  # noqa: BLE001 - degrade, never
                # raise into the control loop (design constraint 1)
                logger.warning("journal append failed",
                               path=self.path, kind=kind, error=str(exc))
                self.stats["write_failures"] += 1
                self._reset_fp_locked()
                return False
            self.stats["appends"] += 1
            self._since_compact += 1
            auto = (self._snapshot is not None
                    and self._since_compact >= self.compact_threshold)
        if auto:
            self.compact(self._snapshot())
        return True

    def _open_locked(self) -> io.TextIOWrapper:
        if self._fp is None or self._fp.closed:
            # heal a torn tail before appending: a crash mid-write can
            # leave the file without a trailing newline, and appending
            # straight after it would weld the new record onto the torn
            # fragment — losing BOTH lines at the next replay
            try:
                with open(self.path, "rb") as fp:
                    fp.seek(-1, os.SEEK_END)
                    torn = fp.read(1) != b"\n"
            except (OSError, ValueError):
                torn = False  # missing/empty file: nothing to heal
            self._fp = open(self.path, "a", encoding="utf-8")
            if torn:
                self._fp.write("\n")
        return self._fp

    def _reset_fp_locked(self) -> None:
        if self._fp is not None:
            try:
                self._fp.close()
            except Exception:  # noqa: BLE001 - already degraded
                pass
            self._fp = None

    # -- read path -----------------------------------------------------------
    def replay(self) -> list[dict]:
        """All intact records, in append order. A partial final line
        (torn tail) is dropped; corrupt mid-file lines are skipped and
        logged — recovery proceeds with the intact prefix."""
        return list(self._iter_records())

    def _iter_records(self) -> Iterator[dict]:
        try:
            with open(self.path, encoding="utf-8") as fp:
                lines = fp.readlines()
        except FileNotFoundError:
            return
        except OSError as exc:
            logger.warning("journal unreadable — recovering cold",
                           path=self.path, error=str(exc))
            return
        last = len(lines) - 1
        for idx, line in enumerate(lines):
            stripped = line.strip()
            if not stripped:
                continue
            try:
                record = json.loads(stripped)
                if not isinstance(record, dict):
                    raise ValueError("record is not an object")
            except (ValueError, TypeError):
                if idx == last:
                    # torn tail: the crash interrupted the final write —
                    # expected, silent by design (constraint 2)
                    self.stats["torn_tail_dropped"] += 1
                else:
                    logger.warning("journal line corrupt — skipped",
                                   path=self.path, line_no=idx + 1)
                    self.stats["corrupt_skipped"] += 1
                continue
            yield record

    # -- compaction ----------------------------------------------------------
    def compact(self, records: list[dict]) -> None:
        """Atomically rewrite the journal to exactly ``records`` (each a
        dict with a ``kind`` key): tmp-write + fsync + rename, so a crash
        mid-compaction leaves either the old or the new file, never a
        mix."""
        tmp = self.path + ".tmp"
        with self._lock:
            self._reset_fp_locked()
            try:
                with open(tmp, "w", encoding="utf-8") as fp:
                    for record in records:
                        fp.write(json.dumps(record, sort_keys=True,
                                            separators=(",", ":")) + "\n")
                    fp.flush()
                    os.fsync(fp.fileno())
                os.replace(tmp, self.path)
            except Exception as exc:  # noqa: BLE001 - degrade (1): the
                # un-compacted journal is still valid
                logger.warning("journal compaction failed",
                               path=self.path, error=str(exc))
                self.stats["write_failures"] += 1
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return
            self.stats["compactions"] += 1
            self._since_compact = 0

    def close(self) -> None:
        with self._lock:
            if self._fp is not None and not self._fp.closed:
                try:
                    os.fsync(self._fp.fileno())
                except (OSError, ValueError):
                    pass
            self._reset_fp_locked()


def open_journal(name: str, *,
                 snapshot: Optional[Callable[[], list[dict]]] = None,
                 ) -> Optional[IntentJournal]:
    """Journal ``<journal_dir>/<name>.jsonl``, or ``None`` when
    ``config.SERVING_FLEET_DEFAULTS["journal_dir"]`` is unset (journaling
    off — the default; every caller treats None as disabled)."""
    from ..config import SERVING_FLEET_DEFAULTS

    journal_dir = str(SERVING_FLEET_DEFAULTS.get("journal_dir", "")
                      or "").strip()
    if not journal_dir:
        return None
    return IntentJournal(os.path.join(journal_dir, f"{name}.jsonl"),
                         snapshot=snapshot)
