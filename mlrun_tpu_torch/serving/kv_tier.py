"""Host-RAM KV tier under the paged engine's device page pool — the
port's own copy of ``mlrun_tpu/serving/kv_tier.py``.

The radix prefix cache (serving/prefix.py) lives inside one engine's
device page pool: pool pressure evicts refcount-0 pages and the prefix is
gone. This tier keeps them one level down: a bounded-bytes host store of
page payloads keyed by ``block_chain_key`` chain nodes.

- **Demote** — ``PrefixCache.evict`` victims are copied host-side before
  their device page returns to the free list (serving/paged.py
  ``_reclaim_pages``, chaos ``llm.kv_demote``).
- **Promote** — an admission whose device-pool match stops short probes
  the tier for the next consecutive blocks and copies their pages back
  into freshly reserved pool pages instead of prefilling those tokens
  (``_prepare_admission``, chaos ``llm.kv_promote``).

What it holds: one dict per chain node, ``{"k", "v"[, "k_scale",
"v_scale"]}`` of CPU ``torch.Tensor`` s, each one page of every layer
(``[L, page_size, Hkv(, D)]``) in the pool's own dtype (bf16 or int8 plus
float32 scales, never densified). For a pool on the card the tensors are
in pinned host memory, so demote and promote are plain ``copy_`` calls
across PCIe. The class itself only reads ``nbytes`` of the payload's
values, so numpy arrays serve as well.

Invariants (mirrors of the device-side prefix-cache contract):

- Ancestors outlive descendants: an entry whose child chain node is still
  resident can never evict, so a promote probe walking root-down over
  consecutive chain keys never finds a hole below a hit.
- Pinned entries (a promote in flight) never evict.
- Bounded bytes: ``put`` evicts unpinned childless entries LRU-first to
  fit; an entry larger than the whole budget is refused, never stored.

Thread-safe: a lock guards the index (entries' page tensors are immutable
by convention — writers store copies).
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class _Entry:
    __slots__ = ("key", "parent_key", "pages", "nbytes", "pins")

    def __init__(self, key: int, parent_key: int | None, pages: dict,
                 nbytes: int):
        self.key = key
        self.parent_key = parent_key
        self.pages = pages
        self.nbytes = nbytes
        self.pins = 0


class HostKVTier:
    """Bounded-bytes host store of per-chain-node KV page payloads."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            raise ValueError(
                f"capacity_bytes must be > 0, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        # key -> _Entry, in LRU order (oldest first)
        self._entries: "OrderedDict[int, _Entry]" = OrderedDict()
        # parent chain key -> set of resident child keys. Children are
        # demoted leaf-first (before their parents), so a parent_key may
        # reference an entry that never arrives — tracked regardless, it
        # only matters once the parent IS resident.
        self._children: dict[int, set[int]] = {}
        self.bytes_used = 0
        # observability counters (surfaced through engine stats)
        self.demotes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: int) -> bool:
        with self._lock:
            return key in self._entries

    @staticmethod
    def _payload_bytes(pages: dict) -> int:
        return sum(int(a.nbytes) for a in pages.values())

    def _evictable(self, entry: _Entry) -> bool:
        if entry.pins > 0:
            return False
        kids = self._children.get(entry.key)
        return not kids

    def _drop(self, entry: _Entry) -> None:
        del self._entries[entry.key]
        self.bytes_used -= entry.nbytes
        if entry.parent_key is not None:
            kids = self._children.get(entry.parent_key)
            if kids is not None:
                kids.discard(entry.key)
                if not kids:
                    del self._children[entry.parent_key]

    def put(self, key: int, parent_key: int | None, pages: dict) -> bool:
        """Store one chain node's page payload (``{name: ndarray}``,
        already host-side copies). Evicts unpinned childless entries
        LRU-first to fit. Returns False when the payload alone exceeds
        the budget or could not fit past pinned/parented residents —
        the demote is simply lost, never an error."""
        nbytes = self._payload_bytes(pages)
        if nbytes > self.capacity_bytes:
            return False
        with self._lock:
            prior = self._entries.get(key)
            if prior is not None:
                # refresh in place (same chain re-demoted)
                self.bytes_used -= prior.nbytes
                prior.pages = pages
                prior.nbytes = nbytes
                self.bytes_used += nbytes
                self._entries.move_to_end(key)
                self.demotes += 1
                return True
            while self.bytes_used + nbytes > self.capacity_bytes:
                victim = next(
                    (e for e in self._entries.values()
                     if self._evictable(e)), None)
                if victim is None:
                    return False
                self._drop(victim)
                self.evictions += 1
            entry = _Entry(key, parent_key, pages, nbytes)
            self._entries[key] = entry
            self.bytes_used += nbytes
            if parent_key is not None:
                self._children.setdefault(parent_key, set()).add(key)
            self.demotes += 1
            return True

    def get(self, key: int) -> dict | None:
        """Page payload for ``key`` (LRU-bumped) or None on miss."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry.pages

    def peek(self, key: int) -> bool:
        """Residency probe without touching LRU order or counters."""
        with self._lock:
            return key in self._entries

    def pin(self, key: int) -> bool:
        """Hold ``key`` against eviction (a promote/fetch assembling its
        payload). Returns False when the entry is already gone."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return False
            entry.pins += 1
            return True

    def unpin(self, key: int) -> None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.pins > 0:
                entry.pins -= 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes_used": self.bytes_used,
                "capacity_bytes": self.capacity_bytes,
                "demotes": self.demotes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
