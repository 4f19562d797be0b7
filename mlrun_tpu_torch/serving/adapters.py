"""Multi-tenant LoRA adapter serving: the device bank, the hot-swap
registry and per-tenant admission fairness — counterpart of
``mlrun_tpu/serving/adapters.py`` (same names, same ``status_code``
classes, same ``.npz`` artifact layout).

- :class:`AdapterBank` — the device-resident working set: per target,
  stacked float32 factors ``[n_slots, L, in, r]`` / ``[n_slots, L, r,
  out]`` / ``[n_slots, L]`` that the batched forwards gather by a per-row
  slot index (serving/llm.py ``_lora_rows``). Slot 0 is the base model
  (all-zero factors, a zero delta), so padding rows and adapterless
  requests ride the same dispatch. Loading an adapter writes its slot in
  place; the tensors are never reallocated.
- :class:`AdapterRegistry` — named adapters loaded from a tree, a local
  ``.npz`` path or a callable, a host LRU of deserialized trees in front
  of the bank, and refcounts that pin a resident adapter while any
  request uses it. Typed 404 / 429 failures keep a bad tenant id or a
  full working set a per-request error, never an engine failure.
- :class:`TenantRateLimiter` — a token bucket per adapter id in front of
  the shared admission queue.

Adapter identity is the NAME: the prefix cache is namespaced by it
(serving/prefix.py), so KV computed under adapter A is never reused for
adapter B. Names are immutable versions.

Loads and evictions fire the ``llm.adapter_load`` chaos point (an armed
error fails one request, never the engine); ``retire`` also drops the
adapter's request-phase series. The adapter-labelled metric series are
published by the engines (serving/llm_batch.py). Datastore URLs for
artifacts are not ported (ROADMAP.md item 10). The engines resolve a
tenant id through the canary router (serving/canary.py) before the
registry sees it; without a router every name resolves to itself.
"""

from __future__ import annotations

import io
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..chaos import FaultPoints, fire
from ..config import SERVING_LLM_DEFAULTS
from ..models.lora import (
    _PROJ_DIMS,
    DEFAULT_TARGETS,
    LoraShapeError,
    lora_rank,
    validate_lora,
)
from .resilience import AdmissionRejected, ResilienceError


# -- errors ------------------------------------------------------------------
class AdapterError(ResilienceError):
    """Base for adapter-registry failures (per-request, never fatal to
    the engine)."""


class UnknownAdapterError(AdapterError):
    """The request names an adapter no source can provide — a client
    error (404), rejected at submit() before any queueing."""

    status_code = 404


class AdapterCapacityError(AdapterError, AdmissionRejected):
    """Every device bank slot is pinned by in-flight requests of OTHER
    adapters — retry later (429), or raise ``max_live_adapters``."""

    status_code = 429


class AdapterRateLimitError(AdmissionRejected):
    """The tenant's token bucket is empty — per-adapter admission
    fairness shed this request (429) so one flooding tenant cannot
    starve the shared queue."""

    status_code = 429


# -- artifact (de)serialization ----------------------------------------------
def save_adapter(target_path: str, lora: dict):
    """Serialize an adapter tree (torch tensors or numpy arrays) to one
    ``.npz`` at ``target_path`` (a local path or a datastore url) — the
    artifact the registry loads. Keys are ``<target>/<factor>``, e.g. ``wq/lora_a``; values
    are float32."""
    validate_lora(lora)
    flat = {}
    for target, adapter in lora.items():
        for key in ("lora_a", "lora_b", "scaling"):
            value = adapter[key]
            if isinstance(value, torch.Tensor):
                value = value.detach().float().cpu().numpy()
            flat[f"{target}/{key}"] = np.asarray(value, np.float32)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    if "://" in target_path:
        from ..datastore import store_manager

        store_manager.object(url=target_path).put(buf.getvalue())
    else:
        with open(target_path, "wb") as fp:
            fp.write(buf.getvalue())


def load_adapter(path: str) -> dict:
    """Inverse of :func:`save_adapter`: read an ``.npz`` adapter artifact
    from a local path or a datastore url (through ``DataItem.get``, with
    its ``datastore.read`` fault point) back into the ``{target: {lora_a,
    lora_b, scaling}}`` tree of numpy arrays."""
    if "://" in path:
        from ..datastore import store_manager

        data = store_manager.object(url=path).get()
    else:
        with open(path, "rb") as fp:
            data = fp.read()
    blob = np.load(io.BytesIO(data))
    lora: dict = {}
    for key in blob.files:
        target, factor = key.rsplit("/", 1)
        lora.setdefault(target, {})[factor] = blob[key]
    return lora


def _to_f32(value, device: torch.device) -> torch.Tensor:
    """A factor (torch tensor or numpy array, bf16 included) as a float32
    tensor on ``device``."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.asarray(value).astype(np.float32))
    return value.detach().to(device=device, dtype=torch.float32)


# -- device bank -------------------------------------------------------------
class AdapterBank:
    """Stacked per-target LoRA factors on ``device``, indexed by bank slot.

    ``tensors[target] = {"lora_a": [S, L, in, r], "lora_b": [S, L, r,
    out], "scaling": [S, L]}`` float32, with S = 1 + max_live (slot 0 =
    base, all zeros). The batched forwards gather rows by a per-request /
    per-decode-row slot index, so every batch row applies its own
    (A, B) delta inside one dispatch."""

    def __init__(self, config, max_live: int, rank: int,
                 targets: Sequence[str] = DEFAULT_TARGETS,
                 device: torch.device | str = "cpu"):
        if max_live < 1:
            raise ValueError(f"max_live must be >= 1, got {max_live}")
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.config = config
        self.max_live = int(max_live)
        self.n_slots = self.max_live + 1
        self.rank = int(rank)
        self.targets = tuple(targets)
        self.device = torch.device(device)
        tensors = {}
        for target in self.targets:
            if target not in _PROJ_DIMS:
                raise LoraShapeError(f"unknown lora target '{target}'")
            d_in, d_out = _PROJ_DIMS[target](config)
            shapes = {"lora_a": (self.n_slots, config.n_layers, d_in, rank),
                      "lora_b": (self.n_slots, config.n_layers, rank, d_out),
                      "scaling": (self.n_slots, config.n_layers)}
            tensors[target] = {
                key: torch.zeros(shape, dtype=torch.float32,
                                 device=self.device)
                for key, shape in shapes.items()}
        self.tensors = tensors

    @torch.no_grad()
    def load_slot(self, slot: int, lora: dict):
        """Write one adapter's factors into bank slot ``slot``, in place
        on the current stream (a dispatch holding the tensors sees the new
        contents, never stale storage). Validates rank/targets/shape
        agreement first (LoraShapeError on drift)."""
        if not 1 <= slot < self.n_slots:
            raise ValueError(f"bank slot {slot} out of range "
                             f"[1, {self.n_slots})")
        validate_lora(lora, config=self.config, rank=self.rank,
                      targets=self.targets)
        for target in self.targets:
            adapter = lora.get(target)
            for key, bank in self.tensors[target].items():
                if adapter is None:
                    # an adapter may train fewer targets than the bank
                    # carries — absent targets contribute a zero delta
                    bank[slot].zero_()
                else:
                    bank[slot].copy_(_to_f32(adapter[key], self.device))


class _Resident:
    __slots__ = ("slot", "refcount", "loaded", "last_used")

    def __init__(self, slot: int):
        self.slot = slot
        self.refcount = 0
        self.loaded = False
        self.last_used = 0


class AdapterRegistry:
    """Named adapters behind a bounded device working set.

    ``sources`` maps adapter name -> one of: a ready adapter tree
    (dict), a local ``.npz`` path (loaded via :func:`load_adapter`), or a
    zero-arg callable returning the tree. Deserialized trees sit in a
    host-side LRU (``host_cache`` entries), so an evicted-then-reused
    adapter re-lands in the bank without another artifact read.

    Thread-safe. ``pin``/``unpin`` bracket a request's lifetime (the
    engines attach unpin as a future done-callback, so every completion
    path releases exactly once); ``ensure_loaded`` runs on the engine's
    scheduler thread (the device owner) and performs the bank write.
    The bank lives on ``device``."""

    def __init__(self, config, sources: Optional[dict] = None,
                 max_live: Optional[int] = None,
                 rank: Optional[int] = None,
                 targets: Optional[Sequence[str]] = None,
                 host_cache: Optional[int] = None,
                 now_fn: Callable[[], float] = time.monotonic,
                 device: torch.device | str = "cpu"):
        conf = SERVING_LLM_DEFAULTS["adapters"]
        self.sources = dict(sources or {})
        if max_live is None:
            max_live = int(conf["max_live_adapters"])
        if host_cache is None:
            host_cache = int(conf["host_cache"])
        self._now = now_fn
        self._lock = threading.RLock()
        # serializes device-bank writes: a registry shared across engines
        # sees ensure_loaded from several scheduler threads
        self._bank_lock = threading.Lock()
        self._host_cache: OrderedDict[str, dict] = OrderedDict()
        self._host_cache_max = max(1, int(host_cache))
        self._residents: dict[str, _Resident] = {}
        self._tick = 0
        self.stats = {"adapter_loads": 0, "adapter_evictions": 0,
                      "adapter_load_errors": 0,
                      "adapter_rejected_capacity": 0,
                      "adapter_rejected_unknown": 0}
        if rank is None or targets is None:
            inferred = self._infer_shape()
            rank = rank if rank is not None else inferred[0]
            targets = targets if targets is not None else inferred[1]
        self.bank = AdapterBank(config, max_live, rank, targets,
                                device=device)
        self._free_slots = list(range(1, self.bank.n_slots))
        # optional DRAFT-model adapter registry (in-engine speculative
        # decoding): per-tenant draft adapters in their own bank sized for
        # the draft config. None = every tenant drafts with the base
        # draft model (the verify still runs under the tenant's TARGET
        # adapter, so the stream is the adapter's greedy output either way)
        self.draft: Optional["AdapterRegistry"] = None

    def attach_draft(self, draft_config, sources: Optional[dict] = None,
                     rank: Optional[int] = None,
                     targets: Optional[Sequence[str]] = None,
                     max_live: Optional[int] = None) -> "AdapterRegistry":
        """Attach per-tenant DRAFT adapters: a second registry, on this
        one's device, whose bank is shaped for the draft model. Tenants
        absent here draft with the base draft model (an acceptance-rate
        cost only, never a correctness one)."""
        self.draft = AdapterRegistry(draft_config, sources=sources,
                                     max_live=max_live, rank=rank,
                                     targets=targets, now_fn=self._now,
                                     device=self.bank.device)
        return self.draft

    def _infer_shape(self) -> tuple[int, tuple]:
        """Rank/targets from the first source (a lazy path/callable source
        is loaded once: the bank's shapes must exist before traffic)."""
        for name in self.sources:
            lora = self._load_params(name)
            return lora_rank(lora), tuple(lora.keys())
        raise ValueError(
            "cannot size the adapter bank: no sources to infer "
            "rank/targets from — pass rank= (and targets=) explicitly")

    # -- source lifecycle ----------------------------------------------------
    def add_source(self, name: str, source):
        """Publish a new named adapter at runtime (tree | path |
        callable). Names are immutable versions: an existing name is
        never overwritten (publish new weights under a new name)."""
        with self._lock:
            existing = self.sources.get(name)
            if existing is not None and existing is not source:
                raise ValueError(
                    f"adapter '{name}' already has a source — adapter "
                    f"names are immutable versions; publish new weights "
                    f"under a new versioned name")
            self.sources[name] = source

    def retire(self, name: str, keep_source: bool = False):
        """Take an adapter out of service: drop its source (unless
        ``keep_source``) and host-cache entry, and free its bank slot if
        no in-flight request pins it. A still-pinned resident keeps
        serving its in-flight requests and becomes LRU-evictable once the
        pins drain — retire never fails live traffic."""
        from ..obs import retire_adapter_phases

        with self._lock:
            if not keep_source:
                self.sources.pop(name, None)
            self._host_cache.pop(name, None)
            resident = self._residents.get(name)
            retired_resident = resident is not None \
                and resident.refcount == 0
            if retired_resident:
                del self._residents[name]
                slot = resident.slot
                self._free_slots.append(slot)
                self.stats["adapter_evictions"] += 1
        if not keep_source:
            # a fully retired identity releases its per-phase histogram
            # series too: version churn must not exhaust the
            # mlt_request_phase_seconds label-set cap
            retire_adapter_phases(name)
        if retired_resident:
            fire(FaultPoints.llm_adapter_load, op="evict", adapter=name,
                 slot=slot)

    # -- host-side loading ---------------------------------------------------
    def known(self, name: str) -> bool:
        with self._lock:
            return name in self.sources or name in self._host_cache

    def check_known(self, name: str):
        """Typed 404 for an unknown name (counted) — the submit-path gate
        that runs BEFORE any rate-limit bucket is touched."""
        if not self.known(name):
            with self._lock:
                self.stats["adapter_rejected_unknown"] += 1
            raise UnknownAdapterError(f"unknown adapter '{name}'")

    def _load_params(self, name: str) -> dict:
        with self._lock:
            cached = self._host_cache.get(name)
            if cached is not None:
                self._host_cache.move_to_end(name)
                return cached
            source = self.sources.get(name)
        if source is None:
            raise UnknownAdapterError(f"unknown adapter '{name}'")
        if callable(source):
            lora = source()
        elif isinstance(source, str):
            lora = load_adapter(source)
        else:
            lora = source
        with self._lock:
            self._host_cache[name] = lora
            self._host_cache.move_to_end(name)
            while len(self._host_cache) > self._host_cache_max:
                self._host_cache.popitem(last=False)
        return lora

    # -- device residency ----------------------------------------------------
    def pinned_counts(self) -> dict:
        """{adapter: in-flight refcount} snapshot."""
        with self._lock:
            return {name: r.refcount for name, r in self._residents.items()
                    if r.refcount > 0}

    def live(self) -> int:
        """Adapters currently loaded in the device bank."""
        with self._lock:
            return sum(1 for r in self._residents.values() if r.loaded)

    def resident_names(self) -> list:
        with self._lock:
            return sorted(self._residents)

    def pin(self, name: str):
        """Reserve a bank slot for ``name`` and take one in-flight
        reference. Raises :class:`UnknownAdapterError` (404) or, when
        every slot is pinned by other adapters' in-flight requests,
        :class:`AdapterCapacityError` (429). Bookkeeping only — never
        touches the device, safe from any submit thread."""
        if not name:
            return
        with self._lock:
            self._tick += 1
            resident = self._residents.get(name)
            if resident is not None:
                resident.refcount += 1
                resident.last_used = self._tick
                return
            if not self.known(name):
                self.stats["adapter_rejected_unknown"] += 1
                raise UnknownAdapterError(f"unknown adapter '{name}'")
            if self._free_slots:
                slot = self._free_slots.pop()
            else:
                victim = min(
                    (r for r in self._residents.values()
                     if r.refcount == 0),
                    key=lambda r: r.last_used, default=None)
                if victim is None:
                    self.stats["adapter_rejected_capacity"] += 1
                    raise AdapterCapacityError(
                        f"all {self.bank.max_live} adapter slots are "
                        f"pinned by in-flight requests — cannot load "
                        f"'{name}' (raise max_live_adapters or retry)")
                victim_name = next(n for n, r in self._residents.items()
                                   if r is victim)
                del self._residents[victim_name]
                slot = victim.slot
                self.stats["adapter_evictions"] += 1
                try:
                    fire(FaultPoints.llm_adapter_load, op="evict",
                         adapter=victim_name, slot=slot)
                except BaseException:
                    # an armed error must not leak the freed slot
                    self._free_slots.append(slot)
                    raise
            resident = _Resident(slot)
            resident.refcount = 1
            resident.last_used = self._tick
            self._residents[name] = resident

    def unpin(self, name: str):
        if not name:
            return
        with self._lock:
            resident = self._residents.get(name)
            if resident is not None and resident.refcount > 0:
                resident.refcount -= 1

    def ensure_loaded(self, name: str) -> int:
        """Materialize a pinned adapter in the device bank; returns its
        bank slot. Called on the scheduler thread at admission. A failed
        load raises — failing ONE request, never the engine — and keeps
        the resident (slot reserved, not loaded), so other requests
        pinning it simply retry the load."""
        if not name:
            return 0
        with self._lock:
            self._tick += 1
            resident = self._residents.get(name)
            if resident is None:
                raise UnknownAdapterError(
                    f"adapter '{name}' is not pinned (internal ordering "
                    f"bug: pin() must precede ensure_loaded())")
            resident.last_used = self._tick
            if resident.loaded:
                return resident.slot
            slot = resident.slot
        try:
            fire(FaultPoints.llm_adapter_load, op="load", adapter=name,
                 slot=slot)
            lora = self._load_params(name)
            with self._bank_lock:
                # re-validate slot ownership before the write: the fetch
                # above ran without locks, and with a SHARED registry the
                # resident can lose its pins and be evicted-and-reassigned
                # meanwhile — a stale write would overwrite the new
                # tenant's factors
                with self._lock:
                    current = self._residents.get(name)
                    if current is not resident or current.slot != slot:
                        raise AdapterCapacityError(
                            f"adapter '{name}' lost its bank slot during "
                            f"load (evicted under contention) — retry")
                self.bank.load_slot(slot, lora)
        except Exception:
            with self._lock:
                self.stats["adapter_load_errors"] += 1
            raise
        with self._lock:
            resident.loaded = True
            self.stats["adapter_loads"] += 1
        return resident.slot


def build_registry(config, adapters, max_live_adapters, device):
    """The engines' ``adapters=`` argument as a registry: None stays None,
    a registry is shared as given, a sources dict builds one on
    ``device``."""
    if adapters is None or isinstance(adapters, AdapterRegistry):
        return adapters
    return AdapterRegistry(config, sources=adapters,
                           max_live=max_live_adapters, device=device)


# -- per-tenant admission fairness -------------------------------------------
class TenantRateLimiter:
    """One token bucket per adapter id (the base model, adapter "", is a
    tenant too). ``rate`` tokens/second refill up to ``burst``; an empty
    bucket sheds with :class:`AdapterRateLimitError` BEFORE the shared
    queue, so a flooding tenant consumes its own budget, not the fleet's
    queue capacity."""

    def __init__(self, rate: float, burst: float,
                 now_fn: Callable[[], float] = time.monotonic):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._now = now_fn
        self._lock = threading.Lock()
        self._buckets: dict[str, list] = {}   # tenant -> [tokens, last_t]

    def try_acquire(self, tenant: str) -> bool:
        now = self._now()
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = [self.burst, now]
                self._buckets[tenant] = bucket
            tokens = min(self.burst,
                         bucket[0] + (now - bucket[1]) * self.rate)
            bucket[1] = now
            if tokens < 1.0:
                bucket[0] = tokens
                return False
            bucket[0] = tokens - 1.0
            return True

    def check(self, tenant: str):
        if not self.try_acquire(tenant):
            raise AdapterRateLimitError(
                f"tenant '{tenant or '<base>'}' is over its admission "
                f"rate ({self.rate}/s, burst {self.burst}) — shed to "
                f"protect the shared queue")
