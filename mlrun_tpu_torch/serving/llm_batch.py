"""Continuous batching: the slot scheduler of the LLM engines —
counterpart of ``mlrun_tpu/serving/llm_batch.py``.

A fixed batch of decode slots; requests are admitted into free slots by a
batch-1 prefill (``_forward_with_cache``) and every scheduler tick advances
all active slots by one token. Finished rows free their slot for the next
queued request. All device work happens on the one scheduler thread.

The dense engine keeps every slot's KV in one cache [L, slots, max_len]
(native or int8): an admission prefills a batch-1 cache, chunk by chunk
with chunked prefill (the cached flash kernel on the card, at
``q_offset > 0`` on a resumed chunk), and ``_insert`` copies it into its
slot; each tick runs one ``_decode_rowwise`` over all slots (dense
attention, per-row positions). The paged engine (serving/paged.py) runs on
the same scheduler core with its page pool behind the storage hooks.

Speculative decoding is the engines' shared policy: a resident draft
model (on a dense slot cache, through ``_decode_rowwise``) proposes up to
k tokens per row per tick, one multi-token verify forward checks them
(``_verify_rowwise`` here, the page-pool verify in the paged engine), and
each row commits its accepted prefix.

Multi-tenant LoRA: with ``adapters`` every request may name an adapter of
the engine's registry (serving/adapters.py); the admission prefill runs
under its bank slot and each decode or verify dispatch gathers every
row's factors by its slot. A tenant id with canary state resolves to its
effective versioned id at submit (serving/canary.py; ``request_key`` pins
the split side).

Resilience and observability, as the reference's: a ``max_wait``
queue-time budget fails expired requests with ``DeadlineExceeded`` (504);
the degradation ladder (``degradation=``) clamps ``max_new_tokens`` and
parks speculation under queue or page pressure; every request carries a
phase ledger (``request_ledger``, on by default) whose closed summary
rides the result's stats as ``timing``; the engines publish the ``mlt_*``
series (obs/) and fire the chaos points ``llm.submit``, ``llm.prefill``,
``llm.spec_verify`` and ``fleet.degrade``. ``submit_prefill`` /
``submit_prefilled`` hand a prompt's KV from a prefill engine to a decode
engine as a :class:`KVHandoff`.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..chaos import FaultPoints, fire
from ..config import SERVING_LLM_DEFAULTS
from ..models.llama import LlamaConfig, Params, lm_head, logits_f32
from ..obs import (
    ADAPTER_LIVE,
    ADAPTER_LOADS,
    CANARY_REQUESTS,
    LLM_DECODE_TICK,
    LLM_EVENTS,
    LLM_FREE_PAGE_FRAC,
    LLM_ITL,
    LLM_QUEUE_DEPTH,
    LLM_SPEC_ROUNDS,
    LLM_SPEC_TOKENS,
    LLM_TTFT,
    REGISTRY,
    RequestLedger,
    export_phases,
    flight_record,
    get_flight_recorder,
    get_tracer,
    ledger_enabled,
    register_memory_collector,
)
from ..obs.stats import nearest_rank
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rope, rope_table
from ..utils import logger
from ..utils.profiler import tick as profiler_tick
from .adapters import (
    AdapterError,
    AdapterRateLimitError,
    AdapterRegistry,
    TenantRateLimiter,
    UnknownAdapterError,
    build_registry,
)
from .canary import get_canary_router, split_key_for
from .llm import (
    _cached_attention,
    _forward_with_cache,
    _lora_rows,
    _out_and_mlp,
    _qkv,
    default_device,
    init_kv_cache,
)
from .samples import emit_sample, sampling_enabled
from .resilience import (
    DeadlineExceeded,
    DegradationLadder,
    EngineStoppedError,
    PromptTooLongError,
    QueueFullError,
)

# process-wide engine sequence: each engine's /metrics identity
_ENGINE_SEQUENCE = itertools.count(1)


def _write_rows(dst: torch.Tensor, rows, index, inside, values):
    """``dst[rows, index] = values`` for the rows where ``inside`` holds;
    the other rows keep their entry. The reference's scatter drops a write
    past the cache's end; here those rows are clamped onto the last entry
    and rewrite it with its own value, so nothing syncs the host."""
    old = dst[rows, index]
    keep = inside.reshape(-1, *([1] * (values.dim() - 1)))
    dst[rows, index] = torch.where(keep, values.to(dst.dtype), old)


def _store_kv(cache: dict, layer: int, k, v, write, dtype):
    """Write a step's k/v into ``layer`` of a dense slot cache through
    ``write(dst, values)`` (an int8 cache takes them quantized per vector,
    with their scales) and return what the attention reads: the cache
    itself, or the int8 cache's view dequantized to ``dtype``, as the
    reference does."""
    from .llm import _dequantize_kv, _quantize_kv

    if "k_scale" not in cache:
        write(cache["k"][layer], k)
        write(cache["v"][layer], v)
        return cache["k"][layer], cache["v"][layer]
    for name, t in (("k", k), ("v", v)):
        values, scales = _quantize_kv(t)
        write(cache[name][layer], values)
        write(cache[f"{name}_scale"][layer], scales)
    return (_dequantize_kv(cache["k"][layer], cache["k_scale"][layer], dtype),
            _dequantize_kv(cache["v"][layer], cache["v_scale"][layer], dtype))


def _decode_rowwise(config: LlamaConfig, params: Params, tokens: torch.Tensor,
                    cache: dict, generator=None, temperature=None,
                    top_k=None, top_p=None, lora=None, adapter_ids=None):
    """One decode token per row of a dense native slot cache (the draft
    model's) with PER-ROW positions ``cache['pos']`` (rows at different
    generation depths): tokens [B, 1]. Each row's KV is written at its own
    position, then every row attends its cache up to that position. Greedy
    rows take the argmax; with a ``generator`` the per-row sampling
    settings apply (serving/sampling.py). The cache is updated IN PLACE
    and ``pos`` advances by one. Returns (next_token [B] int32, cache).
    An int8 cache takes the token quantized per vector and attends its
    dequantized view in ``config.dtype``, as the reference does.
    ``lora``/``adapter_ids`` add per-row multi-tenant LoRA: each row
    gathers its own factors from the bank by its slot (0 = base model /
    inactive rows), as in ``llm._forward_with_cache``."""
    from .sampling import sample_logits

    b = tokens.shape[0]
    m = cache["k"].shape[2]
    start = cache["pos"].long()                           # [B]
    positions = start[:, None]                            # [B, 1]
    rows = torch.arange(b, device=tokens.device)
    index, inside = start.clamp_max(m - 1), start < m
    x = params["embedding"][tokens].to(config.dtype)
    cos, sin = rope_table(positions, config.head_dim, config.rope_theta)
    lora_rows = _lora_rows(lora, adapter_ids)

    def write(dst, values):
        _write_rows(dst, rows, index, inside, values)

    for layer in range(config.n_layers):
        lp = {name: w[layer] for name, w in params["layers"].items()}
        h = rms_norm(x, lp["attn_norm_scale"], config.norm_eps)
        q, k, v = _qkv(config, h, lp, lora_rows, layer)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_attn, v_attn = _store_kv(cache, layer, k[:, 0], v[:, 0], write,
                                   config.dtype)
        attn = _cached_attention(config, q, k_attn, v_attn, positions, m)
        x = _out_and_mlp(config, x, attn, lp, lora_rows, layer)
    x = rms_norm(x, params["final_norm_scale"], config.norm_eps)
    logits = logits_f32(x[:, 0], lm_head(params))
    if generator is None:
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        next_token = sample_logits(logits, generator, temperature, top_k,
                                   top_p)
    cache["pos"] = cache["pos"] + 1
    return next_token, cache


def _verify_rowwise(config: LlamaConfig, params: Params,
                    chunk: torch.Tensor, cache: dict, lora=None,
                    adapter_ids=None):
    """Batched multi-token speculative verify on a dense slot cache with
    PER-ROW positions: ``chunk`` [B, S] is each row's committed last token
    followed by its draft proposals, at positions ``pos[r]..pos[r]+S-1``.
    ONE forward gives the target's argmax at all S positions, the chunk
    attending the cache in place under per-position causal masking (dense
    attention, as the reference).

    The chunk's KV is written at its positions BEFORE the attention reads
    (int8 caches quantize it per vector), and ``pos`` is NOT advanced: the
    host commits the accepted length afterwards, so entries past it are
    stale but never read before they are written again. Writes past the
    cache's end drop (the reference's ``mode="drop"``): each lane is
    written in turn, and a lane past the end is clamped onto the last
    entry and rewrites that entry's current value, so a garbage lane never
    overwrites a row's real last entry and nothing syncs the host. The
    cache is updated IN PLACE. ``lora``/``adapter_ids``: each row's own
    adapter, as in :func:`_decode_rowwise`. Returns (verified [B, S]
    int32, cache)."""
    b, s = chunk.shape
    m = cache["k"].shape[2]
    positions = cache["pos"].long()[:, None] + torch.arange(
        s, device=chunk.device)[None, :]                    # [B, S]
    rows = torch.arange(b, device=chunk.device)
    index, inside = positions.clamp_max(m - 1), positions < m
    x = params["embedding"][chunk].to(config.dtype)
    cos, sin = rope_table(positions, config.head_dim, config.rope_theta)
    lora_rows = _lora_rows(lora, adapter_ids)

    def write(dst, values):
        # lanes in ascending position: a clamped lane reads back what a
        # real lane just wrote at the last entry
        for lane in range(s):
            _write_rows(dst, rows, index[:, lane], inside[:, lane],
                        values[:, lane])

    for layer in range(config.n_layers):
        lp = {name: w[layer] for name, w in params["layers"].items()}
        h = rms_norm(x, lp["attn_norm_scale"], config.norm_eps)
        q, k, v = _qkv(config, h, lp, lora_rows, layer)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_attn, v_attn = _store_kv(cache, layer, k, v, write, config.dtype)
        attn = _cached_attention(config, q, k_attn, v_attn, positions, m)
        x = _out_and_mlp(config, x, attn, lp, lora_rows, layer)
    x = rms_norm(x, params["final_norm_scale"], config.norm_eps)
    logits = logits_f32(x, lm_head(params))
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def _insert(big_cache: dict, small: dict, slot: int, pos: int) -> dict:
    """Copy a prefilled batch-1 cache (int8 scales included) into row
    ``slot`` of a dense slot cache (the same max_len) and set that row's
    position. In place."""
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in big_cache:
            big_cache[name][:, slot] = small[name][:, 0].to(
                big_cache[name].dtype)
    big_cache["pos"][slot] = pos
    return big_cache


def _percentile(sorted_samples: list, q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample list (the
    shared ``obs.stats.nearest_rank``)."""
    return nearest_rank(sorted_samples, q)


def _to_wire(t: torch.Tensor) -> np.ndarray:
    """A KV tensor as the host array a :class:`KVHandoff` carries: float32
    and int8 as they are; bfloat16 as its raw 16-bit patterns (uint16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_wire(a) -> torch.Tensor:
    """The inverse of :func:`_to_wire`, which also reads the reference's
    bfloat16 arrays (``ml_dtypes.bfloat16``, where numpy has it) by their
    bits."""
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()     # a torch tensor must not alias read-only memory
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(
            a.view(np.int16))).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclass
class KVHandoff:
    """Prefill-to-decode KV handoff payload, the reference's class.

    A prefill engine produces one via :meth:`ContinuousBatchingEngine.
    submit_prefill`; a decode engine consumes it via
    ``submit_prefilled`` and decodes token-identically to the
    single-engine path (greedy). The payload is host arrays trimmed to the
    prompt rows, so it can cross a process boundary; rebuilt from its
    fields as the other package's ``KVHandoff``, it crosses between the
    reference's engines and the port's in both directions.

    Wire format (the reference's): ``kv`` always carries ``k``/``v``
    ``[L, prompt_len, Hkv, D]``; on an int8 pool (``kv_dtype == "int8"``)
    they stay int8 and the per-vector float32 scales ride alongside as
    ``k_scale``/``v_scale`` ``[L, prompt_len, Hkv]`` — never densified.
    float32 and int8 arrays cross unchanged. numpy has no bfloat16 (and
    the card's machine has no ``ml_dtypes``), so a bfloat16 native pool's
    ``k``/``v`` cross as their raw 16-bit patterns in ``uint16`` arrays,
    with ``kv_dtype`` still ``"native"``: the array dtype names the bits
    (no float KV is ever uint16). The port reads both that and the
    reference's ``ml_dtypes.bfloat16`` arrays; the reference would cast
    uint16 values numerically, so a bfloat16 payload from the port must
    be viewed as bfloat16 before the reference imports it (ROADMAP.md,
    queue 3)."""

    prompt: list
    first_token: int
    kv: dict                     # {"k","v"[, "k_scale","v_scale"]}: numpy
    prompt_len: int
    kv_dtype: str = "native"     # "native" | "int8": the exporting pool's
    cached_prefix: int = 0       # prompt tokens served from the prefill
    #                              engine's prefix cache
    sampling: tuple = (0.0, 0, 1.0)
    prefill_s: float = 0.0       # submit-to-export wall on the prefill side
    replica: str = ""            # prefill replica id (fleet bookkeeping)
    adapter: str = ""            # the tenant the KV was computed under: the
    #                              decode engine decodes with the same one
    timing: Optional[dict] = None  # the prefill side's closed ledger
    prewarm: bool = False        # the importer registers the imported
    #                              pages in its prefix index

    def nbytes(self) -> int:
        return int(sum(arr.nbytes for arr in self.kv.values()))



@dataclass
class _Admission:
    """A request claimed off the queue and being prefilled into a slot.

    With chunked prefill the same admission resumes across scheduler
    ticks: ``offset`` is the absolute prefill cursor (it starts at ``base``
    > 0 on a paged prefix-cache hit)."""

    slot: int
    request_id: int
    prompt: list
    max_new: int
    eos_id: Optional[int]
    future: Future
    submitted: float
    sampling: tuple
    expires: Optional[float] = None
    small: dict = None
    base: int = 0
    offset: int = 0
    chunks: int = 0
    first_token: int = -1
    # paged-engine bookkeeping
    page_ids: object = None
    pages: list = field(default_factory=list)
    prefix_nodes: list = field(default_factory=list)
    # prefix-hit kernel path: the cached prefix was NOT gathered into
    # ``small`` — prefill dispatches attend the shared pages in place
    # through ``prefix_ids`` (pages_per_slot long, -1 past the prefix)
    kernel_prefix: bool = False
    prefix_ids: object = None
    # multi-tenant LoRA: the request's adapter name and its bank slot
    # (resolved at admission by AdapterRegistry.ensure_loaded)
    adapter: str = ""
    adapter_slot: int = 0
    # trace context captured at submit ((trace_id, parent_span_id)) and
    # the wall clock at claim: the llm.prefill span is emitted from these
    trace: Optional[tuple] = None
    claimed: float = 0.0
    # KV handoff: an export admission resolves its future with a
    # KVHandoff instead of activating a slot; a prefilled one arrived with
    # its KV and skips the prefill dispatch; register_import also indexes
    # the imported pages (a prewarm payload)
    export: bool = False
    prefilled: bool = False
    register_import: bool = False
    # the request's phase ledger (None with the ledger off)
    ledger: Optional[RequestLedger] = None
    # monitoring tap: first-token top1-top2 logit gap, threaded to the
    # slot for the completion sample
    logit_margin: float = float("nan")


@dataclass
class _Slot:
    request_id: int = -1
    tokens: list = field(default_factory=list)
    remaining: int = 0
    eos_id: Optional[int] = None
    future: Optional[Future] = None
    started: float = 0.0
    ttft: float = 0.0
    prompt_len: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # multi-tenant LoRA: the occupying request's adapter and bank slot
    # (the decode tick gathers each row's factors by adapter_slot)
    adapter: str = ""
    adapter_slot: int = 0
    # trace context and decode start (wall clock) of the llm.decode span
    trace: Optional[tuple] = None
    decode_started: float = 0.0
    # the request's phase ledger, handed over from the admission; every
    # tick flips it decode_active / decode_stall around the dispatch
    ledger: Optional[RequestLedger] = None
    # monitoring tap (serving/samples.py): first-token top1-top2 logit
    # gap, captured at prefill only while a sample observer is armed
    logit_margin: float = float("nan")

    @property
    def active(self) -> bool:
        return self.request_id >= 0


class ContinuousBatchingEngine:
    """Admission + decode loop over a fixed slot batch.

    ``submit()`` is thread-safe and returns a Future resolving to (tokens,
    stats). The slot storage and the decode and verify steps are hooks
    (``_make_cache``, ``_prepare_admission``, ``_complete_storage``,
    ``_plain_decode_tick``, ``_release_slot_storage``,
    ``_warmup_storage``, ``_make_verify_fn``, ``_spec_verify_dispatch``,
    ``_spec_apply_positions``, ``_spec_warmup_verify``): this class keeps
    the slots in a dense cache [L, slots, max_len] (``kv_dtype`` native or
    int8); :class:`~.paged.PagedContinuousBatchingEngine` implements them
    over its page pool.

    ``speculative`` (``{"enabled": True, "k": ..., "draft_config": ...,
    "draft_params": ...}`` over the config defaults) keeps a draft model
    resident: each tick whose rows are all greedy runs up to k draft steps
    per row and one verify forward, and commits each row's accepted
    prefix (per-row k adapts to a bounded acceptance window, one per
    adapter).

    ``adapters`` (a sources dict, or an ``AdapterRegistry`` shared with
    other engines) serves named LoRA adapters per request, with
    ``max_live_adapters`` bank slots; ``adapter_rate`` > 0 puts a token
    bucket per tenant (``adapter_burst`` deep) in front of the queue.

    Overload: ``max_queue_size`` sheds the newest request (429),
    ``max_wait`` > 0 fails a request still queued past that many seconds
    with ``DeadlineExceeded`` (504), and ``degradation`` (a
    ``DegradationLadder`` spec) clamps ``max_new_tokens`` and parks
    speculation while the queue (or, paged, the free-page fraction) is
    past its rung. ``request_ledger`` (None = the config's default, on)
    attributes every request's wall to phases; the summary comes back as
    ``stats["timing"]``.
    """

    def __init__(self, config: LlamaConfig, params: Params,
                 max_len: int = 2048, slots: int = 4,
                 prefill_buckets: tuple = (128, 512, 1024),
                 seed: int = 0, kv_dtype: str = "native",
                 max_queue_size: int = 0, max_wait: float = 0.0,
                 degradation: dict | None = None,
                 prefill_chunk: int | None = None,
                 latency_window: int | None = None,
                 attention_impl: str | None = None,
                 speculative: dict | None = None, adapters=None,
                 max_live_adapters: int | None = None,
                 adapter_rate: float | None = None,
                 adapter_burst: float | None = None,
                 request_ledger: bool | None = None, device=None):
        from ..ops.attention import resolve_prefill_impl

        self.config = config
        self.params = params
        self.max_len = max_len
        self.slots = slots
        self.kv_dtype = kv_dtype
        self.device = default_device(device)
        if params["embedding"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embedding'].device}, the engine "
                f"on {self.device}")
        if max_queue_size < 0:
            raise ValueError("max_queue_size must be >= 0")
        if max_wait < 0:
            raise ValueError("max_wait must be >= 0")
        # bounded admission queue, reject-newest shedding (0 = unbounded);
        # max_wait: per-request queue-time budget in seconds (0 = off)
        self.max_queue_size = int(max_queue_size)
        self.max_wait = float(max_wait)
        self.degradation = DegradationLadder.from_spec(degradation)
        # chunked prefill: at most prefill_chunk prompt tokens per
        # scheduler tick, so a long prompt never freezes the inter-token
        # latency of running slots; 0 = whole-prompt prefill inline
        if prefill_chunk is None:
            prefill_chunk = int(SERVING_LLM_DEFAULTS["prefill_chunk"])
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        self.prefill_chunk = min(int(prefill_chunk), max_len)
        if latency_window is None:
            latency_window = int(SERVING_LLM_DEFAULTS["latency_window"])
        if latency_window <= 0:
            raise ValueError("latency_window must be > 0")
        self._ttft_ring: deque = deque(maxlen=latency_window)
        self._itl_ring: deque = deque(maxlen=latency_window)
        self._tick_ring: deque = deque(maxlen=latency_window)
        # attention dispatch: auto | flash | kernel | reference; prefill
        # resolves to the cached flash kernel or the dense masked softmax
        if attention_impl is None:
            attention_impl = str(SERVING_LLM_DEFAULTS["attention_impl"])
        self.attention_impl = attention_impl
        self.prefill_impl = resolve_prefill_impl(attention_impl, self.device)
        if self.prefill_impl == "flash":
            from ..ops import _build

            _build.library()  # build now: a kernel fault surfaces here
        self._admission: Optional[_Admission] = None
        self.prefill_buckets = tuple(
            b for b in sorted(prefill_buckets) if b <= max_len) or (max_len,)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        # multi-tenant LoRA: named adapters loaded into a device bank that
        # every prefill / decode dispatch gathers per row by slot. A
        # shared registry's stats are the registry's, published by no
        # engine; None = a single-tenant engine, on the plain products
        self._owns_adapters = not isinstance(adapters, AdapterRegistry)
        self._adapters = build_registry(config, adapters, max_live_adapters,
                                        self.device)
        adapters_conf = SERVING_LLM_DEFAULTS["adapters"]
        if adapter_rate is None:
            adapter_rate = float(adapters_conf["rate"])
        if adapter_burst is None:
            adapter_burst = float(adapters_conf["burst"])
        # per-tenant admission fairness in front of the shared queue
        self._tenant_limiter = (TenantRateLimiter(adapter_rate, adapter_burst)
                                if adapter_rate > 0 else None)
        # adapter label values this engine has emitted series for —
        # removed with the rest of its series on stop()
        self._adapter_labels_seen: set = set()
        # per-request phase ledger: off = one None check per instrumented
        # site, nothing allocated. The clock is injectable for fake-clock
        # closure tests; every ledger transition reads it exactly once
        if request_ledger is None:
            request_ledger = ledger_enabled()
        self.request_ledger = bool(request_ledger)
        self._ledger_clock = time.perf_counter

        self._cache = self._make_cache()
        self._slot_state = [_Slot() for _ in range(slots)]
        self._queue: queue.Queue = queue.Queue()
        self._running = False
        self._stopped = False
        self._crash_exc: Optional[Exception] = None
        self._thread: Optional[threading.Thread] = None
        # /metrics identity and scrape-time collector; ``replica`` labels
        # every mlt_llm_* series ("" for a standalone engine) — set it
        # before start()
        self._obs_name = f"{type(self).__name__}-{next(_ENGINE_SEQUENCE)}"
        self.replica = ""
        self._metrics_collector = None
        self._next_id = 0
        # RLock: the expiry sweep holds it across drain and re-put while
        # the helpers it calls re-acquire it
        self._lock = threading.RLock()
        # queued requests carrying a max_wait budget; the per-tick expiry
        # sweep is skipped while this is zero
        self._budgeted = 0
        self._stats = {"requests": 0, "completed": 0, "ttft_sum": 0.0,
                       "tokens_out": 0, "shed": 0, "expired": 0,
                       "degraded": 0, "rejected_too_long": 0,
                       "prefill_chunks": 0, "prefill_tokens_tick_max": 0,
                       "handoffs_out": 0, "handoff_bytes_out": 0,
                       "handoffs_in": 0, "handoff_bytes_in": 0,
                       "adapter_rate_limited": 0}
        # flipped by the degradation ladder; the speculative tick consults
        # it
        self.speculative_enabled = True
        # in-engine speculative decoding: off unless a draft model is given
        self._init_speculative(speculative)

    # -- storage hooks: the dense slot cache --------------------------------
    def _make_cache(self):
        """Slot KV storage (hook: the paged engine makes a page pool)."""
        return init_kv_cache(self.config, self.slots, self.max_len,
                             kv_dtype=self.kv_dtype, device=self.device)

    def _complete_storage(self, adm: _Admission):
        """Move the prefilled batch-1 cache into the slot (the paged engine
        scatters it into its pages)."""
        _insert(self._cache, adm.small, adm.slot, len(adm.prompt))
        adm.small = None  # the batch-1 cache is consumed

    def _plain_decode_tick(self, active) -> int:
        """One ``_decode_rowwise`` over every slot (inactive rows decode
        garbage behind their own position) and one host read of the
        tokens."""
        last = np.zeros((self.slots, 1), np.int64)
        for i in active:
            last[i, 0] = self._slot_state[i].tokens[-1]
        tokens = torch.as_tensor(last, device=self.device)
        lora_kw = self._lora_kwargs(self._slot_adapter_ids())
        self._ledger_mark(active, "decode_active")
        if any(self._slot_state[i].temperature > 0 for i in active):
            temp = np.zeros((self.slots,), np.float32)
            top_k = np.zeros((self.slots,), np.int64)
            top_p = np.ones((self.slots,), np.float32)
            for i in active:
                slot = self._slot_state[i]
                temp[i], top_k[i], top_p[i] = (slot.temperature, slot.top_k,
                                               slot.top_p)
            next_token, self._cache = _decode_rowwise(
                self.config, self.params, tokens, self._cache,
                self._generator, temp, top_k, top_p, **lora_kw)
        else:
            next_token, self._cache = _decode_rowwise(
                self.config, self.params, tokens, self._cache, **lora_kw)
        tokens_host = next_token.cpu().numpy()
        self._ledger_mark(active, "decode_stall")
        for i in active:
            slot = self._slot_state[i]
            token = int(tokens_host[i])
            slot.tokens.append(token)
            slot.remaining -= 1
            capacity = slot.prompt_len + len(slot.tokens) >= self.max_len
            if (slot.eos_id is not None and token == slot.eos_id) or \
                    slot.remaining <= 0 or capacity:
                self._finish(i)
        return len(active)

    def _release_slot_storage(self, index: int):
        # zero the freed row's position so decode writes land in its own
        # (now unused) region
        self._cache["pos"][index] = 0
        self._spec_release_slot(index)

    def _abort_admission(self, adm: _Admission):
        """Release admission-held storage (stop mid-prefill)."""

    # -- multi-tenant LoRA ----------------------------------------------------
    def _lora_kwargs(self, slots=None) -> dict:
        """The forward kwargs that thread the adapter bank and per-row slot
        ids into a dispatch, {} without a registry. ``slots`` is an int
        (a batch-1 admission prefill) or one slot per engine slot (a
        decode or verify tick); default every row on the base slot 0. The
        ids are copied to the device once per dispatch."""
        if self._adapters is None:
            return {}
        if slots is None:
            ids = np.zeros((self.slots,), np.int32)
        else:
            ids = np.atleast_1d(np.asarray(slots, np.int32))
        return {"lora": self._adapters.bank.tensors,
                "adapter_ids": torch.as_tensor(ids, device=self.device)}

    def _slot_adapter_ids(self) -> np.ndarray:
        """Per-engine-slot bank slots for a decode dispatch (inactive rows
        decode on the base slot; their outputs are discarded)."""
        return np.fromiter(
            (s.adapter_slot if s.active else 0 for s in self._slot_state),
            np.int32, self.slots)

    def _resolve_adapter(self, adapter: str, future: Future):
        """Load the request's adapter into the device bank (on the
        scheduler thread, the device owner). Returns the bank slot, or
        None after failing the request's future: an adapter that does not
        load fails ONE request, never the engine."""
        if not adapter:
            return 0
        try:
            return self._adapters.ensure_loaded(adapter)
        except Exception as exc:  # noqa: BLE001 - a per-request failure
            logger.warning("adapter load failed", adapter=adapter,
                           error=str(exc))
            if not future.done():
                future.set_exception(exc)
            return None

    def add_adapter_source(self, name: str, source):
        """Publish a named adapter at runtime; requests naming it load
        through the normal pin / ensure_loaded admission."""
        if self._adapters is None:
            raise ValueError(
                "engine has no adapter registry (build it with "
                "adapters=... to hot-load adapters)")
        self._adapters.add_source(name, source)

    def retire_adapter(self, name: str, keep_source: bool = False):
        """Take an adapter out of service; in-flight pins finish first."""
        if self._adapters is not None:
            self._adapters.retire(name, keep_source=keep_source)

    # -- speculative decoding (the policy; the verify step is a hook) -------
    def _init_speculative(self, speculative: dict | None):
        conf = dict(SERVING_LLM_DEFAULTS["speculative"])
        draft_config = draft_params = None
        enabled = bool(conf["enabled"])
        if isinstance(speculative, dict):
            draft_config = speculative.get("draft_config")
            draft_params = speculative.get("draft_params")
            conf.update({k: v for k, v in speculative.items()
                         if k not in ("draft_config", "draft_params")})
            enabled = bool(conf.get("enabled", True))
        self.spec_k = max(1, int(conf.get("k", 4) or 4))
        self.spec_min_acceptance = float(conf.get("min_acceptance", 0.35))
        self.spec_window = max(1, int(conf.get("window", 32) or 32))
        self.spec_probe_every = max(1, int(conf.get("probe_every", 16)
                                           or 16))
        self.spec_enabled = bool(enabled and draft_config is not None
                                 and draft_params is not None)
        if not self.spec_enabled:
            return
        if draft_config.vocab_size != self.config.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if draft_params["embedding"].device.type != self.device.type:
            raise ValueError(
                f"draft params live on {draft_params['embedding'].device}, "
                f"the engine on {self.device}")
        self._spec_draft_config = draft_config
        self._spec_draft_params = draft_params
        # the draft's KV is always the dense slot layout (a small model:
        # the page pool exists for the target's memory, not the draft's)
        self._spec_dcache = init_kv_cache(draft_config, self.slots,
                                          self.max_len, device=self.device)
        # entries behind each slot's last committed token in the draft
        # cache (the same invariant as the target's position)
        self._spec_dpos = np.zeros((self.slots,), np.int32)
        # prompt tokens per slot: the draft's resync source after plain
        # ticks advanced the target without the draft
        self._spec_prompts: dict = {}
        self._spec_stale: set = set()
        # per-adapter bounded acceptance windows: (proposed, accepted) per
        # verify round, and each parked adapter's probation count
        self._spec_windows: dict = {}
        self._spec_probe: dict = {}
        # per-tenant draft adapters: the one each slot pins, and the
        # adapters whose draft load failed once (they draft on the base
        # draft model from then on, never retried per tick)
        self._spec_draft_pins: dict = {}
        self._spec_draft_block: set = set()
        self._stats.update({"spec_rounds": 0, "spec_proposed": 0,
                            "spec_accepted": 0, "spec_rejected": 0,
                            "spec_tokens": 0, "spec_parked_ticks": 0,
                            "spec_resyncs": 0})
        # the engine's verify step, made on first use (the paged engine
        # resolves its attention route after this constructor runs)
        self._spec_verify = None

    def _make_verify_fn(self):
        """The multi-token verify step ``fn(params, chunk, storage, ...)``
        (hook: the paged engine swaps in the page-pool verify)."""
        return functools.partial(_verify_rowwise, self.config)

    def _spec_verify_fn(self):
        if self._spec_verify is None:
            self._spec_verify = self._make_verify_fn()
        return self._spec_verify

    def _spec_draft_registry(self):
        """The per-tenant DRAFT adapter registry, or None (every tenant
        drafts on the base draft model)."""
        return getattr(self._adapters, "draft", None)

    def _spec_lora_kwargs(self, adapter_ids) -> dict:
        """Draft-bank LoRA kwargs for the draft dispatches ({} without
        draft adapters: the base draft model)."""
        draft = self._spec_draft_registry()
        if draft is None or adapter_ids is None:
            return {}
        return {"lora": draft.bank.tensors,
                "adapter_ids": torch.as_tensor(np.asarray(adapter_ids,
                                                          np.int32),
                                               device=self.device)}

    def _spec_pin_draft(self, index: int, adapter: str):
        """Pin the tenant's DRAFT adapter for the life of slot ``index``
        (released by ``_spec_release_slot``), where the draft registry has
        one. A tenant without one drafts on the base draft model: the
        verify runs under the tenant's TARGET adapter, so the stream is
        the adapter's greedy output either way (the draft only buys
        speed)."""
        draft = self._spec_draft_registry()
        if draft is None or not adapter or adapter in self._spec_draft_block \
                or not draft.known(adapter):
            return
        try:
            draft.pin(adapter)
        except AdapterError as exc:
            self._spec_draft_block.add(adapter)
            logger.warning("draft adapter unavailable, using base draft",
                           adapter=adapter, error=str(exc))
            return
        self._spec_draft_pins[index] = adapter

    def _spec_draft_slot(self, index: int) -> int:
        """The draft bank slot of slot ``index``'s pinned draft adapter, 0
        (the base draft) without one or once its load failed."""
        adapter = self._spec_draft_pins.get(index)
        if adapter is None or adapter in self._spec_draft_block:
            return 0
        try:
            return self._spec_draft_registry().ensure_loaded(adapter)
        except Exception as exc:  # noqa: BLE001 - a draft adapter that
            # does not load degrades to the base draft, never the request
            self._spec_draft_block.add(adapter)
            logger.warning("draft adapter unavailable, using base draft",
                           adapter=adapter, error=str(exc))
            return 0

    def _spec_slot_draft_ids(self, active):
        """Per-slot DRAFT bank slots (0 = base draft model), or None
        without draft adapters."""
        if self._spec_draft_registry() is None:
            return None
        ids = np.zeros((self.slots,), np.int32)
        for i in active:
            ids[i] = self._spec_draft_slot(i)
        return ids

    def _spec_draft_steps(self, tokens: torch.Tensor,
                          lora=None, adapter_ids=None) -> np.ndarray:
        """``spec_k`` greedy draft steps over the full slot batch from each
        row's draft position (the reference's ``lax.scan``, here a loop of
        ``_decode_rowwise`` dispatches; the rows' draft adapters gathered
        once) and one host read of the proposals [slots, spec_k]."""
        cache = self._spec_dcache
        cache["pos"] = torch.as_tensor(self._spec_dpos, device=self.device)
        lora_rows = _lora_rows(lora, adapter_ids)
        proposals = []
        for _ in range(self.spec_k):
            nxt, cache = _decode_rowwise(self._spec_draft_config,
                                         self._spec_draft_params, tokens,
                                         cache, lora=lora_rows)
            proposals.append(nxt)
            tokens = nxt[:, None].long()
        return torch.stack(proposals, dim=1).cpu().numpy()

    def _spec_prefill_slot(self, index: int, tokens_seq):
        """(Re)build one slot's draft KV by prefilling ``tokens_seq`` (under
        the slot's draft adapter, where it has one); afterwards
        ``_spec_dpos[index] == len(tokens_seq)``."""
        total = len(tokens_seq)
        if total <= 0 or total > self.max_len:
            self._spec_dpos[index] = max(0, min(total, self.max_len))
            return
        small = init_kv_cache(self._spec_draft_config, 1, self.max_len,
                              device=self.device)
        padded = np.zeros((1, self._bucket_for(total)), np.int64)
        padded[0, :total] = tokens_seq
        draft_slot = self._spec_draft_slot(index)
        lora_kw = self._spec_lora_kwargs([draft_slot] if draft_slot else None)
        _forward_with_cache(self._spec_draft_config, self._spec_draft_params,
                            torch.as_tensor(padded, device=self.device),
                            small, **lora_kw)
        # garbage KV at the padded tail is masked by position until real
        # writes land there (the target's bucket-pad argument)
        _insert(self._spec_dcache, small, index, total)
        self._spec_dpos[index] = total

    def _spec_admit_slot(self, adm: _Admission):
        """Draft prefill of a fresh admission: the draft always takes the
        full prompt, whether the target prefilled cold or through a
        prefix-cache hit (the draft has no prefix cache)."""
        self._spec_prompts[adm.slot] = list(adm.prompt)
        self._spec_stale.discard(adm.slot)
        self._spec_pin_draft(adm.slot, adm.adapter)
        self._spec_prefill_slot(adm.slot, adm.prompt)

    def _spec_resync_row(self, index: int):
        """Rebuild a stale draft row (plain ticks advanced the target
        without the draft): re-prefill prompt + committed tokens minus the
        last. Draft-side only — the target's output never depends on the
        draft's KV, so a resync cannot change the stream."""
        slot = self._slot_state[index]
        stream = list(self._spec_prompts.get(index, ())) + slot.tokens
        if len(stream) > 1:
            self._spec_prefill_slot(index, stream[:-1])
        else:
            self._spec_dpos[index] = 0
        self._spec_stale.discard(index)
        with self._lock:
            self._stats["spec_resyncs"] += 1

    def _spec_release_slot(self, index: int):
        if not self.spec_enabled:
            return
        self._spec_prompts.pop(index, None)
        self._spec_stale.discard(index)
        self._spec_dpos[index] = 0
        adapter = self._spec_draft_pins.pop(index, None)
        if adapter is not None:
            self._spec_draft_registry().unpin(adapter)

    def _spec_row_k(self, adapter: str) -> int:
        """Adaptive per-row proposal length from the adapter's bounded
        acceptance window: a cold window gives the full k; a paying one k
        scaled to the expected acceptance; under ``spec_min_acceptance``
        the row parks at 0 (plain decode) with a k=1 probe every
        ``spec_probe_every`` consulted rounds. Round counts, never the
        clock."""
        window = self._spec_windows.get(adapter)
        if window is None:
            window = self._spec_windows[adapter] = deque(
                maxlen=self.spec_window)
        proposed = sum(p for p, _ in window)
        if proposed < 8:
            return self.spec_k
        acc = sum(a for _, a in window) / proposed
        if acc < self.spec_min_acceptance:
            count = self._spec_probe.get(adapter, 0) + 1
            self._spec_probe[adapter] = count
            return 1 if count % self.spec_probe_every == 0 else 0
        self._spec_probe.pop(adapter, None)
        return max(1, min(self.spec_k,
                          int(round(acc * (self.spec_k + 1)))))

    def _spec_tick_viable(self, active) -> bool:
        if not self.spec_enabled or not self.speculative_enabled:
            return False
        # mixed greedy/sampled batches tick plain: the verify chunk's
        # argmax equivalence is a greedy contract
        return all(self._slot_state[i].temperature == 0.0 for i in active)

    def _spec_apply_positions(self, committed: dict):
        """Commit accepted positions on the target's KV (hook: the paged
        engine writes its host-side positions). Rewinding is the whole
        rollback: rejected entries are overwritten before any read."""
        rows = torch.as_tensor(list(committed), device=self.device)
        self._cache["pos"][rows] = torch.as_tensor(
            list(committed.values()), dtype=torch.int32, device=self.device)

    def _spec_verify_dispatch(self, chunk: np.ndarray, active) -> np.ndarray:
        """One multi-token verify forward over every slot -> the target's
        argmax at each chunk position [slots, k+1] on the host (hook: the
        paged engine dispatches the page-pool verify)."""
        verified, self._cache = self._spec_verify_fn()(
            self.params, torch.as_tensor(chunk, device=self.device),
            self._cache, **self._lora_kwargs(self._slot_adapter_ids()))
        return verified.cpu().numpy()

    def _spec_decode_tick(self, active) -> Optional[int]:
        """One speculative tick: ``spec_k`` batched draft steps, ONE
        multi-token verify dispatch, then per-row accept / rollback.
        Returns None to fall through to the plain tick (a chaos park, or
        every row's gate parked this round)."""
        from .speculative import accept_tokens

        # chaos: an armed llm.spec_verify fault parks THIS tick to plain
        # decode — never a client error; the stream stays exact-greedy
        # because a plain tick emits the same target argmax
        try:
            fire(FaultPoints.llm_spec_verify, engine=self._obs_name,
                 replica=self.replica, rows=len(active))
        except Exception as exc:  # noqa: BLE001 - any armed error parks
            with self._lock:
                self._stats["spec_parked_ticks"] += 1
            flight_record("engine.spec_park", engine=self._obs_name,
                          replica=self.replica, error=str(exc))
            return None

        k_max = self.spec_k
        k_effs = np.zeros((self.slots,), np.int32)
        any_spec = False
        for i in active:
            slot = self._slot_state[i]
            if slot.remaining < 1:
                continue
            # gate consult before resync: a parked row's stale draft cache
            # is never read (its k_eff is 0, its writes are discarded)
            k_row = min(self._spec_row_k(slot.adapter), slot.remaining,
                        k_max)
            k_effs[i] = max(0, k_row)
            if k_row > 0:
                any_spec = True
                if i in self._spec_stale:
                    self._spec_resync_row(i)
        if not any_spec:
            return None

        last = np.zeros((self.slots, 1), np.int64)
        for i in active:
            last[i, 0] = self._slot_state[i].tokens[-1]
        self._ledger_mark(active, "decode_active")
        proposals = self._spec_draft_steps(
            torch.as_tensor(last, device=self.device),
            **self._spec_lora_kwargs(self._spec_slot_draft_ids(active)))
        chunk = np.zeros((self.slots, k_max + 1), np.int64)
        chunk[:, 0] = last[:, 0]
        chunk[:, 1:] = proposals
        verified = self._spec_verify_dispatch(chunk, active)
        self._ledger_mark(active, "decode_stall")

        finished = []
        committed = {}
        rounds = proposed_total = accepted_total = tokens_total = 0
        for i in active:
            slot = self._slot_state[i]
            k_eff = int(k_effs[i])
            emitted, n_accept = accept_tokens(proposals[i, :k_eff],
                                              verified[i], k_eff)
            if k_eff > 0:
                rounds += 1
                proposed_total += k_eff
                accepted_total += n_accept
                self._spec_windows[slot.adapter].append((k_eff, n_accept))
            if slot.eos_id is not None and slot.eos_id in emitted:
                emitted = emitted[:emitted.index(slot.eos_id) + 1]
            emitted = emitted[:max(0, slot.remaining)]
            slot.tokens.extend(int(t) for t in emitted)
            slot.remaining -= len(emitted)
            if k_eff > 0:
                tokens_total += len(emitted)
            pos_i = slot.prompt_len + len(slot.tokens) - 1
            committed[i] = pos_i
            self._spec_dpos[i] = pos_i
            capacity = slot.prompt_len + len(slot.tokens) >= self.max_len
            if ((slot.eos_id is not None and slot.tokens[-1] == slot.eos_id)
                    or slot.remaining <= 0 or capacity):
                finished.append(i)
        self._spec_apply_positions(committed)
        with self._lock:
            self._stats["spec_rounds"] += rounds
            self._stats["spec_proposed"] += proposed_total
            self._stats["spec_accepted"] += accepted_total
            self._stats["spec_rejected"] += proposed_total - accepted_total
            self._stats["spec_tokens"] += tokens_total
        for i in finished:
            self._finish(i)
        return len(active)

    def _spec_warmup(self):
        """One draft prefill, one round of draft steps and one verify
        ahead of traffic. The garbage KV they write sits behind position 0
        or on the scratch page and is overwritten before any read."""
        if not self.spec_enabled:
            return
        small = init_kv_cache(self._spec_draft_config, 1, self.max_len,
                              device=self.device)
        _forward_with_cache(
            self._spec_draft_config, self._spec_draft_params,
            torch.zeros((1, self.prefill_buckets[0]), dtype=torch.long,
                        device=self.device), small)
        self._spec_draft_steps(torch.zeros((self.slots, 1), dtype=torch.long,
                                           device=self.device))
        self._spec_warmup_verify()

    def _spec_warmup_verify(self):
        """Warm the verify step (hook: the paged engine verifies against
        its scratch page). The chunk's writes land behind position 0 and
        are overwritten by the next admission's insert."""
        chunk = torch.zeros((self.slots, self.spec_k + 1), dtype=torch.long,
                            device=self.device)
        self._spec_verify_fn()(self.params, chunk, self._cache,
                               **self._lora_kwargs())
        self._cache["pos"].zero_()

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._running:
            return
        self._running = True
        self._register_metrics()
        # device memory / host RSS exposition while this engine lives
        register_memory_collector(self)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0):
        """Stop the scheduler and fail every pending request promptly with
        :class:`EngineStoppedError`; the engine's metric series go with
        it."""
        self._running = False
        self._stopped = True
        thread, self._thread = self._thread, None
        exc = EngineStoppedError("engine stopped while the request was "
                                 "pending")
        if thread is not None:
            thread.join(timeout=timeout)
        if thread is not None and thread.is_alive():
            # still inside a device step: fail what is queued now and
            # leave the in-flight slots to the scheduler's exit
            logger.warning("engine stop: scheduler still busy after "
                           "join timeout", timeout=timeout)
            self._drain_queue(exc)
        else:
            self._fail_pending(exc)
        self._unregister_metrics()

    def close(self):
        self.stop()

    # -- /metrics collector --------------------------------------------------
    # cumulative stats keys mirrored as counter series at scrape time (the
    # adapter_* keys have their one family, mlt_adapter_loads_total)
    _COUNTER_STATS = ("requests", "completed", "tokens_out", "shed",
                      "expired", "degraded", "rejected_too_long",
                      "prefill_chunks", "prefix_queries", "prefix_hits",
                      "prefix_evictions", "prefix_cached_tokens",
                      "handoffs_out", "handoff_bytes_out", "handoffs_in",
                      "handoff_bytes_in")

    def _register_metrics(self):
        """Expose this engine on the process registry: queue-depth and
        free-page-fraction gauges, the cumulative stats counters, the
        speculation counters and the per-tenant adapter series, read at
        scrape time (weakly bound; retired on stop())."""
        if self._metrics_collector is not None:
            return
        import weakref

        ref = weakref.ref(self)
        name = self._obs_name
        replica = self.replica
        adapter_labels = self._adapter_labels_seen
        has_adapters = self._adapters is not None and self._owns_adapters
        has_limiter = self._tenant_limiter is not None
        has_spec = self.spec_enabled
        counter_stats = self._COUNTER_STATS

        def remove_series():
            for adapter in adapter_labels | {""}:
                LLM_QUEUE_DEPTH.remove(engine=name, replica=replica,
                                       adapter=adapter)
            LLM_FREE_PAGE_FRAC.remove(engine=name, replica=replica)
            if has_spec:
                LLM_SPEC_ROUNDS.remove(engine=name, replica=replica)
                for outcome in ("accepted", "rejected"):
                    LLM_SPEC_TOKENS.remove(engine=name, replica=replica,
                                           outcome=outcome)
            for key in counter_stats:
                LLM_EVENTS.remove(engine=name, replica=replica, event=key)
            if has_adapters:
                ADAPTER_LIVE.remove(engine=name, replica=replica)
                for outcome in ("ok", "evict", "error", "capacity",
                                "unknown"):
                    ADAPTER_LOADS.remove(engine=name, replica=replica,
                                         outcome=outcome)
            if has_adapters or has_limiter:
                ADAPTER_LOADS.remove(engine=name, replica=replica,
                                     outcome="rate_limited")
            if replica:
                # a fleet replica owns its latency series too; standalone
                # engines (replica "") share one series, never removed
                for adapter in adapter_labels | {""}:
                    for family in (LLM_TTFT, LLM_ITL):
                        family.remove(replica=replica, adapter=adapter)
                LLM_DECODE_TICK.remove(replica=replica)

        def collect():
            engine = ref()
            if engine is None:
                remove_series()
                return False
            stats = engine.stats
            # per-tenant queue depth: every live adapter gets its queued
            # estimate (explicitly 0 when idle); "" carries the rest, so
            # the sum over adapter values is the engine's total depth
            depth = stats.get("queue_depth", 0)
            named = engine._adapter_queue_depths()
            live = engine._live_adapter_labels() | set(named)
            for adapter in live:
                LLM_QUEUE_DEPTH.set(named.get(adapter, 0), engine=name,
                                    replica=replica, adapter=adapter)
            LLM_QUEUE_DEPTH.set(max(0, depth - sum(named.values())),
                                engine=name, replica=replica, adapter="")
            # retire the series of tenants that are gone
            stale = adapter_labels - live - {""}
            for adapter in stale:
                LLM_QUEUE_DEPTH.remove(engine=name, replica=replica,
                                       adapter=adapter)
                if replica:
                    for family in (LLM_TTFT, LLM_ITL):
                        family.remove(replica=replica, adapter=adapter)
            adapter_labels.difference_update(stale)
            adapter_labels.update(live)
            frac = engine._free_page_frac()
            if frac is not None:
                LLM_FREE_PAGE_FRAC.set(frac, engine=name, replica=replica)
            for key in engine._COUNTER_STATS:
                if key in stats:
                    LLM_EVENTS.set_total(stats[key], engine=name,
                                         replica=replica, event=key)
            if has_spec:
                LLM_SPEC_ROUNDS.set_total(stats.get("spec_rounds", 0),
                                          engine=name, replica=replica)
                LLM_SPEC_TOKENS.set_total(stats.get("spec_accepted", 0),
                                          engine=name, replica=replica,
                                          outcome="accepted")
                LLM_SPEC_TOKENS.set_total(stats.get("spec_rejected", 0),
                                          engine=name, replica=replica,
                                          outcome="rejected")
            registry = engine._adapters if engine._owns_adapters else None
            if registry is not None:
                ADAPTER_LIVE.set(registry.live(), engine=name,
                                 replica=replica)
                reg_stats = registry.stats
                for outcome, key in (
                        ("ok", "adapter_loads"),
                        ("evict", "adapter_evictions"),
                        ("error", "adapter_load_errors"),
                        ("capacity", "adapter_rejected_capacity"),
                        ("unknown", "adapter_rejected_unknown")):
                    ADAPTER_LOADS.set_total(reg_stats[key], engine=name,
                                            replica=replica,
                                            outcome=outcome)
            if registry is not None or has_limiter:
                ADAPTER_LOADS.set_total(
                    stats.get("adapter_rate_limited", 0), engine=name,
                    replica=replica, outcome="rate_limited")
            return None

        self._metrics_collector = collect
        self._remove_metric_series = remove_series
        REGISTRY.add_collector(collect)

    def _adapter_queue_depths(self) -> dict:
        """{adapter: queued-but-not-active} from the registry's pins (one
        per in-flight request) minus the rows already decoding or
        prefilling."""
        if self._adapters is None or not self._owns_adapters:
            return {}
        pins = self._adapters.pinned_counts()
        if not pins:
            return {}
        active: dict = {}
        for slot in self._slot_state:
            if slot.active and slot.adapter:
                active[slot.adapter] = active.get(slot.adapter, 0) + 1
        adm = self._admission
        if adm is not None and adm.adapter:
            active[adm.adapter] = active.get(adm.adapter, 0) + 1
        return {adapter: max(0, count - active.get(adapter, 0))
                for adapter, count in pins.items()}

    def _live_adapter_labels(self) -> set:
        """Adapter names that keep metric series now: bank residents plus
        anything occupying a slot or the admission."""
        if self._adapters is None:
            return set()
        live = set(self._adapters.resident_names()) \
            if self._owns_adapters else set()
        live.update(s.adapter for s in self._slot_state
                    if s.active and s.adapter)
        adm = self._admission
        if adm is not None and adm.adapter:
            live.add(adm.adapter)
        return live

    def _unregister_metrics(self):
        """Drop the collector and every labelled series this engine owns:
        a process churning engines must not pin dead series."""
        collector, self._metrics_collector = self._metrics_collector, None
        if collector is not None:
            REGISTRY.remove_collector(collector)
            self._remove_metric_series()

    def warmup(self):
        """Run one prefill (cold form) and one decode tick ahead of
        traffic, so the first request pays for no kernel build or library
        initialisation. All writes land in scratch storage."""
        started = time.perf_counter()
        small = init_kv_cache(self.config, 1, self.max_len,
                              device=self.device)
        tokens = torch.zeros((1, self.prefill_buckets[0]), dtype=torch.long,
                             device=self.device)
        _forward_with_cache(self.config, self.params, tokens, small,
                            attn_impl=self.prefill_impl,
                            **self._lora_kwargs(0))
        self._warmup_storage()
        self._spec_warmup()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logger.info("continuous batching engine warm", slots=self.slots,
                    warmup_s=round(time.perf_counter() - started, 2))

    def _warmup_storage(self):
        """One decode tick over every slot at position 0, then every
        position back to 0 (hook: the paged engine warms its prefix-hit
        prefill and its decode tick). The garbage KV lands at row 0 of each
        slot, which an admission's insert overwrites."""
        step = torch.zeros((self.slots, 1), dtype=torch.long,
                           device=self.device)
        _decode_rowwise(self.config, self.params, step, self._cache,
                        **self._lora_kwargs())
        self._cache["pos"] = torch.zeros((self.slots,), dtype=torch.int32,
                                         device=self.device)

    # -- API ----------------------------------------------------------------
    def _free_page_frac(self) -> Optional[float]:
        """Paged engines report KV-page headroom; the dense engine None."""
        return None

    def _queue_depth(self) -> int:
        return self._queue.qsize()

    def pressure_level(self) -> int:
        """Degradation-ladder level: 0 normal, 1 degraded (speculation
        off, ``max_new_tokens`` clamped), 2 shedding (queue full)."""
        depth = self._queue_depth()
        if self.max_queue_size and depth >= self.max_queue_size:
            return 2
        if self.degradation is not None:
            return self.degradation.level(depth, self.max_queue_size,
                                          self._free_page_frac())
        return 0

    def submit(self, prompt_tokens, max_new_tokens: int = 64,
               eos_id: int | None = None, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               max_wait: float | None = None, adapter: str = "",
               request_key=None, _extra=None, _trace=None) -> Future:
        """Thread-safe request submission. The future fails fast —
        QueueFullError when shedding, EngineStoppedError after stop/crash,
        PromptTooLongError past max_len, UnknownAdapterError (404) for an
        ``adapter`` no source provides, AdapterRateLimitError (429) for a
        tenant over its token bucket, AdapterCapacityError (429) when
        every bank slot is pinned by other adapters, DeadlineExceeded
        (504) once it waited past ``max_wait`` (None = the engine's) —
        and never silently hangs. A named adapter stays pinned until the
        future completes. A tenant id with canary state resolves to its
        effective versioned id first (serving/canary.py);
        ``request_key`` pins the split side (absent, the prompt tokens
        decide). ``_extra`` ("export" or an imported :class:`KVHandoff`)
        and ``_trace`` are the fleet's and the handoff's internal
        channel."""
        future: Future = Future()
        if self._stopped and not self._running:
            cause = f": {self._crash_exc}" if self._crash_exc else ""
            future.set_exception(EngineStoppedError(
                f"engine is stopped, not accepting requests{cause}"))
            return future
        prompt_len = len(prompt_tokens)
        if prompt_len == 0:
            future.set_exception(ValueError("empty prompt"))
            return future
        if prompt_len + max_new_tokens > self.max_len:
            with self._lock:
                self._stats["rejected_too_long"] += 1
            future.set_exception(PromptTooLongError(
                f"prompt_len {prompt_len} + max_new_tokens "
                f"{max_new_tokens} exceeds max_len {self.max_len}"))
            return future
        adapter = adapter or ""
        # the phase ledger from here on: submit-side checks are
        # "admission" time, the limiter check "rate_limit_wait"
        ledger = RequestLedger(clock=self._ledger_clock) \
            if self.request_ledger else None
        split_tenant = split_side = ""
        if adapter and not isinstance(_extra, KVHandoff):
            # canary/version resolution: a tenant id with router state
            # becomes its effective versioned id HERE, before the prefix
            # cache, the limiter and the bank see it. An imported handoff
            # arrives resolved (its prefill side chose) and must not
            # re-roll the split. Metering waits for the queue put
            # (_meter_split): a shed request must not skew the split
            router = get_canary_router()
            if router is not None:
                resolved, side = router.resolve(
                    adapter, split_key_for(prompt_tokens, request_key))
                if side:
                    split_tenant, split_side = adapter, side
                adapter = resolved
        if adapter:
            # the 404 check runs BEFORE the limiter: an unknown name never
            # mints a rate-limit bucket, fails 404 (not 429), and is never
            # served the base model's tokens
            if self._adapters is None:
                future.set_exception(UnknownAdapterError(
                    f"engine has no adapter registry (adapter='{adapter}')"))
                return future
            try:
                self._adapters.check_known(adapter)
            except AdapterError as exc:
                future.set_exception(exc)
                return future
        # per-tenant fairness BEFORE the shared queue: a flooding tenant
        # burns its own bucket, not everyone's queue capacity. An imported
        # handoff was charged once at its prefill admission
        if self._tenant_limiter is not None \
                and not isinstance(_extra, KVHandoff):
            if ledger is not None:
                ledger.enter("rate_limit_wait")
            acquired = self._tenant_limiter.try_acquire(adapter)
            if ledger is not None:
                ledger.enter("admission")
            if not acquired:
                with self._lock:
                    self._stats["adapter_rate_limited"] += 1
                future.set_exception(AdapterRateLimitError(
                    f"tenant '{adapter or '<base>'}' is over its admission "
                    f"rate — shed to protect the shared queue"))
                return future
        # the chaos point fires BEFORE the pin: an armed error here must
        # not strand a refcount
        fire(FaultPoints.llm_submit, prompt_len=prompt_len,
             max_new_tokens=max_new_tokens, adapter=adapter,
             replica=self.replica)
        if adapter:
            try:
                self._adapters.pin(adapter)
            except AdapterError as exc:
                future.set_exception(exc)
                return future
            # one pin per in-flight request, released on ANY completion
            # path (result, shed, expiry, stop): the future is its lifetime
            future.add_done_callback(
                lambda _f, a=adapter: self._adapters.unpin(a))
            try:
                self._enqueue(future, prompt_tokens, max_new_tokens,
                              eos_id, temperature, top_k, top_p, max_wait,
                              adapter, _extra, _trace, ledger)
            except Exception as exc:  # noqa: BLE001 - an exception past
                # the pin must complete the future (its unpin callback)
                if not future.done():
                    future.set_exception(exc)
                return future
            self._meter_split(split_tenant, split_side, future)
            return future
        self._enqueue(future, prompt_tokens, max_new_tokens, eos_id,
                      temperature, top_k, top_p, max_wait, adapter, _extra,
                      _trace, ledger)
        self._meter_split(split_tenant, split_side, future)
        return future

    @staticmethod
    def _meter_split(tenant: str, side: str, future: Future):
        """Count one ADMITTED request on the canary split telemetry —
        after the queue put, so sheds and rejections (whose futures
        already failed) and fleet re-dispatch attempts that never
        enqueued don't skew the canary/(canary+stable) fraction."""
        if side and (not future.done() or future.exception() is None):
            CANARY_REQUESTS.inc(adapter=tenant, side=side)

    def _enqueue(self, future: Future, prompt_tokens, max_new_tokens,
                 eos_id, temperature, top_k, top_p, max_wait, adapter,
                 _extra, _trace, ledger=None) -> Future:
        """The pressure / degradation checks and the queue put: the tail of
        submit()."""
        level = self.pressure_level()
        if level >= 2:
            with self._lock:
                self._stats["shed"] += 1
            flight_record("engine.shed", engine=self._obs_name,
                          queue_depth=self._queue.qsize(), adapter=adapter)
            future.set_exception(QueueFullError(
                f"engine queue is full (max_queue_size="
                f"{self.max_queue_size}, depth {self._queue.qsize()}) — "
                f"shedding"))
            return future
        if level >= 1:
            # degraded: clamp the token budget and park speculative
            # decoding before shedding starts
            if self.degradation is not None:
                max_new_tokens = self.degradation.clamp_max_new(
                    max_new_tokens, level)
            if self.speculative_enabled:
                logger.warning("engine degraded: speculative decoding off",
                               queue_depth=self._queue.qsize())
            self.speculative_enabled = False
            with self._lock:
                self._stats["degraded"] += 1
        else:
            self.speculative_enabled = True
        budget = self.max_wait if max_wait is None else float(max_wait)
        expires = (time.perf_counter() + budget) if budget > 0 else None
        # the submitting thread's span crosses to the scheduler inside the
        # queue item: the llm.prefill / llm.decode spans are its children
        if _trace is None:
            current_span = get_tracer().current()
            _trace = ((current_span.trace_id, current_span.span_id)
                      if current_span is not None else None)
        if ledger is not None:
            if _trace is not None:
                ledger.trace_id = _trace[0]
            # submit-side work done; the clock now charges the queue
            ledger.enter("queue_wait")
        # enqueue under the lock: the expiry sweep drains and re-puts the
        # queue atomically, so a racing put never jumps older requests
        with self._lock:
            request_id = self._next_id
            self._next_id += 1
            self._stats["requests"] += 1
            if expires is not None:
                self._budgeted += 1
            self._queue.put((request_id, [int(t) for t in prompt_tokens],
                             int(max_new_tokens), eos_id, future,
                             time.perf_counter(),
                             (float(temperature), int(top_k), float(top_p)),
                             expires, _trace, _extra, adapter, ledger))
        if not self._running:
            self.start()
        return future

    # -- prefill / decode disaggregation: the KV handoff ---------------------
    def submit_prefill(self, prompt_tokens, eos_id: int | None = None,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0, max_wait: float | None = None,
                       adapter: str = "", request_key=None,
                       _trace=None) -> Future:
        """Run ONLY the (chunked) prefill of a prompt; the future resolves
        to a :class:`KVHandoff` a decode engine imports via
        :meth:`submit_prefilled`. On the paged engine the prompt's KV
        still lands in this engine's prefix cache under ``adapter``'s
        root. ``max_new_tokens=1`` bounds the page reservation to the
        prompt."""
        return self.submit(prompt_tokens, max_new_tokens=1, eos_id=eos_id,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, max_wait=max_wait, adapter=adapter,
                           request_key=request_key, _extra="export",
                           _trace=_trace)

    def submit_prefilled(self, handoff: KVHandoff,
                         max_new_tokens: int = 64,
                         eos_id: int | None = None,
                         max_wait: float | None = None,
                         register_prefix: bool = False,
                         _trace=None) -> Future:
        """Admit an already-prefilled request: the handoff's KV is imported
        into the admission cache and decode starts at once — no prefill
        dispatch runs on this engine. Decode runs under the handoff's
        adapter. ``register_prefix`` also indexes the imported prompt
        pages in the paged engine's prefix cache (a prewarm replay). A
        payload from a pool of another dtype raises ``ValueError``."""
        expects_scales = self.kv_dtype == "int8"
        wire_dtype = getattr(handoff, "kv_dtype", None) or (
            "int8" if "k_scale" in handoff.kv else "native")
        if wire_dtype != self.kv_dtype or \
                ("k_scale" in handoff.kv) != expects_scales:
            raise ValueError(
                f"KV handoff dtype mismatch: engine kv_dtype="
                f"'{self.kv_dtype}' cannot import a '{wire_dtype}' "
                f"payload — prefill and decode pools must quantize alike")
        temperature, top_k, top_p = handoff.sampling
        if register_prefix and not handoff.prewarm:
            handoff = dataclasses.replace(handoff, prewarm=True)
        return self.submit(handoff.prompt, max_new_tokens=max_new_tokens,
                           eos_id=eos_id, temperature=temperature,
                           top_k=top_k, top_p=top_p, max_wait=max_wait,
                           adapter=handoff.adapter, _extra=handoff,
                           _trace=_trace)

    def _handoff_kv(self, adm: _Admission, rows: int) -> dict:
        """An export admission's prompt KV as host arrays (the
        :class:`KVHandoff` payload; int8 pools ship int8 values and float32
        scales). Hook: the paged engine's kernel-prefix path fills the
        cached-prefix rows from its pool pages."""
        return {name: _to_wire(adm.small[name][:, 0, :rows])
                for name in ("k", "v", "k_scale", "v_scale")
                if name in adm.small}

    def _import_small(self, handoff: KVHandoff) -> dict:
        """A handoff's payload as the batch-1 admission cache: the prompt
        rows from the payload, zeros beyond (decode writes a position
        before it attends it)."""
        small = init_kv_cache(self.config, 1, self.max_len,
                              kv_dtype=self.kv_dtype, device=self.device)
        for name in ("k", "v", "k_scale", "v_scale"):
            payload = handoff.kv.get(name)
            if name not in small or payload is None:
                continue
            rows = min(payload.shape[1], self.max_len)
            small[name][:, 0, :rows] = _from_wire(payload[:, :rows]).to(
                device=self.device, dtype=small[name].dtype)
        small["pos"] = torch.full((1,), handoff.prompt_len,
                                  dtype=torch.int32, device=self.device)
        return small

    def _export_admission(self, adm: _Admission):
        """Resolve an export admission's future with its KV handoff and
        free the slot storage at once: a prefill engine never holds a
        decode slot. (The paged engine's ``_complete_storage`` already
        registered the prompt's blocks, so the prefix stays cached.)"""
        if adm.ledger is not None:
            # the trim and serialize below are the prefill side's handoff
            adm.ledger.enter("handoff")
        rows = len(adm.prompt)
        kv = self._handoff_kv(adm, rows)
        prefill_s = time.perf_counter() - adm.submitted
        timing = None
        if adm.ledger is not None:
            timing = adm.ledger.close("handoff")
            export_phases(timing, adapter=adm.adapter)
        if adm.trace is not None:
            attrs = {"slot": adm.slot, "prompt_len": len(adm.prompt),
                     "chunks": adm.chunks, "cached_prefix": adm.base,
                     "imported": False, "exported": True,
                     "adapter": adm.adapter, "replica": self.replica}
            if timing is not None:
                attrs["timing"] = timing
            get_tracer().emit("llm.prefill", adm.trace[0], adm.trace[1],
                              start=adm.claimed, attrs=attrs)
        handoff = KVHandoff(
            prompt=list(adm.prompt), first_token=adm.first_token, kv=kv,
            prompt_len=len(adm.prompt), kv_dtype=self.kv_dtype,
            cached_prefix=adm.base, sampling=adm.sampling,
            prefill_s=prefill_s, replica=self.replica,
            adapter=adm.adapter, timing=timing)
        self._release_slot_storage(adm.slot)
        with self._lock:
            self._stats["handoffs_out"] += 1
            self._stats["handoff_bytes_out"] += handoff.nbytes()
            # a prefill engine's TTFT ring is its prefill latency: the
            # first token ships inside the handoff
            self._ttft_ring.append(prefill_s)
            if adm.adapter:
                self._adapter_labels_seen.add(adm.adapter)
        LLM_TTFT.observe(prefill_s,
                         exemplar=(adm.trace[0] if adm.trace else None),
                         replica=self.replica, adapter=adm.adapter)
        if not adm.future.done():
            adm.future.set_result(handoff)

    def generate(self, prompt_tokens, max_new_tokens: int = 64,
                 eos_id: int | None = None, timeout: float = 300.0,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, adapter: str = "",
                 request_key=None):
        """Synchronous convenience wrapper around submit()."""
        return self.submit(prompt_tokens, max_new_tokens, eos_id,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, adapter=adapter,
                           request_key=request_key).result(timeout=timeout)

    @property
    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            ttfts = sorted(self._ttft_ring)
            itls = sorted(self._itl_ring)
            ticks = sorted(self._tick_ring)
        if out["completed"]:
            out["ttft_avg_s"] = out["ttft_sum"] / out["completed"]
        if ttfts:
            out["ttft_p50_s"] = _percentile(ttfts, 0.50)
            out["ttft_p95_s"] = _percentile(ttfts, 0.95)
        if itls:
            out["itl_p50_s"] = _percentile(itls, 0.50)
            out["itl_p95_s"] = _percentile(itls, 0.95)
        if ticks:
            out["decode_tick_p50_s"] = _percentile(ticks, 0.50)
            out["decode_tick_p95_s"] = _percentile(ticks, 0.95)
        out["attention_impl"] = self.attention_impl
        out["prefill_impl"] = self.prefill_impl
        out["queue_depth"] = self._queue_depth()
        out["pressure_level"] = self.pressure_level()
        out["speculative_enabled"] = self.speculative_enabled
        if self._adapters is not None and self._owns_adapters:
            out.update(self._adapters.stats)
            out["adapter_live"] = self._adapters.live()
            out["adapter_resident"] = self._adapters.resident_names()
        if "spec_rounds" in out:
            out["acceptance_rate"] = (
                out["spec_accepted"] / out["spec_proposed"]
                if out["spec_proposed"] else 0.0)
            out["spec_tokens_per_round"] = (
                out["spec_tokens"] / out["spec_rounds"]
                if out["spec_rounds"] else 0.0)
        return out

    # -- scheduler ----------------------------------------------------------
    def _bucket_for(self, length: int) -> int:
        for bucket in self.prefill_buckets:
            if length <= bucket:
                return bucket
        return self.max_len

    def _first_token(self, logits, sampling: tuple) -> int:
        """Sample/argmax the first generated token from last-position
        logits [1, vocab]."""
        temperature, top_k, top_p = sampling
        if temperature > 0:
            from .sampling import sample_logits

            return int(sample_logits(logits, self._generator, [temperature],
                                     [top_k], [top_p])[0])
        return int(torch.argmax(logits, dim=-1)[0])

    def _run_prefill(self, adm: _Admission,
                     limit: int | None = None) -> bool:
        """Advance the admission's prefill by ONE dispatch: up to ``limit``
        prompt tokens (the whole remaining suffix, bucket-padded, when
        limit is None). The cursor starts at ``adm.base``. Returns True
        once the prompt is fully prefilled and the first token sampled."""
        if adm.ledger is not None and adm.ledger.current_phase != "prefill":
            # first chunk dispatch: the request is in prefill from here to
            # its first token, decode ticks between chunks included
            adm.ledger.enter("prefill")
        fire(FaultPoints.llm_prefill, request_id=adm.request_id,
             slot=adm.slot, offset=adm.offset, chunks=adm.chunks,
             replica=self.replica)
        prompt = adm.prompt
        total = len(prompt)
        start = adm.offset
        remaining = total - start
        cap = self.max_len - start
        if limit is None:
            # a bucket shape that still fits the cache tail
            pad_len = next(
                (b for b in self.prefill_buckets if remaining <= b <= cap),
                min(self._bucket_for(remaining), cap))
        else:
            pad_len = min(limit, cap)
        take = min(remaining, pad_len)
        padded = np.zeros((1, pad_len), np.int64)
        padded[0, :take] = prompt[start:start + take]
        adm.small["pos"] = torch.full((1,), start, dtype=torch.int32,
                                      device=self.device)
        lora_kw = self._lora_kwargs(adm.adapter_slot)
        logits, adm.small = self._prefill_dispatch(
            adm, torch.as_tensor(padded, device=self.device), lora_kw)
        adm.offset += take
        adm.chunks += 1
        with self._lock:
            self._stats["prefill_chunks"] += 1
            if take > self._stats["prefill_tokens_tick_max"]:
                self._stats["prefill_tokens_tick_max"] = take
        if adm.offset < total:
            return False
        if take != pad_len:
            # padding advanced pos past the prompt; replay the last real
            # token for its logits
            adm.small["pos"] = torch.full((1,), total - 1, dtype=torch.int32,
                                          device=self.device)
            logits, adm.small = self._prefill_dispatch(
                adm, torch.as_tensor([[prompt[-1]]], dtype=torch.long,
                                     device=self.device), lora_kw)
        if sampling_enabled():
            # monitoring tap: first-token top1-top2 logit gap. Only while
            # an observer is armed — one topk and one host copy, not paid
            # when dark
            row = logits.reshape(-1)
            if row.numel() >= 2:
                top2 = torch.topk(row, 2).values
                adm.logit_margin = float(top2[0] - top2[1])
        adm.first_token = self._first_token(logits, adm.sampling)
        return True

    def _prefill_dispatch(self, adm: _Admission, tokens, lora_kw: dict):
        """One prefill device dispatch for an admission (a chunk or the
        last-token replay) under its adapter (``lora_kw``). Hook: the
        paged engine routes prefix-hit admissions through the paged
        prefill kernel."""
        return _forward_with_cache(self.config, self.params, tokens,
                                   adm.small, attn_impl=self.prefill_impl,
                                   **lora_kw)

    def _activate_slot(self, adm: _Admission):
        """Fill slot bookkeeping after a successful prefill."""
        temperature, top_k, top_p = adm.sampling
        slot = self._slot_state[adm.slot]
        slot.request_id = adm.request_id
        slot.tokens = [adm.first_token]
        slot.remaining = adm.max_new - 1
        slot.eos_id = adm.eos_id
        slot.future = adm.future
        slot.started = adm.submitted
        slot.ttft = time.perf_counter() - adm.submitted
        slot.prompt_len = len(adm.prompt)
        slot.temperature = temperature
        slot.top_k = top_k
        slot.top_p = top_p
        slot.adapter = adm.adapter
        slot.adapter_slot = adm.adapter_slot
        slot.trace = adm.trace
        slot.ledger = adm.ledger
        slot.logit_margin = adm.logit_margin
        slot.decode_started = time.time()
        if adm.ledger is not None:
            # the row now waits for its first decode dispatch
            adm.ledger.enter("decode_stall")
        with self._lock:
            self._ttft_ring.append(slot.ttft)
            if adm.adapter:
                self._adapter_labels_seen.add(adm.adapter)
        LLM_TTFT.observe(slot.ttft,
                         exemplar=(adm.trace[0] if adm.trace else None),
                         replica=self.replica, adapter=adm.adapter)
        if (adm.eos_id is not None and adm.first_token == adm.eos_id) or \
                slot.remaining <= 0:
            self._finish(adm.slot)

    def _validate_item(self, item) -> bool:
        """Expiry and capacity checks on a dequeued request (submit()
        already rejects the too-long ones). Returns False, failing the
        future, when the item cannot be served."""
        prompt, max_new, future, submitted, expires = (
            item[1], item[2], item[4], item[5], item[7])
        if future.done():
            return False
        if self._request_expired(future, submitted, expires):
            return False
        if len(prompt) + max_new > self.max_len:
            future.set_exception(PromptTooLongError(
                f"prompt_len {len(prompt)} + max_new_tokens {max_new} "
                f"exceeds max_len {self.max_len}"))
            return False
        return True

    def _prepare_admission(self) -> Optional[_Admission]:
        """Claim a free slot + the next valid queued request and build its
        admission (a batch-1 prefill cache, cursor at 0). Hook: the paged
        engine reserves pages and matches the prefix cache."""
        free = next((i for i, s in enumerate(self._slot_state)
                     if not s.active), None)
        if free is None:
            return None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return None
            self._consume_budget(item[7])
            if not self._validate_item(item):
                continue
            (request_id, prompt, max_new, eos_id, future, submitted,
             sampling, expires, trace, extra, adapter, ledger) = item
            if ledger is not None:
                # claimed off the queue: queue_wait closes here
                ledger.enter("adapter_load_wait" if adapter
                             else "admission")
            adapter_slot = self._resolve_adapter(adapter, future)
            if ledger is not None and adapter:
                ledger.enter("admission")
            if adapter_slot is None:
                continue  # the adapter did not load: request failed typed
            try:
                adm = _Admission(
                    slot=free, request_id=request_id, prompt=prompt,
                    max_new=max_new, eos_id=eos_id, future=future,
                    submitted=submitted, sampling=sampling, expires=expires,
                    trace=trace, claimed=time.time(), adapter=adapter,
                    adapter_slot=adapter_slot, ledger=ledger)
                self._apply_directive(adm, extra)
                if adm.small is None:
                    adm.small = init_kv_cache(self.config, 1, self.max_len,
                                              kv_dtype=self.kv_dtype,
                                              device=self.device)
                return adm
            except Exception as exc:
                # dequeued but not yet tracked in self._admission: fail the
                # future before the scheduler dies, or it would hang
                if not future.done():
                    future.set_exception(exc)
                raise

    def _apply_directive(self, adm: _Admission, extra):
        """Fold the handoff directive of a queue item into a fresh
        admission: "export" marks a prefill-only request; a KVHandoff
        means the prefill ran elsewhere — import its KV and go straight to
        slot activation."""
        if extra == "export":
            adm.export = True
        elif isinstance(extra, KVHandoff):
            if adm.ledger is not None:
                # deserialize + storage completion: the decode side's
                # handoff
                adm.ledger.enter("handoff")
            adm.small = self._import_small(extra)
            adm.offset = len(adm.prompt)
            adm.first_token = int(extra.first_token)
            adm.prefilled = True
            adm.register_import = bool(getattr(extra, "prewarm", False))
            with self._lock:
                self._stats["handoffs_in"] += 1
                self._stats["handoff_bytes_in"] += int(extra.nbytes())

    def _finish_admission(self, adm: _Admission):
        small = adm.small
        self._complete_storage(adm)
        if adm.ledger is not None:
            adm.ledger.note("prefill_chunks", adm.chunks)
            if adm.base:
                adm.ledger.note("cached_prefix", adm.base)
        if adm.trace is not None and not adm.export:
            get_tracer().emit(
                "llm.prefill", adm.trace[0], adm.trace[1],
                start=adm.claimed, attrs={
                    "slot": adm.slot, "prompt_len": len(adm.prompt),
                    "chunks": adm.chunks, "cached_prefix": adm.base,
                    "imported": adm.prefilled, "exported": False,
                    "adapter": adm.adapter, "replica": self.replica})
        # one admission completed, on the flight ring
        flight_record("engine.admit", engine=self._obs_name,
                      request_id=adm.request_id,
                      prompt_len=len(adm.prompt), cached_prefix=adm.base,
                      chunks=adm.chunks, slot=adm.slot,
                      adapter=adm.adapter, export=bool(adm.export))
        if adm.export:
            # the storage hook consumed the batch-1 cache; the handoff
            # serializes it
            adm.small = small
            self._export_admission(adm)
            adm.small = None
            return
        if self.spec_enabled:
            self._spec_admit_slot(adm)
        self._activate_slot(adm)

    def _admit_one(self) -> bool:
        """Prefill one queued request into a free slot (True if admitted).
        The admission is tracked in ``self._admission`` while its prefill
        runs, so a crash mid-prefill still fails its future."""
        adm = self._prepare_admission()
        if adm is None:
            return False
        self._admission = adm
        if not adm.prefilled:
            self._run_prefill(adm, limit=None)
        self._finish_admission(adm)
        self._admission = None
        return True

    def _admission_tick(self):
        """Admission work for one scheduler iteration: with chunked
        prefill at most ONE <= prefill_chunk dispatch per tick; otherwise
        admit whole prompts until slots or queue run out. (max_wait is a
        queue-time budget, spent once the request is claimed.)"""
        if not self.prefill_chunk:
            while self._admit_one():
                pass
            return
        adm = self._admission
        if adm is None:
            adm = self._prepare_admission()
            if adm is None:
                return
            self._admission = adm
        if adm.prefilled or self._run_prefill(adm, limit=self.prefill_chunk):
            self._finish_admission(adm)
            self._admission = None

    def _ledger_mark(self, active: list, phase: str):
        """Flip every active slot's ledger into ``phase`` (the
        decode_active / decode_stall split around each dispatch)."""
        for i in active:
            ledger = self._slot_state[i].ledger
            if ledger is not None:
                ledger.enter(phase)

    def _finish(self, index: int):
        slot = self._slot_state[index]
        stats = {
            "ttft_s": slot.ttft,
            "generated": len(slot.tokens),
            "prompt_len": slot.prompt_len,
            "total_s": time.perf_counter() - slot.started,
        }
        timing = None
        if slot.ledger is not None:
            timing = slot.ledger.close()
            stats["timing"] = timing
            export_phases(timing, adapter=slot.adapter)
        with self._lock:
            self._stats["completed"] += 1
            self._stats["ttft_sum"] += slot.ttft
            self._stats["tokens_out"] += len(slot.tokens)
        if slot.trace is not None:
            attrs = {"slot": index, "generated": len(slot.tokens),
                     "replica": self.replica}
            if timing is not None:
                attrs["timing"] = timing
            get_tracer().emit("llm.decode", slot.trace[0], slot.trace[1],
                              start=slot.decode_started, attrs=attrs)
        if sampling_enabled():
            # monitoring tap: one bounded per-completion sample — output
            # token ids, lengths, latency, first-token logit margin
            emit_sample(adapter=slot.adapter, tokens=list(slot.tokens),
                        prompt_len=slot.prompt_len,
                        generated=len(slot.tokens), ttft_s=slot.ttft,
                        total_s=stats["total_s"],
                        logit_margin=slot.logit_margin,
                        engine=self._obs_name, replica=self.replica)
        future, tokens = slot.future, slot.tokens
        self._slot_state[index] = _Slot()
        self._release_slot_storage(index)
        if future is not None and not future.done():
            future.set_result((tokens, stats))

    def _decode_tick(self) -> int:
        active = [i for i, s in enumerate(self._slot_state) if s.active]
        if not active:
            return 0
        if self._spec_tick_viable(active):
            done = self._spec_decode_tick(active)
            if done is not None:
                return done
        if self.spec_enabled:
            # a plain tick advances the target without the draft: those
            # rows' draft caches go stale and resync on the next spec tick
            self._spec_stale.update(active)
        return self._plain_decode_tick(active)

    def _consume_budget(self, expires: float | None):
        """A budgeted item left the admission queue for good."""
        if expires is not None:
            with self._lock:
                self._budgeted = max(0, self._budgeted - 1)

    def _request_expired(self, future: Future, submitted: float,
                         expires: float | None) -> bool:
        """Fail a request whose queue-time budget is spent (a fast
        504-class failure instead of a future hanging)."""
        if expires is None or time.perf_counter() < expires:
            return False
        waited = time.perf_counter() - submitted
        with self._lock:
            self._stats["expired"] += 1
        future.set_exception(DeadlineExceeded(
            f"request spent {waited:.2f}s queued, over its max_wait "
            f"budget — engine overloaded"))
        return True

    def _expire_queued(self):
        """Sweep the admission queue for requests past their queue-time
        budget, every scheduler iteration, so queued requests fail within
        one tick of their budget even while every slot is busy. Free when
        no queued request carries a budget; atomic against submit(), so
        the drain and re-put never reorder a racing newcomer."""
        if self._budgeted <= 0 or self._queue.empty():
            return
        with self._lock:
            keep = []
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item[4].done() or self._request_expired(
                        item[4], item[5], item[7]):
                    self._consume_budget(item[7])
                else:
                    keep.append(item)
            for item in keep:  # FIFO order preserved
                self._queue.put(item)

    def _control_tick(self):
        """Scheduler-thread hook for control work that must not race a
        device dispatch (the paged engine runs its fetch_prefix /
        import_prefix ops here). Base engine: nothing."""

    def _loop(self):
        try:
            while self._running:
                # the ITL sample spans the whole iteration (admission
                # prefill included): an unchunked long prefill between two
                # decode ticks IS the inter-token gap clients see
                started = time.perf_counter()
                # on-demand profiling: claims or advances an armed capture
                # — one global check when dark
                profiler_tick(self._obs_name)
                # fail-slow injection seam: an armed delay() stretches
                # every scheduler iteration — TTFT and ITL rise, nothing
                # errors
                fire(FaultPoints.fleet_degrade, replica=self.replica,
                     engine=self._obs_name)
                self._expire_queued()
                self._control_tick()
                self._admission_tick()
                if not any(s.active for s in self._slot_state):
                    if self._admission is None:
                        time.sleep(0.002)  # idle: poll admissions at 2 ms
                    continue
                t_tick = time.perf_counter()
                # per-tenant ITL: one observation per adapter active in
                # the tick (captured before it: finished rows reset inside)
                tick_adapters = {s.adapter for s in self._slot_state
                                 if s.active}
                if self._decode_tick():
                    now = time.perf_counter()
                    elapsed, tick_s = now - started, now - t_tick
                    with self._lock:
                        self._itl_ring.append(elapsed)
                        self._tick_ring.append(tick_s)
                        self._adapter_labels_seen.update(
                            a for a in tick_adapters if a)
                    for tick_adapter in tick_adapters:
                        LLM_ITL.observe(elapsed, replica=self.replica,
                                        adapter=tick_adapter)
                    LLM_DECODE_TICK.observe(tick_s, replica=self.replica)
        except Exception as exc:  # noqa: BLE001 - a dead scheduler must
            # fail pending work loudly, not leave futures hanging forever
            logger.error("continuous batching scheduler died",
                         error=f"{type(exc).__name__}: {exc}")
            flight_record("engine.crash", engine=self._obs_name,
                          replica=self.replica, error=str(exc),
                          error_type=type(exc).__name__)
            self._running = False
            self._stopped = True
            self._crash_exc = exc
            self._fail_pending(exc)

    def _drain_queue(self, exc: Exception):
        """Fail every request still in the admission queue."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if not item[4].done():
                item[4].set_exception(exc)

    def _fail_pending(self, exc: Exception):
        failed = int(self._admission is not None) \
            + sum(1 for s in self._slot_state
                  if s.active and s.future is not None
                  and not s.future.done()) + self._queue.qsize()
        flight_record("engine.fail_pending", engine=self._obs_name,
                      replica=self.replica, failed=failed,
                      error_type=type(exc).__name__)
        if not isinstance(exc, EngineStoppedError):
            # a crash (not a clean stop) is a post-mortem moment: the
            # decision sequence into it is the debugging record
            get_flight_recorder().dump(
                "engine-crash", extra={"engine": self._obs_name,
                                       "error": str(exc)})
        adm, self._admission = self._admission, None
        if adm is not None:
            if not adm.future.done():
                adm.future.set_exception(exc)
            self._abort_admission(adm)
        with self._lock:
            self._budgeted = 0
        for i, slot in enumerate(self._slot_state):
            if not slot.active:
                continue
            if slot.future is not None and not slot.future.done():
                slot.future.set_exception(exc)
            self._slot_state[i] = _Slot()
            self._release_slot_storage(i)
        self._drain_queue(exc)
