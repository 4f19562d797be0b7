"""Paged KV cache for long-prompt serving — counterpart of
``mlrun_tpu/serving/paged.py``.

KV lives in a pool of fixed-size pages, mapped to slots through a page
table, so the pool is sized for the expected total tokens rather than
slots x max_len:

- pool:       {"k", "v"}: [layers, n_pages + 1, page_size, kv_heads,
  head_dim]; the LAST physical page is a scratch page, where writes for
  unmapped slots (-1 page ids) land;
- page_table: [slots, pages_per_slot] int32 (host numpy; -1 = unmapped);
- int8 pools: k/v as per-vector int8 with float32 scales ``k_scale`` /
  ``v_scale`` [layers, n_pages + 1, page_size, kv_heads];
- attention:  the kernel path reads the pool through the page table in
  place (decode: ``csrc/paged_decode.cu``; a prefix-cache hit's suffix
  prefill: ``csrc/paged_prefill.cu`` LSE-merged with the bounded
  ``csrc/flash_fwd_cached.cu``; a speculative round's verify chunk: the
  verify entry of ``csrc/paged_prefill.cu`` LSE-merged with the chunk's
  causal part; int8 pages dequantized in float32). The reference path
  gathers the slot's pages into a dense view per layer and runs the dense
  masked attention.
- page allocation is host-side bookkeeping on the scheduler thread.
- the host KV tier (``kv_tier=``, serving/kv_tier.py): an evicted prefix
  page demotes to pinned host memory, and an admission whose device match
  stops short promotes the next cached blocks back into its fresh pages,
  where the paged prefill kernel reads them like any prefix page.
  ``fetch_prefix`` / ``import_prefix`` move a cached chain between
  engines as a :class:`~.llm_batch.KVHandoff`.

Pages for prompt + max_new_tokens are reserved at admission, so decode can
never run out mid-generation. Full page-size blocks of each prompt are
indexed in a radix trie (serving/prefix.py); an admission shares the
longest cached chain read-only and prefills only the suffix. Refcount-0
pages stay cached until an allocation evicts them (LRU, leaf first).

Where the reference donated the pool to its jitted decode step, the port
updates the pool tensors in place.
"""

from __future__ import annotations

import functools
import queue
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from ..chaos import FaultPoints, fire
from ..config import SERVING_LLM_DEFAULTS
from ..models.llama import LlamaConfig, lm_head, logits_f32
from ..obs import KV_TIER_BYTES, KV_TIER_EVENTS, KV_TIER_HITS
from .kv_tier import HostKVTier
from .llm import (
    _cached_attention,
    _dequantize_kv,
    _forward_with_cache,
    _lora_rows,
    _out_and_mlp,
    _qkv,
    _quantize_kv,
    init_kv_cache,
)
from .llm_batch import (
    ContinuousBatchingEngine,
    KVHandoff,
    _Admission,
    _from_wire,
    _to_wire,
)
from .prefix import PrefixCache, block_chain_key


def init_paged_pool(config: LlamaConfig, n_pages: int, page_size: int,
                    kv_dtype: str = "native",
                    device: torch.device | str = "cpu") -> dict:
    """Page pool with ``n_pages`` physical pages (callers that need a
    scratch page pass n_pages + 1 and keep the last id off the free
    list). The int8 pool carries per-vector float32 scales ``k_scale`` /
    ``v_scale`` [L, n_pages, page_size, Hkv]."""
    if kv_dtype not in ("native", "int8"):
        raise ValueError(f"unknown kv_dtype '{kv_dtype}' (native | int8)")
    shape = (config.n_layers, n_pages, page_size, config.n_kv_heads,
             config.head_dim)
    if kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=config.dtype, device=device),
            "v": torch.zeros(shape, dtype=config.dtype, device=device)}


_POOL_NAMES = ("k", "v", "k_scale", "v_scale")


def _live_pages(page_ids):
    """(page indices, physical ids) of the entries >= 0 of a host id
    list, as index tensors."""
    ids = np.asarray(page_ids.cpu() if torch.is_tensor(page_ids)
                     else page_ids, np.int64)
    idx = np.nonzero(ids >= 0)[0]
    return torch.from_numpy(idx), torch.from_numpy(ids[idx])


def insert_prompt_pages(pool: dict, small: dict, page_ids,
                        page_size: int) -> dict:
    """Scatter a prefilled batch-1 slot cache (``small``, max_len a
    multiple of page_size) into the pool at ``page_ids`` ([pages_per_slot],
    host ints), scales included on int8 pools. Pages with id < 0 are
    skipped. In place; returns ``pool``."""
    idx, pid = _live_pages(page_ids)
    if idx.numel() == 0:
        return pool
    dev = pool["k"].device
    idx, pid = idx.to(dev), pid.to(dev)
    for name in _POOL_NAMES:
        if name not in pool:
            continue
        src = small[name][:, 0]                       # [L, M, Hkv(, D)]
        pages = src.reshape(src.shape[0], -1, page_size, *src.shape[2:])
        pool[name][:, pid] = pages[:, idx].to(pool[name].dtype)
    return pool


def gather_prefix_pages(pool: dict, small: dict, page_ids,
                        page_size: int) -> dict:
    """Inverse of :func:`insert_prompt_pages`: copy cached prefix pages
    (and their scales) from the pool into a batch-1 slot cache so a
    suffix-only prefill can attend over them. Ids < 0 leave the rows
    untouched. In place; returns ``small``."""
    idx, pid = _live_pages(page_ids)
    if idx.numel() == 0:
        return small
    dev = small["k"].device
    idx, pid = idx.to(dev), pid.to(dev)
    for name in _POOL_NAMES:
        if name not in pool or name not in small:
            continue
        dst = small[name][:, 0]                       # [L, M, Hkv(, D)]
        pages = dst.view(dst.shape[0], -1, page_size, *dst.shape[2:])
        pages[:, idx] = pool[name][:, pid].to(dst.dtype)
    return small


def _write_token_all_layers(pool: dict, k_tok, v_tok, page_table, pos,
                            page_size: int, scales=None) -> dict:
    """k_tok/v_tok: [L, slots, Hkv, D] (int8 pools: the quantized values,
    with ``scales`` = (k_scale, v_scale) [L, slots, Hkv]); write each
    slot's token into its current page at pos % page_size (unmapped slots
    write to the scratch page, which is never read). In place; returns
    ``pool``."""
    scratch = pool["k"].shape[1] - 1
    pos = pos.long()
    pid = torch.gather(page_table.long(), 1, (pos // page_size)[:, None])[:, 0]
    pid_safe = torch.where(pid >= 0, pid, torch.full_like(pid, scratch))
    offset = pos % page_size
    rows = {"k": k_tok, "v": v_tok}
    if scales is not None:
        rows["k_scale"], rows["v_scale"] = scales
    for name, row in rows.items():
        pool[name][:, pid_safe, offset] = row.to(pool[name].dtype)
    return pool


def _decode_rowwise_paged(config: LlamaConfig, page_size: int,
                          attn_impl: str, params, tokens: torch.Tensor,
                          pool: dict, page_table: torch.Tensor,
                          pos: torch.Tensor, generator=None,
                          temperature=None, top_k=None, top_p=None,
                          lora=None, adapter_ids=None):
    """One decode token per slot against the page pool.

    ``attn_impl="reference"``: per layer, gather the slot's pages into a
    dense [slots, max_len] view (int8 pools: dequantized, then rounded to
    ``config.dtype``), splice the just-computed token into it, and run the
    dense masked attention; the tokens' KV is written to the pool once,
    for all layers, at the end.

    ``attn_impl="kernel"``: per layer, write the token's KV into the pool
    FIRST (int8 pools quantize it per vector on the way in), then run the
    paged-decode kernel, which reads the pool through the page table and
    dequantizes int8 pages in float32 (CPU tensors take its plain
    version). Both paths store identical bits at identical positions
    (they share one ``_quantize_kv``).

    tokens [slots, 1]; page_table [slots, pages_per_slot] int32; pos
    [slots] int32 absolute positions (all on the pool's device). The pool
    is updated IN PLACE (the reference donates it to the jitted step).
    ``lora``/``adapter_ids`` add per-row multi-tenant LoRA: each slot's
    projections take its own adapter from the bank by slot index (0 =
    base model), gathered once for the tick; the attention route is the
    same either way. Returns (next_token [slots] int32, pool, pos + 1)."""
    from ..ops.norms import rms_norm
    from ..ops.paged_attention import _paged_decode_call
    from ..ops.rotary import apply_rope, rope_table
    from .sampling import sample_logits

    b = tokens.shape[0]
    positions = pos.long()[:, None]
    x = params["embedding"][tokens].to(config.dtype)
    cos, sin = rope_table(positions, config.head_dim, config.rope_theta)
    quantized = "k_scale" in pool
    use_kernel = attn_impl == "kernel"
    rows = torch.arange(b, device=tokens.device)
    if use_kernel:
        scratch = pool["k"].shape[1] - 1
        pid = torch.gather(page_table.long(), 1,
                           (positions // page_size))[:, 0]
        pid_safe = torch.where(pid >= 0, pid, torch.full_like(pid, scratch))
        offset = positions[:, 0] % page_size
    else:
        safe_table = page_table.long().clamp_min(0)
    lora_rows = _lora_rows(lora, adapter_ids)

    k_new, v_new = [], []
    for layer in range(config.n_layers):
        lp = {name: w[layer] for name, w in params["layers"].items()}
        h = rms_norm(x, lp["attn_norm_scale"], config.norm_eps)
        q, k, v = _qkv(config, h, lp, lora_rows, layer)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if use_kernel:
            # token KV lands in the pool first (unmapped slots route to
            # the never-read scratch page), then the kernel attends
            # pool-side through the page table — no dense view, no gather
            for name, t in (("k", k[:, 0]), ("v", v[:, 0])):
                if quantized:
                    t, scales = _quantize_kv(t)
                    pool[f"{name}_scale"][layer, pid_safe, offset] = scales
                pool[name][layer, pid_safe, offset] = t.to(pool[name].dtype)
            scales_kw = ({"k_scale": pool["k_scale"][layer],
                          "v_scale": pool["v_scale"][layer]}
                         if quantized else {})
            attn = _paged_decode_call(
                q[:, 0].contiguous(), pool["k"][layer], pool["v"][layer],
                page_table, pos, page_size, **scales_kw)[:, None]
        else:
            # dense per-layer view of each slot's pages, with the new token
            # spliced in at each slot's position
            views = []
            for name in ("k", "v"):
                view = pool[name][layer][safe_table]  # [slots, pps, ps, ...]
                view = view.reshape(b, -1, *view.shape[3:])
                if quantized:
                    scale = pool[f"{name}_scale"][layer][safe_table]
                    view = _dequantize_kv(
                        view, scale.reshape(b, -1, scale.shape[-1]),
                        config.dtype)
                views.append(view.to(config.dtype))
            kd, vd = views
            kd[rows, positions[:, 0]] = k[:, 0]
            vd[rows, positions[:, 0]] = v[:, 0]
            attn = _cached_attention(config, q, kd, vd, positions,
                                     kd.shape[1])
            k_new.append(k[:, 0])
            v_new.append(v[:, 0])
        x = _out_and_mlp(config, x, attn, lp, lora_rows, layer)

    x = rms_norm(x, params["final_norm_scale"], config.norm_eps)
    logits = logits_f32(x[:, 0], lm_head(params))
    if generator is None:
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        next_token = sample_logits(logits, generator, temperature, top_k,
                                   top_p)
    if not use_kernel:
        # one pooled write for all layers: [L, slots, Hkv, D]
        k_tok, v_tok = torch.stack(k_new), torch.stack(v_new)
        scales = None
        if quantized:
            (k_tok, k_scale), (v_tok, v_scale) = (_quantize_kv(k_tok),
                                                  _quantize_kv(v_tok))
            scales = (k_scale, v_scale)
        _write_token_all_layers(pool, k_tok, v_tok, page_table, pos,
                                page_size, scales=scales)
    return next_token, pool, pos + 1


def _verify_rowwise_paged(config: LlamaConfig, page_size: int,
                          attn_impl: str, params, chunk: torch.Tensor,
                          pool: dict, page_table: torch.Tensor,
                          pos: torch.Tensor, lora=None, adapter_ids=None):
    """Batched multi-token speculative verify against the page pool:
    ``chunk`` [slots, S] is each slot's committed last token plus its
    draft proposals at positions ``pos[r]..pos[r]+S-1``; ONE forward gives
    the target's argmax at all S positions of every slot.

    Per layer the chunk's KV is written into the pool through the page
    table first (int8 pools quantize it per vector). ``attn_impl=
    "kernel"``: the verify kernel attends each slot's prefix pages in
    place, LSE-merged with the chunk's causal part over itself — which
    on int8 pools sees the chunk's dequantized values, the bits a later
    decode tick reads back. ``"reference"``: the dense-view verify, which
    splices the raw chunk KV into the dequantized view, as the reference
    decode path does.

    Rollback is the host's position rewind: chunk lanes inside a slot's
    reservation overwrite entries past its committed position, which no
    query reads before they are written again; lanes past the
    reservation (rows speculating fewer tokens this round) go to the
    scratch page. ``pos`` is not advanced here. The pool is updated IN
    PLACE. ``lora``/``adapter_ids``: each slot's own (target) adapter, as
    in :func:`_decode_rowwise_paged`. Returns (verified [slots, S] int32,
    pool)."""
    from ..ops.norms import rms_norm
    from ..ops.paged_attention import (
        paged_verify_merged,
        paged_verify_reference,
    )
    from ..ops.rotary import apply_rope, rope_table

    b, s = chunk.shape
    pps = page_table.shape[1]
    positions = pos.long()[:, None] + torch.arange(
        s, device=chunk.device)[None, :]                    # [slots, S]
    x = params["embedding"][chunk].to(config.dtype)
    cos, sin = rope_table(positions, config.head_dim, config.rope_theta)
    quantized = "k_scale" in pool
    use_kernel = attn_impl == "kernel"
    scratch = pool["k"].shape[1] - 1
    page_idx = positions // page_size
    offset = positions % page_size
    # torch.gather raises past the table where jnp.take_along_axis clamps:
    # clamp first, then route every lane past the reservation to scratch
    pid = torch.gather(page_table.long(), 1, page_idx.clamp_max(pps - 1))
    pid_safe = torch.where((pid >= 0) & (page_idx < pps), pid,
                           torch.full_like(pid, scratch))
    verify = paged_verify_merged if use_kernel else paged_verify_reference
    lora_rows = _lora_rows(lora, adapter_ids)

    for layer in range(config.n_layers):
        lp = {name: w[layer] for name, w in params["layers"].items()}
        h = rms_norm(x, lp["attn_norm_scale"], config.norm_eps)
        q, k, v = _qkv(config, h, lp, lora_rows, layer)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        chunk_kv = [k, v]
        for i, (name, t) in enumerate((("k", k), ("v", v))):
            if quantized:
                t, scales = _quantize_kv(t)
                pool[f"{name}_scale"][layer, pid_safe, offset] = scales
                if use_kernel:
                    chunk_kv[i] = _dequantize_kv(t, scales, config.dtype)
            pool[name][layer, pid_safe, offset] = t.to(pool[name].dtype)
        scales_kw = ({"k_scale": pool["k_scale"][layer],
                      "v_scale": pool["v_scale"][layer]}
                     if quantized else {})
        attn = verify(q, *chunk_kv, pool["k"][layer], pool["v"][layer],
                      page_table, pos, page_size=page_size, **scales_kw)
        x = _out_and_mlp(config, x, attn.to(x.dtype), lp, lora_rows, layer)

    x = rms_norm(x, params["final_norm_scale"], config.norm_eps)
    logits = logits_f32(x, lm_head(params))
    return torch.argmax(logits, dim=-1).to(torch.int32), pool


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching over a paged KV pool.

    Same scheduler contract as the reference engine (submit / generate /
    start / stop / warmup / stats), with slot KV in a shared page pool:
    ``n_pages`` defaults to the dense equivalent (slots x pages_per_slot);
    size it smaller to oversubscribe memory. Pages for prompt + max_new are
    reserved at admission; requests wait, in order, until enough pages are
    free.

    ``kv_dtype="int8"`` keeps the pool as per-vector int8 with float32
    scales (about half the bytes a page); the kernels dequantize in
    float32. ``speculative`` (a dict with ``draft_config`` /
    ``draft_params`` and the config keys) turns on in-engine speculative
    decoding: each greedy tick runs the draft's k steps and one verify
    forward over the pool (``_verify_rowwise_paged``).

    ``adapters`` serves named LoRA adapters per slot, as in the base
    engine; the prefix cache keeps one root per adapter, so a prefix hit
    only ever shares KV computed under the same adapter, and a hit's
    suffix prefill runs under the slot's adapter on the same kernels.

    ``kv_tier`` (True / False / ``{"host_bytes": ...}`` / None = the
    config's default, off) keeps evicted prefix pages in a bounded host
    tier and promotes them back on admission; a failed demote or promote
    falls back to token prefill, never a client error. The degradation
    ladder's ``min_free_page_frac`` reads the free-page fraction
    (reclaimable prefix pages count as free).

    ``device`` defaults to the GPU (and raises without one); pass
    ``device="cpu"`` for the plain paths.
    """

    def __init__(self, config: LlamaConfig, params, max_len: int = 2048,
                 slots: int = 4, prefill_buckets: tuple = (128, 512, 1024),
                 seed: int = 0, kv_dtype: str = "native",
                 page_size: int = 128, n_pages: int | None = None,
                 max_queue_size: int = 0, max_wait: float = 0.0,
                 degradation: dict | None = None,
                 prefill_chunk: int | None = None,
                 latency_window: int | None = None,
                 prefix_cache: bool | None = None,
                 attention_impl: str | None = None,
                 speculative: dict | None = None, adapters=None,
                 max_live_adapters: int | None = None,
                 adapter_rate: float | None = None,
                 adapter_burst: float | None = None,
                 request_ledger: bool | None = None, kv_tier=None,
                 device=None):
        from ..ops.paged_attention import resolve_paged_impl

        if max_len % page_size:
            raise ValueError(
                f"max_len {max_len} must be a multiple of page_size "
                f"{page_size} (a partial last page would misalign KV rows)")
        # set before super().__init__ — _make_cache runs during it
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        self.n_pages = n_pages or slots * self.pages_per_slot
        self.kv_dtype = kv_dtype
        self._pending: deque = deque()
        if prefix_cache is None:
            prefix_cache = bool(SERVING_LLM_DEFAULTS["prefix_cache"])
        self._prefix = PrefixCache(page_size) if prefix_cache else None
        # trie nodes each slot holds a refcount on (matched + registered)
        self._slot_prefix_nodes: dict[int, list] = {}
        # the host KV tier: True / False, a config-style dict (an explicit
        # dict opts in unless it says otherwise), or None (the config
        # decides); it needs the prefix cache
        tier_conf = dict(SERVING_LLM_DEFAULTS["kv_tier"])
        if isinstance(kv_tier, dict):
            tier_conf.update(kv_tier)
            kv_tier = kv_tier.get("enabled", True)
        elif kv_tier is None:
            kv_tier = tier_conf.get("enabled", False)
        self._kv_tier = (HostKVTier(int(tier_conf.get("host_bytes",
                                                      64 << 20)))
                         if kv_tier and self._prefix is not None else None)
        # fetch_prefix / import_prefix ops queue here and run on the
        # scheduler thread between ticks (_control_tick): the pool is
        # written by every dispatch, so it is never touched off-thread
        self._control: deque = deque()
        super().__init__(config, params, max_len=max_len, slots=slots,
                         prefill_buckets=prefill_buckets, seed=seed,
                         kv_dtype=kv_dtype, max_queue_size=max_queue_size,
                         max_wait=max_wait, degradation=degradation,
                         prefill_chunk=prefill_chunk,
                         latency_window=latency_window,
                         attention_impl=attention_impl,
                         speculative=speculative, adapters=adapters,
                         max_live_adapters=max_live_adapters,
                         adapter_rate=adapter_rate,
                         adapter_burst=adapter_burst,
                         request_ledger=request_ledger, device=device)
        # decode: the paged kernel or the gather+dense reference, resolved
        # from the same knob as the prefill path; an explicit kernel
        # request on the CPU raised KernelUnavailableError inside
        self.attn_impl = resolve_paged_impl(self.attention_impl, self.device)
        # prefix-hit suffix prefill: "kernel" attends the cached prefix
        # pages in place (paged prefill kernel LSE-merged with the bounded
        # flash); "gather" copies them densely into the slot cache first
        self.paged_prefill_impl = (
            "kernel" if self.prefill_impl == "flash" else "gather")
        if self.attn_impl == "kernel" or self.prefill_impl == "flash":
            from ..ops import _build

            _build.library()  # build now: a kernel fault surfaces here
        self._page_table = np.full((slots, self.pages_per_slot), -1, np.int32)
        self._pos = np.zeros((slots,), np.int32)
        self._free_pages: deque = deque(range(self.n_pages))
        self._slot_pages: dict[int, list] = {}
        # bytes the gather path would copy per decode tick (the dense k+v
        # view of every slot, all layers) — what the kernel path avoids
        self._gather_bytes_per_tick = (
            2 * config.n_layers * slots * max_len * config.n_kv_heads
            * config.head_dim * self._pool["k"].element_size())
        self._stats.update({"attn_kernel_ticks": 0, "attn_gather_ticks": 0,
                            "attn_hbm_bytes_avoided": 0,
                            "prefill_kernel_chunks": 0,
                            "prefill_gather_admissions": 0,
                            "kv_demotes": 0, "kv_demoted_pages": 0,
                            "kv_promotes": 0, "kv_promoted_pages": 0,
                            "kv_fetches": 0, "kv_fetched_pages": 0,
                            "kv_imports": 0, "kv_imported_pages": 0})

    def _make_cache(self):
        # +1 physical page: the scratch page for masked writes
        self._pool = init_paged_pool(self.config, self.n_pages + 1,
                                     self.page_size, self.kv_dtype,
                                     device=self.device)
        return None  # slot KV lives in the page pool

    def _warmup_storage(self):
        """Warm the prefix-hit prefill (all -1 ids: the scratch page) and
        one decode tick over an all-unmapped table; the writes land on the
        scratch page and behind pos 0, never on a live page."""
        if self._prefix is not None and self.paged_prefill_impl == "kernel":
            ids = torch.full((self.pages_per_slot,), -1, dtype=torch.int32,
                             device=self.device)
            prefix_kv = self._prefix_kv(ids, self.page_size)
            small = init_kv_cache(self.config, 1, self.max_len,
                                  kv_dtype=self.kv_dtype, device=self.device)
            small["pos"].fill_(self.page_size)
            tokens = torch.zeros((1, self.prefill_buckets[0]),
                                 dtype=torch.long, device=self.device)
            _forward_with_cache(self.config, self.params, tokens, small,
                                prefix_kv=prefix_kv,
                                attn_impl=self.prefill_impl,
                                page_size=self.page_size,
                                **self._lora_kwargs(0))
        table = torch.as_tensor(self._page_table, device=self.device)
        pos = torch.as_tensor(self._pos, device=self.device)
        step = torch.zeros((self.slots, 1), dtype=torch.long,
                           device=self.device)
        _decode_rowwise_paged(self.config, self.page_size, self.attn_impl,
                              self.params, step, self._pool, table, pos,
                              **self._lora_kwargs())

    # -- admission: page reservation + prefix reuse -------------------------
    def _free_page_frac(self) -> float:
        """KV-page headroom for the degradation ladder: it degrades
        (speculation off, max_new clamped) before admission would block on
        an exhausted pool. Refcount-0 cached prefix pages are reclaimable,
        so they count as free."""
        if not self.n_pages:
            return 1.0
        free = len(self._free_pages)
        if self._prefix is not None:
            free += self._prefix.evictable_pages()
        return free / self.n_pages

    def _queue_depth(self) -> int:
        return self._queue.qsize() + len(self._pending)

    def _expire_queued(self):
        super()._expire_queued()
        # head-of-line requests parked waiting for pages carry their
        # queue-time budget too
        while self._pending and (self._pending[0][4].done()
                                 or self._request_expired(
                                     self._pending[0][4],
                                     self._pending[0][5],
                                     self._pending[0][7])):
            self._pending.popleft()

    def _reclaim_pages(self, needed: int):
        """Evict LRU refcount-0 cached prefix pages until the free list
        covers ``needed`` pages, firing ``llm.prefix_evict`` per evicted
        page. With the host tier each victim demotes first; a failed
        demote loses the chain to the tier but never blocks the
        reclaim."""
        if self._prefix is None or len(self._free_pages) >= needed:
            return
        tier = self._kv_tier
        # a node does not know its adapter: recover it from the root its
        # chain hangs off (one map per reclaim)
        root_adapters = {id(root): name for name, root
                         in self._prefix._roots.items()} \
            if tier is not None else None

        def on_evict(node):
            fire(FaultPoints.llm_prefix_evict, page_id=node.page_id,
                 refcount=node.refcount, last_used=node.last_used)
            if tier is None:
                return
            try:
                self._demote_node(node, root_adapters)
            except Exception:  # noqa: BLE001 - demote is best effort: the
                # page is reclaimed either way
                with self._lock:
                    self._stats["kv_demotes"] += 1
                KV_TIER_EVENTS.inc(engine=self._obs_name,
                                   replica=self.replica, op="demote",
                                   outcome="error")

        freed = self._prefix.evict(needed - len(self._free_pages),
                                   on_evict)
        self._free_pages.extend(freed)

    def _host_page(self, page_id: int) -> dict:
        """A copy of one pool page (every layer, scales included) in host
        memory, pinned when the pool is on the card: the tier's payload."""
        pinned = self._pool["k"].device.type == "cuda"
        out = {}
        for name, arr in self._pool.items():
            src = arr[:, page_id]
            dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=pinned)
            out[name] = dst.copy_(src)
        return out

    def _demote_node(self, node, root_adapters: dict):
        """Copy one eviction victim's page host-side into the tier, keyed
        by its block-chain identity (chaos ``llm.kv_demote``). Eviction is
        leaf-first, so a chain demotes child before parent; the tier's
        ancestors-outlive-descendants eviction keeps probes hole-free."""
        blocks = []
        cur = node
        while cur.parent is not None:
            blocks.append(cur.block)
            cur = cur.parent
        adapter = root_adapters.get(id(cur), "")
        blocks.reverse()
        flat = [t for block in blocks for t in block]
        key = block_chain_key(flat, self.page_size, adapter=adapter)
        parent_key = block_chain_key(
            flat[:-self.page_size], self.page_size, adapter=adapter) \
            if len(blocks) > 1 else None
        fire(FaultPoints.llm_kv_demote, key=key, page_id=node.page_id,
             blocks=len(blocks), adapter=adapter)
        stored = self._kv_tier.put(key, parent_key,
                                   self._host_page(node.page_id))
        with self._lock:
            self._stats["kv_demotes"] += 1
            if stored:
                self._stats["kv_demoted_pages"] += 1
        KV_TIER_EVENTS.inc(engine=self._obs_name, replica=self.replica,
                           op="demote",
                           outcome="ok" if stored else "fallback")
        KV_TIER_BYTES.set(self._kv_tier.bytes_used,
                          engine=self._obs_name, replica=self.replica)

    def _tier_probe(self, prompt, adapter: str, k: int) -> list:
        """Consecutive host-tier payloads for the blocks just past the
        first ``k`` device-matched ones, probed root-down and stopped at
        the first miss. Same cap as ``PrefixCache.match``: at least one
        suffix token always remains to prefill."""
        limit = max(0, (len(prompt) - 1) // self.page_size)
        hits: list = []
        for i in range(k, limit):
            payload = self._kv_tier.get(block_chain_key(
                prompt[:(i + 1) * self.page_size], self.page_size,
                adapter=adapter))
            if payload is None:
                break
            hits.append(payload)
        return hits

    def _tier_import(self, hits: list, ids, k: int) -> int:
        """Copy probed host-tier payloads into the admission's reserved
        fresh pages (the page table already points at them): the pages
        come back bit-identical to what was demoted (chaos
        ``llm.kv_promote``). Returns the number of promoted blocks."""
        fire(FaultPoints.llm_kv_promote, blocks=len(hits), base_blocks=k)
        for n, payload in enumerate(hits):
            pid = int(ids[k + n])
            for name, arr in self._pool.items():
                arr[:, pid].copy_(payload[name])
        with self._lock:
            self._stats["kv_promotes"] += 1
            self._stats["kv_promoted_pages"] += len(hits)
        KV_TIER_EVENTS.inc(engine=self._obs_name, replica=self.replica,
                           op="promote", outcome="ok")
        KV_TIER_HITS.inc(len(hits), engine=self._obs_name,
                         replica=self.replica, tier="host")
        return len(hits)

    # -- cached prefixes between engines ------------------------------------
    def fetch_prefix(self, prompt_tokens, adapter: str = "") -> Future:
        """Assemble this engine's cached KV for ``prompt_tokens``'s leading
        full blocks (device pages first, then the host tier) into a
        prefix-only :class:`KVHandoff` another engine imports with
        :meth:`import_prefix` instead of prefilling. Resolves to None when
        nothing is cached. Runs on the scheduler thread between ticks."""
        future: Future = Future()
        self._control.append(("fetch", (list(prompt_tokens), adapter),
                              future))
        if not self._running:
            self.start()
        return future

    def import_prefix(self, handoff: KVHandoff) -> Future:
        """Import a :meth:`fetch_prefix` payload's full blocks into the
        page pool and the prefix index without admitting a request.
        Resolves to the number of newly cached pages (0 = already cached,
        or no page free). A payload from a pool of another dtype raises
        ``ValueError``."""
        expects_scales = self.kv_dtype == "int8"
        wire_dtype = getattr(handoff, "kv_dtype", None) or (
            "int8" if "k_scale" in handoff.kv else "native")
        if wire_dtype != self.kv_dtype or \
                ("k_scale" in handoff.kv) != expects_scales:
            raise ValueError(
                f"KV handoff dtype mismatch: engine kv_dtype="
                f"'{self.kv_dtype}' cannot import a '{wire_dtype}' "
                f"payload — fetch and import pools must quantize alike")
        future: Future = Future()
        self._control.append(("import", (handoff,), future))
        if not self._running:
            self.start()
        return future

    def _control_tick(self):
        while self._control:
            kind, args, future = self._control.popleft()
            if future.done():
                continue
            try:
                if kind == "fetch":
                    future.set_result(self._do_fetch_prefix(*args))
                else:
                    future.set_result(self._do_import_prefix(*args))
            except Exception as exc:  # noqa: BLE001 - a control op fails
                # its own future, never the scheduler
                future.set_exception(exc)

    def _do_fetch_prefix(self, prompt, adapter: str):
        if self._prefix is None:
            return None
        matched_pages, nodes = self._prefix.match(prompt, adapter=adapter)
        k = len(matched_pages)
        tier_rows: list = []
        try:
            parts: dict = {name: [] for name in self._pool}
            if k:
                pids = torch.as_tensor(matched_pages, dtype=torch.long,
                                       device=self._pool["k"].device)
                for name, arr in self._pool.items():
                    rows = arr[:, pids]
                    parts[name].append(rows.reshape(
                        rows.shape[0], k * self.page_size,
                        *rows.shape[3:]).cpu())
            if self._kv_tier is not None:
                tier_rows = self._tier_probe(prompt, adapter, k)
            for payload in tier_rows:
                for name in self._pool:
                    parts[name].append(payload[name])
        finally:
            self._prefix.release(nodes)
        total = k + len(tier_rows)
        if not total:
            KV_TIER_EVENTS.inc(engine=self._obs_name,
                               replica=self.replica, op="fetch",
                               outcome="miss")
            return None
        kv = {name: _to_wire(torch.cat(chunks, dim=1))
              for name, chunks in parts.items()}
        rows_tok = total * self.page_size
        handoff = KVHandoff(
            prompt=list(prompt[:rows_tok]), first_token=-1, kv=kv,
            prompt_len=rows_tok, kv_dtype=self.kv_dtype,
            cached_prefix=rows_tok, replica=self.replica,
            adapter=adapter, prewarm=True)
        with self._lock:
            self._stats["kv_fetches"] += 1
            self._stats["kv_fetched_pages"] += total
        KV_TIER_EVENTS.inc(engine=self._obs_name, replica=self.replica,
                           op="fetch", outcome="ok")
        return handoff

    def _do_import_prefix(self, handoff: KVHandoff) -> int:
        if self._prefix is None:
            return 0
        prompt = list(handoff.prompt)
        full = min(len(prompt), handoff.prompt_len) // self.page_size
        full = min(full, self.pages_per_slot)
        if full <= 0:
            return 0
        adapter = handoff.adapter
        # a fetch payload is exactly full blocks; match() always leaves one
        # suffix token unmatched, so probe with a sentinel token to see
        # every cached block (the sentinel is never indexed)
        _, nodes = self._prefix.match(prompt + [0], adapter=adapter)
        k = len(nodes)
        fresh: list = []
        try:
            need = full - k
            if need > 0:
                self._reclaim_pages(need)
            if need > len(self._free_pages):
                # a partial import stays contiguous root-down
                need = len(self._free_pages)
                full = k + need
            if need <= 0:
                return 0
            fresh = [self._free_pages.popleft() for _ in range(need)]
            ids = np.full((self.pages_per_slot,), -1, np.int32)
            ids[k:full] = fresh
            pids = torch.as_tensor(fresh, dtype=torch.long,
                                   device=self._pool["k"].device)
            for name, arr in self._pool.items():
                payload = _from_wire(handoff.kv[name][
                    :, k * self.page_size:full * self.page_size])
                payload = payload.reshape(payload.shape[0], need,
                                          self.page_size,
                                          *payload.shape[2:])
                arr[:, pids] = payload.to(device=arr.device,
                                          dtype=arr.dtype)
            new_nodes, claimed = self._prefix.register(
                prompt[:full * self.page_size], ids, nodes,
                adapter=adapter)
            claimed_set = set(claimed)
            self._free_pages.extend(p for p in fresh
                                    if p not in claimed_set)
            fresh = []
            nodes = nodes + new_nodes
            with self._lock:
                self._stats["kv_imports"] += 1
                self._stats["kv_imported_pages"] += len(claimed)
            KV_TIER_HITS.inc(len(claimed), engine=self._obs_name,
                             replica=self.replica, tier="remote")
            return len(claimed)
        except Exception:
            self._free_pages.extend(fresh)
            raise
        finally:
            self._prefix.release(nodes)

    def _remove_kv_tier_series(self):
        """Drop this engine's hierarchical-KV series on stop."""
        labels = {"engine": self._obs_name, "replica": self.replica}
        KV_TIER_BYTES.remove(**labels)
        for tier in ("device", "host", "remote"):
            KV_TIER_HITS.remove(tier=tier, **labels)
        for op in ("demote", "promote", "fetch"):
            for outcome in ("ok", "miss", "fallback", "error"):
                KV_TIER_EVENTS.remove(op=op, outcome=outcome, **labels)

    def _unregister_metrics(self):
        super()._unregister_metrics()
        self._remove_kv_tier_series()

    def _prepare_admission(self) -> _Admission | None:
        free = next((i for i, s in enumerate(self._slot_state)
                     if not s.active), None)
        if free is None:
            return None
        while True:
            if not self._pending:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    return None
                # the item left the admission queue; the head-of-line sweep
                # in _expire_queued tracks it from here
                self._consume_budget(item[7])
                self._pending.append(item)
            item = self._pending[0]
            if not self._validate_item(item):
                self._pending.popleft()
                continue
            (request_id, prompt, max_new, eos_id, future, submitted,
             sampling, expires, trace, extra, adapter, ledger) = item
            imported = isinstance(extra, KVHandoff)
            needed = -(-(len(prompt) + max_new) // self.page_size)
            if needed > self.n_pages:
                # would never fit — fail fast instead of blocking the
                # queue head forever
                self._pending.popleft()
                future.set_exception(ValueError(
                    f"request needs {needed} pages but the pool has only "
                    f"{self.n_pages}; raise n_pages or lower "
                    f"max_new_tokens"))
                continue
            matched_pages: list = []
            matched_nodes: list = []
            # an imported handoff arrives with its whole prompt's KV, so it
            # takes fresh pages. Matching is per ADAPTER root: KV computed
            # under adapter A is never served to adapter B
            if self._prefix is not None and not imported:
                matched_pages, matched_nodes = self._prefix.match(
                    prompt, adapter=adapter)
            k = len(matched_pages)
            fresh_needed = needed - k
            available = len(self._free_pages)
            if self._prefix is not None:
                available += self._prefix.evictable_pages()
            if available < fresh_needed:
                # head-of-line waits for pages (in order); drop the match
                # holds so the cached prefix stays evictable meanwhile (the
                # ledger keeps charging queue_wait)
                if self._prefix is not None:
                    self._prefix.release(matched_nodes)
                return None
            if ledger is not None and adapter:
                ledger.enter("adapter_load_wait")
            adapter_slot = self._resolve_adapter(adapter, future)
            if adapter_slot is None:
                # the adapter did not load: the request failed typed;
                # release the match holds and move on
                if self._prefix is not None:
                    self._prefix.release(matched_nodes)
                self._pending.popleft()
                continue
            if ledger is not None:
                # claimed for good: page reservation and the prefix work
                # below are admission
                ledger.enter("admission")
            self._pending.popleft()
            fresh: list = []
            try:
                if self._prefix is not None and not imported:
                    self._prefix.queries += 1
                    if k:
                        self._prefix.hits += 1
                        self._prefix.cached_tokens += k * self.page_size
                        if self._kv_tier is not None:
                            KV_TIER_HITS.inc(
                                k, engine=self._obs_name,
                                replica=self.replica, tier="device")
                self._reclaim_pages(fresh_needed)
                fresh = [self._free_pages.popleft()
                         for _ in range(fresh_needed)]
                ids = np.full((self.pages_per_slot,), -1, np.int32)
                ids[:k] = matched_pages
                ids[k:needed] = fresh
                # host-tier promote: blocks just past the device match that
                # sit in the host tier are copied into their reserved fresh
                # pages instead of prefilled from tokens. A failed promote
                # falls back to token prefill over the same pages — never a
                # client error
                if self._kv_tier is not None and k < needed \
                        and not imported:
                    hits = self._tier_probe(prompt, adapter, k)
                    if hits:
                        if ledger is not None:
                            ledger.enter("promote")
                        try:
                            promoted = self._tier_import(hits, ids, k)
                            new_nodes, claimed = self._prefix.register(
                                prompt[:(k + promoted) * self.page_size],
                                ids, matched_nodes, adapter=adapter)
                            matched_nodes = matched_nodes + new_nodes
                            if claimed:
                                claimed_set = set(claimed)
                                fresh = [p for p in fresh
                                         if p not in claimed_set]
                            k += promoted
                        except Exception:  # noqa: BLE001 - fall back to
                            # prefilling the suffix from tokens
                            KV_TIER_EVENTS.inc(
                                engine=self._obs_name,
                                replica=self.replica, op="promote",
                                outcome="error")
                        if ledger is not None:
                            ledger.enter("admission")
                adm = _Admission(
                    slot=free, request_id=request_id, prompt=prompt,
                    max_new=max_new, eos_id=eos_id, future=future,
                    submitted=submitted, sampling=sampling, expires=expires,
                    trace=trace, claimed=time.time(),
                    base=k * self.page_size, offset=k * self.page_size,
                    adapter=adapter, adapter_slot=adapter_slot,
                    ledger=ledger)
                adm.page_ids = ids
                adm.pages = fresh
                adm.prefix_nodes = matched_nodes
                self._apply_directive(adm, extra)
                if adm.small is None:
                    adm.small = init_kv_cache(self.config, 1, self.max_len,
                                              kv_dtype=self.kv_dtype,
                                              device=self.device)
                if k:
                    prefix_ids = ids.copy()
                    prefix_ids[k:] = -1
                    if self.paged_prefill_impl == "kernel":
                        # the suffix prefill attends the shared prefix pages
                        # in place (prefill_gather_admissions stays 0)
                        adm.kernel_prefix = True
                        adm.prefix_ids = torch.as_tensor(
                            prefix_ids, device=self.device)
                    else:
                        # reference path: seed the batch-1 cache with a
                        # dense copy of the prefix KV
                        with self._lock:
                            self._stats["prefill_gather_admissions"] += 1
                        gather_prefix_pages(self._pool, adm.small,
                                            prefix_ids, self.page_size)
                return adm
            except Exception as exc:
                # popped but not yet tracked in self._admission: give the
                # storage back and fail the future before the scheduler
                # dies, or the request would hang
                self._free_pages.extend(fresh)
                if self._prefix is not None:
                    self._prefix.release(matched_nodes)
                if not future.done():
                    future.set_exception(exc)
                raise

    def _prefill_dispatch(self, adm: _Admission, tokens, lora_kw: dict):
        """Prefix-hit admissions on the kernel path attend the cached
        prefix pages in place: the pool and page ids ride the dispatch as
        ``prefix_kv``, and every chunk (and the last-token replay)
        LSE-merges the paged prefill kernel's partial state with the local
        attention over the suffix rows, under the slot's adapter."""
        if not adm.kernel_prefix:
            return super()._prefill_dispatch(adm, tokens, lora_kw)
        prefix_kv = self._prefix_kv(adm.prefix_ids, adm.base)
        with self._lock:
            self._stats["prefill_kernel_chunks"] += 1
        return _forward_with_cache(self.config, self.params, tokens,
                                   adm.small, prefix_kv=prefix_kv,
                                   attn_impl=self.prefill_impl,
                                   page_size=self.page_size, **lora_kw)

    def _prefix_kv(self, page_ids, base: int) -> dict:
        """The prefix-hit form of ``_forward_with_cache``: the pool (with
        its scales on int8 pools), the prefix's page ids and length."""
        prefix_kv = {name: self._pool[name] for name in _POOL_NAMES
                     if name in self._pool}
        prefix_kv.update(page_ids=page_ids, base=base)
        return prefix_kv

    def _handoff_kv(self, adm: _Admission, rows: int) -> dict:
        kv = super()._handoff_kv(adm, rows)
        k = adm.base // self.page_size
        if not adm.kernel_prefix or not k:
            return kv
        # kernel-prefix exports: rows < base were never gathered into the
        # slot cache — take them from the shared pool pages (int8 pages
        # and scales ship as they are)
        ids = torch.as_tensor(np.asarray(adm.page_ids[:k], np.int64),
                              device=self._pool["k"].device)
        for name in kv:
            pages = self._pool[name][:, ids]
            rows_t = _from_wire(kv[name])
            rows_t[:, :adm.base] = pages.reshape(
                pages.shape[0], adm.base, *pages.shape[3:]).cpu()
            kv[name] = _to_wire(rows_t)
        return kv

    def _complete_storage(self, adm: _Admission):
        k = adm.base // self.page_size
        insert_ids = np.asarray(adm.page_ids, np.int32).copy()
        # shared prefix pages are read-only — never rewrite them
        insert_ids[:k] = -1
        insert_prompt_pages(self._pool, adm.small, insert_ids,
                            self.page_size)
        adm.small = None  # the batch-1 cache is consumed
        held = list(adm.prefix_nodes)
        pages = list(adm.pages)
        # an imported handoff is not indexed (a decode engine serves no
        # prefills), unless it is a prewarm replay
        if self._prefix is not None and \
                (not adm.prefilled or adm.register_import):
            # index this prompt's freshly written full blocks under the
            # request's adapter root; claimed pages become cache-owned
            # (not freed on release)
            new_nodes, claimed = self._prefix.register(
                adm.prompt, adm.page_ids, adm.prefix_nodes,
                adapter=adm.adapter)
            held.extend(new_nodes)
            if claimed:
                claimed_set = set(claimed)
                pages = [p for p in pages if p not in claimed_set]
        self._slot_pages[adm.slot] = pages
        self._slot_prefix_nodes[adm.slot] = held
        self._page_table[adm.slot] = adm.page_ids
        self._pos[adm.slot] = len(adm.prompt)

    def _abort_admission(self, adm: _Admission):
        self._free_pages.extend(adm.pages)
        if self._prefix is not None:
            self._prefix.release(adm.prefix_nodes)

    def _fail_pending(self, exc: Exception):
        # head-of-line requests parked in the pending deque fail with
        # everything else on stop/crash
        while self._pending:
            future = self._pending.popleft()[4]
            if not future.done():
                future.set_exception(exc)
        # queued fetch / import ops fail the same way
        while self._control:
            future = self._control.popleft()[2]
            if not future.done():
                future.set_exception(exc)
        super()._fail_pending(exc)

    def _release_slot_storage(self, index: int):
        self._free_pages.extend(self._slot_pages.pop(index, []))
        if self._prefix is not None:
            # drop this slot's holds; refcount-0 pages STAY cached until
            # an allocation evicts them
            self._prefix.release(self._slot_prefix_nodes.pop(index, []))
        self._page_table[index] = -1
        self._pos[index] = 0
        self._spec_release_slot(index)

    # paged-only cumulative stats mirrored to mlt_llm_events_total
    _COUNTER_STATS = ContinuousBatchingEngine._COUNTER_STATS + (
        "attn_kernel_ticks", "attn_gather_ticks", "attn_hbm_bytes_avoided",
        "prefill_kernel_chunks", "prefill_gather_admissions",
        "kv_demotes", "kv_demoted_pages", "kv_promotes",
        "kv_promoted_pages", "kv_fetches", "kv_fetched_pages",
        "kv_imports", "kv_imported_pages")

    @property
    def stats(self) -> dict:
        out = ContinuousBatchingEngine.stats.fget(self)
        out["decode_attn_impl"] = self.attn_impl
        out["paged_prefill_impl"] = self.paged_prefill_impl
        out["free_pages"] = len(self._free_pages)
        if self._prefix is not None:
            queries = self._prefix.queries
            out["prefix_queries"] = queries
            out["prefix_hits"] = self._prefix.hits
            out["prefix_hit_rate"] = (
                self._prefix.hits / queries if queries else 0.0)
            out["prefix_cached_tokens"] = self._prefix.cached_tokens
            out["prefix_evictions"] = self._prefix.evictions
            out["prefix_cached_pages"] = self._prefix.cached_pages()
        if self._kv_tier is not None:
            out["kv_tier"] = self._kv_tier.stats()
        return out

    # -- speculative decoding: the paged hooks (the policy is the base's) --
    def _make_verify_fn(self):
        return functools.partial(_verify_rowwise_paged, self.config,
                                 self.page_size, self.attn_impl)

    def _spec_apply_positions(self, committed: dict):
        # the pool-side rollback: rejected draft positions are simply not
        # committed, and their entries are overwritten before any read.
        # Pages were reserved at admission for prompt + max_new, and
        # k_eff <= remaining keeps every accepted lane inside that
        # reservation, so nothing moves on the free list mid-round
        for index, value in committed.items():
            self._pos[index] = value

    def _spec_verify_dispatch(self, chunk: np.ndarray, active) -> np.ndarray:
        table = torch.as_tensor(self._page_table, device=self.device)
        pos = torch.as_tensor(self._pos, device=self.device)
        verified, self._pool = self._spec_verify_fn()(
            self.params, torch.as_tensor(chunk, device=self.device),
            self._pool, table, pos,
            **self._lora_kwargs(self._slot_adapter_ids()))
        verified = verified.cpu().numpy()
        with self._lock:
            # a verify dispatch is one attention tick like a decode tick:
            # on the kernel path it never gathers a dense view
            if self.attn_impl == "kernel":
                self._stats["attn_kernel_ticks"] += 1
                self._stats["attn_hbm_bytes_avoided"] += \
                    self._gather_bytes_per_tick
            else:
                self._stats["attn_gather_ticks"] += 1
        return verified

    def _spec_warmup_verify(self):
        # an all-(-1) table routes every chunk write to the scratch page;
        # called directly (not through _spec_verify_dispatch) so warmup
        # counts no attention tick
        chunk = torch.zeros((self.slots, self.spec_k + 1), dtype=torch.long,
                            device=self.device)
        table = torch.full((self.slots, self.pages_per_slot), -1,
                           dtype=torch.int32, device=self.device)
        pos = torch.zeros((self.slots,), dtype=torch.int32,
                          device=self.device)
        self._spec_verify_fn()(self.params, chunk, self._pool, table, pos,
                               **self._lora_kwargs())

    def _plain_decode_tick(self, active) -> int:
        last = np.zeros((self.slots, 1), np.int64)
        for i in active:
            last[i, 0] = self._slot_state[i].tokens[-1]
        table = torch.as_tensor(self._page_table, device=self.device)
        pos = torch.as_tensor(self._pos, device=self.device)
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
            next_token, self._pool, _ = _decode_rowwise_paged(
                self.config, self.page_size, self.attn_impl, self.params,
                tokens, self._pool, table, pos, self._generator, temp, top_k,
                top_p, **lora_kw)
        else:
            next_token, self._pool, _ = _decode_rowwise_paged(
                self.config, self.page_size, self.attn_impl, self.params,
                tokens, self._pool, table, pos, **lora_kw)
        tokens_host = next_token.cpu().numpy()
        self._ledger_mark(active, "decode_stall")
        with self._lock:
            # on the kernel path a tick never gathers a dense view
            # (attn_gather_ticks stays 0)
            if self.attn_impl == "kernel":
                self._stats["attn_kernel_ticks"] += 1
                self._stats["attn_hbm_bytes_avoided"] += \
                    self._gather_bytes_per_tick
            else:
                self._stats["attn_gather_ticks"] += 1
        for i in active:
            slot = self._slot_state[i]
            token = int(tokens_host[i])
            slot.tokens.append(token)
            slot.remaining -= 1
            self._pos[i] += 1
            capacity = slot.prompt_len + len(slot.tokens) >= self.max_len
            if (slot.eos_id is not None and token == slot.eos_id) or \
                    slot.remaining <= 0 or capacity:
                self._finish(i)
        return len(active)

