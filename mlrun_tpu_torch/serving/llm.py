"""LLM inference on the GPU: KV-cached prefill forward and the serving
step — counterpart of ``mlrun_tpu/serving/llm.py``.

``_forward_with_cache`` is the admission (prefill) forward of the engines:
it runs a prompt chunk at ``cache['pos']`` through every layer, writes the
chunk's KV into the batch-1 slot cache, and attends over that cache with
the cached flash kernel (``attn_impl="flash"``) or the dense masked
softmax. On a paged prefix-cache hit (``prefix_kv``) the cached prefix is
attended in place in the pool's pages by the paged prefill kernel and
LSE-merged with the bounded flash over the suffix.

The int8 KV cache (``kv_dtype="int8"``) stores k/v per vector as int8
with float32 scales, quantized by :func:`_quantize_kv` to the reference's
bits.

Multi-tenant LoRA: with an adapter bank (serving/adapters.py) every
projection of the engines' forwards adds each row's own low-rank delta
in float32 (:func:`_lora_rows`, :func:`_proj`), the reference's
``_lora_delta``; the attention routes are the same with or without it.

``LLMEngine`` generates one prompt (or an equal-length batch) at a time:
a bucket-padded prefill, then greedy decode in chunks of dense 1-token
steps with one host read per chunk. ``LLMModelServer`` serves through it
by default, or through the dense or the paged continuous-batching engine
(serving/llm_batch.py, serving/paged.py), with an int8 KV cache and a
speculative draft model when asked.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SERVING_LLM_DEFAULTS
from ..models.llama import LlamaConfig, Params, _mm_f32, lm_head, logits_f32
from ..ops.attention import NEG_INF
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rope, rope_table
from ..utils import logger
from .adapters import UnknownAdapterError, build_registry
from .resilience import PromptTooLongError


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    GPU. Without a CUDA device the caller must ask for the CPU explicitly —
    an engine never carries on on the CPU by itself."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but no CUDA "
                               "device is available")
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: mlrun_tpu_torch serves on the GPU; "
            "pass device='cpu' explicitly to run the plain CPU paths")
    return torch.device("cuda")


def init_kv_cache(config: LlamaConfig, batch: int, max_len: int,
                  dtype=None, kv_dtype: str = "native",
                  device: torch.device | str = "cpu") -> dict:
    """KV cache dict: k/v [L, batch, max_len, Hkv, D] and pos [batch]
    int32, on ``device``. ``kv_dtype="int8"`` stores k/v as per-vector
    symmetric int8 with float32 scales ``k_scale``/``v_scale`` [L, batch,
    max_len, Hkv] (see :func:`_quantize_kv`)."""
    if kv_dtype not in ("native", "int8"):
        raise ValueError(f"unknown kv_dtype '{kv_dtype}' (native | int8)")
    shape = (config.n_layers, batch, max_len, config.n_kv_heads,
             config.head_dim)
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if kv_dtype == "int8":
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{name}_scale"] = torch.zeros(
                shape[:-1], dtype=torch.float32, device=device)
        return cache
    dtype = dtype or config.dtype
    cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 values, float32 scale over the last dim): the
    reference's bits — ``amax / 127``, a true division by ``max(scale,
    1e-8)`` (not a reciprocal multiply) and round-half-to-even
    (``torch.round``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / scale.clamp_min(1e-8)[..., None]).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _cached_attention(config, q, k_cache, v_cache, q_positions, cache_len):
    """q: [B, S, H, D]; caches: [B, M, Hkv, D]. Causal over positions:
    row (b, i) attends k_pos <= q_positions[b, i]."""
    n_rep = config.n_heads // config.n_kv_heads
    m = k_cache.shape[1]
    if n_rep > 1:
        k_cache = torch.repeat_interleave(k_cache, n_rep, dim=2)
        v_cache = torch.repeat_interleave(v_cache, n_rep, dim=2)
    scale = config.head_dim ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_cache.float()) * scale
    k_pos = torch.arange(m, device=q.device)
    mask = k_pos[None, None, :] <= q_positions[:, :, None]     # [B, S, M]
    logits = torch.where(mask[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v_cache)


def _cached_attention_lse(config, q, k_cache, v_cache, q_positions, k_lo):
    """Bounded dense cached attention returning (o, lse): like
    :func:`_cached_attention` but kv rows below ``k_lo`` are masked out
    (they live in shared pool pages on a prefix hit). o [B, S, H, D] f32,
    lse [B, H, S] f32. The S == 1 replay form of the hit path."""
    n_rep = config.n_heads // config.n_kv_heads
    m = k_cache.shape[1]
    if n_rep > 1:
        k_cache = torch.repeat_interleave(k_cache, n_rep, dim=2)
        v_cache = torch.repeat_interleave(v_cache, n_rep, dim=2)
    scale = config.head_dim ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_cache.float()) * scale
    k_pos = torch.arange(m, device=q.device)
    mask = (k_pos[None, None, :] <= q_positions[:, :, None]) \
        & (k_pos[None, None, :] >= int(k_lo))
    logits = torch.where(mask[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    m_max = logits.amax(dim=-1)                                # [B, H, S]
    weight = torch.exp(logits - m_max[..., None])
    denom = weight.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", weight / denom[..., None],
                     v_cache.float())
    return o, m_max + torch.log(denom)


def _gather_rows(lora_target: dict, adapter_ids: torch.Tensor):
    """One target's bank factors for each batch row, all layers: (A rows
    [B, L, in, r], scaling * B rows [B, L, r, out]), float32, by the
    per-row slot ids ``adapter_ids`` [B] (a device tensor, never read
    back). The per-row scaling is folded into B here, once."""
    ids = adapter_ids.long()
    scaling = lora_target["scaling"].index_select(0, ids)       # [B, L]
    return (lora_target["lora_a"].index_select(0, ids),
            lora_target["lora_b"].index_select(0, ids)
            * scaling[:, :, None, None])


def _lora_rows(lora: Optional[dict], adapter_ids) -> Optional[dict]:
    """Every target's factors gathered for the batch rows once per
    dispatch (:func:`_gather_rows`), ``{target: (A rows, scaled B
    rows)}``; a layer then takes views of them instead of gathering
    again. ``adapter_ids`` None: ``lora`` is such rows already and is
    returned as is."""
    if lora is None or adapter_ids is None:
        return lora
    return {target: _gather_rows(parts, adapter_ids)
            for target, parts in lora.items()}


def _lora_delta(h_in: torch.Tensor, lora_target: dict, layer: int,
                adapter_ids: torch.Tensor) -> torch.Tensor:
    """Per-row low-rank delta for one projection, in float32: each batch
    row takes its OWN (A, B, scaling) from the stacked adapter bank
    (serving/adapters.py AdapterBank) by its slot index ``adapter_ids``
    [B]; rows on slot 0 (base model / padding) hit all-zero factors, a
    zero delta. ``h_in`` [B, S, in] is promoted to float32, as the
    reference's einsum of a bf16 activation with float32 factors is.
    (The forwards add the same delta fused into their projections,
    :func:`_proj`.)"""
    a, bb = _gather_rows(lora_target, adapter_ids)
    return torch.bmm(torch.bmm(h_in.float(), a[:, layer]), bb[:, layer])


def _proj(h: torch.Tensor, w: torch.Tensor, rows: Optional[dict] = None,
          target: str = "", layer: int = 0,
          h32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A projection h [B, S, in] @ w [in, out]. Without adapters
    (``rows`` None) the plain product in h's dtype. With a bank's rows
    (:func:`_lora_rows`) the reference's form for every row, base-slot
    rows included: the base product with a float32 result, plus the
    float32 delta where ``target`` is adapted (``(h @ A) @ (scaling *
    B)``, its add fused into the second product), cast to h's dtype
    once. ``h32`` is h in float32, when the caller has it."""
    if rows is None:
        return h @ w
    b, s, e = h.shape
    out = _mm_f32(h.reshape(b * s, e), w).reshape(b, s, w.shape[-1])
    if target in rows:
        a, bb = rows[target]
        h32 = h.float() if h32 is None else h32
        out = torch.baddbmm(out, torch.bmm(h32, a[:, layer]), bb[:, layer])
    return out.to(h.dtype)


def _f32_if_adapted(h: torch.Tensor, rows: Optional[dict], targets):
    """h in float32 when one of ``targets`` is adapted (shared by the
    projections that read h), else None."""
    if rows and any(target in rows for target in targets):
        return h.float()
    return None


def _qkv(config: LlamaConfig, h: torch.Tensor, lp: dict,
         rows: Optional[dict] = None, layer: int = 0):
    """The q/k/v projections of one layer: [B, S, H|Hkv, D] each (the
    float32 copy of h made once for the three adapted products)."""
    b, s, _ = h.shape
    h32 = _f32_if_adapted(h, rows, ("wq", "wk", "wv"))
    q = _proj(h, lp["wq"], rows, "wq", layer, h32)
    k = _proj(h, lp["wk"], rows, "wk", layer, h32)
    v = _proj(h, lp["wv"], rows, "wv", layer, h32)
    return (q.reshape(b, s, config.n_heads, config.head_dim),
            k.reshape(b, s, config.n_kv_heads, config.head_dim),
            v.reshape(b, s, config.n_kv_heads, config.head_dim))


def _out_and_mlp(config: LlamaConfig, x: torch.Tensor, attn: torch.Tensor,
                 lp: dict, rows: Optional[dict] = None,
                 layer: int = 0) -> torch.Tensor:
    """The rest of a layer after its attention: the output projection
    into the residual, then the SwiGLU MLP block."""
    b, s, _ = x.shape
    x = x + _proj(attn.reshape(b, s, config.qkv_dim), lp["wo"], rows, "wo",
                  layer)
    h = rms_norm(x, lp["mlp_norm_scale"], config.norm_eps)
    h32 = _f32_if_adapted(h, rows, ("w_gate", "w_up"))
    gate = _proj(h, lp["w_gate"], rows, "w_gate", layer, h32)
    up = _proj(h, lp["w_up"], rows, "w_up", layer, h32)
    return x + _proj(F.silu(gate) * up, lp["w_down"], rows, "w_down", layer)


def _forward_with_cache(config: LlamaConfig, params: Params,
                        tokens: torch.Tensor, cache: dict,
                        prefix_kv: Optional[dict] = None,
                        all_logits: bool = False,
                        attn_impl: str = "dense",
                        page_size: int = 0, start: int | None = None,
                        lora: Optional[dict] = None, adapter_ids=None):
    """Run tokens [B, S] starting at ``cache['pos']`` (uniform over the
    batch); returns (logits, cache). Logits are [B, vocab] f32 for the last
    position, or [B, S, vocab] with ``all_logits``. ``start`` is the
    caller's host copy of ``cache['pos'][0]``: given, the position is not
    read back from the device (a decode loop then never waits on the card
    between its steps).

    The chunk's KV is written into ``cache`` IN PLACE and ``cache['pos']``
    advances by S (the reference returns a new cache; its callers never
    reuse the old one, so the port saves the copy).

    ``attn_impl="flash"`` attends over the cache with the cached flash
    kernel (CUDA; the plain version for CPU tensors) for S > 1; ``dense``
    (and every 1-token dispatch) uses the masked softmax.

    An int8 cache (``k_scale`` in ``cache``) takes the chunk quantized
    per vector and attends the cache's dequantized view in
    ``config.dtype``, as the reference does.

    ``prefix_kv`` is the paged engine's prefix-hit form (batch 1):
    ``{"k"/"v": the pool [L, P+1, ps, Hkv, D], "page_ids": [pps] int32
    tensor, "base": int[, "k_scale"/"v_scale": [L, P+1, ps, Hkv] float32
    on int8 pools]}``. Cache rows below ``base`` are zeros — the
    cached prefix is attended in place through the page ids by the paged
    prefill kernel and LSE-merged with the local attention over the suffix
    rows, so a hit never gathers the prefix densely (``page_size`` is the
    pool's page size).

    ``lora``/``adapter_ids`` add batched multi-tenant LoRA: ``lora`` is
    the stacked adapter bank (``{target: {lora_a: [S, L, in, r], ...}}``)
    and ``adapter_ids`` [B] selects each row's bank slot (0 = base
    model); every projection then takes :func:`_proj`'s float32 form.
    Without a bank the projections are the plain products."""
    from ..ops.attention import (
        _flash_fwd_v2_cached_bounded,
        flash_attention_cached,
    )
    from ..ops.paged_attention import merge_softmax_states, paged_prefix_part

    b, s = tokens.shape
    max_len = cache["k"].shape[2]
    if start is None:
        start = int(cache["pos"][0])
    positions = cache["pos"].long()[:, None] + torch.arange(
        s, device=tokens.device)[None, :]                       # [B, S]
    x = params["embedding"][tokens].to(config.dtype)
    # one rope table from row 0: the engines keep pos uniform per batch
    cos, sin = rope_table(positions[0], config.head_dim, config.rope_theta)
    base = int(prefix_kv["base"]) if prefix_kv is not None else 0
    quantized = "k_scale" in cache
    # an int8 pool's per-vector scales ride the prefix-hit form
    pool_scales = (("k_scale", "v_scale")
                   if prefix_kv is not None and "k_scale" in prefix_kv
                   else ())
    rows = _lora_rows(lora, adapter_ids)

    for layer in range(config.n_layers):
        lp = {name: w[layer] for name, w in params["layers"].items()}
        h = rms_norm(x, lp["attn_norm_scale"], config.norm_eps)
        q, k, v = _qkv(config, h, lp, rows, layer)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if quantized:
            # the chunk is quantized into the int8 slot cache, and the
            # attention reads the cache's dequantized view in config.dtype
            # — it sees what later reads of the cache will see
            for name, t in (("k", k), ("v", v)):
                values, scales = _quantize_kv(t)
                cache[name][layer][:, start:start + s] = values
                cache[f"{name}_scale"][layer][:, start:start + s] = scales
            k_attn = _dequantize_kv(cache["k"][layer],
                                    cache["k_scale"][layer], config.dtype)
            v_attn = _dequantize_kv(cache["v"][layer],
                                    cache["v_scale"][layer], config.dtype)
        else:
            k_attn = cache["k"][layer]
            v_attn = cache["v"][layer]
            k_attn[:, start:start + s] = k.to(k_attn.dtype)
            v_attn[:, start:start + s] = v.to(v_attn.dtype)
        if prefix_kv is not None:
            # paged prefix-hit suffix prefill: local rows (>= base) via the
            # bounded flash (s > 1) or the bounded dense form (the 1-token
            # replay); the cached prefix via the paged prefill kernel,
            # reading pool pages in place; the two partial softmax states
            # are LSE-merged. The kernels take k/v at the kv head count, so
            # no repeat copy is made.
            if attn_impl == "flash" and s > 1:
                o_loc, lse_loc = _flash_fwd_v2_cached_bounded(
                    q, k_attn, v_attn, start, base)
            else:
                o_loc, lse_loc = _cached_attention_lse(
                    config, q, k_attn, v_attn, positions, base)
            o_pre, lse_pre = paged_prefix_part(
                q, prefix_kv["k"][layer], prefix_kv["v"][layer],
                prefix_kv["page_ids"], base, page_size=page_size,
                **{name: prefix_kv[name][layer] for name in pool_scales})
            attn = merge_softmax_states(o_pre, lse_pre, o_loc,
                                        lse_loc).to(x.dtype)
        elif attn_impl == "flash" and s > 1:
            attn = flash_attention_cached(q, k_attn, v_attn, start)
        else:
            attn = _cached_attention(config, q, k_attn, v_attn, positions,
                                     max_len)
        x = _out_and_mlp(config, x, attn, lp, rows, layer)

    x = rms_norm(x, params["final_norm_scale"], config.norm_eps)
    logits = logits_f32(x if all_logits else x[:, -1], lm_head(params))
    cache["pos"] = cache["pos"] + s
    return logits, cache


class LLMEngine:
    """Batch-1 (or equal-length batch) generation around a Llama param
    tree: one bucket-padded prefill through ``_forward_with_cache``
    (attention over the cache with the cached flash kernel on the card,
    the dense masked softmax otherwise), then greedy decode in fixed
    chunks of ``decode_chunk`` dense 1-token steps with one host read per
    chunk, or sampled decode token by token. Counterpart of the
    reference's ``LLMEngine``, whose jitted ``lax.scan`` chunk becomes a
    loop of dispatches here.

    ``device`` defaults to the GPU (and raises without one); pass
    ``device="cpu"`` for the plain paths. ``adapters`` (a sources dict or
    a shared ``AdapterRegistry``) serves named LoRA adapters per request
    or per batch row; without it a request naming one fails with
    ``UnknownAdapterError`` (404), as on the reference's engine."""

    def __init__(self, config: LlamaConfig, params: Params,
                 max_len: int = 2048, batch: int = 1,
                 prefill_buckets: tuple = (128, 512, 1024),
                 temperature: float = 0.0, kv_dtype: str = "native",
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 attention_impl: str | None = None, adapters=None,
                 max_live_adapters: int | None = None, device=None):
        from ..ops.attention import resolve_prefill_impl

        self.config = config
        self.params = params
        self.max_len = max_len
        self.batch = batch
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.kv_dtype = kv_dtype
        self.device = default_device(device)
        if params["embedding"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embedding'].device}, the engine "
                f"on {self.device}")
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self.prefill_buckets = tuple(
            b for b in sorted(prefill_buckets) if b <= max_len) or (max_len,)
        if attention_impl is None:
            attention_impl = str(SERVING_LLM_DEFAULTS["attention_impl"])
        self.attention_impl = attention_impl
        # flash prefill; decode stays dense — a 1-token q gains nothing
        # from blockwise streaming
        self.prefill_impl = resolve_prefill_impl(attention_impl, self.device)
        # multi-tenant LoRA: named adapters resolved per request / row
        self._adapters = build_registry(config, adapters, max_live_adapters,
                                        self.device)
        if self.prefill_impl == "flash":
            from ..ops import _build

            _build.library()  # build now: a kernel fault surfaces here
        self.decode_chunk = 32

    # -- device steps -------------------------------------------------------
    def _new_cache(self) -> dict:
        return init_kv_cache(self.config, self.batch, self.max_len,
                             kv_dtype=self.kv_dtype, device=self.device)

    def _lora_kwargs(self, slots=None) -> dict:
        """The forward kwargs that thread the adapter bank and per-row slot
        ids (one per batch row: an int or a [batch] array; default every
        row on the base slot 0) into a dispatch; {} without a registry."""
        if self._adapters is None:
            return {}
        ids = np.broadcast_to(np.asarray(0 if slots is None else slots,
                                         np.int32), (self.batch,))
        return {"lora": self._adapters.bank.tensors,
                "adapter_ids": torch.as_tensor(ids.copy(),
                                               device=self.device)}

    def _prefill(self, tokens: torch.Tensor, cache: dict, **lora_kw):
        return _forward_with_cache(self.config, self.params, tokens, cache,
                                   attn_impl=self.prefill_impl, **lora_kw)

    def _decode(self, tokens: torch.Tensor, cache: dict, start: int,
                **lora_kw):
        """One dense decode step of tokens [batch, 1] at ``start``."""
        return _forward_with_cache(self.config, self.params, tokens, cache,
                                   start=start, **lora_kw)

    def _decode_n(self, token: torch.Tensor, cache: dict, n: int,
                  start: int, lora=None, adapter_ids=None):
        """``n`` greedy steps from ``token`` [batch, 1] at ``start``, the
        argmax kept on the device (the reference's ``lax.scan``); the
        rows' adapter factors are gathered once for all ``n``. Returns
        (tokens [n, batch] int32 on the device, cache)."""
        rows = _lora_rows(lora, adapter_ids)
        out = []
        for i in range(n):
            logits, cache = self._decode(token, cache, start + i, lora=rows)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(nxt)
            token = nxt[:, None].long()
        return torch.stack(out), cache

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature and self.temperature > 0:
            from .sampling import sample_logits

            b = logits.shape[0]
            return sample_logits(logits, self._generator,
                                 [self.temperature] * b, [self.top_k] * b,
                                 [self.top_p] * b)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def warmup(self):
        """Run every prefill bucket, the 1-token step and one decode chunk
        ahead of traffic, so the first request pays for no kernel build or
        library initialisation."""
        started = time.perf_counter()
        kw = self._lora_kwargs()
        for bucket in self.prefill_buckets:
            cache = self._new_cache()
            self._prefill(torch.zeros((self.batch, bucket), dtype=torch.long,
                                      device=self.device), cache, **kw)
        step = torch.zeros((self.batch, 1), dtype=torch.long,
                           device=self.device)
        cache = self._new_cache()
        self._decode(step, cache, 0, **kw)
        tokens, _ = self._decode_n(step, cache,
                                   min(self.decode_chunk, self.max_len), 0,
                                   **kw)
        tokens.cpu()  # host read = a real sync
        logger.info("llm engine warm", buckets=list(self.prefill_buckets),
                    warmup_s=round(time.perf_counter() - started, 2))

    def _bucket_for(self, length: int) -> int:
        for bucket in self.prefill_buckets:
            if length <= bucket:
                return bucket
        return self.max_len

    # -- API ----------------------------------------------------------------
    def generate(self, prompt_tokens, max_new_tokens: int = 64,
                 eos_id: int | None = None, adapter: str = "",
                 request_key=None) -> tuple[list[int], dict]:
        """Greedy/temperature generation for a single prompt (every batch
        row carries it); returns (tokens, timing stats). ``adapter`` names
        a registry adapter applied to every row (a typed 404 when
        unknown); a tenant id with canary state resolves to its effective
        versioned id first (serving/canary.py), ``request_key`` pinning
        the split side."""
        prompt = np.asarray(prompt_tokens, dtype=np.int64).reshape(1, -1)
        prompt_len = prompt.shape[1]
        if prompt_len + max_new_tokens > self.max_len:
            raise PromptTooLongError(
                f"prompt_len {prompt_len} + max_new_tokens "
                f"{max_new_tokens} exceeds max_len {self.max_len}")
        split_tenant = split_side = ""
        if adapter:
            from .canary import get_canary_router, split_key_for

            router = get_canary_router()
            if router is not None:
                resolved, side = router.resolve(
                    adapter, split_key_for(prompt_tokens, request_key))
                if side:
                    split_tenant, split_side = adapter, side
                adapter = resolved
        if adapter and self._adapters is None:
            raise UnknownAdapterError(
                f"engine has no adapter registry (adapter='{adapter}')")
        bucket = self._bucket_for(prompt_len)
        padded = np.zeros((self.batch, bucket), np.int64)
        padded[:, :prompt_len] = prompt
        t0 = time.perf_counter()
        kw = {}
        if self._adapters is not None:
            self._adapters.pin(adapter)
        try:
            if self._adapters is not None:
                kw = self._lora_kwargs(self._adapters.ensure_loaded(adapter))
            out_tokens, ttft, t1 = self._generate_inner(
                prompt, prompt_len, bucket, padded, max_new_tokens, eos_id,
                t0, kw)
        finally:
            if self._adapters is not None:
                self._adapters.unpin(adapter)
        decode_time = time.perf_counter() - t1
        stats = {
            "ttft_s": ttft,
            "decode_tokens_per_sec": (len(out_tokens) - 1) / decode_time
            if decode_time > 0 and len(out_tokens) > 1 else 0.0,
            "prompt_len": prompt_len,
            "generated": len(out_tokens),
        }
        if split_side:
            # metered on success only: the split-fraction telemetry counts
            # served requests
            from ..obs import CANARY_REQUESTS

            CANARY_REQUESTS.inc(adapter=split_tenant, side=split_side)
        from .samples import emit_sample, sampling_enabled

        if sampling_enabled():
            emit_sample(adapter=adapter, tokens=list(out_tokens),
                        prompt_len=prompt_len, generated=len(out_tokens),
                        ttft_s=ttft, total_s=time.perf_counter() - t0,
                        logit_margin=float("nan"),
                        engine=type(self).__name__, replica="")
        return out_tokens, stats

    # -- adapter source lifecycle -------------------------------------------
    def add_adapter_source(self, name: str, source):
        if self._adapters is None:
            raise ValueError(
                "engine has no adapter registry (build it with "
                "adapters=... to hot-load adapters)")
        self._adapters.add_source(name, source)

    def retire_adapter(self, name: str, keep_source: bool = False):
        if self._adapters is not None:
            self._adapters.retire(name, keep_source=keep_source)

    def _prefill_prompt(self, padded: np.ndarray, last: np.ndarray,
                        prompt_len: int, bucket: int,
                        kw: dict | None = None):
        """The bucket-padded prefill, then ``pos`` rewinds to the prompt:
        unless the prompt fills its bucket, a 1-token dense replay of the
        last prompt token (``last`` [batch, 1]) at ``prompt_len - 1`` gives
        the first logits. ``kw`` carries the rows' adapters. Returns
        (logits [batch, vocab], cache)."""
        kw = kw or {}
        cache = self._new_cache()
        logits, cache = self._prefill(
            torch.as_tensor(padded, device=self.device), cache, **kw)
        if prompt_len != bucket:
            cache["pos"] = torch.full((self.batch,), prompt_len - 1,
                                      dtype=torch.int32, device=self.device)
            logits, cache = self._decode(
                torch.as_tensor(last, device=self.device), cache,
                prompt_len - 1, **kw)
        else:
            cache["pos"] = torch.full((self.batch,), prompt_len,
                                      dtype=torch.int32, device=self.device)
        return logits, cache

    def _generate_inner(self, prompt, prompt_len, bucket, padded,
                        max_new_tokens, eos_id, t0, kw):
        logits, cache = self._prefill_prompt(
            padded, prompt[:, -1:].repeat(self.batch, 0), prompt_len, bucket,
            kw)
        next_token = self._sample(logits)
        out_tokens = [int(next_token[0])]
        ttft = time.perf_counter() - t0
        t1 = time.perf_counter()
        remaining = max_new_tokens - 1
        pos = prompt_len  # the next cache row, on the host
        if self.temperature and self.temperature > 0:
            # sampled decode: token by token
            for _ in range(remaining):
                if eos_id is not None and out_tokens[-1] == eos_id:
                    break
                step = torch.full((self.batch, 1), out_tokens[-1],
                                  dtype=torch.long, device=self.device)
                logits, cache = self._decode(step, cache, pos, **kw)
                pos += 1
                out_tokens.append(int(self._sample(logits)[0]))
        else:
            # greedy: always the full chunk, truncated on the host
            while remaining > 0:
                if eos_id is not None and out_tokens[-1] == eos_id:
                    break
                if prompt_len + len(out_tokens) + self.decode_chunk \
                        > self.max_len:
                    break  # cache capacity: a full chunk would not fit
                step = torch.full((self.batch, 1), out_tokens[-1],
                                  dtype=torch.long, device=self.device)
                tokens, cache = self._decode_n(step, cache,
                                               self.decode_chunk, pos, **kw)
                pos += self.decode_chunk
                chunk = tokens[:, 0].cpu().tolist()[:remaining]
                if eos_id is not None and eos_id in chunk:
                    chunk = chunk[: chunk.index(eos_id) + 1]
                out_tokens.extend(int(t) for t in chunk)
                remaining -= len(chunk)
        return out_tokens, ttft, t1

    def generate_batch(self, prompts: list, max_new_tokens: int = 64,
                       eos_id: int | None = None,
                       adapters: list | None = None) -> tuple[list, dict]:
        """Batched greedy generation for EQUAL-LENGTH prompts (one decode
        chunk serves the whole batch). Mixed lengths, and sampled
        decoding, fall back to a per-prompt loop. ``adapters`` gives one
        registry adapter name per prompt ("" = base): each row applies its
        own delta inside the shared dispatch, and padding rows ride the
        base slot. The engine must be built with ``batch >=
        len(prompts)``."""
        n = len(prompts)
        if n == 0:
            return [], {"ttft_s": 0.0, "decode_tokens_per_sec": 0.0,
                        "batch": 0}
        if n > self.batch:
            raise ValueError(
                f"{n} prompts exceed engine batch size {self.batch}")
        if adapters is not None and len(adapters) != n:
            raise ValueError(
                f"adapters has {len(adapters)} entries for {n} prompts")
        row_adapters = list(adapters or [""] * n)
        if any(row_adapters) and self._adapters is None:
            raise UnknownAdapterError(
                "engine has no adapter registry "
                f"(adapters={sorted(set(filter(None, row_adapters)))})")
        lengths = {len(p) for p in prompts}
        if len(lengths) > 1 or (self.temperature and self.temperature > 0):
            outs = []
            started = time.perf_counter()
            first_ttft = None
            for prompt, row_adapter in zip(prompts, row_adapters):
                tokens, stats = self.generate(prompt, max_new_tokens, eos_id,
                                              adapter=row_adapter)
                outs.append(tokens)
                first_ttft = first_ttft if first_ttft is not None \
                    else stats["ttft_s"]
            wall = time.perf_counter() - started
            generated = sum(len(o) for o in outs)
            return outs, {
                "ttft_s": first_ttft or 0.0,
                # true aggregate: total tokens over total wall time
                "decode_tokens_per_sec": generated / wall if wall > 0
                else 0.0,
                "batch": n,
            }

        prompt_len = lengths.pop()
        bucket = self._bucket_for(prompt_len)
        padded = np.zeros((self.batch, bucket), np.int64)
        for i, prompt in enumerate(prompts):
            padded[i, :prompt_len] = prompt
        t0 = time.perf_counter()
        kw = {}
        pinned = []
        try:
            if self._adapters is not None:
                # every row's adapter pinned for the whole batched
                # dispatch; padding rows (>= n) stay on the base slot 0
                slots = np.zeros((self.batch,), np.int32)
                for i, row_adapter in enumerate(row_adapters):
                    self._adapters.pin(row_adapter)
                    pinned.append(row_adapter)
                    slots[i] = self._adapters.ensure_loaded(row_adapter)
                kw = self._lora_kwargs(slots)
            out, ttft, t1, generated = self._generate_batch_inner(
                n, prompt_len, bucket, padded, max_new_tokens, eos_id, t0,
                kw)
        finally:
            for row_adapter in pinned:
                self._adapters.unpin(row_adapter)
        decode_time = time.perf_counter() - t1
        stats = {
            "ttft_s": ttft,
            "decode_tokens_per_sec": generated / decode_time
            if decode_time > 0 and generated else 0.0,
            "batch": n,
        }
        return out, stats

    def _generate_batch_inner(self, n, prompt_len, bucket, padded,
                              max_new_tokens, eos_id, t0, kw):
        logits, cache = self._prefill_prompt(
            padded, padded[:, prompt_len - 1:prompt_len], prompt_len, bucket,
            kw)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [[int(t)] for t in next_token.cpu().tolist()[:n]]
        ttft = time.perf_counter() - t0

        t1 = time.perf_counter()
        remaining = max_new_tokens - 1
        generated_so_far = 1
        step = next_token[:, None].long()
        while remaining > 0:
            if eos_id is not None and all(
                    o and o[-1] == eos_id for o in out[:n]):
                break  # every row finished
            # the same capacity guard as generate(): pos starts at
            # prompt_len
            if prompt_len + generated_so_far + self.decode_chunk \
                    > self.max_len:
                break
            tokens, cache = self._decode_n(
                step, cache, self.decode_chunk,
                prompt_len + generated_so_far - 1, **kw)
            chunk = tokens.cpu().numpy()  # [chunk, batch]
            take = min(self.decode_chunk, remaining)
            for i in range(n):
                row = chunk[:take, i].tolist()
                if eos_id is not None and eos_id in row:
                    row = row[: row.index(eos_id) + 1]
                if not out[i] or (eos_id is None
                                  or out[i][-1] != eos_id):
                    out[i].extend(int(t) for t in row)
            step = tokens[-1][:, None].long()
            remaining -= take
            generated_so_far += self.decode_chunk  # cache rows consumed
        generated = sum(len(o) for o in out) - n
        return out, ttft, t1, generated


class LLMModelServer:
    """Serving-graph step: generation on the GPU.

    With its defaults (``continuous_batching=False``) the server builds an
    :class:`LLMEngine` and ``predict`` generates each input in turn;
    ``continuous_batching=True`` builds the dense
    ``ContinuousBatchingEngine``, and with ``paged=True`` the paged one
    (``paged=True`` alone raises the reference's ``ValueError`` at load).

    class args: model_preset, max_len, max_new_tokens, continuous_batching,
    paged, slots, kv_dtype (native | int8), page_size, n_pages,
    prefill_chunk, prefix_cache, attention_impl, speculative (True |
    {"draft": preset, "k": ...} | None; the batching engines), adapters
    (named LoRA sources: tree | local .npz path | callable; a v2 body's
    ``"adapter"`` picks one), max_live_adapters, adapter_rate and
    adapter_burst (the batching engines' per-tenant token bucket),
    max_queue_size, max_wait and degradation (the batching engines'
    overload protection), replicas / prefill_replicas / routing (with
    ``continuous_batching=True``: ``replicas >= 2`` or ``prefill_replicas
    > 0`` serves through an ``EngineFleet`` of batching engines, the
    affinity or random routing of serving/fleet.py, a prefill pool handing
    KV to a decode pool), request_ledger (None = the config's default,
    on; a batching server answers a v2 body's ``"timing": true`` with each
    input's phase breakdown), temperature, top_k, top_p, warmup, seed,
    device (default: the GPU; ``"cpu"`` runs the plain paths), hf_model
    (an HF Llama checkpoint directory, or hub id, loaded in place of the
    preset by ``frameworks.huggingface.load_hf_weights_into_llama``),
    tokenizer (an ``AutoTokenizer`` directory or id: string inputs are
    encoded, and their outputs decoded to strings).
    """

    def __new__(cls, *args, **kwargs):
        from .v2_serving import V2ModelServer

        class _Server(V2ModelServer):
            def __init__(self, *a, model_preset: str = "tiny",
                         tokenizer: str | None = None, max_len: int = 1024,
                         max_new_tokens: int = 64,
                         hf_model: str | None = None,
                         temperature: float = 0.0, warmup: bool = True,
                         continuous_batching: bool = False, slots: int = 4,
                         kv_dtype: str = "native", top_k: int = 0,
                         top_p: float = 1.0, paged: bool = False,
                         page_size: int = 128, n_pages: int | None = None,
                         max_queue_size: int = 0, max_wait: float = 0.0,
                         degradation: dict | None = None,
                         prefill_chunk: int | None = None,
                         prefix_cache: bool | None = None,
                         attention_impl: str | None = None,
                         replicas: int = 0, prefill_replicas: int = 0,
                         routing: str | None = None,
                         adapters: dict | None = None,
                         max_live_adapters: int | None = None,
                         adapter_rate: float | None = None,
                         adapter_burst: float | None = None,
                         request_ledger: bool | None = None,
                         speculative: dict | bool | None = None,
                         seed: int = 0, device=None, **kw):
                super().__init__(*a, **kw)
                self.model_preset = model_preset
                # a local HF checkpoint directory (or hub id) whose
                # weights and config replace the preset's; a tokenizer
                # directory (or hub id) for string inputs
                self.hf_model = hf_model
                self.tokenizer_id = tokenizer
                self._tokenizer = None
                self.continuous_batching = continuous_batching
                self.paged = paged
                self.max_len = max_len
                self.max_new_tokens = max_new_tokens
                self.temperature = temperature
                self._warmup = warmup
                self.slots = slots
                self.kv_dtype = kv_dtype
                self.top_k = top_k
                self.top_p = top_p
                self.page_size = page_size
                self.n_pages = n_pages
                # overload knobs forwarded to the batching engines
                self.max_queue_size = max_queue_size
                self.max_wait = max_wait
                self.degradation = degradation
                # per-request phase ledger; None = the config's default
                self.request_ledger = request_ledger
                self.prefill_chunk = prefill_chunk
                self.prefix_cache = prefix_cache
                self.attention_impl = attention_impl
                # engine fleet: replicas >= 2 builds an EngineFleet of
                # batching engines instead of one engine; prefill_replicas
                # > 0 also splits prefill and decode into two pools joined
                # by the KV handoff
                self.replicas = replicas
                self.prefill_replicas = prefill_replicas
                self.routing = routing
                # in-engine speculative decoding: True / {"draft": preset,
                # "k": ...} enables a resident draft model; None leaves it
                # to the config defaults (off)
                self.speculative = speculative
                # multi-tenant LoRA: named adapter sources, handed to
                # every engine kind
                self.adapters = adapters
                self.max_live_adapters = max_live_adapters
                self.adapter_rate = adapter_rate
                self.adapter_burst = adapter_burst
                self.seed = seed
                self.device = default_device(device)
                self.engine = None
                # predict -> postprocess hand-over of the opt-in "timing"
                # field: thread-local, because concurrent requests share
                # this server and each runs its whole chain on one thread
                self._timing_out = threading.local()

            def load(self):
                from ..models import llama

                if self.paged and not self.continuous_batching:
                    raise ValueError(
                        "paged=True needs continuous_batching=True "
                        "(the paged pool backs the slot scheduler)")
                if self.hf_model:
                    from ..frameworks.huggingface import (
                        load_hf_weights_into_llama,
                    )

                    config, params = load_hf_weights_into_llama(
                        self.hf_model, device=self.device)
                else:
                    config = llama.MODEL_PRESETS[self.model_preset]()
                    generator = torch.Generator(device=self.device)
                    generator.manual_seed(self.seed)
                    params = llama.init_params(config, generator,
                                               self.device)
                if self.tokenizer_id:
                    from transformers import AutoTokenizer

                    self._tokenizer = AutoTokenizer.from_pretrained(
                        self.tokenizer_id)
                if not self.continuous_batching:
                    self.engine = LLMEngine(
                        config, params, max_len=self.max_len,
                        temperature=self.temperature, top_k=self.top_k,
                        top_p=self.top_p, kv_dtype=self.kv_dtype,
                        attention_impl=self.attention_impl, seed=self.seed,
                        adapters=self.adapters,
                        max_live_adapters=self.max_live_adapters,
                        device=self.device)
                    if self._warmup:
                        self.engine.warmup()
                    self.model = self.engine
                    return
                common = dict(
                    max_len=self.max_len, slots=self.slots,
                    kv_dtype=self.kv_dtype,
                    max_queue_size=self.max_queue_size,
                    max_wait=self.max_wait, degradation=self.degradation,
                    request_ledger=self.request_ledger,
                    prefill_chunk=self.prefill_chunk,
                    attention_impl=self.attention_impl, seed=self.seed,
                    speculative=self._speculative_conf(),
                    adapters=self.adapters,
                    max_live_adapters=self.max_live_adapters,
                    adapter_rate=self.adapter_rate,
                    adapter_burst=self.adapter_burst, device=self.device)

                # every replica of a fleet closes over the same params, so
                # the replicas share one copy of the weights on the card
                def build_engine(role="unified"):
                    if self.paged:
                        from .paged import PagedContinuousBatchingEngine

                        return PagedContinuousBatchingEngine(
                            config, params, page_size=self.page_size,
                            n_pages=self.n_pages,
                            prefix_cache=self.prefix_cache, **common)
                    from .llm_batch import ContinuousBatchingEngine

                    return ContinuousBatchingEngine(config, params, **common)

                if self.replicas >= 2 or self.prefill_replicas:
                    from .fleet import EngineFleet

                    self.engine = EngineFleet(
                        build_engine, replicas=max(1, self.replicas),
                        prefill_replicas=self.prefill_replicas,
                        routing=self.routing)
                else:
                    self.engine = build_engine()
                if self._warmup:
                    self.engine.warmup()
                self.engine.start()
                self.model = self.engine

            def _speculative_conf(self) -> dict | None:
                """The engine's draft-carrying speculative dict from the
                class arg over the config defaults: the named draft preset
                is built resident beside the target, its random weights
                drawn from a generator seeded 1 (the reference draws them
                from PRNGKey(1)). A dict enables speculation unless it says
                ``"enabled": False`` (the reference's docstring; its code
                leaves such a dict off, ROADMAP.md queue 3)."""
                from ..models import llama

                conf = dict(SERVING_LLM_DEFAULTS["speculative"])
                arg = self.speculative
                if isinstance(arg, bool):
                    arg = {"enabled": arg}
                if isinstance(arg, dict):
                    conf.update(arg)
                    conf["enabled"] = bool(arg.get("enabled", True))
                if not (conf["enabled"] and conf.get("draft")):
                    return None
                draft_config = llama.MODEL_PRESETS[conf["draft"]]()
                generator = torch.Generator(device=self.device)
                generator.manual_seed(1)
                conf["draft_config"] = draft_config
                conf["draft_params"] = llama.init_params(
                    draft_config, generator, self.device)
                return conf

            def predict(self, request):
                # v2 body tenant id ({"inputs": [...], "adapter": "t1"}) and
                # canary key, threaded to the engine as the reference does;
                # an adapter no source provides fails 404
                adapter = request.get("adapter", "") or ""
                request_key = request.get("request_key") or None
                # {"timing": true} returns each input's phase-ledger
                # breakdown on the batching servers; the LLMEngine server
                # ignores the field, as the reference's does. Clear the
                # hand-over slot first: a predict() that raised must not
                # leak one request's timing onto this thread's next one
                self._timing_out.value = None
                want_timing = bool(request.get("timing"))
                inputs = request["inputs"]
                id_lists = []
                for item in inputs:
                    if isinstance(item, str):
                        if self._tokenizer is None:
                            raise ValueError(
                                "string inputs need a tokenizer= class arg")
                        id_lists.append(self._tokenizer(item)["input_ids"])
                    else:
                        id_lists.append([int(t) for t in item])
                return [self._tokenizer.decode(tokens)
                        if isinstance(item, str) else tokens
                        for item, tokens in zip(
                            inputs, self._generate(id_lists, adapter,
                                                   request_key,
                                                   want_timing))]

            def _generate(self, id_lists, adapter, request_key,
                          want_timing) -> list:
                """Each input's generated token ids."""
                if not self.continuous_batching:
                    out_tokens = []
                    for ids in id_lists:
                        tokens, stats = self.engine.generate(
                            ids, max_new_tokens=self.max_new_tokens,
                            adapter=adapter, request_key=request_key)
                        self.set_metric("ttft_s", stats["ttft_s"])
                        self.set_metric("decode_tps",
                                        stats["decode_tokens_per_sec"])
                        out_tokens.append(tokens)
                    return out_tokens
                # submit everything, then collect — requests share the
                # decode batch; bounded wait so a dead scheduler fails the
                # futures rather than wedging the worker
                futures = [self.engine.submit(
                    ids, max_new_tokens=self.max_new_tokens,
                    temperature=self.temperature, top_k=self.top_k,
                    top_p=self.top_p, adapter=adapter,
                    request_key=request_key) for ids in id_lists]
                results = [f.result(timeout=600) for f in futures]
                if results:
                    self.set_metric("ttft_s",
                                    min(s["ttft_s"] for _, s in results))
                    generated = sum(s["generated"] for _, s in results)
                    wall = max(s["total_s"] for _, s in results)
                    if wall > 0:
                        self.set_metric("decode_tps", generated / wall)
                engine_stats = self.engine.stats
                for key in ("ttft_p50_s", "ttft_p95_s", "itl_p50_s",
                            "itl_p95_s", "prefix_hit_rate",
                            "prefix_cached_tokens", "prefix_evictions",
                            "prefill_chunks"):
                    if key in engine_stats:
                        self.set_metric(key, engine_stats[key])
                if want_timing:
                    self._timing_out.value = [s.get("timing")
                                              for _, s in results]
                return [tokens for tokens, _ in results]

            def postprocess(self, response):
                # the opt-in "timing" field rides the v2 envelope next to
                # "outputs" (one entry per input, aligned)
                timings = getattr(self._timing_out, "value", None)
                self._timing_out.value = None
                if timings and any(t is not None for t in timings):
                    response["timing"] = timings
                return response

            def close(self):
                # an LLMEngine holds no scheduler thread to stop
                if self.engine is not None and self.continuous_batching:
                    self.engine.stop()

        return _Server(*args, **kwargs)
