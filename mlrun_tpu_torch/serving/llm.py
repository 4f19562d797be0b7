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

``LLMModelServer`` serves through the paged continuous-batching engine
(serving/paged.py), with an int8 pool and a speculative draft model when
asked; its other engines are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import SERVING_LLM_DEFAULTS
from ..models.llama import LlamaConfig, Params, lm_head, logits_f32
from ..ops.attention import NEG_INF
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rope, rope_table
from .resilience import not_ported


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


def _forward_with_cache(config: LlamaConfig, params: Params,
                        tokens: torch.Tensor, cache: dict,
                        prefix_kv: Optional[dict] = None,
                        all_logits: bool = False,
                        attn_impl: str = "dense",
                        page_size: int = 0):
    """Run tokens [B, S] starting at ``cache['pos']`` (uniform over the
    batch); returns (logits, cache). Logits are [B, vocab] f32 for the last
    position, or [B, S, vocab] with ``all_logits``.

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
    pool's page size)."""
    from ..ops.attention import (
        _flash_fwd_v2_cached_bounded,
        flash_attention_cached,
    )
    from ..ops.paged_attention import merge_softmax_states, paged_prefix_part

    b, s = tokens.shape
    max_len = cache["k"].shape[2]
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

    for layer in range(config.n_layers):
        lp = {name: w[layer] for name, w in params["layers"].items()}
        h = rms_norm(x, lp["attn_norm_scale"], config.norm_eps)
        q = (h @ lp["wq"]).reshape(b, s, config.n_heads, config.head_dim)
        k = (h @ lp["wk"]).reshape(b, s, config.n_kv_heads, config.head_dim)
        v = (h @ lp["wv"]).reshape(b, s, config.n_kv_heads, config.head_dim)
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
        x = x + attn.reshape(b, s, config.qkv_dim) @ lp["wo"]
        h2 = rms_norm(x, lp["mlp_norm_scale"], config.norm_eps)
        x = x + (F.silu(h2 @ lp["w_gate"]) * (h2 @ lp["w_up"])) @ lp["w_down"]

    x = rms_norm(x, params["final_norm_scale"], config.norm_eps)
    logits = logits_f32(x if all_logits else x[:, -1], lm_head(params))
    cache["pos"] = cache["pos"] + s
    return logits, cache


class LLMModelServer:
    """Serving-graph step: generation on the GPU through the paged
    continuous-batching engine.

    class args: model_preset, max_len, max_new_tokens, slots, kv_dtype
    (native | int8), page_size, n_pages, prefill_chunk, prefix_cache,
    attention_impl, speculative (True | {"draft": preset, "k": ...} |
    None), temperature, top_k, top_p, warmup, seed, device (default: the
    GPU; ``"cpu"`` runs the plain paths). The reference's other engines
    and features raise ``NotImplementedError`` naming their ROADMAP.md
    item.
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
                         speculative: dict | bool | None = None,
                         seed: int = 0, device=None, **kw):
                super().__init__(*a, **kw)
                # (value, ROADMAP.md item) of each reference feature
                unported = {
                    "tokenizer": (tokenizer, 10),
                    "hf_model": (hf_model, 10),
                    "max_wait/degradation": (max_wait or degradation, 2),
                    "replicas/prefill_replicas/routing": (
                        replicas >= 2 or prefill_replicas or routing, 6),
                    "adapters": (adapters, 3),
                }
                for what, (value, item) in unported.items():
                    if value:
                        raise not_ported(f"LLMModelServer {what}", item)
                if not continuous_batching or not paged:
                    raise not_ported(
                        "LLMModelServer without continuous_batching=True, "
                        "paged=True (LLMEngine / the dense "
                        "ContinuousBatchingEngine)",
                        2)
                self.model_preset = model_preset
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
                self.max_queue_size = max_queue_size
                self.prefill_chunk = prefill_chunk
                self.prefix_cache = prefix_cache
                self.attention_impl = attention_impl
                # in-engine speculative decoding: True / {"draft": preset,
                # "k": ...} enables a resident draft model; None leaves it
                # to the config defaults (off)
                self.speculative = speculative
                self.seed = seed
                self.device = default_device(device)
                self.engine = None

            def load(self):
                from ..models.llama import MODEL_PRESETS, init_params
                from .paged import PagedContinuousBatchingEngine

                config = MODEL_PRESETS[self.model_preset]()
                generator = torch.Generator(device=self.device)
                generator.manual_seed(self.seed)
                params = init_params(config, generator, self.device)
                self.engine = PagedContinuousBatchingEngine(
                    config, params, max_len=self.max_len, slots=self.slots,
                    kv_dtype=self.kv_dtype, page_size=self.page_size,
                    n_pages=self.n_pages,
                    max_queue_size=self.max_queue_size,
                    prefill_chunk=self.prefill_chunk,
                    prefix_cache=self.prefix_cache,
                    attention_impl=self.attention_impl, seed=self.seed,
                    speculative=self._speculative_conf(), device=self.device)
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
                from ..models.llama import MODEL_PRESETS, init_params

                conf = dict(SERVING_LLM_DEFAULTS["speculative"])
                arg = self.speculative
                if isinstance(arg, bool):
                    arg = {"enabled": arg}
                if isinstance(arg, dict):
                    conf.update(arg)
                    conf["enabled"] = bool(arg.get("enabled", True))
                if not (conf["enabled"] and conf.get("draft")):
                    return None
                draft_config = MODEL_PRESETS[conf["draft"]]()
                generator = torch.Generator(device=self.device)
                generator.manual_seed(1)
                conf["draft_config"] = draft_config
                conf["draft_params"] = init_params(draft_config, generator,
                                                   self.device)
                return conf

            def predict(self, request):
                id_lists = []
                for item in request["inputs"]:
                    if isinstance(item, str):
                        raise not_ported("string inputs (a tokenizer)", 10)
                    id_lists.append([int(t) for t in item])
                # submit everything, then collect — requests share the
                # decode batch; bounded wait so a dead scheduler fails the
                # futures rather than wedging the worker
                futures = [self.engine.submit(
                    ids, max_new_tokens=self.max_new_tokens,
                    temperature=self.temperature, top_k=self.top_k,
                    top_p=self.top_p) for ids in id_lists]
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
                return [tokens for tokens, _ in results]

            def close(self):
                if self.engine is not None:
                    self.engine.stop()

        return _Server(*args, **kwargs)
